"""The port's kernel build on the CPU (no nvcc needed): the library a
source builds into is named by a hash of the source, of every header it
includes from csrc/ and of the flags, so an edited header never loads a
stale library."""

import shutil

import pytest

from pulseportraiture_tpu_torch import _kernels


def test_library_path_covers_included_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(_kernels, "CSRC_DIR", str(csrc))
    (csrc / "common.cuh").write_text('// v1\n#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text('// v1\n#include "common.cuh"\n')
    src = csrc / "moments.cu"
    src.write_text('#include "common.cuh"\n#include <cuda_runtime.h>\n'
                   '#include "missing.cuh"\n' + src.read_text())
    assert _kernels._source_files("moments.cu") == [
        "moments.cu", "common.cuh", "inner.cuh"]   # each once, cycle cut
    first = _kernels._lib_path("moments")
    other = _kernels._lib_path("fftfit")
    (csrc / "inner.cuh").write_text('// v2\n#include "common.cuh"\n')
    second = _kernels._lib_path("moments")
    assert second != first
    (csrc / "common.cuh").write_text('// v2\n#include "inner.cuh"\n')
    third = _kernels._lib_path("moments")
    assert third not in (first, second)
    # a header no source includes, and another library, change nothing
    (csrc / "unused.cuh").write_text("// v1\n")
    assert _kernels._lib_path("moments") == third
    assert _kernels._lib_path("fftfit") == other


def test_library_path_of_a_source_without_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(_kernels, "CSRC_DIR", str(csrc))
    for lib in ("moments", "moments_scat", "fftfit"):
        assert _kernels._source_files(lib + ".cu") == [lib + ".cu"]
        before = _kernels._lib_path(lib)
        path = csrc / (lib + ".cu")
        path.write_text(path.read_text() + "\n// edited\n")
        assert _kernels._lib_path(lib) != before


def test_spectra_source_in_the_build(tmp_path, monkeypatch):
    """csrc/spectra.cu is one of the built sources, holds both entry
    points, and its library's name changes when the source is edited."""
    assert "spectra.cu" in _kernels.SOURCES
    assert _kernels._lib_of("spectra") == _kernels._lib_of("spectra_noise") \
        == "spectra"
    text = open(_kernels.CSRC_DIR + "/spectra.cu").read()
    for name in ("spectra", "spectra_noise"):
        assert 'extern "C" int %s(' % _kernels.KERNELS[name][1] in text
        assert "__global__" in text and _kernels.TRACE_NAMES[name] in text
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(_kernels, "CSRC_DIR", str(csrc))
    before = _kernels._lib_path("spectra")
    src = csrc / "spectra.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _kernels._lib_path("spectra") != before


@pytest.mark.parametrize("source,names", [
    ("unpack.cu", ("unpack", "baseline")),
    ("loadstats.cu", ("load_stats",)),
    ("rotate.cu", ("rotate",))])
def test_load_sources_in_the_build(tmp_path, monkeypatch, source, names):
    """The load's kernels (K5 csrc/unpack.cu, K6 csrc/loadstats.cu, K7
    csrc/rotate.cu) are built sources, each entry point and traced CUDA
    function in its source, each with a plain version; a library's name
    changes when its source is edited."""
    assert source in _kernels.SOURCES
    lib = source[:-len(".cu")]
    text = open(_kernels.CSRC_DIR + "/" + source).read()
    for name in names:
        assert _kernels._lib_of(name) == lib
        assert 'extern "C" int %s(' % _kernels.KERNELS[name][1] in text
        assert "__global__" in text and _kernels.TRACE_NAMES[name] in text
        assert callable(getattr(_kernels, name + "_plain"))
        assert name in _kernels.LAUNCHES
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(_kernels, "CSRC_DIR", str(csrc))
    before = _kernels._lib_path(lib)
    src = csrc / source
    src.write_text(src.read_text() + "\n// edited\n")
    assert _kernels._lib_path(lib) != before


def test_wavelet_source_in_the_build(tmp_path, monkeypatch):
    """K8 (csrc/wavelet.cu) is a built source: its eight entry points and
    its traced CUDA function are in the source, it has a plain version
    and a launch count, and its library's name changes when the source
    is edited."""
    assert "wavelet.cu" in _kernels.SOURCES
    assert _kernels._lib_of("smooth_search") == "wavelet"
    text = open(_kernels.CSRC_DIR + "/wavelet.cu").read()
    symbols = _kernels._SYMBOLS["smooth_search"]
    assert _kernels.KERNELS["smooth_search"][1] in symbols
    assert len(symbols) == 8
    for sym in symbols:
        assert 'extern "C" int %s(' % sym in text
    assert "__global__" in text and \
        _kernels.TRACE_NAMES["smooth_search"] in text
    assert callable(_kernels.smooth_search_plain)
    assert "smooth_search" in _kernels.LAUNCHES
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(_kernels, "CSRC_DIR", str(csrc))
    before = _kernels._lib_path("wavelet")
    src = csrc / "wavelet.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _kernels._lib_path("wavelet") != before


def test_gauss_source_in_the_build(tmp_path, monkeypatch):
    """K9 (csrc/gauss.cu) is a built source: both entry points
    (gauss_normal, gauss_sse) and their traced CUDA functions are in it,
    each has a plain version and a launch count, and the library's name
    changes when the source is edited."""
    assert "gauss.cu" in _kernels.SOURCES
    text = open(_kernels.CSRC_DIR + "/gauss.cu").read()
    for name in ("gauss_normal", "gauss_sse"):
        assert _kernels._lib_of(name) == "gauss"
        assert 'extern "C" int %s(' % _kernels.KERNELS[name][1] in text
        assert "__global__" in text and _kernels.TRACE_NAMES[name] in text
        assert callable(getattr(_kernels, name + "_plain"))
        assert name in _kernels.LAUNCHES
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(_kernels, "CSRC_DIR", str(csrc))
    before = _kernels._lib_path("gauss")
    src = csrc / "gauss.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _kernels._lib_path("gauss") != before
