"""The port's crash-resume checkpoint against the JAX package's.

The cases of tests/test_pipeline_toas.py (resume and skip finished
archives, drop a partial block, a zero-TOA marker, a legacy markerless
file) and of tests/test_tracing.py (drop_checkpoint_blocks, trace
tokens), run on pulseportraiture_tpu_torch with ``device="cpu"``; then
the same three archives checkpointed by both packages' pptoas
``--checkpoint``: the same blocks and ``C pp_done`` markers, the TOA lines
within 1 ns and their flags to the last printed digit
(tests/torch_tim.py).
"""

import os

import numpy as np
import pytest

from pulseportraiture_tpu.cli import pptoas as jcli
from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.io.archive import make_fake_pulsar
from pulseportraiture_tpu.io.gmodel import write_model
from pulseportraiture_tpu.pipelines import toas as jtoas
from pulseportraiture_tpu_torch.cli import pptoas as tcli
from pulseportraiture_tpu_torch.pipelines import toas as ttoas
from torch_tim import assert_same_tim


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_jit_caches():
    """The reference fits add variants to the JAX package's jit caches,
    which tests/test_retrace_budget.py holds to a budget in whatever test
    process runs it next: drop them when the module ends."""
    yield
    jfp._batch_impl.clear_cache()
    jfp._solve.clear_cache()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_checkpoint")
    gm = str(tmp / "c.gmodel")
    write_model(gm, "c", "000", 1500.0,
                np.array([0.0, 0.0, 0.4, 0.0, 0.05, 0.0, 1.0, -0.5]),
                np.ones(8, int), -4.0, 0, quiet=True)
    par = str(tmp / "c.par")
    with open(par, "w") as f:
        f.write("PSR J0\nRAJ 00:00:00\nDECJ 00:00:00\nF0 100.0\n"
                "PEPOCH 56000.0\nDM 30.0\n")
    files = []
    for i in range(3):
        fits = str(tmp / ("c%d.fits" % i))
        make_fake_pulsar(gm, par, fits, nsub=2, nchan=8, nbin=128,
                         nu0=1500.0, bw=400.0, tsub=60.0, noise_stds=0.01,
                         dedispersed=False, seed=20 + i, quiet=True)
        files.append(fits)
    return tmp, gm, files


def _toa_lines(path):
    return [ln for ln in open(path)
            if ln.split() and ln.split()[0] not in ("FORMAT", "C", "#")]


def test_get_toas_checkpoint_resume(corpus, tmp_path):
    """TOAs append to the checkpoint per archive; a re-run skips archives
    already written (whatever the path spelling), and a partial block is
    dropped and refit, never skipped or duplicated."""
    _, gm, files = corpus
    ckpt = str(tmp_path / "resume.tim")
    gt1 = ttoas.GetTOAs(files[0], gm, quiet=True, device="cpu")
    gt1.get_TOAs(quiet=True, checkpoint=ckpt)
    lines1 = _toa_lines(ckpt)
    assert len(lines1) == 2 and all(ln.split()[0] == files[0]
                                    for ln in lines1)
    assert open(ckpt).read().splitlines()[-1] == "C pp_done %s 2" % files[0]

    rel_first = os.path.relpath(files[0])
    gt2 = ttoas.GetTOAs([rel_first] + files[1:], gm, quiet=True,
                        device="cpu")
    gt2.get_TOAs(quiet=True, checkpoint=ckpt)
    assert gt2.order == files[1:]  # the first archive resumed, not refit
    assert [ln.split()[0] for ln in _toa_lines(ckpt)] == \
        [files[0]] * 2 + [files[1]] * 2 + [files[2]] * 2

    # crash mid-write: drop the last marker and one TOA line of the block
    with open(ckpt) as f:
        content = f.readlines()
    truncated = [ln for ln in content
                 if not (ln.split()[:2] == ["C", "pp_done"]
                         and ln.split()[2] == files[2])][:-1]
    with open(ckpt, "w") as f:
        f.writelines(truncated)
    gt3 = ttoas.GetTOAs(files, gm, quiet=True, device="cpu")
    gt3.get_TOAs(quiet=True, checkpoint=ckpt)
    assert gt3.order == [files[2]]  # only the partial archive refit
    assert [ln.split()[0] for ln in _toa_lines(ckpt)] == \
        [files[0]] * 2 + [files[1]] * 2 + [files[2]] * 2
    markers = [ln.split() for ln in open(ckpt) if ln.startswith("C pp_done")]
    assert markers == [["C", "pp_done", f, "2"] for f in files]


def test_narrowband_checkpoint(corpus, tmp_path):
    """get_narrowband_TOAs keeps the same protocol: one block of
    nsub x nchan lines and its marker per archive, skipped on resume."""
    _, gm, files = corpus
    ckpt = str(tmp_path / "nb.tim")
    gt = ttoas.GetTOAs(files[:2], gm, quiet=True, device="cpu")
    gt.get_narrowband_TOAs(quiet=True, checkpoint=ckpt)
    gt2 = ttoas.GetTOAs(files, gm, quiet=True, device="cpu")
    gt2.get_narrowband_TOAs(quiet=True, checkpoint=ckpt)
    assert gt2.order == files[2:]
    markers = [ln.split() for ln in open(ckpt) if ln.startswith("C pp_done")]
    assert markers == [["C", "pp_done", f, "16"] for f in files]
    assert len(_toa_lines(ckpt)) == 48


@pytest.mark.parametrize("pkg", [ttoas, jtoas], ids=["port", "jax"])
def test_checkpoint_zero_toa_archive_stays_done(tmp_path, pkg):
    """A 'C pp_done <arch> 0' marker (an archive whose TOAs were all
    culled) validates on resume and leaves the file untouched."""
    ckpt = str(tmp_path / "z.tim")
    with open(ckpt, "w") as f:
        f.write("C pp_done empty.fits 0\n")
        f.write("a.fits 1400.0 56000.5 1.0 1\n")
        f.write("C pp_done a.fits 1\n")
    done = pkg._resume_checkpoint(ckpt)
    assert done == {os.path.realpath("empty.fits"),
                    os.path.realpath("a.fits")}
    assert len(open(ckpt).readlines()) == 3


def _legacy(path):
    with open(path, "w") as f:
        f.write("FORMAT 1\n")
        f.write("a.fits 1400.0 56000.5 1.0 1\n")
        f.write("a.fits 1500.0 56000.5 1.0 1\n")
        f.write("b.fits 1400.0 56001.5 1.0 1\n")
        f.write("c.fits 1400.0 56002.5 1.0 1\n")  # trailing: maybe cut


def test_checkpoint_legacy_markerless_matches_reference(tmp_path):
    """A pre-marker checkpoint keeps every block but the trailing one and
    is rewritten with markers — the same file from both packages."""
    port, ref = str(tmp_path / "p.tim"), str(tmp_path / "r.tim")
    _legacy(port)
    _legacy(ref)
    done = ttoas._resume_checkpoint(port)
    assert done == jtoas._resume_checkpoint(ref)
    assert done == {os.path.realpath("a.fits"), os.path.realpath("b.fits")}
    assert open(port).read() == open(ref).read()
    assert "C pp_done a.fits 2\n" in open(port).readlines()
    assert ttoas._resume_checkpoint(port) == done


def test_drop_checkpoint_blocks_and_traces(tmp_path):
    """drop_checkpoint_blocks removes exactly the named archives' blocks,
    marked with or without a trace token, as the JAX package's does."""
    body = ("a1.fits 1400.0 56000.0 1.0 pks\n"
            "C pp_done a1.fits 1 trace=%s\n"
            "a2.fits 1400.0 56000.1 1.0 pks\n"
            "C pp_done a2.fits 1\n" % ("c3" * 16))
    port, ref = str(tmp_path / "p.tim"), str(tmp_path / "r.tim")
    for path in (port, ref):
        with open(path, "w") as f:
            f.write(body)
    assert len(ttoas._resume_checkpoint(port)) == 2
    assert list(ttoas.checkpoint_traces(port).values()) == ["c3" * 16]
    assert ttoas.drop_checkpoint_blocks(port, ["a1.fits"]) == 1
    assert jtoas.drop_checkpoint_blocks(ref, ["a1.fits"]) == 1
    assert open(port).read() == open(ref).read()
    assert len(ttoas._resume_checkpoint(port)) == 1
    assert ttoas.checkpoint_traces(port) == {}
    assert ttoas.drop_checkpoint_blocks(port, []) == 0
    assert ttoas.drop_checkpoint_blocks(str(tmp_path / "none.tim"),
                                        ["a2.fits"]) == 0
    assert ttoas.drop_checkpoint_blocks(port, ["a2.fits"]) == 1
    assert _toa_lines(port) == []


def test_cli_checkpoint_matches_reference(corpus, tmp_path, capsys):
    """pptoas --checkpoint from both packages: the same blocks and
    markers, TOA lines within 1 ns; a second run appends nothing; the
    post-processing options are refused as the JAX CLI refuses them."""
    _, gm, files = corpus
    meta = str(tmp_path / "all.meta")
    with open(meta, "w") as f:
        f.write("\n".join(files) + "\n")
    port, ref = str(tmp_path / "p.tim"), str(tmp_path / "r.tim")
    base = ["-d", meta, "-m", gm, "--print_phase", "--quiet"]
    for _ in range(2):
        assert jcli.main(base + ["--checkpoint", ref]) == 0
        assert tcli.main(base + ["--checkpoint", port, "--device",
                                 "cpu"]) == 0
    pl, rl = open(port).read().splitlines(), open(ref).read().splitlines()
    assert [ln for ln in pl if ln.startswith("C ")] == \
        [ln for ln in rl if ln.startswith("C ")] == \
        ["C pp_done %s 2" % f for f in files]
    assert_same_tim(port, ref, 6, skip_comments=True)
    for bad in (["--snr_cut", "5"], ["--one_DM"], ["-f", "princeton"]):
        assert tcli.main(base + ["--checkpoint", port, "--device", "cpu"]
                         + bad) == 1
    assert "cannot be combined" in capsys.readouterr().err
    assert tcli.main(base + ["--checkpoint", port, "--device", "cpu",
                             "-o", str(tmp_path / "other.tim")]) == 0
    assert "supersedes -o" in capsys.readouterr().err
    assert not os.path.exists(str(tmp_path / "other.tim"))
