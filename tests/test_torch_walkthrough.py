"""examples/example.py through both packages, at a small size.

The reference walkthrough — scintillated, dispersed fake epochs -> align
-> spline model -> wideband TOAs -> a DMDATA + DMX GLS timing fit — on 5
epochs of 4 subints x 32 channels x 256 bins written by the port's
make_fake_pulsar (chip_smoke.walkthrough_inputs; the smoke runs the same
steps at 10 x 512 x 2048 on the card).  The port runs every step on the
CPU (the plain versions of kernels K1 and K2); the JAX package runs each
step on the files the port's previous step wrote, so each step is held
on the same inputs:

* align: the aligned portraits within 5e-8 of the peak (the bound of
  tests/test_torch_align.py: the fits stop at the f64 floor);
* spline model from the port's aligned portrait: the model portraits
  within 1e-8 of the peak (tests/test_torch_spline_build.py);
* TOAs with the port's model: the .tim files within 1 ns, flag for flag
  (tests/torch_tim.py).  The TOA errors here are ~9 us, so 1 ns is
  1e-4 of them — below what the fits' stopping rule fixes, which is why
  each package's TOAs are made from one model file: the two packages'
  own models, equal to 4e-16, give TOAs up to 3 ns apart;
* GLS on the port's .tim: the parameters within 1e-3 of their errors,
  the errors, wrms and reduced chi2 within 1e-6 relative;
* the port's result meets example.py's own criteria (DM offsets
  relative to their mean within 5 sigma + 1e-5; dF0, dF1 within 5
  sigma; DMX wander within 5 sigma + 2e-5).
"""

import os
import sys

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.io.archive import load_data
from pulseportraiture_tpu.io.parfile import read_par
from pulseportraiture_tpu.io.splmodel import read_spline_model
from pulseportraiture_tpu.io.timfile import write_TOAs
from pulseportraiture_tpu.models.spline import SplineModelPortrait
from pulseportraiture_tpu.pipelines.align import align_archives
from pulseportraiture_tpu.pipelines.timing import (parse_tim,
                                                   wideband_gls_fit)
from pulseportraiture_tpu.pipelines.toas import GetTOAs
from torch_tim import assert_same_tim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

SHAPE = (4, 32, 256)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small CPU tensors run fastest on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_walkthrough_port_vs_reference(tmp_path):
    data = tmp_path / "data"
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    for d in (data, port_dir, ref_dir):
        d.mkdir()
    meta, files, dDMs = chip_smoke.walkthrough_inputs(ROOT, str(data), SHAPE)
    run = chip_smoke.walkthrough_run(ROOT, str(port_dir), meta, files,
                                     "cpu")
    par = os.path.join(ROOT, "examples", "example.par")

    avg = str(ref_dir / "walk.port")
    align_archives(meta, initial_guess=files[0], tscrunch=True,
                   pscrunch=True, outfile=avg, niter=1, quiet=True)
    port_avg = load_data(str(port_dir / "walk.port")).subints
    ref_avg = load_data(avg).subints
    assert np.abs(port_avg - ref_avg).max() <= 5e-8 * np.abs(ref_avg).max()

    spl = str(ref_dir / "walk-fit.spl")
    dp = SplineModelPortrait(str(port_dir / "walk.port"), quiet=True)
    dp.normalize_portrait("prof")
    dp.make_spline_model(max_ncomp=3, smooth=True, snr_cutoff=150.0,
                         rchi2_tol=0.1, k=3, sfac=1.0, quiet=True)
    dp.write_model(spl, quiet=True)
    freqs = load_data(files[0]).freqs[0]
    want = np.asarray(read_spline_model(spl, freqs, SHAPE[2])[1])
    have = np.asarray(read_spline_model(run["spl"], freqs, SHAPE[2])[1])
    assert np.abs(have - want).max() <= 1e-8 * np.abs(want).max()

    tim = str(ref_dir / "walk.tim")
    gt = GetTOAs(meta, run["spl"], quiet=True)
    gt.get_TOAs(DM0=float(read_par(par).DM), bary=False)
    write_TOAs(gt.TOA_list, SNR_cutoff=0.0, outfile=tim, append=False)
    n = chip_smoke.WALK_EPOCHS * SHAPE[0]
    assert_same_tim(run["tim"], tim, n)

    ref_gls = wideband_gls_fit(parse_tim(run["tim"]),
                               str(port_dir / "walk-fit.par"))
    gls = run["gls"]
    assert list(gls["params"]) == list(ref_gls["params"])
    assert gls["fit_dm"] and gls["fit_f1"]
    assert len(gls["dmx"]) == chip_smoke.WALK_EPOCHS
    for name, value in ref_gls["params"].items():
        err = ref_gls["errors"][name]
        assert abs(gls["params"][name] - value) <= 1e-3 * err, name
        assert gls["errors"][name] == pytest.approx(err, rel=1e-6), name
    for key in ("prefit_wrms_us", "postfit_wrms_us", "red_chi2"):
        assert gls[key] == pytest.approx(ref_gls[key], rel=1e-6), key
    crit, ok = chip_smoke.walkthrough_criteria(run["gt"], gls, dDMs)
    assert ok, crit
