"""The port's ppzap and zap pipeline against the JAX package.

Archives from the JAX package's make_fake_pulsar: 3 subints x 16
channels x 128 bins with two hot (noisy) channels and one zapped
channel, and a metafile of it with a clean archive.  ``get_zap_channels``
and ``print_paz_cmds`` must give identical lists and text; an
``apply_zaps`` round trip must zero exactly the listed weights (the
port's PSRFITS writer and reader); ``ppzap -m`` (the post-fit chi2/S-N
cut, the port with ``--device cpu`` and the plain kernel versions) and
the model-free cut must emit identical paz commands, and the post-fit
``channel_red_chi2s`` must agree within 1e-10 relative.
"""

import os

import numpy as np
import pytest

from pulseportraiture_tpu.cli import ppzap as jzap_cli
from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.io.archive import load_data as jload
from pulseportraiture_tpu.io.archive import make_fake_pulsar
from pulseportraiture_tpu.io.gmodel import write_model
from pulseportraiture_tpu.ops.noise import get_noise as jget_noise
from pulseportraiture_tpu.ops.normalize import normalize_portrait as jnorm
from pulseportraiture_tpu.pipelines import zap as jzap
from pulseportraiture_tpu.pipelines.toas import GetTOAs as JGetTOAs
from pulseportraiture_tpu_torch.cli import ppzap as tzap_cli
from pulseportraiture_tpu_torch.io.archive import load_data as tload
from pulseportraiture_tpu_torch.pipelines import zap as tzap
from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs as TGetTOAs

MODEL_PARAMS = np.array([0.02, 0.0, 0.40, 0.0, 0.05, 0.0, 1.0, -0.5])


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_jit_caches():
    """The reference fits add variants to the JAX package's jit caches,
    which tests/test_retrace_budget.py holds to a budget in whatever test
    process runs it next: drop them when the module ends."""
    yield
    jfp._batch_impl.clear_cache()
    jfp._solve.clear_cache()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_zap")
    gm = str(tmp / "z.gmodel")
    write_model(gm, "z", "000", 1500.0, MODEL_PARAMS, np.ones(8, int),
                -4.0, 0, quiet=True)
    par = str(tmp / "z.par")
    with open(par, "w") as f:
        f.write("PSR J0\nRAJ 00:00:00\nDECJ 00:00:00\nF0 100.0\n"
                "PEPOCH 56000.0\nDM 30.0\n")
    noise = np.full(16, 0.005)
    noise[3] = 0.08
    noise[11] = 0.05
    w = np.ones((3, 16))
    w[:, 6] = 0.0
    hot = str(tmp / "hot.fits")
    make_fake_pulsar(gm, par, hot, nsub=3, nchan=16, nbin=128, nu0=1500.0,
                     bw=800.0, tsub=60.0, noise_stds=noise, weights=w,
                     dedispersed=False, seed=3, quiet=True)
    clean = str(tmp / "clean.fits")
    make_fake_pulsar(gm, par, clean, nsub=1, nchan=16, nbin=128,
                     nu0=1500.0, bw=800.0, tsub=60.0, noise_stds=0.004,
                     dedispersed=True, seed=4, quiet=True)
    meta = str(tmp / "zap.meta")
    with open(meta, "w") as f:
        f.write("%s\n%s\n" % (hot, clean))
    return tmp, gm, hot, clean, meta


@pytest.mark.parametrize("nstd", [2.0, 3.0, 5.0])
def test_get_zap_channels_and_paz_cmds_match_reference(setup, nstd):
    _, _, hot, clean, _ = setup
    zaps = []
    for path in (hot, clean):
        kw = dict(dedisperse=False, tscrunch=False, pscrunch=True,
                  rm_baseline=True, quiet=True)
        got = tzap.get_zap_channels(tload(path, device="cpu", **kw), nstd=nstd)
        want = jzap.get_zap_channels(jload(path, **kw), nstd=nstd)
        assert got == want
        zaps.append(got)
    if nstd <= 3.0:
        assert 3 in zaps[0][0] and 11 in zaps[0][0]
    for all_subs in (False, True):
        for modify in (False, True):
            assert tzap.print_paz_cmds([hot, clean], zaps, all_subs,
                                       modify, quiet=True) == \
                jzap.print_paz_cmds([hot, clean], zaps, all_subs, modify,
                                    quiet=True)
    assert tzap.print_paz_cmds([], [], quiet=True) == []


def test_apply_zaps_round_trip(setup, tmp_path):
    """Copy mode writes <name>.zap with exactly the listed weights zeroed
    (per subint, or in every subint with all_subs); modify rewrites in
    place; a misaligned list is refused."""
    import shutil

    _, _, hot, _, _ = setup
    work = str(tmp_path / "w.fits")
    shutil.copy(hot, work)
    before = tload(work, pscrunch=True, quiet=True, device="cpu").weights
    zap_list = [[[3, 11], [3], []]]
    (out, n), = tzap.apply_zaps([work], zap_list, modify=False, quiet=True)
    assert out == str(tmp_path / "w.zap") and n == 3
    after = tload(out, pscrunch=True, quiet=True, device="cpu").weights
    want = before.copy()
    want[0, [3, 11]] = 0.0
    want[1, 3] = 0.0
    np.testing.assert_array_equal(after, want)
    np.testing.assert_array_equal(tload(work, pscrunch=True, quiet=True,
                                        device="cpu").weights, before)
    tzap.apply_zaps([work], [[[5], [], []]], all_subs=True, modify=True,
                    quiet=True)
    want = before.copy()
    want[:, 5] = 0.0
    np.testing.assert_array_equal(tload(work, pscrunch=True, quiet=True,
                                        device="cpu").weights, want)
    with pytest.raises(ValueError):
        tzap.apply_zaps([work, work], zap_list, modify=False, quiet=True)


def test_channels_to_zap_match_reference(setup):
    """get_channels_to_zap after get_TOAs: identical zap lists, reduced
    chi2s within 1e-10 relative, the fitted subint's payload of
    return_fit within 1e-10 of the JAX package's."""
    _, gm, hot, _, _ = setup
    ref = JGetTOAs(hot, gm, quiet=True)
    ref.get_TOAs(quiet=True)
    port = TGetTOAs(hot, gm, quiet=True, device="cpu")
    port.get_TOAs(quiet=True)
    nzap = 0
    for kw in (dict(), dict(SNR_threshold=0.0, rchi2_threshold=2.0),
               dict(SNR_threshold=200.0, rchi2_threshold=1e9)):
        zaps = port.get_channels_to_zap(**kw)
        assert zaps == ref.get_channels_to_zap(**kw)
        nzap += sum(len(z) for z in zaps[0])
        for p_sub, r_sub in zip(port.channel_red_chi2s[0],
                                ref.channel_red_chi2s[0]):
            assert len(p_sub) == len(r_sub)
            if r_sub:
                np.testing.assert_allclose(p_sub, r_sub, rtol=1e-10)
    assert nzap > 0
    for got, want in zip(port.return_fit(0, 1), ref.return_fit(0, 1)):
        got, want = np.asarray(got), np.asarray(want)
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("extra", [
    ["-n", "3"], ["-n", "2", "-T"], ["-m", "MODEL"],
    ["-m", "MODEL", "-S", "0", "-R", "2.0"], ["-m", "MODEL", "-T"]],
    ids=["nstd3", "nstd2_tscrunch", "model", "model_rchi2",
         "model_tscrunch"])
def test_ppzap_cli_matches_reference(setup, extra):
    tmp, gm, hot, clean, meta = setup
    extra = [gm if a == "MODEL" else a for a in extra]
    tag = "_".join(a.strip("-") for a in extra if a != gm)
    ref, port = str(tmp / ("r_%s.cmds" % tag)), str(tmp / ("p_%s.cmds" % tag))
    args = ["-d", meta, "--quiet"] + extra
    assert jzap_cli.main(args + ["-o", ref]) == 0
    assert tzap_cli.main(args + ["-o", port, "--device", "cpu"]) == 0
    text = open(port).read()
    assert text == open(ref).read()
    assert "-z 3" in text


@pytest.mark.parametrize("method", ["mean", "max", "prof", "rms", "abs"])
def test_ppzap_norm_matches_reference_steps(setup, method, tmp_path):
    """-N: every fitted subint normalized, its per-channel noise
    re-estimated, then the median-noise cut — the JAX package's steps
    (its CLI passes get_noise a ``chans`` keyword its get_noise_PS does
    not take, so the steps run here one by one)."""
    _, _, hot, _, _ = setup
    data = jload(hot, dedisperse=False, tscrunch=False, pscrunch=True,
                 rm_baseline=True, quiet=True)
    data.subints = np.array(data.subints)
    data.noise_stds = np.array(data.noise_stds)
    for isub in data.ok_isubs:
        data.subints[isub, 0] = np.asarray(jnorm(
            data.subints[isub, 0], method=method,
            weights=data.weights[isub], return_norms=False))
        data.noise_stds[isub, 0] = np.asarray(jget_noise(
            data.subints[isub, 0]))
    want = jzap.print_paz_cmds([hot], [jzap.get_zap_channels(data, 3.0)],
                               modify=False, quiet=True)
    out = str(tmp_path / "p.cmds")
    assert tzap_cli.main(["-d", hot, "-n", "3", "-N", method, "-o", out,
                          "--quiet", "--device", "cpu"]) == 0
    assert open(out).read().splitlines() == want


def test_ppzap_cli_apply_and_refusals(setup, tmp_path, capsys):
    import shutil

    _, gm, hot, _, _ = setup
    work = str(tmp_path / "a.fits")
    shutil.copy(hot, work)
    cmds = str(tmp_path / "a.cmds")
    assert tzap_cli.main(["-d", work, "-m", gm, "-o", cmds, "--quiet",
                          "--device", "cpu"]) == 0
    listed = {(int(t[4]), int(t[6])) for t in (
        ln.split() for ln in open(cmds)) if t[:4] == ["paz", "-m", "-I",
                                                      "-z"]}
    assert listed
    assert tzap_cli.main(["-d", work, "-m", gm, "--apply", "--quiet",
                          "--device", "cpu"]) == 0
    before = tload(work, pscrunch=True, quiet=True, device="cpu").weights
    after = tload(str(tmp_path / "a.zap"), pscrunch=True, quiet=True,
                  device="cpu").weights
    zeroed = {(int(c), int(i)) for i, c in zip(*np.nonzero(
        (before > 0) & (after == 0)))}
    assert zeroed == listed
    assert tzap_cli.main(["-d", work, "--apply", "-o", "x", "--device",
                          "cpu"]) == 1
    # --hist draws the post-fit chi2s: without -m there are none, and
    # nothing is drawn (as the JAX CLI); with -m see test_torch_viz_cli.py
    assert tzap_cli.main(["-d", work, "--hist", "--quiet", "--device",
                          "cpu"]) == 0
    assert not os.path.exists(work + "_ppzap_hist.png")
    assert tzap_cli.main([]) == 1
    assert not os.path.exists("x")
