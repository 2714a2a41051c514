"""The port's load_data on the CPU against the JAX package's, and the load
kernels' plain versions against their definitions.

Each archive is written once by the port's make_fake_pulsar (or is one
of the vendored fixtures) and read by both packages.  Arrays agree to
1e-10 of the field's largest magnitude (the tolerance of
tests/test_torch_ops.py's fixture loads: the two packages take the same
sums in another order and by other FFTs), scalars to 1e-10 relative;
masks, weights, ok_ichans, Ps and freqs are equal.
"""

import os

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.io import archive as jarch
from pulseportraiture_tpu.io.fits import read_fits as jread_fits
from pulseportraiture_tpu.io.psrfits import read_archive as jread_archive
from pulseportraiture_tpu.ops.noise import get_SNR as jget_SNR
from pulseportraiture_tpu.ops.noise import get_noise as jget_noise
from pulseportraiture_tpu_torch import _kernels as K
from pulseportraiture_tpu_torch.io import archive as tarch
from pulseportraiture_tpu_torch.io.fits import read_fits
from pulseportraiture_tpu_torch.io.psrfits import (fscrunch_data,
                                                   read_archive,
                                                   tscrunch_data)
from pulseportraiture_tpu_torch.ops.fourier import apply_phasor, phasor
from pulseportraiture_tpu_torch.ops.noise import get_SNR, get_noise_PS

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
EXAMPLES = os.path.join(HERE, os.pardir, "examples")
GMODEL = os.path.join(EXAMPLES, "example.gmodel")
PAR = os.path.join(EXAMPLES, "example.par")
TOL = 1e-10

ARRAYS = ("subints", "noise_stds", "SNRs", "prof", "flux_prof", "phases")
SCALARS = ("prof_noise", "prof_SNR", "DM", "nbin", "nchan", "nsub", "npol",
           "bw", "nu0", "integration_length")
EQUAL = ("masks", "weights", "Ps", "freqs", "ok_isubs",
         "doppler_factors", "parallactic_angles")


def _rel(have, want):
    have, want = np.asarray(have, float), np.asarray(want, float)
    assert have.shape == want.shape
    if not want.size:
        return 0.0
    gap = np.abs(have - want)
    gap[np.isnan(have) & np.isnan(want)] = 0.0
    return float(gap.max() / max(np.nanmax(np.abs(want)), 1e-300))


def _same_load(have, want):
    for key in ARRAYS:
        assert _rel(have[key], want[key]) <= TOL, key
    for key in SCALARS:
        h, w = float(have[key]), float(want[key])
        assert abs(h - w) <= TOL * abs(w) or h == w, (key, h, w)
    for key in EQUAL:
        np.testing.assert_array_equal(np.asarray(have[key]),
                                      np.asarray(want[key]), err_msg=key)
    assert have.masks.dtype == want.masks.dtype == np.float64
    assert [list(c) for c in have.ok_ichans] == \
        [list(c) for c in want.ok_ichans]
    assert have.state == want.state and have.dmc == want.dmc
    assert [e.mjd() for e in have.epochs] == [e.mjd() for e in want.epochs]


def _weights(nsub, nchan):
    w = np.ones((nsub, nchan))
    if nchan > 2:
        w[:, 2] = 0.0
        w[nsub - 1, nchan - 1] = 0.0
    return w


# archive name -> make_fake_pulsar keywords (nsub 3, 8 channels, 64 bins
# unless given)
ARCHIVES = {
    "plain": {},
    "nsub1": dict(nsub=1),
    "nchan1": dict(nchan=1),
    "zapped_subint": dict(zap_subint=1),
    "coherence": dict(npol=4, state="Coherence"),
    "stokes": dict(npol=4, state="Stokes"),
    "dedispersed": dict(dedispersed=True),
    "odd_nbin": dict(nbin=63),
}

# case -> (archive, load_data keywords)
CASES = {
    "default": ("plain", {}),
    "nsub1": ("nsub1", {}),
    "nsub1_fscrunch_flux": ("nsub1", dict(fscrunch=True, flux_prof=True)),
    "nchan1": ("nchan1", dict(flux_prof=True)),
    "zapped_subint_tscrunch": ("zapped_subint", dict(tscrunch=True)),
    "zapped_subint": ("zapped_subint", {}),
    "coherence": ("coherence", {}),
    "coherence_pscrunch": ("coherence", dict(pscrunch=True)),
    "coherence_to_stokes": ("coherence", dict(state="Stokes")),
    "coherence_to_intensity": ("coherence", dict(state="Intensity")),
    "stokes": ("stokes", {}),
    "stokes_pscrunch": ("stokes", dict(pscrunch=True, flux_prof=True)),
    "stokes_to_coherence": ("stokes", dict(state="Coherence",
                                           pscrunch=True)),
    "dmc_reload": ("dedispersed", dict(dededisperse=True, pscrunch=True)),
    "dedispersed": ("dedispersed", dict(flux_prof=True)),
    "dedisperse": ("plain", dict(dedisperse=True)),
    "dedisperse_dededisperse": ("plain", dict(dedisperse=True,
                                              dededisperse=True)),
    "tscrunch": ("plain", dict(tscrunch=True)),
    "fscrunch": ("plain", dict(fscrunch=True)),
    "flux_prof": ("plain", dict(flux_prof=True)),
    "no_SNRs": ("plain", dict(get_SNRs=False)),
    "noise_fit": ("plain", dict(noise_method="fit")),
    "odd_nbin": ("odd_nbin", dict(flux_prof=True)),
    "no_baseline": ("plain", dict(rm_baseline=False)),
    "everything": ("coherence", dict(state="Stokes", dedisperse=True,
                                     tscrunch=True, pscrunch=True,
                                     fscrunch=True, flux_prof=True)),
}


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_load")
    out = {}
    for i, (name, kw) in enumerate(sorted(ARCHIVES.items())):
        kw = dict(kw)
        nsub, nchan = kw.pop("nsub", 3), kw.pop("nchan", 8)
        w = _weights(nsub, nchan)
        if "zap_subint" in kw:
            w[kw.pop("zap_subint")] = 0.0
        out[name] = tarch.make_fake_pulsar(
            GMODEL, PAR, str(tmp / (name + ".fits")), nsub=nsub,
            nchan=nchan, nbin=kw.pop("nbin", 64), tsub=60.0, phase=0.1,
            dDM=2e-3, weights=w, noise_stds=0.05, seed=20 + i, **kw)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_load_matches_reference(archives, case):
    name, kw = CASES[case]
    have = tarch.load_data(archives[name], device="cpu", **kw)
    want = jarch.load_data(archives[name], **kw)
    _same_load(have, want)
    # the returned archive holds the loaded cube
    np.testing.assert_array_equal(have.arch.data, have.subints)
    assert _rel(have.arch.data, want.arch.data) <= TOL
    assert have.arch.state == want.arch.state


_FIXTURES = [("psrchive_style", dict(pscrunch=True)),
             ("psrchive_style", dict(state="Stokes", tscrunch=True)),
             ("t2pred_style", {}),
             ("t2pred_style", dict(dedisperse=True, fscrunch=True,
                                   flux_prof=True)),
             ("stokes_style", {}),
             ("stokes_style", dict(state="Coherence", rm_baseline=False))]


@pytest.mark.parametrize("name,kw", _FIXTURES, ids=[
    "%s-%d" % (n, i) for i, (n, _) in enumerate(_FIXTURES)])
def test_fixture_loads_match_reference(name, kw):
    path = os.path.join(DATA, name + ".fits")
    _same_load(tarch.load_data(path, device="cpu", quiet=True, **kw),
               jarch.load_data(path, quiet=True, **kw))


def test_archive_object_and_refresh(archives):
    """An Archive passed in: refresh_arch copies it (the caller's stays
    as it was, still encoded), refresh_arch=False loads into it."""
    arch = read_archive(archives["plain"])
    d = tarch.load_data(arch, device="cpu", pscrunch=True, tscrunch=True)
    assert arch.encoded is not None and arch.nsub == 3
    tarch.load_data(arch, device="cpu", tscrunch=True, refresh_arch=False,
                    return_arch=False)
    assert arch.encoded is None and arch.nsub == 1
    np.testing.assert_array_equal(arch.data, d.subints)


def test_masks_broadcast_as_the_reference_einsum(archives):
    d = tarch.load_data(archives["coherence"], device="cpu")
    w = np.where(d.weights == 0.0, 0.0, 1.0)
    want = np.einsum("ij,k->ijk", w, np.ones(d.nbin))
    want = np.einsum("j,ikl->ijkl", np.ones(d.npol), want)
    assert d.masks.shape == want.shape == (3, 4, 8, 64)
    np.testing.assert_array_equal(d.masks, want)
    assert d.masks.flags.writeable and d.masks.flags.c_contiguous


def test_load_without_a_device_raises(archives, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tarch.load_data(archives["plain"])


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("which", ["tscrunch", "fscrunch"])
def test_scrunch_helpers_are_the_archive_methods(archives, which, kind):
    """tscrunch_data and fscrunch_data, the Archive's scrunch arithmetic
    that load_data runs on tensors, against the JAX package's Archive
    methods on the same cube (zapped weights included): numpy bit-equal,
    torch within 1e-14 of the largest magnitude (its sums run in another
    order); the weights they leave equal."""
    from pulseportraiture_tpu.io.psrfits import read_archive as jread

    want = jread(archives["plain"])
    want.dedisperse()
    arch = read_archive(archives["plain"])
    data, w = want.data.copy(), want.weights.copy()
    helper = dict(tscrunch=tscrunch_data, fscrunch=fscrunch_data)[which]
    if kind == "torch":
        data, w = torch.as_tensor(data), torch.as_tensor(w)
    have = helper(data, w)
    getattr(want, which)()
    getattr(arch, which + "_metadata")()
    np.testing.assert_array_equal(arch.weights, want.weights)
    if kind == "numpy":
        np.testing.assert_array_equal(have, want.data)
    else:
        assert _rel(have.numpy(), want.data) <= 1e-14
    one = data[:1] if which == "tscrunch" else data[:, :, :1]
    assert helper(one, w) is one   # one subint (channel): left as it is


# -- the plain versions against their definitions ---------------------------

def _rows(seed, rows=24, nbin=64, offset=40.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, nbin))
    x[:, nbin // 3:nbin // 3 + 5] += 6.0
    return x + offset * rng.uniform(-1, 1, (rows, 1))


def _be_rows(raw):
    """int16 rows as K5 takes them: the big-endian bytes of their values,
    read as an int16 tensor."""
    return torch.from_numpy(np.ascontiguousarray(raw).astype(">i2").view(
        np.int16))


def test_unpack_plain_is_numpys_decode():
    """K5 takes the stored (big-endian) rows: bit-equal to numpy's decode
    of their values, without and with the baseline."""
    rng = np.random.default_rng(1)
    raw = rng.integers(-32767, 32768, (12, 100)).astype(np.int16)
    scl = rng.uniform(1e-4, 1.0, 12).astype(np.float32).astype(np.float64)
    offs = rng.uniform(-50, 50, 12).astype(np.float32).astype(np.float64)
    want = raw.astype(np.float64) * scl[:, None] + offs[:, None]
    have = K.unpack(_be_rows(raw), torch.as_tensor(scl),
                    torch.as_tensor(offs))
    np.testing.assert_array_equal(have.numpy(), want)
    out = torch.empty(12, 100, dtype=torch.float64)
    assert K.unpack_plain(_be_rows(raw), torch.as_tensor(scl),
                          torch.as_tensor(offs), out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)
    # with the baseline: the decode, then baseline_plain
    both = K.unpack(_be_rows(raw), torch.as_tensor(scl),
                    torch.as_tensor(offs), frac=0.125)
    np.testing.assert_array_equal(
        both.numpy(), K.baseline_plain(torch.as_tensor(want)).numpy())


@pytest.mark.parametrize("pad", [0, 3, 16], ids=lambda p: "pad%d" % p)
@pytest.mark.parametrize("nbin", [1, 7, 64, 200])
def test_unpack_plain_of_stored_rows(nbin, pad):
    """The DATA column of FITS records whose stride and DATA offset are
    odd (a ``pad``-byte column first), read by io.fits as stored and
    packed by io.archive.stored_rows: unpack_plain bit-equal to numpy's
    decode of the values, without and with the baseline (then equal to
    baseline_plain of that decode)."""
    nsub, nchan = 3, 4
    rng = np.random.default_rng(nbin + pad)
    vals = rng.integers(-32768, 32768, (nsub, 1, nchan, nbin)).astype(
        np.int16)
    vals[0, 0, 0, :2] = (-32768, 32767)[:nbin]
    fields = ([("PAD", "S%d" % pad)] if pad else []) + [
        ("DATA", ">i2", (nchan * nbin,))]
    table = np.zeros(nsub, dtype=fields)
    table["DATA"] = vals.reshape(nsub, -1)
    buf = memoryview(table.tobytes())
    stored = np.frombuffer(buf, dtype=table.dtype)["DATA"].reshape(
        nsub, 1, nchan, nbin)
    assert stored.dtype == np.dtype(">i2")
    assert stored.strides[0] == table.dtype.itemsize
    rows = tarch.stored_rows(stored, torch.device("cpu"))
    assert rows.dtype == torch.int16 and rows.shape == (nsub * nchan, nbin)
    np.testing.assert_array_equal(K.stored_values(rows).numpy(),
                                  vals.reshape(-1, nbin))
    scl = rng.uniform(1e-4, 1.0, nsub * nchan).astype(np.float32).astype(
        np.float64)
    offs = rng.uniform(-50, 50, nsub * nchan).astype(np.float32).astype(
        np.float64)
    want = vals.reshape(-1, nbin).astype(np.float64) * scl[:, None] \
        + offs[:, None]
    args = (rows, torch.as_tensor(scl), torch.as_tensor(offs))
    np.testing.assert_array_equal(K.unpack_plain(*args).numpy(), want)
    np.testing.assert_array_equal(
        K.unpack_plain(*args, frac=0.125).numpy(),
        K.baseline_plain(torch.as_tensor(want)).numpy())
    # a native column packs to the same stored bytes
    assert torch.equal(tarch.stored_rows(vals, torch.device("cpu")), rows)


@pytest.mark.parametrize("nbin", [1, 7, 64, 200])
def test_baseline_plain_is_the_least_window_mean(nbin):
    x = _rows(nbin, nbin=nbin)
    nwin = K.baseline_window(nbin)
    assert nwin == max(1, int(0.125 * nbin))
    idx = (np.arange(nbin)[:, None] + np.arange(nwin)[None, :]) % nbin
    level = x[:, idx].mean(axis=-1).min(axis=-1, keepdims=True)
    want = x - level
    have = K.baseline(torch.as_tensor(x)).numpy()
    spread = np.ptp(x, axis=-1, keepdims=True)
    assert np.all(np.abs(have - want) <= 1e-12 * np.maximum(spread, 1.0))
    # in place, as load_data runs it
    t = torch.as_tensor(x.copy())
    assert K.baseline(t, out=t) is t
    np.testing.assert_array_equal(t.numpy(), have)


def test_load_stats_plain_is_get_noise_and_get_SNR():
    x = torch.as_tensor(_rows(3, nbin=128, offset=0.0))
    x[5] -= x[5].mean() + 0.5   # sum < 0 < max: Weq <= 0, S/N masked
    X = torch.fft.rfft(x, dim=-1)
    noise = torch.empty(x.shape[0], dtype=torch.float64)
    snr = torch.empty_like(noise)
    K.load_stats(x, X, noise, snr)
    np.testing.assert_array_equal(noise.numpy(), get_noise_PS(x).numpy())
    np.testing.assert_array_equal(snr.numpy(), get_SNR(x).numpy())
    assert snr[5] == 0.0
    # the JAX package's estimators, on the same rows
    np.testing.assert_allclose(noise.numpy(), np.asarray(jget_noise(
        x.numpy())), rtol=1e-12)
    np.testing.assert_allclose(snr.numpy(), np.asarray(jget_SNR(x.numpy())),
                               rtol=1e-12, atol=1e-12)
    only = torch.empty_like(noise)
    K.load_stats(x, X, only)
    np.testing.assert_array_equal(only.numpy(), noise.numpy())


def test_rotate_plain_is_apply_phasor():
    rng = np.random.default_rng(4)
    X = torch.as_tensor(rng.standard_normal((3, 5, 33))
                        + 1j * rng.standard_normal((3, 5, 33)))
    s = torch.as_tensor(rng.uniform(-40, 40, (3, 5)))
    have = K.rotate(X, s)
    np.testing.assert_array_equal(have.numpy(),
                                  (X * phasor(s, 33)).numpy())
    np.testing.assert_array_equal(apply_phasor(X, s).numpy(), have.numpy())
    k = np.arange(33)
    want = X.numpy() * np.exp(2j * np.pi * np.mod(s.numpy()[..., None] * k,
                                                  1.0))
    np.testing.assert_allclose(have.numpy(), want, rtol=0, atol=1e-12)
    # broadcast shifts, and in place
    row = K.rotate(X, s[0])
    np.testing.assert_array_equal(row[1].numpy(), (X[1] * phasor(
        s[0], 33)).numpy())
    Y = X.clone()
    assert K.rotate(Y, s, out=Y) is Y
    np.testing.assert_array_equal(Y.numpy(), have.numpy())


def test_model_rotation_is_differentiable_without_the_kernel(monkeypatch):
    """The fitted model's join rotation (gen_gaussian_portrait, under
    torch.func's vmap and jacfwd in the Gaussian fit) is the
    differentiable phasor product and never K7, whose launch carries no
    derivative: with _kernels.rotate refused the Jacobian is the same as
    the finite difference of the portrait in the join parameters."""
    from pulseportraiture_tpu_torch.ops.profiles import gen_gaussian_portrait

    def refuse(*a, **kw):
        raise AssertionError("K7 on a fitted model")

    freqs = np.linspace(1100.0, 1900.0, 6)
    params = np.array([0.02, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2,
                       0.0, 0.013])
    joins = [np.arange(0, 3), np.arange(3, 6)]
    phases = np.arange(64) / 64.0

    def port(v):
        return gen_gaussian_portrait("001", v, -4.0, phases, freqs, 1500.0,
                                     joins, 0.005)

    x = torch.as_tensor(np.concatenate([params[:8], [0.0, 1e-3],
                                        params[8:]]))
    monkeypatch.setattr(K, "rotate", refuse)
    jac = torch.func.vmap(torch.func.jacfwd(port))(x[None])[0]
    h = 1e-6
    for i in (8, 9, 10, 11):
        e = torch.zeros_like(x)
        e[i] = h
        fd = (port(x + e) - port(x - e)) / (2 * h)
        assert float((jac[..., i] - fd).abs().max()) <= \
            1e-6 * float(fd.abs().max())
        assert float(fd.abs().max()) > 0.0


def test_kernel_wrappers_check_their_arguments():
    x = torch.zeros(4, 16, dtype=torch.float64)
    with pytest.raises(TypeError):
        K.unpack(x, torch.ones(4, dtype=torch.float64),
                 torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        K.unpack(torch.zeros(4, 16, dtype=torch.int16),
                 torch.ones(3, dtype=torch.float64),
                 torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        K.load_stats(x, torch.zeros(4, 8, dtype=torch.complex128),
                     torch.empty(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        K.rotate(torch.zeros(4, 9, dtype=torch.complex128),
                 torch.zeros(4), out=torch.zeros(2, 9,
                                                 dtype=torch.complex128))


def test_load_split_names_its_steps(archives):
    split = {}
    tarch.load_data(archives["plain"], device="cpu", dedisperse=True,
                    split=split)
    assert set(split) <= set(tarch.LOAD_STEPS)
    assert {"read", "upload", "K5", "rotate", "cuFFT", "K6", "K7",
            "download"} <= set(split)
    assert all(v >= 0.0 for v in split.values())


def test_read_archive_keeps_the_column_encoded(archives):
    arch = read_archive(archives["coherence"])
    raw, scl, offs = arch.encoded
    assert raw.dtype == np.int16 and raw.shape == (3, 4, 8, 64)
    assert scl.shape == offs.shape == (3, 4, 8)
    want = raw.astype(np.float64) * scl[..., None] + offs[..., None]
    copy = arch.copy()
    assert copy.encoded is not None
    np.testing.assert_array_equal(arch.data, want)
    assert arch.encoded is None and copy.encoded is not None
    np.testing.assert_array_equal(copy.data, want)
    assert (arch.nsub, arch.npol, arch.nchan, arch.nbin) == (3, 4, 8, 64)


# -- the DATA column as stored ----------------------------------------------

FIXTURE_FILES = ("psrchive_style", "t2pred_style", "stokes_style")
FITS_FILES = FIXTURE_FILES + tuple(sorted(ARCHIVES))


def _fits_path(archives, name):
    return os.path.join(DATA, name + ".fits") if name in FIXTURE_FILES \
        else archives[name]


@pytest.mark.parametrize("name", FITS_FILES)
def test_read_fits_matches_reference(archives, name):
    """The port's read_fits against the JAX package's, HDU by HDU: the
    same header cards in the same order, the same columns with the same
    shapes and values; every column but DATA in native byte order as
    there, DATA a read-only big-endian view of the file's bytes."""
    path = _fits_path(archives, name)
    have, want = read_fits(path), jread_fits(path)
    assert len(have) == len(want)
    for h, w in zip(have, want):
        assert h.header.order == w.header.order
        assert dict(h.header) == dict(w.header)
        assert list(h.columns) == list(w.columns)
        for key, wc in w.columns.items():
            hc = h.columns[key]
            assert hc.shape == wc.shape, key
            np.testing.assert_array_equal(hc, wc, err_msg=key)
            if key == "DATA":
                assert hc.dtype == np.dtype(">i2") and wc.dtype == np.int16
                assert not hc.flags.writeable
            else:
                assert hc.dtype == wc.dtype, key
    assert any("DATA" in h.columns for h in have)


@pytest.mark.parametrize("name", FITS_FILES)
def test_stored_view_is_the_encoded_column(archives, name):
    """Archive.stored is the file's big-endian column: byte-swapped it is
    Archive.encoded (native int16), and encoded decoded is the JAX
    package's cube, bit for bit; neither read expands the cube."""
    path = _fits_path(archives, name)
    arch = read_archive(path)
    raw, scl, offs = arch.stored
    enc, escl, eoffs = arch.encoded
    assert raw.dtype == np.dtype(">i2") and enc.dtype == np.int16
    assert raw.shape == enc.shape == (arch.nsub, arch.npol, arch.nchan,
                                      arch.nbin)
    np.testing.assert_array_equal(raw.view(np.int16).byteswap(), enc)
    assert escl is scl and eoffs is offs and arch.stored is not None
    want = jread_archive(path).data
    np.testing.assert_array_equal(
        enc.astype(np.float64) * scl[..., None] + offs[..., None], want)
    np.testing.assert_array_equal(arch.data, want)
