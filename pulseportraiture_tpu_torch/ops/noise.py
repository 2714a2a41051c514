"""Off-pulse noise and S/N estimators, and the noise-floor filters.

Port of the JAX package's ``ops/noise.py`` (reference pplib.py:1393-1495
and :2206-2308), batched over every leading dimension and run on the
device of the data:

* "PS" — the square root of the mean of the top quarter of the power
  spectrum (the pipelines' default);
* "fit" — the mean power above a noise-floor cutoff harmonic that
  ``find_kc`` fits to the log power spectrum by brute force over a
  20 x 20 x 20 (a, b, dc) grid, as the reference's ``opt.brute`` does.

``find_kc`` does not build the JAX package's [Ns, Ns, Ns, N] model per
channel (65.6 MB at nbin 2048; 8.6 TB for the channels of a 256 x 512
archive).  chi2(a, b, dc) = sum_k (y_k - b s_a(k) - dc)^2 expands, with
y the log power less its mean, into per-channel sums — sum y, sum y^2,
and sum_k y_k s_a(k), one [C, N] x [N, Ns] product — and per-a sums of
s_a and s_a^2, so the grid is a cheap [C, Ns^3] pass over blocks of
channels.  The pass keeps the reference's choice on ties: at b = 0 every
a gives the same chi2 bit for bit (each a-dependent term is multiplied
by b = 0 exactly, and equal shapes share one column of the product), and
the first flat index, a-major, wins.  A channel with a non-finite log
power (a zero power, as in an all-zero channel) makes the reference's
b grid start with 0 * inf = NaN, so its first grid point is NaN and its
argmin 0: the port sets a = a_0 for such channels directly.
"""

import torch

from ..config import real_dtype

__all__ = ["get_noise", "get_noise_PS", "get_noise_fit", "get_SNR",
           "find_kc", "half_triangle_function", "wiener_filter",
           "brickwall_filter", "fit_brickwall", "wiener_smooth"]

# channels of the (a, b, dc) grid evaluated at a time: 2048 x 20^3
# float64 is 131 MB per grid-sized temporary.  On the card a block's ~75
# small launches cost more than its arithmetic, so its blocks are 8x
# larger (1 GB per temporary, ~4 GB in all)
GRID_ROWS = 2048
GRID_ROWS_CUDA = 16384


def _block_rows(device):
    return GRID_ROWS_CUDA if device.type == "cuda" else GRID_ROWS


def get_noise(data, method="PS", **kwargs):
    """Noise level per leading-batch element of ``data`` [..., nbin]
    (reference pplib.py:2206-2225)."""
    if method == "PS":
        return get_noise_PS(data, **kwargs)
    if method == "fit":
        return get_noise_fit(data, **kwargs)
    raise ValueError(f"Unknown get_noise method '{method}'.")


def _power(data):
    """rFFT and |rFFT|^2 / nbin of profiles [..., nbin]."""
    FFT = torch.fft.rfft(data, dim=-1)
    return FFT, (FFT * torch.conj(FFT)).real / data.shape[-1]


def get_noise_PS(data, frac=4):
    """Noise from the mean of the top 1/frac of the power spectrum
    (reference pplib.py:2227-2253)."""
    pows = _power(torch.as_tensor(data).to(real_dtype))[1]
    kc = int((1 - 1.0 / frac) * pows.shape[-1])
    return torch.sqrt(torch.mean(pows[..., kc:], dim=-1))


def half_triangle_function(a, b, dc, N):
    """Half-triangle of base floor(a) and height b on a dc baseline, at
    k = 0..N-1 (reference pplib.py:1436-1446)."""
    a = torch.floor(torch.as_tensor(a, dtype=real_dtype))
    k = torch.arange(N, dtype=real_dtype, device=a.device)
    return dc + torch.where(k < a, b - (b / a) * k, 0.0)


def _linspace_rows(start, stop, num):
    """jnp.linspace(start, stop, num) per row of start/stop [C] -> [C, num]
    (start (1 - i/div) + stop i/div, the endpoint set exactly)."""
    step = torch.arange(num - 1, dtype=real_dtype,
                        device=stop.device) / (num - 1)
    return torch.cat([start[:, None] * (1 - step) + stop[:, None] * step,
                      stop[:, None]], dim=-1)


def _kc_grid(N, fn, Ns, device):
    """The a grid of find_kc (reference pplib.py:1448-1495): the distinct
    shapes s_a(k) [U, N], the index of each a's shape [Ns], the sums of
    each a's shape and of its square [Ns], and the cutoff harmonic of
    each a [Ns].  Equal shapes (half_tri's floor(a) can repeat) share one
    row, so they tie bit for bit as in the literal grid."""
    k = torch.arange(N, dtype=real_dtype, device=device)
    one = torch.ones(1, dtype=real_dtype, device=device)
    if fn == "exp_dc":
        a_grid = _linspace_rows(one / N, one, Ns)[0]
        shape = torch.exp(-a_grid[:, None] * k[None, :])
        # the first k with exp(-a k) < 0.005, else N - 1
        below = shape < 0.005
        kc = torch.where(below.any(dim=-1), torch.argmax(below.to(
            torch.uint8), dim=-1), N - 1)
    elif fn == "half_tri":
        a_grid = _linspace_rows(one, one * N, Ns)[0]
        fa = torch.floor(a_grid)[:, None]
        shape = torch.where(k[None, :] < fa, 1.0 - k[None, :] / fa, 0.0)
        kc = torch.floor(a_grid).to(torch.int64)
    else:
        raise ValueError(f"Unknown find_kc fn '{fn}'.")
    uniq, inverse = torch.unique(shape, dim=0, return_inverse=True)
    return (uniq, inverse, uniq.sum(dim=-1)[inverse],
            (uniq * uniq).sum(dim=-1)[inverse], kc)


def _argmin_a(logp, grid, Ns):
    """Index of a at the brute-force minimum of chi2(a, b, dc) per row of
    logp [R, N] (``grid`` from _kc_grid), the first flat (a, b, dc) index
    on ties (see the module docstring)."""
    N = logp.shape[-1]
    lmin, lmax = logp.amin(dim=-1), logp.amax(dim=-1)
    b = _linspace_rows(torch.zeros_like(lmin), lmax - lmin, Ns)   # [R, Ns]
    dc = _linspace_rows(lmin, lmax, Ns)
    finite = torch.isfinite(logp).all(dim=-1)
    logp = torch.where(finite[:, None], logp, 0.0)
    b = torch.where(finite[:, None], b, 0.0)
    mean = logp.mean(dim=-1, keepdim=True)
    y = logp - mean
    d = torch.where(finite[:, None], dc, 0.0) - mean              # [R, Ns]
    uniq, inverse, S1, S2, _ = grid
    Ya = (y @ uniq.T)[:, inverse]                                 # [R, Na]
    Sy, Syy = y.sum(dim=-1), (y * y).sum(dim=-1)
    T = b[:, None, :] * b[:, None, :] * S2[None, :, None] \
        - 2.0 * b[:, None, :] * Ya[:, :, None]                    # [R, a, b]
    U = N * d * d - 2.0 * d * Sy[:, None]                         # [R, dc]
    V = 2.0 * b[:, None, :, None] * d[:, None, None, :] \
        * S1[None, :, None, None]                                 # [R,a,b,dc]
    chi2 = (Syy[:, None, None] + T)[..., None] + U[:, None, None, :] + V
    ia = torch.argmin(chi2.reshape(chi2.shape[0], -1), dim=-1) // (Ns * Ns)
    return torch.where(finite, ia, 0)


def find_kc(pows, fn="exp_dc", Ns=20):
    """Noise-floor cutoff harmonic from a brute fit to log10 power, per
    row of ``pows`` [..., N] (int64 [...]; reference pplib.py:1448-1495):

    * 'exp_dc' (default): model b exp(-a k) + dc, a in [1/N, 1], b in
      [0, range], dc in [min, max] of the row's log power; the cutoff is
      the first k with exp(-a k) < 0.005, else N - 1;
    * 'half_tri': model half_triangle(a, b, dc), a in [1, N]; the cutoff
      is floor(a).
    """
    pows = torch.as_tensor(pows).to(real_dtype)
    rows = pows.reshape(-1, pows.shape[-1])
    grid = _kc_grid(rows.shape[-1], fn, Ns, rows.device)
    out = torch.empty(rows.shape[0], dtype=torch.int64, device=rows.device)
    step = _block_rows(rows.device)
    for i in range(0, rows.shape[0], step):
        s = slice(i, i + step)
        out[s] = grid[-1][_argmin_a(torch.log10(rows[s]), grid, Ns)]
    return out.reshape(pows.shape[:-1])


def get_noise_fit(data, fact=1.1, fn="exp_dc"):
    """Noise from the harmonics at and above k_crit = min(fact
    find_kc(pows), int(0.99 npow)), per leading-batch element of
    ``data`` [..., nbin] (reference pplib.py:2255-2287)."""
    data = torch.as_tensor(data).to(real_dtype)
    rows = data.reshape(-1, data.shape[-1])
    npow = data.shape[-1] // 2 + 1
    grid = _kc_grid(npow, fn, 20, data.device)
    k = torch.arange(npow, dtype=real_dtype, device=data.device)
    out = torch.empty(rows.shape[0], dtype=real_dtype, device=data.device)
    step = _block_rows(data.device)
    for i in range(0, rows.shape[0], step):
        s = slice(i, i + step)
        pows = _power(rows[s])[1]
        kc = grid[-1][_argmin_a(torch.log10(pows), grid, 20)]
        k_crit = torch.clamp(fact * kc.to(real_dtype), max=int(0.99 * npow))
        mask = k[None, :] >= k_crit[:, None]
        out[s] = torch.sqrt(torch.where(mask, pows, 0.0).sum(dim=-1)
                            / mask.sum(dim=-1))
    return out.reshape(data.shape[:-1])


def wiener_filter(prof, noise):
    """Per-harmonic Wiener filter H_k = S_k / (S_k + N_k) of a noisy
    profile [..., nbin]: the JAX package's working version of the
    reference's unfinished filter (pplib.py:1393-1408), with the signal
    power the measured power less the noise floor noise^2, clipped at 0."""
    pows = _power(torch.as_tensor(prof).to(real_dtype))[1]
    return _wiener_from_pows(pows, noise)


def _wiener_from_pows(pows, noise):
    sig = torch.clamp(pows - noise ** 2, min=0.0)
    return sig / (sig + noise ** 2)


def brickwall_filter(N, kc):
    """Ones below harmonic kc, zeros from it on: [..., N] for kc [...]
    (reference pplib.py:1410-1418)."""
    kc = torch.as_tensor(kc)
    return torch.where(torch.arange(N, device=kc.device) < kc[..., None],
                       1.0, 0.0).to(real_dtype)


def fit_brickwall(prof, noise):
    """The brickwall cutoff kc closest (L2) to the profile's Wiener filter
    (reference pplib.py:1420-1434, in closed form with cumulative sums)."""
    return _fit_brickwall_from_wf(wiener_filter(prof, noise))


def _fit_brickwall_from_wf(wf):
    # X2(kc) = sum_{i<kc} (wf_i - 1)^2 + sum_{i>=kc} wf_i^2
    zero = torch.zeros(wf.shape[:-1] + (1,), dtype=wf.dtype, device=wf.device)
    ones_cost = torch.cat([zero, torch.cumsum((wf - 1.0) ** 2, dim=-1)],
                          dim=-1)
    tot = torch.sum(wf ** 2, dim=-1, keepdim=True)
    zeros_cost = tot - torch.cat([zero, torch.cumsum(wf ** 2, dim=-1)],
                                 dim=-1)
    return torch.argmin(ones_cost + zeros_cost, dim=-1)


def wiener_smooth(prof, noise, brickwall=False):
    """The profile [..., nbin] filtered by its Wiener filter (or by the
    best-fit brickwall)."""
    prof = torch.as_tensor(prof)
    nbin = prof.shape[-1]
    FFT, pows = _power(prof.to(real_dtype))
    H = _wiener_from_pows(pows, noise)
    if brickwall:
        H = brickwall_filter(nbin // 2 + 1, _fit_brickwall_from_wf(H))
    return torch.fft.irfft(FFT * H, nbin, dim=-1).to(prof.dtype)


def get_SNR(prof, fudge=3.25, noise_method="PS"):
    """Lorimer & Kramer S/N with the reference's PSRCHIVE-matching fudge
    (pplib.py:2289-2308).  Assumes the baseline has been removed."""
    prof = torch.as_tensor(prof).to(real_dtype)
    noise = get_noise(prof, method=noise_method)
    Weq = prof.sum(dim=-1) / prof.max(dim=-1).values
    mask = torch.where(Weq <= 0.0, 0.0, 1.0).to(real_dtype)
    Weq = torch.where(Weq <= 0.0, torch.ones_like(Weq), Weq)
    SNR = prof.sum(dim=-1) / (noise * Weq ** 0.5)
    return (SNR * mask) / fudge
