"""Bounded Levenberg-Marquardt least squares in PyTorch.

Port of the JAX package's ``fit/lm.py`` (which stands in for the
reference's lmfit ``leastsq`` in fit_powlaw, fit_gaussian_profile and
fit_gaussian_portrait, pplib.py:1763-2052).  The Jacobian is forward-mode
(``torch.func.jacfwd`` of the residual, as the JAX package's
``jax.jacfwd``), and the iteration is a masked batched loop: each pass
gathers the problems not yet done, steps them and scatters the results
back, so a batch [B, nparam] steps in lockstep and a finished problem
stays frozen exactly as under ``vmap`` of the JAX package's
``lax.while_loop``.  The ``done`` test syncs the host once per pass.
A problem can instead be given through its normal equations
(``normal=``: the sum of squares, J^T r and J^T J from one call), and
then no Jacobian is formed: the Gaussian portrait fit gives them from
kernel K9 when unscattered and unjoined, from K10 when scattered or
joined (fit.gauss.portrait_route), and keeps jacfwd for the fits neither
takes.

Error semantics follow lmfit's defaults: the covariance is
``inv(J^T J) * red_chi2`` with J the err-weighted Jacobian at the
solution (Jacobi-equilibrated, inverted by ``inv_refined``), and
stderr = sqrt(diag(cov)); frozen parameters report 0 and parameters
whose Jacobian column vanishes (unidentifiable) report inf.
"""

import math

import torch

from ..config import real_dtype, resolve_device
from ..utils.databunch import DataBunch
from .smallsolve import inv_refined, solve_refined

__all__ = ["lm_solve"]


def _vec(value, n, fill, device):
    if value is None:
        return torch.full((n,), fill, dtype=real_dtype, device=device)
    return torch.as_tensor(value, dtype=real_dtype, device=device)


def lm_solve(residual_fn, x0, fit_flags=None, bounds=None, max_iter=100,
             ftol=1e-12, xtol=1e-12, args=(), device=None, normal=None):
    """Minimize ``sum(residual_fn(x, *args)**2)`` over x.

    residual_fn: x [nparam] (+args) -> err-weighted residuals [N], built
    from torch operations that ``torch.func`` can batch and differentiate
    (no data-dependent Python branches).  x0: initial parameters [nparam]
    or [B, nparam] (independent problems solved in lockstep).
    fit_flags: optional 0/1 mask [nparam]; 0 freezes a parameter.
    bounds: optional (lo [nparam], hi [nparam]) (+-inf = free).
    Runs on x0's device when it is a tensor, else on ``device`` (None =
    the CUDA device).  Returns DataBunch(params, param_errs, covar, chi2,
    red_chi2, nfev, return_code, ndata) of tensors, batched like x0.

    normal: optional; the problem through its normal equations in place
    of residual_fn (which is then not called): an object with
    ``sse(x [B, nparam]) -> f [B]`` (sum r^2), ``normal(x) -> (f [B],
    g [B, nparam], JtJ [B, nparam, nparam])`` (g = J^T r, JtJ = J^T J of
    the err-weighted residuals r and their Jacobian J) and ``ndata``.
    Every pass and the covariance use it; the flags and the
    identifiability mask act on JtJ as they act on J, since
    (J D)^T (J D) = D J^T J D for a diagonal D.
    """
    if isinstance(x0, torch.Tensor):
        device = x0.device
    else:
        device = resolve_device(device)
    x0 = torch.as_tensor(x0, dtype=real_dtype, device=device)
    single = x0.ndim == 1
    x = x0[None].clone() if single else x0.clone()
    B, nparam = x.shape
    flags = _vec(fit_flags, nparam, 1.0, device)
    lo = _vec(None if bounds is None else bounds[0], nparam, -math.inf,
              device)
    hi = _vec(None if bounds is None else bounds[1], nparam, math.inf,
              device)
    eye = torch.eye(nparam, dtype=real_dtype, device=device)
    unfit = eye * (1.0 - flags)

    if normal is None:
        def res(p):
            return residual_fn(p, *args).to(real_dtype)

        def res_twice(p):
            r = res(p)
            return r, r

        res_b = torch.func.vmap(res)
        jac_b = torch.func.vmap(torch.func.jacfwd(res_twice, has_aux=True))

        def sse(p):
            r = res_b(p)
            return torch.sum(r * r, dim=-1)

        def gradient_normal(p):
            J, r = jac_b(p)
            J = J * flags
            return (torch.einsum("bnp,bn->bp", J, r),
                    torch.einsum("bnp,bnq->bpq", J, J))

        def normal_matrix(p):
            J = jac_b(p)[0] * flags
            return torch.einsum("bnp,bnq->bpq", J, J)

        r0 = res_b(x)
        ndata = r0.shape[-1]
        f = torch.sum(r0 * r0, dim=-1)
    else:
        sse = normal.sse
        flags2 = flags[:, None] * flags[None, :]

        def gradient_normal(p):
            _, g, JtJ = normal.normal(p)
            return g * flags, JtJ * flags2

        def normal_matrix(p):
            return gradient_normal(p)[1]

        ndata = int(normal.ndata)
        f = sse(x)
    mu = torch.full((B,), 1e-3, dtype=real_dtype, device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    nfev = torch.ones(B, dtype=torch.long, device=device)
    rc = torch.full((B,), 3, dtype=torch.long, device=device)

    for _ in range(int(max_iter)):
        act = torch.nonzero(~done).flatten()
        if act.numel() == 0:
            break
        xa, fa, mua = x[act], f[act], mu[act]
        g, JtJ = gradient_normal(xa)
        scale_d = torch.clamp(torch.abs(torch.diagonal(JtJ, dim1=-2,
                                                       dim2=-1)), min=1e-30)
        A = JtJ + mua[:, None, None] * torch.diag_embed(scale_d) + unfit
        raw_trial = xa - solve_refined(A, g)
        trial = torch.minimum(torch.maximum(raw_trial, lo), hi)
        f_t = sse(trial)
        accept = f_t < fa
        mu_new = torch.where(accept, torch.clamp(mua * 0.3, min=1e-14),
                             mua * 5.0)
        x_new = torch.where(accept[:, None], trial, xa)
        f_new = torch.where(accept, f_t, fa)
        df = torch.abs(fa - f_new)
        dx = torch.amax(torch.abs(x_new - xa), dim=-1)
        f_conv = accept & (df <= ftol * torch.clamp(f_new, min=1.0))
        x_conv = accept & (dx <= xtol * torch.clamp(
            torch.amax(torch.abs(x_new), dim=-1), min=1.0))
        # a rejected, unclipped step whose own predicted decrease
        # (2 g . step) is below ftol marks the arithmetic floor: stop
        # there rather than spiral mu up to 1e12 (the JAX package's
        # plateau exit); clipped or uphill proposals keep inflating mu
        pred_dec = -2.0 * torch.sum(g * (trial - xa), dim=-1)
        unclipped = torch.all((raw_trial >= lo) & (raw_trial <= hi), dim=-1)
        plateau = (~accept) & unclipped & (pred_dec >= 0.0) & \
            (pred_dec <= ftol * torch.clamp(fa, min=1.0))
        stuck = (~accept) & (mu_new > 1e12)
        rc_a = torch.where(f_conv | plateau, 1, torch.where(
            x_conv, 2, torch.where(stuck, 4, rc[act])))
        x[act], f[act], mu[act], rc[act] = x_new, f_new, mu_new, rc_a
        done[act] = f_conv | x_conv | plateau | stuck
        nfev[act] += 2

    # lmfit-style covariance at the solution; unidentifiable parameters
    # (a vanishing Jacobian column, e.g. tau pinned at its 0 bound) are
    # left out of the inverse like frozen ones and report inf
    JtJ = normal_matrix(x)
    colnorm = torch.diagonal(JtJ, dim1=-2, dim2=-1)          # [B, nparam]
    ident = flags * (colnorm > 1e-30)
    JtJ = JtJ * (ident[:, :, None] * ident[:, None, :]) + \
        torch.diag_embed(1.0 - ident)
    nfit = torch.sum(flags)
    dof = torch.clamp(ndata - nfit, min=1.0)
    red_chi2 = f / dof
    # Jacobi equilibration bounds the condition number the float32 seed
    # inverse sees (amp ~1, wid ~1e-2, slopes ~1e-3 mix scales)
    d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(JtJ, dim1=-2, dim2=-1),
                                     min=1e-300))
    di, dj = d[:, :, None], d[:, None, :]
    cov = (inv_refined(di * JtJ * dj) * di * dj) * red_chi2[:, None, None]
    perr = torch.sqrt(torch.diagonal(cov, dim1=-2, dim2=-1)) * flags
    perr = torch.where(flags * (1.0 - ident) > 0,
                       torch.full_like(perr, math.inf), perr)
    out = DataBunch(params=x, param_errs=perr, covar=cov, chi2=f,
                    red_chi2=red_chi2, nfev=nfev, return_code=rc,
                    ndata=ndata)
    if single:
        return DataBunch(**{k: (v[0] if isinstance(v, torch.Tensor) else v)
                            for k, v in out.items()})
    return out
