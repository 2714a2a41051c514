"""Small batched solves: unrolled Cholesky, and float32 LU + float64
iterative refinement.

Port of the JAX package's ``fit/smallsolve.py``.  ``chol_factor``,
``chol_solve``, ``solve_sym`` and ``inv_sym`` unroll the Cholesky
factorization over the (static, tiny) n as elementwise ops batched over
the leading dimensions; a non-positive-definite input gives NaN (the
square root of a negative pivot), as in the reference.

``solve_refined`` and ``inv_refined`` keep the reference's arithmetic —
one float32 LU, then two float64 refinement passes — so that the solver's
accept/reject decisions match the reference's.  The ``_ex`` variants are
used on purpose: ``torch.linalg.lu_factor`` raises on a zero pivot,
whereas the reference yields inf/NaN, which the Levenberg loop then
rejects (raising its damping).  Here a singular system likewise yields
non-finite steps instead of an exception.

Float32 subnormals in the matrix and the right-hand side are flushed to
zero before the float32 stage, as the reference's CPU backend runs with
denormals-are-zero: a damping term mu * 1e-30 on a parameter whose
Jacobian column vanishes (tau at its 0 bound in the Gaussian fits) is
then a zero pivot, the step is non-finite and the Levenberg loop rejects
it and raises its damping, exactly as in the reference.
"""

import torch

__all__ = ["chol_factor", "chol_solve", "solve_sym", "inv_sym",
           "matvec", "solve_refined", "inv_refined"]


def chol_factor(A):
    """Lower-triangular Cholesky factor of symmetric A [..., n, n]."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    zero = torch.zeros_like(A[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero
                                     for j in range(n)], dim=-1)
                        for i in range(n)], dim=-2)


def chol_solve(L, b):
    """x with A x = b, given L = chol_factor(A); b [..., n]."""
    n = L.shape[-1]
    y = [None] * n
    for i in range(n):                   # forward substitution: L y = b
        s = b[..., i]
        for p in range(i):
            s = s - L[..., i, p] * y[p]
        y[i] = s / L[..., i, i]
    x = [None] * n
    for i in reversed(range(n)):         # back substitution: L^T x = y
        s = y[i]
        for p in range(i + 1, n):
            s = s - L[..., p, i] * x[p]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def solve_sym(A, b):
    """x = A^-1 b for symmetric (positive-definite) A [..., n, n]."""
    return chol_solve(chol_factor(A), b)


def inv_sym(A):
    """Inverse of symmetric (positive-definite) A [..., n, n]."""
    n = A.shape[-1]
    L = chol_factor(A)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return torch.stack([chol_solve(L, torch.broadcast_to(
        eye[i], A.shape[:-2] + (n,))) for i in range(n)], dim=-1)


def _f32(x):
    """float32 with subnormals flushed to zero (denormals-are-zero)."""
    x = x.to(torch.float32)
    return torch.where(torch.abs(x) < torch.finfo(torch.float32).tiny,
                       torch.zeros_like(x), x)


def matvec(A, x):
    """A x for A [..., n, n], x [..., n].  On a CUDA device each element
    is summed over j in index order by elementwise ops: cuBLAS picks its
    batched kernel by the batch count, so a product batched over a
    solver's lanes would give a lane bits that depend on how many lanes
    share the call (and a sharded fit's subint groups share fewer)."""
    if not A.is_cuda:
        return torch.einsum("...ij,...j->...i", A, x)
    out = A[..., 0] * x[..., None, 0]
    for j in range(1, A.shape[-1]):
        out = out + A[..., j] * x[..., None, j]
    return out


def solve_refined(A, b, refinements=2):
    """x = A^-1 b for A [..., n, n], b [..., n]: f32 LU + f64 refinement
    (r = b - A x; x += A_f32^-1 r)."""
    lu, piv, _ = torch.linalg.lu_factor_ex(_f32(A))

    def solve32(rhs):
        return torch.linalg.lu_solve(
            lu, piv, _f32(rhs)[..., None])[..., 0].to(A.dtype)

    x = solve32(b)
    for _ in range(refinements):
        r = b - matvec(A, x)
        x = x + solve32(r)
    return x


def inv_refined(A, refinements=2):
    """A^-1 for A [..., n, n]: f32 inverse + f64 Newton refinement
    (X <- X (2 I - A X))."""
    X = torch.linalg.inv_ex(_f32(A)).inverse.to(A.dtype)
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    for _ in range(refinements):
        X = X @ (2.0 * eye - A @ X)
    return X
