"""Small triangular-solve / Cholesky primitives (PyTorch twin of
:mod:`hpmpc_tpu.ops.tri`).

Every function takes leading batch dimensions.  ``cholesky`` is the JAX
package's blocked recursion, not ``torch.linalg.cholesky``: it splits at
``k = n // 2``, factors 2x2 blocks directly and clamps each pivot argument
to at least 1e-30 (float64) or 1e-20 (float32), so a barrier-weighted stage
Hessian that loses positive-definiteness to roundoff gives a huge but
finite factor (the IPM then retreats through its step-length guards)
instead of NaN.  Its sums run in the same order as the JAX recursion.

``getrf``/``getrs`` are the pivoted LU and its solve, batch-first.
"""

from __future__ import annotations

import torch


def _vec_rhs(A, x) -> bool:
    """Whether ``x`` is a (..., n) vector right-hand side of the (..., n,
    n) matrix ``A`` (else a (..., n, k) matrix one)."""
    return x.ndim == A.ndim - 1


def solve_tril(L, x):
    """Solve L y = x with L lower-triangular; ``x`` (..., n) or (..., n,
    k)."""
    if _vec_rhs(L, x):
        return torch.linalg.solve_triangular(L, x[..., None], upper=False)[
            ..., 0]
    return torch.linalg.solve_triangular(L, x, upper=False)


def solve_triu(U, x):
    """Solve U y = x with U upper-triangular; ``x`` (..., n) or (..., n,
    k)."""
    if _vec_rhs(U, x):
        return torch.linalg.solve_triangular(U, x[..., None], upper=True)[
            ..., 0]
    return torch.linalg.solve_triangular(U, x, upper=True)


def tril_inverse(L):
    """Explicit inverse of a lower-triangular matrix by block divide and
    conquer: inv([[A, 0], [C, B]]) = [[A^-1, 0], [-B^-1 C A^-1, B^-1]],
    log2(n) levels of batched matmuls."""
    n = L.shape[-1]
    if n == 1:
        return 1.0 / L
    k = n // 2
    Ai = tril_inverse(L[..., :k, :k])
    Bi = tril_inverse(L[..., k:, k:])
    Ci = -(Bi @ (L[..., k:, :k] @ Ai))
    top = torch.cat([Ai, torch.zeros_like(L[..., :k, k:])], dim=-1)
    bot = torch.cat([Ci, Bi], dim=-1)
    return torch.cat([top, bot], dim=-2)


def chol_masked(M, pad_diag):
    """Cholesky of a padded stage tile: identity added on the padded
    coordinates (``pad_diag`` = 1 there), so the factor exists and the
    padding stays decoupled."""
    return cholesky(M + torch.diag_embed(pad_diag))


def cholesky(M):
    """Blocked lower Cholesky with clamped pivots (see the module doc).

      M = [[A, B'], [B, C]]:  L11 = chol(A); L21 = B L11^-T;
                              L22 = chol(C - L21 L21')
    """
    n = M.shape[-1]
    # clamp propagates NaN as jnp.maximum does
    tiny = 1e-30 if M.dtype == torch.float64 else 1e-20
    if n == 1:
        return torch.sqrt(torch.clamp(M, min=tiny))
    if n <= 2:
        a = M[..., 0:1, 0:1]
        b = M[..., 1:2, 0:1]
        c = M[..., 1:2, 1:2]
        la = torch.sqrt(torch.clamp(a, min=tiny))
        lb = b / la
        lc = torch.sqrt(torch.clamp(c - lb * lb, min=tiny))
        top = torch.cat([la, torch.zeros_like(lb)], dim=-1)
        bot = torch.cat([lb, lc], dim=-1)
        return torch.cat([top, bot], dim=-2)
    k = n // 2
    L11 = cholesky(M[..., :k, :k])
    L21 = M[..., k:, :k] @ tril_inverse(L11).transpose(-1, -2)
    L22 = cholesky(M[..., k:, k:] - L21 @ L21.transpose(-1, -2))
    top = torch.cat([L11, M.new_zeros(M.shape[:-2] + (k, n - k))], dim=-1)
    bot = torch.cat([L21, L22], dim=-1)
    return torch.cat([top, bot], dim=-2)


def getrf(A):
    """LU factorization with partial pivoting (the JAX package's
    ``getrf``, the reference's ``dgetrf_pivot_lib``).

    Returns ``(LU, piv)``: unit-lower L and U packed in one matrix, and
    ``piv[..., k]`` the row swapped into position k at step k (LAPACK's
    ipiv convention, 0-based, int32).  Batched over leading dims.
    Right-looking elimination: at step k the largest |entry| of column k
    on or below the diagonal (the first one on a tie) is swapped into row
    k, the multipliers below the pivot are stored in column k (a zero
    pivot stores zero multipliers' quotient by 1), and only the columns
    past k take the rank-1 update, so the stored multipliers ride along
    with later swaps."""
    n = A.shape[-1]
    LU = A.clone()
    piv = torch.zeros(A.shape[:-1], dtype=torch.int32, device=A.device)
    iota = torch.arange(n, device=A.device)
    for k in range(n):
        col = torch.where(iota >= k, LU[..., :, k].abs(),
                          torch.full_like(LU[..., :, k], float("-inf")))
        p = torch.argmax(col, dim=-1)
        piv[..., k] = p.to(torch.int32)
        row_k = LU[..., k, :].clone()
        row_p = torch.take_along_dim(LU, p[..., None, None], dim=-2)[..., 0, :]
        is_p = (iota == p[..., None])[..., None]
        LU = torch.where(is_p, row_k[..., None, :], LU)
        LU[..., k, :] = row_p
        pivval = LU[..., k, k]
        safe = torch.where(pivval.abs() > 0, pivval, torch.ones_like(pivval))
        below = (iota > k).to(A.dtype)
        mult = LU[..., :, k] / safe[..., None] * below
        LU[..., :, k + 1:] -= mult[..., :, None] * LU[..., k:k + 1, k + 1:]
        LU[..., k + 1:, k] = mult[..., k + 1:]
    return LU, piv


def getrs(LU, piv, b):
    """Solve ``A x = b`` (``b`` (..., n)) with a :func:`getrf`
    factorization: the recorded row swaps applied to ``b`` in order, then
    the unit-lower and upper triangular solves."""
    n = LU.shape[-1]
    b = b.clone()
    for k in range(n):
        p = piv[..., k].long()[..., None]
        bk = b[..., k:k + 1].clone()
        bp = torch.take_along_dim(b, p, dim=-1)
        b.scatter_(-1, p, bk)
        b[..., k:k + 1] = bp
    L = torch.tril(LU, -1) + torch.eye(n, dtype=LU.dtype, device=LU.device)
    return solve_triu(torch.triu(LU), solve_tril(L, b))
