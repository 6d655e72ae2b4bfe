"""Small triangular-solve / Cholesky primitives (PyTorch twin of
:mod:`hpmpc_tpu.ops.tri`).

Every function takes leading batch dimensions.  ``cholesky`` is the JAX
package's blocked recursion, not ``torch.linalg.cholesky``: it splits at
``k = n // 2``, factors 2x2 blocks directly and clamps each pivot argument
to at least 1e-30 (float64) or 1e-20 (float32), so a barrier-weighted stage
Hessian that loses positive-definiteness to roundoff gives a huge but
finite factor (the IPM then retreats through its step-length guards)
instead of NaN.  Its sums run in the same order as the JAX recursion.

``getrf``/``getrs`` are not ported yet: they arrive with condensing and MHE
(ROADMAP Queue 1 items 12 and 16).
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
