"""Batched backward Riccati for the large-NZ band (PyTorch twin of
:mod:`hpmpc_tpu.models.riccati_blocked`).

The hand-batched twin of :mod:`.riccati`: every argument and result carries
a leading batch axis B, each stage is a few batched matrix products
(``torch.matmul``, as the JAX module leaves them to XLA), triangular solves
come from :mod:`..ops.tri`, and the stage Cholesky is the batched
right-looking kernel :func:`..ops.batch_chol.cholesky` (Queue 2 row 24)
instead of :mod:`.riccati`'s divide-and-conquer recursion.  The same
algebra as :func:`.riccati.factor_solve` in the same order; only the
Cholesky's algorithm differs.

The structured route sends its KKT solves here past the per-thread
kernels' size envelope (:func:`..models.ipm.make_kernel_chain_kkt`,
:func:`..ops.stage_kernel.engine_fits`).  ``factor_solve_folded`` builds
each stage's effective Hessian inside the stage loop, so the (B, N+1, NZ,
NZ) stack is never stored (at nx=64, B=1024 in float32 it would be 0.65 GB
an iteration).
"""

from __future__ import annotations

import torch

from ..ops import batch_chol
from ..ops.tri import solve_tril, solve_triu
from .riccati import RiccatiSolution


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _mtv(A, x):
    return (A.transpose(-1, -2) @ x[..., None])[..., 0]


def factor_solve(H_eff, g_eff, F, b, NU, with_pi=True):
    """Batched factorize-and-solve on stacked effective Hessians.

    ``H_eff`` (B, N+1, NZ, NZ), ``g_eff`` (B, N+1, NZ), ``F`` (B, N, NZ,
    NX), ``b`` (B, N, NX).  Returns ``(RiccatiSolution, L, eu, px, Pb)``,
    batch first: L (B, N+1, NZ, NZ), eu (B, N+1, NU), px (B, N+1, NX), Pb
    (B, N, NX)."""
    return _factor_solve(lambda n: H_eff[:, n], g_eff, F, b, NU, with_pi)


def factor_solve_folded(H, dvec, C, Qx_g, g_eff, F, b, NU, with_pi=True):
    """Folded-assembly variant: stage n's effective Hessian ``H_n +
    diag(dvec_n) + C_n' diag(Qx_g_n) C_n`` is built inside the stage loop.
    ``Qx_g`` (B, N+1, NG) must already be masked to the active rows (zero
    rows make the C term vanish on stages without general rows)."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)

    def assemble(n):
        C_n = C[:, n]
        return (H[:, n] + eye * dvec[:, n, None, :]
                + torch.einsum("bgz,bg,bgw->bzw", C_n, Qx_g[:, n], C_n))

    return _factor_solve(assemble, g_eff, F, b, NU, with_pi)


def _eu_px(L, m, NU):
    eu = solve_tril(L[:, :NU, :NU], m[:, :NU])
    return eu, m[:, NU:] - _mv(L[:, NU:, :NU], eu)


def _factor_solve(assemble, g_eff, F, b, NU, with_pi):
    N = F.shape[1]
    L = [None] * (N + 1)
    eu = [None] * (N + 1)
    px = [None] * (N + 1)
    Pb = [None] * N
    L[N] = batch_chol.cholesky(assemble(N))
    eu[N], px[N] = _eu_px(L[N], g_eff[:, N], NU)
    for n in range(N - 1, -1, -1):
        Lxx_next = L[n + 1][:, NU:, NU:]
        F_n = F[:, n]
        W = F_n @ Lxx_next                                 # (B, NZ, NX)
        Pb[n] = _mv(Lxx_next, _mtv(Lxx_next, b[:, n]))
        m = g_eff[:, n] + _mv(F_n, Pb[n] + px[n + 1])
        L[n] = batch_chol.cholesky(assemble(n) + W @ W.transpose(-1, -2))
        eu[n], px[n] = _eu_px(L[n], m, NU)
    L = torch.stack(L, 1)
    eu = torch.stack(eu, 1)
    px = torch.stack(px, 1)
    sol = _forward(L, eu, px, F, b, NU, with_pi)
    return sol, L, eu, px, torch.stack(Pb, 1)


def solve(L, g_eff, F, b, NU, Pb=None, with_pi=True):
    """Batched solve with a retained factor for a new right-hand side (the
    reference's trs, ``d_back_ric_rec.c:564``).  ``Pb`` (B, N, NX) from a
    prior :func:`factor_solve` skips the two products per stage (the
    reference's ``compute_Pb=0``).  Returns ``(RiccatiSolution, Pb)``."""
    N = F.shape[1]
    eu = [None] * (N + 1)
    px = [None] * (N + 1)
    Pb_out = [None] * N
    eu[N], px[N] = _eu_px(L[:, N], g_eff[:, N], NU)
    for n in range(N - 1, -1, -1):
        if Pb is None:
            Lxx = L[:, n + 1, NU:, NU:]
            Pb_out[n] = _mv(Lxx, _mtv(Lxx, b[:, n]))
        else:
            Pb_out[n] = Pb[:, n]
        m = g_eff[:, n] + _mv(F[:, n], Pb_out[n] + px[n + 1])
        eu[n], px[n] = _eu_px(L[:, n], m, NU)
    sol = _forward(L, torch.stack(eu, 1), torch.stack(px, 1), F, b, NU,
                   with_pi)
    return sol, torch.stack(Pb_out, 1)


def _forward(L, eu, px, F, b, NU, with_pi=True):
    """Batched forward substitution (reference ``d_back_ric_rec.c:339-
    401``): u_n = -Luu^{-T}(eu_n + Lxu' x_n), x_{n+1} = b_n + F_n' z_n,
    pi_n = Lxx_{n+1} (Lxx_{n+1}' x_{n+1}) + px_{n+1}."""
    N = F.shape[1]
    # x0 = -(Lxx0 Lxx0')^{-1} px0 by two triangular solves: JAX takes the
    # explicit inverse from NX = 96 (riccati_blocked.py:173-179, measured on
    # its TPU); the H100 prefers the solves at NX 64-128 (PERF.md section 5)
    Lxx0 = L[:, 0, NU:, NU:]
    x = -solve_triu(Lxx0.transpose(-1, -2), solve_tril(Lxx0, px[:, 0]))
    z, pi = [], []
    for n in range(N + 1):
        Ln = L[:, n]
        u = -solve_triu(Ln[:, :NU, :NU].transpose(-1, -2),
                        eu[:, n] + _mtv(Ln[:, NU:, :NU], x))
        z.append(torch.cat([u, x], dim=1))
        if n == N:
            break
        x_next = b[:, n] + _mtv(F[:, n], z[-1])
        if with_pi:
            Lxx_next = L[:, n + 1, NU:, NU:]
            pi.append(_mv(Lxx_next, _mtv(Lxx_next, x_next)) + px[:, n + 1])
        else:
            pi.append(torch.zeros_like(x_next))
        x = x_next
    return RiccatiSolution(z=torch.stack(z, 1), pi=torch.stack(pi, 1))
