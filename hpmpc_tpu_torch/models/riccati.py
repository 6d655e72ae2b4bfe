"""Backward Riccati recursion for the LQCP (PyTorch twin of
:mod:`hpmpc_tpu.models.riccati`), batch-native.

Every argument carries a leading instance axis B: ``H_eff`` (B, N+1, NZ,
NZ), ``g_eff`` (B, N+1, NZ), ``F`` (B, N, NZ, NX), ``b`` (B, N, NX).  A
Python loop over the stages takes the place of ``lax.scan``; each stage is
a handful of batched small-matrix products, the factorization the JAX
package's clamped blocked Cholesky (:func:`..ops.tri.cholesky`).

    m_n  = g_n + F_n (P_{n+1} b_n + p_{n+1})
    eu_n = Luu_n^{-1} m_n[:NU]           (pre-solved u gradient)
    px_n = m_n[NU:] - Lxu_n eu_n         (= p_n, the value-function gradient)

``factor`` / ``solve`` are the reference's trf / trs split
(``d_back_ric_rec.c:403,:564``), ``factor_solve`` its sv; ``Pb`` (= P_{n+1}
b_n) is returned so that a re-solve with the same (factor, b) skips it.
This is the structured IPM's plain KKT backend; its kernel backend is
:func:`..ops.stage_kernel.factor_solve_folded` /
:func:`..ops.stage_kernel.solve_batched`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.tri import cholesky, solve_tril, solve_triu


class RiccatiSolution(NamedTuple):
    z: torch.Tensor  # (B, N+1, NZ) primal [u; x] per stage
    pi: torch.Tensor  # (B, N, NX) equality multipliers


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _mtv(A, x):
    return (A.transpose(-1, -2) @ x[..., None])[..., 0]


def _eu_px(L, m, NU):
    """eu = Luu^{-1} m_u; px = m_x - Lxu eu."""
    eu = solve_tril(L[:, :NU, :NU], m[:, :NU])
    return eu, m[:, NU:] - _mv(L[:, NU:, :NU], eu)


def factor_solve(H_eff, g_eff, F, b, NU, with_pi=True):
    """Factorize and solve (reference sv, ``d_back_ric_rec.c:112``).

    ``H_eff`` holds the stage Hessians with the identity padding and any
    constraint diagonal already added.  Returns (solution, factor L (B,
    N+1, NZ, NZ), eu (B, N+1, NU), px (B, N+1, NX), Pb (B, N, NX))."""
    N = F.shape[1]
    L = [None] * (N + 1)
    eu = [None] * (N + 1)
    px = [None] * (N + 1)
    Pb = [None] * N
    L[N] = cholesky(H_eff[:, N])
    eu[N], px[N] = _eu_px(L[N], g_eff[:, N], NU)
    for n in range(N - 1, -1, -1):
        Lxx_next = L[n + 1][:, NU:, NU:]
        F_n = F[:, n]
        W = F_n @ Lxx_next                            # "trmm" stage coupling
        Pb[n] = _mv(Lxx_next, _mtv(Lxx_next, b[:, n]))
        m = g_eff[:, n] + _mv(F_n, Pb[n] + px[n + 1])
        L[n] = cholesky(H_eff[:, n] + W @ W.transpose(-1, -2))
        eu[n], px[n] = _eu_px(L[n], m, NU)
    L = torch.stack(L, 1)
    eu = torch.stack(eu, 1)
    px = torch.stack(px, 1)
    sol = _forward(L, eu, px, F, b, NU, with_pi)
    return sol, L, eu, px, torch.stack(Pb, 1)


def factor(H_eff, F, NU):
    """Factorize only (reference trf, ``d_back_ric_rec.c:403``)."""
    N = F.shape[1]
    L = [None] * (N + 1)
    L[N] = cholesky(H_eff[:, N])
    for n in range(N - 1, -1, -1):
        W = F[:, n] @ L[n + 1][:, NU:, NU:]
        L[n] = cholesky(H_eff[:, n] + W @ W.transpose(-1, -2))
    return torch.stack(L, 1)


def solve(L, g_eff, F, b, NU, Pb=None, with_pi=True):
    """Solve with a retained factor for a new right-hand side (reference
    trs, ``d_back_ric_rec.c:564``).  With ``Pb`` (= P_{n+1} b_n of a prior
    ``factor_solve`` with the same b) the two products per stage are
    skipped (the reference's ``compute_Pb=0``).  Returns (solution, Pb)."""
    N = F.shape[1]
    eu = [None] * (N + 1)
    px = [None] * (N + 1)
    Pb_out = [None] * N
    eu[N], px[N] = _eu_px(L[:, N], g_eff[:, N], NU)
    for n in range(N - 1, -1, -1):
        if Pb is None:
            Lxx_next = L[:, n + 1, NU:, NU:]
            Pb_out[n] = _mv(Lxx_next, _mtv(Lxx_next, b[:, n]))
        else:
            Pb_out[n] = Pb[:, n]
        m = g_eff[:, n] + _mv(F[:, n], Pb_out[n] + px[n + 1])
        eu[n], px[n] = _eu_px(L[:, n], m, NU)
    sol = _forward(L, torch.stack(eu, 1), torch.stack(px, 1), F, b, NU,
                   with_pi)
    return sol, torch.stack(Pb_out, 1)


def _forward(L, eu, px, F, b, NU, with_pi=True):
    """Forward substitution: u_n = -Luu^{-T}(eu_n + Lxu' x_n),
    x_{n+1} = b_n + F_n' z_n, pi_n = P_{n+1} x_{n+1} + p_{n+1}
    (reference ``d_back_ric_rec.c:339-401``)."""
    N = F.shape[1]
    Lxx0 = L[:, 0, NU:, NU:]
    # free initial state x_0 = -P_0^{-1} p_0 (x_0 = 0 when nx[0] = 0:
    # identity padding and a zero gradient)
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


def kkt_residuals(H_eff, g_eff, F, b, z, pi, NU):
    """Unconstrained LQCP KKT residuals (the reference's
    ``d_back_ric_res_tv``, ``lqcp_solvers/d_res.c:38``):

        rq_n = g_n + H_n z_n + [0; -pi_{n-1}] + F_n pi_n
        rb_n = b_n + F_n' z_n - x_{n+1}
    """
    N = F.shape[1]
    rq = g_eff + torch.einsum("bnzw,bnw->bnz", H_eff, z)
    rq[:, 1:, NU:] -= pi
    rq[:, :N] += torch.einsum("bnzx,bnx->bnz", F, pi)
    rb = b + torch.einsum("bnzx,bnz->bnx", F, z[:, :N]) - z[:, 1:, NU:]
    return rq, rb
