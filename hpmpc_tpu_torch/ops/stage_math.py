"""Per-stage IPM math in plain PyTorch — the kernels' plain versions.

One function per in-kernel helper of the JAX package, same name without
the leading underscore: the Riccati stage algebra of
``hpmpc_tpu/ops/stage_kernel.py`` (``_chol`` ... ``_folded_bwd_core_fb``)
and the box step primitives of ``hpmpc_tpu/ops/step_kernel.py``
(``_t_inv_lamt`` ... ``_corr_co_qx``).  Their CUDA counterparts are the
``__device__`` functions of ``csrc/stage_math.cuh``; the formulas, clamps
and NaN behaviour match one for one.

Everything here is batch-FIRST: a stage matrix is ``(B, r, c)``, a stage
vector ``(B, r)``, a per-instance scalar ``(B,)``.  The triangular factors
are lower; only their lower triangles are ever read.  The box primitives
come in two forms: the phase-1 (delta) forms ``qx_fold``, ``dt_dlam``,
``corr_co_qx`` (``A`` = d_cat) and the phase-2 (residual) forms
``qx_fold_res``, ``dt_dlam_res``, ``corr_co_qx_res`` (``A`` = rd, ``M`` =
rm), the two branches of the JAX helpers' ``phase2`` flag.
"""

from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# Riccati stage algebra (stage_kernel.py:198-447)
# ---------------------------------------------------------------------------


def chol(M: torch.Tensor):
    """Lower Cholesky of (B, n, n) symmetric ``M`` with the clamped pivot
    ``rsqrt(max(a_jj, 1e-20))``; returns (L, Dinv), Dinv the reciprocal
    diagonal.  Only the lower triangle of ``M`` is read."""
    A = torch.tril(M).clone()
    n = M.shape[-1]
    Dinv = M.new_empty(M.shape[:-1])
    for j in range(n):
        d = torch.rsqrt(torch.clamp(A[:, j, j], min=1e-20))
        Dinv[:, j] = d
        A[:, j:, j] = A[:, j:, j] * d[:, None]
        if j + 1 < n:
            c = A[:, j + 1:, j]
            A[:, j + 1:, j + 1:] -= torch.tril(c[:, :, None] * c[:, None, :])
    return A, Dinv


def tril_solve(L, Dinv, b):
    """y = L^{-1} b by forward substitution (lower L, reciprocal diag)."""
    n = b.shape[-1]
    y = torch.empty_like(b)
    for i in range(n):
        acc = b[:, i]
        if i:
            acc = acc - (L[:, i, :i] * y[:, :i]).sum(-1)
        y[:, i] = acc * Dinv[:, i]
    return y


def triu_solve_t(L, Dinv, b):
    """y = L^{-T} b by backward substitution on the transpose."""
    n = b.shape[-1]
    y = torch.empty_like(b)
    for i in reversed(range(n)):
        acc = b[:, i]
        if i + 1 < n:
            acc = acc - (L[:, i + 1:, i] * y[:, i + 1:]).sum(-1)
        y[:, i] = acc * Dinv[:, i]
    return y


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _mtv(A, x):
    return (A.transpose(-1, -2) @ x[..., None])[..., 0]


def dinv_ll(Ll, NU):
    """Reciprocal diagonal of the Luu block, clamped at 1e-30."""
    d = torch.diagonal(Ll[:, :NU, :NU], dim1=-2, dim2=-1)
    return 1.0 / torch.clamp(d, min=1e-30)


def pb_of(Lxx, bb):
    """Pb = Lxx (Lxx' b) on a lower-triangular Lxx."""
    return _mv(Lxx, _mtv(Lxx, bb))


def trs_stage(NU, Ll, Dinv_u, g, F, Pbpx, is_t):
    """Backward substitution on the split factor: m = g (terminal) or
    g + F (Pb + px_next); eu = Luu^{-1} m_u; px = m_x - Lxu eu."""
    m = g if is_t else g + _mv(F, Pbpx)
    eu = tril_solve(Ll[:, :NU, :NU], Dinv_u, m[:, :NU])
    px = m[:, NU:] - _mv(Ll[:, NU:, :NU], eu)
    return eu, px


def root_x0(Lxx, px):
    """x0 = -(Lxx Lxx')^{-1} px (the free initial state)."""
    Dinv_x = 1.0 / torch.clamp(
        torch.diagonal(Lxx, dim1=-2, dim2=-1), min=1e-30)
    t = tril_solve(Lxx, Dinv_x, -px)
    return triu_solve_t(Lxx, Dinv_x, t)


def u_of_x(NU, Ll, Dinv_u, eu, x):
    """u = -Luu^{-T} (eu + Lxu' x)."""
    rhs = eu + _mtv(Ll[:, NU:, :NU], x)
    return -triu_solve_t(Ll[:, :NU, :NU], Dinv_u, rhs)


def pi_of_x(Lxx, px, x):
    """pi = Lxx (Lxx' x) + px."""
    return _mv(Lxx, _mtv(Lxx, x)) + px


def x_next_of(F, bb, z):
    """x_{s+1} = b_s + F_s' z_s."""
    return bb + _mtv(F, z)


def folded_bwd_core(NU, Hp, g, F, bb, Lxx_c, px_c):
    """One folded backward-Riccati stage on an assembled effective Hessian
    ``Hp`` (B, NZ, NZ) and gradient ``g``: trmm/syrk + Cholesky + eu/px.
    ``Lxx_c``/``px_c`` is the carry from stage k+1 (zeros at the terminal
    stage, which collapses the formulas to M = Hp, Pb = 0, m = g).
    Returns (Lf, eu, px, Pb); the next carry is (Lf[:, NU:, NU:], px)."""
    W = F @ Lxx_c
    Pb = pb_of(Lxx_c, bb)
    m = g + _mv(F, Pb + px_c)
    M = Hp + W @ W.transpose(-1, -2)
    Lf, Dinv = chol(M)
    eu = tril_solve(Lf[:, :NU, :NU], Dinv[:, :NU], m[:, :NU])
    px = m[:, NU:] - _mv(Lf[:, NU:, :NU], eu)
    return Lf, eu, px, Pb


# ---------------------------------------------------------------------------
# box step primitives, phase-1 forms (step_kernel.py:57-171)
# box vectors are (B, 2K): slots [0, K) lower bounds, [K, 2K) upper bounds
# ---------------------------------------------------------------------------


def t_inv_lamt(lam, t, mb):
    """Masked 1/t and lam/t."""
    rec = 1.0 / torch.where(mb > 0, t, torch.ones_like(t))
    t_inv = rec * mb
    return t_inv, lam * t_inv


def qx_fold(K, lam, t, mb, A):
    """(Qx_fold, qx_fold), both (B, K), masked:
    Qx = fold(lam/t), qx = fold(-sgn*lam - lam/t*A); fold = lo + up."""
    _, lamt = t_inv_lamt(lam, t, mb)
    q_lo = -lam[:, :K] - lamt[:, :K] * A[:, :K]
    q_up = lam[:, K:] - lamt[:, K:] * A[:, K:]
    mbl = mb[:, :K]
    return (lamt[:, :K] + lamt[:, K:]) * mbl, (q_lo + q_up) * mbl


def gather_box(z, idx):
    """z (B, NZ) -> (B, K) values at the box slots ``idx`` (K,)."""
    return z[:, idx]


def scatter_add_box(base, idx, v):
    """base (B, NZ) + v (B, K) scattered to slots ``idx`` (out of place;
    padded slots carry v == 0)."""
    return base.index_add(1, idx, v)


def dt_dlam(K, lam, t, mb, A, zb, dl0):
    """Box (dt, dlam) of a direction with gathered values ``zb`` (B, K):
    dt = (sgn*(zb2 - A) - t) * mb; dlam = (dl0 - lam/t*dt - lam) * mb."""
    _, lamt = t_inv_lamt(lam, t, mb)
    dt_lo = ((zb - A[:, :K]) - t[:, :K]) * mb[:, :K]
    dt_up = ((A[:, K:] - zb) - t[:, K:]) * mb[:, K:]
    dt = torch.cat([dt_lo, dt_up], dim=1)
    dlam = (dl0 - lamt * dt - lam) * mb
    return dt, dlam


def alpha_cands(v, dv, mb):
    """Fraction-to-boundary candidates: -v/dv where dv < 0 (masked),
    +inf elsewhere."""
    pred = (dv < 0.0) & (mb > 0.0)
    return torch.where(pred, -v / torch.where(pred, dv, -torch.ones_like(dv)),
                       torch.full_like(v, float("inf")))


def corr_co_qx(K, lam, t, mb, A, dtb, dlb, sm):
    """Centering correction co = t_inv (sigma mu - dl dt) and the corrected
    gradient fold qx + fold(-sgn co); ``sm`` is (B,)."""
    t_inv, _ = t_inv_lamt(lam, t, mb)
    co = t_inv * (sm[:, None] - dlb * dtb) * mb
    _, qx0 = qx_fold(K, lam, t, mb, A)
    return co, qx0 + (co[:, K:] - co[:, :K]) * mb[:, :K]


# ---------------------------------------------------------------------------
# box step primitives, phase-2 (residual) forms (step_kernel.py:64-165,
# ``phase2=True``): A = rd, M = rm
# ---------------------------------------------------------------------------


def qx_fold_res(K, lam, t, mb, A, M):
    """Phase-2 (Qx_fold, qx_fold): Qx = fold(lam/t),
    qx = fold(sgn*t_inv*M - lam/t*A), masked."""
    t_inv, lamt = t_inv_lamt(lam, t, mb)
    q_lo = t_inv[:, :K] * M[:, :K] - lamt[:, :K] * A[:, :K]
    q_up = -t_inv[:, K:] * M[:, K:] - lamt[:, K:] * A[:, K:]
    mbl = mb[:, :K]
    return (lamt[:, :K] + lamt[:, K:]) * mbl, (q_lo + q_up) * mbl


def dt_dlam_res(K, lam, t, mb, A, M, zb):
    """Phase-2 box (dt, dlam) of a delta with gathered values ``zb``:
    dt = sgn*(zb2 - A) * mb (the full slack step, no ``- t``);
    dlam = -t_inv*(lam*dt + M) * mb."""
    t_inv, _ = t_inv_lamt(lam, t, mb)
    dt_lo = (zb - A[:, :K]) * mb[:, :K]
    dt_up = (A[:, K:] - zb) * mb[:, K:]
    dt = torch.cat([dt_lo, dt_up], dim=1)
    return dt, -t_inv * (lam * dt + M) * mb


def corr_co_qx_res(K, lam, t, mb, A, M, dtb, dlb, sm):
    """Phase-2 corrector stream rm2 = (M + dt dl - sigma mu) * mb and the
    gradient fold of :func:`qx_fold_res` on it; ``sm`` is (B,)."""
    co = (M + (dtb * dlb - sm[:, None])) * mb
    _, qx = qx_fold_res(K, lam, t, mb, A, co)
    return co, qx


# ---------------------------------------------------------------------------
# per-stage direction tail of the alpha pass, which the mega kernels' plain
# versions run too (step_kernel.py ``_dt_dlam`` + ``_alpha_store``)
# ---------------------------------------------------------------------------


def box_dir(K, phase2, lam, t, mb, A, M, zb, dl0):
    """Box (dt, dlam) of a direction with gathered values ``zb``: phase 1
    with the centering stream ``dl0`` (0 in the affine half), phase 2 with
    ``M`` (rm or rm2)."""
    if phase2:
        return dt_dlam_res(K, lam, t, mb, A, M, zb)
    return dt_dlam(K, lam, t, mb, A, zb, dl0)


def alpha_partials(lam, t, mb, dt, dl):
    """One stage's (amin, s0, s1, s2): the fraction-to-boundary minimum
    and the mu(alpha) sum partials of a box direction, each (B,)."""
    cand = torch.minimum(alpha_cands(lam, dl, mb), alpha_cands(t, dt, mb))
    return (cand.amin(1), (lam * t * mb).sum(1),
            (lam * dt + t * dl).sum(1), (dl * dt).sum(1))
