"""Per-stage IPM math in plain PyTorch — the kernels' plain versions.

One function per in-kernel helper of the JAX package, same name without
the leading underscore: the Riccati stage algebra of
``hpmpc_tpu/ops/stage_kernel.py`` (``_chol`` ... ``_folded_bwd_core_fb``)
and the box step primitives of ``hpmpc_tpu/ops/step_kernel.py``
(``_t_inv_lamt`` ... ``_corr_co_qx``), and its soft-constraint primitives
(``_soft_schur`` ... ``_soft_dt_dls``, with the combined box + soft passes
of the soft kernels).  Their CUDA counterparts are the
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


# ---------------------------------------------------------------------------
# soft-constraint step primitives (step_kernel.py:547-608, mega_kernel.py
# :632-673): the 4-slack-family machinery of the single-loop soft IPM,
# always in the phase-1 (delta) formulation.  Soft vectors are (B, 4NS)
# ordered [lo; up; s_lo; s_up], the soft constants (B, 6NS) ordered
# [d_lbs; d_ubs; Z0; Z1; zlin0; zlin1], the mask ``ms`` (B, NS).
# ---------------------------------------------------------------------------


def soft4(a, NS):
    """The four slack families of a (B, 4NS) soft vector."""
    return a[:, :NS], a[:, NS:2 * NS], a[:, 2 * NS:3 * NS], a[:, 3 * NS:]


def soft_schur(NS, lam_s, t_s, ms, c):
    """Per-stage soft slack Schur elimination: a dict of every quantity the
    soft step formulas read.  Every ``where(ms > 0, ...)`` guard stays: a
    masked slot may hold anything."""
    dlbs, dubs = c[:, :NS], c[:, NS:2 * NS]
    Z0, Z1 = c[:, 2 * NS:3 * NS], c[:, 3 * NS:4 * NS]
    zl0F, zl1F = c[:, 4 * NS:5 * NS], c[:, 5 * NS:]
    ms4 = torch.cat([ms, ms, ms, ms], 1)
    rec = 1.0 / torch.where(ms4 > 0, t_s, torch.ones_like(t_s))
    t_inv_s = rec * ms4
    lamt_s = lam_s * t_inv_s
    lts0, lts1, lts2, lts3 = soft4(lamt_s, NS)
    ls0, ls1, ls2, ls3 = soft4(lam_s, NS)
    rqx0 = ls0 + lts0 * dlbs
    rqx1 = ls1 - lts1 * dubs
    on = ms > 0
    one, zero = torch.ones_like(ms), torch.zeros_like(ms)
    Zl0 = torch.where(on, 1.0 / torch.where(on, Z0 + lts0 + lts2, one), zero)
    Zl1 = torch.where(on, 1.0 / torch.where(on, Z1 + lts1 + lts3, one), zero)
    return dict(ms4=ms4, t_inv_s=t_inv_s, lamt_s=lamt_s, rQx0=lts0,
                rQx1=lts1, rqx0=rqx0, rqx1=rqx1, Zl0=Zl0, Zl1=Zl1,
                zl0=-zl0F + rqx0 + ls2, zl1=-zl1F + rqx1 + ls3, dlbs=dlbs,
                dubs=dubs)


def soft_qx(ms, S):
    """(Qx_s, qx_s), each (B, NS), from the Schur dict."""
    rqx0e = S["rqx0"] - S["rQx0"] * S["zl0"] * S["Zl0"]
    rqx1e = S["rqx1"] - S["rQx1"] * S["zl1"] * S["Zl1"]
    rQx0e = S["rQx0"] - S["rQx0"] * S["rQx0"] * S["Zl0"]
    rQx1e = S["rQx1"] - S["rQx1"] * S["rQx1"] * S["Zl1"]
    return (rQx0e + rQx1e) * ms, (rqx1e - rqx0e) * ms


def soft_dt_dls(NS, lam_s, t_s, S, zs, dl0_s, zl0x, zl1x):
    """Soft (dt, dlam) for the gathered direction values ``zs`` (B, NS)
    against the current zl pair (affine: zl; corrector: zl + the dl2
    fold); ``dl0_s`` is 0 (affine) or dl2s (corrector)."""
    ts0, ts1, ts2, ts3 = soft4(t_s, NS)
    ds_lo = (zl0x - S["rQx0"] * zs) * S["Zl0"]
    ds_up = (zl1x + S["rQx1"] * zs) * S["Zl1"]
    dts = torch.cat([ds_lo + zs - S["dlbs"] - ts0,
                     ds_up - zs + S["dubs"] - ts1,
                     ds_lo - ts2, ds_up - ts3], 1) * S["ms4"]
    dls = (dl0_s - S["lamt_s"] * dts - lam_s) * S["ms4"]
    return dts, dls


def soft_corr_qx(NS, ms, S, dts, dls, sm, exact):
    """Soft centering correction dl2s = t_inv (sigma mu - dl dt) ms4 and
    the corrected soft gradient fold: qx_s plus the Schur-folded dl2s
    correction with ``exact``, qx_s alone without (the reference's dropped
    correction, ``hpmpc_tpu/models/ipm_soft.py:113-120``); ``sm`` (B,)."""
    dl2s = S["t_inv_s"] * (sm[:, None] - dls * dts) * S["ms4"]
    _, qx_s = soft_qx(ms, S)
    if not exact:
        return dl2s, qx_s
    d0, d1, d2, d3 = soft4(dl2s, NS)
    rqx0c = d0 - S["rQx0"] * (d0 + d2) * S["Zl0"]
    rqx1c = d1 - S["rQx1"] * (d1 + d3) * S["Zl1"]
    return dl2s, qx_s + (rqx1c - rqx0c) * ms


def soft_alpha_pass(K, NS, lam, t, mb, A, lam_s, t_s, ms, c, zb, zs, dl0b,
                    dl2s):
    """The combined box + soft direction and alpha/sums pass of one stage
    (``_soft_alpha_from_out``): box (dt, dl) of the gathered box values
    ``zb`` with the centering stream ``dl0b`` (0 in the affine pass), soft
    (dt, dl) of the gathered soft values ``zs`` against zl, or in the
    corrector pass (``dl2s`` given) against zl + the dl2s fold, then the
    fraction-to-boundary minimum and the mu(alpha) partials over both
    families.  Returns (dtb, dlb, dts, dls, amin, s0, s1, s2)."""
    dtb, dlb = dt_dlam(K, lam, t, mb, A, zb, dl0b)
    S = soft_schur(NS, lam_s, t_s, ms, c)
    zs = zs * ms
    if dl2s is None:
        zl0x, zl1x, dl0_s = S["zl0"], S["zl1"], 0.0
    else:
        d0, d1, d2, d3 = soft4(dl2s, NS)
        zl0x, zl1x, dl0_s = S["zl0"] + d0 + d2, S["zl1"] + d1 + d3, dl2s
    dts, dls = soft_dt_dls(NS, lam_s, t_s, S, zs, dl0_s, zl0x, zl1x)
    ms4 = S["ms4"]
    cand = torch.minimum(
        torch.minimum(alpha_cands(lam, dlb, mb),
                      alpha_cands(t, dtb, mb)).amin(1),
        torch.minimum(alpha_cands(lam_s, dls, ms4),
                      alpha_cands(t_s, dts, ms4)).amin(1))
    return (dtb, dlb, dts, dls, cand,
            (lam * t * mb).sum(1) + (lam_s * t_s * ms4).sum(1),
            (lam * dtb + t * dlb).sum(1) + (lam_s * dts + t_s * dls).sum(1),
            (dlb * dtb).sum(1) + (dls * dts).sum(1))
