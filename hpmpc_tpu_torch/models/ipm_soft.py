"""Primal-dual IPM with soft (slack-penalized) box constraints (PyTorch
twin of :mod:`hpmpc_tpu.models.ipm_soft`), batch-native.

A soft constraint ``lb_i - s_lo <= z[idx_i] <= ub_i + s_up`` with slacks
``s_lo, s_up >= 0`` and the penalty ``1/2 s' diag(Z) s + z_lin' s``
carries four slack/multiplier pairs, ordered [lower, upper, s_lo >= 0,
s_up >= 0] (the reference's ``d_ip2_mpc_soft_tv``,
``mpc_solvers/d_ip2_soft.c:83``); the slacks are eliminated every
iteration by a scalar Schur complement that folds into the stage Hessian
like a hard box constraint (``d_aux_ip_soft_lib4.c:167``).

:func:`solve` is the structured single-loop Mehrotra predictor-corrector
(every leaf with a leading instance axis, as :func:`.ipm.solve`: the loop
runs while any instance is live, one host sync per iteration, and selects
per instance); its KKT backend is the plain batched Riccati of
:mod:`.riccati` or, with ``use_pallas``, the hand-written kernels of
:func:`.ipm.make_kernel_chain_kkt`.  The lanes engine is
:mod:`.ipm_soft_lanes`; :func:`compute_residuals` is the float64 oracle of
both.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ocp import OCPQP
from . import ipm as _ipm
from . import riccati


class SoftSpec(NamedTuple):
    """Soft-constraint data; every leaf may carry a leading batch axis.

    idxbs: (N+1, NS) int32 padded-z coordinates of the softly bounded
    entries; d_lbs/d_ubs: (N+1, NS) soft bounds; Z: (N+1, 2, NS) quadratic
    slack penalties [lower, upper]; z_lin: (N+1, 2, NS) linear slack
    penalties; ns_mask: (N+1, NS) validity."""

    idxbs: torch.Tensor
    d_lbs: torch.Tensor
    d_ubs: torch.Tensor
    Z: torch.Tensor
    z_lin: torch.Tensor
    ns_mask: torch.Tensor


class SoftSolution(NamedTuple):
    """Batched soft solution: every field has a leading instance axis B."""

    z: torch.Tensor  # (B, N+1, NZ)
    pi: torch.Tensor  # (B, N, NX)
    lam_b: torch.Tensor  # (B, N+1, 2, NB)
    t_b: torch.Tensor
    lam_g: torch.Tensor  # (B, N+1, 2, NG)
    t_g: torch.Tensor
    lam_s: torch.Tensor  # (B, N+1, 4, NS) [lower, upper, s_lo>=0, s_up>=0]
    t_s: torch.Tensor
    kk: torch.Tensor  # (B,) int32
    status: torch.Tensor  # (B,) int32: 0 converged, 1 max iters, 2 frozen
    stat: torch.Tensor  # (B, k_max, 5) [sigma, alpha_aff, mu_aff, alpha, mu]


class SoftResiduals(NamedTuple):
    rq: torch.Tensor  # (B, N+1, NZ) z-stationarity
    rz: torch.Tensor  # (B, N+1, 2, NS) slack stationarity
    rb: torch.Tensor  # (B, N, NX)
    rd_b: torch.Tensor  # (B, N+1, 2, NB)
    rd_g: torch.Tensor  # (B, N+1, 2, NG)
    rd_s: torch.Tensor  # (B, N+1, 2, NS) slacked-bound gaps
    mu: torch.Tensor  # (B,)


def _onehot(idx, mask, NZ, dt):
    """(..., K, NZ) selection of the coordinates ``idx`` under ``mask``."""
    return torch.nn.functional.one_hot(idx.long(), NZ).to(dt) * mask[..., None]


class _SoftState(NamedTuple):
    z: torch.Tensor       # (B, N+1, NZ)
    pi: torch.Tensor      # (B, N, NX)
    lam_b: torch.Tensor   # (B, N+1, 2, NB)
    t_b: torch.Tensor
    lam_g: torch.Tensor   # (B, N+1, 2, NG)
    t_g: torch.Tensor
    lam_s: torch.Tensor   # (B, N+1, 4, NS)
    t_s: torch.Tensor
    mu: torch.Tensor      # (B,)
    alpha: torch.Tensor   # (B,) last damped step
    kk: torch.Tensor      # (B,) int32
    sigma: torch.Tensor   # (B,)
    stat: torch.Tensor    # (B, k_max, 5)


def solve(dims, qp: OCPQP, soft: SoftSpec, cfg, exact_mehrotra_soft=True,
          z0=None, pi0=None) -> SoftSolution:
    """Solve a batch of soft-constrained OCP QPs (every leaf of ``qp`` and
    ``soft`` with a leading instance axis B), as ``jax.vmap(hpmpc_tpu.
    models.ipm_soft.solve)``: the reference's ``d_ip2_mpc_soft_tv`` with
    its ``stat`` trace ``[sigma, alpha_aff, mu_aff, alpha, mu]`` and exit
    conditions, per instance.

    ``exact_mehrotra_soft=True`` (default) applies the full Mehrotra
    centering correction to the soft gradient; False drops it, as the
    reference's stale pointer does (``d_aux_ip_soft_lib4.c:557,601``), and
    reproduces its trace.  ``z0`` (B, N+1, NZ) / ``pi0`` (B, N, NX) with
    ``cfg.warm_start`` seed the iterate; the box-violation correction
    still applies.  ``cfg.use_pallas`` factors and re-solves with the
    hand-written kernels (the soft barrier terms are diagonal, so the hard
    kernels serve: ``d_ip2_soft.c:94-96`` merges the hard and soft boxes),
    else the plain batched Riccati.  Runs on the device of ``qp``."""
    dt, dev = qp.dtype, qp.device
    B = qp.b.shape[0]
    N, NU, NZ = dims.N, dims.NU, dims.NZ
    k_max = int(cfg.k_max)
    mb, mg, ms = qp.nb_mask, qp.ng_mask, soft.ns_mask
    mb2, mg2, ms4 = (m[:, :, None, :] for m in (mb, mg, ms))
    oh_b = _ipm._box_onehot(qp)
    oh_s = _onehot(soft.idxbs, ms, NZ, dt)
    ng_stages = tuple(n for n in range(N + 1) if dims.ng[n] > 0)
    scatter, gather, cz_of = _ipm._scatter_box, _ipm._gather_box, _ipm._cz

    if cfg.use_pallas:
        fs, trs, _ = _ipm.make_kernel_chain_kkt(qp, ng_stages, NU)

        def kkt_factor_solve(Qx_b, Qx_s, Qx_g, g_eff):
            dvec = (scatter(oh_b, Qx_b) + scatter(oh_s, Qx_s) + qp.pad_diag
                    + cfg.reg_eps)
            return fs(dvec, Qx_g * mg, g_eff, qp.b)

        def kkt_resolve(fstate, g_eff):
            return trs(fstate, g_eff, qp.b)
    else:

        def kkt_factor_solve(Qx_b, Qx_s, Qx_g, g_eff):
            H_eff = _ipm._diag_add(
                _ipm._build_Heff(qp, oh_b, Qx_b, Qx_g, cfg.reg_eps,
                                 ng_stages), scatter(oh_s, Qx_s))
            sol, L, _, _, Pb = riccati.factor_solve(H_eff, g_eff, qp.F, qp.b,
                                                    NU)
            return sol.z, sol.pi, (L, Pb)

        def kkt_resolve(fstate, g_eff):
            sol, _ = riccati.solve(fstate[0], g_eff, qp.F, qp.b, NU,
                                   Pb=fstate[1])
            return sol.z, sol.pi

    # mu scaling, per instance: 2 nb + 2 ng + 4 ns (d_ip2_soft.c:268-271)
    mu_scal = 1.0 / (dims.n_constr + 4.0 * ms.reshape(B, -1).sum(1))
    kiota = torch.arange(k_max, device=dev)

    # ---- init (d_init_var_mpc_soft_tv): the hard init on the masked z0 --
    s0 = _ipm.init_vars(
        dims, qp, cfg, z0=None if z0 is None else z0.to(dt) * qp.z_mask,
        pi0=pi0)
    full = lambda v: torch.full((B,), v, dtype=dt, device=dev)  # noqa: E731
    lam_s0 = ((ms4 > 0).to(dt) * float(cfg.mu0)).expand(
        -1, -1, 4, -1).contiguous()
    s = _SoftState(
        z=s0.z, pi=s0.pi, lam_b=s0.lam_b, t_b=s0.t_b, lam_g=s0.lam_g,
        t_g=s0.t_g, lam_s=lam_s0, t_s=torch.ones_like(lam_s0),
        mu=full(cfg.mu0), alpha=full(1.0), kk=s0.kk, sigma=full(0.0),
        stat=s0.stat)

    def sum_lt(lam_b, t_b, lam_g, t_g, lam_s, t_s):
        return ((lam_b * t_b * mb2).flatten(1).sum(1)
                + (lam_g * t_g * mg2).flatten(1).sum(1)
                + (lam_s * t_s * ms4).flatten(1).sum(1))

    def body(s: _SoftState) -> _SoftState:
        t_inv_b = torch.where(mb2 > 0, 1.0 / s.t_b, 0.0)
        t_inv_g = torch.where(mg2 > 0, 1.0 / s.t_g, 0.0)
        t_inv_s = torch.where(ms4 > 0, 1.0 / s.t_s, 0.0)
        lamt_b, lamt_g, lamt_s = (s.lam_b * t_inv_b, s.lam_g * t_inv_g,
                                  s.lam_s * t_inv_s)

        # hessian/gradient folds (sigma_mu = 0 on the affine pass)
        Qx_b = (lamt_b[:, :, 0] + lamt_b[:, :, 1]) * mb
        qx_b = (s.lam_b[:, :, 1] - lamt_b[:, :, 1] * qp.d_ub
                - s.lam_b[:, :, 0] - lamt_b[:, :, 0] * qp.d_lb) * mb
        Qx_g = (lamt_g[:, :, 0] + lamt_g[:, :, 1]) * mg
        qx_g = (s.lam_g[:, :, 1] - lamt_g[:, :, 1] * qp.d_ug
                - s.lam_g[:, :, 0] - lamt_g[:, :, 0] * qp.d_lg) * mg

        # soft Schur elimination (update_hessian's soft block, :344-506)
        rQx0, rQx1 = lamt_s[:, :, 0], lamt_s[:, :, 1]
        rqx0 = s.lam_s[:, :, 0] + lamt_s[:, :, 0] * soft.d_lbs
        rqx1 = s.lam_s[:, :, 1] - lamt_s[:, :, 1] * soft.d_ubs
        Zl0 = torch.where(ms > 0, 1.0 / (soft.Z[:, :, 0] + rQx0
                                         + lamt_s[:, :, 2]), 0.0)
        Zl1 = torch.where(ms > 0, 1.0 / (soft.Z[:, :, 1] + rQx1
                                         + lamt_s[:, :, 3]), 0.0)
        zl0 = -soft.z_lin[:, :, 0] + rqx0 + s.lam_s[:, :, 2]
        zl1 = -soft.z_lin[:, :, 1] + rqx1 + s.lam_s[:, :, 3]
        rqx0e = rqx0 - rQx0 * zl0 * Zl0
        rqx1e = rqx1 - rQx1 * zl1 * Zl1
        rQx0e = rQx0 - rQx0 * rQx0 * Zl0
        rQx1e = rQx1 - rQx1 * rQx1 * Zl1
        Qx_s = (rQx0e + rQx1e) * ms
        qx_s = (rqx1e - rqx0e) * ms

        # KKT factor + solve (merged hard + soft box scatter)
        g_eff = _ipm._build_geff(qp, oh_b, qp.g * qp.z_mask, qx_b, qx_g,
                                 ng_stages) + scatter(oh_s, qx_s)
        dz, dpi, fstate = kkt_factor_solve(Qx_b, Qx_s, Qx_g, g_eff)

        def dt_dlam(dz, dlam0_b, dlam0_g, dlam0_s, zl0, zl1):
            """dt and dlam of every family from the direction (compute_alpha,
            :611)."""
            zb = gather(oh_b, dz)
            dtb = torch.stack([zb - qp.d_lb - s.t_b[:, :, 0],
                               -zb + qp.d_ub - s.t_b[:, :, 1]], 2) * mb2
            czv = cz_of(qp, dz)
            dtg = torch.stack([czv - qp.d_lg - s.t_g[:, :, 0],
                               -czv + qp.d_ug - s.t_g[:, :, 1]], 2) * mg2
            zs = gather(oh_s, dz)
            ds_lo = (zl0 - lamt_s[:, :, 0] * zs) * Zl0
            ds_up = (zl1 + lamt_s[:, :, 1] * zs) * Zl1
            dts = torch.stack([ds_lo + zs - soft.d_lbs - s.t_s[:, :, 0],
                               ds_up - zs + soft.d_ubs - s.t_s[:, :, 1],
                               ds_lo - s.t_s[:, :, 2],
                               ds_up - s.t_s[:, :, 3]], 2) * ms4
            dlam_b = (dlam0_b - lamt_b * dtb - s.lam_b) * mb2
            dlam_g = (dlam0_g - lamt_g * dtg - s.lam_g) * mg2
            dlam_s = (dlam0_s - lamt_s * dts - s.lam_s) * ms4
            return dtb, dtg, dts, dlam_b, dlam_g, dlam_s

        def alpha_all(dtb, dtg, dts, dlam_b, dlam_g, dlam_s):
            a = torch.ones(B, dtype=dt, device=dev)
            for v, dv, m in ((s.lam_b, dlam_b, mb2), (s.t_b, dtb, mb2),
                             (s.lam_g, dlam_g, mg2), (s.t_g, dtg, mg2),
                             (s.lam_s, dlam_s, ms4), (s.t_s, dts, ms4)):
                a = _ipm._min_ratio(a, v, dv, m * torch.ones_like(v))
            return a

        zero = torch.zeros_like
        d1 = dt_dlam(dz, zero(s.lam_b), zero(s.lam_g), zero(s.lam_s), zl0,
                     zl1)
        dtb, dtg, dts, dlam_b, dlam_g, dlam_s = d1
        alpha_aff = alpha_all(*d1)
        a4 = (alpha_aff * 0.995)[:, None, None, None]
        mu_aff = sum_lt(s.lam_b + a4 * dlam_b, s.t_b + a4 * dtb,
                        s.lam_g + a4 * dlam_g, s.t_g + a4 * dtg,
                        s.lam_s + a4 * dlam_s, s.t_s + a4 * dts) * mu_scal
        sigma = (mu_aff / s.mu) ** 3
        sm4 = (sigma * s.mu)[:, None, None, None]

        # corrector gradient update (update_gradient, :508)
        dlam2_b = t_inv_b * (sm4 - dlam_b * dtb) * mb2
        dlam2_g = t_inv_g * (sm4 - dlam_g * dtg) * mg2
        dlam2_s = t_inv_s * (sm4 - dlam_s * dts) * ms4
        qx_b2 = qx_b + (dlam2_b[:, :, 1] - dlam2_b[:, :, 0]) * mb
        qx_g2 = qx_g + (dlam2_g[:, :, 1] - dlam2_g[:, :, 0]) * mg
        zl0c = zl0 + dlam2_s[:, :, 0] + dlam2_s[:, :, 2]
        zl1c = zl1 + dlam2_s[:, :, 1] + dlam2_s[:, :, 3]
        qx_s2 = qx_s
        if exact_mehrotra_soft:
            rqx0c = dlam2_s[:, :, 0] - rQx0 * (dlam2_s[:, :, 0]
                                               + dlam2_s[:, :, 2]) * Zl0
            rqx1c = dlam2_s[:, :, 1] - rQx1 * (dlam2_s[:, :, 1]
                                               + dlam2_s[:, :, 3]) * Zl1
            qx_s2 = qx_s + (rqx1c - rqx0c) * ms
        g_eff2 = _ipm._build_geff(qp, oh_b, qp.g * qp.z_mask, qx_b2, qx_g2,
                                  ng_stages) + scatter(oh_s, qx_s2)
        dz2, dpi2 = kkt_resolve(fstate, g_eff2)

        d2 = dt_dlam(dz2, dlam2_b, dlam2_g, dlam2_s, zl0c, zl1c)
        dtb, dtg, dts, dlam_b, dlam_g, dlam_s = d2
        alpha2 = alpha_all(*d2)
        a2 = alpha2 * 0.995
        a3, a4 = a2[:, None, None], a2[:, None, None, None]
        new = dict(lam_b=s.lam_b + a4 * dlam_b, t_b=s.t_b + a4 * dtb,
                   lam_g=s.lam_g + a4 * dlam_g, t_g=s.t_g + a4 * dtg,
                   lam_s=s.lam_s + a4 * dlam_s, t_s=s.t_s + a4 * dts)
        mu_new = sum_lt(**new) * mu_scal
        row = torch.stack([sigma, alpha_aff, mu_aff, alpha2, mu_new], 1)
        stat = torch.where((kiota[None, :] == s.kk[:, None])[..., None],
                           row[:, None, :], s.stat)
        s_new = _SoftState(
            z=s.z + a3 * (dz2 - s.z), pi=s.pi + a3 * (dpi2 - s.pi), **new,
            mu=mu_new, alpha=a2, kk=s.kk + 1, sigma=sigma, stat=stat)
        ok = _ipm.step_ok(mu_new, s.mu)
        return _ipm._gate(ok, s_new,
                          s._replace(alpha=torch.zeros_like(s.alpha)))

    mu_tol, alpha_min = float(cfg.mu_tol), float(cfg.alpha_min)
    while True:
        live = (s.kk < k_max) & (s.mu > mu_tol) & (s.alpha >= alpha_min)
        if not bool(live.any()):
            break
        s = _ipm._gate(live, body(s), s)

    status = torch.where(s.mu <= mu_tol, 0,
                         torch.where(s.kk >= k_max, 1, 2)).to(torch.int32)
    return SoftSolution(
        z=s.z, pi=s.pi, lam_b=s.lam_b, t_b=s.t_b, lam_g=s.lam_g, t_g=s.t_g,
        lam_s=s.lam_s, t_s=s.t_s, kk=s.kk, status=status, stat=s.stat)


def compute_residuals(dims, qp: OCPQP, soft: SoftSpec,
                      sol: SoftSolution) -> SoftResiduals:
    """Exact KKT residuals of a batch of soft-constrained QPs at ``sol``
    (the reference's ``d_res_mpc_soft_tv``, ``d_res_ip_soft.c:38``; the
    JAX package's :func:`hpmpc_tpu.models.ipm_soft.compute_residuals`,
    written for a leading batch axis instead of vmap).  The 3rd/4th slack
    families are the slack variables s_lo/s_up.  ``mu`` uses the
    2nb + 2ng + 4ns scaling of the solver's stat trace."""
    N, NU, NZ = dims.N, dims.NU, dims.NZ
    dt = qp.dtype
    z, pi = sol.z, sol.pi
    lam_b, t_b, lam_g, t_g = sol.lam_b, sol.t_b, sol.lam_g, sol.t_g
    lam_s, t_s = sol.lam_s, sol.t_s
    mb, mg, ms = qp.nb_mask, qp.ng_mask, soft.ns_mask
    oh_b = _onehot(qp.idxb, mb, NZ, dt)
    oh_s = _onehot(soft.idxbs, ms, NZ, dt)
    s_lo, s_up = t_s[:, :, 2], t_s[:, :, 3]

    # z-stationarity: the hard terms, plus the soft bound multipliers
    # scattered at the soft coordinates
    rq = qp.g * qp.z_mask + torch.einsum("bnzw,bnw->bnz", qp.H, z)
    rq[:, 1:, NU:] += -pi
    rq[:, :N] += torch.einsum("bnzx,bnx->bnz", qp.F, pi)
    rq = rq + torch.einsum("bnkz,bnk->bnz", oh_b,
                           (lam_b[:, :, 1] - lam_b[:, :, 0]) * mb)
    rq = rq + torch.einsum("bngz,bng->bnz", qp.C,
                           (lam_g[:, :, 1] - lam_g[:, :, 0]) * mg)
    rq = rq + torch.einsum("bnkz,bnk->bnz", oh_s,
                           (lam_s[:, :, 1] - lam_s[:, :, 0]) * ms)
    rq = rq * qp.z_mask

    # slack stationarity (d_res_ip_soft.c:150): Z s + z_lin - lam_bound
    # - lam_nonneg, per side
    rz = torch.stack(
        [soft.z_lin[..., 0, :] + soft.Z[..., 0, :] * s_lo - lam_s[:, :, 0]
         - lam_s[:, :, 2],
         soft.z_lin[..., 1, :] + soft.Z[..., 1, :] * s_up - lam_s[:, :, 1]
         - lam_s[:, :, 3]], 2) * ms[..., None, :]

    rb = qp.b + torch.einsum("bnzx,bnz->bnx", qp.F, z[:, :N]) - z[:, 1:, NU:]
    rb = rb * qp.x_mask[..., 1:, :]

    zb = torch.einsum("bnkz,bnz->bnk", oh_b, z)
    rd_b = torch.stack([qp.d_lb - zb + t_b[:, :, 0],
                        qp.d_ub - zb - t_b[:, :, 1]], 2) * mb[..., None, :]
    cz = torch.einsum("bngz,bnz->bng", qp.C, z)
    rd_g = torch.stack([qp.d_lg + t_g[:, :, 0] - cz,
                        qp.d_ug - t_g[:, :, 1] - cz], 2) * mg[..., None, :]
    # slacked soft bounds: z_s >= d_lbs - s_lo, z_s <= d_ubs + s_up
    zs = torch.einsum("bnkz,bnz->bnk", oh_s, z)
    rd_s = torch.stack([soft.d_lbs - s_lo - zs + t_s[:, :, 0],
                        soft.d_ubs + s_up - zs - t_s[:, :, 1]],
                       2) * ms[..., None, :]

    B = z.shape[0]
    mu = ((lam_b * t_b * mb[..., None, :]).reshape(B, -1).sum(1)
          + (lam_g * t_g * mg[..., None, :]).reshape(B, -1).sum(1)
          + (lam_s * t_s * ms[..., None, :]).reshape(B, -1).sum(1)) / (
        dims.n_constr + 4.0 * ms.reshape(B, -1).sum(1))
    return SoftResiduals(rq=rq, rz=rz, rb=rb, rd_b=rd_b, rd_g=rd_g,
                         rd_s=rd_s, mu=mu)


def residuals64(dims, qp: OCPQP, soft: SoftSpec, sol: SoftSolution,
                sub: torch.Tensor):
    """:func:`compute_residuals` in float64 of the instances ``sub`` of a
    batched solve: ({field: max |residual|}, the largest relative
    difference between their mu and the solver's last stat row)."""
    def d64(x):
        x = x[sub]
        return x.double() if x.is_floating_point() else x

    q = type(qp)(**{f.name: d64(getattr(qp, f.name))
                    for f in dataclasses.fields(qp)})
    x = type(sol)(*[d64(v) for v in sol])
    res = compute_residuals(dims, q, type(soft)(*[d64(v) for v in soft]), x)
    rmax = {f: float(getattr(res, f).abs().max()) for f in res._fields}
    mu_eng = x.stat[torch.arange(len(sub), device=sub.device),
                    x.kk.long().clamp(min=1) - 1, 4]
    dmu = float(((res.mu - mu_eng).abs() / res.mu.abs().clamp(min=1e-30))
                .max())
    return rmax, dmu
