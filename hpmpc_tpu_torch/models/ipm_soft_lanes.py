"""The soft lanes engine: the batched single-loop soft Mehrotra IPM on
batch-last streams (PyTorch twin of :mod:`hpmpc_tpu.models.ipm_soft_lanes`).

Same predictor-corrector and per-iteration slack Schur elimination as the
reference's ``d_ip2_mpc_soft_tv`` (``mpc_solvers/d_ip2_soft.c:83``): every
soft constraint carries four slack/multiplier families [lo; up; s_lo;
s_up], eliminated stage by stage into the box fold of the Riccati sweep
(the Zl/zl recurrences of ``d_aux_ip_soft_lib4.c:167`` and the corrector
gradient at ``:508``).  A half-iteration is one soft mega kernel
(:func:`~..ops.mega_kernel.factor_solve_soft_mega` /
:func:`~..ops.mega_kernel.solve_soft_mega`, ``HPMPC_MEGA_SWEEPS=1``, the
default) or the 6-kernel sequence (soft prep, factor+solve, soft alpha;
soft corrector, re-solve, soft alpha: :mod:`..ops.step_kernel`,
:mod:`..ops.stage_kernel`).  The per-instance scalar math, the
general-constraint rows and the gating stay in plain tensor code, with
the scaffolding of the hard engine (:func:`.ipm_lanes.make_lanes_common`,
:func:`.ipm_lanes.make_ng_lanes`).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..ops import mega_kernel as mk
from ..ops import stage_kernel as sk
from ..ops import step_kernel as stk
from ..ops.layout import from_lanes, to_lanes
from . import ipm as _ipm
from .ipm_lanes import make_lanes_common, make_ng_lanes
from .ipm_soft import SoftSolution


class _LSState(NamedTuple):
    """Loop state; fields ending in ``L`` are batch-last streams, the rest
    batch-first."""

    zL: torch.Tensor       # (N+1, NZ, B)
    piL: torch.Tensor      # (N, NX, B)
    lamL: torch.Tensor     # (N+1, 2NB, B) [lower; upper]
    tL: torch.Tensor       # (N+1, 2NB, B)
    lam_g: torch.Tensor    # (B, 2NGF) [lower-all; upper-all]
    t_g: torch.Tensor      # (B, 2NGF)
    lamsL: torch.Tensor    # (N+1, 4NS, B) [lo; up; s_lo; s_up]
    tsL: torch.Tensor      # (N+1, 4NS, B)
    mu: torch.Tensor       # (B,)
    alpha: torch.Tensor    # (B,)
    kk: torch.Tensor       # (B,) int32
    stat: torch.Tensor     # (B, k_max, 5)


def solve_batched_soft_lanes(dims, qp, soft, cfg, idxbs_static,
                             exact_mehrotra_soft: bool = True
                             ) -> SoftSolution:
    """Batched soft solve on the soft lanes engine (the JAX package's
    ``solve_batched_soft_lanes``).

    ``qp`` and ``soft`` (:class:`~.ipm_soft.SoftSpec`) carry a leading
    instance axis on every leaf; ``idxbs_static`` is the (N+1, NS) table of
    padded-z soft coordinates shared by the batch.  ``exact_mehrotra_soft``
    keeps the soft corrector's gradient correction (False: the reference's
    dropped correction, ``hpmpc_tpu/models/ipm_soft.py:113-120``).
    float32 and float64 both run.  Liveness is per instance: the loop runs
    while any instance is live (one host sync per iteration), and an
    instance that is not live keeps its state (a select).  Needs box
    constraints (NB > 0), soft rows (NS > 0) and a static ``dims.idxb``.

    Not ported yet: ``HPMPC_FUSED_SWEEPS=1`` (ROADMAP Queue 2 rows 17-18)
    raises ``NotImplementedError``."""
    exact = bool(exact_mehrotra_soft)
    mega = os.environ.get("HPMPC_MEGA_SWEEPS", "1") == "1"
    if not mega and os.environ.get("HPMPC_FUSED_SWEEPS", "0") == "1":
        raise NotImplementedError(
            "soft lanes engine: the fused sweeps (HPMPC_FUSED_SWEEPS=1) need "
            "ROADMAP Queue 2 rows 17 and 18")
    dt = qp.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"soft lanes engine takes float32/float64, got {dt}")
    NS = soft.ns_mask.shape[-1]
    if dims.NB == 0 or dims.idxb is None or NS == 0:
        raise ValueError("soft lanes engine needs box constraints with a "
                         "static dims.idxb and soft rows (NS > 0)")
    dev = qp.device
    N, NU, NX, NZ, NB, NG = (dims.N, dims.NU, dims.NX, dims.NZ, dims.NB,
                             dims.NG)
    Np1 = N + 1
    B = qp.b.shape[0]
    kd = dict(NB=NB, NS=NS, NU=NU, NZ=NZ, NX=NX)
    sd = dict(NB=NB, NS=NS, NZ=NZ)
    ks = dict(NU=NU, NZ=NZ, NX=NX)
    ng_stages = tuple(n for n in range(Np1) if dims.ng[n] > 0)
    n_ng = len(ng_stages)
    NGF = n_ng * NG
    k_max = int(cfg.k_max)
    mu_tol = float(cfg.mu_tol)
    alpha_min = float(cfg.alpha_min)
    mu0 = float(cfg.mu0)

    # ---- shared scaffolding (one copy for the hard and soft engines) -----
    cm = make_lanes_common(dims, qp, cfg)
    gate = cm.gate
    idxT, mbL, dcatL, gL, pdregL, bL = (cm.idxT, cm.mbL, cm.dcatL, cm.gL,
                                        cm.pdregL, cm.bL)
    Hl, Fl = cm.Hl, cm.Fl
    idxS = torch.as_tensor(
        np.array(idxbs_static, np.int32).reshape(Np1, NS), device=dev)

    ms1 = soft.ns_mask.to(dt)                            # (B, Np1, NS)
    ms4_st = torch.cat([ms1] * 4, -1)                    # (B, Np1, 4NS)
    msL = to_lanes(ms1)
    # soft constants: [d_lbs; d_ubs; Z0; Z1; zlin0; zlin1] per stage
    softcL = to_lanes(torch.cat([
        soft.d_lbs, soft.d_ubs, soft.Z[..., 0, :], soft.Z[..., 1, :],
        soft.z_lin[..., 0, :], soft.z_lin[..., 1, :]], -1).to(dt))

    ngh = make_ng_lanes(dims, qp, ng_stages, dt, B)
    mgF, dg_cat, mg2, sgn_g = ngh.mgF, ngh.dg_cat, ngh.mg2, ngh.sgn_g
    cat2 = lambda v: torch.cat([v, v], 1)  # noqa: E731
    empty = torch.zeros(B, 0, dtype=dt, device=dev)

    # mu scaling, per instance: 2 nb + 2 ng + 4 ns (d_ip2_soft.c:268-271)
    n_hard = 2 * sum(dims.nb) + 2 * sum(dims.ng)
    mu_scal = 1.0 / (n_hard + 4.0 * ms1.reshape(B, -1).sum(1))

    def soft_in(s):
        return (idxT, idxS, s.lamL, s.tL, dcatL, mbL, s.lamsL, s.tsL, softcL,
                msL)

    def affine_half(s, ngl, qx_g):
        """Soft prep + factorization + affine solve + affine box+soft
        alpha partials: one soft mega kernel, or the 6-kernel loop's soft
        prep, factor+solve and soft alpha passes.  Returns (dz, fstate,
        (dtb, dlb, dts, dls, amin, s0, s1, s2))."""
        if mega:
            out = mk.factor_solve_soft_mega(
                *soft_in(s), gL, pdregL, Hl, ngl,
                ngh.ct_lanes_stream(qx_g) if n_ng else None, ng_stages, Fl,
                bL, **kd)
            return out[0], out[1], out[2:]
        dvecL, geffL = stk.soft_prep_flat(*soft_in(s), gL, pdregL, **sd)
        if n_ng:
            geffL = ngh.ct_add_lanes(geffL, qx_g)
        dzL, _, fstate = sk.factor_solve_folded_flat(
            Hl, dvecL, ngl, ng_stages, geffL, Fl, bL, want_pi=False, **ks)
        idx_t, idx_s, *rest = soft_in(s)
        aff = stk.soft_alpha_sums_flat(idx_t, idx_s, dzL, *rest, None, None,
                                       corrector=False, **sd)
        return dzL, fstate, aff

    def corr_half(s, fstate, aff, smv, qx_g2):
        """Soft corrector gradient + retained-factor solve + corrector
        box+soft alpha partials: one soft mega kernel, or the 6-kernel
        loop's soft corrector pass, re-solve and soft alpha pass.  Returns
        (dz2, dpi2, (dt2b, dl2b, dt2s, dl2s, amin, s0, s1, s2))."""
        if mega:
            out = mk.solve_soft_mega(
                idxT, idxS, fstate, *soft_in(s)[2:], *aff[:4], smv, gL,
                ngh.ct_lanes_stream(qx_g2) if n_ng else None, ng_stages, Fl,
                bL, exact=exact, **kd)
            return out[0], out[1], out[2:]
        geff2L, dl2bL, dl2sL = stk.soft_corr_flat(
            *soft_in(s), *aff[:4], smv, gL, exact=exact, **sd)
        if n_ng:
            geff2L = ngh.ct_add_lanes(geff2L, qx_g2)
        dz2L, dpi2L = sk.solve_flat(*fstate, geff2L, Fl, bL, **ks)
        idx_t, idx_s, *rest = soft_in(s)
        corr = stk.soft_alpha_sums_flat(idx_t, idx_s, dz2L, *rest, dl2bL,
                                        dl2sL, corrector=True, **sd)
        return dz2L, dpi2L, corr

    # ---- init (d_init_var_mpc_soft_tv; box/ng init shared via cm) --------
    lam_g0, t_g0 = cm.ng_init(ngh)
    t_s0 = torch.ones(B, Np1, 4 * NS, dtype=dt, device=dev)
    lam_s0 = torch.where(ms4_st > 0, torch.full_like(t_s0, mu0),
                         torch.zeros_like(t_s0))
    s = _LSState(
        zL=cm.zL0, piL=torch.zeros(N, NX, B, dtype=dt, device=dev),
        lamL=cm.lamL0, tL=cm.tL0, lam_g=lam_g0, t_g=t_g0,
        lamsL=to_lanes(lam_s0), tsL=to_lanes(t_s0),
        mu=torch.full((B,), mu0, dtype=dt, device=dev),
        alpha=torch.ones(B, dtype=dt, device=dev),
        kk=torch.zeros(B, dtype=torch.int32, device=dev),
        stat=torch.zeros(B, k_max, 5, dtype=dt, device=dev))

    def finish(parts, lam_g, t_g, dtg, dlg):
        return cm.finish_alpha_sums(parts, ngh, lam_g, t_g, dtg, dlg)

    # ---- single loop (d_ip2_mpc_soft_tv) --------------------------------
    def body(s):
        t_inv_g = lamt_g = qx_g = empty
        ngl = None
        if n_ng:
            t_inv_g = torch.where(mg2 > 0, 1.0 / s.t_g,
                                  torch.zeros_like(s.t_g))
            lamt_g = s.lam_g * t_inv_g
            Qx_g = ngh.fold_g(lamt_g) * mgF
            qx_g = ngh.fold_g(-sgn_g * s.lam_g - lamt_g * dg_cat) * mgF
            ngl = ngh.ngl_of(Qx_g)

        dzL, fstate, aff = affine_half(s, ngl, qx_g)
        dtg = dlg = empty
        if n_ng:
            dtg = (sgn_g * (cat2(ngh.cz_of(dzL)) - dg_cat) - s.t_g) * mg2
            dlg = (-lamt_g * dtg - s.lam_g) * mg2
        alpha_aff, a0, a1, a2c = finish(aff[4:], s.lam_g, s.t_g, dtg, dlg)
        a = 0.995 * alpha_aff
        mu_aff = (a0 + a * a1 + a * a * a2c) * mu_scal
        sigma = (mu_aff / s.mu) ** 3
        smv = sigma * s.mu

        qx_g2 = dl2g = None
        if n_ng:
            dl2g = t_inv_g * (smv[:, None] - dlg * dtg) * mg2
            qx_g2 = qx_g + ngh.fold_g(-sgn_g * dl2g) * mgF
        dz2L, dpi2L, corr = corr_half(s, fstate, aff, smv, qx_g2)
        dtg2 = dlg2 = empty
        if n_ng:
            dtg2 = (sgn_g * (cat2(ngh.cz_of(dz2L)) - dg_cat) - s.t_g) * mg2
            dlg2 = (dl2g - lamt_g * dtg2 - s.lam_g) * mg2
        alpha2, b0, b1, b2 = finish(corr[4:], s.lam_g, s.t_g, dtg2, dlg2)
        a2 = 0.995 * alpha2
        mu_new = (b0 + a2 * b1 + a2 * a2 * b2) * mu_scal

        row = torch.stack([sigma, alpha_aff, mu_aff, alpha2, mu_new], 1)
        s_new = _LSState(
            zL=s.zL + a2 * (dz2L - s.zL), piL=s.piL + a2 * (dpi2L - s.piL),
            lamL=s.lamL + a2 * corr[1], tL=s.tL + a2 * corr[0],
            lam_g=s.lam_g + a2[:, None] * dlg2,
            t_g=s.t_g + a2[:, None] * dtg2,
            lamsL=s.lamsL + a2 * corr[3], tsL=s.tsL + a2 * corr[2],
            mu=mu_new, alpha=alpha2 * 0.995, kk=s.kk + 1,
            stat=cm.stat_update(s.stat, s.kk, row))
        ok = _ipm.step_ok(mu_new, s.mu)
        return gate(ok, s_new, s._replace(alpha=torch.zeros_like(s.alpha)))

    while True:
        live = (s.kk < k_max) & (s.mu > mu_tol) & (s.alpha >= alpha_min)
        if not bool(live.any()):
            break
        s = gate(live, body(s), s)

    status = torch.where(
        s.mu <= mu_tol, 0, torch.where(s.kk >= k_max, 1, 2)).to(torch.int32)

    # ---- structured outputs (the SoftSolution contract) ------------------
    lam_g_s = torch.zeros(B, Np1, 2, NG, dtype=dt, device=dev)
    t_g_s = torch.ones(B, Np1, 2, NG, dtype=dt, device=dev)
    for k, n in enumerate(ng_stages):
        sl = slice(k * NG, (k + 1) * NG)
        lam_g_s[:, n, 0] = s.lam_g[:, sl]
        lam_g_s[:, n, 1] = s.lam_g[:, NGF:][:, sl]
        t_g_s[:, n, 0] = s.t_g[:, sl]
        t_g_s[:, n, 1] = s.t_g[:, NGF:][:, sl]
    return SoftSolution(
        z=from_lanes(s.zL), pi=from_lanes(s.piL),
        lam_b=from_lanes(s.lamL).reshape(B, Np1, 2, NB),
        t_b=from_lanes(s.tL).reshape(B, Np1, 2, NB),
        lam_g=lam_g_s, t_g=t_g_s,
        lam_s=from_lanes(s.lamsL).reshape(B, Np1, 4, NS),
        t_s=from_lanes(s.tsL).reshape(B, Np1, 4, NS),
        kk=s.kk, status=status, stat=s.stat)
