"""Solver-resident batched IPM: the whole phase-1 Mehrotra loop in one
kernel launch (PyTorch twin of :mod:`hpmpc_tpu.models.ipm_resident`).

Streams in (:func:`.ipm_lanes.make_lanes_common`), one
:func:`~..ops.resident_kernel.ipm_resident` launch, one
:func:`~..ops.step_kernel.resid_full` launch for the exit KKT residuals,
the general-constraint residual terms, and the batched
:class:`~.ipm.IPMSolution`.  Semantics: the reference's legacy
no-residual solver (``d_ip2_hard.c``), the ``mu_switch <= mu_tol``
degeneracy of the flagship.  ``stat`` rows are indexed by iteration
number (equal to the kk-indexed rows whenever no instance stops early);
``status=2`` folds the NaN/divergence guard and the ``alpha_min`` exit
into one frozen flag.

float32 and float64 both run (the H100 has native f64; the JAX engine is
f32-only because a TPU emulates f64).
"""

from __future__ import annotations

import torch

from ..ocp import OCPDims, OCPQP
from ..ops import resident_kernel as rk
from ..ops import step_kernel as stk
from ..ops.layout import from_lanes, to_lanes
from . import ipm as _ipm
from .ipm_lanes import make_lanes_common, make_ng_lanes


def resident_inputs(dims: OCPDims, qp: OCPQP, cfg, z0=None, pi0=None):
    """Streams and static arguments of one
    :func:`~..ops.resident_kernel.ipm_resident` launch for this batch.

    Returns ``(args, kw, cm, ngh)``: ``ipm_resident(*args, **kw)`` runs the
    solve; ``cm``/``ngh`` are the :func:`.ipm_lanes.make_lanes_common` /
    :func:`.ipm_lanes.make_ng_lanes` namespaces the exit residuals reuse."""
    dt = qp.dtype
    dev = qp.device
    N, NU, NX, NZ, NB, NG = (dims.N, dims.NU, dims.NX, dims.NZ,
                             dims.NB, dims.NG)
    B = qp.b.shape[0]
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"resident engine takes float32/float64, got {dt}")
    if dims.idxb is None or max(dims.nb) == 0:
        raise ValueError("resident engine needs box constraints with a "
                         "static dims.idxb")
    if int(cfg.iter_ref) != 0:
        raise ValueError("resident engine runs without iter_ref")
    ng_stages = tuple(n for n in range(N + 1) if dims.ng[n] > 0)
    n_ng = len(ng_stages)

    cm = make_lanes_common(dims, qp, cfg, z0=z0, pi0=pi0)
    pi0l = (cm.piL0 if cm.piL0 is not None
            else torch.zeros(N, NX, B, dtype=dt, device=dev))
    ngh = make_ng_lanes(dims, qp, ng_stages, dt, B)
    kw = dict(
        NB=NB, NU=NU, NZ=NZ, NX=NX, k_max=int(cfg.k_max),
        mu_scal=1.0 / dims.n_constr,
        # phase-1-only: run to the flagship's phase-1 floor
        mu_tol=float(max(cfg.mu_tol, cfg.mu_switch)),
        alpha_min=float(cfg.alpha_min), mu0=float(cfg.mu0), NG=NG,
    )
    if n_ng:
        NGF = n_ng * NG

        def g_lanes(flat):  # (B, 2*NGF) [lo-all; up-all] -> (n_ng, 2NG, B)
            lo = flat[:, :NGF].reshape(B, n_ng, NG)
            up = flat[:, NGF:].reshape(B, n_ng, NG)
            return to_lanes(torch.cat([lo, up], -1))

        lam_g0, t_g0 = cm.ng_init(ngh)
        C_stack = torch.stack([qp.C[:, n] for n in ng_stages], 1).to(dt)
        kw.update(
            ng_stage_ids=ng_stages,
            Cg=to_lanes(C_stack),
            dgg=g_lanes(ngh.dg_cat), mgg=g_lanes(ngh.mg2),
            lamg0=g_lanes(lam_g0), tg0=g_lanes(t_g0),
        )
    args = (cm.idxT, cm.lamL0, cm.tL0, cm.zL0, pi0l, cm.gL, cm.pdregL,
            cm.Hl, cm.Fl, cm.bL, cm.dcatL, cm.mbL)
    return args, kw, cm, ngh


def exit_resid_inputs(dims: OCPDims, qp: OCPQP, cm, z, pi, lam, t):
    """Arguments of the :func:`~..ops.step_kernel.resid_full` launch on
    the batch-last iterate ``(z, pi, lam, t)`` that
    :func:`~..ops.resident_kernel.ipm_resident` returned: ``resid_full(
    *args, **kw)``."""
    args = (cm.idxT, cm.Hl, cm.Fl, z, pi, cm.gL, cm.bL, lam, t, cm.dcatL,
            cm.mbL, to_lanes(qp.z_mask), to_lanes(qp.x_mask[:, 1:]))
    return args, dict(NB=dims.NB, NU=dims.NU, NZ=dims.NZ, NX=dims.NX)


def solve_batched_resident(dims: OCPDims, qp: OCPQP, cfg,
                           z0=None, pi0=None) -> _ipm.IPMSolution:
    dt = qp.dtype
    dev = qp.device
    N, NB, NG = dims.N, dims.NB, dims.NG
    Np1 = N + 1
    B = qp.b.shape[0]
    args, kw, cm, ngh = resident_inputs(dims, qp, cfg, z0=z0, pi0=pi0)
    ng_stages = kw.get("ng_stage_ids", ())
    n_ng = len(ng_stages)
    NGF = n_ng * NG
    mu_scal, mu_tol = kw["mu_scal"], kw["mu_tol"]

    outs = rk.ipm_resident(*args, **kw)
    z_l, pi_l, lam_l, t_l, mu, kk, frz, stat_l = outs[:8]

    # ---- final residuals (one kernel) -------------------------------------
    r_args, r_kw = exit_resid_inputs(dims, qp, cm, z_l, pi_l, lam_l, t_l)
    rqL, rbL, rdL, _, musumL = stk.resid_full(*r_args, **r_kw)
    rbL = rbL[:N]
    mu_sum = musumL.sum(0)

    def absmax_l(y):  # batch-last stream -> (B,)
        return y.abs().reshape(-1, B).amax(0)

    lam_g_s = torch.zeros(B, Np1, 2, NG, dtype=dt, device=dev)
    t_g_s = torch.ones(B, Np1, 2, NG, dtype=dt, device=dev)
    if n_ng:
        g3 = from_lanes(outs[8])                    # (B, n_ng, 2NG)
        g3t = from_lanes(outs[9])
        lam_g_f = torch.cat([g3[..., :NG].reshape(B, NGF),
                             g3[..., NG:].reshape(B, NGF)], 1)
        t_g_f = torch.cat([g3t[..., :NG].reshape(B, NGF),
                           g3t[..., NG:].reshape(B, NGF)], 1)
        rqL = ngh.ct_add_lanes(
            rqL, ngh.fold_g(-ngh.sgn_g * lam_g_f) * ngh.mgF)
        czn = ngh.cz_of(z_l)
        rd_g = ((ngh.dg_cat - torch.cat([czn, czn], 1)
                 + ngh.sgn_g * t_g_f) * ngh.mg2)
        rm_g = lam_g_f * t_g_f * ngh.mg2
        mu_sum = mu_sum + rm_g.sum(1)
        rd_g_max = rd_g.abs().amax(1)
        for j, n in enumerate(ng_stages):
            lam_g_s[:, n, 0] = g3[:, j, :NG]
            lam_g_s[:, n, 1] = g3[:, j, NG:]
            t_g_s[:, n, 0] = g3t[:, j, :NG]
            t_g_s[:, n, 1] = g3t[:, j, NG:]
    else:
        rd_g_max = torch.zeros(B, dtype=dt, device=dev)
    mu_res = mu_sum * mu_scal

    inf_norm_res = torch.stack([
        absmax_l(rqL), absmax_l(rbL),
        torch.maximum(absmax_l(rdL), rd_g_max), mu_res,
    ], dim=1)

    frozen = frz > 0
    status = torch.where(
        frozen, 2, torch.where(mu <= mu_tol, 0, 1)).to(torch.int32)
    return _ipm.IPMSolution(
        z=from_lanes(z_l),
        pi=from_lanes(pi_l),
        lam_b=from_lanes(lam_l).reshape(B, Np1, 2, NB),
        t_b=from_lanes(t_l).reshape(B, Np1, 2, NB),
        lam_g=lam_g_s, t_g=t_g_s,
        kk=kk.to(torch.int32), status=status,
        stat=from_lanes(stat_l),
        inf_norm_res=inf_norm_res,
    )
