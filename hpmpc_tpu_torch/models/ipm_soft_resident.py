"""Solver-resident batched soft IPM: the whole soft Mehrotra loop of
``d_ip2_mpc_soft_tv`` (``mpc_solvers/d_ip2_soft.c:83``) in one kernel
launch (PyTorch twin of :mod:`hpmpc_tpu.models.ipm_soft_resident`).

Streams in (the hard resident engine's, :func:`.ipm_resident.
resident_inputs`, and the soft rows', :func:`.ipm_soft_lanes.
soft_streams`), one launch of
:func:`~..ops.resident_kernel.ipm_resident` with ``NS > 0`` (Queue 2 row
1s), and the batched :class:`~.ipm_soft.SoftSolution`.  No exit-residual
pass runs: the soft solution carries none.  The soft solver is
single-phase, so the resident contract is the soft engines' for any
``iter_ref == 0`` config; the bookkeeping is the resident engine's:
``stat`` rows indexed by iteration (a stopped instance's later rows are
zero), ``status=2`` for the NaN/divergence guard and the ``alpha_min``
exit together, else 0 where mu <= mu_tol and 1.

float32 and float64 both run (the JAX engine is f32-only because a TPU
emulates f64); ``parallel.batch.solve_batched_soft`` sends it float32
only, under ``HPMPC_RESIDENT=1``, as the JAX package does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import resident_kernel as rk
from ..ops.layout import from_lanes
from .ipm_resident import resident_inputs
from .ipm_soft import SoftSolution
from .ipm_soft_lanes import soft_streams


def soft_resident_inputs(dims, qp, soft, cfg, idxbs_static,
                         exact_mehrotra_soft: bool = True):
    """Streams and static arguments of one soft
    :func:`~..ops.resident_kernel.ipm_resident` launch for this batch:
    the hard resident engine's (:func:`.ipm_resident.resident_inputs`,
    general rows included) and the soft rows' (:func:`.ipm_soft_lanes.
    soft_streams`).  ``ipm_resident(*args, **kw)`` runs the solve."""
    NS = soft.ns_mask.shape[-1]
    if NS == 0:
        raise ValueError("soft resident engine needs soft rows (NS > 0)")
    # the soft solver is single-phase: it runs to mu_tol itself, with no
    # phase-1 floor mu_switch
    args, kw, _, _ = resident_inputs(dims, qp,
                                     dataclasses.replace(cfg, mu_switch=0.0))
    ss = soft_streams(dims, soft, idxbs_static, float(cfg.mu0), qp.dtype,
                      qp.device)
    kw.update(mu_scal=0.0,  # unused with soft rows: musc, per instance
              NS=NS, exact=bool(exact_mehrotra_soft), idxs_tab=ss.idxS,
              lams0=ss.lamsL0, ts0=ss.tsL0, softc=ss.softcL, msk=ss.msL,
              musc=ss.mu_scal)
    return args, kw


def solve_batched_soft_resident(dims, qp, soft, cfg, idxbs_static,
                                exact_mehrotra_soft: bool = True
                                ) -> SoftSolution:
    """Batched soft solve on the soft resident engine (the JAX package's
    ``solve_batched_soft_resident``; the same contract as
    :func:`.ipm_soft_lanes.solve_batched_soft_lanes`).

    ``qp`` and ``soft`` (:class:`~.ipm_soft.SoftSpec`) carry a leading
    instance axis on every leaf; ``idxbs_static`` is the (N+1, NS) table of
    padded-z soft coordinates shared by the batch.  Needs box constraints
    (NB > 0), soft rows (NS > 0), a static ``dims.idxb`` and no
    ``iter_ref``."""
    args, kw = soft_resident_inputs(dims, qp, soft, cfg, idxbs_static,
                                    exact_mehrotra_soft)
    dt, dev = qp.dtype, qp.device
    Np1, NB, NG, NS = dims.N + 1, dims.NB, dims.NG, kw["NS"]
    B = qp.b.shape[0]
    ng_stages = kw.get("ng_stage_ids", ())

    outs = rk.ipm_resident(*args, **kw)
    z_l, pi_l, lam_l, t_l, mu, kk, frz, stat_l = outs[:8]
    lams_l, ts_l = outs[-2:]

    status = torch.where(
        frz > 0, 2, torch.where(mu <= kw["mu_tol"], 0, 1)).to(torch.int32)
    lam_g_s = torch.zeros(B, Np1, 2, NG, dtype=dt, device=dev)
    t_g_s = torch.ones(B, Np1, 2, NG, dtype=dt, device=dev)
    if ng_stages:
        g3, g3t = from_lanes(outs[8]), from_lanes(outs[9])  # (B, n_ng, 2NG)
        for j, n in enumerate(ng_stages):
            lam_g_s[:, n, 0], lam_g_s[:, n, 1] = g3[:, j, :NG], g3[:, j, NG:]
            t_g_s[:, n, 0], t_g_s[:, n, 1] = g3t[:, j, :NG], g3t[:, j, NG:]
    return SoftSolution(
        z=from_lanes(z_l), pi=from_lanes(pi_l),
        lam_b=from_lanes(lam_l).reshape(B, Np1, 2, NB),
        t_b=from_lanes(t_l).reshape(B, Np1, 2, NB),
        lam_g=lam_g_s, t_g=t_g_s,
        lam_s=from_lanes(lams_l).reshape(B, Np1, 4, NS),
        t_s=from_lanes(ts_l).reshape(B, Np1, 4, NS),
        kk=kk.to(torch.int32), status=status, stat=from_lanes(stat_l))
