"""The lanes engine: the two-phase batched Mehrotra IPM on batch-last
streams (PyTorch twin of :mod:`hpmpc_tpu.models.ipm_lanes`).

:func:`solve_batched_lanes` runs the reference's ``d_ip2_res_hard``: phase 1
(delta formulation) down to ``max(mu_tol, mu_switch)``, the exact KKT
residuals (:func:`~..ops.step_kernel.resid_full`), then phase 2 (residual
formulation) down to ``mu_tol``, recomputing the residuals after every
step.  A half-iteration is one mega kernel (:mod:`..ops.mega_kernel`,
``HPMPC_MEGA_SWEEPS=1``, the default without refinement) or the 6-kernel
sequence (prep, factor+solve, alpha; corrector, re-solve, alpha:
:mod:`..ops.step_kernel`, :mod:`..ops.stage_kernel`), which also carries
``iter_ref`` iterative refinement (the reference's ITER_REF,
``d_ip2_res_hard.c:48``): one fused pass (``refine_flat_fused``) or, with
``HPMPC_FUSED_REFINE=0``, the unfused pass (``resid_terms_flat``, the
residuals' elementwise assembly, ``solve_flat_pb``).  The flat form
(``flat=True``) is the 6-kernel sequence with the unfused refinement: the
kernel set of the JAX package's flat engine ``ipm_fast``, which the port
folds in here.  Either form continues a previous stage's solution
(``state0``, the two-stage route).  The per-instance scalar math (alpha,
mu, sigma), the general-constraint rows (a few (B, NG) vectors on a few
stages, small einsums) and the gating stay in plain tensor code.

The scaffolding it shares with the resident engine is here too: the box
index table, the constant streams, the reference's ``d_init_var`` initial
iterate (box-violation correction included) and the general-constraint
init.  The einsums keep float32 at full precision (the package pins TF32
off).
"""

from __future__ import annotations

import os
import types
from typing import NamedTuple

import numpy as np
import torch

from ..ocp import OCPDims, OCPQP
from ..ops import mega_kernel as mk
from ..ops import stage_kernel as sk
from ..ops import stage_math as sm
from ..ops import step_kernel as stk
from ..ops.layout import from_lanes, sym_compress, to_lanes
from . import ipm as _ipm


def make_ng_lanes(dims, qp, ng_stages, dt, B):
    """General-constraint machinery over batch-last z streams: a few
    (B, NG) vectors on a few stages, as small einsums."""
    NG = dims.NG
    n_ng = len(ng_stages)
    NGF = n_ng * NG
    dev = qp.device
    ns = types.SimpleNamespace(n_ng=n_ng, NGF=NGF)
    if not n_ng:
        empty = torch.zeros(B, 0, dtype=dt, device=dev)
        ns.mgF = ns.dg_cat = ns.mg2 = ns.sgn_g = empty
        ns.cz_of = lambda zl: empty
        ns.ct_add_lanes = lambda gl, v: gl
        ns.fold_g = lambda v: v
        ns.ngl_of = ns.ct_lanes_stream = lambda v: None
        ns.Cl_lanes = None
        return ns

    C_act = [qp.C[:, n].to(dt) for n in ng_stages]     # each (B, NG, NZ)
    C_stack = torch.stack(C_act, 1)                    # (B, n_ng, NG, NZ)
    ns.Cl_lanes = to_lanes(C_stack)                    # (n_ng, NG, NZ, B)
    r, c = torch.tril_indices(dims.NZ, dims.NZ, device=dev)
    C_i, C_j = C_stack[..., r], C_stack[..., c]        # (B, n_ng, NG, NT)
    ns.mgF = torch.cat([qp.ng_mask[:, n] for n in ng_stages], 1)
    dg_lo = torch.cat([qp.d_lg[:, n] for n in ng_stages], 1)
    dg_up = torch.cat([qp.d_ug[:, n] for n in ng_stages], 1)
    ns.dg_cat = torch.cat([dg_lo, dg_up], 1)
    ns.mg2 = torch.cat([ns.mgF, ns.mgF], 1)
    ns.sgn_g = torch.cat([torch.ones(1, NGF, dtype=dt, device=dev),
                          -torch.ones(1, NGF, dtype=dt, device=dev)], 1)

    def cz_of(zl):
        """C_n z_n on the active stages of a batch-last z stream
        (N+1, NZ, B) -> (B, NGF)."""
        return torch.cat([
            torch.einsum("bgz,zb->bg", C_act[k], zl[n])
            for k, n in enumerate(ng_stages)], 1)

    def ct_add_lanes(gl, v):
        """gl[n] += C_n' v_n on the active stages (gl batch-last
        (N+1, NZ, B), v (B, NGF)); returns a new stream."""
        gl = gl.clone()
        for k, n in enumerate(ng_stages):
            contrib = torch.einsum("bg,bgz->zb",
                                   v[:, k * NG:(k + 1) * NG], C_act[k])
            gl[n] += contrib
        return gl

    def ngl_of(Qx_g):
        """The mega kernels' ``ngl`` stream: C_n' diag(Qx_g) C_n packed
        per active stage, (B, NGF) -> (n_ng, NT, B), in the working dtype
        (the JAX package rounds it through float32)."""
        Qg = Qx_g.reshape(B, n_ng, NG)
        return to_lanes(torch.einsum("bngt,bng,bngt->bnt", C_i, Qg, C_j))

    def ct_lanes_stream(v):
        """The mega kernels' ``ngadd`` stream: C_n' v_n per active stage,
        (B, NGF) -> (n_ng, NZ, B)."""
        return to_lanes(torch.einsum("bng,bngz->bnz",
                                     v.reshape(B, n_ng, NG), C_stack))

    ns.cz_of = cz_of
    ns.ct_add_lanes = ct_add_lanes
    ns.ngl_of = ngl_of
    ns.ct_lanes_stream = ct_lanes_stream
    ns.fold_g = lambda v: v[:, :NGF] + v[:, NGF:]
    return ns


def make_lanes_common(dims, qp, cfg, z0=None, pi0=None):
    """Shared scaffolding of the batched engines: index table, constant
    box/stage streams, the ``d_init_var`` initial iterate and the
    per-instance loop helpers of the hard and soft lanes engines
    (``finish_alpha_sums``, ``stat_update``, ``gate``).

    ``z0`` (B, N+1, NZ) / ``pi0`` (B, N, NX) with ``cfg.warm_start`` seed
    the iterate; the box-violation correction still applies to the seeded
    iterate."""
    dt = qp.dtype
    dev = qp.device
    N, NU, NZ, NB = dims.N, dims.NU, dims.NZ, dims.NB
    Np1 = N + 1
    B = qp.b.shape[0]
    ns = types.SimpleNamespace()

    # ---- box index table + one-time init selection ----------------------
    idx_np = np.zeros((Np1, NB), np.int32)
    sel_np = np.zeros((Np1, NZ, NB))
    for n in range(Np1):
        nun = dims.nu[n]
        for k in range(dims.nb[n]):
            j = int(dims.idxb[n][k])
            jp = j if j < nun else NU + (j - nun)
            idx_np[n, k] = jp
            sel_np[n, jp, k] = 1.0
    ns.idxT = torch.as_tensor(idx_np, device=dev)
    Sel = torch.as_tensor(sel_np, dtype=dt, device=dev)

    # ---- box constant streams ------------------------------------------
    mb1 = qp.nb_mask                                   # (B, Np1, NB)
    mb_st = torch.cat([mb1, mb1], -1)                  # (B, Np1, 2NB)
    ns.mbL = to_lanes(mb_st)
    ns.dcatL = to_lanes(torch.cat([qp.d_lb, qp.d_ub], -1))
    ns.gL = to_lanes(qp.g * qp.z_mask)
    ns.pdregL = to_lanes(qp.pad_diag + float(cfg.reg_eps))
    ns.bL = to_lanes(qp.b)
    ns.Hl = to_lanes(sym_compress(qp.H.to(dt)))
    ns.Fl = to_lanes(qp.F.to(dt))

    # ---- init (exact reference branching; ipm.init_vars twin) ------------
    thr0 = 0.1
    mu0 = float(cfg.mu0)
    d_lb3, d_ub3 = qp.d_lb, qp.d_ub
    if cfg.warm_start and z0 is not None:
        z_in = z0.to(dt) * qp.z_mask                   # (B, Np1, NZ)
        zb0 = torch.einsum("bnz,nzk->bnk", z_in, Sel)
    else:
        z_in = torch.zeros(B, Np1, NZ, dtype=dt, device=dev)
        zb0 = torch.zeros(B, Np1, NB, dtype=dt, device=dev)
    t_lo0 = zb0 - d_lb3
    t_up0 = d_ub3 - zb0
    both = (t_lo0 < thr0) & (t_up0 < thr0)
    lo_only = (t_lo0 < thr0) & ~both
    up_only = (t_up0 < thr0) & ~both
    thr = torch.full_like(t_lo0, thr0)
    t_lo = torch.where(both | lo_only, thr, t_lo0)
    t_up = torch.where(both | up_only, thr, t_up0)
    z_corr = torch.where(
        both, (d_lb3 - d_ub3) * 0.5,
        torch.where(lo_only, d_lb3 + thr0,
                    torch.where(up_only, d_ub3 - thr0, zb0)))
    changed = ((both | lo_only | up_only) & (mb1 > 0)).to(dt)
    z0_full = (
        z_in * (1.0 - torch.einsum("bnk,nzk->bnz", changed, Sel))
        + torch.einsum("bnk,nzk->bnz", changed * z_corr, Sel))
    t_b0 = torch.cat([t_lo, t_up], -1)
    t_b0 = torch.where(mb_st > 0, t_b0, torch.ones_like(t_b0))
    lam_b0 = torch.where(mb_st > 0, mu0 / t_b0, torch.zeros_like(t_b0))
    ns.zL0 = to_lanes(z0_full)
    ns.lamL0 = to_lanes(lam_b0)
    ns.tL0 = to_lanes(t_b0)
    if cfg.warm_start and pi0 is not None:
        ns.piL0 = to_lanes(pi0.to(dt) * qp.x_mask[:, 1:])
    else:
        ns.piL0 = None

    def ng_init(ngh):
        """Slack/multiplier init of the general-constraint rows, (B, 2NGF)
        each, [lower-all; upper-all]."""
        if not ngh.n_ng:
            return (torch.zeros(B, 0, dtype=dt, device=dev),
                    torch.ones(B, 0, dtype=dt, device=dev))
        czv = ngh.cz_of(ns.zL0)
        t_g0 = torch.clamp(ngh.sgn_g * (torch.cat([czv, czv], 1)
                                        - ngh.dg_cat), min=thr0)
        t_g0 = torch.where(ngh.mg2 > 0, t_g0, torch.ones_like(t_g0))
        lam_g0 = torch.where(ngh.mg2 > 0, mu0 / t_g0, torch.zeros_like(t_g0))
        return lam_g0, t_g0

    ns.ng_init = ng_init

    # ---- per-instance loop helpers shared by the hard and soft engines --
    kiota = torch.arange(int(cfg.k_max), device=dev)

    def finish_alpha_sums(parts, ngh, lam_g, t_g, dtg, dlg):
        """Reduce a kernel's per-stage (amin, s0, s1, s2) partials over the
        stages and add the ng rows: (alpha, s0, s1, s2), each (B,)."""
        amin, s0, s1, s2 = (parts[0].amin(0), parts[1].sum(0),
                            parts[2].sum(0), parts[3].sum(0))
        if ngh.n_ng:
            cand = torch.minimum(sm.alpha_cands(lam_g, dlg, ngh.mg2),
                                 sm.alpha_cands(t_g, dtg, ngh.mg2))
            amin = torch.minimum(amin, cand.amin(1))
            s0 = s0 + (lam_g * t_g * ngh.mg2).sum(1)
            s1 = s1 + (lam_g * dtg + t_g * dlg).sum(1)
            s2 = s2 + (dlg * dtg).sum(1)
        return torch.minimum(torch.ones_like(amin), amin), s0, s1, s2

    def stat_update(stat, kk, row):
        """``stat`` (B, k_max, 5) with row ``kk`` of each instance set to
        ``row`` (B, 5)."""
        mask = (kiota[None, :] == kk[:, None])[..., None]
        return torch.where(mask, row[:, None, :], stat)

    def gate(m, new, old):
        """Per instance, ``new`` where ``m`` (B,) holds, else ``old`` (two
        loop states of one NamedTuple type; fields ending in ``L`` are
        batch-last): a select, never a multiply (a gated-off instance may
        hold NaN)."""
        out = []
        for f, a, b in zip(new._fields, new, old):
            mm = (m if f.endswith("L")
                  else m.reshape((-1,) + (1,) * (a.ndim - 1)))
            out.append(torch.where(mm, a, b))
        return type(new)(*out)

    ns.finish_alpha_sums = finish_alpha_sums
    ns.stat_update = stat_update
    ns.gate = gate
    return ns


class _LState(NamedTuple):
    """Loop state; fields ending in ``L`` are batch-last streams, the rest
    batch-first."""

    zL: torch.Tensor       # (N+1, NZ, B)
    piL: torch.Tensor      # (N, NX, B)
    lamL: torch.Tensor     # (N+1, 2NB, B) per stage [lower; upper]
    tL: torch.Tensor       # (N+1, 2NB, B)
    lam_g: torch.Tensor    # (B, 2NGF) [lower-all; upper-all]
    t_g: torch.Tensor      # (B, 2NGF)
    mu: torch.Tensor       # (B,)
    alpha: torch.Tensor    # (B,)
    kk: torch.Tensor       # (B,) int32
    stat: torch.Tensor     # (B, k_max, 5)
    lam_ref: torch.Tensor  # (B,) cumulative-guard anchor, +inf: none yet


class _LRes(NamedTuple):
    """KKT residuals of an iterate (phase 2's right-hand sides)."""

    rqL: torch.Tensor      # (N+1, NZ, B)
    rbL: torch.Tensor      # (N, NX, B)
    rdL: torch.Tensor      # (N+1, 2NB, B)
    rmL: torch.Tensor      # (N+1, 2NB, B)
    rd_g: torch.Tensor     # (B, 2NGF)
    rm_g: torch.Tensor     # (B, 2NGF)
    mu: torch.Tensor       # (B,)


def _hot_state(state0, qp, cm, ngh, ng_stages, mu_scal, dt) -> _LState:
    """The loop state that continues a previous stage's solution
    ``state0`` (the two-stage route's hand-off, the JAX engine's
    ``state0`` branch): its full primal-dual iterate under the box and ng
    masks, mu recomputed from lam*t, kk and the stat rows carried, alpha
    back at 1 and the guard's anchor cleared."""
    B = qp.b.shape[0]
    mb_st = torch.cat([qp.nb_mask, qp.nb_mask], -1)
    lam_st = torch.cat([state0.lam_b[:, :, 0], state0.lam_b[:, :, 1]],
                       -1).to(dt)
    t_st = torch.cat([state0.t_b[:, :, 0], state0.t_b[:, :, 1]], -1).to(dt)
    lamL = to_lanes(torch.where(mb_st > 0, lam_st, torch.zeros_like(lam_st)))
    tL = to_lanes(torch.where(mb_st > 0, t_st, torch.ones_like(t_st)))
    mu = (lamL * tL * cm.mbL).reshape(-1, B).sum(0)
    lam_g = t_g = torch.zeros(B, 0, dtype=dt, device=qp.device)
    if ng_stages:
        def gcat(a):
            return torch.cat([a[:, n, side].to(dt) for side in (0, 1)
                              for n in ng_stages], 1)

        lam_g = torch.where(ngh.mg2 > 0, gcat(state0.lam_g),
                            torch.zeros_like(ngh.mg2))
        t_g = torch.where(ngh.mg2 > 0, gcat(state0.t_g),
                          torch.ones_like(ngh.mg2))
        mu = mu + (lam_g * t_g * ngh.mg2).sum(1)
    return _LState(
        zL=to_lanes(state0.z.to(dt) * qp.z_mask),
        piL=to_lanes(state0.pi.to(dt) * qp.x_mask[:, 1:]),
        lamL=lamL, tL=tL, lam_g=lam_g, t_g=t_g, mu=mu * mu_scal,
        alpha=torch.ones(B, dtype=dt, device=qp.device),
        kk=state0.kk.to(torch.int32), stat=state0.stat.to(dt),
        lam_ref=torch.full((B,), float("inf"), dtype=dt, device=qp.device))


def solve_batched_lanes(dims: OCPDims, qp: OCPQP, cfg, z0=None, pi0=None,
                        state0=None, flat: bool = False,
                        kkt_factory=None) -> _ipm.IPMSolution:
    """Batched two-phase solve on the lanes engine (the JAX package's
    ``solve_batched_lanes``).

    ``z0`` (B, N+1, NZ) / ``pi0`` (B, N, NX) with ``cfg.warm_start`` seed
    the iterate; ``state0``, a previous stage's :class:`~.ipm.IPMSolution`,
    seeds the whole primal-dual state instead (hot continuation: mu is
    recomputed from lam*t, kk and the stat rows carry over, alpha restarts
    at 1).  ``cfg.iter_ref`` > 0 refines every direction ``iter_ref``
    times (:func:`~..ops.stage_kernel.refine_flat_fused`); with
    ``cfg.iter_ref_mu_thr`` > 0 only the iterations that start with the
    batch's smallest mu below it (one decision for the whole batch, live or
    not, as in the JAX engine); ``HPMPC_FUSED_REFINE=0`` runs each pass
    unfused (:func:`~..ops.stage_kernel.resid_terms_flat` +
    :func:`~..ops.stage_kernel.solve_flat_pb`).  ``flat=True`` is the flat
    form that ``parallel.batch`` routes the ``"flat"`` engine and the flat
    stage 2 to: the 6-kernel sequence with the unfused refinement, whatever
    the two knobs say.  float32 and float64 both run.  Liveness is per
    instance: the loops run while any instance is live (one host sync per
    iteration), and an instance that is not live keeps its state (a
    select).  Needs a static ``dims.idxb``; a problem with general rows
    and no box rows runs with one masked box slot (``OCPDims.NB`` is at
    least 1, ``nb_mask`` 0), which every kernel of both forms ignores.

    ``kkt_factory(dims, qp, ng_stages, Hl, Fl)`` (the flat form only, no
    ``iter_ref``: the JAX engine's hook, ``ipm_fast.solve_batched_flat``)
    swaps the KKT kernels while the step, alpha, gating and trace machinery
    stays: it returns a namespace with ``factor(dvec, ngl, g, b) -> (dz,
    dpi, fstate)``, ``resolve(fstate, g, b) -> (dz, dpi)``,
    ``resid_terms(z, pi) -> (hz, fz, fpi)`` (the Newton residual's node
    and edge products) and ``apply_fpi(rq, fpi)`` (fpi onto the rows it
    belongs to), every stream batch-last; ``Hl`` and ``Fl`` are the
    engine's packed H and F streams.  Used by the scenario tree
    (:func:`.tree.solve_tree_ipm_flat`); None is the chain.

    Not ported yet: ``HPMPC_FUSED_SWEEPS=1`` (ROADMAP Queue 2 rows 17-18)
    raises ``NotImplementedError``."""
    iter_ref = int(cfg.iter_ref)
    ref_thr = float(cfg.iter_ref_mu_thr)
    mega = (not flat and iter_ref == 0
            and os.environ.get("HPMPC_MEGA_SWEEPS", "1") == "1")
    if kkt_factory is not None and (not flat or iter_ref
                                    or state0 is not None):
        raise ValueError("a kkt_factory runs on the flat form, without "
                         "iter_ref and state0")
    if (not mega and kkt_factory is None
            and os.environ.get("HPMPC_FUSED_SWEEPS", "0") == "1"):
        raise NotImplementedError(
            "lanes engine: the fused sweeps (HPMPC_FUSED_SWEEPS=1) need "
            "ROADMAP Queue 1 #7b, Queue 2 rows 17 and 18")
    fused_refine = (not flat
                    and os.environ.get("HPMPC_FUSED_REFINE", "1") == "1")
    dt = qp.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"lanes engine takes float32/float64, got {dt}")
    if dims.idxb is None:
        raise ValueError("lanes engine needs a static dims.idxb")
    dev = qp.device
    N, NU, NX, NZ, NB, NG = (dims.N, dims.NU, dims.NX, dims.NZ, dims.NB,
                             dims.NG)
    Np1 = N + 1
    B = qp.b.shape[0]
    kd = dict(NB=NB, NU=NU, NZ=NZ, NX=NX)
    ks = dict(NU=NU, NZ=NZ, NX=NX)
    ng_stages = tuple(n for n in range(Np1) if dims.ng[n] > 0)
    n_ng = len(ng_stages)
    NGF = n_ng * NG
    k_max = int(cfg.k_max)
    mu_scal = 1.0 / dims.n_constr
    mu_tol = float(cfg.mu_tol)
    mu_tol_low = float(max(cfg.mu_tol, cfg.mu_switch))
    alpha_min = float(cfg.alpha_min)

    cm = make_lanes_common(dims, qp, cfg, z0=z0, pi0=pi0)
    idxT, mbL, dcatL, gL, bL = cm.idxT, cm.mbL, cm.dcatL, cm.gL, cm.bL
    pdregL, Hl, Fl = cm.pdregL, cm.Hl, cm.Fl
    zmaskL, xmaskL = to_lanes(qp.z_mask), to_lanes(qp.x_mask[:, 1:])
    ngh = make_ng_lanes(dims, qp, ng_stages, dt, B)
    kkt = (kkt_factory(dims, qp, ng_stages, Hl, Fl)
           if kkt_factory is not None else None)
    mgF, dg_cat, mg2, sgn_g = ngh.mgF, ngh.dg_cat, ngh.mg2, ngh.sgn_g
    cz_of, fold_g = ngh.cz_of, ngh.fold_g
    cat2 = lambda v: torch.cat([v, v], 1)  # noqa: E731
    empty = torch.zeros(B, 0, dtype=dt, device=dev)
    gate = cm.gate

    def finish(parts, lam_g, t_g, dtg, dlg):
        return cm.finish_alpha_sums(parts, ngh, lam_g, t_g, dtg, dlg)

    def lam_inst_max(lamL, lam_g):
        """Per-instance max |dual| (the dual-explosion guard's measure)."""
        m = lamL.abs().reshape(-1, B).amax(0)
        return torch.maximum(m, lam_g.abs().amax(1)) if n_ng else m

    def ng_barrier(s):
        """(1/t, lam/t, Qx_g, the kernels' ngl stream) of the ng rows at
        ``s``; Qx_g is the folded masked barrier diagonal (B, NGF)."""
        if not n_ng:
            return empty, empty, None, None
        t_inv_g = torch.where(mg2 > 0, 1.0 / s.t_g, torch.zeros_like(s.t_g))
        lamt_g = s.lam_g * t_inv_g
        Qx_g = fold_g(lamt_g) * mgF
        return t_inv_g, lamt_g, Qx_g, ngh.ngl_of(Qx_g)

    def refine(fstate, Qx_g, geffL, rhsL, zL, piL):
        """``iter_ref`` ITER_REF passes on the direction (zL, piL) of the
        Newton system the 6-kernel affine half factored: fused, or the
        unfused pass (the JAX engine's ``newton_refine_lanes``): the stage
        products, the residuals assembled elementwise (the pi coupling and
        the x shift are slice-adds in this layout), the re-solve with Pb
        recomputed for rb, the update."""
        Ll, Lxx, _, dvecL = fstate
        if fused_refine:
            qxgl = to_lanes(Qx_g.reshape(B, n_ng, NG)) if n_ng else None
            for _ in range(iter_ref):
                zL, piL = sk.refine_flat_fused(
                    Hl, dvecL, ngh.Cl_lanes, qxgl, ng_stages, geffL, Fl, rhsL,
                    zL, piL, Ll, Lxx, **ks)
            return zL, piL
        for _ in range(iter_ref):
            hzL, fzL, fpiL = sk.resid_terms_flat(Hl, Fl, zL, piL, NZ=NZ,
                                                 NX=NX)
            # the terms in the fused pass's order (csrc/refine_flat.cu):
            # g + dvec z as one multiply-add (dvec ~ 1/mu near the end,
            # where rounding dvec z apart from g would round the largest
            # term alone), + H z, + F pi, - the pi shift, + the ng term
            rqL = torch.addcmul(geffL, dvecL, zL) + hzL
            rqL[:N] += fpiL[:N]
            rqL[1:, NU:] -= piL
            if n_ng:
                rqL = ngh.ct_add_lanes(rqL, Qx_g * mgF * cz_of(zL))
            rbL = rhsL + fzL[:N] - zL[1:, NU:]
            dzL, dpiL = sk.solve_flat_pb(Ll, Lxx, rqL, Fl, rbL, **ks)
            zL, piL = zL + dzL, piL + dpiL
        return zL, piL

    def affine_half(s, A_L, M_L, baseL, rhsL, qx_g, Qx_g, ngl, phase2,
                    do_ref):
        """Barrier prep + factorization + affine solve + affine alpha
        partials: one mega kernel, or the 6-kernel loop's prep,
        factor+solve (+ refinement) and alpha passes.  Returns (dz, fstate,
        dt, dl, (amin, s0, s1, s2)); the 6-kernel fstate also carries
        dvec."""
        if mega:
            dzL, fstate, dtL, dlL, *parts = mk.factor_solve_mega(
                idxT, s.lamL, s.tL, A_L, M_L, mbL, baseL, pdregL, Hl, ngl,
                ngh.ct_lanes_stream(qx_g) if n_ng else None, ng_stages, Fl,
                rhsL, phase2=phase2, **kd)
            return dzL, fstate, dtL, dlL, parts
        dvecL, geffL = stk.prep_flat(idxT, s.lamL, s.tL, A_L, M_L, mbL,
                                     baseL, pdregL, NB=NB, NZ=NZ,
                                     phase2=phase2)
        if n_ng:
            geffL = ngh.ct_add_lanes(geffL, qx_g)
        if kkt is not None:
            dzL, dpiL, fstate = kkt.factor(dvecL, ngl, geffL, rhsL)
        else:
            dzL, dpiL, fstate = sk.factor_solve_folded_flat(
                Hl, dvecL, ngl, ng_stages, geffL, Fl, rhsL,
                want_pi=iter_ref > 0, **ks)
        fstate = fstate + (dvecL,)
        if do_ref:
            dzL, _ = refine(fstate, Qx_g, geffL, rhsL, dzL, dpiL)
        dtL, dlL, *parts = stk.alpha_sums_flat(
            idxT, dzL, s.lamL, s.tL, A_L, M_L, None, mbL, NB=NB, NZ=NZ,
            phase2=phase2)
        return dzL, fstate, dtL, dlL, parts

    def corr_half(s, A_L, M_L, fstate, dtL, dlL, smu, baseL, rhsL, qx_g2,
                  Qx_g, phase2, do_ref):
        """Corrector gradient + retained-factor solve + corrector alpha
        partials: one mega kernel, or the 6-kernel loop's corrector pass,
        re-solve (+ refinement) and alpha pass.  Returns (dz2, dpi2, dt2,
        dl2, (amin, s0, s1, s2))."""
        if mega:
            dz2L, dpi2L, dt2L, dl2L, *parts = mk.solve_mega(
                idxT, fstate, s.lamL, s.tL, A_L, M_L, mbL, dtL, dlL, smu,
                baseL, ngh.ct_lanes_stream(qx_g2) if n_ng else None,
                ng_stages, Fl, rhsL, phase2=phase2, **kd)
            return dz2L, dpi2L, dt2L, dl2L, parts
        geff2L, coL = stk.corr_geff_flat(idxT, s.lamL, s.tL, A_L, M_L, dtL,
                                         dlL, smu, baseL, mbL, NB=NB, NZ=NZ,
                                         phase2=phase2)
        if n_ng:
            geff2L = ngh.ct_add_lanes(geff2L, qx_g2)
        if kkt is not None:
            dz2L, dpi2L = kkt.resolve(fstate[:3], geff2L, rhsL)
        else:
            dz2L, dpi2L = sk.solve_flat(*fstate[:3], geff2L, Fl, rhsL, **ks)
        if do_ref:
            dz2L, dpi2L = refine(fstate, Qx_g, geff2L, rhsL, dz2L, dpi2L)
        dt2L, dl2L, *parts = stk.alpha_sums_flat(
            idxT, dz2L, s.lamL, s.tL, A_L, coL if phase2 else None,
            None if phase2 else coL, mbL, NB=NB, NZ=NZ, phase2=phase2)
        return dz2L, dpi2L, dt2L, dl2L, parts

    def candidate(s, a2, dz2L, dpi2L, dt2L, dl2L, dtg2, dlg2, phase2):
        """The iterate after a step of length ``a2`` (B,): phase 1 steps
        toward the full corrector iterate, phase 2 along the delta."""
        if phase2:
            z_new, pi_new = s.zL + a2 * dz2L, s.piL + a2 * dpi2L
        else:
            z_new = s.zL + a2 * (dz2L - s.zL)
            pi_new = s.piL + a2 * (dpi2L - s.piL)
        return (z_new, pi_new, s.lamL + a2 * dl2L, s.tL + a2 * dt2L,
                s.lam_g + a2[:, None] * dlg2, s.t_g + a2[:, None] * dtg2)

    def accept(s, cand, row):
        """The state after the step ``cand`` with trace row ``row`` (B, 5),
        gated by the breakdown guard: a refused step keeps ``s`` with alpha
        0, which ends the instance.  Returns (ok, state)."""
        mu_new = row[:, 4]
        lmx_new = lam_inst_max(cand[2], cand[4])
        s_new = _LState(
            *cand, mu=mu_new, alpha=0.995 * row[:, 3], kk=s.kk + 1,
            stat=cm.stat_update(s.stat, s.kk, row),
            lam_ref=_ipm.anchor_lam_ref(s.lam_ref, mu_new, lmx_new))
        ok = _ipm.step_ok(mu_new, s.mu, lmx_new,
                          lam_inst_max(s.lamL, s.lam_g), s.lam_ref)
        refused = s._replace(alpha=torch.zeros_like(s.alpha))
        return ok, gate(ok, s_new, refused)

    def live_and_gate(s, tol):
        """The loop's one host sync: the live instances (B,) and whether
        any is live; with ``iter_ref`` also the batch-wide refinement gate
        (the smallest mu of every instance, live or not, below
        ``iter_ref_mu_thr``; always on without a threshold)."""
        live = (s.kk < k_max) & (s.mu > tol) & (s.alpha >= alpha_min)
        if not iter_ref or ref_thr <= 0:
            return live, bool(live.any()), bool(iter_ref)
        any_live, do_ref = torch.stack(
            [live.any(), s.mu.min() < ref_thr]).tolist()
        return live, any_live, do_ref

    # ---- phase 1 (delta formulation) -------------------------------------
    def phase1_body(s, do_ref):
        t_inv_g, lamt_g, Qx_g, ngl = ng_barrier(s)
        qx_g = (fold_g(-sgn_g * s.lam_g - lamt_g * dg_cat) * mgF
                if n_ng else None)
        dzL, fstate, dtL, dlL, parts = affine_half(
            s, dcatL, None, gL, bL, qx_g, Qx_g, ngl, False, do_ref)
        dtg = dlg = empty
        if n_ng:
            dtg = (sgn_g * (cat2(cz_of(dzL)) - dg_cat) - s.t_g) * mg2
            dlg = (-lamt_g * dtg - s.lam_g) * mg2
        alpha_aff, a0, a1, a2c = finish(parts, s.lam_g, s.t_g, dtg, dlg)
        a = 0.995 * alpha_aff
        mu_aff = (a0 + a * a1 + a * a * a2c) * mu_scal
        sigma = (mu_aff / s.mu) ** 3
        smu = sigma * s.mu

        qx_g2 = dl2g = None
        if n_ng:
            dl2g = t_inv_g * (smu[:, None] - dlg * dtg) * mg2
            qx_g2 = qx_g + fold_g(-sgn_g * dl2g) * mgF
        dz2L, dpi2L, dt2L, dl2L, parts2 = corr_half(
            s, dcatL, None, fstate, dtL, dlL, smu, gL, bL, qx_g2, Qx_g,
            False, do_ref)
        dtg2 = dlg2 = empty
        if n_ng:
            dtg2 = (sgn_g * (cat2(cz_of(dz2L)) - dg_cat) - s.t_g) * mg2
            dlg2 = (dl2g - lamt_g * dtg2 - s.lam_g) * mg2
        alpha2, b0, b1, b2 = finish(parts2, s.lam_g, s.t_g, dtg2, dlg2)
        a2 = 0.995 * alpha2
        mu_new = (b0 + a2 * b1 + a2 * a2 * b2) * mu_scal
        row = torch.stack([sigma, alpha_aff, mu_aff, alpha2, mu_new], 1)
        cand = candidate(s, a2, dz2L, dpi2L, dt2L, dl2L, dtg2, dlg2, False)
        return accept(s, cand, row)[1]

    if state0 is None:
        lam_g0, t_g0 = cm.ng_init(ngh)
        s = _LState(
            zL=cm.zL0,
            piL=(cm.piL0 if cm.piL0 is not None
                 else torch.zeros(N, NX, B, dtype=dt, device=dev)),
            lamL=cm.lamL0, tL=cm.tL0, lam_g=lam_g0, t_g=t_g0,
            mu=torch.full((B,), float(cfg.mu0), dtype=dt, device=dev),
            alpha=torch.ones(B, dtype=dt, device=dev),
            kk=torch.zeros(B, dtype=torch.int32, device=dev),
            stat=torch.zeros(B, k_max, 5, dtype=dt, device=dev),
            lam_ref=torch.full((B,), float("inf"), dtype=dt, device=dev))
    else:
        s = _hot_state(state0, qp, cm, ngh, ng_stages, mu_scal, dt)

    while True:
        live, any_live, do_ref = live_and_gate(s, mu_tol_low)
        if not any_live:
            break
        s = gate(live, phase1_body(s, do_ref), s)

    # ---- residuals (one kernel + the ng rows) ----------------------------
    if kkt is not None:
        idx_box = idxT.long()[:, :, None].expand(Np1, NB, B)
        sgnL = torch.cat([torch.ones(NB, 1, dtype=dt, device=dev),
                          -torch.ones(NB, 1, dtype=dt, device=dev)])

    def kkt_residuals(zL, piL, lamL, tL):
        """The hook's residuals: its node and edge products, assembled
        elementwise as the JAX engine's ``residuals`` assembles them (the
        terms of ``resid_full``: rb on the edges, the box rows per
        stage)."""
        hzL, fzL, fpiL = kkt.resid_terms(zL, piL)
        rqL = kkt.apply_fpi(gL + hzL, fpiL)
        rqL[1:, NU:] -= piL
        lam_f = (lamL[:, NB:] - lamL[:, :NB]) * mbL[:, :NB]
        rqL = rqL.scatter_add(1, idx_box, lam_f) * zmaskL
        rbL = (bL + fzL - zL[1:, NU:]) * xmaskL
        zb = torch.gather(zL, 1, idx_box)
        rdL = (dcatL - torch.cat([zb, zb], 1) + sgnL * tL) * mbL
        rmL = lamL * tL * mbL
        return rqL, rbL, rdL, rmL, rmL.sum(1)

    def residuals(zL, piL, lamL, tL, lam_g, t_g):
        if kkt is not None:
            rqL, rbL, rdL, rmL, musumL = kkt_residuals(zL, piL, lamL, tL)
        else:
            rqL, rbL, rdL, rmL, musumL = stk.resid_full(
                idxT, Hl, Fl, zL, piL, gL, bL, lamL, tL, dcatL, mbL, zmaskL,
                xmaskL, **kd)
            rbL = rbL[:N]
        mu = musumL.sum(0)
        rd_g = rm_g = empty
        if n_ng:
            rqL = ngh.ct_add_lanes(rqL, fold_g(-sgn_g * lam_g) * mgF)
            rd_g = (dg_cat - cat2(cz_of(zL)) + sgn_g * t_g) * mg2
            rm_g = lam_g * t_g * mg2
            mu = mu + rm_g.sum(1)
        return _LRes(rqL, rbL, rdL, rmL, rd_g, rm_g, mu * mu_scal)

    res = residuals(s.zL, s.piL, s.lamL, s.tL, s.lam_g, s.t_g)
    s = s._replace(mu=res.mu)

    # ---- phase 2 (residual formulation) ----------------------------------
    def phase2_body(s, res, do_ref):
        t_inv_g, lamt_g, Qx_g, ngl = ng_barrier(s)

        def qxg_from(rm_g):
            return fold_g(sgn_g * t_inv_g * rm_g - lamt_g * res.rd_g) * mgF

        dzL, fstate, dtL, dlL, parts = affine_half(
            s, res.rdL, res.rmL, res.rqL, res.rbL,
            qxg_from(res.rm_g) if n_ng else None, Qx_g, ngl, True, do_ref)
        dtg = dlg = empty
        if n_ng:
            dtg = sgn_g * (cat2(cz_of(dzL)) - res.rd_g) * mg2
            dlg = -t_inv_g * (s.lam_g * dtg + res.rm_g) * mg2
        alpha_aff, a0, a1, a2c = finish(parts, s.lam_g, s.t_g, dtg, dlg)
        a = 0.995 * alpha_aff
        mu_aff = (a0 + a * a1 + a * a * a2c) * mu_scal
        sigma = (mu_aff / s.mu) ** 3
        smu = sigma * s.mu

        qx_g2 = rm_g2 = None
        if n_ng:
            rm_g2 = res.rm_g + (dtg * dlg - smu[:, None]) * mg2
            qx_g2 = qxg_from(rm_g2)
        dz2L, dpi2L, dt2L, dl2L, parts2 = corr_half(
            s, res.rdL, res.rmL, fstate, dtL, dlL, smu, res.rqL, res.rbL,
            qx_g2, Qx_g, True, do_ref)
        dtg2 = dlg2 = empty
        if n_ng:
            dtg2 = sgn_g * (cat2(cz_of(dz2L)) - res.rd_g) * mg2
            dlg2 = -t_inv_g * (s.lam_g * dtg2 + rm_g2) * mg2
        alpha2 = finish(parts2, s.lam_g, s.t_g, dtg2, dlg2)[0]
        a2 = 0.995 * alpha2
        cand = candidate(s, a2, dz2L, dpi2L, dt2L, dl2L, dtg2, dlg2, True)
        res_new = residuals(*cand)
        row = torch.stack([sigma, alpha_aff, mu_aff, alpha2, res_new.mu], 1)
        ok, s_new = accept(s, cand, row)
        return s_new, gate(ok, res_new, res)

    while True:
        live, any_live, do_ref = live_and_gate(s, mu_tol)
        if not any_live:
            break
        s_new, res_new = phase2_body(s, res, do_ref)
        s, res = gate(live, s_new, s), gate(live, res_new, res)

    # ---- status, residual norms, the IPMSolution --------------------------
    status = torch.where(
        s.mu <= mu_tol, 0, torch.where(s.kk >= k_max, 1, 2)).to(torch.int32)

    def absmax_l(y):  # batch-last stream -> (B,)
        return y.abs().reshape(-1, B).amax(0)

    rd_max = absmax_l(res.rdL)
    if n_ng:
        rd_max = torch.maximum(rd_max, res.rd_g.abs().amax(1))
    inf_norm_res = torch.stack([absmax_l(res.rqL), absmax_l(res.rbL), rd_max,
                                res.mu], dim=1)
    lam_g_s = torch.zeros(B, Np1, 2, NG, dtype=dt, device=dev)
    t_g_s = torch.ones(B, Np1, 2, NG, dtype=dt, device=dev)
    for k, n in enumerate(ng_stages):
        sl = slice(k * NG, (k + 1) * NG)
        lam_g_s[:, n, 0] = s.lam_g[:, sl]
        lam_g_s[:, n, 1] = s.lam_g[:, NGF:][:, sl]
        t_g_s[:, n, 0] = s.t_g[:, sl]
        t_g_s[:, n, 1] = s.t_g[:, NGF:][:, sl]
    return _ipm.IPMSolution(
        z=from_lanes(s.zL), pi=from_lanes(s.piL),
        lam_b=from_lanes(s.lamL).reshape(B, Np1, 2, NB),
        t_b=from_lanes(s.tL).reshape(B, Np1, 2, NB),
        lam_g=lam_g_s, t_g=t_g_s, kk=s.kk, status=status, stat=s.stat,
        inf_norm_res=inf_norm_res)
