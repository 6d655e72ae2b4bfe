"""Stream scaffolding of the batched engines (PyTorch twin of
``make_ng_lanes`` and ``make_lanes_common`` in
:mod:`hpmpc_tpu.models.ipm_lanes`).

Builds, from a batched :class:`~..ocp.OCPQP`, the batch-last streams the
kernels read (layout: :mod:`..ops.layout`): the box index table, the
constant box/stage streams, the reference's ``d_init_var`` initial iterate
(box-violation correction branch included) and the general-constraint
init.  Everything runs as plain tensor code on the QP's device; the
einsums keep float32 at full precision (the package pins TF32 off).

The lanes engine itself (``solve_batched_lanes``) is not ported yet; only
what the resident engine needs is here.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from ..ops.layout import sym_compress, to_lanes


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
        return ns

    C_act = [qp.C[:, n].to(dt) for n in ng_stages]     # each (B, NG, NZ)
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

    ns.cz_of = cz_of
    ns.ct_add_lanes = ct_add_lanes
    ns.fold_g = lambda v: v[:, :NGF] + v[:, NGF:]
    return ns


def make_lanes_common(dims, qp, cfg, z0=None, pi0=None):
    """Shared scaffolding of the batched engines: index table, constant
    box/stage streams and the ``d_init_var`` initial iterate.

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
    return ns
