"""The dense condensed-QP IPM, the single-instance latency engine (PyTorch
twin of :mod:`hpmpc_tpu.models.ipm_dense`).

FULL condensing (``cond.plan(dims, 1)``) plus elimination of the terminal
state leaves ONE dense QP

    min 1/2 y' Hd y + gd' y          y = condensed inputs (nz = sum nu)
    s.t. lb <= Sel' y <= ub          (the surviving input box slots)
         dlg <= G y <= dug           (state boxes + terminal rows)

with no stage recursion: the only sequential depth per IPM iteration is the
nz-column dense Cholesky.  The matrices are condensed once per plan; each
tick maps the raw per-stage offsets ``vec(b)`` to the dense vectors by
affine maps ``v(b) = v_c + v_m vec(b)``.

The maps: the JAX package takes ``jax.jacfwd`` of the vector pipeline.
Here the pipeline (:func:`_dense_vectors`, batch-native) runs once on a
batch: instance 0 is the problem with b = 0 (the constants ``v_c``), and
instance i > 0 is the problem with every constant vector (g, the bounds)
set to zero and b = the i-th unit vector.  Every output of the pipeline is
a linear function of b plus a term in those constants only, so instance i
is exactly ``v_m`` e_i, computed by the same linear operations jacfwd's
tangents go through (no difference quotient, no step size).

f32 caveat (the JAX package's, measured there): condensing squares the
conditioning; with an active terminal general block the f32 dense path
stalls near mu 1e-3.  On box-constrained problems f32 converges with the
sequential solver's iteration count.

Semantics: phase-1 Mehrotra to ``mu_tol``/``k_max`` (the legacy
``d_ip2_hard.c`` contract).  :func:`solve_dense_tick` runs the tick
through the hand-written kernel (``ops.dense_kernel``, Queue 2 row 23)
for CUDA tensors and through its plain version for CPU tensors;
``use_kernel=False`` runs :func:`solve_dense_ref`, the port of the JAX
package's f64-capable oracle.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ocp import OCPDims, OCPQP
from ..ops import dense_kernel as dk
from ..ops.tri import cholesky, solve_tril, solve_triu
from ..parallel.batch import broadcast_qp
from . import cond as _cond
from . import ipm as _ipm


class DensePlan(NamedTuple):
    """Static dense-QP data + the affine vector maps ``v(b) = v_c + v_m @
    vec(b)`` for v in {gd, lb, ub, dlg, dug} (exact: the pipeline is affine
    in the stage offsets)."""

    nz: int
    nb: int
    ngd: int
    nu0: int              # nu of stage 0 (u_0 = y[nz-nu0:nz], reversed-u)
    Hd: torch.Tensor      # (nz, nz)
    Sel: torch.Tensor     # (nz, nb) 0/1 box gather
    G: torch.Tensor       # (ngd, nz)
    gd_c: torch.Tensor
    gd_m: torch.Tensor
    lb_c: torch.Tensor
    lb_m: torch.Tensor
    ub_c: torch.Tensor
    ub_m: torch.Tensor
    dlg_c: torch.Tensor
    dlg_m: torch.Tensor
    dug_c: torch.Tensor
    dug_m: torch.Tensor

    def vectors(self, bflat):
        """(gd, lb, ub, dlg, dug) of the tick with offsets ``bflat``."""
        return tuple(c + m @ bflat for c, m in (
            (self.gd_c, self.gd_m), (self.lb_c, self.lb_m),
            (self.ub_c, self.ub_m), (self.dlg_c, self.dlg_m),
            (self.dug_c, self.dug_m)))


class DenseTickResult(NamedTuple):
    u0: torch.Tensor      # (nu0,) first-stage controls (what a tick ships)
    y: torch.Tensor       # (nz,) full condensed input vector
    kk: torch.Tensor      # int32 iterations
    mu: torch.Tensor      # final duality measure
    status: torch.Tensor  # 0 converged / 1 k_max / 2 frozen


def _terminal_blocks(qp2: OCPQP, pl2):
    """Terminal-stage x-block cost of a condensed batch (the padded layout
    puts stage 1's x block at ``dims2.NU``, while ``dims2.idxb`` holds
    logical coordinates)."""
    d2 = pl2.dims2
    NU2, NX2 = d2.NU, d2.NX
    Hxx = qp2.H[:, 1, NU2:NU2 + NX2, NU2:NU2 + NX2]
    gx = qp2.g[:, 1, NU2:NU2 + NX2]
    return Hxx, gx, NU2, NX2


def _dense_vectors(dims: OCPDims, qpb: OCPQP, pl2, box_slots):
    """(gd, lb, ub, dlg, dug) of the eliminated dense QP of every instance
    of the batch ``qpb``, each (B, n)."""
    d2 = pl2.dims2
    nz = d2.NU
    qp2 = _cond.condense(qpb, pl2)
    Hxx, gx, xoff, NX2 = _terminal_blocks(qp2, pl2)
    nuN = dims.nu[dims.N]
    Fy = qp2.F[:, 0, :nz, :]                      # (B, nz, NX2)
    b0 = qp2.b[:, 0]                              # (B, NX2)
    mv = lambda A, x: (A @ x[..., None])[..., 0]  # noqa: E731

    gd = qp2.g[:, 0, :nz] + mv(Fy, mv(Hxx, b0) + gx)
    slots = list(box_slots)
    lb = qp2.d_lb[:, 0, slots]
    ub = qp2.d_ub[:, 0, slots]
    rows_lo, rows_hi = [qp2.d_lg[:, 0, :d2.ng[0]]], [qp2.d_ug[:, 0, :d2.ng[0]]]
    for k in range(d2.nb[1]):                     # terminal box -> general
        j = int(d2.idxb[1][k]) - nuN
        rows_lo.append((qp2.d_lb[:, 1, k] - b0[:, j])[:, None])
        rows_hi.append((qp2.d_ub[:, 1, k] - b0[:, j])[:, None])
    if d2.ng[1]:                                  # terminal ng -> general
        crow = qp2.C[:, 1, :d2.ng[1], xoff:xoff + NX2]
        cb = mv(crow, b0)
        rows_lo.append(qp2.d_lg[:, 1, :d2.ng[1]] - cb)
        rows_hi.append(qp2.d_ug[:, 1, :d2.ng[1]] - cb)
    return gd, lb, ub, torch.cat(rows_lo, 1), torch.cat(rows_hi, 1)


def plan_dense(dims: OCPDims, qp: OCPQP) -> DensePlan:
    """The dense plan of ONE chain QP (leaves without an instance axis), on
    its device: matrices by full condensing, the vector maps as the module
    doc says."""
    N, NX = dims.N, dims.NX
    dt, dev = qp.dtype, qp.device
    pl2 = _cond.plan(dims, 1)
    d2 = pl2.dims2
    nz = d2.NU
    q1 = broadcast_qp(qp, 1)
    qp2 = _cond.condense(q1, pl2)
    Hxx, gx, xoff, NX2 = _terminal_blocks(qp2, pl2)
    nuN = dims.nu[N]
    Fy = qp2.F[0, 0, :nz, :]
    Hd = qp2.H[0, 0, :nz, :nz] + (Fy @ Hxx[0]) @ Fy.T
    Hd = 0.5 * (Hd + Hd.T)

    # surviving input box slots of the condensed stage (x0-region rows are
    # eliminated with x0)
    box_slots = tuple(k for k in range(d2.nb[0]) if int(d2.idxb[0][k]) < nz)
    Sel = torch.zeros(nz, len(box_slots), dtype=dt, device=dev)
    for i, k in enumerate(box_slots):
        Sel[int(d2.idxb[0][k]), i] = 1.0

    rows = [qp2.C[0, 0, :d2.ng[0], :nz]]
    for k in range(d2.nb[1]):
        j = int(d2.idxb[1][k]) - nuN
        rows.append(Fy[:, j][None, :])
    if d2.ng[1]:
        rows.append(qp2.C[0, 1, :d2.ng[1], xoff:xoff + NX2] @ Fy.T)
    G = torch.cat(rows, 0)

    # instance 0: b = 0 (the constants); instance 1 + i: the constants
    # zeroed, b = e_i (the linear part's column i)
    nb_flat = N * NX
    qb = broadcast_qp(qp, 1 + nb_flat)
    unit = torch.cat([torch.zeros(1, nb_flat, dtype=dt, device=dev),
                      torch.eye(nb_flat, dtype=dt, device=dev)], 0)
    keep = torch.zeros(1 + nb_flat, 1, 1, dtype=dt, device=dev)
    keep[0] = 1.0
    qb = dataclasses.replace(
        qb, b=unit.reshape(1 + nb_flat, N, NX), g=qb.g * keep,
        d_lb=qb.d_lb * keep, d_ub=qb.d_ub * keep, d_lg=qb.d_lg * keep,
        d_ug=qb.d_ug * keep)
    vec = _dense_vectors(dims, qb, pl2, box_slots)
    consts = [v[0] for v in vec]
    maps = [v[1:].T.contiguous() for v in vec]
    return DensePlan(
        nz=int(nz), nb=len(box_slots), ngd=int(G.shape[0]),
        nu0=int(dims.nu[0]), Hd=Hd.contiguous(), Sel=Sel,
        G=G.contiguous(),
        gd_c=consts[0], gd_m=maps[0], lb_c=consts[1], lb_m=maps[1],
        ub_c=consts[2], ub_m=maps[2], dlg_c=consts[3], dlg_m=maps[3],
        dug_c=consts[4], dug_m=maps[4])


def _result(plan: DensePlan, y, kk, mu, status) -> DenseTickResult:
    # reversed-u layout: u_0 is the LAST nu0 block of y (cond.plan)
    return DenseTickResult(u0=y[plan.nz - plan.nu0:plan.nz], y=y, kk=kk,
                           mu=mu, status=status)


def solve_dense_ref(plan: DensePlan, bflat, cfg, y0=None) -> DenseTickResult:
    """Plain reference of the dense phase-1 Mehrotra IPM (the JAX
    package's oracle, ``solve_dense_ref``): ``ipm.py``'s phase-1 formulas
    on one dense stage, the blocked clamped Cholesky of :mod:`..ops.tri`,
    the breakdown guard :func:`.ipm.step_ok`.  ``y0``: warm-start iterate
    (None = cold); the ``d_init_var`` clamp applies either way.  One host
    sync per iteration."""
    dt, dev = plan.Hd.dtype, plan.Hd.device
    gd, lb, ub, dlg, dug = plan.vectors(bflat)
    Sel, G = plan.Sel, plan.G
    c = lambda v: torch.tensor(v, dtype=dt, device=dev)  # noqa: E731
    mu0, thr0 = c(cfg.mu0), c(0.1)
    mu_scal = c(1.0 / (2 * (plan.nb + plan.ngd)))
    mu_tol, alpha_min = c(cfg.mu_tol), c(cfg.alpha_min)

    y = (torch.zeros(plan.nz, dtype=dt, device=dev) if y0 is None
         else y0.to(dt))
    yb = Sel.T @ y
    t_lo0, t_up0 = yb - lb, ub - yb
    both = (t_lo0 < thr0) & (t_up0 < thr0)
    lo_o = (t_lo0 < thr0) & ~both
    up_o = (t_up0 < thr0) & ~both
    t_lo = torch.where(both | lo_o, thr0, t_lo0)
    t_up = torch.where(both | up_o, thr0, t_up0)
    yb_c = torch.where(both, 0.5 * (lb - ub),
                       torch.where(lo_o, lb + thr0,
                                   torch.where(up_o, ub - thr0, yb)))
    ch = (both | lo_o | up_o).to(dt)
    y = y - Sel @ (ch * yb) + Sel @ (ch * yb_c)
    lam_lo, lam_up = mu0 / t_lo, mu0 / t_up
    cz = G @ y
    tg_lo = torch.maximum(thr0, cz - dlg)
    tg_up = torch.maximum(thr0, dug - cz)
    lg_lo, lg_up = mu0 / tg_lo, mu0 / tg_up

    def mu_of(ll, tl, lu, tu, gl, sl, gu, su):
        return ((ll * tl).sum() + (lu * tu).sum() + (gl * sl).sum()
                + (gu * su).sum()) * mu_scal

    def step(pairs):
        a = c(1.0)
        for v, dv in pairs:
            pred = dv < 0.0
            r = torch.where(pred, -v / torch.where(pred, dv, -torch.ones_like(
                dv)), torch.full_like(v, float("inf")))
            if r.numel():
                a = torch.minimum(a, r.min())
        return a

    def solve(Lc, r):
        return solve_triu(Lc.T, solve_tril(Lc, r))

    state = (y, t_lo, t_up, lam_lo, lam_up, tg_lo, tg_up, lg_lo, lg_up)
    mu, alpha, kk = c(cfg.mu0), c(1.0), 0
    while kk < cfg.k_max and bool(mu > mu_tol) and bool(alpha >= alpha_min):
        (y, t_lo, t_up, lam_lo, lam_up, tg_lo, tg_up, lg_lo, lg_up) = state
        ti_lo, ti_up = 1.0 / t_lo, 1.0 / t_up
        si_lo, si_up = 1.0 / tg_lo, 1.0 / tg_up
        lt_lo, lt_up = lam_lo * ti_lo, lam_up * ti_up
        gt_lo, gt_up = lg_lo * si_lo, lg_up * si_up
        Qx_b = lt_lo + lt_up
        qx_b = (-lam_lo - lt_lo * lb) + (lam_up - lt_up * ub)
        Qx_g = gt_lo + gt_up
        qx_g = (-lg_lo - gt_lo * dlg) + (lg_up - gt_up * dug)
        Hbar = (plan.Hd + Sel @ (Qx_b[:, None] * Sel.T)
                + G.T @ (Qx_g[:, None] * G))
        g_eff = gd + Sel @ qx_b + G.T @ qx_g
        Lc = cholesky(Hbar)
        y1 = solve(Lc, -g_eff)

        def dirs(y_new, dl0_lo, dl0_up, dg0_lo, dg0_up):
            ybn = Sel.T @ y_new
            dt_lo = (ybn - lb) - t_lo
            dt_up = (ub - ybn) - t_up
            dl_lo = dl0_lo - lt_lo * dt_lo - lam_lo
            dl_up = dl0_up - lt_up * dt_up - lam_up
            czn = G @ y_new
            ds_lo = (czn - dlg) - tg_lo
            ds_up = (dug - czn) - tg_up
            dg_lo = dg0_lo - gt_lo * ds_lo - lg_lo
            dg_up = dg0_up - gt_up * ds_up - lg_up
            return dt_lo, dt_up, dl_lo, dl_up, ds_lo, ds_up, dg_lo, dg_up

        def pairs(d):
            return ((lam_lo, d[2]), (lam_up, d[3]), (t_lo, d[0]),
                    (t_up, d[1]), (lg_lo, d[6]), (lg_up, d[7]),
                    (tg_lo, d[4]), (tg_up, d[5]))

        zz = torch.zeros_like
        d1 = dirs(y1, zz(lam_lo), zz(lam_up), zz(lg_lo), zz(lg_up))
        a_aff = step(pairs(d1)) * 0.995
        mu_aff = mu_of(lam_lo + a_aff * d1[2], t_lo + a_aff * d1[0],
                       lam_up + a_aff * d1[3], t_up + a_aff * d1[1],
                       lg_lo + a_aff * d1[6], tg_lo + a_aff * d1[4],
                       lg_up + a_aff * d1[7], tg_up + a_aff * d1[5])
        sigma = (mu_aff / mu) ** 3
        smu = sigma * mu
        dl2_lo = ti_lo * (smu - d1[2] * d1[0])
        dl2_up = ti_up * (smu - d1[3] * d1[1])
        dg2_lo = si_lo * (smu - d1[6] * d1[4])
        dg2_up = si_up * (smu - d1[7] * d1[5])
        qx_b2 = qx_b + (-dl2_lo + dl2_up)
        qx_g2 = qx_g + (-dg2_lo + dg2_up)
        g_eff2 = gd + Sel @ qx_b2 + G.T @ qx_g2
        y2 = solve(Lc, -g_eff2)
        d2 = dirs(y2, dl2_lo, dl2_up, dg2_lo, dg2_up)
        a2 = step(pairs(d2)) * 0.995
        new = (y + a2 * (y2 - y), t_lo + a2 * d2[0], t_up + a2 * d2[1],
               lam_lo + a2 * d2[2], lam_up + a2 * d2[3],
               tg_lo + a2 * d2[4], tg_up + a2 * d2[5],
               lg_lo + a2 * d2[6], lg_up + a2 * d2[7])
        mu_n = mu_of(new[3], new[1], new[4], new[2], new[7], new[5],
                     new[8], new[6])
        if bool(_ipm.step_ok(mu_n, mu)):
            state, mu, alpha, kk = new, mu_n, a2, kk + 1
        else:
            alpha = c(0.0)
    status = 0 if bool(mu <= mu_tol) else (1 if kk >= cfg.k_max else 2)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    return _result(plan, state[0], i32(kk), mu, i32(status))


def solve_dense_tick(plan: DensePlan, bflat, cfg, use_kernel: bool = True,
                     y0=None) -> DenseTickResult:
    """The deployment tick: raw per-stage offsets ``vec(b)`` in, controls
    out.  ``use_kernel`` (default) runs :func:`..ops.dense_kernel.
    dense_ipm_call`: the CUDA kernel for a plan on the card, its plain
    version for a plan on the CPU; ``use_kernel=False`` runs
    :func:`solve_dense_ref`.  ``y0``: warm-start iterate (the previous
    tick's ``y``; the ``d_init_var`` clamp still applies)."""
    if not use_kernel:
        return solve_dense_ref(plan, bflat, cfg, y0=y0)
    y, kk, mu, status = dk.dense_ipm_call(plan, bflat, cfg, y0=y0)
    return _result(plan, y, kk, mu, status)
