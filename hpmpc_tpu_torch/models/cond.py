"""Partial (N -> N2) and full (N -> 1) condensing of OCP QPs (PyTorch twin
of :mod:`hpmpc_tpu.models.cond`), batch-native.

The reference's condensing layer (``lqcp_solvers/d_part_cond.c``,
``d_cond.c``): the horizon splits into N2 groups (the first ``R1 = N -
N2*(N//N2)`` one stage longer, ``d_part_cond.c:699-701``); inside a group
every state is an affine function of the group's inputs and entry state
through the "Gamma" prefix maps (``d_cond_BAbt``, ``:214``), which gives a
shorter, denser QP:

  * condensed inputs in REVERSE time order (the reference's layout,
    ``d_cond_BAbt:281-291``): ``u2 = [u_{T-1}; ...; u_1; u_0]``, state
    ``x2 = x_{group start}``;
  * condensed cost: the stage costs composed with the affine maps;
  * constraints (``d_cond_DCtd:579``): input boxes stay boxes (indices
    remapped); state boxes of interior stages become general rows (Gamma
    rows, bounds shifted by the constant term); general rows compose with
    the maps.

:func:`expand_solution` is ``d_part_expand_solution`` (``:1103``).  The two
reference bugs that ``tests/test_cond.py`` documents stay the reference's:
this condensing is the N^3 composition class, which includes the ``S
Gamma_b`` gradient term and the right last block row of R2.

Every QP leaf (and every solution field) carries a leading instance axis
B: ``jax.vmap(condense)`` becomes the batch axis written out.  The
:class:`CondPlan` is static metadata, shared by the batch.  ``suggest_n2``
is not ported: its cost model is fitted to TPU measurements (ROADMAP
Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ocp import OCPDims, OCPQP
from . import ipm


class CondPlan(NamedTuple):
    """Static metadata tying the condensed problem to the original one
    (:class:`hpmpc_tpu.models.cond.CondPlan`)."""

    dims: OCPDims  # original
    dims2: OCPDims  # condensed
    N2: int
    group_start: tuple  # len N2, first original stage of each group
    group_T: tuple  # len N2, number of stages in each group
    box_map: tuple  # ((g, slot2, stage, idx_logical), ...) box -> box
    gen_from_box: tuple  # ((g, row2, stage, idx_logical), ...) state box -> gen
    gen_from_gen: tuple  # ((g, row2, stage, row), ...) gen -> gen


def _groups(N: int, N2: int):
    N1 = N // N2
    R1 = N - N2 * N1
    M1 = N1 + 1 if R1 > 0 else N1
    start, Ts = [], []
    s = 0
    for g in range(N2):
        T = M1 if g < R1 else N1
        start.append(s)
        Ts.append(T)
        s += T
    assert s == N
    return tuple(start), tuple(Ts)


def _rev_offsets(dims: OCPDims, s: int, T: int) -> dict:
    """Reversed-time offset of each stage's inputs in its group's u2."""
    off, acc = {}, 0
    for k in range(T - 1, -1, -1):
        off[k] = acc
        acc += dims.nu[s + k]
    return off


def plan(dims: OCPDims, N2: int) -> CondPlan:
    """Condensed problem sizes and static constraint layout
    (``d_part_cond_compute_problem_size``, ``d_part_cond.c:694``)."""
    if dims.idxb is None:
        raise ValueError("condensing needs a static idxb on OCPDims")
    if not 1 <= N2 <= dims.N:
        raise ValueError(f"N2 must be in [1, {dims.N}], got {N2}")
    N = dims.N
    # boundary states and the terminal cost copy at the full padded width:
    # non-uniform state sizes on stages 1..N would mispack (the reference's
    # condensing is fixed-size only); nx[0] < NX (eliminated x0) is fine
    if any(nxn != dims.NX for nxn in dims.nx[1:]):
        raise ValueError(
            "partial/full condensing requires a uniform state size on "
            f"stages 1..N (got nx={dims.nx}); pad the model or solve "
            "without condensing (N2=None)")
    start, Ts = _groups(N, N2)

    nx2, nu2, nb2, ng2, idxb2 = [], [], [], [], []
    box_map, gen_from_box, gen_from_gen = [], [], []
    for g in range(N2):
        s, T = start[g], Ts[g]
        nx2.append(dims.nx[s])
        nu_g = sum(dims.nu[s:s + T])
        nu2.append(nu_g)
        off = _rev_offsets(dims, s, T)
        ib = ig = 0
        idxb2_g = []
        # interior stages first, last to first (d_cond_DCtd:637-668), then
        # the first stage
        for k in range(T - 1, 0, -1):
            stg = s + k
            for j in range(dims.nb[stg]):
                idx = dims.idxb[stg][j]
                if idx < dims.nu[stg]:          # input box stays box
                    box_map.append((g, ib, stg, idx))
                    idxb2_g.append(off[k] + idx)
                    ib += 1
                else:                           # state box -> general row
                    gen_from_box.append((g, ig, stg, idx))
                    ig += 1
        for j in range(dims.nb[s]):
            idx = dims.idxb[s][j]
            box_map.append((g, ib, s, idx))
            idxb2_g.append(off[0] + idx if idx < dims.nu[s]
                           else nu_g + (idx - dims.nu[s]))
            ib += 1
        for k in range(T - 1, -1, -1):
            stg = s + k
            for j in range(dims.ng[stg]):
                gen_from_gen.append((g, ig, stg, j))
                ig += 1
        nb2.append(ib)
        ng2.append(ig)
        idxb2.append(tuple(idxb2_g))

    nx2.append(dims.nx[N])
    nu2.append(dims.nu[N])
    nb2.append(dims.nb[N])
    ng2.append(dims.ng[N])
    idxb2.append(dims.idxb[N])
    dims2 = OCPDims.create(N2, nx2, nu2, nb2, ng2, idxb=idxb2)
    return CondPlan(dims=dims, dims2=dims2, N2=N2, group_start=start,
                    group_T=Ts, box_map=tuple(box_map),
                    gen_from_box=tuple(gen_from_box),
                    gen_from_gen=tuple(gen_from_gen))


def _find_slot(dims: OCPDims, stg: int, idx: int) -> int:
    """Slot of logical index ``idx`` in stage ``stg``'s idxb list."""
    for j, v in enumerate(dims.idxb[stg]):
        if v == idx:
            return j
    raise KeyError((stg, idx))


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _stage_maps(dims: OCPDims, qp: OCPQP, pl: CondPlan, g: int):
    """Affine maps z_k = Phi_k [u2; x2] + c_k of every stage k of group g
    (Phi_k (B, NZ, NZ2), c_k (B, NZ), padded coordinates) and the
    end-of-group map (Gx (B, NX, NZ2), gc (B, NX))."""
    NU, NX, NZ = dims.NU, dims.NX, dims.NZ
    NU2, NZ2 = pl.dims2.NU, pl.dims2.NZ
    s, T = pl.group_start[g], pl.group_T[g]
    B, dt, dev = qp.b.shape[0], qp.dtype, qp.device
    off = _rev_offsets(dims, s, T)

    Gx = torch.zeros(B, NX, NZ2, dtype=dt, device=dev)
    Gx[:, :, NU2:] = torch.diag_embed(qp.x_mask[:, s])   # x_0 = x2
    gc = torch.zeros(B, NX, dtype=dt, device=dev)
    Phis, cs = [], []
    for k in range(T):
        stg = s + k
        Phi = torch.zeros(B, NZ, NZ2, dtype=dt, device=dev)
        nu_k = dims.nu[stg]
        if nu_k:
            Phi[:, :nu_k, off[k]:off[k] + nu_k] = torch.eye(
                nu_k, dtype=dt, device=dev)
        Phi[:, NU:] = Gx
        c = torch.zeros(B, NZ, dtype=dt, device=dev)
        c[:, NU:] = gc
        Phis.append(Phi)
        cs.append(c)
        Ft = qp.F[:, stg].transpose(-1, -2)              # (B, NX, NZ)
        Gx = Ft @ Phi
        gc = qp.b[:, stg] + _mv(Ft, c)
    return Phis, cs, Gx, gc


def _vector_data(dims, qp, pl, all_maps):
    """The condensed vector data (b2, g2, bounds) from the affine maps of
    every group: shared by :func:`condense` and :func:`condense_rhs`."""
    dims2 = pl.dims2
    N, NU = dims.N, dims.NU
    N2 = pl.N2
    NU2, NX2, NZ2, NB2, NG2 = (dims2.NU, dims2.NX, dims2.NZ, dims2.NB,
                               dims2.NG)
    B, dt, dev = qp.b.shape[0], qp.dtype, qp.device
    z = lambda *s: torch.zeros(B, *s, dtype=dt, device=dev)  # noqa: E731
    b2, g2 = z(N2, NX2), z(N2 + 1, NZ2)
    d_lb2, d_ub2 = z(N2 + 1, NB2), z(N2 + 1, NB2)
    d_lg2, d_ug2 = z(N2 + 1, NG2), z(N2 + 1, NG2)

    for g in range(N2):
        Phis, cs, _, gcT = all_maps[g]
        s, T = pl.group_start[g], pl.group_T[g]
        gg = z(NZ2)
        for k in range(T):
            stg = s + k
            gg = gg + _mv(Phis[k].transpose(-1, -2),
                          _mv(qp.H[:, stg], cs[k])
                          + qp.g[:, stg] * qp.z_mask[:, stg])
        g2[:, g] = gg
        b2[:, g] = gcT[:, :NX2]
    # terminal gradient (terminal inputs, nu[N] > 0, at [:nuN] both sides)
    g2[:, N2, NU2:NU2 + NX2] = qp.g[:, N, NU:NU + NX2]
    nuN = dims.nu[N]
    if nuN:
        g2[:, N2, :nuN] = qp.g[:, N, :nuN]

    for (g, slot2, stg, idx) in pl.box_map:
        idxp = idx if idx < dims.nu[stg] else NU + (idx - dims.nu[stg])
        cval = all_maps[g][1][stg - pl.group_start[g]][:, idxp]
        j = _find_slot(dims, stg, idx)
        d_lb2[:, g, slot2] = qp.d_lb[:, stg, j] - cval
        d_ub2[:, g, slot2] = qp.d_ub[:, stg, j] - cval
    for (g, row2, stg, idx) in pl.gen_from_box:
        idxp = NU + (idx - dims.nu[stg])
        cval = all_maps[g][1][stg - pl.group_start[g]][:, idxp]
        j = _find_slot(dims, stg, idx)
        d_lg2[:, g, row2] = qp.d_lb[:, stg, j] - cval
        d_ug2[:, g, row2] = qp.d_ub[:, stg, j] - cval
    for (g, row2, stg, j) in pl.gen_from_gen:
        cshift = (qp.C[:, stg, j]
                  * all_maps[g][1][stg - pl.group_start[g]]).sum(-1)
        d_lg2[:, g, row2] = qp.d_lg[:, stg, j] - cshift
        d_ug2[:, g, row2] = qp.d_ug[:, stg, j] - cshift
    nbN, ngN = dims.nb[N], dims.ng[N]
    d_lb2[:, N2, :nbN] = qp.d_lb[:, N, :nbN]
    d_ub2[:, N2, :nbN] = qp.d_ub[:, N, :nbN]
    d_lg2[:, N2, :ngN] = qp.d_lg[:, N, :ngN]
    d_ug2[:, N2, :ngN] = qp.d_ug[:, N, :ngN]
    return dict(b=b2, g=g2, d_lb=d_lb2, d_ub=d_ub2, d_lg=d_lg2, d_ug=d_ug2)


def condense(qp: OCPQP, pl: CondPlan) -> OCPQP:
    """The condensed batch of QPs (``d_part_cond``, ``d_part_cond.c:926``;
    every leaf of ``qp`` with a leading instance axis)."""
    dims, dims2 = pl.dims, pl.dims2
    N, NU = dims.N, dims.NU
    N2 = pl.N2
    NU2, NX2, NZ2, NB2, NG2 = (dims2.NU, dims2.NX, dims2.NZ, dims2.NB,
                               dims2.NG)
    B, dt, dev = qp.b.shape[0], qp.dtype, qp.device

    F2 = torch.zeros(B, N2, NZ2, NX2, dtype=dt, device=dev)
    H2 = torch.zeros(B, N2 + 1, NZ2, NZ2, dtype=dt, device=dev)
    C2 = torch.zeros(B, N2 + 1, NG2, NZ2, dtype=dt, device=dev)
    idxb2 = torch.zeros(N2 + 1, NB2, dtype=torch.int32)

    all_maps = {}
    for g in range(N2):
        Phis, cs, GxT, gcT = _stage_maps(dims, qp, pl, g)
        all_maps[g] = (Phis, cs, GxT, gcT)
        s, T = pl.group_start[g], pl.group_T[g]
        Hg = torch.zeros(B, NZ2, NZ2, dtype=dt, device=dev)
        for k in range(T):
            Hg = Hg + Phis[k].transpose(-1, -2) @ (qp.H[:, s + k] @ Phis[k])
        H2[:, g] = Hg
        F2[:, g] = GxT.transpose(-1, -2)[:, :, :NX2]

    # terminal stage cost copies through (inputs at [:nuN], states at NU)
    nuN = dims.nu[N]
    H2[:, N2, NU2:NU2 + NX2, NU2:NU2 + NX2] = qp.H[:, N, NU:NU + NX2,
                                                   NU:NU + NX2]
    if nuN:
        H2[:, N2, :nuN, :nuN] = qp.H[:, N, :nuN, :nuN]
        H2[:, N2, :nuN, NU2:NU2 + NX2] = qp.H[:, N, :nuN, NU:NU + NX2]
        H2[:, N2, NU2:NU2 + NX2, :nuN] = qp.H[:, N, NU:NU + NX2, :nuN]

    for (g, slot2, stg, idx) in pl.box_map:
        log2 = dims2.idxb[g][slot2]
        idxb2[g, slot2] = (log2 if log2 < dims2.nu[g]
                           else NU2 + (log2 - dims2.nu[g]))
    for (g, row2, stg, idx) in pl.gen_from_box:
        idxp = NU + (idx - dims.nu[stg])
        C2[:, g, row2] = all_maps[g][0][stg - pl.group_start[g]][:, idxp]
    for (g, row2, stg, j) in pl.gen_from_gen:
        Phi = all_maps[g][0][stg - pl.group_start[g]]
        C2[:, g, row2] = _mv(Phi.transpose(-1, -2), qp.C[:, stg, j])
    for j in range(dims.nb[N]):
        idx = dims.idxb[N][j]
        idxb2[N2, j] = idx if idx < nuN else NU2 + (idx - nuN)
    for j in range(dims.ng[N]):
        C2[:, N2, j, NU2:NU2 + NX2] = qp.C[:, N, j, NU:NU + NX2]
        if nuN:
            C2[:, N2, j, :nuN] = qp.C[:, N, j, :nuN]

    vec = _vector_data(dims, qp, pl, all_maps)
    tile = lambda a: torch.as_tensor(a, dtype=dt, device=dev).expand(  # noqa: E731
        (B,) + a.shape)
    return OCPQP(
        F=F2, H=H2, C=C2,
        idxb=idxb2.to(dev).expand(B, N2 + 1, NB2),
        z_mask=tile(dims2.z_mask()), x_mask=tile(dims2.x_mask()),
        nb_mask=tile(dims2.nb_mask()), ng_mask=tile(dims2.ng_mask()),
        **vec)


def condense_rhs(qp: OCPQP, pl: CondPlan, qp2_mat: OCPQP) -> OCPQP:
    """Vector-only re-condensing (the reference's rhs fast path,
    ``d_part_cond_rhs_libstr``, ``d_part_cond_libstr.c:991``): the
    condensed b, g and bounds for changed vector data, the matrix parts
    (F2, H2, C2) kept from an earlier :func:`condense` result
    ``qp2_mat``.  Matrix data (A, B, Q, S, R, C) must be unchanged."""
    all_maps = {g: _stage_maps(pl.dims, qp, pl, g) for g in range(pl.N2)}
    return dataclasses.replace(qp2_mat,
                               **_vector_data(pl.dims, qp, pl, all_maps))


def expand_solution(qp: OCPQP, pl: CondPlan,
                    sol2: ipm.IPMSolution) -> ipm.IPMSolution:
    """The full-horizon solution of a batch (``d_part_expand_solution``,
    ``d_part_cond.c:1103``): inputs copied, states rolled out through the
    dynamics, multipliers split back to their stages, interior pi by
    backward stationarity."""
    dims, dims2 = pl.dims, pl.dims2
    N, NU, NX, NZ = dims.N, dims.NU, dims.NX, dims.NZ
    N2, NU2, NX2 = pl.N2, dims2.NU, dims2.NX
    B, dt, dev = qp.b.shape[0], qp.dtype, qp.device

    z = torch.zeros(B, N + 1, NZ, dtype=dt, device=dev)
    z[:, N, NU:NU + NX2] = sol2.z[:, N2, NU2:NU2 + NX2]
    if dims.nu[N]:
        z[:, N, :dims.nu[N]] = sol2.z[:, N2, :dims.nu[N]]
    for g in range(N2):
        s, T = pl.group_start[g], pl.group_T[g]
        off = _rev_offsets(dims, s, T)
        for k in range(T):
            nu_k = dims.nu[s + k]
            if nu_k:
                z[:, s + k, :nu_k] = sol2.z[:, g, off[k]:off[k] + nu_k]
        z[:, s, NU:NU + NX2] = sol2.z[:, g, NU2:NU2 + NX2]
        for k in range(T - 1):
            stg = s + k
            x_next = qp.b[:, stg] + _mv(qp.F[:, stg].transpose(-1, -2),
                                        z[:, stg] * qp.z_mask[:, stg])
            z[:, stg + 1, NU:] = x_next * qp.x_mask[:, stg + 1]

    lam_b = torch.zeros(B, N + 1, 2, dims.NB, dtype=dt, device=dev)
    t_b = torch.ones_like(lam_b)
    lam_g = torch.zeros(B, N + 1, 2, dims.NG, dtype=dt, device=dev)
    t_g = torch.ones_like(lam_g)
    for (g, slot2, stg, idx) in pl.box_map:
        j = _find_slot(dims, stg, idx)
        lam_b[:, stg, :, j] = sol2.lam_b[:, g, :, slot2]
        t_b[:, stg, :, j] = sol2.t_b[:, g, :, slot2]
    for (g, row2, stg, idx) in pl.gen_from_box:
        j = _find_slot(dims, stg, idx)
        lam_b[:, stg, :, j] = sol2.lam_g[:, g, :, row2]
        t_b[:, stg, :, j] = sol2.t_g[:, g, :, row2]
    for (g, row2, stg, j) in pl.gen_from_gen:
        lam_g[:, stg, :, j] = sol2.lam_g[:, g, :, row2]
        t_g[:, stg, :, j] = sol2.t_g[:, g, :, row2]
    nbN, ngN = dims.nb[N], dims.ng[N]
    lam_b[:, N, :, :nbN] = sol2.lam_b[:, N2, :, :nbN]
    t_b[:, N, :, :nbN] = sol2.t_b[:, N2, :, :nbN]
    lam_g[:, N, :, :ngN] = sol2.lam_g[:, N2, :, :ngN]
    t_g[:, N, :, :ngN] = sol2.t_g[:, N2, :, :ngN]

    # group-boundary pis copy; interior ones by backward stationarity
    pi = torch.zeros(B, N, NX, dtype=dt, device=dev)
    oh = ipm._box_onehot(qp)
    for g in range(N2):
        s, T = pl.group_start[g], pl.group_T[g]
        pi[:, s + T - 1] = sol2.pi[:, g] * qp.x_mask[:, s + T, :NX]
        for k in range(T - 1, 0, -1):
            stg = s + k
            zs = z[:, stg] * qp.z_mask[:, stg]
            w = qp.g[:, stg] * qp.z_mask[:, stg] + _mv(qp.H[:, stg], zs)
            net_b = (lam_b[:, stg, 1] - lam_b[:, stg, 0]) * qp.nb_mask[:, stg]
            w = w + _mv(oh[:, stg].transpose(-1, -2), net_b)
            net_g = (lam_g[:, stg, 1] - lam_g[:, stg, 0]) * qp.ng_mask[:, stg]
            w = w + _mv(qp.C[:, stg].transpose(-1, -2), net_g)
            w = w + _mv(qp.F[:, stg], pi[:, stg])
            pi[:, stg - 1] = w[:, NU:] * qp.x_mask[:, stg]

    return ipm.IPMSolution(z=z, pi=pi, lam_b=lam_b, t_b=t_b, lam_g=lam_g,
                           t_g=t_g, kk=sol2.kk, status=sol2.status,
                           stat=sol2.stat, inf_norm_res=sol2.inf_norm_res)


def solve_partial_cond(dims: OCPDims, qp: OCPQP, cfg: ipm.IPMConfig,
                       N2: int):
    """Condense -> structured IPM (:func:`.ipm.solve`) -> expand, on a
    batch (the reference's ``N2 < N`` path of
    ``fortran_order_d_ip_ocp_hard_tv``, ``fortran_order_interface.c:
    434-528``).  Returns ``(expanded_solution, condensed_solution)``."""
    pl = plan(dims, N2)
    qp2 = condense(qp, pl)
    sol2 = ipm.solve(pl.dims2, qp2, cfg)
    return expand_solution(qp, pl, sol2), sol2


def solve_batched_partial_cond(dims: OCPDims, qp: OCPQP,
                               cfg: ipm.IPMConfig, N2: int):
    """:func:`solve_partial_cond` with the condensed batch dispatched by
    :func:`..parallel.batch.solve_batched` (any engine its rule picks for
    the condensed dims).  Returns ``(expanded_solution,
    condensed_solution)``."""
    from ..parallel import batch as pbatch

    pl = plan(dims, N2)
    qp2 = condense(qp, pl)
    sol2 = pbatch.solve_batched(pl.dims2, qp2, cfg)
    return expand_solution(qp, pl, sol2), sol2
