"""Scenario-tree Riccati kernels: CUDA kernels + plain versions.

Port of the three wrappers of ``hpmpc_tpu/ops/tree_kernel.py`` (Queue 2
rows 26-28), the tree twins of :mod:`.stage_kernel`'s flat family:

  * :func:`tree_factor_solve_flat` (TPU: ``_tree_bwd_kernel`` then
    ``_tree_fwd_kernel``, two calls; here one launch) -- the folded
    backward Riccati factorization over nodes n-1..0, each child adding
    ``W W'`` (``W = F Lxx``) and ``F (P b + p)`` into its parent's
    accumulator through ``dad``, then the forward recovery over nodes
    0..n-1 from each parent's z;
  * :func:`tree_solve_flat` (``_tree_trs_kernel`` + the forward kernel) --
    the retained-factor re-solve with the cached Pb;
  * :func:`tree_resid_terms_flat` (``_tree_resid_kernel``) -- per node
    ``H z``, per edge ``F' z_dad`` and ``F pi`` (edge-major; the caller
    scatters ``F pi`` onto the parents' rows).

Topology: ``dad`` is the tree's parent tuple (``TreeDef.dad``, dad[0] =
-1); nodes are breadth-first, so reverse id order is a valid
children-before-parents order.  Rows 26-27 run a depth level's nodes at
once: they read the tree as its level schedule (:func:`level_schedule`,
one small int32 table on the device, :func:`schedule_table`, made once
per process), row 28 as the parent table.  Layout: batch-last node
streams (n, k, B) and edge streams (n-1, k, B), edge e the edge into node
e+1 -- the chain's (N+1, k, B) with N = n-1.  The factor state ``(Ll (n,
NZ, NU, B), Lxx (n, NX, NX, B), Pb (n-1, NX, B))`` is the chain's.  General
constraints sit on the nodes ``ng_node_ids`` (slot j on node
``ng_node_ids[j]``): ``ngl`` (n_ng, NT, B), the packed C' diag(Qx_g) C
term, None without such nodes.

CPU tensors run the plain version (``<name>_ref``); CUDA tensors launch
the kernel (``csrc/tree_sweeps.cu``, ``csrc/tree_resid_terms.cu``) or
raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from . import stage_math as sm
from .layout import from_lanes, sym_expand, sym_nt, to_lanes

#: launches of each CUDA kernel in this process
LAUNCHES = {"tree_factor_solve_flat": 0, "tree_solve_flat": 0,
            "tree_resid_terms_flat": 0}
#: calls of each wrapper that ran the plain version (CPU tensors)
PLAIN_CALLS = dict.fromkeys(LAUNCHES, 0)


class _TreeFactorArgs(ctypes.Structure):
    # mirrors struct TreeFactorArgs in csrc/tree_sweeps.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "sched", "H", "dvec", "ngl", "ng_node", "g", "F", "b", "Ll", "Lxx",
        "Pb", "z", "pi", "work")] + [(n, ctypes.c_int64) for n in (
            "B", "n", "n_levels", "wmax", "n_ng", "want_pi")]


class _TreeSolveArgs(ctypes.Structure):
    # mirrors struct TreeSolveArgs in csrc/tree_sweeps.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "sched", "Ll", "Lxx", "Pb", "g", "F", "b", "z", "pi", "work")] + [
        (n, ctypes.c_int64) for n in ("B", "n", "n_levels", "wmax")]


class _TreeResidArgs(ctypes.Structure):
    # mirrors struct TreeResidArgs in csrc/tree_resid_terms.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "dad", "H", "F", "z", "pi", "hz", "fz", "fpi")] + [
        ("B", ctypes.c_int64), ("n", ctypes.c_int64)]


# ---------------------------------------------------------------------------
# plain versions (batch-first inside, node by node in the kernels' order)
# ---------------------------------------------------------------------------


def _forward(dad, Ll, Lxx, eu, px, F, b, want_pi):
    """Forward recovery, nodes 0..n-1 (``_tree_fwd_kernel``): the root's
    free initial state, then x_k = b_e + F_e' z_dad(k) on the edge e = k-1
    into node k, pi_e = Lxx_k (Lxx_k' x_k) + px_k (with ``want_pi``), u_k
    and z_k."""
    B, n, NZ, NU = Ll.shape
    z = Ll.new_zeros(B, n, NZ)
    pi = Ll.new_zeros(B, n - 1, Lxx.shape[2]) if want_pi else None
    for k in range(n):
        if k == 0:
            x = sm.root_x0(Lxx[:, 0], px[:, 0])
        else:
            x = sm.x_next_of(F[:, k - 1], b[:, k - 1], z[:, dad[k]])
            if want_pi:
                pi[:, k - 1] = sm.pi_of_x(Lxx[:, k], px[:, k], x)
        u = sm.u_of_x(NU, Ll[:, k], sm.dinv_ll(Ll[:, k], NU), eu[:, k], x)
        z[:, k] = torch.cat([u, x], dim=1)
    return z, pi


def _ng_hessian(H, dvec, ngl, ng_node_ids, NZ):
    """The effective node Hessians, batch-first (B, n, NZ, NZ): packed H +
    diag(dvec) + the packed ng term on its nodes."""
    Hf = sym_expand(from_lanes(H), NZ) + torch.diag_embed(from_lanes(dvec))
    if ng_node_ids:
        ngf = sym_expand(from_lanes(ngl), NZ)
        for j, k in enumerate(ng_node_ids):
            Hf[:, k] += ngf[:, j]
    return Hf


def tree_factor_solve_flat_ref(dad, H, dvec, ngl, ng_node_ids, g, F, b, *,
                               NU, NZ, NX, want_pi):
    """Plain PyTorch version of :func:`tree_factor_solve_flat` (same
    arguments, same outputs).  Node by node, n-1..0:

      M_k = H_k + diag(dvec_k) [+ ngl_j] + sum_children W_c W_c'
      m_k = g_k + sum_children F_c (Pb_c + px_c)
      L_k = chol(M_k), eu_k = Luu^{-1} m_u, px_k = m_x - Lxu eu_k
      (k > 0) W = F_e Lxx_k, Pb_e = Lxx_k (Lxx_k' b_e), e = k-1, into
      node dad[k]'s accumulator

    then the forward recovery."""
    Hf = _ng_hessian(H, dvec, ngl, ng_node_ids, NZ)
    gb, Fb, bb = from_lanes(g), from_lanes(F), from_lanes(b)
    B, n = gb.shape[:2]
    accM = Hf.new_zeros(B, n, NZ, NZ)
    accm = gb.new_zeros(B, n, NZ)
    Ll = Hf.new_zeros(B, n, NZ, NU)
    Lxx = Hf.new_zeros(B, n, NX, NX)
    eus, pxs = gb.new_zeros(B, n, NU), gb.new_zeros(B, n, NX)
    Pb = gb.new_zeros(B, n - 1, NX)
    for k in range(n - 1, -1, -1):
        Lf, Dinv = sm.chol(Hf[:, k] + accM[:, k])
        m = gb[:, k] + accm[:, k]
        eu = sm.tril_solve(Lf[:, :NU, :NU], Dinv[:, :NU], m[:, :NU])
        px = m[:, NU:] - sm._mv(Lf[:, NU:, :NU], eu)
        Ll[:, k], Lxx[:, k] = Lf[:, :, :NU], Lf[:, NU:, NU:]
        eus[:, k], pxs[:, k] = eu, px
        if k:
            Fe = Fb[:, k - 1]
            W = Fe @ Lf[:, NU:, NU:]
            Pb[:, k - 1] = sm.pb_of(Lf[:, NU:, NU:], bb[:, k - 1])
            accM[:, dad[k]] += W @ W.transpose(-1, -2)
            accm[:, dad[k]] += sm._mv(Fe, Pb[:, k - 1] + px)
    z, pi = _forward(dad, Ll, Lxx, eus, pxs, Fb, bb, want_pi)
    return (to_lanes(z), to_lanes(pi) if want_pi else None,
            (to_lanes(Ll), to_lanes(Lxx), to_lanes(Pb)))


def tree_solve_flat_ref(dad, Ll, Lxx, Pb, g, F, b, *, NU, NZ, NX):
    """Plain PyTorch version of :func:`tree_solve_flat` (same arguments,
    same outputs): nodes n-1..0, m_k = g_k + sum_children F_c (Pb_c +
    px_c), eu_k = Luu^{-1} m_u (pivots 1/max(L_ii, 1e-30)), px_k = m_x - Lxu
    eu_k; then the forward recovery with pi."""
    Llb, Lxxb, Pbb, gb, Fb, bb = (from_lanes(x)
                                  for x in (Ll, Lxx, Pb, g, F, b))
    B, n = gb.shape[:2]
    accm = gb.new_zeros(B, n, NZ)
    eus, pxs = gb.new_zeros(B, n, NU), gb.new_zeros(B, n, NX)
    for k in range(n - 1, -1, -1):
        m = gb[:, k] + accm[:, k]
        eu = sm.tril_solve(Llb[:, k, :NU], sm.dinv_ll(Llb[:, k], NU),
                           m[:, :NU])
        px = m[:, NU:] - sm._mv(Llb[:, k, NU:], eu)
        eus[:, k], pxs[:, k] = eu, px
        if k:
            accm[:, dad[k]] += sm._mv(Fb[:, k - 1], Pbb[:, k - 1] + px)
    z, pi = _forward(dad, Llb, Lxxb, eus, pxs, Fb, bb, True)
    return to_lanes(z), to_lanes(pi)


def tree_resid_terms_flat_ref(dad, H, F, z, pi, *, NZ, NX):
    """Plain PyTorch version of :func:`tree_resid_terms_flat` (same
    arguments, same outputs)."""
    Hf = sym_expand(from_lanes(H), NZ)
    Fb, zb, pib = from_lanes(F), from_lanes(z), from_lanes(pi)
    zd = zb[:, [max(d, 0) for d in dad[1:]]]
    hz = (Hf @ zb[..., None])[..., 0]
    fz = (Fb.transpose(-1, -2) @ zd[..., None])[..., 0]
    fpi = (Fb @ pib[..., None])[..., 0]
    return to_lanes(hz), to_lanes(fz), to_lanes(fpi)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _check(name, x, dad, ng_node_ids, named, shapes):
    """Device / topology / ng / dtype / shape / contiguity checks."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    n = len(dad)
    if not _breadth_first(tuple(dad)):
        raise ValueError(f"{name}: dad must be breadth-first (dad[0] = -1, "
                         "0 <= dad[k] < k)")
    if any(not 0 <= k < n for k in ng_node_ids):
        raise ValueError(f"{name}: ng node ids out of range")
    if "ngl" in named and (named["ngl"] is None) != (not ng_node_ids):
        raise ValueError(f"{name}: ngl must be given iff there are ng nodes")
    _build.check_tensors(x.device, x.dtype,
                         {k: v for k, v in named.items() if v is not None},
                         shapes)


@functools.lru_cache(maxsize=None)
def _breadth_first(dad) -> bool:
    return len(dad) >= 2 and dad[0] == -1 and all(
        0 <= dad[k] < k for k in range(1, len(dad)))


def _dad_table(dad, dev):
    """The int32 device table of the parents, dad[0] clamped to 0."""
    return _build.int_table(tuple(max(d, 0) for d in dad), dev)


class LevelSchedule(NamedTuple):
    """The order in which rows 26-27 visit a tree's nodes."""
    levels: tuple    # node ids of each depth, root level first, ascending
    pos: tuple       # each node's place in its level
    children: tuple  # each node's children, descending id


@functools.lru_cache(maxsize=None)
def level_schedule(dad) -> LevelSchedule:
    """The level schedule of the parent tuple ``dad`` (dad[0] = -1, dad[k]
    < k): the nodes of one depth are independent in both sweeps (a node
    needs its children's terms backward, its parent's z forward), and a
    parent sums its children's terms in descending id, the order of the
    one-thread sweep that visited nodes n-1..0."""
    depth = [0] * len(dad)
    for k in range(1, len(dad)):
        depth[k] = depth[dad[k]] + 1
    levels = [[] for _ in range(max(depth) + 1)]
    pos = []
    for k, d in enumerate(depth):
        pos.append(len(levels[d]))
        levels[d].append(k)
    children = [[] for _ in dad]
    for k in range(len(dad) - 1, 0, -1):
        children[dad[k]].append(k)
    return LevelSchedule(tuple(map(tuple, levels)), tuple(pos),
                         tuple(map(tuple, children)))


@functools.lru_cache(maxsize=None)
def schedule_table(dad) -> tuple:
    """The int32 schedule table rows 26-27 read (``Sched`` in
    ``csrc/tree_sweeps.cu``): the level offsets (L + 1) into the node ids
    by level (n, root level first), each node's place in its level (n),
    its parent (n, dad[0] = 0), the offsets (n + 1) into the children
    lists (n - 1 ids, each list in descending id)."""
    s = level_schedule(dad)
    lev_off, ch_off = [0], [0]
    for lev in s.levels:
        lev_off.append(lev_off[-1] + len(lev))
    for ch in s.children:
        ch_off.append(ch_off[-1] + len(ch))
    return (*lev_off, *(k for lev in s.levels for k in lev), *s.pos,
            *(max(d, 0) for d in dad), *ch_off,
            *(c for ch in s.children for c in ch))


@functools.lru_cache(maxsize=None)
def _sched(dad, dev):
    """(the schedule table on ``dev``, the level count, the widest level's
    node count) of ``dad``."""
    s = level_schedule(dad)
    return (_build.int_table(schedule_table(dad), dev), len(s.levels),
            max(map(len, s.levels)))


LAYOUT_KEYS = ("team", "teams", "instances", "threads", "on_chip",
               "work_block")


@functools.lru_cache(maxsize=None)
def _layout(n, wmax, solve, dt, NU, NX) -> tuple:
    fn = _build.load("tree_sweeps", NU=NU, NX=NX).hp_tree_sweeps_layout
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_int64 * len(LAYOUT_KEYS))()
    fn(n, wmax, int(solve), _build.dtype_code(dt), ctypes.addressof(out))
    return tuple(out)


def layout(n, wmax, solve, dt, *, NU, NX) -> dict:
    """The launch layout of row 26 (``solve`` False) or row 27 on a tree of
    ``n`` nodes whose widest level holds ``wmax``, in dtype ``dt``: lanes a
    team, teams (warps) an instance, instances and threads a block, whether
    the kept rows (eu, px, the children's terms) sit in shared memory, and
    a block's device memory for them otherwise, in scalars (the source's
    size rule, ``hp_tree_sweeps_layout``; the library is built on first
    use)."""
    return dict(zip(LAYOUT_KEYS, _layout(n, wmax, bool(solve), dt, NU, NX)))


def _work(n, wmax, solve, x, B, NU, NX):
    """Device memory for the kept rows past the size rule (one slab a block
    of instances), None where they fit in shared memory."""
    lay = layout(n, wmax, solve, x.dtype, NU=NU, NX=NX)
    if lay["on_chip"]:
        return None
    blocks = -(-B // lay["instances"])
    return torch.empty(blocks * lay["work_block"], dtype=x.dtype,
                       device=x.device)


def tree_factor_solve_flat(dad, H, dvec, ngl, ng_node_ids, g, F, b, *, NU,
                           NZ, NX, want_pi):
    """Folded tree Riccati factorization + forward recovery in one launch
    (Queue 2 row 26).

    Inputs: ``dad`` (the parent tuple), packed ``H`` (n, NT, B), the
    barrier diagonal ``dvec`` and the effective gradient ``g`` (n, NZ, B),
    ``ngl`` (n_ng, NT, B) or None, ``F`` (n-1, NZ, NX, B), ``b`` (n-1, NX,
    B).  Returns ``(z, pi, (Ll, Lxx, Pb))``: z (n, NZ, B), pi (n-1, NX, B)
    or None without ``want_pi``, and the factor state.

    CPU tensors run :func:`tree_factor_solve_flat_ref`; CUDA tensors launch
    ``csrc/tree_sweeps.cu`` on the current stream (no sync)."""
    name = "tree_factor_solve_flat"
    ng_node_ids = tuple(ng_node_ids)
    kw = dict(NU=NU, NZ=NZ, NX=NX, want_pi=bool(want_pi))
    if H.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return tree_factor_solve_flat_ref(dad, H, dvec, ngl, ng_node_ids, g,
                                          F, b, **kw)
    n, B = H.shape[0], H.shape[-1]
    n_ng, NT = len(ng_node_ids), sym_nt(NZ)
    named = dict(H=H, dvec=dvec, ngl=ngl, g=g, F=F, b=b)
    shapes = dict(H=(n, NT, B), dvec=(n, NZ, B), ngl=(n_ng, NT, B),
                  g=(n, NZ, B), F=(n - 1, NZ, NX, B), b=(n - 1, NX, B))
    _check(name, H, dad, ng_node_ids, named, shapes)
    new = lambda *s: torch.empty(*s, dtype=H.dtype, device=H.device)  # noqa: E731
    Ll, Lxx, Pb = new(n, NZ, NU, B), new(n, NX, NX, B), new(n - 1, NX, B)
    z = new(n, NZ, B)
    pi = new(n - 1, NX, B) if want_pi else None
    sched, L, wmax = _sched(tuple(dad), H.device)
    work = _work(n, wmax, False, H, B, NU, NX)
    ptrs = (sched, H, dvec, ngl, _build.int_table(ng_node_ids, H.device), g,
            F, b, Ll, Lxx, Pb, z, pi, work)
    a = _TreeFactorArgs(*[_build.ptr(x) for x in ptrs], B, n, L, wmax, n_ng,
                        int(bool(want_pi)))
    _build.launch("tree_sweeps", name, a, H.device, H.dtype, NU=NU, NX=NX)
    LAUNCHES[name] += 1
    return z, pi, (Ll, Lxx, Pb)


def tree_solve_flat(dad, Ll, Lxx, Pb, g, F, b, *, NU, NZ, NX):
    """Retained-factor tree re-solve with the cached Pb + forward recovery
    with pi, one launch (Queue 2 row 27): the solve of the gradient ``g``
    (n, NZ, B) against the factor state ``(Ll, Lxx, Pb)`` of
    :func:`tree_factor_solve_flat`.  Returns ``(z, pi)``.

    CPU tensors run :func:`tree_solve_flat_ref`; CUDA tensors launch
    ``csrc/tree_sweeps.cu`` (no sync)."""
    name = "tree_solve_flat"
    if g.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return tree_solve_flat_ref(dad, Ll, Lxx, Pb, g, F, b, NU=NU, NZ=NZ,
                                   NX=NX)
    n, B = g.shape[0], g.shape[-1]
    named = dict(Ll=Ll, Lxx=Lxx, Pb=Pb, g=g, F=F, b=b)
    shapes = dict(Ll=(n, NZ, NU, B), Lxx=(n, NX, NX, B), Pb=(n - 1, NX, B),
                  g=(n, NZ, B), F=(n - 1, NZ, NX, B), b=(n - 1, NX, B))
    _check(name, g, dad, (), named, shapes)
    new = lambda *s: torch.empty(*s, dtype=g.dtype, device=g.device)  # noqa: E731
    z, pi = new(n, NZ, B), new(n - 1, NX, B)
    sched, L, wmax = _sched(tuple(dad), g.device)
    work = _work(n, wmax, True, g, B, NU, NX)
    ptrs = (sched, Ll, Lxx, Pb, g, F, b, z, pi, work)
    a = _TreeSolveArgs(*[_build.ptr(x) for x in ptrs], B, n, L, wmax)
    _build.launch("tree_sweeps", name, a, g.device, g.dtype, NU=NU, NX=NX)
    LAUNCHES[name] += 1
    return z, pi


def tree_resid_terms_flat(dad, H, F, z, pi, *, NZ, NX):
    """The node and edge products of the tree's Newton residuals, one
    launch (Queue 2 row 28): ``(hz, fz, fpi)`` with hz_k = H_k z_k (n, NZ,
    B), fz_e = F_e' z_dad(e+1) (n-1, NX, B) and fpi_e = F_e pi_e (n-1, NZ,
    B), edge-major (the caller adds fpi_e onto the rows of node dad(e+1)).
    Inputs: packed ``H`` (n, NT, B), ``F`` (n-1, NZ, NX, B), ``z`` (n, NZ,
    B), ``pi`` (n-1, NX, B).

    CPU tensors run :func:`tree_resid_terms_flat_ref`; CUDA tensors launch
    ``csrc/tree_resid_terms.cu`` (no sync)."""
    name = "tree_resid_terms_flat"
    if z.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return tree_resid_terms_flat_ref(dad, H, F, z, pi, NZ=NZ, NX=NX)
    n, B = z.shape[0], z.shape[-1]
    named = dict(H=H, F=F, z=z, pi=pi)
    shapes = dict(H=(n, sym_nt(NZ), B), F=(n - 1, NZ, NX, B), z=(n, NZ, B),
                  pi=(n - 1, NX, B))
    _check(name, z, dad, (), named, shapes)
    new = lambda *s: torch.empty(*s, dtype=z.dtype, device=z.device)  # noqa: E731
    hz, fz, fpi = new(n, NZ, B), new(n - 1, NX, B), new(n - 1, NZ, B)
    ptrs = (_dad_table(dad, z.device), H, F, z, pi, hz, fz, fpi)
    a = _TreeResidArgs(*[_build.ptr(x) for x in ptrs], B, n)
    _build.launch("tree_resid_terms", name, a, z.device, z.dtype,
                  NU=NZ - NX, NX=NX)
    LAUNCHES[name] += 1
    return hz, fz, fpi
