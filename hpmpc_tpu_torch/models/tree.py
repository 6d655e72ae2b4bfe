"""Scenario-tree robust MPC: the tree Riccati recursion and the tree IPM
(PyTorch twin of :mod:`hpmpc_tpu.models.tree`), batch-native.

The reference's tree solvers (``lqcp_solvers/d_tree_back_ric_rec_libstr.c``,
``mpc_solvers/d_tree_ip2_res_hard_libstr.c:80``, node structure
``include/tree.h:34-44``) walk the nodes one by one, children before
parents.  Here every DEPTH LEVEL is one batched step, as in the JAX
package: the factorizations and solves of a level's nodes are one batched
Cholesky and a few batched products, over the leading instance axis too.

Representation: nodes 0..n_nodes-1 in breadth-first order (root 0, every
parent's id below its children's); the node arrays reuse the
:class:`~..ocp.OCPQP` container with axis 1 (after the instance axis B) the
nodes (``H``, ``g`` and the constraints per node), and the EDGE data
``F[e]``, ``b[e]`` on the edge ``dad(e+1) -> e+1``, so the shapes are the
chain's: n_nodes = dims.N + 1 node rows, dims.N edge rows.

Backward sweep per node (``d_tree_back_ric_rec_libstr.c:79-264``):

    M_n = H_n + sum_{children c} W_c W_c',   W_c = F_c Lxx_c
    m_n = g_n + sum_{children c} F_c (P_c b_c + p_c)
    L_n = chol(M_n)

then the forward sweep root -> leaves, one multiplier per edge.  The
JAX package's ``.at[dad[lev]].add`` scatter is ``index_add_``: siblings
share a parent, and their terms accumulate.

:func:`solve_tree_ipm` injects the tree :class:`~.ipm.KKTBackend` into the
shared two-phase Mehrotra loop :func:`~.ipm.solve`.
:func:`solve_tree_ipm_flat` runs the lanes engine's flat form with the
tree's hand-written kernels (:mod:`..ops.tree_kernel`, Queue 2 rows 26-28)
through its ``kkt_factory`` hook.  ``solve_tree_ipm_sharded`` (the node
axis across devices) is not ported yet: ROADMAP Queue 1 #19.
"""

from __future__ import annotations

import dataclasses
import types
from typing import NamedTuple

import torch

from ..ocp import OCPDims, OCPQP
from ..ops.tri import cholesky, solve_tril, solve_triu
from . import ipm
from .riccati import _mtv, _mv


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """Static tree topology (hashable).

    dad[k] = parent of node k (dad[0] = -1); nodes are breadth-first so
    every parent index is smaller than its children's."""

    dad: tuple

    @property
    def n_nodes(self) -> int:
        return len(self.dad)

    @property
    def depth(self) -> tuple:
        d = [0] * self.n_nodes
        for k in range(1, self.n_nodes):
            d[k] = d[self.dad[k]] + 1
        return tuple(d)

    @property
    def levels(self) -> tuple:
        """tuple of tuples: node ids per depth, shallow -> deep."""
        dep = self.depth
        lev = [[] for _ in range(max(dep) + 1)]
        for k, d in enumerate(dep):
            lev[d].append(k)
        return tuple(tuple(l) for l in lev)

    @staticmethod
    def from_md_nr_nh(md: int, Nr: int, Nh: int) -> "TreeDef":
        """The reference's ``setup_tree(md, Nr, Nh)``
        (``test_problems/test_d_tree_ric_libstr.c:61-93``): md-way branching
        for the first Nr stages, then single chains out to depth Nh.
        Node count: (Nh-Nr) md^Nr + (md^{Nr+1}-1)/(md-1) for md>1."""
        dad = [-1]
        frontier = [0]
        for d in range(Nh):
            new_frontier = []
            for p in frontier:
                for _ in range(md if d < Nr else 1):
                    dad.append(p)
                    new_frontier.append(len(dad) - 1)
            frontier = new_frontier
        return TreeDef(dad=tuple(dad))


class TreeFactor(NamedTuple):
    L: torch.Tensor   # (B, n_nodes, NZ, NZ)
    eu: torch.Tensor  # (B, n_nodes, NU) pre-solved u gradients
    px: torch.Tensor  # (B, n_nodes, NX) value-function gradients
    Pb: torch.Tensor  # (B, n_edges, NX) cached P_c b_c per edge


def _level_arrays(tdef: TreeDef, device):
    """(levels, dad of each level): per level (a node-id tuple, its index
    tensor, the index tensor of its nodes' parents), deep -> shallow, on
    ``device``, made once per process."""
    out = []
    for lev in reversed(tdef.levels):
        dads = tuple(max(tdef.dad[k], 0) for k in lev)
        out.append((lev, ipm._stage_index(lev, device),
                    ipm._stage_index(dads, device)))
    return out


def tree_factor_solve(tdef: TreeDef, qp: OCPQP, H_eff, g_eff, rhs_b, NU):
    """Factorize + solve the tree KKT system (reference sv,
    ``d_tree_back_ric_rec_libstr.c:42``), level-batched.

    ``H_eff`` (B, n, NZ, NZ), ``g_eff`` (B, n, NZ), ``rhs_b`` (B, n-1, NX).
    Returns (z, pi, factor) with z (B, n, NZ), pi (B, n-1, NX) -- the
    multiplier of the edge into node e+1 at pi[:, e] (chain layout)."""
    B, n, NZ = g_eff.shape
    NX = qp.F.shape[-1]
    dt, dev = H_eff.dtype, H_eff.device
    zeros = lambda *s: torch.zeros(*s, dtype=dt, device=dev)  # noqa: E731
    S, mg = zeros(B, n, NZ, NZ), zeros(B, n, NZ)   # children's terms
    L, eu, px = zeros(B, n, NZ, NZ), zeros(B, n, NU), zeros(B, n, NZ - NU)
    Pb = zeros(B, n - 1, NX)

    for lev, li, di in _level_arrays(tdef, dev):   # deepest level first
        L_l = cholesky(H_eff[:, li] + S[:, li])
        m = g_eff[:, li] + mg[:, li]
        eu_l = solve_tril(L_l[..., :NU, :NU], m[..., :NU])
        px_l = m[..., NU:] - _mv(L_l[..., NU:, :NU], eu_l)
        L[:, li], eu[:, li], px[:, li] = L_l, eu_l, px_l
        if lev[0] == 0:
            break                                   # the root has no edge
        ei = li - 1
        Lxx = L_l[..., NU:, NU:]
        F_l = qp.F[:, ei]
        W = F_l @ Lxx                               # F_c Lxx_c
        Pb_l = _mv(Lxx, _mtv(Lxx, rhs_b[:, ei]))
        Pb[:, ei] = Pb_l
        S.index_add_(1, di, W @ W.transpose(-1, -2))
        mg.index_add_(1, di, _mv(F_l, Pb_l + px_l))

    return _tree_forward(tdef, qp, (L, eu, px, Pb), rhs_b, NU)


def tree_resolve(tdef: TreeDef, qp: OCPQP, factor: TreeFactor, g_eff, rhs_b,
                 NU):
    """Solve with a retained factor for a new gradient (reference trs,
    ``d_tree_back_ric_rec_libstr.c:309``; the cached Pb reused)."""
    B, n, NZ = g_eff.shape
    dt, dev = g_eff.dtype, g_eff.device
    L = factor.L
    mg = torch.zeros(B, n, NZ, dtype=dt, device=dev)
    eu = torch.zeros(B, n, NU, dtype=dt, device=dev)
    px = torch.zeros(B, n, NZ - NU, dtype=dt, device=dev)
    for lev, li, di in _level_arrays(tdef, dev):
        m = g_eff[:, li] + mg[:, li]
        L_l = L[:, li]
        eu_l = solve_tril(L_l[..., :NU, :NU], m[..., :NU])
        px_l = m[..., NU:] - _mv(L_l[..., NU:, :NU], eu_l)
        eu[:, li], px[:, li] = eu_l, px_l
        if lev[0] == 0:
            break
        ei = li - 1
        mg.index_add_(1, di, _mv(qp.F[:, ei], factor.Pb[:, ei] + px_l))
    z, pi, _ = _tree_forward(tdef, qp, (L, eu, px, factor.Pb), rhs_b, NU)
    return z, pi


def _tree_forward(tdef: TreeDef, qp: OCPQP, fac, rhs_b, NU):
    L, eu, px, Pb = fac
    B, n, NZ = L.shape[:3]
    NX = qp.F.shape[-1]
    dev = L.device
    z = L.new_zeros(B, n, NZ)
    pi = L.new_zeros(B, n - 1, NX)

    # root: the free (eliminated) initial state, then u
    Lxx0 = L[:, 0, NU:, NU:]
    x0 = -solve_triu(Lxx0.transpose(-1, -2), solve_tril(Lxx0, px[:, 0]))
    u0 = -solve_triu(L[:, 0, :NU, :NU].transpose(-1, -2),
                     eu[:, 0] + _mtv(L[:, 0, NU:, :NU], x0))
    z[:, 0, :NU], z[:, 0, NU:] = u0, x0

    for lev, li, di in reversed(_level_arrays(tdef, dev)[:-1]):
        ei = li - 1
        x_l = rhs_b[:, ei] + _mtv(qp.F[:, ei], z[:, di])
        L_l = L[:, li]
        Lxx = L_l[..., NU:, NU:]
        pi[:, ei] = _mv(Lxx, _mtv(Lxx, x_l)) + px[:, li]
        u_l = -solve_triu(L_l[..., :NU, :NU].transpose(-1, -2),
                          eu[:, li] + _mtv(L_l[..., NU:, :NU], x_l))
        z[:, li, :NU], z[:, li, NU:] = u_l, x_l
    return z, pi, TreeFactor(L=L, eu=eu, px=px, Pb=Pb)


def tree_residuals(tdef: TreeDef, qp: OCPQP, oh, mu_scal, z, pi, lam_b, t_b,
                   lam_g, t_g, rhs_b) -> ipm.Residuals:
    """Tree-topology KKT residuals (reference
    ``d_tree_res_ip_res_hard_libstr.c:66``): the chain's, but the
    stationarity couples each node to its children's edge multipliers and
    its own incoming edge; rb lives on the edges (indexed by child node)."""
    NU = qp.H.shape[-1] - qp.x_mask.shape[-1]
    di = ipm._stage_index(tuple(tdef.dad[1:]), z.device)
    mb, mg_ = qp.nb_mask, qp.ng_mask

    rq = qp.g * qp.z_mask + torch.einsum("bnzw,bnw->bnz", qp.H, z)
    rq[:, 1:, NU:] -= pi                      # own incoming edge
    rq.index_add_(1, di, torch.einsum("bkzx,bkx->bkz", qp.F, pi))
    rq = rq + ipm._scatter_box(oh, (lam_b[:, :, 1] - lam_b[:, :, 0]) * mb)
    rq = rq + torch.einsum("bngz,bng->bnz", qp.C,
                           (lam_g[:, :, 1] - lam_g[:, :, 0]) * mg_)
    rq = rq * qp.z_mask

    rb = (rhs_b + torch.einsum("bkzx,bkz->bkx", qp.F, z[:, di])
          - z[:, 1:, NU:]) * qp.x_mask[:, 1:]

    zb = ipm._gather_box(oh, z)
    rd_b = torch.stack([qp.d_lb - zb + t_b[:, :, 0],
                        qp.d_ub - zb - t_b[:, :, 1]], 2) * mb[:, :, None, :]
    cz = ipm._cz(qp, z)
    rd_g = torch.stack([qp.d_lg + t_g[:, :, 0] - cz,
                        qp.d_ug - t_g[:, :, 1] - cz], 2) * mg_[:, :, None, :]
    rm_b = lam_b * t_b * mb[:, :, None, :]
    rm_g = lam_g * t_g * mg_[:, :, None, :]
    mu = (rm_b.flatten(1).sum(1) + rm_g.flatten(1).sum(1)) * mu_scal
    return ipm.Residuals(rq=rq, rb=rb, rd_b=rd_b, rd_g=rd_g, rm_b=rm_b,
                         rm_g=rm_g, mu=mu)


def tree_backend(tdef: TreeDef, dims: OCPDims, qp: OCPQP,
                 reg_eps: float = 0.0) -> ipm.KKTBackend:
    """The tree :class:`~.ipm.KKTBackend` for :func:`~.ipm.solve`."""
    NU = dims.NU
    oh = ipm._box_onehot(qp)
    mu_scal = torch.tensor(1.0 / max(dims.n_constr, 1), dtype=qp.dtype,
                           device=qp.device)
    ng_stages = tuple(n for n in range(dims.N + 1) if dims.ng[n] > 0)

    def factor_solve(Qx_b, Qx_g, g_eff, rhs_b):
        H_eff = ipm._build_Heff(qp, oh, Qx_b, Qx_g, reg_eps, ng_stages)
        z, pi, fac = tree_factor_solve(tdef, qp, H_eff, g_eff, rhs_b, NU)
        return z, pi, (fac,)

    def resolve(fstate, g_eff, rhs_b):
        return tree_resolve(tdef, qp, fstate[0], g_eff, rhs_b, NU)

    def residuals(z, pi, lam_b, t_b, lam_g, t_g, rhs_b):
        return tree_residuals(tdef, qp, oh, mu_scal, z, pi, lam_b, t_b,
                              lam_g, t_g, rhs_b)

    return ipm.KKTBackend(factor_solve=factor_solve, resolve=resolve,
                          residuals=residuals,
                          carry_factor=lambda fstate: fstate[0].L)


def solve_tree_ipm(tdef: TreeDef, dims: OCPDims, qp: OCPQP,
                   cfg: ipm.IPMConfig, z0=None, pi0=None):
    """Tree IPM (``d_tree_ip2_res_mpc_hard_libstr``): the shared two-phase
    Mehrotra loop with the tree backend injected, over the batch of ``qp``
    (every leaf with a leading instance axis; no vmap: the port's
    :func:`~.ipm.solve` is batch-native).

    ``dims`` describes the NODE arrays: dims.N + 1 == n_nodes.  ``z0`` (B,
    n_nodes, NZ) / ``pi0`` (B, n_nodes-1, NX) with ``cfg.warm_start`` seed
    the iterate (the reference tree solver's ``warm_start`` argument,
    ``d_tree_ip2_res_hard_libstr.c:80``): closed-loop tree-RTI re-solves
    start from the previous tick's node trajectory."""
    if dims.N + 1 != tdef.n_nodes:
        raise ValueError(f"dims.N + 1 = {dims.N + 1} node rows, the tree "
                         f"has {tdef.n_nodes} nodes")
    return ipm.solve(dims, qp, cfg, z0=z0, pi0=pi0,
                     backend=tree_backend(tdef, dims, qp, cfg.reg_eps))


# ---------------------------------------------------------------------------
# the batched flat tree engine (the lanes engine's flat form + rows 26-28)
# ---------------------------------------------------------------------------


def _flat_tree_kkt_factory(tdef: TreeDef):
    """KKT hook of :func:`~.ipm_lanes.solve_batched_lanes` (``flat=True``):
    the chain's sweeps replaced by the tree kernels
    (:mod:`..ops.tree_kernel`), the engine's step, alpha, gating and trace
    machinery kept -- the flat-engine twin of injecting
    :func:`tree_backend` into :func:`~.ipm.solve`."""

    def factory(dims, qp, ng_stages, Hl, Fl):
        from ..ops import tree_kernel as tk

        ks = dict(NU=dims.NU, NZ=dims.NZ, NX=dims.NX)
        di = ipm._stage_index(tuple(tdef.dad[1:]), qp.device)

        def factor(dvecL, ngl, geffL, rhsL):
            # the affine pi is dead in the loop (iter_ref is off): skip it
            return tk.tree_factor_solve_flat(
                tdef.dad, Hl, dvecL, ngl, ng_stages, geffL, Fl, rhsL,
                want_pi=False, **ks)

        def resolve(fstate, geffL, rhsL):
            return tk.tree_solve_flat(tdef.dad, *fstate, geffL, Fl, rhsL,
                                      **ks)

        def resid_terms(zL, piL):
            return tk.tree_resid_terms_flat(tdef.dad, Hl, Fl, zL, piL,
                                            NZ=dims.NZ, NX=dims.NX)

        def apply_fpi(rqL, fpiL):
            """The edge-major F_e pi_e onto the rows of each edge's parent
            (JAX: a 0/1 selection matmul)."""
            return rqL.index_add(0, di, fpiL)

        return types.SimpleNamespace(factor=factor, resolve=resolve,
                                     resid_terms=resid_terms,
                                     apply_fpi=apply_fpi)

    return factory


def solve_tree_ipm_flat(tdef: TreeDef, dims: OCPDims, qp: OCPQP,
                        cfg: ipm.IPMConfig, z0=None, pi0=None):
    """Batched tree IPM on the lanes engine's flat form with the tree
    kernels (Queue 2 rows 26-28): the tree twin of the chain's ``"flat"``
    engine.  ``qp`` leaves carry a leading batch axis; needs a static
    ``dims.idxb`` and ``cfg.iter_ref == 0``; float32 and float64 both run
    (the JAX engine is float32 only, the TPU having no float64; the
    float64 form is the port's test oracle).

    The TPU gates are dropped (ROADMAP "What does not carry over"): the
    batch need not be a multiple of 1024, and there is no VMEM fit test.
    ``HPMPC_TREE_HBM`` has no counterpart: the backward sweep's per-node
    accumulator always lives in device memory, per instance."""
    from . import ipm_lanes

    if dims.N + 1 != tdef.n_nodes:
        raise ValueError(f"dims.N + 1 = {dims.N + 1} node rows, the tree "
                         f"has {tdef.n_nodes} nodes")
    return ipm_lanes.solve_batched_lanes(
        dims, qp, cfg, z0=z0, pi0=pi0, flat=True,
        kkt_factory=_flat_tree_kkt_factory(tdef))
