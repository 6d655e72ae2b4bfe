"""Batched QP solving (PyTorch twin of the dispatch half of
:mod:`hpmpc_tpu.parallel.batch`).

The batch is a first-class leading axis on every QP leaf.
:func:`select_engine` keeps the JAX package's rule and engine names, minus
the gates that are TPU measurements (the ``B % 1024`` block, the NZ 19..22
mega fence; nothing here chunks at 4096 either).  Its size gate
(:func:`..ops.stage_kernel.engine_fits`) is the card's own: past the per-thread engines'
envelope measured on the H100 every batch takes ``"structured"``, whose
kernel backend runs the blocked large-NZ band.
Every engine of :func:`solve_batched` is ported: ``"resident"``,
``"lanes"``, ``"flat"`` (the lanes engine's flat form, into which the
JAX package's flat engine ``ipm_fast`` folds), the two two-stage engines
and ``"structured"`` (the batch-native :func:`~..models.ipm.solve`, which
the library's default ``IPMConfig()`` reaches), with the f32 escalation
(:func:`_escalate_stalled`) and :func:`solve_single`; on the soft path
(:func:`solve_batched_soft`) ``"soft_lanes"`` and ``"soft_flat"`` (both
the soft lanes engine, whose default 6-kernel loop is the flat form) and
``"soft_structured"`` (the batch-native :func:`~..models.ipm_soft.solve`);
on the scenario tree (:func:`solve_batched_tree`) the flat tree engine or
the structured tree IPM.  The opt-in soft resident engine raises
``NotImplementedError`` naming its ROADMAP item instead of quietly running
something else.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..models import ipm
from ..ocp import OCPDims, OCPQP
from ..ops import stage_kernel as sk


def broadcast_qp(qp: OCPQP, batch: int) -> OCPQP:
    """Tile a single QP into a batch (leading axis; views, no copies)."""
    return OCPQP(**{
        f.name: getattr(qp, f.name).expand(
            (batch,) + tuple(getattr(qp, f.name).shape))
        for f in dataclasses.fields(qp)})


def select_engine(dims: OCPDims, cfg: ipm.IPMConfig, B: int, dtype) -> str:
    """The hard-path dispatch rule: ``"resident"``, ``"lanes"``,
    ``"flat"``, ``"two_stage_resident"``, ``"two_stage_lanes"`` or
    ``"structured"``, as in :func:`hpmpc_tpu.parallel.batch.select_engine`,
    with the H100's size envelope (:func:`..ops.stage_kernel.engine_fits`)
    where JAX has its VMEM one: past it, ``"structured"``, whose kernel
    backend runs the blocked large-NZ band.

    Env knobs as in the JAX package: ``HPMPC_RESIDENT=0`` disables the
    resident engine, ``HPMPC_LANES_LOOP=0`` the lanes engine."""
    if not (cfg.use_pallas and dims.n_constr > 0 and dims.idxb is not None
            and sk.engine_fits(int(dims.NX), int(dims.NU))):
        return "structured"
    f32 = dtype == torch.float32
    iter_ref = int(cfg.iter_ref)
    ref_thr = float(cfg.iter_ref_mu_thr)

    def resident_ok(stage1_mu_tol: float) -> bool:
        # exact only where the legacy phase-1-to-mu_tol semantics coincide
        # with the requested config: mu_switch <= the target tolerance
        return (
            os.environ.get("HPMPC_RESIDENT", "1") == "1"
            and dims.NB > 0
            and f32
            and float(cfg.mu_switch) <= stage1_mu_tol
        )

    lanes_ok = (
        (os.environ.get("HPMPC_LANES_LOOP", "1") == "1"
         or os.environ.get("HPMPC_MEGA_SWEEPS", "0") == "1")
        and dims.NB > 0
        and f32
    )
    if iter_ref == 0:
        if resident_ok(float(cfg.mu_tol)):
            return "resident"
        return "lanes" if lanes_ok else "flat"
    if ref_thr > 0 and lanes_ok:
        if resident_ok(max(float(cfg.mu_tol), ref_thr)):
            return "two_stage_resident"
        return "two_stage_lanes"
    return "flat"


def solve_batched(dims: OCPDims, qp: OCPQP, cfg: ipm.IPMConfig,
                  z0=None, pi0=None) -> ipm.IPMSolution:
    """Solve a batch of QPs (leading instance axis on every leaf) with the
    engine :func:`select_engine` picks.  ``z0`` (B, N+1, NZ) / ``pi0``
    (B, N, NX) with ``cfg.warm_start`` seed the iterate.  In float32 with
    ``cfg.escalate_stalled`` the instances the solve leaves unconverged are
    re-solved in float64 (:func:`_escalate_stalled`)."""
    if cfg.escalate_stalled and qp.dtype == torch.float32:
        cfg_base = dataclasses.replace(cfg, escalate_stalled=False)
        sol = solve_batched(dims, qp, cfg_base, z0=z0, pi0=pi0)
        return _escalate_stalled(dims, qp, cfg_base, sol, z0, pi0)
    B = qp.b.shape[0]
    engine = select_engine(dims, cfg, B, qp.dtype)
    if engine == "resident":
        from ..models import ipm_resident

        return ipm_resident.solve_batched_resident(dims, qp, cfg,
                                                   z0=z0, pi0=pi0)
    if engine in ("lanes", "flat"):
        from ..models import ipm_lanes

        return ipm_lanes.solve_batched_lanes(dims, qp, cfg, z0=z0, pi0=pi0,
                                             flat=engine == "flat")
    if engine in ("two_stage_resident", "two_stage_lanes"):
        return _solve_two_stage(dims, qp, cfg, engine, z0, pi0)
    return ipm.solve(dims, qp, cfg, z0=z0, pi0=pi0)


def _escalate_stalled(dims: OCPDims, qp: OCPQP, cfg, sol, z0, pi0):
    """The float32 floor's escalation (``IPMConfig.escalate_stalled``, the
    JAX package's ``_escalate_stalled``): every instance the float32 solve
    left unconverged (status != 0) is re-solved in float64 through the
    structured route with the plain backend (``use_pallas=False``: float64
    end to end) and its result, cast back, replaces that instance's; the
    converged instances keep theirs bit for bit.  One host sync finds the
    stalled instances; only they are re-solved (instances are independent,
    so each gets what a whole-batch re-solve would give it)."""
    idx = torch.nonzero(sol.status != 0).flatten()
    if idx.numel() == 0:
        return sol

    def pick64(x):
        x = x[idx]
        return x.double() if x.is_floating_point() else x

    qp64 = OCPQP(**{f.name: pick64(getattr(qp, f.name))
                    for f in dataclasses.fields(qp)})
    cfg64 = dataclasses.replace(cfg, use_pallas=False)
    solm = solve_batched(dims, qp64, cfg64,
                         z0=None if z0 is None else pick64(z0),
                         pi0=None if pi0 is None else pick64(pi0))
    out = []
    for a, m in zip(sol, solm):
        a = a.clone()
        a[idx] = m.to(a.dtype)
        out.append(a)
    return type(sol)(*out)


def solve_single(dims: OCPDims, qp: OCPQP, cfg: ipm.IPMConfig, z0=None,
                 pi0=None) -> ipm.IPMSolution:
    """Solve ONE QP (leaves without an instance axis; ``z0`` (N+1, NZ) /
    ``pi0`` (N, NX) with ``cfg.warm_start``) through :func:`solve_batched`
    at B=1 and return its solution without the instance axis.  The JAX
    function pads the instance into a 1024-lane block for the TPU's (8,
    128) tile; that is a TPU gate and is dropped here, as the others."""
    qpb = broadcast_qp(qp, 1)
    sol = solve_batched(dims, qpb, cfg,
                        z0=None if z0 is None else z0[None],
                        pi0=None if pi0 is None else pi0[None])
    return type(sol)(*[x[0] for x in sol])


def broadcast_soft(soft, batch: int):
    """Tile one :class:`~..models.ipm_soft.SoftSpec` into a batch (leading
    axis; views, no copies)."""
    return type(soft)(*[x.expand((batch,) + tuple(x.shape)) for x in soft])


def select_soft_engine(dims: OCPDims, cfg: ipm.IPMConfig, dtype, NS: int,
                       idxbs) -> str:
    """The soft-path dispatch rule of
    :func:`hpmpc_tpu.parallel.batch.solve_batched_soft`, minus the TPU's
    ``B % 1024`` block, with the H100's size envelope
    (:func:`..ops.stage_kernel.engine_fits`) where JAX has its VMEM one:
    ``"soft_resident"`` (opt-in, ``HPMPC_RESIDENT=1``), ``"soft_lanes"``,
    ``"soft_flat"`` or ``"soft_structured"``.  ``HPMPC_LANES_LOOP=0``
    (without ``HPMPC_MEGA_SWEEPS=1``) leaves the lanes engine."""
    if not (cfg.use_pallas and dims.idxb is not None and idxbs is not None
            and sk.engine_fits(int(dims.NX), int(dims.NU))):
        return "soft_structured"
    soft_f32 = dims.NB > 0 and NS > 0 and dtype == torch.float32
    if (os.environ.get("HPMPC_RESIDENT") == "1" and soft_f32
            and int(cfg.iter_ref) == 0):
        return "soft_resident"
    if ((os.environ.get("HPMPC_LANES_LOOP", "1") == "1"
         or os.environ.get("HPMPC_MEGA_SWEEPS", "0") == "1") and soft_f32):
        return "soft_lanes"
    return "soft_flat"


def solve_batched_soft(dims: OCPDims, qp: OCPQP, soft, cfg: ipm.IPMConfig,
                       idxbs=None, exact_mehrotra_soft: bool = True):
    """Solve a batch of soft-constrained QPs (leading instance axis on
    every leaf of ``qp`` and ``soft``) with the engine
    :func:`select_soft_engine` picks; returns a
    :class:`~..models.ipm_soft.SoftSolution`.

    ``idxbs``: the static (N+1, NS) padded-z soft coordinates shared by
    every instance (the soft analogue of ``dims.idxb``).  The opt-in
    ``"soft_resident"`` engine raises ``NotImplementedError`` naming its
    ROADMAP item."""
    NS = soft.ns_mask.shape[-1]
    engine = select_soft_engine(dims, cfg, qp.dtype, NS, idxbs)
    if engine == "soft_resident":
        raise NotImplementedError(
            "soft engine 'soft_resident' is not ported yet: ROADMAP Queue 1 "
            "#10b, Queue 2 row 1s (the soft resident kernel)")
    if engine == "soft_structured":
        from ..models import ipm_soft

        return ipm_soft.solve(dims, qp, soft, cfg,
                              exact_mehrotra_soft=exact_mehrotra_soft)
    from ..models import ipm_soft_lanes

    idxbs_t = tuple(tuple(int(i) for i in row) for row in idxbs)
    return ipm_soft_lanes.solve_batched_soft_lanes(
        dims, qp, soft, cfg, idxbs_t,
        exact_mehrotra_soft=exact_mehrotra_soft)


def solve_batched_tree(tdef, dims: OCPDims, qp: OCPQP, cfg: ipm.IPMConfig,
                       z0=None, pi0=None) -> ipm.IPMSolution:
    """Tree twin of :func:`solve_batched`: a batch of scenario-tree QPs
    (node/edge arrays, :mod:`..models.tree`, with a leading instance axis).
    With ``cfg.use_pallas``, a static ``dims.idxb``, float32 data, no
    ``iter_ref`` and a stage width inside the per-thread kernels' envelope
    (:func:`..ops.stage_kernel.engine_fits`), the flat tree engine
    (:func:`~..models.tree.solve_tree_ipm_flat`: the lanes engine's flat
    form with the tree kernels); otherwise the batch-native structured tree
    IPM (:func:`~..models.tree.solve_tree_ipm`, plain torch, no per-shape
    build), float64 included, as in JAX.  The card's envelope takes the
    place of the JAX rule's TPU gates (the ``B % 1024`` block, the VMEM fit
    of the accumulator).

    ``z0`` (B, n_nodes, NZ) / ``pi0`` (B, n_nodes-1, NX) with
    ``cfg.warm_start`` seed the node iterate on both routes: closed-loop
    tree-RTI re-solves stay on the flat engine (the reference tree
    solver's ``warm_start`` argument, ``d_tree_ip2_res_hard_libstr.c:80``)."""
    from ..models import tree as _tree

    if (cfg.use_pallas and dims.idxb is not None
            and qp.dtype == torch.float32 and int(cfg.iter_ref) == 0
            and sk.engine_fits(int(dims.NX), int(dims.NU))):
        return _tree.solve_tree_ipm_flat(tdef, dims, qp, cfg, z0=z0, pi0=pi0)
    return _tree.solve_tree_ipm(tdef, dims, qp, cfg, z0=z0, pi0=pi0)


def _solve_two_stage(dims, qp, cfg, engine, z0, pi0) -> ipm.IPMSolution:
    """The two-stage parity route (``bench.py``'s second line): the
    resident or the lanes engine runs the well-conditioned iterations
    unrefined to mu <= ``iter_ref_mu_thr``, then hands its whole
    primal-dual state to the lanes engine, which finishes with the
    mu-gated refinement; kk and the stat rows continue across the
    hand-off.  ``HPMPC_STAGE2_LANES=0`` runs stage 2 on the lanes engine's
    flat form (the JAX package's flat stage 2)."""
    from ..models import ipm_lanes

    cfg1 = dataclasses.replace(
        cfg, iter_ref=0,
        mu_tol=max(float(cfg.mu_tol), float(cfg.iter_ref_mu_thr)))
    if engine == "two_stage_resident":
        from ..models import ipm_resident

        sol1 = ipm_resident.solve_batched_resident(dims, qp, cfg1,
                                                   z0=z0, pi0=pi0)
    else:
        sol1 = ipm_lanes.solve_batched_lanes(dims, qp, cfg1, z0=z0, pi0=pi0)
    return ipm_lanes.solve_batched_lanes(
        dims, qp, cfg, state0=sol1,
        flat=os.environ.get("HPMPC_STAGE2_LANES", "1") != "1")
