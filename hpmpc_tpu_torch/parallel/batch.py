"""Batched QP solving (PyTorch twin of the dispatch half of
:mod:`hpmpc_tpu.parallel.batch`).

The batch is a first-class leading axis on every QP leaf.
:func:`select_engine` keeps the JAX package's rule and engine names, minus
the gates that are TPU measurements (the ``B % 1024`` block, the VMEM fit
gates, the NZ 19..22 mega fence; nothing here chunks at 4096 either).
The ``"resident"``, ``"lanes"`` and the two two-stage engines are ported,
and on the soft path (:func:`solve_batched_soft`) ``"soft_lanes"``;
every other engine raises ``NotImplementedError`` naming its ROADMAP item
instead of quietly running something else.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..models import ipm
from ..ocp import OCPDims, OCPQP

#: ROADMAP.md Queue 1 item that ports each engine not available yet
_NOT_PORTED = {
    "structured": "Queue 1 #5 (structured ipm.solve)",
    "flat": "Queue 1 #7 (the flat engine folds into the lanes engine)",
}


def broadcast_qp(qp: OCPQP, batch: int) -> OCPQP:
    """Tile a single QP into a batch (leading axis; views, no copies)."""
    return OCPQP(**{
        f.name: getattr(qp, f.name).expand(
            (batch,) + tuple(getattr(qp, f.name).shape))
        for f in dataclasses.fields(qp)})


def select_engine(dims: OCPDims, cfg: ipm.IPMConfig, B: int, dtype) -> str:
    """The hard-path dispatch rule: ``"resident"``, ``"lanes"``,
    ``"flat"``, ``"two_stage_resident"``, ``"two_stage_lanes"`` or
    ``"structured"``, as in :func:`hpmpc_tpu.parallel.batch.select_engine`.

    Env knobs as in the JAX package: ``HPMPC_RESIDENT=0`` disables the
    resident engine, ``HPMPC_LANES_LOOP=0`` the lanes engine."""
    if not (cfg.use_pallas and dims.n_constr > 0 and dims.idxb is not None):
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
    (B, N, NX) with ``cfg.warm_start`` seed the iterate."""
    if cfg.escalate_stalled and qp.dtype == torch.float32:
        raise NotImplementedError(
            "escalate_stalled re-solves through the structured engine: "
            f"ROADMAP {_NOT_PORTED['structured']}")
    B = qp.b.shape[0]
    engine = select_engine(dims, cfg, B, qp.dtype)
    if engine == "resident":
        from ..models import ipm_resident

        return ipm_resident.solve_batched_resident(dims, qp, cfg,
                                                   z0=z0, pi0=pi0)
    if engine == "lanes":
        from ..models import ipm_lanes

        return ipm_lanes.solve_batched_lanes(dims, qp, cfg, z0=z0, pi0=pi0)
    if engine in ("two_stage_resident", "two_stage_lanes"):
        return _solve_two_stage(dims, qp, cfg, engine, z0, pi0)
    raise NotImplementedError(
        f"engine {engine!r} is not ported yet: ROADMAP {_NOT_PORTED[engine]}")


#: ROADMAP.md item that ports each soft engine not available yet
_SOFT_NOT_PORTED = {
    "soft_resident": "Queue 2 row 1s (the soft resident kernel)",
    "soft_flat": "Queue 1 #7 (ipm_soft_fast folds into the lanes engine)",
    "soft_structured": "Queue 1 #10 (the structured soft ipm_soft.solve)",
}


def broadcast_soft(soft, batch: int):
    """Tile one :class:`~..models.ipm_soft.SoftSpec` into a batch (leading
    axis; views, no copies)."""
    return type(soft)(*[x.expand((batch,) + tuple(x.shape)) for x in soft])


def select_soft_engine(dims: OCPDims, cfg: ipm.IPMConfig, dtype, NS: int,
                       idxbs) -> str:
    """The soft-path dispatch rule of
    :func:`hpmpc_tpu.parallel.batch.solve_batched_soft`, minus the TPU
    gates (the ``B % 1024`` block and the VMEM fit gates):
    ``"soft_resident"`` (opt-in, ``HPMPC_RESIDENT=1``), ``"soft_lanes"``,
    ``"soft_flat"`` or ``"soft_structured"``.  ``HPMPC_LANES_LOOP=0``
    (without ``HPMPC_MEGA_SWEEPS=1``) leaves the lanes engine."""
    if not (cfg.use_pallas and dims.idxb is not None and idxbs is not None):
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
    every instance (the soft analogue of ``dims.idxb``).  The
    ``"soft_lanes"`` engine is ported; the others raise
    ``NotImplementedError`` naming their ROADMAP item."""
    NS = soft.ns_mask.shape[-1]
    engine = select_soft_engine(dims, cfg, qp.dtype, NS, idxbs)
    if engine != "soft_lanes":
        raise NotImplementedError(
            f"soft engine {engine!r} is not ported yet: ROADMAP "
            f"{_SOFT_NOT_PORTED[engine]}")
    from ..models import ipm_soft_lanes

    idxbs_t = tuple(tuple(int(i) for i in row) for row in idxbs)
    return ipm_soft_lanes.solve_batched_soft_lanes(
        dims, qp, soft, cfg, idxbs_t,
        exact_mehrotra_soft=exact_mehrotra_soft)


def _solve_two_stage(dims, qp, cfg, engine, z0, pi0) -> ipm.IPMSolution:
    """The two-stage parity route (``bench.py``'s second line): the
    resident or the lanes engine runs the well-conditioned iterations
    unrefined to mu <= ``iter_ref_mu_thr``, then hands its whole
    primal-dual state to the lanes engine, which finishes with the
    mu-gated refinement; kk and the stat rows continue across the
    hand-off.  ``HPMPC_STAGE2_LANES=0`` (the flat stage 2) raises."""
    from ..models import ipm_lanes

    if os.environ.get("HPMPC_STAGE2_LANES", "1") != "1":
        raise NotImplementedError(
            f"two-stage route with the flat stage 2: ROADMAP "
            f"{_NOT_PORTED['flat']}")
    cfg1 = dataclasses.replace(
        cfg, iter_ref=0,
        mu_tol=max(float(cfg.mu_tol), float(cfg.iter_ref_mu_thr)))
    if engine == "two_stage_resident":
        from ..models import ipm_resident

        sol1 = ipm_resident.solve_batched_resident(dims, qp, cfg1,
                                                   z0=z0, pi0=pi0)
    else:
        sol1 = ipm_lanes.solve_batched_lanes(dims, qp, cfg1, z0=z0, pi0=pi0)
    return ipm_lanes.solve_batched_lanes(dims, qp, cfg, state0=sol1)
