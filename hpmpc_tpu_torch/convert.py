"""Parameter carry-over between the JAX package and the port.

A JAX :class:`hpmpc_tpu.ocp.OCPQP`'s leaves, handed over as numpy arrays
keyed by field name, become the port's :class:`~.ocp.OCPQP` (batched or
not); warm-start state (``z0``/``pi0``), a whole batched solution
(:class:`~.models.ipm.IPMSolution`, e.g. a first stage's hand-off) and
soft-constraint data (:class:`~.models.ipm_soft.SoftSpec`) ride along
the same way.  Numpy is
the only currency, so neither package imports the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.ipm import IPMSolution
from .models.ipm_soft import SoftSpec
from .ocp import OCPDims, OCPQP, resolve_device

QP_FIELDS = tuple(f.name for f in dataclasses.fields(OCPQP))


def qp_from_numpy(dims: OCPDims, arrays: dict, device=None,
                  dtype=torch.float64) -> OCPQP:
    """``arrays[name]`` for every :class:`OCPQP` field -> the port's QP on
    ``device`` (default: the CUDA card); float leaves are cast to
    ``dtype``, ``idxb`` stays int32.  Each leaf is ``(stage, ...)`` or
    ``(B, stage, ...)``; the stage axis must match ``dims``."""
    device = resolve_device(device)
    missing = [f for f in QP_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"qp_from_numpy: missing fields {missing}")
    out = {}
    for name in QP_FIELDS:
        a = np.asarray(arrays[name])
        if name == "idxb":
            t = torch.tensor(a.astype(np.int32), device=device)
        else:
            t = torch.tensor(a, device=device, dtype=dtype)
        out[name] = t
    qp = OCPQP(**out)
    Np1 = qp.H.shape[-3]
    if Np1 != dims.N + 1 or qp.H.shape[-1] != dims.NZ:
        raise ValueError(
            f"qp_from_numpy: H has shape {tuple(qp.H.shape)}, dims expect "
            f"(..., {dims.N + 1}, {dims.NZ}, {dims.NZ})")
    return qp


def warm_from_numpy(arrays: dict, device=None, dtype=torch.float64):
    """Warm-start state ``(z0, pi0)`` from ``arrays`` (each entry optional:
    a missing key gives None) — the iterate a previous solve returned,
    (B, N+1, NZ) and (B, N, NX), on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    def one(key):
        if arrays.get(key) is None:
            return None
        return torch.tensor(np.asarray(arrays[key]), device=device,
                            dtype=dtype)

    return one("z0"), one("pi0")


def solution_from_numpy(arrays: dict, device=None,
                        dtype=torch.float64) -> IPMSolution:
    """``arrays[name]`` for every :class:`~.models.ipm.IPMSolution` field
    (batched, e.g. a JAX solution's leaves as numpy) -> the port's
    solution on ``device`` (default: the CUDA card): ``kk``/``status``
    int32, the rest ``dtype``."""
    device = resolve_device(device)
    out = {}
    for name in IPMSolution._fields:
        a = np.asarray(arrays[name])
        dt = torch.int32 if name in ("kk", "status") else dtype
        out[name] = torch.tensor(a, device=device, dtype=dt)
    return IPMSolution(**out)


def soft_from_numpy(arrays: dict, device=None,
                    dtype=torch.float64) -> SoftSpec:
    """``arrays[name]`` for every :class:`~.models.ipm_soft.SoftSpec` field
    (e.g. a JAX ``SoftSpec``'s leaves as numpy, batched or not) -> the
    port's soft data on ``device`` (default: the CUDA card): ``idxbs``
    int32, the rest ``dtype``."""
    device = resolve_device(device)
    out = {}
    for name in SoftSpec._fields:
        a = np.asarray(arrays[name])
        if name == "idxbs":
            out[name] = torch.tensor(a.astype(np.int32), device=device)
        else:
            out[name] = torch.tensor(a, device=device, dtype=dtype)
    return SoftSpec(**out)


def qp_to_numpy(qp: OCPQP) -> dict:
    """Inverse of :func:`qp_from_numpy`: field name -> numpy array."""
    return {name: getattr(qp, name).detach().cpu().numpy()
            for name in QP_FIELDS}
