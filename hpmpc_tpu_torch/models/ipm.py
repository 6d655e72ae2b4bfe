"""IPM configuration, solution container and breakdown-guard constants
(PyTorch twin of the matching parts of :mod:`hpmpc_tpu.models.ipm`).

Same field names and defaults as the JAX ``IPMConfig``, so a config carries
across.  The structured two-phase solver itself (``ipm.solve``) is not
ported yet; the engines that are (``models.ipm_resident``,
``models.ipm_lanes``, ``models.ipm_soft_lanes``) share these definitions
and the breakdown guard (:func:`step_ok`, :func:`anchor_lam_ref`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class IPMConfig:
    """Runtime tunables (the reference's ``k_max, mu0, mu_tol, alpha_min,
    warm_start`` plus the JAX package's engine knobs; see
    :class:`hpmpc_tpu.models.ipm.IPMConfig` for each field's meaning)."""

    k_max: int = 30
    mu0: float = 2.0
    mu_tol: float = 1e-8
    alpha_min: float = 1e-8
    warm_start: bool = False
    # phase-1 -> phase-2 switch; mu_switch <= mu_tol is the legacy
    # no-residual solver (phase 1 all the way), the resident engine's
    # contract
    mu_switch: float = 1e-5
    # dispatch to the hand-written kernel engines (parallel.batch)
    use_pallas: bool = False
    reg_eps: float = 0.0
    iter_ref: int = 0
    corrector_low: bool = True
    corrector_high: bool = True
    iter_ref_mu_thr: float = 0.0
    escalate_stalled: bool = False


class IPMSolution(NamedTuple):
    """Batched solution: every field has a leading instance axis B."""

    z: torch.Tensor  # (B, N+1, NZ)
    pi: torch.Tensor  # (B, N, NX)
    lam_b: torch.Tensor  # (B, N+1, 2, NB) [lower, upper]
    t_b: torch.Tensor  # (B, N+1, 2, NB)
    lam_g: torch.Tensor  # (B, N+1, 2, NG)
    t_g: torch.Tensor  # (B, N+1, 2, NG)
    kk: torch.Tensor  # (B,) int32 iterations used
    status: torch.Tensor  # (B,) int32: 0 converged, 1 max iters, 2 frozen
    stat: torch.Tensor  # (B, k_max, 5) [sigma, alpha_aff, mu_aff, alpha, mu]
    inf_norm_res: torch.Tensor  # (B, 4) {|rq|inf, |rb|inf, |rd|inf, mu}


#: mu level below which the f32 breakdown guards arm (barrier conditioning
#: ~1/mu outruns f32 near here); the resident kernel applies them in-kernel
GUARD_MU_FLOOR = 1e-3
#: per-step and anchored max-|dual| growth factor that counts as breakdown
GUARD_LAM_GROWTH = 30.0
#: per-step mu growth factor that counts as divergence below the floor
GUARD_MU_GROWTH = 10.0
#: "not anchored yet" / "no blocking row" sentinel, finite in float32
BIG = 3.0e38


def step_ok(mu_new, mu_old, lam_max_new=None, lam_max_old=None,
            lam_ref=None):
    """Numerical-breakdown guard of one step, per instance ((B,) tensors in,
    a (B,) bool out), as :func:`hpmpc_tpu.models.ipm.step_ok`: the new mu
    must be finite and, in float32 only, below ``GUARD_MU_FLOOR`` it must
    not grow ``GUARD_MU_GROWTH``-fold, the max |dual| must not grow
    ``GUARD_LAM_GROWTH``-fold in one step (given ``lam_max_new``), and not
    beyond that factor of the anchor ``lam_ref`` once one exists (given,
    and finite).  The soft engine passes the mu guards only.  float64 is
    exempt from all but finiteness."""
    ok = torch.isfinite(mu_new)
    if mu_new.dtype == torch.float32:
        floor = mu_old < GUARD_MU_FLOOR
        ok = ok & ~((mu_new > GUARD_MU_GROWTH * mu_old) & floor)
        if lam_max_new is not None:
            ok = ok & ~((lam_max_new > GUARD_LAM_GROWTH
                         * torch.clamp(lam_max_old, min=1.0)) & floor)
        if lam_ref is not None:
            ok = ok & ~((lam_max_new > GUARD_LAM_GROWTH * lam_ref)
                        & torch.isfinite(lam_ref))
    return ok


def anchor_lam_ref(lam_ref, mu_new, lam_max_new):
    """Carry update of the cumulative guard's anchor: on the step that
    first takes an instance below ``GUARD_MU_FLOOR``, record
    ``max(|lam|, 1)``; afterwards keep it.  Starts at +inf (no anchor)."""
    entering = torch.isinf(lam_ref) & (mu_new < GUARD_MU_FLOOR)
    return torch.where(entering, torch.clamp(lam_max_new, min=1.0), lam_ref)
