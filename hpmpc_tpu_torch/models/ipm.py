"""Primal-dual interior-point method for hard-constrained linear MPC
(PyTorch twin of :mod:`hpmpc_tpu.models.ipm`), batch-native.

:func:`solve` is the structured two-phase Mehrotra predictor-corrector IPM
of the reference's ``d_ip2_res_mpc_hard_tv``
(``mpc_solvers/d_ip2_res_hard.c:116``): phase 1 solves for the full new
iterate while mu > max(mu_tol, mu_switch), phase 2 for deltas against the
exact KKT residuals, each KKT system by the backward Riccati recursion.
Its KKT backend (:func:`chain_backend`) is the plain batched Riccati of
:mod:`.riccati` or, with ``use_pallas``, the hand-written kernels
:func:`~..ops.stage_kernel.factor_solve_folded` and
:func:`~..ops.stage_kernel.solve_batched` (:func:`make_kernel_chain_kkt`,
the JAX package's ``make_pallas_chain_kkt``), and past their size envelope
the blocked Riccati of :mod:`.riccati_blocked` on the batched Cholesky
kernel (the large-NZ band).

Every QP leaf carries a leading instance axis B, and so does every field of
the state: the per-instance scalars (mu, alpha, sigma, kk, the guard's
anchor) are (B,) tensors.  Where JAX runs ``vmap(while_loop(pred,
gated(body, pred)))``, the loops here run while any instance's predicate
holds (one host sync per iteration), compute the body for the whole batch
and keep, per instance, the new state where its predicate held and the old
one elsewhere (a select, so a frozen instance may hold anything).  The
``stat`` row of a step goes to each instance's own ``kk``.

The same field names and defaults as the JAX ``IPMConfig`` carry a config
across.  The batched engines (``models.ipm_resident``, ``models.ipm_lanes``,
``models.ipm_soft_lanes``) share the config, the solution container and
the breakdown guard (:func:`step_ok`, :func:`anchor_lam_ref`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ocp import OCPDims, OCPQP
from ..ops import stage_kernel as sk
from ..ops.layout import from_lanes, sym_compress, to_lanes
from . import riccati, riccati_blocked


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


# --------------------------------------------------------------------------
# the structured solver's state
# --------------------------------------------------------------------------


class KKTCarry(NamedTuple):
    """Retained Riccati factor + one-step-back iterate (the reference's
    workspace between a solve and a ``d_kkt_solve_new_rhs_res_mpc_hard_tv``
    re-solve, ``d_ip2_res_hard.c:1922-2299``).  ``L`` is the factor of the
    last iteration, the rest the iterate one step before the final one."""

    L: torch.Tensor  # (B, N+1, NZ, NZ)
    z_bkp: torch.Tensor
    pi_bkp: torch.Tensor
    lam_b_bkp: torch.Tensor
    t_b_bkp: torch.Tensor
    lam_g_bkp: torch.Tensor
    t_g_bkp: torch.Tensor


class IPMState(NamedTuple):
    z: torch.Tensor  # (B, N+1, NZ)
    pi: torch.Tensor  # (B, N, NX)
    lam_b: torch.Tensor  # (B, N+1, 2, NB) [lower, upper]
    t_b: torch.Tensor  # (B, N+1, 2, NB) (padded slots: lam=0, t=1)
    lam_g: torch.Tensor  # (B, N+1, 2, NG)
    t_g: torch.Tensor  # (B, N+1, 2, NG)
    mu: torch.Tensor  # (B,)
    alpha: torch.Tensor  # (B,) last damped step
    kk: torch.Tensor  # (B,) int32
    sigma: torch.Tensor  # (B,) last centering parameter
    stat: torch.Tensor  # (B, k_max, 5)
    carry: "KKTCarry | None"  # with return_carry only
    lam_ref: torch.Tensor  # (B,) cumulative-guard anchor, +inf: none yet


class Residuals(NamedTuple):
    rq: torch.Tensor  # (B, N+1, NZ) stationarity
    rb: torch.Tensor  # (B, N, NX) dynamics
    rd_b: torch.Tensor  # (B, N+1, 2, NB) box constraint residuals
    rd_g: torch.Tensor  # (B, N+1, 2, NG)
    rm_b: torch.Tensor  # (B, N+1, 2, NB) complementarity
    rm_g: torch.Tensor  # (B, N+1, 2, NG)
    mu: torch.Tensor  # (B,)


class KKTBackend(NamedTuple):
    """Equality-structure backend of the IPM (the chain default here; the
    tree and associative-scan engines inject their own):

    factor_solve(Qx_b, Qx_g, g_eff, rhs_b) -> (dz, dpi, factor_state)
        (the backend owns the barrier-Hessian assembly H + diag fold +
        C' diag(Qx_g) C)
    resolve(factor_state, g_eff, rhs_b) -> (dz, dpi)
    residuals(z, pi, lam_b, t_b, lam_g, t_g, b) -> Residuals

    carry_factor(factor_state) -> L
        the factor a returned :class:`KKTCarry` keeps, batch-first (B, N+1,
        NZ, NZ)"""

    factor_solve: object
    resolve: object
    residuals: object
    carry_factor: object


# --------------------------------------------------------------------------
# helpers (every array batch-first)
# --------------------------------------------------------------------------


def _bc(v, x):
    """(B,) ``v`` shaped to broadcast against batch-first ``x``."""
    return v.reshape((-1,) + (1,) * (x.ndim - 1))


_STAGE_IDX: dict = {}


def _stage_index(stages, device):
    """The stages ``stages`` (a tuple) as an index tensor on ``device``,
    made once per process, so that indexing makes no host-to-device copy
    (and no sync) per call."""
    key = (tuple(stages), str(device))
    idx = _STAGE_IDX.get(key)
    if idx is None:
        idx = torch.tensor(list(stages), dtype=torch.long, device=device)
        _STAGE_IDX[key] = idx
    return idx


def _box_onehot(qp: OCPQP):
    """(B, N+1, NB, NZ) one-hot of idxb masked by nb_mask: the reference's
    idxb gather/scatter (``dvecad_libsp``/``ddiaadin_libsp``) as
    contractions."""
    NZ = qp.H.shape[-1]
    oh = torch.nn.functional.one_hot(qp.idxb.long(), NZ).to(qp.dtype)
    return oh * qp.nb_mask[..., None]


def _gather_box(oh, z):
    return torch.einsum("bnkz,bnz->bnk", oh, z)


def _scatter_box(oh, v):
    return torch.einsum("bnkz,bnk->bnz", oh, v)


def _cz(qp: OCPQP, z):
    return torch.einsum("bngz,bnz->bng", qp.C, z)


def _diag_add(H, d):
    """H + diag(d) on the last two axes, as the JAX package forms it (an
    identity times the diagonal)."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + eye * d[..., None, :]


def _build_Heff(qp: OCPQP, oh, Qx_b, Qx_g, reg, ng_stages):
    """H + diag(scatter(idxb, Qx_b) + pad + reg) + C' diag(Qx_g) C
    (reference ``ddiaadin_libsp`` + the ``dsyrk`` fold,
    ``d_back_ric_rec.c:197-230``); the general-constraint fold only on the
    stages that have general rows, ``ng_stages`` (a tuple)."""
    H = _diag_add(qp.H, _scatter_box(oh, Qx_b) + qp.pad_diag + reg)
    if ng_stages:
        idx = _stage_index(ng_stages, H.device)
        C = qp.C[:, idx]
        H[:, idx] += torch.einsum("bngz,bng,bngw->bnzw", C,
                                  Qx_g[:, idx] * qp.ng_mask[:, idx], C)
    return H


def _build_geff(qp: OCPQP, oh, base, qx_b, qx_g, ng_stages):
    """base + scatter(idxb, qx_b) + C' qx_g (reference ``drowad_libsp`` +
    the ``dgemv`` gradient fold), the latter on ``ng_stages`` only."""
    out = base + _scatter_box(oh, qx_b)
    if ng_stages:
        idx = _stage_index(ng_stages, out.device)
        out[:, idx] += torch.einsum("bngz,bng->bnz", qp.C[:, idx],
                                    qx_g[:, idx] * qp.ng_mask[:, idx])
    return out


def _min_ratio(alpha, v, dv, mask):
    """Fraction-to-boundary, per instance: min(alpha, min over the valid
    entries with dv < 0 of -v/dv) (``d_aux_ip_hard_lib4.c:535-550``)."""
    pred = (dv < 0.0) & (mask > 0.0)
    safe = torch.where(pred, dv, -torch.ones_like(dv))
    ratio = torch.where(pred, -v / safe, torch.full_like(v, float("inf")))
    return torch.minimum(alpha, ratio.flatten(1).amin(1))


def _sum_lt(lam_b, t_b, lam_g, t_g, nb_mask, ng_mask):
    s = (lam_b * t_b * nb_mask[:, :, None, :]).flatten(1).sum(1)
    return s + (lam_g * t_g * ng_mask[:, :, None, :]).flatten(1).sum(1)


def _absmax(x):
    return x.abs().flatten(1).amax(1)


# --------------------------------------------------------------------------
# variable initialization (d_init_var_mpc_hard_tv, d_aux_ip_hard_lib4.c:43)
# --------------------------------------------------------------------------


def init_vars(dims: OCPDims, qp: OCPQP, cfg: IPMConfig, z0=None, pi0=None,
              carry0: KKTCarry | None = None, iterate0=None) -> IPMState:
    """The reference's initial iterate: z from ``z0`` (with
    ``cfg.warm_start``) or zero with its box-violating coordinates moved
    inside, box slacks clamped at 0.1 (including the reference's stale-slack
    quirk), general slacks from the corrected iterate, lam = mu0 / t.

    ``iterate0`` = ``(z, pi, lam_b, t_b, lam_g, t_g)``, batch-first, is the
    full warm start of ``solve_single_newton`` (the reference's
    ``d_init_var_mpc_hard_tv_single_newton``, ``d_aux_ip_hard_lib4.c:154``):
    the iterate as given, mu = mu0."""
    dt, dev = qp.dtype, qp.device
    B = qp.b.shape[0]
    N, NZ, NX = dims.N, dims.NZ, dims.NX
    full = lambda v: torch.full((B,), v, dtype=dt, device=dev)  # noqa: E731
    if iterate0 is not None:
        z, pi, lam_b, t_b, lam_g, t_g = (x.to(dt) for x in iterate0)
        return IPMState(
            z=z, pi=pi, lam_b=lam_b, t_b=t_b, lam_g=lam_g, t_g=t_g,
            mu=full(cfg.mu0), alpha=full(1.0),
            kk=torch.zeros(B, dtype=torch.int32, device=dev),
            sigma=full(0.0),
            stat=torch.zeros(B, cfg.k_max, 5, dtype=dt, device=dev),
            carry=carry0, lam_ref=full(float("inf")))
    thr0 = torch.tensor(0.1, dtype=dt, device=dev)
    mu0 = torch.tensor(cfg.mu0, dtype=dt, device=dev)
    if cfg.warm_start and z0 is not None:
        z = z0.to(dt)
    else:
        z = torch.zeros(B, N + 1, NZ, dtype=dt, device=dev)
    oh = _box_onehot(qp)
    mb = qp.nb_mask
    zb = _gather_box(oh, z)
    t_lo0 = zb - qp.d_lb
    t_up0 = qp.d_ub - zb
    both = (t_lo0 < thr0) & (t_up0 < thr0)
    lo_only = (t_lo0 < thr0) & ~both
    up_only = (t_up0 < thr0) & ~both
    t_lo = torch.where(both | lo_only, thr0, t_lo0)
    t_up = torch.where(both | up_only, thr0, t_up0)
    z_corr = torch.where(
        both, (qp.d_lb - qp.d_ub) * 0.5,
        torch.where(lo_only, qp.d_lb + thr0,
                    torch.where(up_only, qp.d_ub - thr0, zb)))
    changed = (both | lo_only | up_only) & (mb > 0)
    sel = _scatter_box(oh, changed.to(dt))
    z = z * (1.0 - sel) + _scatter_box(
        oh, torch.where(changed, z_corr, torch.zeros_like(z_corr)))

    mb2 = mb[:, :, None, :] > 0
    t_b = torch.where(mb2, torch.stack([t_lo, t_up], 2), 1.0)
    lam_b = torch.where(mb2, mu0 / t_b, 0.0)
    mg2 = qp.ng_mask[:, :, None, :] > 0
    cz = _cz(qp, z)
    t_g = torch.stack([torch.maximum(thr0, cz - qp.d_lg),
                       torch.maximum(thr0, qp.d_ug - cz)], 2)
    t_g = torch.where(mg2, t_g, 1.0)
    lam_g = torch.where(mg2, mu0 / t_g, 0.0)
    if cfg.warm_start and pi0 is not None:
        pi = pi0.to(dt)
    else:
        pi = torch.zeros(B, N, NX, dtype=dt, device=dev)
    return IPMState(
        z=z, pi=pi, lam_b=lam_b, t_b=t_b, lam_g=lam_g, t_g=t_g,
        mu=full(cfg.mu0), alpha=full(1.0),
        kk=torch.zeros(B, dtype=torch.int32, device=dev), sigma=full(0.0),
        stat=torch.zeros(B, cfg.k_max, 5, dtype=dt, device=dev),
        carry=carry0, lam_ref=full(float("inf")))


# --------------------------------------------------------------------------
# residuals (d_res_res_mpc_hard_tv, mpc_solvers/c99/d_res_ip_res_hard.c:39)
# --------------------------------------------------------------------------


def compute_residuals(qp: OCPQP, oh, mu_scal, z, pi, lam_b, t_b, lam_g,
                      t_g) -> Residuals:
    N = qp.F.shape[1]
    NU = qp.H.shape[-1] - qp.x_mask.shape[-1]
    mb, mg = qp.nb_mask, qp.ng_mask

    # stationarity: g + H z + [0; -pi_{n-1}] + F_n pi_n + box/general terms
    rq = qp.g + torch.einsum("bnzw,bnw->bnz", qp.H, z)
    rq[:, 1:, NU:] += -pi
    rq[:, :N] += torch.einsum("bnzx,bnx->bnz", qp.F, pi)
    rq = rq + _scatter_box(oh, (lam_b[:, :, 1] - lam_b[:, :, 0]) * mb)
    rq = rq + torch.einsum("bngz,bng->bnz", qp.C,
                           (lam_g[:, :, 1] - lam_g[:, :, 0]) * mg)
    rq = rq * qp.z_mask

    # dynamics: b + F' z_n - x_{n+1}
    rb = (qp.b + torch.einsum("bnzx,bnz->bnx", qp.F, z[:, :N])
          - z[:, 1:, NU:]) * qp.x_mask[:, 1:]

    zb = _gather_box(oh, z)
    rd_b = torch.stack([qp.d_lb - zb + t_b[:, :, 0],
                        qp.d_ub - zb - t_b[:, :, 1]], 2) * mb[:, :, None, :]
    cz = _cz(qp, z)
    rd_g = torch.stack([qp.d_lg + t_g[:, :, 0] - cz,
                        qp.d_ug - t_g[:, :, 1] - cz], 2) * mg[:, :, None, :]

    rm_b = lam_b * t_b * mb[:, :, None, :]
    rm_g = lam_g * t_g * mg[:, :, None, :]
    mu = (rm_b.flatten(1).sum(1) + rm_g.flatten(1).sum(1)) * mu_scal
    return Residuals(rq=rq, rb=rb, rd_b=rd_b, rd_g=rd_g, rm_b=rm_b,
                     rm_g=rm_g, mu=mu)


# --------------------------------------------------------------------------
# chain (stage-recursion) backend
# --------------------------------------------------------------------------


def make_kernel_chain_kkt(qp: OCPQP, ng_stages: tuple, NU: int):
    """The (factor_solve, resolve, carry_factor) triple of the chain KKT
    system on the hand-written kernels (the JAX package's
    ``make_pallas_chain_kkt`` without its ``custom_vmap``: the port is
    batch-native, so the batched case is the only one, and without the
    TPU's ``BI`` gate).

    Inside the per-thread kernels' size envelope
    (:func:`~..ops.stage_kernel.engine_fits`, measured on the H100) the
    effective Hessian travels DECOMPOSED -- the constant ``H`` + the
    diagonal ``dvec`` + the ng-stage barrier term -- and is assembled in
    the factorization kernel (:func:`~..ops.stage_kernel.
    factor_solve_folded`, Queue 2 row 16); :func:`~..ops.stage_kernel.
    solve_batched` (row 15) re-solves on the retained factor with its Pb.
    H and F are packed and made batch-last once here, per solve; the
    factor state ``(L, Pb)`` stays batch-last.  Past the envelope the
    large-NZ band takes over: the blocked batched Riccati
    (:func:`.riccati_blocked.factor_solve_folded` / :func:`.riccati_blocked.
    solve`) on the batched Cholesky kernel (Queue 2 row 24), batch first,
    its factor state ``(L, Pb)`` batch first too.  ``carry_factor`` gives
    the factor batch first either way.  Shared by the hard structured route
    and the structured soft IPM (:func:`.ipm_soft.solve`)."""
    NZ = qp.H.shape[-1]
    if not sk.engine_fits(NZ - NU, NU):
        return _blocked_chain_kkt(qp, NU)
    Hl = to_lanes(sym_compress(qp.H))
    Fl = to_lanes(qp.F)
    idx = _stage_index(ng_stages, qp.device) if ng_stages else None
    if ng_stages:
        r, c = torch.tril_indices(NZ, NZ, device=qp.device)
        C_act = qp.C[:, idx]                           # (B, n_ng, NG, NZ)
        C_i, C_j = C_act[..., r], C_act[..., c]        # (B, n_ng, NG, NT)

    def factor_solve(dvec, Qx_g, g_eff, rhs_b):
        ngl = (to_lanes(torch.einsum("bngt,bng,bngt->bnt", C_i,
                                     Qx_g[:, idx], C_j))
               if ng_stages else None)
        z, pi, L, _, _, Pb = sk.factor_solve_folded(
            Hl, to_lanes(dvec), ngl, ng_stages, to_lanes(g_eff), Fl,
            to_lanes(rhs_b), NU)
        return from_lanes(z), from_lanes(pi), (L, Pb)

    def resolve(fstate, g_eff, rhs_b):
        L, Pb = fstate
        z, pi = sk.solve_batched(L, to_lanes(g_eff), Fl, to_lanes(rhs_b), Pb,
                                 NU)
        return from_lanes(z), from_lanes(pi)

    def carry_factor(fstate):
        return fstate[0].movedim(-1, 0)          # the kernels' L is batch-last

    return factor_solve, resolve, carry_factor


def _blocked_chain_kkt(qp: OCPQP, NU: int):
    """:func:`make_kernel_chain_kkt`'s large-NZ band: the blocked batched
    Riccati, batch first (JAX ``make_pallas_chain_kkt``'s blocked branch,
    ``hpmpc_tpu/models/ipm.py:565-581,600-604``).  ``Qx_g`` arrives masked
    to the active rows, so the C' diag(Qx_g) C term vanishes off the ng
    stages."""

    def factor_solve(dvec, Qx_g, g_eff, rhs_b):
        sol, L, _, _, Pb = riccati_blocked.factor_solve_folded(
            qp.H, dvec, qp.C, Qx_g, g_eff, qp.F, rhs_b, NU)
        return sol.z, sol.pi, (L, Pb)

    def resolve(fstate, g_eff, rhs_b):
        sol, _ = riccati_blocked.solve(fstate[0], g_eff, qp.F, rhs_b, NU,
                                       Pb=fstate[1])
        return sol.z, sol.pi

    def carry_factor(fstate):
        return fstate[0]

    return factor_solve, resolve, carry_factor


def chain_backend(dims: OCPDims, qp: OCPQP, oh, mu_scal,
                  use_pallas: bool = False, reg_eps: float = 0.0,
                  iter_ref: int = 0) -> KKTBackend:
    """Default backend: the stage-chain Riccati and the chain residual
    topology.  ``use_pallas`` takes the hand-written kernels
    (:func:`make_kernel_chain_kkt`), else the plain batched Riccati of
    :mod:`.riccati`, which alone carries ``iter_ref`` refinement (the
    reference's ITER_REF: full-precision Newton residuals, a correction
    re-solve with the retained factor and Pb recomputed)."""
    NU = dims.NU
    ng_stages = tuple(n for n in range(dims.N + 1) if dims.ng[n] > 0)

    if use_pallas:
        fs, resolve, carry_factor = make_kernel_chain_kkt(qp, ng_stages, NU)

        def factor_solve(Qx_b, Qx_g, g_eff, rhs_b):
            dvec = _scatter_box(oh, Qx_b) + qp.pad_diag + reg_eps
            return fs(dvec, Qx_g * qp.ng_mask, g_eff, rhs_b)
    else:

        def _refine(L, H_eff, g_eff, rhs_b, z, pi):
            for _ in range(iter_ref):
                rq, rb = riccati.kkt_residuals(H_eff, g_eff, qp.F, rhs_b, z,
                                               pi, NU)
                dsol, _ = riccati.solve(L, rq, qp.F, rb, NU)
                z = z + dsol.z
                pi = pi + dsol.pi
            return z, pi

        def factor_solve(Qx_b, Qx_g, g_eff, rhs_b):
            H_eff = _build_Heff(qp, oh, Qx_b, Qx_g, reg_eps, ng_stages)
            sol, L, _, _, Pb = riccati.factor_solve(H_eff, g_eff, qp.F,
                                                    rhs_b, NU)
            z, pi = _refine(L, H_eff, g_eff, rhs_b, sol.z, sol.pi)
            return z, pi, ((L, Pb, H_eff) if iter_ref else (L, Pb))

        def resolve(fstate, g_eff, rhs_b):
            L, Pb = fstate[:2]
            sol, _ = riccati.solve(L, g_eff, qp.F, rhs_b, NU, Pb=Pb)
            if iter_ref:
                return _refine(L, fstate[2], g_eff, rhs_b, sol.z, sol.pi)
            return sol.z, sol.pi

        def carry_factor(fstate):
            return fstate[0]

    def residuals(z, pi, lam_b, t_b, lam_g, t_g, rhs_b):
        return compute_residuals(dataclasses.replace(qp, b=rhs_b), oh,
                                 mu_scal, z, pi, lam_b, t_b, lam_g, t_g)

    return KKTBackend(factor_solve=factor_solve, resolve=resolve,
                      residuals=residuals, carry_factor=carry_factor)


# --------------------------------------------------------------------------
# the solver
# --------------------------------------------------------------------------


def _gate(m, new, old):
    """Per instance, ``new`` where ``m`` (B,) holds, else ``old`` (two
    IPMState or two Residuals): a select, never a multiply."""
    out = []
    for f, a, b in zip(new._fields, new, old):
        if f == "carry":
            out.append(None if a is None else KKTCarry(*[
                torch.where(_bc(m, x), x, y) for x, y in zip(a, b)]))
        else:
            out.append(torch.where(_bc(m, a), a, b))
    return type(new)(*out)


def solve(dims: OCPDims, qp: OCPQP, cfg: IPMConfig, z0=None, pi0=None,
          return_carry: bool = False, backend: KKTBackend | None = None,
          iterate0=None, rti_mode: bool = False):
    """Solve a batch of hard-constrained OCP QPs (every leaf of ``qp`` with
    a leading instance axis B; ``z0`` (B, N+1, NZ) / ``pi0`` (B, N, NX)
    with ``cfg.warm_start``), as ``jax.vmap(hpmpc_tpu.models.ipm.solve)``:
    the reference's ``d_ip2_res_mpc_hard_tv`` with its per-iteration
    ``stat`` trace ``[sigma, alpha_aff, mu_aff, alpha, mu]`` and exit
    conditions, per instance.

    ``cfg.use_pallas`` (without ``iter_ref``, which takes the plain
    backend, as in JAX) factors and re-solves with the hand-written kernels;
    else the plain batched Riccati.  With ``return_carry=True`` also
    returns a :class:`KKTCarry` (batch-first).  ``backend`` replaces the
    chain backend.  ``iterate0`` = ``(z, pi, lam_b, t_b, lam_g, t_g)``
    starts from that full iterate (:func:`init_vars`); ``rti_mode`` skips
    phase 1 and runs phase 2 for exactly ``cfg.k_max`` iterations with no
    tolerance exits (the reference's ``single_newton_step``,
    ``d_ip2_res_hard.c:1686``): :func:`solve_single_newton`.

    Runs on the device of ``qp``; float32 matrix products at full
    precision (the package pins TF32 off)."""
    dt, dev = qp.dtype, qp.device
    B = qp.b.shape[0]
    N, NU, NZ, NX = dims.N, dims.NU, dims.NZ, dims.NX
    n_constr = dims.n_constr
    k_max = int(cfg.k_max)

    if n_constr == 0:
        # no inequality constraints: one Riccati solve (reference :435-450)
        sol, L, _, _, _ = riccati.factor_solve(
            _diag_add(qp.H, qp.pad_diag), qp.g * qp.z_mask, qp.F, qp.b, NU)
        lam_b0 = torch.zeros(B, N + 1, 2, dims.NB, dtype=dt, device=dev)
        lam_g0 = torch.zeros(B, N + 1, 2, dims.NG, dtype=dt, device=dev)
        zero_i = torch.zeros(B, dtype=torch.int32, device=dev)
        sol_unc = IPMSolution(
            z=sol.z * qp.z_mask, pi=sol.pi * qp.x_mask[:, 1:], lam_b=lam_b0,
            t_b=torch.ones_like(lam_b0), lam_g=lam_g0,
            t_g=torch.ones_like(lam_g0), kk=zero_i, status=zero_i.clone(),
            stat=torch.zeros(B, k_max, 5, dtype=dt, device=dev),
            inf_norm_res=torch.zeros(B, 4, dtype=dt, device=dev))
        if return_carry:
            return sol_unc, KKTCarry(
                L, sol_unc.z, sol_unc.pi, lam_b0, torch.ones_like(lam_b0),
                lam_g0, torch.ones_like(lam_g0))
        return sol_unc

    scal = lambda v: torch.tensor(v, dtype=dt, device=dev)  # noqa: E731
    mu_scal = scal(1.0 / n_constr)
    mu_tol = scal(cfg.mu_tol)
    mu_tol_low = scal(max(cfg.mu_tol, cfg.mu_switch))
    alpha_min = scal(cfg.alpha_min)

    oh = _box_onehot(qp)
    mb, mg = qp.nb_mask, qp.ng_mask
    mb2, mg2 = mb[:, :, None, :], mg[:, :, None, :]
    ng_stages = tuple(n for n in range(N + 1) if dims.ng[n] > 0)
    kiota = torch.arange(k_max, device=dev)

    if backend is None:
        backend = chain_backend(
            dims, qp, oh, mu_scal,
            use_pallas=cfg.use_pallas and not cfg.iter_ref,
            reg_eps=cfg.reg_eps, iter_ref=cfg.iter_ref)

    carry0 = None
    if return_carry:
        zeros = lambda *s: torch.zeros(*s, dtype=dt, device=dev)  # noqa: E731
        carry0 = KKTCarry(
            L=zeros(B, N + 1, NZ, NZ),
            z_bkp=zeros(B, N + 1, NZ), pi_bkp=zeros(B, N, NX),
            lam_b_bkp=zeros(B, N + 1, 2, dims.NB),
            t_b_bkp=torch.ones(B, N + 1, 2, dims.NB, dtype=dt, device=dev),
            lam_g_bkp=zeros(B, N + 1, 2, dims.NG),
            t_g_bkp=torch.ones(B, N + 1, 2, dims.NG, dtype=dt, device=dev))
    state0 = init_vars(dims, qp, cfg, z0=z0, pi0=pi0, carry0=carry0,
                       iterate0=iterate0)

    def alpha_all(dtb, dtg, dlam_b, dlam_g, t_b, t_g, lam_b, lam_g):
        a = torch.ones(B, dtype=dt, device=dev)
        a = _min_ratio(a, lam_b, dlam_b, mb2 * torch.ones_like(lam_b))
        a = _min_ratio(a, t_b, dtb, mb2 * torch.ones_like(t_b))
        a = _min_ratio(a, lam_g, dlam_g, mg2 * torch.ones_like(lam_g))
        return _min_ratio(a, t_g, dtg, mg2 * torch.ones_like(t_g))

    def mu_pred(alpha, lam_b, dlam_b, t_b, dtb, lam_g, dlam_g, t_g, dtg):
        a4 = alpha[:, None, None, None]
        return _sum_lt(lam_b + a4 * dlam_b, t_b + a4 * dtb,
                       lam_g + a4 * dlam_g, t_g + a4 * dtg, mb, mg) * mu_scal

    def lam_max(lam_b, lam_g):
        return torch.maximum(_absmax(lam_b), _absmax(lam_g))

    def finish(s, fstate, row, z_new, pi_new, lam_b_new, t_b_new, lam_g_new,
               t_g_new, a2, sigma):
        """The state after a step, gated by the breakdown guard (a refused
        step keeps ``s`` with alpha 0); also returns the guard's verdict."""
        mu_new = row[:, 4]
        stat = torch.where((kiota[None, :] == s.kk[:, None])[..., None],
                           row[:, None, :], s.stat)
        carry = (KKTCarry(backend.carry_factor(fstate), s.z, s.pi, s.lam_b, s.t_b, s.lam_g,
                          s.t_g) if return_carry else s.carry)
        lmx_new = lam_max(lam_b_new, lam_g_new)
        s_new = IPMState(
            z=z_new, pi=pi_new, lam_b=lam_b_new, t_b=t_b_new,
            lam_g=lam_g_new, t_g=t_g_new, mu=mu_new, alpha=a2, kk=s.kk + 1,
            sigma=sigma, stat=stat, carry=carry,
            lam_ref=anchor_lam_ref(s.lam_ref, mu_new, lmx_new))
        ok = step_ok(mu_new, s.mu, lmx_new, lam_max(s.lam_b, s.lam_g),
                     lam_ref=s.lam_ref)
        refused = s._replace(alpha=torch.zeros_like(s.alpha))
        return ok, _gate(ok, s_new, refused)

    # -------------------- phase 1: no residuals --------------------

    def dt_dlam_phase1(z_new, t_b, t_g, lam_b, t_inv_b, t_inv_g, dlam0_b,
                       dlam0_g, lam_g):
        """dt from the full new iterate; dlam = dlam0 - lam*t_inv*dt - lam
        (compute_alpha, d_aux_ip_hard_lib4.c:489-614)."""
        zb = _gather_box(oh, z_new)
        dtb = torch.stack([zb - qp.d_lb - t_b[:, :, 0],
                           -zb + qp.d_ub - t_b[:, :, 1]], 2) * mb2
        cz = _cz(qp, z_new)
        dtg = torch.stack([cz - qp.d_lg - t_g[:, :, 0],
                           -cz + qp.d_ug - t_g[:, :, 1]], 2) * mg2
        dlam_b = (dlam0_b - lam_b * t_inv_b * dtb - lam_b) * mb2
        dlam_g = (dlam0_g - lam_g * t_inv_g * dtg - lam_g) * mg2
        return dtb, dtg, dlam_b, dlam_g

    def phase1_body(s: IPMState) -> IPMState:
        t_inv_b = torch.where(mb2 > 0, 1.0 / s.t_b, 0.0)
        t_inv_g = torch.where(mg2 > 0, 1.0 / s.t_g, 0.0)
        lamt_b = s.lam_b * t_inv_b
        lamt_g = s.lam_g * t_inv_g

        # hessian/gradient fold (update_hessian with sigma_mu=0, :217)
        Qx_b = (lamt_b[:, :, 0] + lamt_b[:, :, 1]) * mb
        Qx_g = (lamt_g[:, :, 0] + lamt_g[:, :, 1]) * mg
        qx_b = (s.lam_b[:, :, 1] - lamt_b[:, :, 1] * qp.d_ub
                - s.lam_b[:, :, 0] - lamt_b[:, :, 0] * qp.d_lb) * mb
        qx_g = (s.lam_g[:, :, 1] - lamt_g[:, :, 1] * qp.d_ug
                - s.lam_g[:, :, 0] - lamt_g[:, :, 0] * qp.d_lg) * mg
        g_eff = _build_geff(qp, oh, qp.g * qp.z_mask, qx_b, qx_g, ng_stages)

        # affine (predictor) solve: the full new iterate
        dz, dpi, fstate = backend.factor_solve(Qx_b, Qx_g, g_eff, qp.b)

        dtb, dtg, dlam_b, dlam_g = dt_dlam_phase1(
            dz, s.t_b, s.t_g, s.lam_b, t_inv_b, t_inv_g,
            torch.zeros_like(s.lam_b), torch.zeros_like(s.lam_g), s.lam_g)
        alpha_aff = alpha_all(dtb, dtg, dlam_b, dlam_g, s.t_b, s.t_g,
                              s.lam_b, s.lam_g)
        if cfg.corrector_low:
            mu_aff = mu_pred(alpha_aff * 0.995, s.lam_b, dlam_b, s.t_b, dtb,
                             s.lam_g, dlam_g, s.t_g, dtg)
            sigma = (mu_aff / s.mu) ** 3

            # corrector gradient update (update_gradient, :387)
            sm4 = (sigma * s.mu)[:, None, None, None]
            dlam2_b = t_inv_b * (sm4 - dlam_b * dtb) * mb2
            dlam2_g = t_inv_g * (sm4 - dlam_g * dtg) * mg2
            qx_b2 = qx_b + (dlam2_b[:, :, 1] - dlam2_b[:, :, 0]) * mb
            qx_g2 = qx_g + (dlam2_g[:, :, 1] - dlam2_g[:, :, 0]) * mg
            g_eff2 = _build_geff(qp, oh, qp.g * qp.z_mask, qx_b2, qx_g2,
                                 ng_stages)

            dz2, dpi2 = backend.resolve(fstate, g_eff2, qp.b)

            dtb, dtg, dlam_b, dlam_g = dt_dlam_phase1(
                dz2, s.t_b, s.t_g, s.lam_b, t_inv_b, t_inv_g, dlam2_b,
                dlam2_g, s.lam_g)
            alpha2 = alpha_all(dtb, dtg, dlam_b, dlam_g, s.t_b, s.t_g,
                               s.lam_b, s.lam_g)
        else:
            # predictor-only step (reference CORRECTOR_LOW=0, :643): sigma
            # stays stale, alpha_aff/mu_aff are recorded as 0
            dz2, dpi2, alpha2 = dz, dpi, alpha_aff
            mu_aff = alpha_aff = torch.zeros_like(s.mu)
            sigma = s.sigma
        a2 = alpha2 * 0.995
        a3, a4 = a2[:, None, None], a2[:, None, None, None]
        lam_b_new = s.lam_b + a4 * dlam_b
        t_b_new = s.t_b + a4 * dtb
        lam_g_new = s.lam_g + a4 * dlam_g
        t_g_new = s.t_g + a4 * dtg
        mu_new = _sum_lt(lam_b_new, t_b_new, lam_g_new, t_g_new, mb,
                         mg) * mu_scal
        row = torch.stack([sigma, alpha_aff, mu_aff, alpha2, mu_new], 1)
        return finish(s, fstate, row, s.z + a3 * (dz2 - s.z),
                      s.pi + a3 * (dpi2 - s.pi), lam_b_new, t_b_new,
                      lam_g_new, t_g_new, a2, sigma)[1]

    s = state0
    while not rti_mode:    # RTI: no phase 1 (single_newton_step, :1686)
        live = (s.kk < k_max) & (s.mu > mu_tol_low) & (s.alpha >= alpha_min)
        if not bool(live.any()):
            break
        s = _gate(live, phase1_body(s), s)

    # -------------------- phase 2: with residuals --------------------

    res = backend.residuals(s.z, s.pi, s.lam_b, s.t_b, s.lam_g, s.t_g, qp.b)
    s = s._replace(mu=res.mu)

    def dt_dlam_res(dz, res, t_inv_b, t_inv_g, lam_b, lam_g):
        """delta slacks from the delta iterate and the constraint residuals
        (compute_alpha_res, d_aux_ip_hard_lib4.c:1180-1313)."""
        dzb = _gather_box(oh, dz)
        dtb = torch.stack([dzb - res.rd_b[:, :, 0],
                           -dzb + res.rd_b[:, :, 1]], 2) * mb2
        cdz = _cz(qp, dz)
        dtg = torch.stack([cdz - res.rd_g[:, :, 0],
                           -cdz + res.rd_g[:, :, 1]], 2) * mg2
        dlam_b = -t_inv_b * (lam_b * dtb + res.rm_b) * mb2
        dlam_g = -t_inv_g * (lam_g * dtg + res.rm_g) * mg2
        return dtb, dtg, dlam_b, dlam_g

    def phase2_body(s: IPMState, res: Residuals):
        t_inv_b = torch.where(mb2 > 0, 1.0 / s.t_b, 0.0)
        t_inv_g = torch.where(mg2 > 0, 1.0 / s.t_g, 0.0)

        # update_hessian_gradient_res (:954)
        Qx_b = (t_inv_b[:, :, 0] * s.lam_b[:, :, 0]
                + t_inv_b[:, :, 1] * s.lam_b[:, :, 1]) * mb
        Qx_g = (t_inv_g[:, :, 0] * s.lam_g[:, :, 0]
                + t_inv_g[:, :, 1] * s.lam_g[:, :, 1]) * mg

        def qx_from(rm_b, rm_g):
            qxb = (t_inv_b[:, :, 0] * (rm_b[:, :, 0]
                                       - s.lam_b[:, :, 0] * res.rd_b[:, :, 0])
                   - t_inv_b[:, :, 1] * (rm_b[:, :, 1]
                                         + s.lam_b[:, :, 1]
                                         * res.rd_b[:, :, 1])) * mb
            qxg = (t_inv_g[:, :, 0] * (rm_g[:, :, 0]
                                       - s.lam_g[:, :, 0] * res.rd_g[:, :, 0])
                   - t_inv_g[:, :, 1] * (rm_g[:, :, 1]
                                         + s.lam_g[:, :, 1]
                                         * res.rd_g[:, :, 1])) * mg
            return qxb, qxg

        qx_b, qx_g = qx_from(res.rm_b, res.rm_g)
        g_eff = _build_geff(qp, oh, res.rq, qx_b, qx_g, ng_stages)

        # the right-hand side is this iteration's rb, so Pb changes every
        # iteration; the corrector re-solve reuses the factor step's Pb
        dz, dpi, fstate = backend.factor_solve(Qx_b, Qx_g, g_eff, res.rb)

        dtb, dtg, dlam_b, dlam_g = dt_dlam_res(dz, res, t_inv_b, t_inv_g,
                                               s.lam_b, s.lam_g)
        alpha_aff = alpha_all(dtb, dtg, dlam_b, dlam_g, s.t_b, s.t_g,
                              s.lam_b, s.lam_g)
        if cfg.corrector_high:
            mu_aff = mu_pred(alpha_aff * 0.995, s.lam_b, dlam_b, s.t_b, dtb,
                             s.lam_g, dlam_g, s.t_g, dtg)
            sigma = (mu_aff / s.mu) ** 3

            # centering correction folded into res_m (:1512) + gradient
            sm4 = (sigma * s.mu)[:, None, None, None]
            rm_b2 = res.rm_b + (dtb * dlam_b - sm4) * mb2
            rm_g2 = res.rm_g + (dtg * dlam_g - sm4) * mg2
            qx_b2, qx_g2 = qx_from(rm_b2, rm_g2)
            g_eff2 = _build_geff(qp, oh, res.rq, qx_b2, qx_g2, ng_stages)
            res2 = res._replace(rm_b=rm_b2, rm_g=rm_g2)

            dz2, dpi2 = backend.resolve(fstate, g_eff2, res.rb)

            dtb, dtg, dlam_b, dlam_g = dt_dlam_res(dz2, res2, t_inv_b,
                                                   t_inv_g, s.lam_b, s.lam_g)
            alpha2 = alpha_all(dtb, dtg, dlam_b, dlam_g, s.t_b, s.t_g,
                               s.lam_b, s.lam_g)
        else:
            # predictor-only residual step (reference CORRECTOR_HIGH=0,
            # d_ip2_res_hard.c:1003)
            dz2, dpi2, alpha2 = dz, dpi, alpha_aff
            mu_aff = alpha_aff = torch.zeros_like(s.mu)
            sigma = s.sigma
        a2 = alpha2 * 0.995
        a3, a4 = a2[:, None, None], a2[:, None, None, None]
        z_new, pi_new = s.z + a3 * dz2, s.pi + a3 * dpi2
        lam_b_new = s.lam_b + a4 * dlam_b
        t_b_new = s.t_b + a4 * dtb
        lam_g_new = s.lam_g + a4 * dlam_g
        t_g_new = s.t_g + a4 * dtg
        res_new = backend.residuals(z_new, pi_new, lam_b_new, t_b_new,
                                    lam_g_new, t_g_new, qp.b)
        row = torch.stack([sigma, alpha_aff, mu_aff, alpha2, res_new.mu], 1)
        ok, s_new = finish(s, fstate, row, z_new, pi_new, lam_b_new, t_b_new,
                           lam_g_new, t_g_new, a2, sigma)
        return s_new, _gate(ok, res_new, res)

    while True:
        live = s.kk < k_max
        if not rti_mode:   # RTI: a fixed count, no tolerance exits
            live = live & (s.mu > mu_tol) & (s.alpha >= alpha_min)
        if not bool(live.any()):
            break
        s_new, res_new = phase2_body(s, res)
        s, res = _gate(live, s_new, s), _gate(live, res_new, res)

    status = torch.where(s.mu <= mu_tol, 0,
                         torch.where(s.kk >= k_max, 1, 2)).to(torch.int32)
    inf_norm_res = torch.stack([
        _absmax(res.rq), _absmax(res.rb),
        torch.maximum(_absmax(res.rd_b), _absmax(res.rd_g)), res.mu], 1)
    solution = IPMSolution(
        z=s.z, pi=s.pi, lam_b=s.lam_b, t_b=s.t_b, lam_g=s.lam_g, t_g=s.t_g,
        kk=s.kk, status=status, stat=s.stat, inf_norm_res=inf_norm_res)
    if return_carry:
        return solution, s.carry
    return solution


# --------------------------------------------------------------------------
# re-solve with the retained factorization for a new right-hand side
# (d_kkt_solve_new_rhs_res_mpc_hard_tv, d_ip2_res_hard.c:1922)
# --------------------------------------------------------------------------


def kkt_solve_new_rhs(dims: OCPDims, qp_new: OCPQP,
                      carry: KKTCarry) -> IPMSolution:
    """One warm Newton step for changed vector data (b, g, bounds) reusing
    the Riccati factor of the last IPM iteration (batch-first ``carry``,
    as :func:`solve` returns it with ``return_carry``), as
    :func:`hpmpc_tpu.models.ipm.kkt_solve_new_rhs`: the backup iterate, its
    residuals against the new data (:2193), the constraint-gradient fold
    (``d_update_gradient_res``, :2214), the triangular re-solve with Pb
    recomputed for the new rb (:2223), dt/dlam
    (``d_compute_dt_dlam_res``, :2234) and a full step (alpha = 1, :2237).
    Matrix data (A, B, Q, R, S, C) must be unchanged.  kk = 1, status 0,
    one zero stat row, per instance."""
    qp = qp_new
    dt, dev = qp.dtype, qp.device
    B = qp.b.shape[0]
    mu_scal = torch.tensor(1.0 / max(dims.n_constr, 1), dtype=dt, device=dev)
    oh = _box_onehot(qp)
    mb2, mg2 = qp.nb_mask[:, :, None, :], qp.ng_mask[:, :, None, :]
    z, pi = carry.z_bkp, carry.pi_bkp
    lam_b, t_b = carry.lam_b_bkp, carry.t_b_bkp
    lam_g, t_g = carry.lam_g_bkp, carry.t_g_bkp

    res = compute_residuals(qp, oh, mu_scal, z, pi, lam_b, t_b, lam_g, t_g)
    t_inv_b = torch.where(mb2 > 0, 1.0 / t_b, 0.0)
    t_inv_g = torch.where(mg2 > 0, 1.0 / t_g, 0.0)
    qx_b = (t_inv_b[:, :, 0] * (res.rm_b[:, :, 0]
                                - lam_b[:, :, 0] * res.rd_b[:, :, 0])
            - t_inv_b[:, :, 1] * (res.rm_b[:, :, 1]
                                  + lam_b[:, :, 1] * res.rd_b[:, :, 1])
            ) * qp.nb_mask
    qx_g = (t_inv_g[:, :, 0] * (res.rm_g[:, :, 0]
                                - lam_g[:, :, 0] * res.rd_g[:, :, 0])
            - t_inv_g[:, :, 1] * (res.rm_g[:, :, 1]
                                  + lam_g[:, :, 1] * res.rd_g[:, :, 1])
            ) * qp.ng_mask
    ng_stages = tuple(n for n in range(dims.N + 1) if dims.ng[n] > 0)
    g_eff = _build_geff(qp, oh, res.rq, qx_b, qx_g, ng_stages)
    sol, _ = riccati.solve(carry.L, g_eff, qp.F, res.rb, dims.NU)
    dz, dpi = sol.z, sol.pi

    dzb = _gather_box(oh, dz)
    dtb = torch.stack([dzb - res.rd_b[:, :, 0],
                       -dzb + res.rd_b[:, :, 1]], 2) * mb2
    cdz = _cz(qp, dz)
    dtg = torch.stack([cdz - res.rd_g[:, :, 0],
                       -cdz + res.rd_g[:, :, 1]], 2) * mg2
    dlam_b = -t_inv_b * (lam_b * dtb + res.rm_b) * mb2
    dlam_g = -t_inv_g * (lam_g * dtg + res.rm_g) * mg2

    new = (z + dz, pi + dpi, lam_b + dlam_b, t_b + dtb, lam_g + dlam_g,
           t_g + dtg)
    r = compute_residuals(qp, oh, mu_scal, *new)
    inf_norm_res = torch.stack([
        _absmax(r.rq), _absmax(r.rb),
        torch.maximum(_absmax(r.rd_b), _absmax(r.rd_g)), r.mu], 1)
    return IPMSolution(
        *new, kk=torch.ones(B, dtype=torch.int32, device=dev),
        status=torch.zeros(B, dtype=torch.int32, device=dev),
        stat=torch.zeros(B, 1, 5, dtype=dt, device=dev),
        inf_norm_res=inf_norm_res)


def solve_single_newton(dims: OCPDims, qp: OCPQP, cfg: IPMConfig, z0, pi0,
                        lam_b0, t_b0, lam_g0, t_g0,
                        return_carry: bool = False):
    """RTI-style warm Newton iterations
    (``d_ip2_res_mpc_hard_tv_single_newton_step``, ``d_ip2_res_hard.c:1348``):
    from the given full iterate (batch-first, typically the previous
    solution), exactly ``cfg.k_max`` residual-phase iterations with no
    tolerance exits (``k_max=1``: classic RTI)."""
    return solve(dims, qp, cfg,
                 iterate0=(z0, pi0, lam_b0, t_b0, lam_g0, t_g0),
                 rti_mode=True, return_carry=return_carry)
