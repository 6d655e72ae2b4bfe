"""Soft-constraint containers and the soft KKT residuals (PyTorch twin of
the matching parts of :mod:`hpmpc_tpu.models.ipm_soft`).

A soft constraint ``lb_i - s_lo <= z[idx_i] <= ub_i + s_up`` with slacks
``s_lo, s_up >= 0`` and the penalty ``1/2 s' diag(Z) s + z_lin' s``
carries four slack/multiplier pairs, ordered [lower, upper, s_lo >= 0,
s_up >= 0] (the reference's ``d_ip2_mpc_soft_tv``,
``mpc_solvers/d_ip2_soft.c:83``).  The batched solver is
:mod:`.ipm_soft_lanes`; :func:`compute_residuals` is its float64 oracle,
written batch-native (every leaf carries a leading instance axis).  The
structured soft ``solve`` is not ported yet (ROADMAP Queue 1 #10).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ocp import OCPQP


class SoftSpec(NamedTuple):
    """Soft-constraint data; every leaf may carry a leading batch axis.

    idxbs: (N+1, NS) int32 padded-z coordinates of the softly bounded
    entries; d_lbs/d_ubs: (N+1, NS) soft bounds; Z: (N+1, 2, NS) quadratic
    slack penalties [lower, upper]; z_lin: (N+1, 2, NS) linear slack
    penalties; ns_mask: (N+1, NS) validity."""

    idxbs: torch.Tensor
    d_lbs: torch.Tensor
    d_ubs: torch.Tensor
    Z: torch.Tensor
    z_lin: torch.Tensor
    ns_mask: torch.Tensor


class SoftSolution(NamedTuple):
    """Batched soft solution: every field has a leading instance axis B."""

    z: torch.Tensor  # (B, N+1, NZ)
    pi: torch.Tensor  # (B, N, NX)
    lam_b: torch.Tensor  # (B, N+1, 2, NB)
    t_b: torch.Tensor
    lam_g: torch.Tensor  # (B, N+1, 2, NG)
    t_g: torch.Tensor
    lam_s: torch.Tensor  # (B, N+1, 4, NS) [lower, upper, s_lo>=0, s_up>=0]
    t_s: torch.Tensor
    kk: torch.Tensor  # (B,) int32
    status: torch.Tensor  # (B,) int32: 0 converged, 1 max iters, 2 frozen
    stat: torch.Tensor  # (B, k_max, 5) [sigma, alpha_aff, mu_aff, alpha, mu]


class SoftResiduals(NamedTuple):
    rq: torch.Tensor  # (B, N+1, NZ) z-stationarity
    rz: torch.Tensor  # (B, N+1, 2, NS) slack stationarity
    rb: torch.Tensor  # (B, N, NX)
    rd_b: torch.Tensor  # (B, N+1, 2, NB)
    rd_g: torch.Tensor  # (B, N+1, 2, NG)
    rd_s: torch.Tensor  # (B, N+1, 2, NS) slacked-bound gaps
    mu: torch.Tensor  # (B,)


def _onehot(idx, mask, NZ, dt):
    """(..., K, NZ) selection of the coordinates ``idx`` under ``mask``."""
    return torch.nn.functional.one_hot(idx.long(), NZ).to(dt) * mask[..., None]


def compute_residuals(dims, qp: OCPQP, soft: SoftSpec,
                      sol: SoftSolution) -> SoftResiduals:
    """Exact KKT residuals of a batch of soft-constrained QPs at ``sol``
    (the reference's ``d_res_mpc_soft_tv``, ``d_res_ip_soft.c:38``; the
    JAX package's :func:`hpmpc_tpu.models.ipm_soft.compute_residuals`,
    written for a leading batch axis instead of vmap).  The 3rd/4th slack
    families are the slack variables s_lo/s_up.  ``mu`` uses the
    2nb + 2ng + 4ns scaling of the solver's stat trace."""
    N, NU, NZ = dims.N, dims.NU, dims.NZ
    dt = qp.dtype
    z, pi = sol.z, sol.pi
    lam_b, t_b, lam_g, t_g = sol.lam_b, sol.t_b, sol.lam_g, sol.t_g
    lam_s, t_s = sol.lam_s, sol.t_s
    mb, mg, ms = qp.nb_mask, qp.ng_mask, soft.ns_mask
    oh_b = _onehot(qp.idxb, mb, NZ, dt)
    oh_s = _onehot(soft.idxbs, ms, NZ, dt)
    s_lo, s_up = t_s[:, :, 2], t_s[:, :, 3]

    # z-stationarity: the hard terms, plus the soft bound multipliers
    # scattered at the soft coordinates
    rq = qp.g * qp.z_mask + torch.einsum("bnzw,bnw->bnz", qp.H, z)
    rq[:, 1:, NU:] += -pi
    rq[:, :N] += torch.einsum("bnzx,bnx->bnz", qp.F, pi)
    rq = rq + torch.einsum("bnkz,bnk->bnz", oh_b,
                           (lam_b[:, :, 1] - lam_b[:, :, 0]) * mb)
    rq = rq + torch.einsum("bngz,bng->bnz", qp.C,
                           (lam_g[:, :, 1] - lam_g[:, :, 0]) * mg)
    rq = rq + torch.einsum("bnkz,bnk->bnz", oh_s,
                           (lam_s[:, :, 1] - lam_s[:, :, 0]) * ms)
    rq = rq * qp.z_mask

    # slack stationarity (d_res_ip_soft.c:150): Z s + z_lin - lam_bound
    # - lam_nonneg, per side
    rz = torch.stack(
        [soft.z_lin[..., 0, :] + soft.Z[..., 0, :] * s_lo - lam_s[:, :, 0]
         - lam_s[:, :, 2],
         soft.z_lin[..., 1, :] + soft.Z[..., 1, :] * s_up - lam_s[:, :, 1]
         - lam_s[:, :, 3]], 2) * ms[..., None, :]

    rb = qp.b + torch.einsum("bnzx,bnz->bnx", qp.F, z[:, :N]) - z[:, 1:, NU:]
    rb = rb * qp.x_mask[..., 1:, :]

    zb = torch.einsum("bnkz,bnz->bnk", oh_b, z)
    rd_b = torch.stack([qp.d_lb - zb + t_b[:, :, 0],
                        qp.d_ub - zb - t_b[:, :, 1]], 2) * mb[..., None, :]
    cz = torch.einsum("bngz,bnz->bng", qp.C, z)
    rd_g = torch.stack([qp.d_lg + t_g[:, :, 0] - cz,
                        qp.d_ug - t_g[:, :, 1] - cz], 2) * mg[..., None, :]
    # slacked soft bounds: z_s >= d_lbs - s_lo, z_s <= d_ubs + s_up
    zs = torch.einsum("bnkz,bnz->bnk", oh_s, z)
    rd_s = torch.stack([soft.d_lbs - s_lo - zs + t_s[:, :, 0],
                        soft.d_ubs + s_up - zs - t_s[:, :, 1]],
                       2) * ms[..., None, :]

    B = z.shape[0]
    mu = ((lam_b * t_b * mb[..., None, :]).reshape(B, -1).sum(1)
          + (lam_g * t_g * mg[..., None, :]).reshape(B, -1).sum(1)
          + (lam_s * t_s * ms[..., None, :]).reshape(B, -1).sum(1)) / (
        dims.n_constr + 4.0 * ms.reshape(B, -1).sum(1))
    return SoftResiduals(rq=rq, rz=rz, rb=rb, rd_b=rd_b, rd_g=rd_g,
                         rd_s=rd_s, mu=mu)
