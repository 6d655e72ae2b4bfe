"""Host-side f64 KKT residual oracle for batched hard-IPM solutions.

Numpy-only copy of :mod:`hpmpc_tpu.utils.resid64` (the JAX package's
``__init__`` imports jax, so the port cannot import it); leaves may be
numpy arrays or tensors on any device, which are copied to the host.

The engines evaluate ``inf_norm_res`` on the device in the working dtype
(f32 at the flagship); near an ill-conditioned stalled iterate the f32 evaluation of
``rq = g + H z - pi + F' pi + ...`` can be dominated by cancellation noise
that scales with the DUAL magnitudes, not with the true backward error —
two equally-converged engines can then report residuals orders of
magnitude apart.  This module recomputes the TRUE residuals of a returned
primal-dual iterate in f64 numpy on the host — the measurement the
size-sweep parity gates trust.

Residual formulas mirror the JAX package's ``models.ipm.compute_residuals``
(reference ``mpc_solvers/c99/d_res_ip_res_hard.c:39``) exactly, with every
product accumulated in f64.

Also provides the component-wise backward-error DENOMINATORS (sums of
absolute values of the terms whose cancellation forms each residual), so
callers can assert scale-relative bounds: ``rq_rel = |rq|_inf / den_q`` is
the classic normwise backward error — "converged to f32 accuracy" means
``rq_rel ~ O(f32 eps * growth)`` independently of problem conditioning.

Every qp leaf may carry the leading batch axis OR be shared across the
batch (unbatched) — benchmark batches that differ only in ``b`` can pass
the stage data once, which keeps the f64 host copies at large NZ to
megabytes instead of the gigabytes a materialized broadcast would cost.
"""

from __future__ import annotations

import numpy as np


def _host(x):
    if hasattr(x, "detach"):  # a torch tensor, possibly on the card
        return x.detach().cpu().numpy()
    return x


def _np64(x):
    return np.asarray(_host(x), np.float64)


class _Leaf:
    """A qp leaf with known unbatched rank; exposes batched-style access."""

    def __init__(self, x, nd_unb, to64=True):
        self.a = _np64(x) if to64 else np.asarray(_host(x))
        self.batched = self.a.ndim == nd_unb + 1

    def ein(self, sub):
        """Einsum subscript for this leaf: prefix 'b' only if batched."""
        return ("b" + sub) if self.batched else sub

    def bview(self):
        """(1, ...) view usable in broadcasted elementwise ops."""
        return self.a if self.batched else self.a[None]


def true_residuals(qp, z, pi, lam_b, t_b, lam_g, t_g):
    """f64 per-instance residual infinity norms of a batched solution.

    ``qp``: an :class:`~hpmpc_tpu_torch.ocp.OCPQP` whose leaves carry a leading
    batch axis B or are shared (see module docstring).  ``z`` (B, N+1,
    NZ), ``pi`` (B, N, NX), ``lam_b``/``t_b`` (B, N+1, 2, NB),
    ``lam_g``/``t_g`` (B, N+1, 2, NG).

    Returns ``(res, rel)``: two (B, 4) f64 arrays of {|rq|inf, |rb|inf,
    |rd|inf, mu} — absolute, and relative (rq/rb normalized by their
    backward-error denominators, floor 1.0; rd/mu reported as-is).
    """
    z, pi = _np64(z), _np64(pi)
    lam_b, t_b = _np64(lam_b), _np64(t_b)
    lam_g, t_g = _np64(lam_g), _np64(t_g)

    B = z.shape[0]
    N = pi.shape[1]
    NZ = z.shape[-1]
    NU = NZ - pi.shape[-1]

    H = _Leaf(qp.H, 3)
    g = _Leaf(qp.g, 2)
    F = _Leaf(qp.F, 3)
    b = _Leaf(qp.b, 2)
    C = _Leaf(qp.C, 3)
    d_lb, d_ub = _Leaf(qp.d_lb, 2), _Leaf(qp.d_ub, 2)
    d_lg, d_ug = _Leaf(qp.d_lg, 2), _Leaf(qp.d_ug, 2)
    mb, mg = _Leaf(qp.nb_mask, 2), _Leaf(qp.ng_mask, 2)
    z_mask, x_mask = _Leaf(qp.z_mask, 2), _Leaf(qp.x_mask, 2)
    idxb = _Leaf(qp.idxb, 2, to64=False)

    def ein(spec_map, out, *leaves_and_arrays):
        """np.einsum with per-operand 'b' prefixes.

        ``spec_map``: list of (subscript, operand) where operand is a
        _Leaf (prefix decided by .batched) or a plain batched ndarray
        (always prefixed).  ``out``: output subscript (always 'b'-led).
        """
        subs, ops = [], []
        for sub, op in spec_map:
            if isinstance(op, _Leaf):
                subs.append(op.ein(sub))
                ops.append(op.a)
            else:
                subs.append("b" + sub)
                ops.append(op)
        return np.einsum(",".join(subs) + "->" + out, *ops,
                         optimize=True)

    # one-hot box scatter (unbatched or batched to match idxb)
    ib = idxb.a
    if idxb.batched:
        oh_arr = np.zeros(ib.shape + (NZ,), np.float64)
        bi, ni, ki = np.meshgrid(*(np.arange(s) for s in ib.shape),
                                 indexing="ij")
        oh_arr[bi, ni, ki, ib] = 1.0
        mb_for_oh = mb.a if mb.batched else mb.a[None]
        oh_arr = oh_arr * mb_for_oh[..., None]
        oh = _Leaf(oh_arr, 3)
        oh.batched = True
    else:
        oh_arr = np.zeros(ib.shape + (NZ,), np.float64)
        ni, ki = np.meshgrid(*(np.arange(s) for s in ib.shape),
                             indexing="ij")
        oh_arr[ni, ki, ib] = 1.0
        mb_u = mb.a.reshape(mb.a.shape[-2:]) if not mb.batched else None
        assert mb_u is not None, (
            "batched nb_mask with shared idxb is unsupported")
        oh_arr = oh_arr * mb_u[..., None]
        oh = _Leaf(oh_arr, 3)

    absH = _Leaf(np.abs(H.a), 3)
    absH.batched = H.batched
    absF = _Leaf(np.abs(F.a), 3)
    absF.batched = F.batched

    # stationarity
    rq = g.bview() + ein([("nzw", H), ("nw", z)], "bnz")
    den_q = np.abs(g.bview()) + ein(
        [("nzw", absH), ("nw", np.abs(z))], "bnz")
    rq = np.broadcast_to(rq, (B, N + 1, NZ)).copy()
    den_q = np.broadcast_to(den_q, (B, N + 1, NZ)).copy()
    pi_pad = np.concatenate([np.zeros_like(pi[:, :1]), pi], axis=1)
    rq[:, :, NU:] -= pi_pad
    den_q[:, :, NU:] += np.abs(pi_pad)
    rq[:, :N] += ein([("nzx", F), ("nx", pi)], "bnz")
    den_q[:, :N] += ein([("nzx", absF), ("nx", np.abs(pi))], "bnz")
    mb_b = mb.bview()
    dlam_b = (lam_b[:, :, 1] - lam_b[:, :, 0]) * mb_b
    sc_b = ein([("nkz", oh), ("nk", dlam_b)], "bnz")
    rq += sc_b
    den_q += np.abs(sc_b)
    mg_b = mg.bview()
    dlam_g = (lam_g[:, :, 1] - lam_g[:, :, 0]) * mg_b
    rq += ein([("ngz", C), ("ng", dlam_g)], "bnz")
    absC = _Leaf(np.abs(C.a), 3)
    absC.batched = C.batched
    den_q += ein([("ngz", absC), ("ng", np.abs(dlam_g))], "bnz")
    rq *= z_mask.bview()
    den_q *= z_mask.bview()

    # dynamics
    xm1 = x_mask.bview()[:, 1:]
    rb = (b.bview() + ein([("nzx", F), ("nz", z[:, :N])], "bnx")
          - z[:, 1:, NU:]) * xm1
    den_b = (np.abs(b.bview())
             + ein([("nzx", absF), ("nz", np.abs(z[:, :N]))], "bnx")
             + np.abs(z[:, 1:, NU:])) * xm1

    # inequalities
    zb = ein([("nkz", oh), ("nz", z)], "bnk")
    rd_b = np.stack(
        [d_lb.bview() - zb + t_b[:, :, 0],
         d_ub.bview() - zb - t_b[:, :, 1]], axis=2
    ) * mb_b[:, :, None, :]
    cz = ein([("ngz", C), ("nz", z)], "bng")
    rd_g = np.stack(
        [d_lg.bview() + t_g[:, :, 0] - cz,
         d_ug.bview() - t_g[:, :, 1] - cz], axis=2
    ) * mg_b[:, :, None, :]

    # complementarity
    rm_b = lam_b * t_b * mb_b[:, :, None, :]
    rm_g = lam_g * t_g * mg_b[:, :, None, :]
    n_constr = float(np.max(2.0 * mb.a.sum(axis=(-2, -1))
                            + 2.0 * mg.a.sum(axis=(-2, -1))))
    mu = (rm_b.sum(axis=(1, 2, 3)) + rm_g.sum(axis=(1, 2, 3))) / max(
        n_constr, 1.0)

    def infn(a):
        return np.abs(a).reshape(B, -1).max(axis=1)

    res = np.stack(
        [infn(rq), infn(rb), np.maximum(infn(rd_b), infn(rd_g)), mu],
        axis=1)
    rel = np.stack(
        [infn(rq) / np.maximum(den_q.reshape(B, -1).max(axis=1), 1.0),
         infn(rb) / np.maximum(den_b.reshape(B, -1).max(axis=1), 1.0),
         np.maximum(infn(rd_b), infn(rd_g)), mu], axis=1)
    return res, rel


def true_residuals_sol(qp, sol):
    """Convenience wrapper over an :class:`IPMSolution`-like pytree."""
    return true_residuals(qp, sol.z, sol.pi, sol.lam_b, sol.t_b,
                          sol.lam_g, sol.t_g)
