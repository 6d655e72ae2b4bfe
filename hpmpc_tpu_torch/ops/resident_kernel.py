"""The whole phase-1 IPM in one kernel: CUDA kernel + plain version.

Port of ``hpmpc_tpu/ops/resident_kernel.py::ipm_resident`` (TPU body
``_resident_kernel``), with the general-constraint rows: the hard
variant (``NS = 0``, Queue 2 row 1) and the soft variant (``NS > 0``, row
1s).  Semantics are the reference's legacy no-residual solver
(``d_ip2_hard.c``; with soft rows the single-loop ``d_ip2_mpc_soft_tv``,
``mpc_solvers/d_ip2_soft.c:83``): pure phase-1 Mehrotra
predictor-corrector to ``mu_tol``/``k_max``, per-instance early stop, the
NaN / divergence / dual-explosion freeze, and a pending state update
``z += a2 (dz2 - z)`` applied stage by stage in the next iteration's
first sweep (a final pass applies the last one).  The soft variant adds,
per stage and sweep, the soft-slack Schur elimination into the barrier
fold, the soft directions with their fraction-to-boundary and duality
terms, and the soft corrector gradient (``exact`` keeps its Schur-folded
correction; without it the reference's dropped correction); its duality
scaling is per instance (``musc``).

Liveness is per instance.  An instance that is not live (converged:
``mu <= mu_tol``, or frozen) skips the iteration and leaves its state,
``kk`` and ``mu`` untouched.  ``stat[it]`` is the row of iteration ``it``
when that iteration's update was applied and zero otherwise — for every
iteration after an instance stopped, and for the breakdown step that
froze it.  (The TPU kernel could only skip whole 1024-lane blocks, so
there a stopped lane's later rows are zero while its block lives and
repeat the block's last row once the whole block is done.)

Inputs are the batch-last streams of
:func:`hpmpc_tpu_torch.models.ipm_lanes.make_lanes_common`.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.ipm import (BIG, GUARD_LAM_GROWTH, GUARD_MU_FLOOR,
                          GUARD_MU_GROWTH)
from . import _build
from . import stage_math as sm
from .layout import from_lanes, sym_expand, sym_nt, to_lanes

#: launches of the CUDA kernel in this process, hard (``NS = 0``) and
#: soft variant
LAUNCHES = {"ipm_resident": 0, "ipm_resident_soft": 0}
#: calls of the wrapper that ran the plain version, per variant
PLAIN_CALLS = dict.fromkeys(LAUNCHES, 0)

_PTRS = ("idx", "lam0", "t0", "z0", "pi0", "base", "pdreg", "H", "F", "b",
         "dcat", "mb", "Cg", "dgg", "mgg", "lamg0", "tg0", "ng_stage",
         "idxs", "lams0", "ts0", "softc", "msk", "musc",
         "z", "pi", "lam", "t", "mu", "kk", "frozen", "stat", "lamg", "tg",
         "lams", "ts", "work")


class _ResidentArgs(ctypes.Structure):
    # mirrors struct ResidentArgs in csrc/ipm_resident.cu, field for field
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [
        ("B", ctypes.c_int64), ("N", ctypes.c_int64), ("K", ctypes.c_int64),
        ("n_ng", ctypes.c_int64), ("mu_scal", ctypes.c_double),
        ("mu_tol", ctypes.c_double), ("alpha_min", ctypes.c_double),
        ("mu0", ctypes.c_double), ("exact", ctypes.c_int)]


def _variant(NS) -> str:
    """The counter key of a call: the hard or the soft variant."""
    return "ipm_resident_soft" if NS else "ipm_resident"


def ipm_resident_ref(idx_tab, lam0, t0, z0, pi0, base, pdreg, H, F, b, dcat,
                     mb, *, NB, NU, NZ, NX, k_max, mu_scal, mu_tol,
                     alpha_min, mu0, NG=1, ng_stage_ids=(), Cg=None,
                     dgg=None, mgg=None, lamg0=None, tg0=None, NS=0,
                     exact=True, idxs_tab=None, lams0=None, ts0=None,
                     softc=None, msk=None, musc=None):
    """Plain PyTorch version of :func:`ipm_resident`: the same arguments
    and outputs, batched torch ops over the instances, Python loops over
    iterations and stages (``ops/stage_math.py`` helpers; the soft rows
    through its ``soft_*`` primitives).  Instances that are not live are
    computed along and gated off, which gives the kernel's per-instance
    results."""
    Np1 = z0.shape[0]
    N = Np1 - 1
    B = z0.shape[-1]
    dt, dev = z0.dtype, z0.device
    NG2 = 2 * NG
    n_ng = len(ng_stage_ids)
    K = int(k_max)
    idx = idx_tab.long()
    slot = {n: j for j, n in enumerate(ng_stage_ids)}

    Hf = sym_expand(from_lanes(H), NZ)           # (B, N+1, NZ, NZ)
    Fb, bb = from_lanes(F), from_lanes(b)        # (B, N, NZ, NX), (B, N, NX)
    gb, pdb = from_lanes(base), from_lanes(pdreg)
    Ab, mbb = from_lanes(dcat), from_lanes(mb)
    z = from_lanes(z0).clone()                   # (B, N+1, NZ)
    pi = from_lanes(pi0).clone()                 # (B, N, NX)
    lam, t = from_lanes(lam0).clone(), from_lanes(t0).clone()
    dz2, dpi2 = torch.zeros_like(z), torch.zeros_like(pi)
    dt2, dl2 = torch.zeros_like(lam), torch.zeros_like(lam)
    dta, dla, co = (torch.zeros_like(lam) for _ in range(3))
    if n_ng:
        Cb = from_lanes(Cg)                      # (B, n_ng, NG, NZ)
        dgb, mgb = from_lanes(dgg), from_lanes(mgg)
        lamg, tg = from_lanes(lamg0).clone(), from_lanes(tg0).clone()
    else:
        lamg = tg = torch.zeros(B, 0, NG2, dtype=dt, device=dev)
    dtag, dlag, cog = (torch.zeros_like(lamg) for _ in range(3))
    dt2g, dl2g = torch.zeros_like(lamg), torch.zeros_like(lamg)
    if NS:
        idxs = idxs_tab.long()
        lams, ts = from_lanes(lams0).clone(), from_lanes(ts0).clone()
        sc, msb = from_lanes(softc), from_lanes(msk)  # (B, N+1, 6NS / NS)
        mu_scal = musc                               # per instance (B,)
        # soft directions: affine, corrector gradient, corrector
        dtas, dlas, dl2cs, dt2s, dl2s = (torch.zeros_like(lams)
                                         for _ in range(5))

        def schur(n):
            return sm.soft_schur(NS, lams[:, n], ts[:, n], msb[:, n],
                                 sc[:, n])

    ll = torch.zeros(B, Np1, NZ, NU, dtype=dt, device=dev)
    lxx = torch.zeros(B, Np1, NX, NX, dtype=dt, device=dev)
    eus = torch.zeros(B, Np1, NU, dtype=dt, device=dev)
    pxs = torch.zeros(B, Np1, NX, dtype=dt, device=dev)
    pbs = torch.zeros(B, N, NX, dtype=dt, device=dev)

    zero = torch.zeros(B, dtype=dt, device=dev)
    a2p = zero.clone()
    mu = torch.full((B,), float(mu0), dtype=dt, device=dev)
    lamref = torch.full((B,), BIG, dtype=dt, device=dev)
    frz = torch.zeros(B, dtype=torch.bool, device=dev)
    kk = torch.zeros(B, dtype=torch.int32, device=dev)
    stat = torch.zeros(B, K, 5, dtype=dt, device=dev)
    big = torch.full((B,), BIG, dtype=dt, device=dev)

    def ng_vals(j):
        return lamg[:, j], tg[:, j], mgb[:, j], dgb[:, j], Cb[:, j]

    def sums(amin, s, lam_, t_, mb_, dt_, dl_):
        cand = torch.minimum(sm.alpha_cands(lam_, dl_, mb_),
                             sm.alpha_cands(t_, dt_, mb_))
        amin = torch.minimum(amin, torch.amin(cand, dim=1))
        return amin, (s[0] + (lam_ * t_ * mb_).sum(1),
                      s[1] + (lam_ * dt_ + t_ * dl_).sum(1),
                      s[2] + (dl_ * dt_).sum(1))

    def forward(corrector):
        """One forward sweep (affine: phase 1, corrector: phase 3);
        returns (amin, (s0, s1, s2))."""
        amin, s = big.clone(), (zero, zero, zero)
        x = sm.root_x0(lxx[:, 0], pxs[:, 0])
        for s_ in range(Np1):
            Ll = ll[:, s_]
            Dinv_u = sm.dinv_ll(Ll, NU)
            u = sm.u_of_x(NU, Ll, Dinv_u, eus[:, s_], x)
            zt = torch.cat([u, x], dim=1)
            if corrector:
                dz2[:, s_] = zt
                if s_ >= 1:
                    dpi2[:, s_ - 1] = sm.pi_of_x(lxx[:, s_], pxs[:, s_], x)
            se = min(s_, N - 1)
            x = sm.x_next_of(Fb[:, se], bb[:, se], zt)
            zb = sm.gather_box(zt, idx[s_])
            dl0 = co[:, s_] if corrector else 0.0
            dtb, dlb = sm.dt_dlam(NB, lam[:, s_], t[:, s_], mbb[:, s_],
                                  Ab[:, s_], zb, dl0)
            if corrector:
                dt2[:, s_], dl2[:, s_] = dtb, dlb
            else:
                dta[:, s_], dla[:, s_] = dtb, dlb
            amin, s = sums(amin, s, lam[:, s_], t[:, s_], mbb[:, s_],
                           dtb, dlb)
            if NS:
                S = schur(s_)
                zs = sm.gather_box(zt, idxs[s_]) * msb[:, s_]
                if corrector:
                    d0, d1, d2, d3 = sm.soft4(dl2cs[:, s_], NS)
                    dts, dls = sm.soft_dt_dls(
                        NS, lams[:, s_], ts[:, s_], S, zs, dl2cs[:, s_],
                        S["zl0"] + d0 + d2, S["zl1"] + d1 + d3)
                    dt2s[:, s_], dl2s[:, s_] = dts, dls
                else:
                    dts, dls = sm.soft_dt_dls(NS, lams[:, s_], ts[:, s_], S,
                                              zs, 0.0, S["zl0"], S["zl1"])
                    dtas[:, s_], dlas[:, s_] = dts, dls
                amin, s = sums(amin, s, lams[:, s_], ts[:, s_], S["ms4"],
                               dts, dls)
            if s_ in slot:
                j = slot[s_]
                lg, tgv, mg, dg, Cj = ng_vals(j)
                cz = (Cj @ zt[..., None])[..., 0]
                dl0g = cog[:, j] if corrector else 0.0
                dtg, dlg = sm.dt_dlam(NG, lg, tgv, mg, dg, cz, dl0g)
                if corrector:
                    dt2g[:, j], dl2g[:, j] = dtg, dlg
                else:
                    dtag[:, j], dlag[:, j] = dtg, dlg
                amin, s = sums(amin, s, lg, tgv, mg, dtg, dlg)
        return amin, s

    for it in range(K + 1):
        live = (~frz) & (mu > mu_tol)
        work = it < K and bool(live.any())

        # ---- phase 0: pending update (stage k), barrier fold + factor ----
        upd = (a2p > 0)[:, None]
        a2c = a2p[:, None]
        Lxx_c = px_c = None
        for s_ in range(Np1):
            k = N - s_
            # a select, never a multiply: frozen directions may hold NaN
            z[:, k] = torch.where(upd, z[:, k] + a2c * (dz2[:, k] - z[:, k]),
                                  z[:, k])
            lam[:, k] = torch.where(upd, lam[:, k] + a2c * dl2[:, k],
                                    lam[:, k])
            t[:, k] = torch.where(upd, t[:, k] + a2c * dt2[:, k], t[:, k])
            if NS:
                lams[:, k] = torch.where(upd, lams[:, k] + a2c * dl2s[:, k],
                                         lams[:, k])
                ts[:, k] = torch.where(upd, ts[:, k] + a2c * dt2s[:, k],
                                       ts[:, k])
            if k >= 1:
                e = k - 1
                pi[:, e] = torch.where(
                    upd, pi[:, e] + a2c * (dpi2[:, e] - pi[:, e]), pi[:, e])
            if k in slot:
                j = slot[k]
                lamg[:, j] = torch.where(upd, lamg[:, j] + a2c * dl2g[:, j],
                                         lamg[:, j])
                tg[:, j] = torch.where(upd, tg[:, j] + a2c * dt2g[:, j],
                                       tg[:, j])
            if not work:
                continue
            Qx, qx = sm.qx_fold(NB, lam[:, k], t[:, k], mbb[:, k], Ab[:, k])
            dvec = sm.scatter_add_box(pdb[:, k], idx[k], Qx)
            if NS:
                Qx_s, qx_s = sm.soft_qx(msb[:, k], schur(k))
                dvec = sm.scatter_add_box(dvec, idxs[k], Qx_s)
            Hp = Hf[:, k] + torch.diag_embed(dvec)
            g = sm.scatter_add_box(gb[:, k], idx[k], qx)
            if NS:
                g = sm.scatter_add_box(g, idxs[k], qx_s)
            if k in slot:
                lg, tgv, mg, dg, Cj = ng_vals(slot[k])
                Qxg, qxg = sm.qx_fold(NG, lg, tgv, mg, dg)
                Hp = Hp + Cj.transpose(-1, -2) @ (Qxg[..., None] * Cj)
                g = g + (Cj.transpose(-1, -2) @ qxg[..., None])[..., 0]
            ke = min(k, N - 1)
            if Lxx_c is None:  # terminal stage: zero carry
                Lxx_c = torch.zeros(B, NX, NX, dtype=dt, device=dev)
                px_c = torch.zeros(B, NX, dtype=dt, device=dev)
            Lf, eu, px, Pb = sm.folded_bwd_core(NU, Hp, g, Fb[:, ke],
                                                bb[:, ke], Lxx_c, px_c)
            Lxx_c, px_c = torch.tril(Lf[:, NU:, NU:]), px
            ll[:, k] = Lf[:, :, :NU]
            lxx[:, k] = Lxx_c
            eus[:, k], pxs[:, k] = eu, px
            if k < N:
                pbs[:, k] = Pb
        a2p = zero.clone()
        if not work:
            break

        # ---- phase 1: affine forward + alpha / mu(alpha) partials -------
        amin, (s0, s1, s2) = forward(corrector=False)
        alpha_aff = torch.minimum(torch.ones_like(amin), amin)
        a = 0.995 * alpha_aff
        mu_aff = (s0 + a * s1 + a * a * s2) * mu_scal
        ratio = mu_aff / torch.where(mu > 0, mu, torch.ones_like(mu))
        sigma = ratio * ratio * ratio
        smu = sigma * mu

        # ---- phase 2: corrector gradient + retained-factor solve --------
        px_c = None
        for s_ in range(Np1):
            k = N - s_
            co_k, qx = sm.corr_co_qx(NB, lam[:, k], t[:, k], mbb[:, k],
                                     Ab[:, k], dta[:, k], dla[:, k], smu)
            co[:, k] = co_k
            g = sm.scatter_add_box(gb[:, k], idx[k], qx)
            if NS:
                dl2cs[:, k], qx_s = sm.soft_corr_qx(
                    NS, msb[:, k], schur(k), dtas[:, k], dlas[:, k], smu,
                    exact)
                g = sm.scatter_add_box(g, idxs[k], qx_s)
            if k in slot:
                j = slot[k]
                lg, tgv, mg, dg, Cj = ng_vals(j)
                cogv, qxg2 = sm.corr_co_qx(NG, lg, tgv, mg, dg, dtag[:, j],
                                           dlag[:, j], smu)
                cog[:, j] = cogv
                g = g + (Cj.transpose(-1, -2) @ qxg2[..., None])[..., 0]
            Ll = ll[:, k]
            Dinv_u = sm.dinv_ll(Ll, NU)
            ke = min(k, N - 1)
            Pbpx = None if s_ == 0 else pbs[:, ke] + px_c
            eu, px_c = sm.trs_stage(NU, Ll, Dinv_u, g, Fb[:, ke], Pbpx,
                                    s_ == 0)
            eus[:, k], pxs[:, k] = eu, px_c

        # ---- phase 3: corrector forward + alpha + step glue -------------
        amin, (s0, s1, s2) = forward(corrector=True)
        alpha2 = torch.minimum(torch.ones_like(amin), amin)
        a2 = 0.995 * alpha2
        mu_new = (s0 + a2 * s1 + a2 * a2 * s2) * mu_scal
        lam_all = torch.cat([lam.reshape(B, -1), lamg.reshape(B, -1)], 1)
        dl_all = torch.cat([dl2.reshape(B, -1), dl2g.reshape(B, -1)], 1)
        lmx_old = torch.maximum(zero, lam_all.abs().amax(1))
        lmx_new = torch.maximum(
            zero, (lam_all + a2[:, None] * dl_all).abs().amax(1))
        floor = mu < GUARD_MU_FLOOR
        anchored = lamref < BIG
        one = torch.ones_like(mu)
        ok = ((mu_new == mu_new) & (mu_new.abs() < BIG)
              & ~((mu_new > GUARD_MU_GROWTH * mu) & floor)
              & ~((lmx_new > GUARD_LAM_GROWTH * torch.maximum(lmx_old, one))
                  & floor)
              & ~(anchored & (lmx_new > GUARD_LAM_GROWTH * lamref)))
        upd = live & ok
        lamref = torch.where(upd & ~anchored & (mu_new < GUARD_MU_FLOOR),
                             torch.maximum(lmx_new, one), lamref)
        a2p = torch.where(upd, a2, zero)
        row = torch.stack([sigma, alpha_aff, mu_aff, alpha2, mu_new], 1)
        stat[:, it] = torch.where(upd[:, None], row, torch.zeros_like(row))
        mu = torch.where(upd, mu_new, mu)
        frz = frz | (live & (~ok | (a2 < alpha_min)))
        kk = kk + upd.to(torch.int32)

    outs = (to_lanes(z), to_lanes(pi), to_lanes(lam), to_lanes(t), mu, kk,
            frz.to(torch.int32), to_lanes(stat))
    if n_ng:
        outs += (to_lanes(lamg), to_lanes(tg))
    if NS:
        outs += (to_lanes(lams), to_lanes(ts))
    return outs


def ipm_resident(idx_tab, lam0, t0, z0, pi0, base, pdreg, H, F, b, dcat, mb,
                 *, NB, NU, NZ, NX, k_max, mu_scal, mu_tol, alpha_min, mu0,
                 NG=1, ng_stage_ids=(), Cg=None, dgg=None, mgg=None,
                 lamg0=None, tg0=None, NS=0, exact=True, idxs_tab=None,
                 lams0=None, ts0=None, softc=None, msk=None, musc=None):
    """Run the whole phase-1 IPM of a batch in one launch.

    Streams (batch-last, B instances): ``lam0``/``t0``/``dcat``/``mb``
    (N+1, 2NB, B), ``z0``/``base``/``pdreg`` (N+1, NZ, B), ``pi0`` (N, NX,
    B), ``H`` (N+1, NT, B) packed, ``F`` (N, NZ, NX, B), ``b`` (N, NX, B),
    ``idx_tab`` (N+1, NB) int32.  General constraints on the stages
    ``ng_stage_ids``: ``Cg`` (n_ng, NG, NZ, B), ``dgg``/``mgg``/``lamg0``/
    ``tg0`` (n_ng, 2NG, B).

    Soft variant (``NS > 0``, the soft rows of ``d_ip2_mpc_soft_tv``):
    ``idxs_tab`` (N+1, NS) int32 padded-z soft coordinates, ``lams0``/
    ``ts0`` (N+1, 4NS, B) [lo; up; s_lo; s_up], ``softc`` (N+1, 6NS, B)
    [d_lbs; d_ubs; Z0; Z1; zlin0; zlin1], ``msk`` (N+1, NS, B) soft mask,
    ``musc`` (B,) the per-instance duality scaling (``mu_scal`` is then
    unused); ``exact`` keeps the soft corrector gradient's Schur-folded
    correction (False: the reference's dropped correction).

    Returns ``(z, pi, lam, t, mu, kk, frozen, stat[, lamg, tg][, lams,
    ts])``: the final iterate as streams, ``mu`` (B,), ``kk``/``frozen``
    (B,) int32, ``stat`` (k_max, 5, B) iteration-indexed rows, the ng
    multipliers and slacks (n_ng, 2NG, B) when there are ng stages, and
    the soft ones (N+1, 4NS, B) when ``NS > 0``.

    CPU tensors run :func:`ipm_resident_ref`; CUDA tensors launch the
    ``csrc/ipm_resident.cu`` kernel on the current stream (no sync).  The
    two variants count apart (``LAUNCHES`` / ``PLAIN_CALLS``)."""
    kw = dict(NB=NB, NU=NU, NZ=NZ, NX=NX, k_max=k_max, mu_scal=mu_scal,
              mu_tol=mu_tol, alpha_min=alpha_min, mu0=mu0, NG=NG,
              ng_stage_ids=tuple(ng_stage_ids), Cg=Cg, dgg=dgg, mgg=mgg,
              lamg0=lamg0, tg0=tg0, NS=NS, exact=exact, idxs_tab=idxs_tab,
              lams0=lams0, ts0=ts0, softc=softc, msk=msk, musc=musc)
    ins = (idx_tab, lam0, t0, z0, pi0, base, pdreg, H, F, b, dcat, mb)
    if z0.device.type == "cpu":
        PLAIN_CALLS[_variant(NS)] += 1
        return ipm_resident_ref(*ins, **kw)
    if z0.device.type != "cuda":
        raise ValueError(f"ipm_resident: unsupported device {z0.device}")
    Np1, B = z0.shape[0], z0.shape[-1]
    N, K = Np1 - 1, int(k_max)
    NB2, NG2, NS4, NT = 2 * NB, 2 * NG, 4 * NS, sym_nt(NZ)
    n_ng = len(ng_stage_ids)
    if K < 1:
        raise ValueError("ipm_resident: k_max must be >= 1")
    names = ["idx_tab", "lam0", "t0", "z0", "pi0", "base", "pdreg", "H", "F",
             "b", "dcat", "mb"]
    shapes = {
        "idx_tab": (Np1, NB), "lam0": (Np1, NB2, B), "t0": (Np1, NB2, B),
        "z0": (Np1, NZ, B), "pi0": (N, NX, B), "base": (Np1, NZ, B),
        "pdreg": (Np1, NZ, B), "H": (Np1, NT, B), "F": (N, NZ, NX, B),
        "b": (N, NX, B), "dcat": (Np1, NB2, B), "mb": (Np1, NB2, B),
        "Cg": (n_ng, NG, NZ, B), "dgg": (n_ng, NG2, B),
        "mgg": (n_ng, NG2, B), "lamg0": (n_ng, NG2, B),
        "tg0": (n_ng, NG2, B), "idxs_tab": (Np1, NS),
        "lams0": (Np1, NS4, B), "ts0": (Np1, NS4, B),
        "softc": (Np1, 6 * NS, B), "msk": (Np1, NS, B), "musc": (B,),
    }
    named = dict(zip(names, ins))
    if n_ng:
        named.update(Cg=Cg, dgg=dgg, mgg=mgg, lamg0=lamg0, tg0=tg0)
    if NS:
        named.update(idxs_tab=idxs_tab, lams0=lams0, ts0=ts0, softc=softc,
                     msk=msk, musc=musc)
    _build.check_tensors(z0.device, z0.dtype, named, shapes)
    _build.dtype_code(z0.dtype)                 # raise before building
    # the soft variant is its own library (-DHP_NS); the hard one's key,
    # without NS, is the one it always had
    dims = dict(NU=NU, NX=NX, NB=NB, NG=NG) | ({"NS": NS} if NS else {})
    lib = _build.load("ipm_resident", **dims)
    fn_rows = lib.hp_ipm_resident_work_rows
    fn_rows.argtypes = [ctypes.c_int64, ctypes.c_int64]
    fn_rows.restype = ctypes.c_int64
    dt, dev = z0.dtype, z0.device
    new = lambda *s: torch.empty(*s, dtype=dt, device=dev)  # noqa: E731
    z, pi = new(Np1, NZ, B), new(N, NX, B)
    lam, t = new(Np1, NB2, B), new(Np1, NB2, B)
    mu = new(B)
    kk = torch.empty(B, dtype=torch.int32, device=dev)
    frozen = torch.empty(B, dtype=torch.int32, device=dev)
    stat = new(K, 5, B)
    lamg, tg = new(n_ng, NG2, B), new(n_ng, NG2, B)
    lams, ts = new(Np1, NS4, B), new(Np1, NS4, B)
    work = new(int(fn_rows(N, n_ng)), B)
    ng_stage = _build.int_table(ng_stage_ids, dev)
    ptrs = [named.get(k) for k in ("idx_tab", "lam0", "t0", "z0", "pi0",
                                   "base", "pdreg", "H", "F", "b", "dcat",
                                   "mb", "Cg", "dgg", "mgg", "lamg0", "tg0")]
    ptrs += [ng_stage] + [named.get(k) for k in (
        "idxs_tab", "lams0", "ts0", "softc", "msk", "musc")]
    ptrs += [z, pi, lam, t, mu, kk, frozen, stat, lamg, tg, lams, ts, work]
    a = _ResidentArgs(*[_build.ptr(x) for x in ptrs], B, N, K, n_ng,
                      float(mu_scal), float(mu_tol), float(alpha_min),
                      float(mu0), int(bool(exact)))
    _build.launch("ipm_resident", "ipm_resident", a, dev, dt, **dims)
    LAUNCHES[_variant(NS)] += 1
    outs = (z, pi, lam, t, mu, kk, frozen, stat)
    if n_ng:
        outs += (lamg, tg)
    if NS:
        outs += (lams, ts)
    return outs
