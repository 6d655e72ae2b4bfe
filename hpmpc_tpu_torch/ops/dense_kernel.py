"""The dense condensed-QP IPM of one instance: CUDA kernel + plain version.

Port of ``hpmpc_tpu/ops/dense_kernel.py::dense_ipm_call`` (the Pallas call
``_dense_call``, body ``_dense_kernel``): the whole phase-1 Mehrotra IPM of
one dense QP

    min 1/2 y' Hd y + gd' y,   lbz <= y <= ubz (where mz > 0),
                               dlg <= G y <= dug

in one launch (``csrc/dense_ipm.cu``; the TPU's sequential grid of one
step per iteration is a loop inside one thread block).  Each iteration
folds ``Hbar = Hd + diag(Qxz) + G' diag(Qxg) G``, factors it by a column
Cholesky with pivots ``rsqrt(max(d, 1e-30))``, solves the predictor and the
corrector by two substitutions each, takes the fraction-to-boundary step
over the eight slack/multiplier families, and applies the kernel's
``step_ok`` twin (non-finite mu, or mu growing tenfold below 1e-3, in
either dtype), the ``alpha_min`` freeze and the per-iteration liveness
exit.  The first step clamps the warm start ``y0`` inside the boxes (the
``d_init_var`` twin).  Box data is z-aligned: ``mz`` (nz,) marks the boxed
coordinates; every general row is live (the TPU kernel's ``mg`` is all
ones).  Returns ``(y, kk, mu, status)``, status 0 converged (mu <=
mu_tol), 2 frozen, 1 otherwise.

One departure from the TPU kernel: it multiplies the iterate y by ``mz``
(at the start and after every step), which pins every unboxed coordinate
to 0 and returns a wrong answer with status 0 on a QP with an unboxed
input (u0 = 0 where its own oracle ``solve_dense_ref`` and the structured
solver give -1.01 on the N=4 chain with input 2 unboxed; ROADMAP Queue 3).
Here y is not masked, as in the oracle; on a QP whose inputs are all
boxed (mz all ones, the flagship) the two are the same arithmetic.

:func:`dense_ipm_plain` is the same arithmetic in plain PyTorch, including
the column Cholesky as the TPU kernel does it (both orientations of each
column: the forward substitution reads the row form, the backward one the
column form).  :func:`dense_ipm` runs it for CPU tensors and launches the
kernel for CUDA tensors; :func:`dense_ipm_call` is the tick entry (the
affine vector maps and the box gather, plain tensor code, then
:func:`dense_ipm`).  The envelope is the TPU kernel's: nz, ngd <= 128,
float32 or float64.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: the kernel's envelope (one lane tile on the TPU; the shared-memory plan
#: of csrc/dense_ipm.cu on the card)
MAX_DIM = 128
#: launches of the CUDA kernel in this process
LAUNCHES = 0
#: calls of :func:`dense_ipm` that ran the plain version (CPU tensors)
PLAIN_CALLS = 0

_BIG = 3.0e38
_THR0 = 0.1


class _Args(ctypes.Structure):
    # mirrors struct DenseIpmArgs in csrc/dense_ipm.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "Hd", "G", "gd", "lbz", "ubz", "mz", "dlg", "dug", "y0", "y", "mu",
        "kk", "status")] + [
        ("nz", ctypes.c_int64), ("ngd", ctypes.c_int64),
        ("k_max", ctypes.c_int64), ("mu0", ctypes.c_double),
        ("mu_tol", ctypes.c_double), ("alpha_min", ctypes.c_double),
        ("mu_scal", ctypes.c_double)]


def _chol_cols(A, tiny):
    """The TPU kernel's column Cholesky of the symmetric ``A`` (``_chol_tall``):
    per column j the pivot ``dinv_j = rsqrt(max(A_jj, tiny))``, the column
    ``c = A[j:, j] dinv_j`` (L's column j) and the row ``r = A[j, j:]
    dinv_j`` (U's row j), then ``A[j:, j:] -= c r'``.  Returns (L, U, dinv)."""
    n = A.shape[0]
    A = A.clone()
    L = torch.zeros_like(A)
    U = torch.zeros_like(A)
    dinv = torch.zeros(n, dtype=A.dtype, device=A.device)
    for j in range(n):
        dj = torch.rsqrt(torch.clamp(A[j, j], min=tiny))
        c = A[j:, j] * dj
        r = A[j, j:] * dj
        L[j:, j] = c
        U[j, j:] = r
        dinv[j] = dj
        A[j:, j:] = A[j:, j:] - c[:, None] * r[None, :]
    return L, U, dinv


def _solve_cols(L, U, dinv, rhs):
    """(L L')^{-1} rhs by the TPU kernel's two column-oriented
    substitutions (``_solve_chol``): forward with U's rows, backward with
    L's rows."""
    n = rhs.shape[0]
    w = torch.zeros_like(rhs)
    acc = torch.zeros_like(rhs)
    for j in range(n):
        w[j] = (rhs[j] - acc[j]) * dinv[j]
        acc = acc + w[j] * U[j]
    x = torch.zeros_like(rhs)
    acc = torch.zeros_like(rhs)
    for j in range(n - 1, -1, -1):
        x[j] = (w[j] - acc[j]) * dinv[j]
        acc = acc + x[j] * L[j]
    return x


def dense_ipm_plain(Hd, G, gd, lbz, ubz, mz, dlg, dug, y0, *, k_max, mu0,
                    mu_tol, alpha_min, mu_scal):
    """Plain PyTorch version of :func:`dense_ipm` (same arguments, same
    outputs): ``Hd`` (nz, nz) symmetric, ``G`` (ngd, nz), ``gd``/``lbz``/
    ``ubz``/``mz``/``y0`` (nz,), ``dlg``/``dug`` (ngd,).  Returns ``(y
    (nz,), kk, mu, status)``, kk and status int32 scalars."""
    dt = Hd.dtype
    c = lambda v: torch.tensor(v, dtype=dt, device=Hd.device)  # noqa: E731
    thr0, big = c(_THR0), c(_BIG)
    mu_tol_t, alpha_min_t, mu_scal_t = c(mu_tol), c(alpha_min), c(mu_scal)
    bz = mz > 0

    def mz_(v):
        return torch.where(bz, v, torch.zeros_like(v))

    # d_init_var twin on the warm start (zeros: cold); unboxed coordinates
    # keep y0 (the TPU kernel zeroes them, see the module doc)
    yv = y0
    t_lo0, t_up0 = mz_(yv - lbz), mz_(ubz - yv)
    both = (t_lo0 < thr0) & (t_up0 < thr0) & bz
    lo_o = (t_lo0 < thr0) & ~both & bz
    up_o = (t_up0 < thr0) & ~both & bz
    t_lo = torch.where(both | lo_o, thr0, t_lo0)
    t_up = torch.where(both | up_o, thr0, t_up0)
    yv = torch.where(both, 0.5 * (lbz - ubz),
                     torch.where(lo_o, lbz + thr0,
                                 torch.where(up_o, ubz - thr0, yv)))
    one = torch.ones_like(t_lo)
    t_lo = torch.where(bz, t_lo, one)
    t_up = torch.where(bz, t_up, one)
    lam_lo = mz_(mu0 / t_lo)
    lam_up = mz_(mu0 / t_up)
    cz = G @ yv
    sg_lo = torch.maximum(thr0, cz - dlg)
    sg_up = torch.maximum(thr0, dug - cz)
    lg_lo, lg_up = mu0 / sg_lo, mu0 / sg_up
    mu = c(mu0)
    frz = False
    kk = 0

    def alpha_of(pairs):
        a = c(1.0)
        for v, dv, m in pairs:
            pred = (dv < 0.0) & m
            r = torch.where(pred, -v / torch.where(pred, dv, -torch.ones_like(dv)),
                            big)
            a = torch.minimum(a, r.min()) if r.numel() else a
        return a

    def mu_of(ll, tl, lu, tu, gl, sl, gu, su):
        s = (mz_(ll * tl) + mz_(lu * tu)).sum() + (gl * sl + gu * su).sum()
        return s * mu_scal_t

    tiny = 1e-30
    for _ in range(int(k_max)):
        if frz or not bool(mu > mu_tol_t):
            break
        ti_lo, ti_up = 1.0 / t_lo, 1.0 / t_up
        si_lo, si_up = 1.0 / sg_lo, 1.0 / sg_up
        lt_lo, lt_up = lam_lo * ti_lo, lam_up * ti_up
        gt_lo, gt_up = lg_lo * si_lo, lg_up * si_up
        Qxz = mz_(lt_lo + lt_up)
        qxz = mz_((-lam_lo - lt_lo * lbz) + (lam_up - lt_up * ubz))
        Qxg = gt_lo + gt_up
        qxg = (-lg_lo - gt_lo * dlg) + (lg_up - gt_up * dug)
        Hbar = Hd + torch.diag(Qxz) + G.T @ (G * Qxg[:, None])
        g_eff = gd + qxz + G.T @ qxg
        L, U, dinv = _chol_cols(Hbar, tiny)
        y1 = _solve_cols(L, U, dinv, -g_eff)

        def dirs(y_new, dl0_lo, dl0_up, dg0_lo, dg0_up):
            dt_lo = mz_((y_new - lbz) - t_lo)
            dt_up = mz_((ubz - y_new) - t_up)
            dl_lo = mz_(dl0_lo - lt_lo * dt_lo - lam_lo)
            dl_up = mz_(dl0_up - lt_up * dt_up - lam_up)
            czn = G @ y_new
            ds_lo = (czn - dlg) - sg_lo
            ds_up = (dug - czn) - sg_up
            dg_lo = dg0_lo - gt_lo * ds_lo - lg_lo
            dg_up = dg0_up - gt_up * ds_up - lg_up
            return dt_lo, dt_up, dl_lo, dl_up, ds_lo, ds_up, dg_lo, dg_up

        def step_alpha(d):
            mg = torch.ones_like(sg_lo, dtype=torch.bool)
            return alpha_of(((lam_lo, d[2], bz), (lam_up, d[3], bz),
                             (t_lo, d[0], bz), (t_up, d[1], bz),
                             (lg_lo, d[6], mg), (lg_up, d[7], mg),
                             (sg_lo, d[4], mg), (sg_up, d[5], mg)))

        zz, zg = torch.zeros_like(lam_lo), torch.zeros_like(lg_lo)
        d1 = dirs(y1, zz, zz, zg, zg)
        a_aff = step_alpha(d1) * 0.995
        mu_aff = mu_of(lam_lo + a_aff * d1[2], t_lo + a_aff * d1[0],
                       lam_up + a_aff * d1[3], t_up + a_aff * d1[1],
                       lg_lo + a_aff * d1[6], sg_lo + a_aff * d1[4],
                       lg_up + a_aff * d1[7], sg_up + a_aff * d1[5])
        sigma = (mu_aff / mu) ** 3
        smu = sigma * mu
        dl2_lo = mz_(ti_lo * (smu - d1[2] * d1[0]))
        dl2_up = mz_(ti_up * (smu - d1[3] * d1[1]))
        dg2_lo = si_lo * (smu - d1[6] * d1[4])
        dg2_up = si_up * (smu - d1[7] * d1[5])
        qxz2 = qxz + (-dl2_lo + dl2_up)
        qxg2 = qxg + (-dg2_lo + dg2_up)
        g_eff2 = gd + qxz2 + G.T @ qxg2
        y2 = _solve_cols(L, U, dinv, -g_eff2)
        d2 = dirs(y2, dl2_lo, dl2_up, dg2_lo, dg2_up)
        a2 = step_alpha(d2) * 0.995

        new = (yv + a2 * (y2 - yv), t_lo + a2 * d2[0],
               t_up + a2 * d2[1], lam_lo + a2 * d2[2], lam_up + a2 * d2[3],
               sg_lo + a2 * d2[4], sg_up + a2 * d2[5], lg_lo + a2 * d2[6],
               lg_up + a2 * d2[7])
        mu_n = mu_of(new[3], new[1], new[4], new[2], new[7], new[5],
                     new[8], new[6])
        ok = bool((mu_n == mu_n) & (mu_n.abs() < big)
                  & ~((mu_n > 10.0 * mu) & (mu < 1e-3)))
        if ok:
            (yv, t_lo, t_up, lam_lo, lam_up, sg_lo, sg_up, lg_lo,
             lg_up) = new
            mu = mu_n
            kk += 1
        frz = (not ok) or bool(a2 < alpha_min_t)
    status = 0 if bool(mu <= mu_tol_t) else (2 if frz else 1)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=Hd.device)  # noqa: E731
    return yv, i32(kk), mu, i32(status)


def dense_ipm(Hd, G, gd, lbz, ubz, mz, dlg, dug, y0, *, k_max, mu0, mu_tol,
              alpha_min, mu_scal):
    """One instance's whole dense IPM (see the module doc).  CPU tensors
    run :func:`dense_ipm_plain`; CUDA tensors launch ``csrc/dense_ipm.cu``
    on the current stream (one block, no sync) and return device tensors:
    ``y`` (nz,), ``kk`` and ``status`` int32 (), ``mu`` ()."""
    global LAUNCHES, PLAIN_CALLS
    kw = dict(k_max=k_max, mu0=mu0, mu_tol=mu_tol, alpha_min=alpha_min,
              mu_scal=mu_scal)
    if Hd.device.type == "cpu":
        PLAIN_CALLS += 1
        return dense_ipm_plain(Hd, G, gd, lbz, ubz, mz, dlg, dug, y0, **kw)
    if Hd.device.type != "cuda":
        raise ValueError(f"dense_ipm: unsupported device {Hd.device}")
    nz, ngd = Hd.shape[0], G.shape[0]
    if not (1 <= nz <= MAX_DIM and ngd <= MAX_DIM):
        raise ValueError(f"dense_ipm: nz={nz}, ngd={ngd} outside the "
                         f"kernel's envelope (1..{MAX_DIM}, 0..{MAX_DIM})")
    named = dict(Hd=Hd, G=G, gd=gd, lbz=lbz, ubz=ubz, mz=mz, dlg=dlg,
                 dug=dug, y0=y0)
    dev, dt = Hd.device, Hd.dtype
    _build.check_tensors(dev, dt, named, dict(
        Hd=(nz, nz), G=(ngd, nz), gd=(nz,), lbz=(nz,), ubz=(nz,), mz=(nz,),
        dlg=(ngd,), dug=(ngd,), y0=(nz,)))
    y = torch.empty(nz, dtype=dt, device=dev)
    mu = torch.empty((), dtype=dt, device=dev)
    kk = torch.empty((), dtype=torch.int32, device=dev)
    status = torch.empty((), dtype=torch.int32, device=dev)
    ptrs = {k: _build.ptr(v) for k, v in named.items()}
    args = _Args(**ptrs, y=_build.ptr(y), mu=_build.ptr(mu),
                 kk=_build.ptr(kk), status=_build.ptr(status), nz=nz,
                 ngd=ngd, k_max=int(k_max), mu0=float(mu0),
                 mu_tol=float(mu_tol), alpha_min=float(alpha_min),
                 mu_scal=float(mu_scal))
    _build.launch("dense_ipm", "dense_ipm", args, dev, dt)
    LAUNCHES += 1
    return y, kk, mu, status


def dense_inputs(plan, bflat, y0=None):
    """The kernel's inputs for one tick: the affine vector maps of
    ``plan.vectors`` (plain matrix-vector products, as the TPU wrapper
    leaves them to XLA), the box data gathered onto z by ``Sel`` and the warm
    start (zeros: cold).  Returns the argument tuple of :func:`dense_ipm`."""
    gd, lb, ub, dlg, dug = plan.vectors(bflat)
    mz = plan.Sel @ torch.ones(plan.nb, dtype=plan.Hd.dtype,
                               device=plan.Hd.device)
    if y0 is None:
        y0 = torch.zeros(plan.nz, dtype=plan.Hd.dtype, device=plan.Hd.device)
    return (plan.Hd, plan.G, gd, plan.Sel @ lb, plan.Sel @ ub, mz, dlg, dug,
            y0.to(plan.Hd.dtype))


def dense_config(plan, cfg) -> dict:
    """The scalar configuration of :func:`dense_ipm` for ``plan`` and an
    ``IPMConfig``: mu scaled by 1 / (2 (nb + ngd))."""
    return dict(k_max=int(cfg.k_max), mu0=float(cfg.mu0),
                mu_tol=float(cfg.mu_tol), alpha_min=float(cfg.alpha_min),
                mu_scal=1.0 / (2 * (plan.nb + plan.ngd)))


def dense_ipm_call(plan, bflat, cfg, y0=None):
    """Tick entry (``dense_ipm_call`` of the JAX package): the affine maps
    of :func:`dense_inputs`, then the whole dense IPM in one call.
    ``y0``: the warm-start iterate (the previous tick's y), None = cold.
    Returns ``(y (nz,), kk, mu, status)``.  Raises ``ValueError`` outside
    the envelope nz, ngd <= 128."""
    if plan.nz > MAX_DIM or plan.ngd > MAX_DIM:
        raise ValueError(
            f"the dense latency kernel supports nz, ngd <= {MAX_DIM} (got "
            f"{plan.nz}, {plan.ngd}); larger condensed problems take the "
            "stage engines (solve_ocp, OCPSession.solve)")
    return dense_ipm(*dense_inputs(plan, bflat, y0), **dense_config(plan, cfg))
