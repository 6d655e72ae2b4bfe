"""IPM step passes over the box streams and the exact KKT residuals:
CUDA kernels + plain versions.

Port of the hard-constraint kernels of ``hpmpc_tpu/ops/step_kernel.py``,
the reference's ``d_aux_ip_hard_lib4.c`` step primitives:

  * :func:`prep_flat` (TPU body ``_prep_kernel``) — barrier Hessian
    diagonal and effective gradient in z-space;
  * :func:`alpha_sums_flat` (``_alpha_kernel``) — the box direction of a
    z direction, the fraction-to-boundary minimum and the mu(alpha)
    partials per stage;
  * :func:`corr_geff_flat` (``_corr_kernel``) — the centering/corrector
    stream and the second effective gradient;
  * :func:`resid_full` (``_resid_kernel`` of ``resid_full_flat``) — the
    twin of the reference's ``d_res_res_mpc_hard_tv``.

The first three are one library, ``csrc/step_flat.cu``; ``phase2`` picks
the box formulas as in :mod:`.mega_kernel`.  Their soft twins, the step
passes of the soft lanes engine's 6-kernel loop (the reference's
``d_aux_ip_soft_lib4.c`` primitives, always in the phase-1 formulas), are
the library ``csrc/soft_step_flat.cu``:

  * :func:`soft_prep_flat` (TPU body ``_soft_prep_kernel``) — box fold +
    soft slack Schur elimination, both scattered;
  * :func:`soft_alpha_sums_flat` (``_soft_alpha_kernel``) — box and soft
    directions, alpha minimum and mu partials, affine or corrector;
  * :func:`soft_corr_flat` (``_soft_corr_kernel``) — both families'
    centering corrections and the second effective gradient, ``exact``.

Layout (see :mod:`.layout`): every stream is batch-last, ``(N+1, k, B)``
for per-stage streams, ``(N, k, B)`` for the N-stage ones (F, b, pi,
x_mask), ``(N+1, NT, B)`` for the packed stage Hessian.  ``idx_tab`` is the
(N+1, NB) int32 box index table shared by the batch; padded box slots
point at z-slot 0 with mask 0.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import stage_math as sm
from .layout import from_lanes, sym_expand, sym_nt, to_lanes

#: launches of the CUDA resid_full kernel in this process
RESID_LAUNCHES = 0
#: launches of each step_flat kernel in this process, [phase 1, phase 2]
LAUNCHES = {"prep_flat": [0, 0], "alpha_sums_flat": [0, 0],
            "corr_geff_flat": [0, 0]}
#: calls of each step_flat wrapper that ran the plain version (CPU
#: tensors), [phase 1, phase 2]
PLAIN_CALLS = {"prep_flat": [0, 0], "alpha_sums_flat": [0, 0],
               "corr_geff_flat": [0, 0]}


class _PrepArgs(ctypes.Structure):
    # mirrors struct PrepArgs in csrc/step_flat.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "idx", "lam", "t", "A", "M", "mb", "base", "pdreg", "dvec",
        "geff")] + [("B", ctypes.c_int64), ("N", ctypes.c_int64),
                    ("phase2", ctypes.c_int64)]


class _AlphaArgs(ctypes.Structure):
    # mirrors struct AlphaArgs in csrc/step_flat.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "idx", "dz", "lam", "t", "A", "M", "dl0", "mb", "dt", "dl", "amin",
        "s0", "s1", "s2")] + [("B", ctypes.c_int64), ("N", ctypes.c_int64),
                              ("phase2", ctypes.c_int64)]


class _CorrArgs(ctypes.Structure):
    # mirrors struct CorrArgs in csrc/step_flat.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "idx", "lam", "t", "A", "M", "dtb", "dlb", "sm", "base", "mb",
        "geff", "co")] + [("B", ctypes.c_int64), ("N", ctypes.c_int64),
                          ("phase2", ctypes.c_int64)]


def prep_flat_ref(idx_tab, lam, t, A, M, mb, base, pdreg, *, NB, NZ,
                  phase2):
    """Plain PyTorch version of :func:`prep_flat`: per stage, the box fold
    (Qx, qx) scattered onto ``pdreg`` and ``base``."""
    idx = idx_tab.long()
    lamb, tb, Ab, mbb = (from_lanes(x) for x in (lam, t, A, mb))
    Mb = from_lanes(M) if phase2 else None
    gb, pdb = from_lanes(base), from_lanes(pdreg)
    dvec, geff = torch.empty_like(pdb), torch.empty_like(gb)
    for n in range(lamb.shape[1]):
        if phase2:
            Qx, qx = sm.qx_fold_res(NB, lamb[:, n], tb[:, n], mbb[:, n],
                                    Ab[:, n], Mb[:, n])
        else:
            Qx, qx = sm.qx_fold(NB, lamb[:, n], tb[:, n], mbb[:, n],
                                Ab[:, n])
        dvec[:, n] = sm.scatter_add_box(pdb[:, n], idx[n], Qx)
        geff[:, n] = sm.scatter_add_box(gb[:, n], idx[n], qx)
    return to_lanes(dvec), to_lanes(geff)


def alpha_sums_flat_ref(idx_tab, dz, lam, t, A, M, dl0, mb, *, NB, NZ,
                        phase2):
    """Plain PyTorch version of :func:`alpha_sums_flat`."""
    idx = idx_tab.long()
    dzb = from_lanes(dz)
    lamb, tb, Ab, mbb = (from_lanes(x) for x in (lam, t, A, mb))
    Mb = from_lanes(M) if phase2 else None
    dl0b = from_lanes(dl0) if dl0 is not None else None
    dtl, dll = torch.empty_like(lamb), torch.empty_like(lamb)
    parts = lamb.new_empty(4, lamb.shape[0], lamb.shape[1])
    for n in range(lamb.shape[1]):
        zb = sm.gather_box(dzb[:, n], idx[n])
        d_t, d_l = sm.box_dir(NB, phase2, lamb[:, n], tb[:, n], mbb[:, n],
                              Ab[:, n], Mb[:, n] if phase2 else None, zb,
                              dl0b[:, n] if dl0b is not None else 0.0)
        dtl[:, n], dll[:, n] = d_t, d_l
        for i, p in enumerate(sm.alpha_partials(lamb[:, n], tb[:, n],
                                                mbb[:, n], d_t, d_l)):
            parts[i, :, n] = p
    amin, s0, s1, s2 = parts.movedim(1, -1).contiguous().unbind(0)
    return to_lanes(dtl), to_lanes(dll), amin, s0, s1, s2


def corr_geff_flat_ref(idx_tab, lam, t, A, M, dtb, dlb, smv, base, mb, *,
                       NB, NZ, phase2):
    """Plain PyTorch version of :func:`corr_geff_flat`."""
    idx = idx_tab.long()
    lamb, tb, Ab, mbb = (from_lanes(x) for x in (lam, t, A, mb))
    Mb = from_lanes(M) if phase2 else None
    dtab, dlab, gb = from_lanes(dtb), from_lanes(dlb), from_lanes(base)
    geff, co = torch.empty_like(gb), torch.empty_like(lamb)
    for n in range(lamb.shape[1]):
        if phase2:
            co[:, n], qx = sm.corr_co_qx_res(
                NB, lamb[:, n], tb[:, n], mbb[:, n], Ab[:, n], Mb[:, n],
                dtab[:, n], dlab[:, n], smv)
        else:
            co[:, n], qx = sm.corr_co_qx(
                NB, lamb[:, n], tb[:, n], mbb[:, n], Ab[:, n], dtab[:, n],
                dlab[:, n], smv)
        geff[:, n] = sm.scatter_add_box(gb[:, n], idx[n], qx)
    return to_lanes(geff), to_lanes(co)


def _launch_step(name, args_t, named, shapes, outs, phase2, NB, NZ):
    """Checks, build and launch shared by the three step_flat wrappers:
    ``named`` are the inputs (None entries are passed as NULL), ``outs``
    the outputs allocated by the caller, in the Args struct's order."""
    lam = named["lam"]
    _build.check_tensors(lam.device, lam.dtype,
                         {k: v for k, v in named.items() if v is not None},
                         shapes)
    Np1, B = lam.shape[0], lam.shape[-1]
    a = args_t(*[_build.ptr(x) for x in (*named.values(), *outs)],
               B, Np1 - 1, int(phase2))
    _build.launch("step_flat", name, a, lam.device, lam.dtype, NZ=NZ, NB=NB)
    LAUNCHES[name][int(phase2)] += 1


def _step_device(name, lam, phase2, M):
    """The CPU/CUDA switch shared by the step_flat wrappers: True for the
    plain version (counted), False for the kernel; raises on another
    device or a phase/M mismatch."""
    if lam.device.type == "cpu":
        PLAIN_CALLS[name][int(phase2)] += 1
        return True
    if lam.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {lam.device}")
    if phase2 != (M is not None):
        raise ValueError(f"{name}: M is required in phase 2 and only there")
    return False


def prep_flat(idx_tab, lam, t, A, M, mb, base, pdreg, *, NB, NZ, phase2):
    """Barrier Hessian diagonal + effective gradient, one pass.

    Box streams ``lam``/``t``/``A``/``M``/``mb`` (N+1, 2NB, B) (``A`` =
    d_cat and ``M`` None in phase 1, ``A`` = rd and ``M`` = rm in phase
    2), ``base`` the gradient base (g or rq) and ``pdreg`` = pad_diag +
    reg, both (N+1, NZ, B).  Returns ``(dvec, geff)``, each (N+1, NZ, B).

    CPU tensors run :func:`prep_flat_ref`; CUDA tensors launch
    ``csrc/step_flat.cu`` on the current stream (no sync)."""
    kw = dict(NB=NB, NZ=NZ, phase2=bool(phase2))
    if _step_device("prep_flat", lam, phase2, M):
        return prep_flat_ref(idx_tab, lam, t, A, M, mb, base, pdreg, **kw)
    Np1, B = lam.shape[0], lam.shape[-1]
    box, zs = (Np1, 2 * NB, B), (Np1, NZ, B)
    named = dict(idx_tab=idx_tab, lam=lam, t=t, A=A, M=M, mb=mb, base=base,
                 pdreg=pdreg)
    shapes = dict(idx_tab=(Np1, NB), lam=box, t=box, A=box, M=box, mb=box,
                  base=zs, pdreg=zs)
    dvec, geff = torch.empty(2, *zs, dtype=lam.dtype,
                             device=lam.device).unbind(0)
    _launch_step("prep_flat", _PrepArgs, named, shapes, (dvec, geff),
                 phase2, NB, NZ)
    return dvec, geff


def alpha_sums_flat(idx_tab, dz, lam, t, A, M, dl0, mb, *, NB, NZ, phase2):
    """Box (dt, dlam) of the z direction ``dz`` (N+1, NZ, B) plus the
    per-stage fraction-to-boundary minimum and duality-gap partials.

    ``M`` is rm or rm2 in phase 2 (None in phase 1); ``dl0`` the phase-1
    centering stream of the corrector pass (None otherwise).  Returns
    ``(dt, dl, amin, s0, s1, s2)``: dt/dl (N+1, 2NB, B), the rest (N+1,
    B); the engine finishes with a min/sum over the stages and
    ``mu(a) = (s0 + a s1 + a^2 s2) / n_constr``.

    CPU tensors run :func:`alpha_sums_flat_ref`; CUDA tensors launch
    ``csrc/step_flat.cu`` (no sync)."""
    kw = dict(NB=NB, NZ=NZ, phase2=bool(phase2))
    if _step_device("alpha_sums_flat", lam, phase2, M):
        return alpha_sums_flat_ref(idx_tab, dz, lam, t, A, M, dl0, mb, **kw)
    if phase2 and dl0 is not None:
        raise ValueError("alpha_sums_flat: dl0 is a phase-1 input")
    Np1, B = lam.shape[0], lam.shape[-1]
    box = (Np1, 2 * NB, B)
    named = dict(idx_tab=idx_tab, dz=dz, lam=lam, t=t, A=A, M=M, dl0=dl0,
                 mb=mb)
    shapes = dict(idx_tab=(Np1, NB), dz=(Np1, NZ, B), lam=box, t=box, A=box,
                  M=box, dl0=box, mb=box)
    new = lambda *s: torch.empty(*s, dtype=lam.dtype,  # noqa: E731
                                 device=lam.device)
    dtl, dll = new(2, *box).unbind(0)
    amin, s0, s1, s2 = new(4, Np1, B).unbind(0)
    _launch_step("alpha_sums_flat", _AlphaArgs, named, shapes,
                 (dtl, dll, amin, s0, s1, s2), phase2, NB, NZ)
    return dtl, dll, amin, s0, s1, s2


def corr_geff_flat(idx_tab, lam, t, A, M, dtb, dlb, smv, base, mb, *, NB,
                   NZ, phase2):
    """Corrector stream + second effective gradient in one pass.

    ``dtb``/``dlb`` are the affine box direction, ``smv`` (B,) sigma*mu.
    Returns ``(geff2, co)``: geff2 (N+1, NZ, B) and ``co`` (N+1, 2NB, B),
    the phase-1 centering correction dl2 or the phase-2 corrected
    complementarity residual rm2 (both consumed by the corrector
    :func:`alpha_sums_flat`).

    CPU tensors run :func:`corr_geff_flat_ref`; CUDA tensors launch
    ``csrc/step_flat.cu`` (no sync)."""
    kw = dict(NB=NB, NZ=NZ, phase2=bool(phase2))
    if _step_device("corr_geff_flat", lam, phase2, M):
        return corr_geff_flat_ref(idx_tab, lam, t, A, M, dtb, dlb, smv,
                                  base, mb, **kw)
    Np1, B = lam.shape[0], lam.shape[-1]
    box, zs = (Np1, 2 * NB, B), (Np1, NZ, B)
    named = dict(idx_tab=idx_tab, lam=lam, t=t, A=A, M=M, dtb=dtb, dlb=dlb,
                 smv=smv, base=base, mb=mb)
    shapes = dict(idx_tab=(Np1, NB), lam=box, t=box, A=box, M=box, dtb=box,
                  dlb=box, smv=(B,), base=zs, mb=box)
    geff = torch.empty(zs, dtype=lam.dtype, device=lam.device)
    co = torch.empty(box, dtype=lam.dtype, device=lam.device)
    _launch_step("corr_geff_flat", _CorrArgs, named, shapes, (geff, co),
                 phase2, NB, NZ)
    return geff, co


# ---------------------------------------------------------------------------
# soft-constraint step passes (csrc/soft_step_flat.cu), the 6-kernel loop of
# the soft lanes engine: single-loop, phase-1 (delta) box formulas only
# ---------------------------------------------------------------------------

#: launches of each soft_step_flat kernel in this process
SOFT_LAUNCHES = {"soft_prep_flat": 0, "soft_alpha_sums_flat": 0,
                 "soft_corr_flat": 0}
#: calls of each soft_step_flat wrapper that ran the plain version
SOFT_PLAIN_CALLS = {"soft_prep_flat": 0, "soft_alpha_sums_flat": 0,
                    "soft_corr_flat": 0}


class _SoftPrepArgs(ctypes.Structure):
    # mirrors struct SoftPrepArgs in csrc/soft_step_flat.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "idxb", "idxs", "lam", "t", "A", "mb", "lam_s", "t_s", "soft_c",
        "ms", "base", "pdreg", "dvec", "geff")] + [
        ("B", ctypes.c_int64), ("N", ctypes.c_int64), ("flag", ctypes.c_int64)]


class _SoftAlphaArgs(ctypes.Structure):
    # mirrors struct SoftAlphaArgs in csrc/soft_step_flat.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "idxb", "idxs", "dz", "lam", "t", "A", "mb", "lam_s", "t_s",
        "soft_c", "ms", "dl0b", "dl2s", "dtb", "dlb", "dts", "dls", "amin",
        "s0", "s1", "s2")] + [
        ("B", ctypes.c_int64), ("N", ctypes.c_int64), ("flag", ctypes.c_int64)]


class _SoftCorrArgs(ctypes.Structure):
    # mirrors struct SoftCorrArgs in csrc/soft_step_flat.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "idxb", "idxs", "lam", "t", "A", "mb", "lam_s", "t_s", "soft_c",
        "ms", "dtb", "dlb", "dts", "dls", "sm", "base", "geff", "dl2b",
        "dl2s")] + [
        ("B", ctypes.c_int64), ("N", ctypes.c_int64), ("flag", ctypes.c_int64)]


def _soft_streams(idx_tab, idxs_tab, lam, t, A, mb, lam_s, t_s, soft_c, ms):
    """The box and soft streams of a soft pass, batch-first, and the two
    index tables as int64."""
    return ((idx_tab.long(), idxs_tab.long())
            + tuple(from_lanes(x) for x in (lam, t, A, mb, lam_s, t_s,
                                            soft_c, ms)))


def soft_prep_flat_ref(idx_tab, idxs_tab, lam, t, A, mb, lam_s, t_s, soft_c,
                       ms, base, pdreg, *, NB, NS, NZ):
    """Plain PyTorch version of :func:`soft_prep_flat`: per stage, the box
    fold and the soft Schur fold scattered onto ``pdreg`` and ``base``."""
    idx, idxs, lamb, tb, Ab, mbb, lsb, tsb, cb, msb = _soft_streams(
        idx_tab, idxs_tab, lam, t, A, mb, lam_s, t_s, soft_c, ms)
    gb, pdb = from_lanes(base), from_lanes(pdreg)
    dvec, geff = torch.empty_like(pdb), torch.empty_like(gb)
    for n in range(lamb.shape[1]):
        Qx, qx = sm.qx_fold(NB, lamb[:, n], tb[:, n], mbb[:, n], Ab[:, n])
        S = sm.soft_schur(NS, lsb[:, n], tsb[:, n], msb[:, n], cb[:, n])
        Qs, qs = sm.soft_qx(msb[:, n], S)
        dvec[:, n] = sm.scatter_add_box(
            sm.scatter_add_box(pdb[:, n], idx[n], Qx), idxs[n], Qs)
        geff[:, n] = sm.scatter_add_box(
            sm.scatter_add_box(gb[:, n], idx[n], qx), idxs[n], qs)
    return to_lanes(dvec), to_lanes(geff)


def soft_alpha_sums_flat_ref(idx_tab, idxs_tab, dz, lam, t, A, mb, lam_s,
                             t_s, soft_c, ms, dl0b, dl2s, *, NB, NS, NZ,
                             corrector):
    """Plain PyTorch version of :func:`soft_alpha_sums_flat`."""
    idx, idxs, lamb, tb, Ab, mbb, lsb, tsb, cb, msb = _soft_streams(
        idx_tab, idxs_tab, lam, t, A, mb, lam_s, t_s, soft_c, ms)
    dzb = from_lanes(dz)
    d0b = from_lanes(dl0b) if corrector else None
    d2s = from_lanes(dl2s) if corrector else None
    dtb, dlb = torch.empty_like(lamb), torch.empty_like(lamb)
    dts, dls = torch.empty_like(lsb), torch.empty_like(lsb)
    parts = lamb.new_empty(4, lamb.shape[0], lamb.shape[1])
    for n in range(lamb.shape[1]):
        out = sm.soft_alpha_pass(
            NB, NS, lamb[:, n], tb[:, n], mbb[:, n], Ab[:, n], lsb[:, n],
            tsb[:, n], msb[:, n], cb[:, n], sm.gather_box(dzb[:, n], idx[n]),
            sm.gather_box(dzb[:, n], idxs[n]),
            d0b[:, n] if corrector else 0.0,
            d2s[:, n] if corrector else None)
        dtb[:, n], dlb[:, n], dts[:, n], dls[:, n] = out[:4]
        for i, p in enumerate(out[4:]):
            parts[i, :, n] = p
    amin, s0, s1, s2 = parts.movedim(1, -1).contiguous().unbind(0)
    return (to_lanes(dtb), to_lanes(dlb), to_lanes(dts), to_lanes(dls),
            amin, s0, s1, s2)


def soft_corr_flat_ref(idx_tab, idxs_tab, lam, t, A, mb, lam_s, t_s, soft_c,
                       ms, dtb, dlb, dts, dls, smv, base, *, NB, NS, NZ,
                       exact):
    """Plain PyTorch version of :func:`soft_corr_flat`."""
    idx, idxs, lamb, tb, Ab, mbb, lsb, tsb, cb, msb = _soft_streams(
        idx_tab, idxs_tab, lam, t, A, mb, lam_s, t_s, soft_c, ms)
    dtab, dlab, dtsb, dlsb, gb = (from_lanes(x)
                                  for x in (dtb, dlb, dts, dls, base))
    geff = torch.empty_like(gb)
    dl2b, dl2s = torch.empty_like(lamb), torch.empty_like(lsb)
    for n in range(lamb.shape[1]):
        dl2b[:, n], qx = sm.corr_co_qx(NB, lamb[:, n], tb[:, n], mbb[:, n],
                                       Ab[:, n], dtab[:, n], dlab[:, n], smv)
        S = sm.soft_schur(NS, lsb[:, n], tsb[:, n], msb[:, n], cb[:, n])
        dl2s[:, n], qs = sm.soft_corr_qx(NS, msb[:, n], S, dtsb[:, n],
                                         dlsb[:, n], smv, exact)
        geff[:, n] = sm.scatter_add_box(
            sm.scatter_add_box(gb[:, n], idx[n], qx), idxs[n], qs)
    return to_lanes(geff), to_lanes(dl2b), to_lanes(dl2s)


def _soft_step_device(name, lam):
    """The CPU/CUDA switch of the soft step wrappers: True for the plain
    version (counted), False for the kernel; raises on another device."""
    if lam.device.type == "cpu":
        SOFT_PLAIN_CALLS[name] += 1
        return True
    if lam.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {lam.device}")
    return False


def _soft_shapes(lam, NB, NS, NZ):
    """The shapes of the streams a soft pass takes (N+1 stages, B
    instances)."""
    Np1, B = lam.shape[0], lam.shape[-1]
    box, s4 = (Np1, 2 * NB, B), (Np1, 4 * NS, B)
    return dict(idx_tab=(Np1, NB), idxs_tab=(Np1, NS), lam=box, t=box, A=box,
                mb=box, lam_s=s4, t_s=s4, soft_c=(Np1, 6 * NS, B),
                ms=(Np1, NS, B), base=(Np1, NZ, B), pdreg=(Np1, NZ, B),
                dz=(Np1, NZ, B), dl0b=box, dl2s=s4, dtb=box, dlb=box, dts=s4,
                dls=s4, smv=(B,))


def _launch_soft(name, args_t, named, outs, flag, NB, NS, NZ):
    """Checks, build and launch shared by the soft step wrappers (None
    inputs are passed as NULL)."""
    lam = named["lam"]
    _build.check_tensors(lam.device, lam.dtype,
                         {k: v for k, v in named.items() if v is not None},
                         _soft_shapes(lam, NB, NS, NZ))
    Np1, B = lam.shape[0], lam.shape[-1]
    a = args_t(*[_build.ptr(x) for x in (*named.values(), *outs)],
               B, Np1 - 1, int(flag))
    _build.launch("soft_step_flat", name, a, lam.device, lam.dtype, NZ=NZ,
                  NB=NB, NS=NS)
    SOFT_LAUNCHES[name] += 1


def soft_prep_flat(idx_tab, idxs_tab, lam, t, A, mb, lam_s, t_s, soft_c, ms,
                   base, pdreg, *, NB, NS, NZ):
    """Soft-IPM barrier Hessian diagonal + effective gradient, one pass:
    the box fold and the soft slack Schur fold, both scattered.

    Box streams ``lam``/``t``/``A`` (= d_cat)/``mb`` (N+1, 2NB, B), soft
    streams ``lam_s``/``t_s`` (N+1, 4NS, B), the packed constants
    ``soft_c`` (N+1, 6NS, B) and mask ``ms`` (N+1, NS, B), ``base``/
    ``pdreg`` (N+1, NZ, B), the index tables ``idx_tab`` (N+1, NB) and
    ``idxs_tab`` (N+1, NS) int32 (padded-z coordinates; padded slots point
    at 0 under a zero mask).  Returns ``(dvec, geff)``, each (N+1, NZ, B).

    CPU tensors run :func:`soft_prep_flat_ref`; CUDA tensors launch
    ``csrc/soft_step_flat.cu`` on the current stream (no sync)."""
    ins = (idx_tab, idxs_tab, lam, t, A, mb, lam_s, t_s, soft_c, ms, base,
           pdreg)
    if _soft_step_device("soft_prep_flat", lam):
        return soft_prep_flat_ref(*ins, NB=NB, NS=NS, NZ=NZ)
    named = dict(zip(("idx_tab", "idxs_tab", "lam", "t", "A", "mb", "lam_s",
                      "t_s", "soft_c", "ms", "base", "pdreg"), ins))
    dvec, geff = torch.empty(2, *base.shape, dtype=lam.dtype,
                             device=lam.device).unbind(0)
    _launch_soft("soft_prep_flat", _SoftPrepArgs, named, (dvec, geff), 0,
                 NB, NS, NZ)
    return dvec, geff


def soft_alpha_sums_flat(idx_tab, idxs_tab, dz, lam, t, A, mb, lam_s, t_s,
                         soft_c, ms, dl0b, dl2s, *, NB, NS, NZ, corrector):
    """Box + soft directions of the z direction ``dz`` (N+1, NZ, B), the
    per-stage fraction-to-boundary minimum and the mu(alpha) partials over
    both families.  The corrector pass (``corrector``) takes the centering
    corrections ``dl0b`` (N+1, 2NB, B) and ``dl2s`` (N+1, 4NS, B) of
    :func:`soft_corr_flat`; the affine pass takes None for both.  Returns
    ``(dtb, dlb, dts, dls, amin, s0, s1, s2)``.

    CPU tensors run :func:`soft_alpha_sums_flat_ref`; CUDA tensors launch
    ``csrc/soft_step_flat.cu`` (no sync)."""
    if corrector != (dl0b is not None) or corrector != (dl2s is not None):
        raise ValueError("soft_alpha_sums_flat: dl0b and dl2s are the "
                         "corrector pass's inputs, and only its")
    ins = (idx_tab, idxs_tab, dz, lam, t, A, mb, lam_s, t_s, soft_c, ms,
           dl0b, dl2s)
    if _soft_step_device("soft_alpha_sums_flat", lam):
        return soft_alpha_sums_flat_ref(*ins, NB=NB, NS=NS, NZ=NZ,
                                        corrector=corrector)
    named = dict(zip(("idx_tab", "idxs_tab", "dz", "lam", "t", "A", "mb",
                      "lam_s", "t_s", "soft_c", "ms", "dl0b", "dl2s"), ins))
    new = lambda *s: torch.empty(*s, dtype=lam.dtype,  # noqa: E731
                                 device=lam.device)
    dtb, dlb = new(2, *lam.shape).unbind(0)
    dts, dls = new(2, *lam_s.shape).unbind(0)
    amin, s0, s1, s2 = new(4, lam.shape[0], lam.shape[-1]).unbind(0)
    _launch_soft("soft_alpha_sums_flat", _SoftAlphaArgs, named,
                 (dtb, dlb, dts, dls, amin, s0, s1, s2), corrector, NB, NS,
                 NZ)
    return dtb, dlb, dts, dls, amin, s0, s1, s2


def soft_corr_flat(idx_tab, idxs_tab, lam, t, A, mb, lam_s, t_s, soft_c, ms,
                   dtb, dlb, dts, dls, smv, base, *, NB, NS, NZ, exact):
    """Soft corrector gradient pass: the centering corrections of both
    families and the second effective gradient.  ``dtb``/``dlb``/``dts``/
    ``dls`` are the affine directions, ``smv`` (B,) sigma*mu; ``exact``
    keeps the Schur-folded soft correction of the gradient (False: the
    reference's dropped correction).  Returns ``(geff2, dl2b, dl2s)``.

    CPU tensors run :func:`soft_corr_flat_ref`; CUDA tensors launch
    ``csrc/soft_step_flat.cu`` (no sync)."""
    ins = (idx_tab, idxs_tab, lam, t, A, mb, lam_s, t_s, soft_c, ms, dtb,
           dlb, dts, dls, smv, base)
    if _soft_step_device("soft_corr_flat", lam):
        return soft_corr_flat_ref(*ins, NB=NB, NS=NS, NZ=NZ, exact=exact)
    named = dict(zip(("idx_tab", "idxs_tab", "lam", "t", "A", "mb", "lam_s",
                      "t_s", "soft_c", "ms", "dtb", "dlb", "dts", "dls",
                      "smv", "base"), ins))
    new = lambda *s: torch.empty(*s, dtype=lam.dtype,  # noqa: E731
                                 device=lam.device)
    geff, dl2b, dl2s = new(*base.shape), new(*lam.shape), new(*lam_s.shape)
    _launch_soft("soft_corr_flat", _SoftCorrArgs, named, (geff, dl2b, dl2s),
                 exact, NB, NS, NZ)
    return geff, dl2b, dl2s


class _ResidArgs(ctypes.Structure):
    # mirrors struct ResidArgs in csrc/resid_full.cu, field for field
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "idx", "H", "F", "z", "pi", "g", "b", "lam", "t", "dcat", "mb",
        "zmask", "xmask", "rq", "rb", "rd", "rm", "musum")] + [
        ("B", ctypes.c_int64), ("N", ctypes.c_int64)]


def resid_full_ref(idx_tab, H, F, z, pi, g, b, lam, t, dcat, mb, zmask,
                   xmask, *, NB, NU, NZ, NX):
    """Plain PyTorch version of :func:`resid_full` (same arguments, same
    outputs).  Computes, per stage n:

      rq = (g + H z + [n<N] F pi_n - [n>0] [0; pi_{n-1}]
            + scatter(idx, (lam_up - lam_lo) mb)) * z_mask
      rb = (b + F' z - x_{n+1}) * x_mask      (stage N: clipped garbage)
      rd = (d - [zb; zb] + [t_lo; -t_up]) * mb,  rm = lam t mb
      musum = sum(rm)
    """
    Np1 = z.shape[0]
    N = Np1 - 1
    B = z.shape[-1]
    dt = z.dtype
    idx = idx_tab.long()
    Hs = from_lanes(H)                          # (B, N+1, NT)
    Hf = sym_expand(Hs, NZ)                     # (B, N+1, NZ, NZ)
    Fb = from_lanes(F)                          # (B, N, NZ, NX)
    zb_ = from_lanes(z)                         # (B, N+1, NZ)
    pib = from_lanes(pi)                        # (B, N, NX)
    gb, bb = from_lanes(g), from_lanes(b)
    lamb, tb = from_lanes(lam), from_lanes(t)
    dcb, mbb = from_lanes(dcat), from_lanes(mb)
    zmb, xmb = from_lanes(zmask), from_lanes(xmask)

    rq = torch.empty(B, Np1, NZ, dtype=dt, device=z.device)
    rb = torch.empty(B, Np1, NX, dtype=dt, device=z.device)
    rd = torch.empty(B, Np1, 2 * NB, dtype=dt, device=z.device)
    rm = torch.empty(B, Np1, 2 * NB, dtype=dt, device=z.device)
    for n in range(Np1):
        ne = min(n, N - 1)
        zn = zb_[:, n]
        acc = gb[:, n] + (Hf[:, n] @ zn[..., None])[..., 0]
        fpi = (Fb[:, ne] @ pib[:, ne][..., None])[..., 0]
        acc = acc + float(n < N) * fpi
        pip = pib[:, min(max(n - 1, 0), N - 1)]
        acc = torch.cat(
            [acc[:, :NU], acc[:, NU:] - float(n > 0) * pip], dim=1)
        lam_f = (lamb[:, n, NB:] - lamb[:, n, :NB]) * mbb[:, n, :NB]
        acc = sm.scatter_add_box(acc, idx[n], lam_f)
        rq[:, n] = acc * zmb[:, n]

        fz = (Fb[:, ne].transpose(-1, -2) @ zn[..., None])[..., 0]
        rb[:, n] = (bb[:, ne] + fz - zb_[:, min(n + 1, N), NU:]) * xmb[:, ne]

        zbox = sm.gather_box(zn, idx[n])
        zb2 = torch.cat([zbox, zbox], dim=1)
        sg = torch.cat([torch.ones_like(zbox), -torch.ones_like(zbox)], 1)
        rd[:, n] = (dcb[:, n] - zb2 + sg * tb[:, n]) * mbb[:, n]
        rm[:, n] = lamb[:, n] * tb[:, n] * mbb[:, n]
    musum = rm.sum(-1)
    return (to_lanes(rq), to_lanes(rb), to_lanes(rd), to_lanes(rm),
            to_lanes(musum))


def resid_full(idx_tab, H, F, z, pi, g, b, lam, t, dcat, mb, zmask, xmask,
               *, NB, NU, NZ, NX):
    """Exact KKT residuals (rq, rb, rd, rm, musum) of a batch-last iterate.

    Shapes: ``H`` (N+1, NT, B) packed, ``F`` (N, NZ, NX, B), ``z``/``g``/
    ``zmask`` (N+1, NZ, B), ``pi``/``b``/``xmask`` (N, NX, B), box streams
    (N+1, 2NB, B).  Returns rq (N+1, NZ, B), rb (N+1, NX, B) whose stage-N
    slot is garbage (slice ``[:N]``), rd/rm (N+1, 2NB, B) and the per-stage
    complementarity sum musum (N+1, B).

    CPU tensors run :func:`resid_full_ref`; CUDA tensors launch the
    ``csrc/resid_full.cu`` kernel on the current stream (no sync)."""
    global RESID_LAUNCHES
    args = (idx_tab, H, F, z, pi, g, b, lam, t, dcat, mb, zmask, xmask)
    if z.device.type == "cpu":
        return resid_full_ref(*args, NB=NB, NU=NU, NZ=NZ, NX=NX)
    if z.device.type != "cuda":
        raise ValueError(f"resid_full: unsupported device {z.device}")
    Np1, B = z.shape[0], z.shape[-1]
    N = Np1 - 1
    NT = sym_nt(NZ)
    NB2 = 2 * NB
    shapes = {
        "idx_tab": (Np1, NB), "H": (Np1, NT, B), "F": (N, NZ, NX, B),
        "z": (Np1, NZ, B), "pi": (N, NX, B), "g": (Np1, NZ, B),
        "b": (N, NX, B), "lam": (Np1, NB2, B), "t": (Np1, NB2, B),
        "dcat": (Np1, NB2, B), "mb": (Np1, NB2, B), "zmask": (Np1, NZ, B),
        "xmask": (N, NX, B),
    }
    names = ("idx_tab", "H", "F", "z", "pi", "g", "b", "lam", "t", "dcat",
             "mb", "zmask", "xmask")
    _build.check_tensors(z.device, z.dtype, dict(zip(names, args)), shapes)
    new = lambda *s: torch.empty(*s, dtype=z.dtype, device=z.device)  # noqa: E731
    rq, rb = new(Np1, NZ, B), new(Np1, NX, B)
    rd, rm = new(Np1, NB2, B), new(Np1, NB2, B)
    musum = new(Np1, B)
    a = _ResidArgs(*[_build.ptr(x) for x in args],
                   *[_build.ptr(x) for x in (rq, rb, rd, rm, musum)],
                   B, N)
    _build.launch("resid_full", "resid_full", a, z.device, z.dtype, NU=NU,
                  NX=NX, NB=NB)
    RESID_LAUNCHES += 1
    return rq, rb, rd, rm, musum
