"""Mega-sweep kernels: one launch per IPM half-iteration, CUDA + plain
versions.

Port of ``hpmpc_tpu/ops/mega_kernel.py``'s hard pair (TPU bodies
``_sv_mega_kernel`` / ``_trs_mega_kernel``):

  * :func:`factor_solve_mega` — barrier prep (Hessian diagonal, gradient,
    general-constraint terms on their stages) feeding the folded backward
    Riccati factorization stage by stage, then the pi-less forward
    recovery with the affine fraction-to-boundary / mu(alpha) partials;
  * :func:`solve_mega` — the centering/corrector gradient feeding the
    retained-factor backward substitution, then the forward recovery with
    pi and the corrector partials.

``phase2`` picks the box formulas: phase 1 is the delta formulation
(``A`` = d_cat, no ``M``), phase 2 the residual one (``A`` = rd, ``M`` =
rm).  The per-stage partials ``(amin, s0, s1, s2)`` come back per stage
and are reduced by the engine (:mod:`..models.ipm_lanes`), as in the JAX
package.

Layout (:mod:`.layout`): batch-last streams, ``(N+1, k, B)``; the factor
state ``fstate = (Ll (N+1, NZ, NU, B), Lxx (N+1, NX, NX, B), Pb (N, NX,
B))`` with zero upper triangles.  General constraints sit on the stages
``ng_stage_ids`` (slot j on stage ``ng_stage_ids[j]``): ``ngl`` (n_ng, NT,
B) is the packed C' diag(Qx_g) C term, ``ngadd`` (n_ng, NZ, B) the C' v
gradient term; both are None when there are no such stages.

The soft pair (:func:`factor_solve_soft_mega`, :func:`solve_soft_mega`,
TPU bodies ``_soft_sv_mega_kernel`` / ``_soft_trs_mega_kernel``) is the
same two half-iterations of the single-loop soft IPM (always the phase-1
box formulas): the 4-slack-family Schur elimination joins the prep of
each backward stage, the combined box + soft alpha pass the forward one.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import stage_kernel as sk
from . import step_kernel as stk
from .layout import sym_nt

#: launches of each CUDA kernel in this process, [phase 1, phase 2]
LAUNCHES = {"factor_solve_mega": [0, 0], "solve_mega": [0, 0]}
#: calls of each wrapper that ran the plain version (CPU tensors),
#: [phase 1, phase 2]
PLAIN_CALLS = {"factor_solve_mega": [0, 0], "solve_mega": [0, 0]}


class _FactorArgs(ctypes.Structure):
    # mirrors struct FactorSolveMegaArgs in csrc/factor_solve_mega.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "idx", "lam", "t", "A", "M", "mb", "base", "pdreg", "H", "ngl",
        "ngadd", "ng_stage", "F", "b", "Ll", "Lxx", "Pb", "z", "dt", "dl",
        "amin", "s0", "s1", "s2", "work")] + [
        ("B", ctypes.c_int64), ("N", ctypes.c_int64),
        ("n_ng", ctypes.c_int64), ("phase2", ctypes.c_int64)]


class _SolveArgs(ctypes.Structure):
    # mirrors struct SolveMegaArgs in csrc/solve_mega.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "idx", "lam", "t", "A", "M", "mb", "dtb", "dlb", "sm", "base",
        "ngadd", "ng_stage", "Ll", "Lxx", "Pb", "F", "b", "z", "pi", "dt",
        "dl", "amin", "s0", "s1", "s2", "work")] + [
        ("B", ctypes.c_int64), ("N", ctypes.c_int64),
        ("n_ng", ctypes.c_int64), ("phase2", ctypes.c_int64)]


def factor_solve_mega_ref(idx_tab, lam, t, A, M, mb, base, pdreg, H, ngl,
                          ngadd, ng_stage_ids, F, b, *, NB, NU, NZ, NX,
                          phase2):
    """Plain PyTorch version of :func:`factor_solve_mega` (same arguments,
    same outputs): the 6-kernel loop's affine half composed from its plain
    passes, prep + the ng gradient rows + the folded factorization + the
    alpha pass."""
    dvec, g = stk.prep_flat_ref(idx_tab, lam, t, A, M, mb, base, pdreg,
                                NB=NB, NZ=NZ, phase2=phase2)
    for j, n in enumerate(ng_stage_ids):
        g[n] += ngadd[j]
    z, _, fstate = sk.factor_solve_folded_flat_ref(
        H, dvec, ngl, ng_stage_ids, g, F, b, NU=NU, NZ=NZ, NX=NX,
        want_pi=False)
    return (z, fstate) + stk.alpha_sums_flat_ref(
        idx_tab, z, lam, t, A, M, None, mb, NB=NB, NZ=NZ, phase2=phase2)


def solve_mega_ref(idx_tab, fstate, lam, t, A, M, mb, dtb, dlb, smv, base,
                   ngadd, ng_stage_ids, F, b, *, NB, NU, NZ, NX, phase2):
    """Plain PyTorch version of :func:`solve_mega` (same arguments, same
    outputs): the corrector pass + the ng gradient rows + the
    retained-factor solve + the alpha pass with the corrector stream (dl0
    in phase 1, M = rm2 in phase 2)."""
    g, co = stk.corr_geff_flat_ref(idx_tab, lam, t, A, M, dtb, dlb, smv,
                                   base, mb, NB=NB, NZ=NZ, phase2=phase2)
    for j, n in enumerate(ng_stage_ids):
        g[n] += ngadd[j]
    z, pi = sk.solve_flat_ref(*fstate, g, F, b, NU=NU, NZ=NZ, NX=NX)
    return (z, pi) + stk.alpha_sums_flat_ref(
        idx_tab, z, lam, t, A, co if phase2 else None,
        None if phase2 else co, mb, NB=NB, NZ=NZ, phase2=phase2)


def _check(name, lam, phase2, M, ng_stage_ids, named, shapes):
    """Device / dtype / shape / contiguity checks shared by both wrappers:
    raise on anything the kernels do not take."""
    if lam.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {lam.device}")
    if phase2 != (M is not None):
        raise ValueError(f"{name}: M is required in phase 2 and only there")
    n_ng = len(ng_stage_ids)
    for key in ("ngl", "ngadd"):
        if key in named and (named[key] is None) != (n_ng == 0):
            raise ValueError(f"{name}: {key} must be given iff there are "
                             "ng stages")
    _build.check_tensors(lam.device, lam.dtype,
                         {k: v for k, v in named.items() if v is not None},
                         shapes)


def factor_solve_mega(idx_tab, lam, t, A, M, mb, base, pdreg, H, ngl, ngadd,
                      ng_stage_ids, F, b, *, NB, NU, NZ, NX, phase2):
    """Barrier prep + folded factorization + pi-less forward + affine
    alpha/mu partials in one launch (one affine half-iteration).

    Inputs: box streams ``lam``/``t``/``A``/``M``/``mb`` (N+1, 2NB, B)
    (``M`` None in phase 1), gradient base ``base`` and ``pdreg`` (N+1, NZ,
    B), packed ``H`` (N+1, NT, B), ``ngl``/``ngadd`` (see the module doc),
    ``F`` (N, NZ, NX, B), ``b`` (N, NX, B), ``idx_tab`` (N+1, NB) int32.
    Returns ``(z, (Ll, Lxx, Pb), dt, dl, amin, s0, s1, s2)``: the affine
    direction z (N+1, NZ, B), the factor state, the box direction (N+1,
    2NB, B) and the per-stage partials (N+1, B).

    CPU tensors run :func:`factor_solve_mega_ref`; CUDA tensors launch
    ``csrc/factor_solve_mega.cu`` on the current stream (no sync)."""
    name = "factor_solve_mega"
    ph = int(bool(phase2))
    kw = dict(NB=NB, NU=NU, NZ=NZ, NX=NX, phase2=bool(phase2))
    ins = (idx_tab, lam, t, A, M, mb, base, pdreg, H, ngl, ngadd,
           tuple(ng_stage_ids), F, b)
    if lam.device.type == "cpu":
        PLAIN_CALLS[name][ph] += 1
        return factor_solve_mega_ref(*ins, **kw)
    Np1, B = lam.shape[0], lam.shape[-1]
    N, NB2, NT, n_ng = Np1 - 1, 2 * NB, sym_nt(NZ), len(ng_stage_ids)
    box = (Np1, NB2, B)
    named = dict(idx_tab=idx_tab, lam=lam, t=t, A=A, M=M, mb=mb, base=base,
                 pdreg=pdreg, H=H, ngl=ngl, ngadd=ngadd, F=F, b=b)
    shapes = dict(idx_tab=(Np1, NB), lam=box, t=box, A=box, M=box, mb=box,
                  base=(Np1, NZ, B), pdreg=(Np1, NZ, B), H=(Np1, NT, B),
                  ngl=(n_ng, NT, B), ngadd=(n_ng, NZ, B),
                  F=(N, NZ, NX, B), b=(N, NX, B))
    _check(name, lam, phase2, M, ng_stage_ids, named, shapes)
    dev, dt = lam.device, lam.dtype
    new = lambda *s: torch.empty(*s, dtype=dt, device=dev)  # noqa: E731
    Ll, Lxx, Pb = new(Np1, NZ, NU, B), new(Np1, NX, NX, B), new(N, NX, B)
    z, dtl, dll = new(Np1, NZ, B), new(Np1, NB2, B), new(Np1, NB2, B)
    amin, s0, s1, s2 = new(4, Np1, B).unbind(0)
    work = new(Np1 * (NU + NX), B)
    ptrs = (idx_tab, lam, t, A, M, mb, base, pdreg, H, ngl, ngadd,
            _build.ng_table(ng_stage_ids, dev), F, b, Ll, Lxx, Pb, z, dtl, dll,
            amin, s0, s1, s2, work)
    a = _FactorArgs(*[_build.ptr(x) for x in ptrs], B, N, n_ng, ph)
    _build.launch(name, name, a, dev, dt, NU=NU, NX=NX, NB=NB)
    LAUNCHES[name][ph] += 1
    return z, (Ll, Lxx, Pb), dtl, dll, amin, s0, s1, s2


def solve_mega(idx_tab, fstate, lam, t, A, M, mb, dtb, dlb, smv, base,
               ngadd, ng_stage_ids, F, b, *, NB, NU, NZ, NX, phase2):
    """Corrector gradient + retained-factor solve + forward with pi +
    corrector alpha/mu partials in one launch (one corrector
    half-iteration).

    ``fstate`` is :func:`factor_solve_mega`'s factor state, ``dtb``/``dlb``
    its affine box direction, ``smv`` (B,) sigma*mu.  In phase 1 the
    centering stream enters the box direction as dl0; in phase 2 the
    corrector residual rm2 enters as ``M``.  Returns ``(z, pi, dt, dl,
    amin, s0, s1, s2)`` with pi (N, NX, B).

    CPU tensors run :func:`solve_mega_ref`; CUDA tensors launch
    ``csrc/solve_mega.cu`` on the current stream (no sync)."""
    name = "solve_mega"
    ph = int(bool(phase2))
    kw = dict(NB=NB, NU=NU, NZ=NZ, NX=NX, phase2=bool(phase2))
    Ll, Lxx, Pb = fstate
    ins = (idx_tab, fstate, lam, t, A, M, mb, dtb, dlb, smv, base, ngadd,
           tuple(ng_stage_ids), F, b)
    if lam.device.type == "cpu":
        PLAIN_CALLS[name][ph] += 1
        return solve_mega_ref(*ins, **kw)
    Np1, B = lam.shape[0], lam.shape[-1]
    N, NB2, n_ng = Np1 - 1, 2 * NB, len(ng_stage_ids)
    box = (Np1, NB2, B)
    named = dict(idx_tab=idx_tab, lam=lam, t=t, A=A, M=M, mb=mb, dtb=dtb,
                 dlb=dlb, smv=smv, base=base, ngadd=ngadd, Ll=Ll, Lxx=Lxx,
                 Pb=Pb, F=F, b=b)
    shapes = dict(idx_tab=(Np1, NB), lam=box, t=box, A=box, M=box, mb=box,
                  dtb=box, dlb=box, smv=(B,), base=(Np1, NZ, B),
                  ngadd=(n_ng, NZ, B), Ll=(Np1, NZ, NU, B),
                  Lxx=(Np1, NX, NX, B), Pb=(N, NX, B), F=(N, NZ, NX, B),
                  b=(N, NX, B))
    _check(name, lam, phase2, M, ng_stage_ids, named, shapes)
    dev, dt = lam.device, lam.dtype
    new = lambda *s: torch.empty(*s, dtype=dt, device=dev)  # noqa: E731
    z, pi = new(Np1, NZ, B), new(N, NX, B)
    dtl, dll = new(Np1, NB2, B), new(Np1, NB2, B)
    amin, s0, s1, s2 = new(4, Np1, B).unbind(0)
    work = new(Np1 * (NU + NX + NB2), B)
    ptrs = (idx_tab, lam, t, A, M, mb, dtb, dlb, smv, base, ngadd,
            _build.ng_table(ng_stage_ids, dev), Ll, Lxx, Pb, F, b, z, pi, dtl,
            dll, amin, s0, s1, s2, work)
    a = _SolveArgs(*[_build.ptr(x) for x in ptrs], B, N, n_ng, ph)
    _build.launch(name, name, a, dev, dt, NU=NU, NX=NX, NB=NB)
    LAUNCHES[name][ph] += 1
    return z, pi, dtl, dll, amin, s0, s1, s2


# ---------------------------------------------------------------------------
# the soft pair (TPU bodies _soft_sv_mega_kernel / _soft_trs_mega_kernel):
# one launch per half-iteration of the single-loop soft IPM, always in the
# phase-1 (delta) box formulas, with the 4-slack-family streams beside the
# box ones (see :func:`.step_kernel.soft_prep_flat` for their layout)
# ---------------------------------------------------------------------------

#: launches of each soft mega kernel in this process
SOFT_LAUNCHES = {"factor_solve_soft_mega": 0, "solve_soft_mega": 0}
#: calls of each soft mega wrapper that ran the plain version
SOFT_PLAIN_CALLS = {"factor_solve_soft_mega": 0, "solve_soft_mega": 0}


class _SoftFactorArgs(ctypes.Structure):
    # mirrors struct FactorSolveSoftMegaArgs in csrc/factor_solve_soft_mega.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "idxb", "idxs", "lam", "t", "A", "mb", "lam_s", "t_s", "soft_c",
        "ms", "base", "pdreg", "H", "ngl", "ngadd", "ng_stage", "F", "b",
        "Ll", "Lxx", "Pb", "z", "dtb", "dlb", "dts", "dls", "amin", "s0",
        "s1", "s2", "work")] + [
        ("B", ctypes.c_int64), ("N", ctypes.c_int64),
        ("n_ng", ctypes.c_int64)]


class _SoftSolveArgs(ctypes.Structure):
    # mirrors struct SolveSoftMegaArgs in csrc/solve_soft_mega.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "idxb", "idxs", "lam", "t", "A", "mb", "lam_s", "t_s", "soft_c",
        "ms", "dtb", "dlb", "dts", "dls", "sm", "base", "ngadd", "ng_stage",
        "Ll", "Lxx", "Pb", "F", "b", "z", "pi", "dt2b", "dl2b", "dt2s",
        "dl2s", "amin", "s0", "s1", "s2", "work")] + [
        ("B", ctypes.c_int64), ("N", ctypes.c_int64),
        ("n_ng", ctypes.c_int64), ("exact", ctypes.c_int64)]


def factor_solve_soft_mega_ref(idx_tab, idxs_tab, lam, t, A, mb, lam_s, t_s,
                               soft_c, ms, base, pdreg, H, ngl, ngadd,
                               ng_stage_ids, F, b, *, NB, NS, NU, NZ, NX):
    """Plain PyTorch version of :func:`factor_solve_soft_mega`: the soft
    6-kernel loop's affine half composed from its plain passes, soft prep +
    the ng gradient rows + the folded factorization + the affine soft
    alpha pass."""
    dvec, g = stk.soft_prep_flat_ref(idx_tab, idxs_tab, lam, t, A, mb, lam_s,
                                     t_s, soft_c, ms, base, pdreg, NB=NB,
                                     NS=NS, NZ=NZ)
    for j, n in enumerate(ng_stage_ids):
        g[n] += ngadd[j]
    z, _, fstate = sk.factor_solve_folded_flat_ref(
        H, dvec, ngl, ng_stage_ids, g, F, b, NU=NU, NZ=NZ, NX=NX,
        want_pi=False)
    return (z, fstate) + stk.soft_alpha_sums_flat_ref(
        idx_tab, idxs_tab, z, lam, t, A, mb, lam_s, t_s, soft_c, ms, None,
        None, NB=NB, NS=NS, NZ=NZ, corrector=False)


def solve_soft_mega_ref(idx_tab, idxs_tab, fstate, lam, t, A, mb, lam_s, t_s,
                        soft_c, ms, dtb, dlb, dts, dls, smv, base, ngadd,
                        ng_stage_ids, F, b, *, NB, NS, NU, NZ, NX, exact):
    """Plain PyTorch version of :func:`solve_soft_mega`: the soft corrector
    pass + the ng gradient rows + the retained-factor solve + the
    corrector soft alpha pass."""
    g, dl2b, dl2s = stk.soft_corr_flat_ref(
        idx_tab, idxs_tab, lam, t, A, mb, lam_s, t_s, soft_c, ms, dtb, dlb,
        dts, dls, smv, base, NB=NB, NS=NS, NZ=NZ, exact=exact)
    for j, n in enumerate(ng_stage_ids):
        g[n] += ngadd[j]
    z, pi = sk.solve_flat_ref(*fstate, g, F, b, NU=NU, NZ=NZ, NX=NX)
    return (z, pi) + stk.soft_alpha_sums_flat_ref(
        idx_tab, idxs_tab, z, lam, t, A, mb, lam_s, t_s, soft_c, ms, dl2b,
        dl2s, NB=NB, NS=NS, NZ=NZ, corrector=True)


def _soft_check(name, lam, ng_stage_ids, named, NB, NS, NU, NZ, NX):
    """Device / ng / dtype / shape / contiguity checks of a soft wrapper."""
    if lam.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {lam.device}")
    n_ng = len(ng_stage_ids)
    for key in ("ngl", "ngadd"):
        if key in named and (named[key] is None) != (n_ng == 0):
            raise ValueError(f"{name}: {key} must be given iff there are "
                             "ng stages")
    Np1, B = lam.shape[0], lam.shape[-1]
    N = Np1 - 1
    shapes = stk._soft_shapes(lam, NB, NS, NZ)
    shapes.update(H=(Np1, sym_nt(NZ), B), ngl=(n_ng, sym_nt(NZ), B),
                  ngadd=(n_ng, NZ, B), F=(N, NZ, NX, B), b=(N, NX, B),
                  Ll=(Np1, NZ, NU, B), Lxx=(Np1, NX, NX, B), Pb=(N, NX, B))
    _build.check_tensors(lam.device, lam.dtype,
                         {k: v for k, v in named.items() if v is not None},
                         shapes)


def factor_solve_soft_mega(idx_tab, idxs_tab, lam, t, A, mb, lam_s, t_s,
                           soft_c, ms, base, pdreg, H, ngl, ngadd,
                           ng_stage_ids, F, b, *, NB, NS, NU, NZ, NX):
    """Soft barrier prep (box fold + slack Schur elimination) + folded
    factorization + pi-less forward + the affine box+soft alpha/mu
    partials in one launch (one affine half-iteration of the soft IPM).

    Inputs: the box streams ``lam``/``t``/``A`` (= d_cat)/``mb`` (N+1,
    2NB, B), the soft streams ``lam_s``/``t_s`` (N+1, 4NS, B), ``soft_c``
    (N+1, 6NS, B), ``ms`` (N+1, NS, B), the index tables ``idx_tab`` (N+1,
    NB) and ``idxs_tab`` (N+1, NS), and as :func:`factor_solve_mega`
    ``base``/``pdreg``/``H``/``ngl``/``ngadd``/``F``/``b``.  Returns ``(z,
    (Ll, Lxx, Pb), dtb, dlb, dts, dls, amin, s0, s1, s2)``; the factor
    state has :func:`factor_solve_mega`'s layout, so :func:`solve_soft_mega`
    and :func:`.stage_kernel.solve_flat` take it.

    CPU tensors run :func:`factor_solve_soft_mega_ref`; CUDA tensors launch
    ``csrc/factor_solve_soft_mega.cu`` on the current stream (no sync)."""
    name = "factor_solve_soft_mega"
    kw = dict(NB=NB, NS=NS, NU=NU, NZ=NZ, NX=NX)
    ins = (idx_tab, idxs_tab, lam, t, A, mb, lam_s, t_s, soft_c, ms, base,
           pdreg, H, ngl, ngadd, tuple(ng_stage_ids), F, b)
    if lam.device.type == "cpu":
        SOFT_PLAIN_CALLS[name] += 1
        return factor_solve_soft_mega_ref(*ins, **kw)
    named = dict(idx_tab=idx_tab, idxs_tab=idxs_tab, lam=lam, t=t, A=A,
                 mb=mb, lam_s=lam_s, t_s=t_s, soft_c=soft_c, ms=ms, base=base,
                 pdreg=pdreg, H=H, ngl=ngl, ngadd=ngadd, F=F, b=b)
    _soft_check(name, lam, ng_stage_ids, named, **kw)
    Np1, B = lam.shape[0], lam.shape[-1]
    N, dev, dt = Np1 - 1, lam.device, lam.dtype
    new = lambda *s: torch.empty(*s, dtype=dt, device=dev)  # noqa: E731
    Ll, Lxx, Pb = new(Np1, NZ, NU, B), new(Np1, NX, NX, B), new(N, NX, B)
    z = new(Np1, NZ, B)
    dtb, dlb = new(2, *lam.shape).unbind(0)
    dts, dls = new(2, *lam_s.shape).unbind(0)
    amin, s0, s1, s2 = new(4, Np1, B).unbind(0)
    work = new(Np1 * (NU + NX), B)
    ptrs = (idx_tab, idxs_tab, lam, t, A, mb, lam_s, t_s, soft_c, ms, base,
            pdreg, H, ngl, ngadd, _build.ng_table(ng_stage_ids, dev), F, b,
            Ll, Lxx, Pb, z, dtb, dlb, dts, dls, amin, s0, s1, s2, work)
    a = _SoftFactorArgs(*[_build.ptr(x) for x in ptrs], B, N,
                        len(ng_stage_ids))
    _build.launch(name, name, a, dev, dt, NU=NU, NX=NX, NB=NB, NS=NS)
    SOFT_LAUNCHES[name] += 1
    return z, (Ll, Lxx, Pb), dtb, dlb, dts, dls, amin, s0, s1, s2


def solve_soft_mega(idx_tab, idxs_tab, fstate, lam, t, A, mb, lam_s, t_s,
                    soft_c, ms, dtb, dlb, dts, dls, smv, base, ngadd,
                    ng_stage_ids, F, b, *, NB, NS, NU, NZ, NX, exact):
    """Soft corrector gradient + retained-factor solve + forward with pi +
    the corrector box+soft alpha/mu partials in one launch (one corrector
    half-iteration of the soft IPM).

    ``fstate`` and ``dtb``/``dlb``/``dts``/``dls`` come from
    :func:`factor_solve_soft_mega`, ``smv`` (B,) is sigma*mu; ``exact``
    keeps the Schur-folded soft correction of the gradient (False: the
    reference's dropped correction).  Returns ``(z, pi, dt2b, dl2b, dt2s,
    dl2s, amin, s0, s1, s2)`` with pi (N, NX, B).

    CPU tensors run :func:`solve_soft_mega_ref`; CUDA tensors launch
    ``csrc/solve_soft_mega.cu`` on the current stream (no sync)."""
    name = "solve_soft_mega"
    kw = dict(NB=NB, NS=NS, NU=NU, NZ=NZ, NX=NX)
    ins = (idx_tab, idxs_tab, fstate, lam, t, A, mb, lam_s, t_s, soft_c, ms,
           dtb, dlb, dts, dls, smv, base, ngadd, tuple(ng_stage_ids), F, b)
    if lam.device.type == "cpu":
        SOFT_PLAIN_CALLS[name] += 1
        return solve_soft_mega_ref(*ins, exact=exact, **kw)
    Ll, Lxx, Pb = fstate
    named = dict(idx_tab=idx_tab, idxs_tab=idxs_tab, lam=lam, t=t, A=A,
                 mb=mb, lam_s=lam_s, t_s=t_s, soft_c=soft_c, ms=ms, dtb=dtb,
                 dlb=dlb, dts=dts, dls=dls, smv=smv, base=base, ngadd=ngadd,
                 Ll=Ll, Lxx=Lxx, Pb=Pb, F=F, b=b)
    _soft_check(name, lam, ng_stage_ids, named, **kw)
    Np1, B = lam.shape[0], lam.shape[-1]
    N, dev, dt = Np1 - 1, lam.device, lam.dtype
    new = lambda *s: torch.empty(*s, dtype=dt, device=dev)  # noqa: E731
    z, pi = new(Np1, NZ, B), new(N, NX, B)
    dt2b, dl2b = new(2, *lam.shape).unbind(0)
    dt2s, dl2s = new(2, *lam_s.shape).unbind(0)
    amin, s0, s1, s2 = new(4, Np1, B).unbind(0)
    work = new(Np1 * (NU + NX + 2 * NB + 4 * NS), B)
    ptrs = (idx_tab, idxs_tab, lam, t, A, mb, lam_s, t_s, soft_c, ms, dtb,
            dlb, dts, dls, smv, base, ngadd,
            _build.ng_table(ng_stage_ids, dev), Ll, Lxx, Pb, F, b, z, pi,
            dt2b, dl2b, dt2s, dl2s, amin, s0, s1, s2, work)
    a = _SoftSolveArgs(*[_build.ptr(x) for x in ptrs], B, N,
                       len(ng_stage_ids), int(bool(exact)))
    _build.launch(name, name, a, dev, dt, NU=NU, NX=NX, NB=NB, NS=NS)
    SOFT_LAUNCHES[name] += 1
    return z, pi, dt2b, dl2b, dt2s, dl2s, amin, s0, s1, s2
