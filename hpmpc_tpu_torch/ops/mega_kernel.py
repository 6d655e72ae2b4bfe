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
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import stage_math as sm
from .layout import from_lanes, sym_expand, sym_nt, to_lanes

#: launches of each CUDA kernel in this process, [phase 1, phase 2]
LAUNCHES = {"factor_solve_mega": [0, 0], "solve_mega": [0, 0]}
#: calls of each wrapper that ran the plain version (CPU tensors),
#: [phase 1, phase 2]
PLAIN_CALLS = {"factor_solve_mega": [0, 0], "solve_mega": [0, 0]}

_NG_TABLES: dict = {}


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


def _partials(lam, t, mb, dt, dl):
    """One stage's (amin, s0, s1, s2): the fraction-to-boundary minimum
    and the mu(alpha) sum partials of a box direction, each (B,)."""
    cand = torch.minimum(sm.alpha_cands(lam, dl, mb),
                         sm.alpha_cands(t, dt, mb))
    return (cand.amin(1), (lam * t * mb).sum(1),
            (lam * dt + t * dl).sum(1), (dl * dt).sum(1))


def _box_dir(NB, phase2, lam, t, mb, A, M, zb, co):
    """Box (dt, dlam) of a direction: phase 1 with the centering stream
    ``co`` as dl0 (0 in the affine half), phase 2 with ``M`` (rm or rm2)."""
    if phase2:
        return sm.dt_dlam_res(NB, lam, t, mb, A, M, zb)
    return sm.dt_dlam(NB, lam, t, mb, A, zb, co)


def factor_solve_mega_ref(idx_tab, lam, t, A, M, mb, base, pdreg, H, ngl,
                          ngadd, ng_stage_ids, F, b, *, NB, NU, NZ, NX,
                          phase2):
    """Plain PyTorch version of :func:`factor_solve_mega` (same arguments,
    same outputs), a Python loop over the stages of the
    ``ops/stage_math.py`` helpers."""
    Np1, B = lam.shape[0], lam.shape[-1]
    N = Np1 - 1
    dt_, dev = lam.dtype, lam.device
    idx = idx_tab.long()
    slot = {n: j for j, n in enumerate(ng_stage_ids)}
    lamb, tb, Ab, mbb = (from_lanes(x) for x in (lam, t, A, mb))
    Mb = from_lanes(M) if phase2 else None
    Hf = sym_expand(from_lanes(H), NZ)            # (B, N+1, NZ, NZ)
    Fb, bb = from_lanes(F), from_lanes(b)
    gb, pdb = from_lanes(base), from_lanes(pdreg)
    if slot:
        nglf = sym_expand(from_lanes(ngl), NZ)    # (B, n_ng, NZ, NZ)
        ngab = from_lanes(ngadd)                  # (B, n_ng, NZ)
    new = lambda *s: torch.zeros(B, *s, dtype=dt_, device=dev)  # noqa: E731
    Ll, Lxx, Pb = new(Np1, NZ, NU), new(Np1, NX, NX), new(N, NX)
    eus, pxs = new(Np1, NU), new(Np1, NX)
    Lxx_c, px_c = new(NX, NX), new(NX)
    for k in range(N, -1, -1):
        if phase2:
            Qx, qx = sm.qx_fold_res(NB, lamb[:, k], tb[:, k], mbb[:, k],
                                    Ab[:, k], Mb[:, k])
        else:
            Qx, qx = sm.qx_fold(NB, lamb[:, k], tb[:, k], mbb[:, k],
                                Ab[:, k])
        dvec = sm.scatter_add_box(pdb[:, k], idx[k], Qx)
        Hp = Hf[:, k] + torch.diag_embed(dvec)
        g = sm.scatter_add_box(gb[:, k], idx[k], qx)
        if k in slot:
            g = g + ngab[:, slot[k]]
            Hp = Hp + nglf[:, slot[k]]
        ke = min(k, N - 1)
        Lf, eu, px, Pbk = sm.folded_bwd_core(NU, Hp, g, Fb[:, ke],
                                             bb[:, ke], Lxx_c, px_c)
        Lxx_c, px_c = torch.tril(Lf[:, NU:, NU:]), px
        Ll[:, k], Lxx[:, k] = Lf[:, :, :NU], Lxx_c
        if k < N:
            Pb[:, k] = Pbk
        eus[:, k], pxs[:, k] = eu, px

    z, dtl, dll = new(Np1, NZ), new(Np1, 2 * NB), new(Np1, 2 * NB)
    parts = new(4, Np1)
    x = sm.root_x0(Lxx[:, 0], pxs[:, 0])
    for s_ in range(Np1):
        Dinv_u = sm.dinv_ll(Ll[:, s_], NU)
        u = sm.u_of_x(NU, Ll[:, s_], Dinv_u, eus[:, s_], x)
        zt = torch.cat([u, x], dim=1)
        z[:, s_] = zt
        se = min(s_, N - 1)
        x = sm.x_next_of(Fb[:, se], bb[:, se], zt)
        zb = sm.gather_box(zt, idx[s_])
        dtb, dlb = _box_dir(NB, phase2, lamb[:, s_], tb[:, s_], mbb[:, s_],
                            Ab[:, s_], Mb[:, s_] if phase2 else None, zb,
                            0.0)
        dtl[:, s_], dll[:, s_] = dtb, dlb
        for i, p in enumerate(_partials(lamb[:, s_], tb[:, s_], mbb[:, s_],
                                        dtb, dlb)):
            parts[:, i, s_] = p
    amin, s0, s1, s2 = to_lanes(parts).unbind(0)
    return (to_lanes(z), (to_lanes(Ll), to_lanes(Lxx), to_lanes(Pb)),
            to_lanes(dtl), to_lanes(dll), amin, s0, s1, s2)


def solve_mega_ref(idx_tab, fstate, lam, t, A, M, mb, dtb, dlb, smv, base,
                   ngadd, ng_stage_ids, F, b, *, NB, NU, NZ, NX, phase2):
    """Plain PyTorch version of :func:`solve_mega` (same arguments, same
    outputs)."""
    Np1, B = lam.shape[0], lam.shape[-1]
    N = Np1 - 1
    dt_, dev = lam.dtype, lam.device
    idx = idx_tab.long()
    slot = {n: j for j, n in enumerate(ng_stage_ids)}
    Llb, Lxxb, Pbb = (from_lanes(x) for x in fstate)
    lamb, tb, Ab, mbb = (from_lanes(x) for x in (lam, t, A, mb))
    Mb = from_lanes(M) if phase2 else None
    dtab, dlab = from_lanes(dtb), from_lanes(dlb)
    Fb, bb, gb = from_lanes(F), from_lanes(b), from_lanes(base)
    if slot:
        ngab = from_lanes(ngadd)
    new = lambda *s: torch.zeros(B, *s, dtype=dt_, device=dev)  # noqa: E731
    co, eus, pxs = new(Np1, 2 * NB), new(Np1, NU), new(Np1, NX)
    px_c = None
    for k in range(N, -1, -1):
        if phase2:
            cok, qx = sm.corr_co_qx_res(NB, lamb[:, k], tb[:, k], mbb[:, k],
                                        Ab[:, k], Mb[:, k], dtab[:, k],
                                        dlab[:, k], smv)
        else:
            cok, qx = sm.corr_co_qx(NB, lamb[:, k], tb[:, k], mbb[:, k],
                                    Ab[:, k], dtab[:, k], dlab[:, k], smv)
        co[:, k] = cok
        g = sm.scatter_add_box(gb[:, k], idx[k], qx)
        if k in slot:
            g = g + ngab[:, slot[k]]
        Dinv_u = sm.dinv_ll(Llb[:, k], NU)
        ke = min(k, N - 1)
        Pbpx = None if k == N else Pbb[:, ke] + px_c
        eu, px_c = sm.trs_stage(NU, Llb[:, k], Dinv_u, g, Fb[:, ke], Pbpx,
                                k == N)
        eus[:, k], pxs[:, k] = eu, px_c

    z, pi = new(Np1, NZ), new(N, NX)
    dtl, dll, parts = new(Np1, 2 * NB), new(Np1, 2 * NB), new(4, Np1)
    x = sm.root_x0(Lxxb[:, 0], pxs[:, 0])
    for s_ in range(Np1):
        if s_ >= 1:
            pi[:, s_ - 1] = sm.pi_of_x(Lxxb[:, s_], pxs[:, s_], x)
        Dinv_u = sm.dinv_ll(Llb[:, s_], NU)
        u = sm.u_of_x(NU, Llb[:, s_], Dinv_u, eus[:, s_], x)
        zt = torch.cat([u, x], dim=1)
        z[:, s_] = zt
        se = min(s_, N - 1)
        x = sm.x_next_of(Fb[:, se], bb[:, se], zt)
        zb = sm.gather_box(zt, idx[s_])
        d_t, d_l = _box_dir(NB, phase2, lamb[:, s_], tb[:, s_], mbb[:, s_],
                            Ab[:, s_], co[:, s_], zb, co[:, s_])
        dtl[:, s_], dll[:, s_] = d_t, d_l
        for i, p in enumerate(_partials(lamb[:, s_], tb[:, s_], mbb[:, s_],
                                        d_t, d_l)):
            parts[:, i, s_] = p
    amin, s0, s1, s2 = to_lanes(parts).unbind(0)
    return (to_lanes(z), to_lanes(pi), to_lanes(dtl), to_lanes(dll),
            amin, s0, s1, s2)


def _ng_table(ng_stage_ids, dev):
    """The (n_ng,) int32 stage table on ``dev``, made once per process so
    the launches issue no host-to-device copy."""
    key = (tuple(ng_stage_ids), str(dev))
    tab = _NG_TABLES.get(key)
    if tab is None:
        tab = torch.tensor(list(ng_stage_ids) or [0], dtype=torch.int32,
                           device=dev)
        _NG_TABLES[key] = tab
    return tab


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
    code = _build.dtype_code(dt)
    lib = _build.load(name, NU=NU, NX=NX, NB=NB)
    new = lambda *s: torch.empty(*s, dtype=dt, device=dev)  # noqa: E731
    Ll, Lxx, Pb = new(Np1, NZ, NU, B), new(Np1, NX, NX, B), new(N, NX, B)
    z, dtl, dll = new(Np1, NZ, B), new(Np1, NB2, B), new(Np1, NB2, B)
    amin, s0, s1, s2 = new(4, Np1, B).unbind(0)
    work = new(Np1 * (NU + NX), B)
    ptrs = (idx_tab, lam, t, A, M, mb, base, pdreg, H, ngl, ngadd,
            _ng_table(ng_stage_ids, dev), F, b, Ll, Lxx, Pb, z, dtl, dll,
            amin, s0, s1, s2, work)
    a = _FactorArgs(*[_build.ptr(x) for x in ptrs], B, N, n_ng, ph)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, f"hp_{name}")(ctypes.addressof(a), code, stream)
    _build.check(lib, rc, name)
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
    code = _build.dtype_code(dt)
    lib = _build.load(name, NU=NU, NX=NX, NB=NB)
    new = lambda *s: torch.empty(*s, dtype=dt, device=dev)  # noqa: E731
    z, pi = new(Np1, NZ, B), new(N, NX, B)
    dtl, dll = new(Np1, NB2, B), new(Np1, NB2, B)
    amin, s0, s1, s2 = new(4, Np1, B).unbind(0)
    work = new(Np1 * (NU + NX + NB2), B)
    ptrs = (idx_tab, lam, t, A, M, mb, dtb, dlb, smv, base, ngadd,
            _ng_table(ng_stage_ids, dev), Ll, Lxx, Pb, F, b, z, pi, dtl,
            dll, amin, s0, s1, s2, work)
    a = _SolveArgs(*[_build.ptr(x) for x in ptrs], B, N, n_ng, ph)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, f"hp_{name}")(ctypes.addressof(a), code, stream)
    _build.check(lib, rc, name)
    LAUNCHES[name][ph] += 1
    return z, pi, dtl, dll, amin, s0, s1, s2
