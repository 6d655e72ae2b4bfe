"""Riccati sweep kernels of the 6-kernel lanes loop and its refinement
pass: CUDA kernels + plain versions.

Port of three wrappers of ``hpmpc_tpu/ops/stage_kernel.py`` (each two
``pallas_call`` s on the TPU, backward sweep then forward recovery, and
one launch here):

  * :func:`factor_solve_folded_flat` (TPU bodies ``_bwd_kernel_folded``,
    split factor, and ``_fwd_kernel_split``) — the folded backward Riccati
    factorization of H + diag(dvec) (+ the C' diag(Qx_g) C term on the ng
    stages) with the gradient ``g``, then the forward recovery of z and,
    with ``want_pi``, pi;
  * :func:`solve_flat` (``_bwd_trs_kernel_ll`` + ``_fwd_kernel_split``) —
    the retained-factor backward substitution with the cached Pb, then the
    forward recovery with pi;
  * :func:`refine_flat_fused` (``_refine_fused_kernel``) — one ITER_REF
    pass (reference ``d_ip2_res_hard.c:1093-1131``): the Newton residuals
    (rq, rb) of the current iterate, the correction re-solve with Pb
    recomputed from the retained Lxx, and ``(z + dz, pi + dpi)``.

Layout (:mod:`.layout`): batch-last streams; the factor state ``fstate =
(Ll (N+1, NZ, NU, B), Lxx (N+1, NX, NX, B), Pb (N, NX, B))`` is
:func:`~.mega_kernel.factor_solve_mega`'s, so :func:`solve_flat` takes
either.  General constraints sit on the stages ``ng_stage_ids`` (slot j on
stage ``ng_stage_ids[j]``): ``ngl`` (n_ng, NT, B) the packed C' diag(Qx_g)
C term, ``C`` (n_ng, NG, NZ, B) the rows and ``qxg`` (n_ng, NG, B) the
folded barrier diagonal; None when there are no such stages.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import stage_math as sm
from .layout import from_lanes, sym_expand, sym_nt, to_lanes

#: launches of each CUDA kernel in this process
LAUNCHES = {"factor_solve_folded_flat": 0, "solve_flat": 0,
            "refine_flat_fused": 0}
#: calls of each wrapper that ran the plain version (CPU tensors)
PLAIN_CALLS = {"factor_solve_folded_flat": 0, "solve_flat": 0,
               "refine_flat_fused": 0}


class _FactorArgs(ctypes.Structure):
    # mirrors struct FactorSolveFlatArgs in csrc/factor_solve_flat.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "H", "dvec", "ngl", "ng_stage", "g", "F", "b", "Ll", "Lxx", "Pb",
        "z", "pi", "work")] + [
        ("B", ctypes.c_int64), ("N", ctypes.c_int64),
        ("n_ng", ctypes.c_int64), ("want_pi", ctypes.c_int64)]


class _SolveArgs(ctypes.Structure):
    # mirrors struct SolveFlatArgs in csrc/solve_flat.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "Ll", "Lxx", "Pb", "g", "F", "b", "z", "pi", "work")] + [
        ("B", ctypes.c_int64), ("N", ctypes.c_int64)]


class _RefineArgs(ctypes.Structure):
    # mirrors struct RefineArgs in csrc/refine_flat.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "H", "dvec", "C", "qxg", "ng_stage", "g", "F", "b", "z", "pi", "Ll",
        "Lxx", "z_new", "pi_new", "work")] + [
        ("B", ctypes.c_int64), ("N", ctypes.c_int64),
        ("n_ng", ctypes.c_int64)]


def _forward(Llb, Lxxb, eus, pxs, Fb, bb, want_pi):
    """Forward recovery on batch-first factor pieces (``_fwd_kernel_split``):
    x0 from the root solve, then per stage pi_{s-1} = Lxx_s (Lxx_s' x_s) +
    px_s (with ``want_pi``), u_s, z_s and x_{s+1} = b_s + F_s' z_s."""
    B, Np1, NU = eus.shape
    N = Np1 - 1
    z = Llb.new_zeros(B, Np1, Llb.shape[2])
    pi = Llb.new_zeros(B, N, Lxxb.shape[2]) if want_pi else None
    x = sm.root_x0(Lxxb[:, 0], pxs[:, 0])
    for s_ in range(Np1):
        if want_pi and s_ >= 1:
            pi[:, s_ - 1] = sm.pi_of_x(Lxxb[:, s_], pxs[:, s_], x)
        Dinv_u = sm.dinv_ll(Llb[:, s_], NU)
        u = sm.u_of_x(NU, Llb[:, s_], Dinv_u, eus[:, s_], x)
        zt = torch.cat([u, x], dim=1)
        z[:, s_] = zt
        se = min(s_, N - 1)
        x = sm.x_next_of(Fb[:, se], bb[:, se], zt)
    return z, pi


def _trs(Llb, Lxxb, Pbb, gb, Fb, bb):
    """Backward substitution on the retained split factor, stages N..0:
    Pb from the cache ``Pbb`` or, where it is None, recomputed as
    Lxx_{k+1} (Lxx_{k+1}' b_k) (``_bwd_trs_pb_kernel``).  Returns (eu,
    px), (B, N+1, NU) and (B, N+1, NX)."""
    B, Np1, NZ, NU = Llb.shape
    N = Np1 - 1
    eus = Llb.new_zeros(B, Np1, NU)
    pxs = Llb.new_zeros(B, Np1, NZ - NU)
    px_c = None
    for k in range(N, -1, -1):
        Dinv_u = sm.dinv_ll(Llb[:, k], NU)
        ke = min(k, N - 1)
        Pbpx = None
        if k < N:
            Pb = (Pbb[:, k] if Pbb is not None
                  else sm.pb_of(Lxxb[:, k + 1], bb[:, k]))
            Pbpx = Pb + px_c
        eu, px_c = sm.trs_stage(NU, Llb[:, k], Dinv_u, gb[:, k], Fb[:, ke],
                                Pbpx, k == N)
        eus[:, k], pxs[:, k] = eu, px_c
    return eus, pxs


def factor_solve_folded_flat_ref(H, dvec, ngl, ng_stage_ids, g, F, b, *,
                                 NU, NZ, NX, want_pi):
    """Plain PyTorch version of :func:`factor_solve_folded_flat` (same
    arguments, same outputs)."""
    Np1, B = H.shape[0], H.shape[-1]
    N = Np1 - 1
    slot = {n: j for j, n in enumerate(ng_stage_ids)}
    Hf = sym_expand(from_lanes(H), NZ)            # (B, N+1, NZ, NZ)
    dvb, gb, Fb, bb = (from_lanes(x) for x in (dvec, g, F, b))
    if slot:
        nglf = sym_expand(from_lanes(ngl), NZ)    # (B, n_ng, NZ, NZ)
    new = lambda *s: H.new_zeros(B, *s)  # noqa: E731
    Ll, Lxx, Pb = new(Np1, NZ, NU), new(Np1, NX, NX), new(N, NX)
    eus, pxs = new(Np1, NU), new(Np1, NX)
    Lxx_c, px_c = new(NX, NX), new(NX)
    for k in range(N, -1, -1):
        Hp = Hf[:, k] + torch.diag_embed(dvb[:, k])
        if k in slot:
            Hp = Hp + nglf[:, slot[k]]
        ke = min(k, N - 1)
        Lf, eu, px, Pbk = sm.folded_bwd_core(NU, Hp, gb[:, k], Fb[:, ke],
                                             bb[:, ke], Lxx_c, px_c)
        Lxx_c, px_c = torch.tril(Lf[:, NU:, NU:]), px
        Ll[:, k], Lxx[:, k] = Lf[:, :, :NU], Lxx_c
        if k < N:
            Pb[:, k] = Pbk
        eus[:, k], pxs[:, k] = eu, px
    z, pi = _forward(Ll, Lxx, eus, pxs, Fb, bb, want_pi)
    return (to_lanes(z), to_lanes(pi) if want_pi else None,
            (to_lanes(Ll), to_lanes(Lxx), to_lanes(Pb)))


def solve_flat_ref(Ll, Lxx, Pb, g, F, b, *, NU, NZ, NX):
    """Plain PyTorch version of :func:`solve_flat` (same arguments, same
    outputs)."""
    Llb, Lxxb, Pbb, gb, Fb, bb = (from_lanes(x)
                                  for x in (Ll, Lxx, Pb, g, F, b))
    eus, pxs = _trs(Llb, Lxxb, Pbb, gb, Fb, bb)
    z, pi = _forward(Llb, Lxxb, eus, pxs, Fb, bb, True)
    return to_lanes(z), to_lanes(pi)


def refine_flat_fused_ref(H, dvec, C, qxg, ng_stage_ids, g, F, b, z, pi, Ll,
                          Lxx, *, NU, NZ, NX):
    """Plain PyTorch version of :func:`refine_flat_fused`: the Newton
    residuals

      rq_k = g_k + (H_k + diag(dvec_k)) z_k + [k<N] F_k pi_k
             - [k>=1] [0; pi_{k-1}] + [ng stage] C' (qxg * C z_k)
      rb_k = b_k + F_k' z_k - x_{k+1}                      (k < N)

    re-solved with the retained factor (Pb recomputed from Lxx for rb),
    added to the iterate."""
    N = F.shape[0]
    Hf = sym_expand(from_lanes(H), NZ)
    dvb, gb, Fb, bb, zb, pib = (from_lanes(x)
                                for x in (dvec, g, F, b, z, pi))
    rq = gb + dvb * zb + (Hf @ zb[..., None])[..., 0]
    rq[:, :N] += (Fb @ pib[..., None])[..., 0]
    rq[:, 1:, NU:] -= pib
    for j, n in enumerate(ng_stage_ids):
        Cj = from_lanes(C[j])                       # (B, NG, NZ)
        cz = (Cj @ zb[:, n, :, None])[..., 0]
        rq[:, n] += (Cj.transpose(1, 2)
                     @ (from_lanes(qxg[j]) * cz)[..., None])[..., 0]
    rb = bb + (Fb.transpose(-1, -2) @ zb[:, :N, :, None])[..., 0] \
        - zb[:, 1:, NU:]
    Llb, Lxxb = from_lanes(Ll), from_lanes(Lxx)
    eus, pxs = _trs(Llb, Lxxb, None, rq, Fb, rb)
    dz, dpi = _forward(Llb, Lxxb, eus, pxs, Fb, rb, True)
    return to_lanes(zb + dz), to_lanes(pib + dpi)


def _cuda_check(name, x, ng_stage_ids, named, shapes):
    """Device / ng / dtype / shape / contiguity checks of a wrapper."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    for key in ("ngl", "C", "qxg"):
        if key in named and (named[key] is None) != (not ng_stage_ids):
            raise ValueError(f"{name}: {key} must be given iff there are "
                             "ng stages")
    _build.check_tensors(x.device, x.dtype,
                         {k: v for k, v in named.items() if v is not None},
                         shapes)


def factor_solve_folded_flat(H, dvec, ngl, ng_stage_ids, g, F, b, *, NU, NZ,
                             NX, want_pi):
    """Folded backward Riccati factorization + forward recovery in one
    launch.

    Inputs: packed ``H`` (N+1, NT, B), the barrier diagonal ``dvec`` and
    the effective gradient ``g`` (N+1, NZ, B), ``ngl`` (see the module
    doc), ``F`` (N, NZ, NX, B), ``b`` (N, NX, B).  Returns ``(z, pi,
    (Ll, Lxx, Pb))``: z (N+1, NZ, B), pi (N, NX, B) or None without
    ``want_pi``, and the factor state.

    CPU tensors run :func:`factor_solve_folded_flat_ref`; CUDA tensors
    launch ``csrc/factor_solve_flat.cu`` on the current stream (no
    sync)."""
    name = "factor_solve_folded_flat"
    kw = dict(NU=NU, NZ=NZ, NX=NX, want_pi=bool(want_pi))
    if H.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return factor_solve_folded_flat_ref(H, dvec, ngl, tuple(ng_stage_ids),
                                            g, F, b, **kw)
    Np1, B = H.shape[0], H.shape[-1]
    N, n_ng = Np1 - 1, len(ng_stage_ids)
    named = dict(H=H, dvec=dvec, ngl=ngl, g=g, F=F, b=b)
    shapes = dict(H=(Np1, sym_nt(NZ), B), dvec=(Np1, NZ, B),
                  ngl=(n_ng, sym_nt(NZ), B), g=(Np1, NZ, B),
                  F=(N, NZ, NX, B), b=(N, NX, B))
    _cuda_check(name, H, ng_stage_ids, named, shapes)
    new = lambda *s: torch.empty(*s, dtype=H.dtype, device=H.device)  # noqa: E731
    Ll, Lxx, Pb = new(Np1, NZ, NU, B), new(Np1, NX, NX, B), new(N, NX, B)
    z = new(Np1, NZ, B)
    pi = new(N, NX, B) if want_pi else None
    work = new(Np1 * (NU + NX), B)
    ptrs = (H, dvec, ngl, _build.ng_table(ng_stage_ids, H.device), g, F, b, Ll,
            Lxx, Pb, z, pi, work)
    a = _FactorArgs(*[_build.ptr(x) for x in ptrs], B, N, n_ng,
                    int(bool(want_pi)))
    _build.launch("factor_solve_flat", name, a, H.device, H.dtype, NU=NU,
                  NX=NX)
    LAUNCHES[name] += 1
    return z, pi, (Ll, Lxx, Pb)


def solve_flat(Ll, Lxx, Pb, g, F, b, *, NU, NZ, NX):
    """Retained-factor backward substitution with the cached Pb + forward
    recovery with pi, one launch: the solve of the gradient ``g`` (N+1,
    NZ, B) against the factor state ``(Ll, Lxx, Pb)``.  Returns ``(z,
    pi)``.

    CPU tensors run :func:`solve_flat_ref`; CUDA tensors launch
    ``csrc/solve_flat.cu`` (no sync)."""
    name = "solve_flat"
    if g.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return solve_flat_ref(Ll, Lxx, Pb, g, F, b, NU=NU, NZ=NZ, NX=NX)
    Np1, B = g.shape[0], g.shape[-1]
    N = Np1 - 1
    named = dict(Ll=Ll, Lxx=Lxx, Pb=Pb, g=g, F=F, b=b)
    shapes = dict(Ll=(Np1, NZ, NU, B), Lxx=(Np1, NX, NX, B), Pb=(N, NX, B),
                  g=(Np1, NZ, B), F=(N, NZ, NX, B), b=(N, NX, B))
    _cuda_check(name, g, (), named, shapes)
    new = lambda *s: torch.empty(*s, dtype=g.dtype, device=g.device)  # noqa: E731
    z, pi, work = new(Np1, NZ, B), new(N, NX, B), new(Np1 * (NU + NX), B)
    a = _SolveArgs(*[_build.ptr(x) for x in (Ll, Lxx, Pb, g, F, b, z, pi,
                                             work)], B, N)
    _build.launch(name, name, a, g.device, g.dtype, NU=NU, NX=NX)
    LAUNCHES[name] += 1
    return z, pi


def refine_flat_fused(H, dvec, C, qxg, ng_stage_ids, g, F, b, z, pi, Ll, Lxx,
                      *, NU, NZ, NX):
    """One fused iterative-refinement pass: returns ``(z_new, pi_new)`` =
    the iterate ``(z, pi)`` plus the retained factor's correction for the
    Newton residuals of the system (H + diag(dvec) [+ C' diag(qxg) C], g,
    F, b).  ``(Ll, Lxx)`` is the factor of that system; Pb is recomputed
    for the residual ``rb``.

    CPU tensors run :func:`refine_flat_fused_ref`; CUDA tensors launch
    ``csrc/refine_flat.cu`` (no sync)."""
    name = "refine_flat_fused"
    if z.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return refine_flat_fused_ref(H, dvec, C, qxg, tuple(ng_stage_ids), g,
                                     F, b, z, pi, Ll, Lxx, NU=NU, NZ=NZ,
                                     NX=NX)
    Np1, B = z.shape[0], z.shape[-1]
    N, n_ng = Np1 - 1, len(ng_stage_ids)
    NG = C.shape[1] if n_ng else 0
    named = dict(H=H, dvec=dvec, C=C, qxg=qxg, g=g, F=F, b=b, z=z, pi=pi,
                 Ll=Ll, Lxx=Lxx)
    shapes = dict(H=(Np1, sym_nt(NZ), B), dvec=(Np1, NZ, B),
                  C=(n_ng, NG, NZ, B), qxg=(n_ng, NG, B), g=(Np1, NZ, B),
                  F=(N, NZ, NX, B), b=(N, NX, B), z=(Np1, NZ, B),
                  pi=(N, NX, B), Ll=(Np1, NZ, NU, B), Lxx=(Np1, NX, NX, B))
    _cuda_check(name, z, ng_stage_ids, named, shapes)
    new = lambda *s: torch.empty(*s, dtype=z.dtype, device=z.device)  # noqa: E731
    z_new, pi_new = new(Np1, NZ, B), new(N, NX, B)
    work = new(Np1 * (NU + 2 * NX), B)
    ptrs = (H, dvec, C, qxg, _build.ng_table(ng_stage_ids, z.device), g, F, b,
            z, pi, Ll, Lxx, z_new, pi_new, work)
    a = _RefineArgs(*[_build.ptr(x) for x in ptrs], B, N, n_ng)
    _build.launch("refine_flat", name, a, z.device, z.dtype, NU=NU, NX=NX,
                  NG=max(NG, 1))
    LAUNCHES[name] += 1
    return z_new, pi_new
