"""Riccati sweep kernels: CUDA kernels + plain versions.

Port of the sweep wrappers of ``hpmpc_tpu/ops/stage_kernel.py`` (each one
or two ``pallas_call`` s on the TPU, backward sweep then forward recovery,
and one launch here).  Three serve the 6-kernel lanes loop and its
refinement pass:

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

Two are the fused-sweep forms of the first two (``HPMPC_FUSED_SWEEPS=1``,
the JAX package's ``*_fused`` kernels): the same functions in one launch
each, with the backward sweep's eu/px slab kept in shared memory instead of
a global scratch stream:

  * :func:`factor_solve_folded_flat_fused` (``_sv_fwd_fused_kernel``) —
    :func:`factor_solve_folded_flat` without pi;
  * :func:`solve_flat_fused` (``_trs_fwd_fused_kernel``) —
    :func:`solve_flat`.

Two serve the same pass unfused (the flat form of the lanes engine, the
JAX package's flat engine ``ipm_fast``):

  * :func:`resid_terms_flat` (``_resid_kernel``) — the stage products H z,
    F' z and F pi of the Newton residuals;
  * :func:`solve_flat_pb` (``_bwd_trs_pb_kernel`` + ``_fwd_kernel_split``)
    — the retained-factor re-solve with Pb recomputed from Lxx for a new
    right-hand side, then the forward recovery with pi.

Layout (:mod:`.layout`): batch-last streams; the factor state ``fstate =
(Ll (N+1, NZ, NU, B), Lxx (N+1, NX, NX, B), Pb (N, NX, B))`` is
:func:`~.mega_kernel.factor_solve_mega`'s, so :func:`solve_flat` takes
either.  General constraints sit on the stages ``ng_stage_ids`` (slot j on
stage ``ng_stage_ids[j]``): ``ngl`` (n_ng, NT, B) the packed C' diag(Qx_g)
C term, ``C`` (n_ng, NG, NZ, B) the rows and ``qxg`` (n_ng, NG, B) the
folded barrier diagonal; None when there are no such stages.

Three serve the structured IPM's kernel backend
(:func:`..models.ipm.make_kernel_chain_kkt`, the JAX package's
``make_pallas_chain_kkt``) with the FULL factor, inside the per-thread
engines' size envelope (:func:`engine_fits`; past it the backend takes the
blocked band, :mod:`..models.riccati_blocked`):

  * :func:`factor_solve_folded` (``_bwd_kernel_folded`` unsplit +
    ``_fwd_kernel``) — the folded factorization of H + diag(dvec) (+ the
    packed ng term on its stage) with the forward recovery of z and pi;
  * :func:`factor_solve_batched` (``_bwd_kernel`` + ``_fwd_kernel``) — the
    same on an effective Hessian handed over whole;
  * :func:`solve_batched` (``_bwd_trs_kernel`` + ``_fwd_kernel``) — the
    retained-factor re-solve with the cached Pb.

They take the JAX wrappers' arguments in the port's batch-last layout and
return the JAX wrappers' outputs the same way: z (N+1, NZ, B), pi (N, NX,
B), L (N+1, NZ, NZ, B) with its strictly upper part zero, eu (N+1, NZ, B)
zero past NU, px (N+1, NX, B), Pb (N, NX, B) -- the chain-backend shapes
(B, N+1, NZ) ... with the batch axis moved last.  The TPU wrappers'
stage-N tail (u_N and x_N in XLA after the calls) is computed in the
kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import stage_math as sm
from .layout import from_lanes, sym_expand, sym_nt, to_lanes

#: launches of each CUDA kernel in this process
LAUNCHES = {"factor_solve_folded_flat": 0, "solve_flat": 0,
            "factor_solve_folded_flat_fused": 0, "solve_flat_fused": 0,
            "refine_flat_fused": 0, "resid_terms_flat": 0,
            "solve_flat_pb": 0, "factor_solve_folded": 0,
            "factor_solve_batched": 0, "solve_batched": 0}
#: calls of each wrapper that ran the plain version (CPU tensors)
PLAIN_CALLS = dict.fromkeys(LAUNCHES, 0)

#: the per-thread engines' size envelope on the H100: the largest stage
#: width NZ = NX + NU that the resident, lanes, flat and rows 16/15 engines
#: and the scenario tree's flat engine serve.  Drawn from
#: hpmpc_tpu_torch/tools/size_sweep.py's tables (PERF.md section 5): a
#: per-thread engine keeps a size only where it built within 300 s and was
#: no slower than the structured route (on the blocked band for the chain).
#: NZ = 19 is the last size where every engine's libraries built, the tree
#: kernels' included, and there each engine beat the structured route; at
#: NZ = 27 the lanes, flat, rows 16/15 and tree builds run over.  One bound
#: serves them all (JAX's TPU rule has a second one for the lanes engine);
#: NZ 20-26 is not measured.
ENGINE_MAX_NZ = 19


def engine_fits(NX: int, NU: int) -> bool:
    """Whether the per-thread kernel engines serve stage width NX + NU
    (the twin of JAX's ``stage_kernel.engine_fits``, whose bound is the
    TPU's VMEM; here the card's measured envelope)."""
    return NX + NU <= ENGINE_MAX_NZ


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


class _ResidTermsArgs(ctypes.Structure):
    # mirrors struct ResidTermsArgs in csrc/resid_terms_flat.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "H", "F", "z", "pi", "hz", "fz", "fpi")] + [
        ("B", ctypes.c_int64), ("N", ctypes.c_int64)]


class _FoldedArgs(ctypes.Structure):
    # mirrors struct FactorSolveFoldedArgs in csrc/factor_solve_folded.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "H", "dvec", "ngl", "ng_stage", "g", "F", "b", "L", "eu", "px", "Pb",
        "z", "pi")] + [
        ("B", ctypes.c_int64), ("N", ctypes.c_int64),
        ("n_ng", ctypes.c_int64)]


class _TrsArgs(ctypes.Structure):
    # mirrors struct SolveBatchedArgs in csrc/solve_batched.cu
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "L", "g", "F", "b", "Pb", "z", "pi", "work")] + [
        ("B", ctypes.c_int64), ("N", ctypes.c_int64)]


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
    arguments, same outputs): :func:`factor_solve_folded_ref` with the
    factor split into Ll and Lxx."""
    z, pi, L, _, _, Pb = factor_solve_folded_ref(H, dvec, ngl, ng_stage_ids,
                                                 g, F, b, NU)
    return (z, pi if want_pi else None,
            (L[:, :, :NU].contiguous(), L[:, NU:, NU:].contiguous(), Pb))


def solve_flat_ref(Ll, Lxx, Pb, g, F, b, *, NU, NZ, NX):
    """Plain PyTorch version of :func:`solve_flat` (same arguments, same
    outputs)."""
    Llb, Lxxb, Pbb, gb, Fb, bb = (from_lanes(x)
                                  for x in (Ll, Lxx, Pb, g, F, b))
    eus, pxs = _trs(Llb, Lxxb, Pbb, gb, Fb, bb)
    z, pi = _forward(Llb, Lxxb, eus, pxs, Fb, bb, True)
    return to_lanes(z), to_lanes(pi)


def factor_solve_folded_flat_fused_ref(H, dvec, ngl, ng_stage_ids, g, F, b,
                                       *, NU, NZ, NX):
    """Plain PyTorch version of :func:`factor_solve_folded_flat_fused`:
    :func:`factor_solve_folded_flat_ref` without pi."""
    return factor_solve_folded_flat_ref(H, dvec, ngl, ng_stage_ids, g, F, b,
                                        NU=NU, NZ=NZ, NX=NX, want_pi=False)


#: plain PyTorch version of :func:`solve_flat_fused` (the same function)
solve_flat_fused_ref = solve_flat_ref


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
    return _launch_factor_flat(name, H, dvec, ngl, ng_stage_ids, g, F, b,
                               **kw)


def _launch_factor_flat(name, H, dvec, ngl, ng_stage_ids, g, F, b, *, NU, NZ,
                        NX, want_pi):
    """Check and launch one form of ``csrc/factor_solve_flat.cu``: the
    global-scratch one or (``name`` ending in ``_fused``, no pi) the one
    with the eu/px slab in shared memory."""
    fused = name.endswith("_fused")
    Np1, B = H.shape[0], H.shape[-1]
    N, n_ng = Np1 - 1, len(ng_stage_ids)
    named = dict(H=H, dvec=dvec, ngl=ngl, g=g, F=F, b=b)
    shapes = dict(H=(Np1, sym_nt(NZ), B), dvec=(Np1, NZ, B),
                  ngl=(n_ng, sym_nt(NZ), B), g=(Np1, NZ, B),
                  F=(N, NZ, NX, B), b=(N, NX, B))
    _cuda_check(name, H, ng_stage_ids, named, shapes)
    if fused:
        _slab_fits(name, H.device, H.dtype, Np1, NU, NX)
    new = lambda *s: torch.empty(*s, dtype=H.dtype, device=H.device)  # noqa: E731
    Ll, Lxx, Pb = new(Np1, NZ, NU, B), new(Np1, NX, NX, B), new(N, NX, B)
    z = new(Np1, NZ, B)
    pi = new(N, NX, B) if want_pi else None
    work = None if fused else new(Np1 * (NU + NX), B)
    ptrs = (H, dvec, ngl, _build.int_table(ng_stage_ids, H.device), g, F, b,
            Ll, Lxx, Pb, z, pi, work)
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
    return _launch_solve_flat(name, Ll, Lxx, Pb, g, F, b, NU=NU, NZ=NZ, NX=NX)


def _launch_solve_flat(name, Ll, Lxx, Pb, g, F, b, *, NU, NZ, NX):
    """Check and launch one form of ``csrc/solve_flat.cu``: the cached-Pb
    one, the Pb form (``Pb`` None) or (``name`` ending in ``_fused``) the
    cached-Pb one with the eu/px slab in shared memory."""
    fused = name.endswith("_fused")
    Np1, B = g.shape[0], g.shape[-1]
    N = Np1 - 1
    named = dict(Ll=Ll, Lxx=Lxx, Pb=Pb, g=g, F=F, b=b)
    shapes = dict(Ll=(Np1, NZ, NU, B), Lxx=(Np1, NX, NX, B), Pb=(N, NX, B),
                  g=(Np1, NZ, B), F=(N, NZ, NX, B), b=(N, NX, B))
    _cuda_check(name, g, (), named, shapes)
    if fused:
        _slab_fits(name, g.device, g.dtype, Np1, NU, NX)
    new = lambda *s: torch.empty(*s, dtype=g.dtype, device=g.device)  # noqa: E731
    z, pi = new(Np1, NZ, B), new(N, NX, B)
    work = None if fused else new(Np1 * (NU + NX), B)
    a = _SolveArgs(*[_build.ptr(x) for x in (Ll, Lxx, Pb, g, F, b, z, pi,
                                             work)], B, N)
    _build.launch("solve_flat", name, a, g.device, g.dtype, NU=NU, NX=NX)
    LAUNCHES[name] += 1
    return z, pi


def _slab_fits(name, dev, dt, Np1, NU, NX):
    """Raise unless the fused sweeps' eu/px slab, (N+1)(NU+NX) scalars for
    each of a block's 32 threads (csrc/solve_flat.cu), fits in the shared
    memory a block of this card can take."""
    nbytes = Np1 * (NU + NX) * 32 * torch.finfo(dt).bits // 8
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if nbytes > limit:
        raise ValueError(
            f"{name}: the eu/px slab of N+1={Np1} stages, NU={NU}, NX={NX} "
            f"in {dt} takes {nbytes} bytes of shared memory a block, more "
            f"than the {limit} a block can have on this card")


def factor_solve_folded_flat_fused(H, dvec, ngl, ng_stage_ids, g, F, b, *,
                                   NU, NZ, NX):
    """:func:`factor_solve_folded_flat` without pi, in one launch that keeps
    the backward sweep's eu/px slab in shared memory (Queue 2 row 18, the
    JAX package's ``factor_solve_folded_flat_fused``).  Same inputs;
    returns ``(z, None, (Ll, Lxx, Pb))``.

    CPU tensors run :func:`factor_solve_folded_flat_fused_ref`; CUDA tensors
    launch the fused form of ``csrc/factor_solve_flat.cu`` (no sync), and a
    shape whose slab does not fit in a block's shared memory raises."""
    name = "factor_solve_folded_flat_fused"
    kw = dict(NU=NU, NZ=NZ, NX=NX)
    if H.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return factor_solve_folded_flat_fused_ref(
            H, dvec, ngl, tuple(ng_stage_ids), g, F, b, **kw)
    return _launch_factor_flat(name, H, dvec, ngl, ng_stage_ids, g, F, b,
                               **kw, want_pi=False)


def solve_flat_fused(Ll, Lxx, Pb, g, F, b, *, NU, NZ, NX):
    """:func:`solve_flat` in one launch that keeps the backward sweep's
    eu/px slab in shared memory (Queue 2 row 17, the JAX package's
    ``solve_flat_fused``).  Same inputs and outputs ``(z, pi)``.

    CPU tensors run :func:`solve_flat_fused_ref`; CUDA tensors launch the
    fused form of ``csrc/solve_flat.cu`` (no sync), and a shape whose slab
    does not fit in a block's shared memory raises."""
    name = "solve_flat_fused"
    if g.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return solve_flat_fused_ref(Ll, Lxx, Pb, g, F, b, NU=NU, NZ=NZ,
                                    NX=NX)
    return _launch_solve_flat(name, Ll, Lxx, Pb, g, F, b, NU=NU, NZ=NZ, NX=NX)


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
    ptrs = (H, dvec, C, qxg, _build.int_table(ng_stage_ids, z.device), g, F, b,
            z, pi, Ll, Lxx, z_new, pi_new, work)
    a = _RefineArgs(*[_build.ptr(x) for x in ptrs], B, N, n_ng)
    _build.launch("refine_flat", name, a, z.device, z.dtype, NU=NU, NX=NX,
                  NG=max(NG, 1))
    LAUNCHES[name] += 1
    return z_new, pi_new


def resid_terms_flat_ref(H, F, z, pi, *, NZ, NX):
    """Plain PyTorch version of :func:`resid_terms_flat` (same arguments,
    same outputs)."""
    N = F.shape[0]
    Hf = sym_expand(from_lanes(H), NZ)
    Fb, zb, pib = from_lanes(F), from_lanes(z), from_lanes(pi)
    hz = (Hf @ zb[..., None])[..., 0]
    fz = zb.new_zeros(zb.shape[0], N + 1, NX)
    fpi = torch.zeros_like(zb)
    fz[:, :N] = (Fb.transpose(-1, -2) @ zb[:, :N, :, None])[..., 0]
    fpi[:, :N] = (Fb @ pib[..., None])[..., 0]
    return to_lanes(hz), to_lanes(fz), to_lanes(fpi)


def solve_flat_pb_ref(Ll, Lxx, g, F, b, *, NU, NZ, NX):
    """Plain PyTorch version of :func:`solve_flat_pb` (same arguments, same
    outputs)."""
    Llb, Lxxb, gb, Fb, bb = (from_lanes(x) for x in (Ll, Lxx, g, F, b))
    eus, pxs = _trs(Llb, Lxxb, None, gb, Fb, bb)
    z, pi = _forward(Llb, Lxxb, eus, pxs, Fb, bb, True)
    return to_lanes(z), to_lanes(pi)


def resid_terms_flat(H, F, z, pi, *, NZ, NX):
    """The stage products of the Newton residuals, one launch: ``(hz, fz,
    fpi)`` with hz_n = H_n z_n (N+1, NZ, B), fz_n = F_n' z_n (N+1, NX, B)
    and fpi_n = F_n pi_n (N+1, NZ, B), the stage-N slices of fz and fpi
    zero.  Inputs: packed ``H`` (N+1, NT, B), ``F`` (N, NZ, NX, B), ``z``
    (N+1, NZ, B), ``pi`` (N, NX, B).

    CPU tensors run :func:`resid_terms_flat_ref`; CUDA tensors launch
    ``csrc/resid_terms_flat.cu`` (no sync)."""
    name = "resid_terms_flat"
    if z.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return resid_terms_flat_ref(H, F, z, pi, NZ=NZ, NX=NX)
    Np1, B = z.shape[0], z.shape[-1]
    N = Np1 - 1
    named = dict(H=H, F=F, z=z, pi=pi)
    shapes = dict(H=(Np1, sym_nt(NZ), B), F=(N, NZ, NX, B), z=(Np1, NZ, B),
                  pi=(N, NX, B))
    _cuda_check(name, z, (), named, shapes)
    new = lambda *s: torch.empty(*s, dtype=z.dtype, device=z.device)  # noqa: E731
    hz, fz, fpi = new(Np1, NZ, B), new(Np1, NX, B), new(Np1, NZ, B)
    a = _ResidTermsArgs(*[_build.ptr(x) for x in (H, F, z, pi, hz, fz,
                                                  fpi)], B, N)
    _build.launch(name, name, a, z.device, z.dtype, NU=NZ - NX, NX=NX)
    LAUNCHES[name] += 1
    return hz, fz, fpi


def solve_flat_pb(Ll, Lxx, g, F, b, *, NU, NZ, NX):
    """Retained-factor re-solve for a new right-hand side, one launch: the
    backward substitution of the gradient ``g`` (N+1, NZ, B) with Pb_k =
    Lxx_{k+1} (Lxx_{k+1}' b_k) recomputed from the factor for ``b`` (N,
    NX, B) -- no Pb cache is read --, then the forward recovery with pi.
    ``(Ll, Lxx)`` is the split factor of :func:`factor_solve_folded_flat`.
    Returns ``(z, pi)``.

    CPU tensors run :func:`solve_flat_pb_ref`; CUDA tensors launch the Pb
    form of ``csrc/solve_flat.cu`` (no sync)."""
    name = "solve_flat_pb"
    if g.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return solve_flat_pb_ref(Ll, Lxx, g, F, b, NU=NU, NZ=NZ, NX=NX)
    return _launch_solve_flat(name, Ll, Lxx, None, g, F, b, NU=NU, NZ=NZ,
                              NX=NX)


# ---------------------------------------------------------------------------
# the structured IPM's kernel backend: full factor (rows 14-16)
# ---------------------------------------------------------------------------


def _full_sweeps(Hb, gb, Fb, bb, NU):
    """Backward folded sweep on the effective Hessian ``Hb`` (B, N+1, NZ,
    NZ), then the forward recovery, batch-first: (z, pi, L, eu, px, Pb)
    with the full factor and eu padded to NZ."""
    B, Np1, NZ = gb.shape
    N, NX = Np1 - 1, NZ - NU
    new = gb.new_zeros
    L, eus, pxs, Pb = new(B, Np1, NZ, NZ), new(B, Np1, NZ), new(B, Np1, NX), \
        new(B, N, NX)
    Lxx_c, px_c = new(B, NX, NX), new(B, NX)
    for k in range(N, -1, -1):
        ke = min(k, N - 1)
        Lf, eu, px, Pbk = sm.folded_bwd_core(NU, Hb[:, k], gb[:, k],
                                             Fb[:, ke], bb[:, ke], Lxx_c, px_c)
        Lxx_c, px_c = Lf[:, NU:, NU:], px
        L[:, k], eus[:, k, :NU], pxs[:, k] = Lf, eu, px
        if k < N:
            Pb[:, k] = Pbk
    z, pi = _forward(L[..., :NU], L[:, :, NU:, NU:], eus[..., :NU], pxs, Fb,
                     bb, True)
    return z, pi, L, eus, pxs, Pb


def whole_hessian(H, dvec, ngterm, ng_stage_ids, NZ):
    """The effective Hessian that :func:`factor_solve_folded` assembles --
    packed ``H`` + diag(``dvec``) + the packed ng term ``ngterm[j]`` on
    stage ``ng_stage_ids[j]`` -- whole, batch-last (N+1, NZ, NZ, B): the
    input of :func:`factor_solve_batched`."""
    Hf = sym_expand(from_lanes(H), NZ) + torch.diag_embed(from_lanes(dvec))
    if ng_stage_ids:
        ngf = sym_expand(from_lanes(ngterm), NZ)
        for j, n in enumerate(ng_stage_ids):
            Hf[:, n] += ngf[:, j]
    return to_lanes(Hf)


def factor_solve_folded_ref(H, dvec, ngterm, ng_stage_ids, g_eff, F, b, NU):
    """Plain PyTorch version of :func:`factor_solve_folded` (same
    arguments, same outputs): :func:`factor_solve_batched_ref` on
    :func:`whole_hessian`."""
    return factor_solve_batched_ref(
        whole_hessian(H, dvec, ngterm, ng_stage_ids, g_eff.shape[1]),
        g_eff, F, b, NU)


def factor_solve_batched_ref(H_eff, g_eff, F, b, NU):
    """Plain PyTorch version of :func:`factor_solve_batched` (same
    arguments, same outputs)."""
    out = _full_sweeps(*(from_lanes(x) for x in (H_eff, g_eff, F, b)), NU)
    return tuple(to_lanes(x) for x in out)


def solve_batched_ref(L, g_eff, F, b, Pb, NU):
    """Plain PyTorch version of :func:`solve_batched` (same arguments,
    same outputs)."""
    Lb, gb, Fb, bb, Pbb = (from_lanes(x) for x in (L, g_eff, F, b, Pb))
    Ll, Lxx = Lb[..., :NU], Lb[:, :, NU:, NU:]
    eus, pxs = _trs(Ll, Lxx, Pbb, gb, Fb, bb)
    z, pi = _forward(Ll, Lxx, eus, pxs, Fb, bb, True)
    return to_lanes(z), to_lanes(pi)


def _launch_folded(name, H, dvec, ngl, ng_stage_ids, g, F, b, NU):
    """Check and launch one form of ``csrc/factor_solve_folded.cu``: the
    folded one (``dvec`` given, packed H) or the whole-Hessian one."""
    Np1, NZ, B = g.shape
    N, NX, n_ng = Np1 - 1, F.shape[2], len(ng_stage_ids)
    if NZ != NU + NX:
        raise ValueError(f"{name}: NZ {NZ} != NU {NU} + NX {NX}")
    if dvec is None:
        named = dict(H=H, g=g, F=F, b=b)
        hshape = (Np1, NZ, NZ, B)
    else:
        named = dict(H=H, dvec=dvec, ngl=ngl, g=g, F=F, b=b)
        hshape = (Np1, sym_nt(NZ), B)
    shapes = dict(H=hshape, dvec=(Np1, NZ, B), ngl=(n_ng, sym_nt(NZ), B),
                  g=(Np1, NZ, B), F=(N, NZ, NX, B), b=(N, NX, B))
    _cuda_check(name, g, ng_stage_ids, named, shapes)
    new = lambda *s: torch.empty(*s, dtype=g.dtype, device=g.device)  # noqa: E731
    L, eu, px, Pb = new(Np1, NZ, NZ, B), new(Np1, NZ, B), new(Np1, NX, B), \
        new(N, NX, B)
    z, pi = new(Np1, NZ, B), new(N, NX, B)
    ptrs = (H, dvec, ngl, _build.int_table(ng_stage_ids, g.device), g, F, b, L,
            eu, px, Pb, z, pi)
    a = _FoldedArgs(*[_build.ptr(x) for x in ptrs], B, N, n_ng)
    _build.launch("factor_solve_folded", name, a, g.device, g.dtype, NU=NU,
                  NX=NX)
    LAUNCHES[name] += 1
    return z, pi, L, eu, px, Pb


def factor_solve_folded(H, dvec, ngterm, ng_stage_ids, g_eff, F, b, NU):
    """Folded Riccati factorization + forward recovery, one launch (Queue 2
    row 16): the effective Hessian H + diag(dvec) (+ the packed C'
    diag(Qx_g) C term ``ngterm[j]`` on stage ``ng_stage_ids[j]``) is
    assembled in the kernel, never stored.

    Inputs: packed ``H`` (N+1, NT, B), ``dvec`` and ``g_eff`` (N+1, NZ,
    B), ``ngterm`` (n_ng, NT, B) or None without ng stages, ``F`` (N, NZ,
    NX, B), ``b`` (N, NX, B).  Returns ``(z, pi, L, eu, px, Pb)`` (module
    doc).

    CPU tensors run :func:`factor_solve_folded_ref`; CUDA tensors launch
    ``csrc/factor_solve_folded.cu`` on the current stream (no sync)."""
    name = "factor_solve_folded"
    if H.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return factor_solve_folded_ref(H, dvec, ngterm, tuple(ng_stage_ids),
                                       g_eff, F, b, NU)
    return _launch_folded(name, H, dvec, ngterm, ng_stage_ids, g_eff, F, b,
                          NU)


def factor_solve_batched(H_eff, g_eff, F, b, NU):
    """Riccati factorization + forward recovery of an effective Hessian
    handed over whole, one launch (Queue 2 row 14): ``H_eff`` (N+1, NZ,
    NZ, B), of which the lower triangle is read; the rest as
    :func:`factor_solve_folded`.

    CPU tensors run :func:`factor_solve_batched_ref`; CUDA tensors launch
    the whole-Hessian form of ``csrc/factor_solve_folded.cu`` (no sync)."""
    name = "factor_solve_batched"
    if H_eff.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return factor_solve_batched_ref(H_eff, g_eff, F, b, NU)
    return _launch_folded(name, H_eff, None, None, (), g_eff, F, b, NU)


def solve_batched(L, g_eff, F, b, Pb, NU):
    """Retained-factor backward substitution with the cached Pb + forward
    recovery, one launch (Queue 2 row 15): the solve of the gradient
    ``g_eff`` (N+1, NZ, B) and right-hand side ``b`` (N, NX, B) against
    the full factor ``L`` (N+1, NZ, NZ, B) and ``Pb`` (N, NX, B) of
    :func:`factor_solve_folded`.  Returns ``(z, pi)``.

    CPU tensors run :func:`solve_batched_ref`; CUDA tensors launch
    ``csrc/solve_batched.cu`` (no sync)."""
    name = "solve_batched"
    if g_eff.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return solve_batched_ref(L, g_eff, F, b, Pb, NU)
    Np1, NZ, B = g_eff.shape
    N, NX = Np1 - 1, F.shape[2]
    if NZ != NU + NX:
        raise ValueError(f"{name}: NZ {NZ} != NU {NU} + NX {NX}")
    named = dict(L=L, g=g_eff, F=F, b=b, Pb=Pb)
    shapes = dict(L=(Np1, NZ, NZ, B), g=(Np1, NZ, B), F=(N, NZ, NX, B),
                  b=(N, NX, B), Pb=(N, NX, B))
    _cuda_check(name, g_eff, (), named, shapes)
    new = lambda *s: torch.empty(*s, dtype=L.dtype, device=L.device)  # noqa: E731
    z, pi, work = new(Np1, NZ, B), new(N, NX, B), new(Np1 * NZ, B)
    a = _TrsArgs(*[_build.ptr(x) for x in (L, g_eff, F, b, Pb, z, pi,
                                           work)], B, N)
    _build.launch(name, name, a, L.device, L.dtype, NU=NU, NX=NX)
    LAUNCHES[name] += 1
    return z, pi
