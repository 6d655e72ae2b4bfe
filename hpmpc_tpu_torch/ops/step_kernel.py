"""Exact KKT residuals on batch-last streams: CUDA kernel + plain version.

Port of ``hpmpc_tpu/ops/step_kernel.py::resid_full_flat`` (TPU body
``_resid_kernel``), the twin of the reference's ``d_res_res_mpc_hard_tv``.
The other step kernels of that file (prep / alpha / corrector, soft
variants) belong to the lanes engine and are not ported yet.

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
    code = _build.dtype_code(z.dtype)
    lib = _build.load("resid_full", NU=NU, NX=NX, NB=NB)
    new = lambda *s: torch.empty(*s, dtype=z.dtype, device=z.device)  # noqa: E731
    rq, rb = new(Np1, NZ, B), new(Np1, NX, B)
    rd, rm = new(Np1, NB2, B), new(Np1, NB2, B)
    musum = new(Np1, B)
    a = _ResidArgs(*[_build.ptr(x) for x in args],
                   *[_build.ptr(x) for x in (rq, rb, rd, rm, musum)],
                   B, N)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        rc = lib.hp_resid_full(ctypes.addressof(a), code, stream)
    _build.check(lib, rc, "resid_full")
    RESID_LAUNCHES += 1
    return rq, rb, rd, rm, musum
