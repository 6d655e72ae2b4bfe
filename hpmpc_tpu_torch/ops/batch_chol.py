"""Batched dense Cholesky for the large-NZ band: CUDA kernels + plain
versions.

Port of ``hpmpc_tpu/ops/batch_chol.py``.  The structured route's blocked
Riccati (:mod:`..models.riccati_blocked`) factors one (B, NZ, NZ) stage
matrix per stage; past the per-thread engines' size envelope
(:func:`.stage_kernel.engine_fits`) that batched Cholesky is where its
factorization runs.

  * :func:`cholesky` (Queue 2 row 24; TPU body ``_chol_body``) — the
    right-looking rank-1 factorization, ``d_j = rsqrt(max(a_jj, tiny))``
    (tiny 1e-20 in float32, 1e-30 in float64), the trailing block updated
    by ``(A[:, j] d_j)(A[j, :] d_j)`` per column, and ``L = tril(A d)`` at
    the end.  :func:`cholesky_ref` is the same loop in PyTorch.  The CUDA
    kernel runs it in panels of 8 columns (the same updates in the same
    column order).
  * :func:`panel_factor` (Queue 2 row 25; TPU body ``_panel_body``) — the
    Cholesky of (B, p, p) panels with their lower-triangular inverse;
    :func:`panel_factor_ref` is its plain version.  :func:`cholesky_blocked`
    is the PyTorch code around it (the column-block trsm as ``A21 @
    Linv'`` and the trailing syrk ``A22 -= L21 L21'``, both ``torch.
    matmul``, as JAX's are ``jnp.matmul``).  As in JAX, nothing routes to
    it: the TPU measured it slower than the rank-1 kernel, and the card's
    numbers are in PERF.md.

Leading batch dimensions are flattened into one, as in JAX.  The TPU
wrapper pads the batch to a multiple of its grid tile with identity
instances (``batch_chol.py:232-235``); the CUDA kernels take one matrix per
thread block (row 24) or warp (row 25), so the port pads nothing.

CPU tensors run the plain versions; CUDA tensors launch
``csrc/batch_chol.cu`` (one library for every size: n and p are runtime)
on the current stream, no sync, or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of each CUDA kernel in this process
LAUNCHES = {"cholesky": 0, "panel_factor": 0}
#: calls of each wrapper that ran the plain version (CPU tensors)
PLAIN_CALLS = dict.fromkeys(LAUNCHES, 0)
#: the panel kernel's widest panel (one lane a column)
MAX_P = 32


class _CholArgs(ctypes.Structure):
    # mirrors struct CholArgs in csrc/batch_chol.cu
    _fields_ = [("A", ctypes.c_void_p), ("L", ctypes.c_void_p),
                ("B", ctypes.c_int64), ("n", ctypes.c_int64)]


class _PanelArgs(ctypes.Structure):
    # mirrors struct PanelArgs in csrc/batch_chol.cu
    _fields_ = [("A", ctypes.c_void_p), ("L", ctypes.c_void_p),
                ("Linv", ctypes.c_void_p), ("B", ctypes.c_int64),
                ("p", ctypes.c_int64)]


def _tiny(dt) -> float:
    return 1e-30 if dt == torch.float64 else 1e-20


def _pivot(a, tiny):
    """``rsqrt(max(a, tiny))``; NaN propagates, as ``jnp.maximum``."""
    return torch.rsqrt(torch.clamp(a, min=tiny))


def cholesky_ref(M):
    """Plain PyTorch version of :func:`cholesky`: ``_chol_body``'s loop on
    the whole matrix, column j updating the rows from j's multiple of 8
    down (the TPU's sublane-aligned trailing slice; the rows above j only
    touch entries the final ``tril`` drops)."""
    n = M.shape[-1]
    A = M.clone()
    lane = torch.arange(n, device=M.device)
    dvec = torch.zeros(M.shape[:-1], dtype=M.dtype, device=M.device)
    tiny = _tiny(M.dtype)
    for j in range(n):
        r0 = (j // 8) * 8
        d = _pivot(A[..., j:j + 1, j:j + 1], tiny)
        rm = torch.where(lane > j, A[..., j:j + 1, :] * d,
                         torch.zeros((), dtype=M.dtype, device=M.device))
        c = A[..., r0:, j:j + 1] * d
        A[..., r0:, :] = A[..., r0:, :] - c * rm
        dvec[..., j] = d[..., 0, 0]
    return torch.tril(A * dvec[..., None, :])


def cholesky(M):
    """Batched lower Cholesky of symmetric positive definite ``M`` (...,
    n, n) (Queue 2 row 24): the factor with its strictly upper part 0.
    Only the lower triangle is read on the card (on a symmetric input the
    TPU kernel's arithmetic; see ``csrc/batch_chol.cu``).

    CPU tensors run :func:`cholesky_ref`; CUDA tensors launch the kernel
    (one thread block per matrix, panels of 8 columns, every n; no
    sync)."""
    name = "cholesky"
    if M.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return cholesky_ref(M)
    if M.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {M.device}")
    if M.ndim < 2 or M.shape[-1] != M.shape[-2] or M.shape[-1] < 1:
        raise ValueError(f"{name}: expected (..., n, n), got "
                         f"{tuple(M.shape)}")
    n = M.shape[-1]
    A = M.reshape(-1, n, n).contiguous()
    B = A.shape[0]
    _build.check_tensors(M.device, M.dtype, {"A": A}, {"A": (B, n, n)})
    L = torch.empty_like(A)
    if B:
        args = _CholArgs(_build.ptr(A), _build.ptr(L), B, n)
        _build.launch("batch_chol", name, args, M.device, M.dtype)
        LAUNCHES[name] += 1
    return L.reshape(M.shape)


def panel_factor_ref(A):
    """Plain PyTorch version of :func:`panel_factor`: ``_panel_body``'s
    loops (the rank-1 factorization on every row, then the inverse by
    forward substitution, one row at a time)."""
    p = A.shape[-1]
    dt, dev = A.dtype, A.device
    lane = torch.arange(p, device=dev)
    row = lane[:, None]
    zero = torch.zeros((), dtype=dt, device=dev)
    dvec = torch.zeros(A.shape[:-1], dtype=dt, device=dev)
    tiny = _tiny(dt)
    for j in range(p):
        d = _pivot(A[..., j:j + 1, j:j + 1], tiny)
        rm = torch.where(lane > j, A[..., j:j + 1, :] * d, zero)
        A = A - (A[..., :, j:j + 1] * d) * rm
        dvec[..., j] = d[..., 0, 0]
    L = torch.where(row >= lane, A * dvec[..., None, :], zero)
    eye = (row == lane).to(dt)
    Linv = torch.zeros_like(L)
    for i in range(p):
        li = torch.where(lane < i, L[..., i:i + 1, :], zero)  # (..., 1, p)
        acc = (li.transpose(-1, -2) * Linv).sum(-2, keepdim=True)
        di = dvec[..., i:i + 1, None]
        Linv[..., i:i + 1, :] = (eye[i:i + 1, :] - acc) * di
    return L, Linv


def panel_factor(A):
    """Panel Cholesky and its lower-triangular inverse (Queue 2 row 25):
    ``A`` (B, p, p) symmetric positive definite, p <= 32; returns ``(L,
    Linv)``, both (B, p, p).

    CPU tensors run :func:`panel_factor_ref`; CUDA tensors launch the
    kernel (one warp per panel; no sync)."""
    name = "panel_factor"
    if A.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return panel_factor_ref(A)
    if A.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {A.device}")
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"{name}: expected (B, p, p), got {tuple(A.shape)}")
    B, p = A.shape[0], A.shape[-1]
    if not 1 <= p <= MAX_P:
        raise ValueError(f"{name}: p={p} outside 1..{MAX_P}")
    _build.check_tensors(A.device, A.dtype, {"A": A}, {"A": (B, p, p)})
    L, Linv = torch.empty_like(A), torch.empty_like(A)
    if B:
        args = _PanelArgs(_build.ptr(A), _build.ptr(L), _build.ptr(Linv), B,
                          p)
        _build.launch("batch_chol", name, args, A.device, A.dtype)
        LAUNCHES[name] += 1
    return L, Linv


def cholesky_blocked(M, p: int = 8):
    """Blocked right-looking batched Cholesky of ``M`` (..., n, n): panels
    of width ``p`` factor with their inverse in :func:`panel_factor`; the
    column-block trsm and the trailing syrk are batched matmuls.  ``n`` is
    padded to a multiple of ``p`` with identity on the padded diagonal, as
    in JAX."""
    shape = M.shape
    n = shape[-1]
    A = M.reshape(-1, n, n)
    npad = -(-n // p) * p
    if npad != n:
        A = torch.nn.functional.pad(A, (0, npad - n, 0, npad - n))
        ii = torch.arange(n, npad, device=M.device)
        A[:, ii, ii] = 1.0
    else:
        A = A.clone()
    L = torch.zeros_like(A)
    for k in range(0, npad, p):
        L11, L11i = panel_factor(A[:, k:k + p, k:k + p].contiguous())
        L[:, k:k + p, k:k + p] = L11
        if k + p < npad:
            L21 = A[:, k + p:, k:k + p] @ L11i.transpose(-1, -2)
            A[:, k + p:, k + p:] -= L21 @ L21.transpose(-1, -2)
            L[:, k + p:, k:k + p] = L21
    return L[:, :n, :n].reshape(shape)
