"""Stream layout helpers (twin of the layout half of
:mod:`hpmpc_tpu.ops.stage_kernel`).

The TPU kernels keep every per-stage stream as ``(nb, N+1, k, 8, 128)``
tiles — 1024 instances per block in the vector lanes.  On the GPU one
instance is one CUDA thread, so the same streams become **batch-last**
``(N+1, k, B)``: neighbouring threads read neighbouring addresses
(coalesced), with no block size or tile shape to respect.

Symmetric stage matrices travel packed: row-major lower triangle,
``n(n+1)/2`` entries, entry (i, j) with j <= i at ``sym_idx(i, j)``.
"""

from __future__ import annotations

import torch


def sym_nt(n: int) -> int:
    return n * (n + 1) // 2


def sym_idx(i: int, j: int) -> int:
    """Packed index of the (i, j) entry, j <= i, of a row-major lower
    triangle."""
    return i * (i + 1) // 2 + j


def sym_compress(x: torch.Tensor) -> torch.Tensor:
    """(..., n, n) symmetric -> (..., n(n+1)/2) packed lower triangle
    (an exact gather; ``tril_indices`` walks it row-major)."""
    n = x.shape[-1]
    r, c = torch.tril_indices(n, n, device=x.device)
    return x[..., r, c]


def sym_expand(p: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`sym_compress` along the last axis: (..., nt) ->
    (..., n, n) symmetric."""
    idx = torch.tensor([[sym_idx(max(i, j), min(i, j)) for j in range(n)]
                        for i in range(n)], device=p.device)
    return p[..., idx]


def to_lanes(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> batch-last (..., B), contiguous."""
    return x.movedim(0, -1).contiguous()


def from_lanes(y: torch.Tensor) -> torch.Tensor:
    """Batch-last (..., B) -> (B, ...), contiguous."""
    return y.movedim(-1, 0).contiguous()
