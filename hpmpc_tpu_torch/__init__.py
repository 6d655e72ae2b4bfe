"""PyTorch + CUDA port of :mod:`hpmpc_tpu` (linear-MPC solvers on an H100).

The module names mirror the JAX package (``ocp``, ``models.ipm``,
``ops.step_kernel``, ``parallel.batch``, ...) so each counterpart is easy
to find; the JAX package stays the reference the port is tested against.
This package imports ``torch``, numpy and scipy only — never ``jax`` or
``hpmpc_tpu``.

Hand-written CUDA kernels live under ``csrc/`` and are built with ``nvcc``
at first use into ``_build/`` (see :mod:`.ops._build`).  On a CPU tensor
every kernel wrapper runs its plain PyTorch version instead.

Precision: float32 matrix products are pinned to full precision (no TF32),
the CUDA form of the bf16-MXU trap the JAX package pins against.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .ocp import OCPDims, OCPQP, pack_ocp  # noqa: E402

__all__ = ["OCPDims", "OCPQP", "pack_ocp"]
