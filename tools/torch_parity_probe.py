#!/usr/bin/env python3
"""Accuracy probe of the PyTorch port's float32 routes at bench.py's
flagship (mass-spring nx=8 nu=3 N=30 nb=7, ngN=8), against its float64
lanes engine on the same batch (``b`` scaled by ``1 + 0.05 N(0,1)``, seed
0):

  * per iteration budget k = 1..k_max, the max control error (max |u|
    difference over all stages and instances) of the f32 lanes engine,
    unrefined and with ``iter_ref=1`` on every iteration, against the f64
    lanes engine at the same budget, and the size of the f64 step;
  * bench.py's parity route (``iter_ref=1, iter_ref_mu_thr=1e-3``,
    two-stage) and the unrefined f32 route at ``k_max=8``: iteration
    counts, status counts, and their control errors.

Imports no JAX.  Runs on the card unless asked for the CPU; on the CPU
the kernel wrappers run their plain versions (keep ``--batch`` small):

    python3 tools/torch_parity_probe.py --device cpu --batch 32
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--k-max", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import numpy as np
    import torch

    from hpmpc_tpu_torch.models import ipm_lanes
    from hpmpc_tpu_torch.models.ipm import IPMConfig
    from hpmpc_tpu_torch.parallel import batch as pbatch
    from hpmpc_tpu_torch.utils.mass_spring import mass_spring_qp

    B, dev = args.batch, torch.device(args.device)
    scales = 1.0 + 0.05 * np.random.default_rng(0).standard_normal(B)

    def flagship(dt):
        dims, qp = mass_spring_qp(8, 3, 30, ngN=8, dtype=dt, device=dev)
        qpb = pbatch.broadcast_qp(qp, B)
        sc = torch.as_tensor(scales, dtype=dt, device=dev)
        return dims, dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])

    dims, q32 = flagship(torch.float32)
    _, q64 = flagship(torch.float64)
    NU = dims.NU

    def err(sol, z64):
        return float((sol.z[..., :NU].double() - z64[..., :NU]).abs().max())

    prev = None
    ref64 = {}
    for k in range(1, args.k_max + 1):
        cfg = IPMConfig(k_max=k, mu_tol=0.0, use_pallas=True)
        s64 = ipm_lanes.solve_batched_lanes(dims, q64, cfg)
        raw = ipm_lanes.solve_batched_lanes(dims, q32, cfg)
        ref = ipm_lanes.solve_batched_lanes(
            dims, q32, dataclasses.replace(cfg, iter_ref=1))
        step = err(s64, prev) if prev is not None else float("nan")
        print(f"k={k}: f64 mu {float(s64.stat[:, k - 1, 4].max()):.3e}, "
              f"f64 step {step:.3e}; f32 control error unrefined "
              f"{err(raw, s64.z):.3e}, refined {err(ref, s64.z):.3e}")
        prev, ref64[k] = s64.z, s64.z

    cfg = IPMConfig(k_max=args.k_max, mu_tol=0.0, alpha_min=1e-8,
                    iter_ref=1, iter_ref_mu_thr=1e-3, use_pallas=True)
    for label, c in (("parity", cfg),
                     ("unrefined", dataclasses.replace(cfg, iter_ref=0))):
        sol = pbatch.solve_batched(dims, q32, c)
        kk = sol.kk.long().cpu()
        print(f"{label} ({pbatch.select_engine(dims, c, B, torch.float32)})"
              f": kk histogram {torch.bincount(kk).tolist()}, status counts "
              f"{torch.bincount(sol.status.cpu(), minlength=3).tolist()}, "
              f"control error at k_max {err(sol, ref64[args.k_max]):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
