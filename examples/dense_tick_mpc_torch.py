"""Minimum-latency closed-loop MPC through the dense condensed-QP engine of
the PyTorch port (the twin of ``examples/dense_tick_mpc.py``): condense
once, then every control tick is ONE warm-started dense IPM solve from the
raw dynamics offsets, one launch of the hand-written kernel
(``hpmpc_tpu_torch/csrc/dense_ipm.cu``) on the CUDA card.

The tick contract: the condensed matrices are fixed across ticks (the
plant model and costs do not change); the measured state enters through
``b_0 = b + A x0`` as in the stage engines' closed loop, and the plan's
exact affine maps recondense the vectors inside the tick.  Each tick is
seeded from the previous tick's iterate (the RTI hot loop).

Run: python examples/dense_tick_mpc_torch.py              (the card)
     python examples/dense_tick_mpc_torch.py --device cpu (the kernel's
                                                           plain version)
"""

import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hpmpc_tpu_torch.models import ipm, ipm_dense  # noqa: E402
from hpmpc_tpu_torch.ocp import resolve_device  # noqa: E402
from hpmpc_tpu_torch.utils.mass_spring import (mass_spring_ab,  # noqa: E402
                                               mass_spring_qp)


def main(N=12, ticks=40, device=None):
    dev = resolve_device(device)
    nx, nu = 8, 3
    A, B = mass_spring_ab(nx, nu, 0.5)
    dims, qp0 = mass_spring_qp(nx, nu, N, A=A, B=B, device=dev)
    qp0 = dataclasses.replace(qp0, g=qp0.g * 0.0)
    b_nom = 0.1 * np.ones(nx)
    plan = ipm_dense.plan_dense(dims, qp0)
    cfg = ipm.IPMConfig(k_max=10, mu_tol=1e-5, alpha_min=1e-8)
    b_rest = qp0.b[1:].reshape(-1)

    def bflat_for(x0):
        b0 = torch.as_tensor(b_nom + A @ x0, dtype=qp0.dtype, device=dev)
        return torch.cat([b0, b_rest])

    x = np.r_[2.5, 2.5, np.zeros(nx - 2)]
    y = None
    kks = []
    rng = np.random.default_rng(0)
    for t in range(ticks):
        res = ipm_dense.solve_dense_tick(plan, bflat_for(x), cfg, y0=y)
        assert int(res.status) == 0, f"tick {t} failed"
        u0 = res.u0.cpu().numpy()
        assert np.all(np.abs(u0) <= 0.5 + 1e-5), "input bound violated"
        x = A @ x + B @ u0 + 0.01 * rng.standard_normal(nx)
        y = res.y
        kks.append(int(res.kk))
        if t % 8 == 0:
            print(f"t={t:2d}  u0={np.round(u0, 3)}  "
                  f"|x|={np.linalg.norm(x):.4f}  kk={int(res.kk)}  "
                  f"mu={float(res.mu):.2e}")
    assert np.linalg.norm(x) < 1.5, "controller failed to regulate"
    # warm ticks converge in fewer iterations than the cold start
    assert np.mean(kks[5:]) < kks[0], (kks[0], np.mean(kks[5:]))
    print(f"regulated under input bounds on {dev}; cold kk={kks[0]}, warm "
          f"mean kk={np.mean(kks[5:]):.1f}: OK")
    return kks


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--horizon", type=int, default=12)
    ap.add_argument("--ticks", type=int, default=40)
    a = ap.parse_args()
    main(N=a.horizon, ticks=a.ticks, device=a.device)
