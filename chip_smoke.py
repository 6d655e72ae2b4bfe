#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``hpmpc_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``hpmpc_tpu_torch/csrc`` (nvcc,
into ``hpmpc_tpu_torch/_build/``), checks each kernel against its plain
PyTorch version on the card at the flagship shapes in float32 and
float64, then drives the port's main path — ``bench.py``'s flagship:
mass-spring nx=8 nu=3 N=30 nb=7 with an ngN=8 terminal equality block,
4096 float32 instances with perturbed ``b``, through
``parallel.batch.solve_batched`` — verifies that it went through both
kernels and that the answer holds up under the float64 host residual
oracle, and times it.  Every failed check raises, so the exit code is
non-zero.  Output, one item per line: the card (nvidia-smi name, power
limit), build seconds, per-check results, timings, a JSON line with the
kernels, and last ``{"ok": true, "device": {...}}``.

Imports no JAX.  Exits non-zero without a CUDA device or without the
package beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

B = 4096
N_HORIZON = 30
SEED = 0

# kernel vs plain on the card, per dtype.  Both run the same algorithm in
# another summation order, so they agree to roundoff as amplified by the
# flagship's conditioning, which grows fast near the barrier floor.  f64:
# the last two iterations (mu ~1e-8 -> 1e-10) amplify it through the
# terminal equality block to ~2e-4 in z between ANY two summation orders
# (measured: the plain version vs the JAX structured solver, 16 instances;
# 3e-9 at k_max=6), so the f64 check runs k_max=6 (mu ~1e-6) and holds a
# tight tolerance.  f32: a one-ulp relative perturbation of b moves pi by
# 3e-4 after 2 iterations, 7e-3 after 3, 0.8 after 5, and flips half the
# instances' freeze iteration by 8 (plain version, 64 instances, CPU), so
# the f32 check runs k_max=2 at tests/test_resident.py's tolerances.
TOL = {
    "float64": dict(k_max=6, z=1e-7, pi=1e-6, lam_rtol=1e-6, lam_atol=1e-6,
                    resid=1e-9),
    "float32": dict(k_max=2, z=2e-3, pi=5e-3, lam_rtol=5e-3, lam_atol=5e-3,
                    resid=1e-3),
}
ORACLE_SUBSAMPLE = 64


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(reps):
        fn(r + 1)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _maxdiff(torch, a, b, mask=None) -> float:
    d = (a.double() - b.double()).abs()
    if mask is not None:
        d = d[..., mask]
    return float(d.max()) if d.numel() else 0.0


def main() -> int:
    repo = pathlib.Path(__file__).resolve().parent
    if not (repo / "hpmpc_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: hpmpc_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    import numpy as np

    from hpmpc_tpu_torch.models import ipm_resident
    from hpmpc_tpu_torch.models.ipm import IPMConfig
    from hpmpc_tpu_torch.ops import _build
    from hpmpc_tpu_torch.ops import resident_kernel as rk
    from hpmpc_tpu_torch.ops import step_kernel as stk
    from hpmpc_tpu_torch.parallel import batch as pbatch
    from hpmpc_tpu_torch.utils.mass_spring import mass_spring_qp
    from hpmpc_tpu_torch.utils.resid64 import true_residuals_sol

    if "jax" in sys.modules:
        _fail("jax was imported")
    dev = torch.device("cuda", 0)
    card = _card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    cfg = IPMConfig(k_max=8, mu_tol=0.0, alpha_min=1e-8, mu_switch=0.0,
                    use_pallas=True)
    rng = np.random.default_rng(SEED)
    scales = 1.0 + 0.05 * rng.standard_normal(B)

    def flagship(dtype):
        dims, qp = mass_spring_qp(8, 3, N_HORIZON, ngN=8, dtype=dtype,
                                  device=dev)
        qpb = pbatch.broadcast_qp(qp, B)
        sc = torch.as_tensor(scales, dtype=dtype, device=dev)
        return dims, dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])

    # ---- 1. build ---------------------------------------------------------
    dims, _ = mass_spring_qp(8, 3, N_HORIZON, ngN=8)
    t0 = time.perf_counter()
    _build.load("resid_full", NU=dims.NU, NX=dims.NX, NB=dims.NB)
    _build.load("ipm_resident", NU=dims.NU, NX=dims.NX, NB=dims.NB,
                NG=dims.NG)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 2. each kernel vs its plain version, float32 and float64 --------
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        dims, qpb = flagship(dtype)
        cfg_chk = dataclasses.replace(cfg, k_max=tol["k_max"])
        args, kw, cm, _ = ipm_resident.resident_inputs(dims, qpb, cfg_chk)
        out_k = rk.ipm_resident(*args, **kw)
        torch.cuda.synchronize()
        out_p = rk.ipm_resident_ref(*args, **kw)
        if not torch.equal(out_k[5], out_p[5]):
            _fail(f"ipm_resident {name}: kk differs from the plain version")
        dz = _maxdiff(torch, out_k[0], out_p[0])
        dpi = _maxdiff(torch, out_k[1], out_p[1])
        # box and general-constraint multipliers and slacks
        pairs = [(out_k[i], out_p[i]) for i in (2, 3, 8, 9)]
        dlam = max(_maxdiff(torch, a, b) for a, b in pairs)
        lam_ok = all(bool(torch.allclose(a, b, rtol=tol["lam_rtol"],
                                         atol=tol["lam_atol"]))
                     for a, b in pairs)
        for arr in out_k:
            if arr.is_floating_point() and not bool(torch.isfinite(arr).all()):
                _fail(f"ipm_resident {name}: non-finite kernel output")
        print(f"ipm_resident {name} (k_max={tol['k_max']}): kk equal, "
              f"max|dz| {dz:.3e}, "
              f"max|dpi| {dpi:.3e}, max|dlam| {dlam:.3e}", flush=True)
        if not (dz <= tol["z"] and dpi <= tol["pi"] and lam_ok):
            _fail(f"ipm_resident {name} disagrees with its plain version")

        # resid_full on the kernel's exit iterate
        r_args, r_kw = ipm_resident.exit_resid_inputs(dims, qpb, cm,
                                                      *out_k[:4])
        res_k = stk.resid_full(*r_args, **r_kw)
        res_p = stk.resid_full_ref(*r_args, **r_kw)
        N = dims.N
        dres = max(_maxdiff(torch, a[:N] if i == 1 else a,
                            b[:N] if i == 1 else b)
                   for i, (a, b) in enumerate(zip(res_k, res_p)))
        scale = max(float(b.abs().max()) for b in res_p)
        print(f"resid_full {name}: max|d| {dres:.3e} (scale {scale:.3e})",
              flush=True)
        if not dres <= tol["resid"] * max(scale, 1.0):
            _fail(f"resid_full {name} disagrees with its plain version")

        if dtype == torch.float32:
            max_abs_err = {"ipm_resident": dz, "resid_full": dres}

    # ---- 3. the main path: solve_batched at the flagship, float32 --------
    dims, qpb = flagship(torch.float32)
    engine = pbatch.select_engine(dims, cfg, B, torch.float32)
    if engine != "resident":
        _fail(f"select_engine chose {engine!r}, expected 'resident'")
    rk.LAUNCHES = 0
    stk.RESID_LAUNCHES = 0
    sol = pbatch.solve_batched(dims, qpb, cfg)
    torch.cuda.synchronize()
    launches = {"ipm_resident": rk.LAUNCHES, "resid_full": stk.RESID_LAUNCHES}
    if min(launches.values()) < 1:
        _fail(f"main path skipped a kernel: launches {launches}")
    shapes = {"z": (B, N + 1, dims.NZ), "pi": (B, N, dims.NX),
              "lam_b": (B, N + 1, 2, dims.NB), "kk": (B,),
              "stat": (B, cfg.k_max, 5), "inf_norm_res": (B, 4)}
    for f, shp in shapes.items():
        if tuple(getattr(sol, f).shape) != shp:
            _fail(f"solution field {f} has shape "
                  f"{tuple(getattr(sol, f).shape)}, expected {shp}")
    for f in sol._fields:
        x = getattr(sol, f)
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            _fail(f"solution field {f} is not finite")
    kk = sol.kk.double()
    status = torch.bincount(sol.status, minlength=3).tolist()
    print(f"main path: engine {engine}, launches {launches}, "
          f"mean kk {float(kk.mean()):.3f}, status counts "
          f"(converged, max-iter, frozen) {status}", flush=True)
    if float(kk.mean()) <= 3.0:
        _fail(f"suspicious mean iteration count {float(kk.mean())}")

    # f64 host oracle on a subsample: the engine's own residual report and
    # the true residuals of the returned iterate must agree, and the primal
    # feasibility residuals must be small
    sub = torch.arange(0, B, B // ORACLE_SUBSAMPLE, device=dev)
    qsub = type(qpb)(**{f.name: getattr(qpb, f.name)[sub]
                        for f in dataclasses.fields(qpb)})
    ssub = type(sol)(*[getattr(sol, f)[sub] for f in sol._fields])
    res, _ = true_residuals_sol(qsub, ssub)
    eng = ssub.inf_norm_res.double().cpu().numpy()
    if not np.all(np.isfinite(res)):
        _fail("oracle residuals not finite")
    if not np.allclose(res, eng, rtol=1e-2, atol=1e-5):
        _fail(f"oracle vs engine residuals: max abs diff "
              f"{np.abs(res - eng).max():.3e}")
    if res[:, 1].max() > 1e-3 or res[:, 2].max() > 1e-3:
        _fail(f"primal residuals too large: rb {res[:, 1].max():.3e}, "
              f"rd {res[:, 2].max():.3e}")
    print(f"f64 oracle ({ORACLE_SUBSAMPLE} instances): max |rq| "
          f"{res[:, 0].max():.3e}, |rb| {res[:, 1].max():.3e}, |rd| "
          f"{res[:, 2].max():.3e}, mu {res[:, 3].max():.3e}", flush=True)

    # ---- 4. timings ---------------------------------------------------------
    def solve_rep(r):
        q = dataclasses.replace(qpb, b=qpb.b * (1.0 + 1e-4 * r))
        return pbatch.solve_batched(dims, q, cfg)

    @contextlib.contextmanager
    def plain_kernels():
        saved = rk.ipm_resident, stk.resid_full
        rk.ipm_resident, stk.resid_full = (rk.ipm_resident_ref,
                                           stk.resid_full_ref)
        try:
            yield
        finally:
            rk.ipm_resident, stk.resid_full = saved

    ms_e2e = _time_ms(torch, solve_rep, reps=10)
    with plain_kernels():
        ms_e2e_plain = _time_ms(torch, solve_rep, reps=2)
    print(f"main path [{card}]: {ms_e2e:.3f} ms per {B}-batch "
          f"({B / ms_e2e * 1e3:.1f} solves/s, mean kk "
          f"{float(kk.mean()):.3f}); plain version {ms_e2e_plain:.3f} ms",
          flush=True)

    # each kernel alone, at the main path's shapes and config
    args, kw, cm, _ = ipm_resident.resident_inputs(dims, qpb, cfg)
    r_args, r_kw = ipm_resident.exit_resid_inputs(
        dims, qpb, cm, *rk.ipm_resident(*args, **kw)[:4])
    kernels = []
    for name, src, repl, plain, fast, a, k, reps in (
            ("ipm_resident", "hpmpc_tpu_torch/csrc/ipm_resident.cu",
             "hpmpc_tpu/ops/resident_kernel.py:813", rk.ipm_resident_ref,
             rk.ipm_resident, args, kw, 10),
            ("resid_full", "hpmpc_tpu_torch/csrc/resid_full.cu",
             "hpmpc_tpu/ops/step_kernel.py:463", stk.resid_full_ref,
             stk.resid_full, r_args, r_kw, 50)):
        ms = _time_ms(torch, lambda r: fast(*a, **k), reps=reps)
        ms_plain = _time_ms(torch, lambda r: plain(*a, **k), reps=2)
        print(f"{name} [{card}]: kernel {ms:.4f} ms, plain {ms_plain:.4f} "
              f"ms (float32, B={B}, N={N_HORIZON}, k_max={cfg.k_max})",
              flush=True)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[name],
                        "max_abs_err": max_abs_err[name],
                        "ms": ms, "plain_ms": ms_plain})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
