#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``hpmpc_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``hpmpc_tpu_torch/csrc`` (one nvcc
per library, all started together, into ``hpmpc_tpu_torch/_build/``) and
prints each kernel's registers and spills, checks each kernel against its
plain PyTorch version on the card at the flagship shapes in float32 and
float64, then drives the port's main paths at ``bench.py``'s flagship:
mass-spring nx=8 nu=3 N=30 nb=7 with an ngN=8 terminal equality block,
4096 instances with perturbed ``b``, through ``parallel.batch.
solve_batched``:

  * the resident route, float32, bench.py's headline config
    (``mu_switch=0``): ``ipm_resident`` + ``resid_full``;
  * the library's default tolerances (``mu_tol=1e-8``, ``mu_switch=1e-5``),
    float32, which go to the lanes engine: ``factor_solve_mega`` +
    ``solve_mega`` + ``resid_full``.  float32 freezes at its barrier floor
    above ``mu_switch``, so this path runs the kernels' phase-1 forms;
  * the lanes engine in float64 at the same width, which crosses
    ``mu_switch`` and runs the phase-2 forms to mu <= 1e-8.

Each path runs with the launch counters set to 0 just before and read just
after, and its answer is held against the float64 host residual oracle.
Then everything is timed.  Every failed check raises, so the exit code is
non-zero.  Output, one item per line: the card (nvidia-smi name, power
limit), build seconds and ptxas lines, per-check results, timings, a JSON
line with the kernels (time, plain time, bound), and last
``{"ok": true, "device": {...}}``.

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
# one mega kernel call vs its plain version, on the engine's first call of
# each phase at the initial iterate: no iteration amplifies the roundoff of
# the two summation orders (host builds of the kernels at these shapes:
# <= 6e-6 of a field's scale in f32, 1.3e-14 in f64), so 5e-5 / 1e-11 of
# the field's scale
MEGA_TOL = {"float32": 5e-5, "float64": 1e-11}
ORACLE_SUBSAMPLE = 64
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and float32
# operations/s outside the tensor cores
HBM_BPS = 3.35e12
F32_OPS = 67e12


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


def _flat(out):
    """Tensors of a kernel's inputs or outputs, tuples unpacked, None and
    non-tensors dropped."""
    flat = []
    for o in out:
        if isinstance(o, (tuple, list)):
            flat += _flat(o)
        elif hasattr(o, "is_floating_point"):
            flat.append(o)
    return flat


def _nbytes(*groups) -> int:
    return sum(x.numel() * x.element_size() for g in groups for x in _flat(g))


def _stage_ops(NU, NX, NB, NG):
    """Floating-point operations per instance and stage of each sweep of
    the kernels (a multiply-add counts 2), counted from the loop bounds of
    the stage helpers in csrc/stage_math.cuh."""
    NZ, NB2, NG2 = NU + NX, 2 * NB, 2 * NG
    NT = NZ * (NZ + 1) // 2
    chol = sum(2 + (NZ - j) + sum(2 * (NZ - jj) for jj in range(j + 1, NZ))
               for j in range(NZ))
    fold = 16 * NB + 2 * NB + NZ                     # qx_fold, scatters, diag
    factor = (NZ * NX * NX + 2 * NX * NX + NX + 2 * NZ * NX
              + NZ * (NZ + 1) * NX + chol + NU * NU + 2 * NX * NU)
    fwd = (NU + 2 * NU * NX + NU * NU + 2 * NX * NZ   # dinv, u, x_next
           + 10 * NB2 + 12 * NB2)                    # dt/dlam, alpha sums
    corr = 6 * NB2 + fold + 2 * NZ * NX + NX + NU * NU + 2 * NX * NU + NU
    return dict(
        factor=fold + factor + fwd, solve=corr + fwd + 2 * NX * NX,
        root=2 * NX * NX + NX, update=3 * NZ + 4 * NB2 + 3 * NX,
        ng_factor=NT + NZ, ng_solve=NZ,
        # resident: barrier term C' diag(Q) C, C' q twice, C z twice, and
        # the box-like step math of the ng rows in the four sweeps
        ng_resident=3 * NT * NG + 4 * NZ * NG + 4 * NZ * NG + 60 * NG2,
        resid=2 * NZ * NZ + 2 * NZ * NX + NX + NB + 2 * NX * NZ + 3 * NX
        + 6 * NB2)


def _bound(nbytes: int, ops: float):
    """Least time on the card (ms) and what bounds it: the larger of the
    bytes over HBM bandwidth and the operations over the f32 peak."""
    t_b, t_o = nbytes / HBM_BPS, ops / F32_OPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def _ptxas_lines(log: str):
    """One line per kernel entry of a ptxas -v report: registers, stack
    frame and spills."""
    out, entry, frame = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "bytes stack frame" in line:
            frame = line.strip()
        elif "Used" in line and "registers" in line and entry:
            regs = line.split("Used")[1].split(",")[0].strip()
            out.append(f"{entry}: {regs}, {frame}")
            entry, frame = None, ""
    return out


def _profile(torch, run, reps: int = 3) -> dict:
    """Where one call's time goes: ``torch.profiler`` over ``reps`` calls
    of ``run`` after a warm-up.  Per call: host wall ms, device busy ms
    (the kernels' summed time), ms and launches of the mega kernels, of
    resid_full and of every other kernel, and host-device syncs."""
    from torch.profiler import ProfilerActivity, profile

    run(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in range(reps):
            run(r + 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    out = dict(wall=wall, busy=0.0, mega=0.0, resid=0.0, other=0.0,
               n_mega=0, n_resid=0, n_other=0, syncs=0)
    for e in prof.key_averages():
        if "Synchronize" in e.key:
            out["syncs"] += e.count / reps
        if not str(e.device_type).endswith("CUDA"):
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / reps
        part = ("mega" if "_mega_kernel" in e.key else
                "resid" if "resid_full_kernel" in e.key else "other")
        out[part] += ms
        out["n_" + part] += e.count / reps
        out["busy"] += ms
    return out


@contextlib.contextmanager
def _capture_mega(mk):
    """Record the arguments of the first call of each mega wrapper per
    phase while the block runs: {(name, phase2): (args, kwargs)}."""
    calls, saved = {}, {n: getattr(mk, n)
                        for n in ("factor_solve_mega", "solve_mega")}

    def spy(name):
        fn = saved[name]

        def call(*a, **k):
            calls.setdefault((name, bool(k["phase2"])), (a, k))
            return fn(*a, **k)
        return call

    for n in saved:
        setattr(mk, n, spy(n))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(mk, n, fn)


def _oracle(torch, np, qpb, sol, dev, rtol, atol, primal_max, what):
    """float64 host residuals of a subsample of ``sol``: they must agree
    with the engine's own ``inf_norm_res`` and have small primal
    residuals; returns the oracle's (n, 4) array."""
    from hpmpc_tpu_torch.utils.resid64 import true_residuals_sol

    B_ = sol.z.shape[0]
    sub = torch.arange(0, B_, B_ // ORACLE_SUBSAMPLE, device=dev)
    qsub = type(qpb)(**{f.name: getattr(qpb, f.name)[sub]
                        for f in dataclasses.fields(qpb)})
    ssub = type(sol)(*[getattr(sol, f)[sub] for f in sol._fields])
    res, _ = true_residuals_sol(qsub, ssub)
    eng = ssub.inf_norm_res.double().cpu().numpy()
    if not np.all(np.isfinite(res)):
        _fail(f"{what}: oracle residuals not finite")
    if not np.allclose(res, eng, rtol=rtol, atol=atol):
        _fail(f"{what}: oracle vs engine residuals: max abs diff "
              f"{np.abs(res - eng).max():.3e}")
    if res[:, 1].max() > primal_max or res[:, 2].max() > primal_max:
        _fail(f"{what}: primal residuals too large: rb {res[:, 1].max():.3e}"
              f", rd {res[:, 2].max():.3e}")
    print(f"{what}: f64 oracle ({ORACLE_SUBSAMPLE} instances): max |rq| "
          f"{res[:, 0].max():.3e}, |rb| {res[:, 1].max():.3e}, |rd| "
          f"{res[:, 2].max():.3e}, mu {res[:, 3].max():.3e}, max "
          f"|oracle - engine| {np.abs(res - eng).max():.3e}", flush=True)
    return res


def _check_solution(torch, sol, dims, k_max, what):
    """Shapes of the main fields and finite values everywhere."""
    N = dims.N
    shapes = {"z": (B, N + 1, dims.NZ), "pi": (B, N, dims.NX),
              "lam_b": (B, N + 1, 2, dims.NB), "kk": (B,),
              "stat": (B, k_max, 5), "inf_norm_res": (B, 4)}
    for f, shp in shapes.items():
        if tuple(getattr(sol, f).shape) != shp:
            _fail(f"{what}: solution field {f} has shape "
                  f"{tuple(getattr(sol, f).shape)}, expected {shp}")
    for f in sol._fields:
        x = getattr(sol, f)
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            _fail(f"{what}: solution field {f} is not finite")


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

    from hpmpc_tpu_torch.models import ipm_lanes, ipm_resident
    from hpmpc_tpu_torch.models.ipm import IPMConfig
    from hpmpc_tpu_torch.ops import _build
    from hpmpc_tpu_torch.ops import mega_kernel as mk
    from hpmpc_tpu_torch.ops import resident_kernel as rk
    from hpmpc_tpu_torch.ops import step_kernel as stk
    from hpmpc_tpu_torch.parallel import batch as pbatch
    from hpmpc_tpu_torch.utils.mass_spring import mass_spring_qp

    if "jax" in sys.modules:
        _fail("jax was imported")
    dev = torch.device("cuda", 0)
    card = _card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    cfg = IPMConfig(k_max=8, mu_tol=0.0, alpha_min=1e-8, mu_switch=0.0,
                    use_pallas=True)
    # the library's default tolerances (mu_tol 1e-8, mu_switch 1e-5)
    cfg_lanes = IPMConfig(k_max=30, use_pallas=True)
    rng = np.random.default_rng(SEED)
    scales = 1.0 + 0.05 * rng.standard_normal(B)

    def flagship(dtype):
        dims, qp = mass_spring_qp(8, 3, N_HORIZON, ngN=8, dtype=dtype,
                                  device=dev)
        qpb = pbatch.broadcast_qp(qp, B)
        sc = torch.as_tensor(scales, dtype=dtype, device=dev)
        return dims, dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])

    # ---- 1. build: one nvcc per library, all at once -----------------------
    dims, _ = mass_spring_qp(8, 3, N_HORIZON, ngN=8, device=dev)
    d3 = dict(NU=dims.NU, NX=dims.NX, NB=dims.NB)
    t0 = time.perf_counter()
    _build.build_all([("resid_full", d3),
                      ("ipm_resident", dict(d3, NG=dims.NG)),
                      ("factor_solve_mega", d3), ("solve_mega", d3)])
    print(f"build: {time.perf_counter() - t0:.1f} s (4 libraries in "
          "parallel)", flush=True)
    for lib, log in sorted(_build.PTXAS_LOG.items()):
        for line in _ptxas_lines(log):
            print(f"ptxas {lib.split('_N')[0]}: {line}", flush=True)

    # ---- 2. each kernel vs its plain version, float32 and float64 --------
    max_abs_err = {}
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
            max_abs_err.update(ipm_resident=dz, resid_full=dres)

        # each mega kernel on the engine's first call of each phase at the
        # initial iterate (phase 2 alone: mu_switch=1e9, A = rd, M = rm)
        with _capture_mega(mk) as calls:
            for kw_l in (dict(), dict(mu_switch=1e9)):
                ipm_lanes.solve_batched_lanes(
                    dims, qpb, IPMConfig(k_max=1, use_pallas=True, **kw_l))
        if len(calls) != 4:
            _fail(f"mega {name}: captured calls {sorted(calls)}")
        for (kname, ph), (a, k) in sorted(calls.items()):
            out_k = _flat(getattr(mk, kname)(*a, **k))
            torch.cuda.synchronize()
            ref = getattr(mk, kname + "_ref")
            out_p = _flat(ref(*a, **k))
            if not all(bool(torch.isfinite(x).all()) for x in out_k):
                _fail(f"{kname} {name} phase {1 + ph}: non-finite output")
            dabs = max(_maxdiff(torch, x, y) for x, y in zip(out_k, out_p))
            rel = max(_maxdiff(torch, x, y)
                      / max(1.0, float(y.abs().max()))
                      for x, y in zip(out_k, out_p))
            print(f"{kname} {name} phase {1 + ph}: max|d| {dabs:.3e}, max "
                  f"|d|/scale {rel:.3e} (tol {MEGA_TOL[name]:.0e})",
                  flush=True)
            if rel > MEGA_TOL[name]:
                _fail(f"{kname} {name} phase {1 + ph} disagrees with its "
                      "plain version")
            if dtype == torch.float32:
                max_abs_err[kname] = max(max_abs_err.get(kname, 0.0), dabs)
        del calls

    # ---- 3. main path 1: solve_batched, resident route, float32 ----------
    dims, qpb = flagship(torch.float32)
    N = dims.N
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
    _check_solution(torch, sol, dims, cfg.k_max, "resident path")
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
    _oracle(torch, np, qpb, sol, dev, 1e-2, 1e-5, 1e-3, "resident path")

    # ---- 4. main path 2: default tolerances -> lanes engine, float32 -----
    engine_l = pbatch.select_engine(dims, cfg_lanes, B, torch.float32)
    if engine_l != "lanes":
        _fail(f"select_engine chose {engine_l!r}, expected 'lanes'")
    for v in mk.LAUNCHES.values():
        v[:] = [0, 0]
    stk.RESID_LAUNCHES = 0
    with _capture_mega(mk) as lanes_calls:
        sol_l = pbatch.solve_batched(dims, qpb, cfg_lanes)
    torch.cuda.synchronize()
    launches_l = {n: list(v) for n, v in mk.LAUNCHES.items()}
    launches_l["resid_full"] = stk.RESID_LAUNCHES
    if (min(launches_l["factor_solve_mega"][0],
            launches_l["solve_mega"][0], launches_l["resid_full"]) < 1):
        _fail(f"lanes path skipped a kernel: launches {launches_l}")
    _check_solution(torch, sol_l, dims, cfg_lanes.k_max, "lanes path f32")
    kk_l = sol_l.kk.double()
    status_l = torch.bincount(sol_l.status, minlength=3).tolist()
    # an instance leaves phase 1 for phase 2 once an accepted step's mu is
    # at most mu_switch (stat rows of steps not taken are 0)
    mu_rows = sol_l.stat[:, :, 4]
    crossed = int(((mu_rows > 0) & (mu_rows <= cfg_lanes.mu_switch))
                  .any(1).sum())
    print(f"lanes path f32: engine {engine_l}, launches [phase 1, phase 2] "
          f"{launches_l}, mean kk {float(kk_l.mean()):.3f}, status counts "
          f"(converged, max-iter, frozen) {status_l}, max mu "
          f"{float(sol_l.inf_norm_res[:, 3].max()):.3e}, instances that "
          f"crossed mu_switch {crossed}", flush=True)
    if float(kk_l.mean()) <= 3.0:
        _fail(f"lanes path: suspicious mean iteration count "
              f"{float(kk_l.mean())}")
    _oracle(torch, np, qpb, sol_l, dev, 1e-2, 1e-5, 1e-3, "lanes path f32")

    # ---- 5. main path 3: the lanes engine in float64, both phases --------
    dims64, qpb64 = flagship(torch.float64)
    for v in mk.LAUNCHES.values():
        v[:] = [0, 0]
    stk.RESID_LAUNCHES = 0
    sol64 = ipm_lanes.solve_batched_lanes(dims64, qpb64, cfg_lanes)
    torch.cuda.synchronize()
    launches_64 = {n: list(v) for n, v in mk.LAUNCHES.items()}
    launches_64["resid_full"] = stk.RESID_LAUNCHES
    if min(launches_64["factor_solve_mega"][1],
           launches_64["solve_mega"][1]) < 1:
        _fail(f"f64 lanes run skipped phase 2: launches {launches_64}")
    _check_solution(torch, sol64, dims64, cfg_lanes.k_max, "lanes path f64")
    conv = (sol64.status == 0) & (sol64.inf_norm_res[:, 3] <= 1e-8)
    status_64 = torch.bincount(sol64.status, minlength=3).tolist()
    print(f"lanes path f64: launches [phase 1, phase 2] {launches_64}, mean "
          f"kk {float(sol64.kk.double().mean()):.3f}, status counts "
          f"{status_64}, converged with mu <= 1e-8: "
          f"{float(conv.double().mean()):.4f}", flush=True)
    if float(conv.double().mean()) < 0.99:
        _fail("f64 lanes run: fewer than 99% of instances converged")
    _oracle(torch, np, qpb64, sol64, dev, 1e-6, 1e-9, 1e-6, "lanes path f64")

    # ---- 6. timings ---------------------------------------------------------
    def solve_rep(q0, d, c, fn):
        def run(r):
            q = dataclasses.replace(q0, b=q0.b * (1.0 + 1e-4 * r))
            return fn(d, q, c)
        return run

    @contextlib.contextmanager
    def plain_kernels():
        saved = (rk.ipm_resident, stk.resid_full, mk.factor_solve_mega,
                 mk.solve_mega)
        rk.ipm_resident, stk.resid_full = (rk.ipm_resident_ref,
                                           stk.resid_full_ref)
        mk.factor_solve_mega = mk.factor_solve_mega_ref
        mk.solve_mega = mk.solve_mega_ref
        try:
            yield
        finally:
            (rk.ipm_resident, stk.resid_full, mk.factor_solve_mega,
             mk.solve_mega) = saved

    e2e = {}
    for label, q0, d, c, fn, reps, preps in (
            ("resident f32", qpb, dims, cfg, pbatch.solve_batched, 10, 2),
            ("lanes f32", qpb, dims, cfg_lanes, pbatch.solve_batched, 5, 1),
            ("lanes f64", qpb64, dims64, cfg_lanes,
             ipm_lanes.solve_batched_lanes, 3, 1)):
        ms = _time_ms(torch, solve_rep(q0, d, c, fn), reps=reps)
        with plain_kernels():
            ms_plain = _time_ms(torch, solve_rep(q0, d, c, fn), reps=preps,
                                warmup=0)
        e2e[label] = (ms, ms_plain)
        print(f"main path {label} [{card}]: {ms:.3f} ms per {B}-batch "
              f"({B / ms * 1e3:.1f} solves/s); plain version "
              f"{ms_plain:.3f} ms", flush=True)
    ms_e2e, ms_e2e_plain = e2e["resident f32"]
    print(f"main path [{card}]: {ms_e2e:.3f} ms per {B}-batch "
          f"({B / ms_e2e * 1e3:.1f} solves/s, mean kk "
          f"{float(kk.mean()):.3f}); plain version {ms_e2e_plain:.3f} ms",
          flush=True)

    # where the time of one lanes call goes (torch.profiler, 3 calls each)
    for label, q0, d, c, fn in (
            ("lanes f32", qpb, dims, cfg_lanes, pbatch.solve_batched),
            ("lanes f64", qpb64, dims64, cfg_lanes,
             ipm_lanes.solve_batched_lanes)):
        pr = _profile(torch, solve_rep(q0, d, c, fn))
        print(f"profile {label} [{card}]: wall {pr['wall']:.3f} ms per call, "
              f"device busy {pr['busy']:.3f} ms (idle share "
              f"{1 - pr['busy'] / pr['wall']:.1%}): mega kernels "
              f"{pr['mega']:.3f} ms in {pr['n_mega']:.0f} launches, "
              f"resid_full {pr['resid']:.3f} ms in {pr['n_resid']:.0f}, "
              f"other kernels {pr['other']:.3f} ms in {pr['n_other']:.0f}; "
              f"{pr['syncs']:.0f} host-device syncs per call", flush=True)

    # each kernel alone, at the main paths' shapes and configs (float32):
    # the resident pair on the resident path's inputs, the mega pair on the
    # lanes path's first phase-1 calls
    ops = _stage_ops(dims.NU, dims.NX, dims.NB, dims.NG)
    args, kw, cm, _ = ipm_resident.resident_inputs(dims, qpb, cfg)
    res_out = rk.ipm_resident(*args, **kw)
    r_args, r_kw = ipm_resident.exit_resid_inputs(dims, qpb, cm,
                                                  *res_out[:4])
    sum_kk = float(res_out[5].double().sum())
    n_ng = len(kw.get("ng_stage_ids", ()))
    it_ops = ((N + 1) * (ops["update"] + ops["factor"] + ops["solve"])
              + 2 * ops["root"] + n_ng * ops["ng_resident"])
    fa, fk = lanes_calls[("factor_solve_mega", False)]
    sa, sk = lanes_calls[("solve_mega", False)]
    kernels = []
    for name, src, repl, plain, fast, a, k, reps, n_ops in (
            ("ipm_resident", "hpmpc_tpu_torch/csrc/ipm_resident.cu",
             "hpmpc_tpu/ops/resident_kernel.py:1014", rk.ipm_resident_ref,
             rk.ipm_resident, args, kw, 10, sum_kk * it_ops
             + B * (N + 1) * ops["update"]),
            ("resid_full", "hpmpc_tpu_torch/csrc/resid_full.cu",
             "hpmpc_tpu/ops/step_kernel.py:509", stk.resid_full_ref,
             stk.resid_full, r_args, r_kw, 50, B * (N + 1) * ops["resid"]),
            ("factor_solve_mega", "hpmpc_tpu_torch/csrc/factor_solve_mega.cu",
             "hpmpc_tpu/ops/mega_kernel.py:325", mk.factor_solve_mega_ref,
             mk.factor_solve_mega, fa, fk, 20,
             B * ((N + 1) * ops["factor"] + ops["root"]
                  + n_ng * ops["ng_factor"])),
            ("solve_mega", "hpmpc_tpu_torch/csrc/solve_mega.cu",
             "hpmpc_tpu/ops/mega_kernel.py:601", mk.solve_mega_ref,
             mk.solve_mega, sa, sk, 20,
             B * ((N + 1) * ops["solve"] + ops["root"]
                  + n_ng * ops["ng_solve"]))):
        out = fast(*a, **k)
        kw_in = [v for v in k.values() if hasattr(v, "is_floating_point")]
        nbytes = _nbytes(a, kw_in, out)
        bound_ms, bound_by = _bound(nbytes, n_ops)
        ms = _time_ms(torch, lambda r: fast(*a, **k), reps=reps)
        ms_plain = _time_ms(torch, lambda r: plain(*a, **k), reps=2)
        print(f"{name} [{card}]: kernel {ms:.4f} ms, plain {ms_plain:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, "
              f"{n_ops:.4e} ops; {bound_ms / ms:.2%} of bound) (float32, "
              f"B={B}, N={N_HORIZON})", flush=True)
        if name in launches:
            n_launch = launches[name] + (launches_l["resid_full"]
                                         if name == "resid_full" else 0)
        else:
            n_launch = sum(launches_l[name])
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": n_launch,
                        "max_abs_err": max_abs_err[name],
                        "ms": ms, "plain_ms": ms_plain,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
