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
solve_batched`` (the f64 lanes runs call the engine directly):

  * the resident route, float32, bench.py's headline config
    (``mu_switch=0``): ``ipm_resident`` + ``resid_full``;
  * the library's default tolerances (``mu_tol=1e-8``, ``mu_switch=1e-5``),
    float32, which go to the lanes engine: ``factor_solve_mega`` +
    ``solve_mega`` + ``resid_full``.  float32 freezes at its barrier floor
    above ``mu_switch``, so this path runs the kernels' phase-1 forms;
  * the lanes engine in float64 at the same width, which crosses
    ``mu_switch`` and runs the phase-2 forms to mu <= 1e-8;
  * ``bench.py``'s parity line, float32 (``k_max=8, mu_tol=0,
    iter_ref=1, iter_ref_mu_thr=1e-3``): the two-stage route, the resident
    engine to mu <= 1e-3, then the lanes engine's 6-kernel loop with
    iterative refinement (``prep_flat``, ``factor_solve_folded_flat``,
    ``refine_flat_fused``, ``alpha_sums_flat``; ``corr_geff_flat``,
    ``solve_flat``, ``refine_flat_fused``, ``alpha_sums_flat``) +
    ``resid_full``.  Its control error against the f64 lanes engine at the
    same budget must be below that of the unrefined f32 route;
  * the lanes engine in float64 with the same refinement and the default
    tolerances, which runs the phase-2 forms of the six kernels.

Each path runs with the launch counters set to 0 just before and read just
after, and its answer is held against the float64 host residual oracle.
Then everything is timed and profiled, the default-tolerance lanes route
also on its 6-kernel loop (``HPMPC_MEGA_SWEEPS=0``) beside the mega
route, and each kernel alone.  Every failed check raises, so the exit code is
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
import os
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
# the field's scale; the same for the six kernels of the 6-kernel loop,
# each checked on one call per phase at the initial iterate too
MEGA_TOL = {"float32": 5e-5, "float64": 1e-11}
# the wrappers of the 6-kernel lanes loop: step passes, then sweeps
STEP_NAMES = ("prep_flat", "alpha_sums_flat", "corr_geff_flat")
STAGE_NAMES = ("factor_solve_folded_flat", "solve_flat", "refine_flat_fused")
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
    trs = 2 * NZ * NX + NX + NU * NU + 2 * NX * NU + NU
    fwd_z = NU + 2 * NU * NX + NU * NU + 2 * NX * NZ   # u, x_next
    pi = 2 * NX * NX + NX
    return dict(
        factor=fold + factor + fwd, solve=corr + fwd + 2 * NX * NX,
        root=2 * NX * NX + NX, update=3 * NZ + 4 * NB2 + 3 * NX,
        ng_factor=NT + NZ, ng_solve=NZ,
        # resident: barrier term C' diag(Q) C, C' q twice, C z twice, and
        # the box-like step math of the ng rows in the four sweeps
        ng_resident=3 * NT * NG + 4 * NZ * NG + 4 * NZ * NG + 60 * NG2,
        resid=2 * NZ * NZ + 2 * NZ * NX + NX + NB + 2 * NX * NZ + 3 * NX
        + 6 * NB2,
        # the 6-kernel loop, per stage: the box passes, the factorization
        # + forward (with pi), the re-solve, the refinement pass (Newton
        # residuals, Pb, substitution, forward, update); ng_refine per ng
        # stage
        prep=fold - NZ, alpha=22 * NB2, corr=6 * NB2 + fold - NZ,
        factor_flat=factor + NZ + fwd_z + pi,
        solve_flat=trs + fwd_z + pi,
        refine=(2 * NZ * NZ + 2 * NZ + 4 * NZ * NX + 2 * NX + 2 * NX * NX
                + trs + fwd_z + pi + NZ + NX),
        ng_refine=4 * NG * NZ)


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


#: the port's kernels as the profiler names them (``<name>_kernel``)
PROFILED = ("ipm_resident", "resid_full", "factor_solve_mega", "solve_mega",
            "prep_flat", "alpha_sums_flat", "corr_geff_flat",
            "factor_solve_flat", "solve_flat", "refine_flat")


def _profile(torch, run, reps: int = 3) -> dict:
    """Where one call's time goes: ``torch.profiler`` over ``reps`` calls
    of ``run`` after a warm-up.  Per call: host wall ms, device busy ms
    (the kernels' summed time), ms and launches of each of the port's
    kernels and of all other kernels together ("other"), and host-device
    syncs."""
    import re

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
    out = dict(wall=wall, busy=0.0, syncs=0.0, ms={}, n={})
    for e in prof.key_averages():
        if "Synchronize" in e.key:
            out["syncs"] += e.count / reps
        if not str(e.device_type).endswith("CUDA"):
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / reps
        part = next((k for k in PROFILED
                     if re.search(rf"\b{k}_kernel\b", e.key)), "other")
        out["ms"][part] = out["ms"].get(part, 0.0) + ms
        out["n"][part] = out["n"].get(part, 0.0) + e.count / reps
        out["busy"] += ms
    return out


def _profile_line(label, card, pr) -> str:
    parts = ", ".join(f"{k} {pr['ms'][k]:.3f} ms in {pr['n'][k]:.0f}"
                      for k in (*PROFILED, "other") if k in pr["ms"])
    return (f"profile {label} [{card}]: wall {pr['wall']:.3f} ms per call, "
            f"device busy {pr['busy']:.3f} ms (idle share "
            f"{1 - pr['busy'] / pr['wall']:.1%}): {parts} launches; "
            f"{pr['syncs']:.0f} host-device syncs per call")


@contextlib.contextmanager
def _capture(targets):
    """Record the arguments of the first call of each wrapper ``(module,
    name)`` of ``targets`` while the block runs: {(name, variant): (args,
    kwargs)}; variant is True for the alpha pass with the phase-1
    centering stream dl0 (the corrector's), False otherwise."""
    calls, saved = {}, [(m, n, getattr(m, n)) for m, n in targets]

    def spy(name, fn):
        def call(*a, **k):
            key = (name, name == "alpha_sums_flat" and a[6] is not None)
            calls.setdefault(key, (a, k))
            return fn(*a, **k)
        return call

    for m, n, fn in saved:
        setattr(m, n, spy(n, fn))
    try:
        yield calls
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def _check_calls(torch, calls, mods, tol, what, errs):
    """Each captured call: kernel vs plain version (``<name>_ref``) on the
    same inputs; the largest difference must be within ``tol`` of each
    output's scale.  Records the max abs difference per kernel in
    ``errs``."""
    for (kname, var), (a, k) in sorted(calls.items()):
        mod = mods[kname]
        out_k = _flat(getattr(mod, kname)(*a, **k))
        torch.cuda.synchronize()
        out_p = _flat(getattr(mod, kname + "_ref")(*a, **k))
        if len(out_k) != len(out_p):
            _fail(f"{kname} {what}: {len(out_k)} outputs, plain version "
                  f"{len(out_p)}")
        if not all(bool(torch.isfinite(x).all()) for x in out_k):
            _fail(f"{kname} {what}: non-finite output")
        dabs = max(_maxdiff(torch, x, y) for x, y in zip(out_k, out_p))
        rel = max(_maxdiff(torch, x, y) / max(1.0, float(y.abs().max()))
                  for x, y in zip(out_k, out_p))
        tag = " (with dl0)" if var else ""
        print(f"{kname}{tag} {what}: max|d| {dabs:.3e}, max |d|/scale "
              f"{rel:.3e} (tol {tol:.0e})", flush=True)
        if rel > tol:
            _fail(f"{kname}{tag} {what} disagrees with its plain version")
        errs[kname] = max(errs.get(kname, 0.0), dabs)


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
    from hpmpc_tpu_torch.ops import stage_kernel as sk
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
    # bench.py's parity line; the same with the default tolerances (f64)
    cfg_par = IPMConfig(k_max=8, mu_tol=0.0, alpha_min=1e-8, iter_ref=1,
                        iter_ref_mu_thr=1e-3, use_pallas=True)
    cfg_ref64 = IPMConfig(k_max=30, iter_ref=1, iter_ref_mu_thr=1e-3,
                          use_pallas=True)
    mods = {**{n: stk for n in STEP_NAMES}, **{n: sk for n in STAGE_NAMES},
            "factor_solve_mega": mk, "solve_mega": mk}
    six = [(mods[n], n) for n in STEP_NAMES + STAGE_NAMES]

    def reset_counts():
        rk.LAUNCHES = 0
        stk.RESID_LAUNCHES = 0
        for d in (stk.LAUNCHES, mk.LAUNCHES):
            for v in d.values():
                v[:] = [0, 0]
        for n in sk.LAUNCHES:
            sk.LAUNCHES[n] = 0

    def read_counts():
        """Launches of every kernel since reset_counts(): [phase 1, phase
        2] for the phase-templated ones, an int for the others."""
        out = {"ipm_resident": rk.LAUNCHES, "resid_full": stk.RESID_LAUNCHES}
        out.update({n: list(v) for n, v in mk.LAUNCHES.items()})
        out.update({n: list(v) for n, v in stk.LAUNCHES.items()})
        out.update(sk.LAUNCHES)
        return out

    def total(v):
        return sum(v) if isinstance(v, list) else v
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
    d2 = dict(NU=dims.NU, NX=dims.NX)
    specs = [("resid_full", d3), ("ipm_resident", dict(d3, NG=dims.NG)),
             ("factor_solve_mega", d3), ("solve_mega", d3),
             ("step_flat", dict(NZ=dims.NZ, NB=dims.NB)),
             ("factor_solve_flat", d2), ("solve_flat", d2),
             ("refine_flat", dict(d2, NG=dims.NG))]
    t0 = time.perf_counter()
    _build.build_all(specs)
    print(f"build: {time.perf_counter() - t0:.1f} s ({len(specs)} "
          "libraries in parallel)", flush=True)
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
        # initial iterate (phase 2 alone: mu_switch=1e9, A = rd, M = rm);
        # then each kernel of the 6-kernel loop the same way, with
        # ungated refinement so that the refinement pass runs too
        errs = {}
        for ph, kw_l in ((1, dict()), (2, dict(mu_switch=1e9))):
            what = f"{name} phase {ph}"
            with _capture([(mk, "factor_solve_mega"),
                           (mk, "solve_mega")]) as calls:
                ipm_lanes.solve_batched_lanes(
                    dims, qpb, IPMConfig(k_max=1, use_pallas=True, **kw_l))
            if len(calls) != 2:
                _fail(f"mega {what}: captured calls {sorted(calls)}")
            _check_calls(torch, calls, mods, MEGA_TOL[name], what, errs)
            with _capture(six) as calls:
                ipm_lanes.solve_batched_lanes(
                    dims, qpb, IPMConfig(k_max=1, iter_ref=1,
                                         use_pallas=True, **kw_l))
            if len(calls) != (7 if ph == 1 else 6):
                _fail(f"6-kernel loop {what}: captured calls "
                      f"{sorted(calls)}")
            _check_calls(torch, calls, mods, MEGA_TOL[name], what, errs)
        del calls
        if dtype == torch.float32:
            max_abs_err.update(errs)

    # ---- 3. main path 1: solve_batched, resident route, float32 ----------
    dims, qpb = flagship(torch.float32)
    N = dims.N
    engine = pbatch.select_engine(dims, cfg, B, torch.float32)
    if engine != "resident":
        _fail(f"select_engine chose {engine!r}, expected 'resident'")
    reset_counts()
    sol = pbatch.solve_batched(dims, qpb, cfg)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = {n: counts[n] for n in ("ipm_resident", "resid_full")}
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
    reset_counts()
    with _capture([(mk, "factor_solve_mega"), (mk, "solve_mega")]) as \
            lanes_calls:
        sol_l = pbatch.solve_batched(dims, qpb, cfg_lanes)
    torch.cuda.synchronize()
    counts = read_counts()
    launches_l = {n: counts[n] for n in ("factor_solve_mega", "solve_mega",
                                         "resid_full")}
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
    reset_counts()
    sol64 = ipm_lanes.solve_batched_lanes(dims64, qpb64, cfg_lanes)
    torch.cuda.synchronize()
    counts = read_counts()
    launches_64 = {n: counts[n] for n in ("factor_solve_mega", "solve_mega",
                                          "resid_full")}
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

    # ---- 6. main path 4: bench.py's parity line, float32 -----------------
    engine_p = pbatch.select_engine(dims, cfg_par, B, torch.float32)
    if engine_p != "two_stage_resident":
        _fail(f"select_engine chose {engine_p!r}, expected "
              "'two_stage_resident'")
    reset_counts()
    with _capture(six) as par_calls:
        sol_p = pbatch.solve_batched(dims, qpb, cfg_par)
    torch.cuda.synchronize()
    launches_p = read_counts()
    need = ("ipm_resident", "resid_full") + STEP_NAMES + STAGE_NAMES
    if (launches_p["ipm_resident"] != 1
            or min(total(launches_p[n]) for n in need) < 1):
        _fail(f"parity path skipped a kernel: launches {launches_p}")
    _check_solution(torch, sol_p, dims, cfg_par.k_max, "parity path")
    if int(sol_p.kk.max()) > cfg_par.k_max:
        _fail(f"parity path: kk {int(sol_p.kk.max())} > k_max")
    _oracle(torch, np, qpb, sol_p, dev, 1e-2, 1e-5, 1e-3, "parity path")
    # control error against the f64 lanes engine at the same budget
    # (tests/test_resident.py's comparison), and for the unrefined f32
    # route (iter_ref=0: the lanes engine); also at matched iterations,
    # each instance against the f64 iterate after as many accepted steps
    cfg_raw = dataclasses.replace(cfg_par, iter_ref=0)
    if pbatch.select_engine(dims, cfg_raw, B, torch.float32) != "lanes":
        _fail("the unrefined parity config does not go to the lanes engine")
    sol_raw = pbatch.solve_batched(dims, qpb, cfg_raw)
    ref64 = {k: ipm_lanes.solve_batched_lanes(
        dims64, qpb64, IPMConfig(k_max=k, mu_tol=0.0, use_pallas=True)).z
        for k in range(1, cfg_par.k_max + 1)}
    NU = dims.NU

    def ctrl_err(s_, zref):
        e = (s_.z[..., :NU].double() - zref[..., :NU]).abs().amax((1, 2))
        return float(e.max()), float(e.median())

    def matched(s_):
        idx = s_.kk.long().clamp(min=1)
        zs = torch.stack([ref64[k] for k in sorted(ref64)])
        return zs[idx - 1, torch.arange(B, device=dev)]

    err_p, med_p = ctrl_err(sol_p, ref64[cfg_par.k_max])
    err_r, med_r = ctrl_err(sol_raw, ref64[cfg_par.k_max])
    merr_p, mmed_p = ctrl_err(sol_p, matched(sol_p))
    merr_r, mmed_r = ctrl_err(sol_raw, matched(sol_raw))
    mu_rows = sol_p.stat[:, :, 4]
    crossed_p = int(((mu_rows > 0) & (mu_rows <= cfg_par.mu_switch))
                    .any(1).sum())
    kk_hist = torch.bincount(sol_p.kk.long(),
                             minlength=cfg_par.k_max + 1).tolist()
    status_p = torch.bincount(sol_p.status, minlength=3).tolist()
    print(f"parity path: engine {engine_p}, launches {launches_p}, kk "
          f"histogram {kk_hist}, status counts (converged, max-iter, "
          f"frozen) {status_p}, max mu "
          f"{float(sol_p.inf_norm_res[:, 3].max()):.3e}, instances that "
          f"crossed mu_switch {crossed_p}", flush=True)
    print(f"parity path: control error vs f64 lanes (k_max="
          f"{cfg_par.k_max}): refined max {err_p:.3e} (median {med_p:.3e}), "
          f"unrefined max {err_r:.3e} (median {med_r:.3e}); at matched "
          f"iterations: refined max {merr_p:.3e} (median {mmed_p:.3e}), "
          f"unrefined max {merr_r:.3e} (median {mmed_r:.3e}); unrefined kk "
          f"histogram {torch.bincount(sol_raw.kk.long()).tolist()}; the "
          f"<= 1e-6 parity claim {'holds' if err_p <= 1e-6 else 'fails'} "
          "here", flush=True)
    if not err_p < err_r:
        _fail(f"parity path: refined control error {err_p:.3e} is not "
              f"below the unrefined {err_r:.3e}")

    # ---- 7. main path 5: lanes engine, float64, refinement, both phases --
    reset_counts()
    sol_r64 = ipm_lanes.solve_batched_lanes(dims64, qpb64, cfg_ref64)
    torch.cuda.synchronize()
    launches_r64 = read_counts()
    if (min(launches_r64[n][1] for n in STEP_NAMES) < 1
            or min(launches_r64[n] for n in STAGE_NAMES) < 1):
        _fail(f"f64 refined lanes run skipped a kernel or phase 2: "
              f"launches {launches_r64}")
    _check_solution(torch, sol_r64, dims64, cfg_ref64.k_max,
                    "refined lanes path f64")
    conv = (sol_r64.status == 0) & (sol_r64.inf_norm_res[:, 3] <= 1e-8)
    print(f"refined lanes path f64: launches {launches_r64}, mean kk "
          f"{float(sol_r64.kk.double().mean()):.3f}, status counts "
          f"{torch.bincount(sol_r64.status, minlength=3).tolist()}, "
          f"converged with mu <= 1e-8: {float(conv.double().mean()):.4f}",
          flush=True)
    if float(conv.double().mean()) < 0.99:
        _fail("f64 refined lanes run: fewer than 99% of instances converged")
    _oracle(torch, np, qpb64, sol_r64, dev, 1e-6, 1e-9, 1e-6,
            "refined lanes path f64")

    # ---- 8. timings ---------------------------------------------------------
    def solve_rep(q0, d, c, fn):
        def run(r):
            q = dataclasses.replace(q0, b=q0.b * (1.0 + 1e-4 * r))
            return fn(d, q, c)
        return run

    def six_kernel_loop(fn):
        """``fn`` with the lanes engine on its 6-kernel loop
        (``HPMPC_MEGA_SWEEPS=0``) for the duration of each call."""
        def call(d, q, c):
            old = os.environ.get("HPMPC_MEGA_SWEEPS")
            os.environ["HPMPC_MEGA_SWEEPS"] = "0"
            try:
                return fn(d, q, c)
            finally:
                if old is None:
                    del os.environ["HPMPC_MEGA_SWEEPS"]
                else:
                    os.environ["HPMPC_MEGA_SWEEPS"] = old
        return call

    @contextlib.contextmanager
    def plain_kernels():
        """Every kernel wrapper of the port replaced by its plain version."""
        swaps = [(rk, "ipm_resident"), (stk, "resid_full"),
                 (mk, "factor_solve_mega"), (mk, "solve_mega"), *six]
        saved = [(m, n, getattr(m, n)) for m, n in swaps]
        for m, n, _ in saved:
            setattr(m, n, getattr(m, n + "_ref"))
        try:
            yield
        finally:
            for m, n, fn in saved:
                setattr(m, n, fn)

    e2e = {}
    for label, q0, d, c, fn, reps, preps in (
            ("resident f32", qpb, dims, cfg, pbatch.solve_batched, 10, 2),
            ("lanes f32", qpb, dims, cfg_lanes, pbatch.solve_batched, 5, 1),
            ("lanes f32, 6-kernel loop", qpb, dims, cfg_lanes,
             six_kernel_loop(pbatch.solve_batched), 5, 1),
            ("lanes f64", qpb64, dims64, cfg_lanes,
             ipm_lanes.solve_batched_lanes, 3, 1),
            ("parity f32", qpb, dims, cfg_par, pbatch.solve_batched, 5, 1)):
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

    # where the time of one call goes (torch.profiler, 3 calls each)
    for label, q0, d, c, fn in (
            ("lanes f32", qpb, dims, cfg_lanes, pbatch.solve_batched),
            ("lanes f32, 6-kernel loop", qpb, dims, cfg_lanes,
             six_kernel_loop(pbatch.solve_batched)),
            ("lanes f64", qpb64, dims64, cfg_lanes,
             ipm_lanes.solve_batched_lanes),
            ("parity f32", qpb, dims, cfg_par, pbatch.solve_batched)):
        pr = _profile(torch, solve_rep(q0, d, c, fn))
        print(_profile_line(label, card, pr), flush=True)

    # each kernel alone, at the main paths' shapes and configs (float32):
    # the resident pair on the resident path's inputs, the mega pair on the
    # lanes path's first phase-1 calls, the six on the parity path's first
    # calls (stage 2, phase 1)
    ops = _stage_ops(dims.NU, dims.NX, dims.NB, dims.NG)
    args, kw, cm, _ = ipm_resident.resident_inputs(dims, qpb, cfg)
    res_out = rk.ipm_resident(*args, **kw)
    r_args, r_kw = ipm_resident.exit_resid_inputs(dims, qpb, cm,
                                                  *res_out[:4])
    sum_kk = float(res_out[5].double().sum())
    n_ng = len(kw.get("ng_stage_ids", ()))
    it_ops = ((N + 1) * (ops["update"] + ops["factor"] + ops["solve"])
              + 2 * ops["root"] + n_ng * ops["ng_resident"])
    BS = B * (N + 1)
    rows = [
        ("ipm_resident", "hpmpc_tpu/ops/resident_kernel.py:1014", rk,
         (args, kw), 10, sum_kk * it_ops + BS * ops["update"],
         launches["ipm_resident"]),
        ("resid_full", "hpmpc_tpu/ops/step_kernel.py:509", stk,
         (r_args, r_kw), 50, BS * ops["resid"],
         launches["resid_full"] + launches_l["resid_full"]),
        ("factor_solve_mega", "hpmpc_tpu/ops/mega_kernel.py:325", mk,
         lanes_calls[("factor_solve_mega", False)], 20,
         B * ((N + 1) * ops["factor"] + ops["root"]
              + n_ng * ops["ng_factor"]),
         sum(launches_l["factor_solve_mega"])),
        ("solve_mega", "hpmpc_tpu/ops/mega_kernel.py:601", mk,
         lanes_calls[("solve_mega", False)], 20,
         B * ((N + 1) * ops["solve"] + ops["root"]
              + n_ng * ops["ng_solve"]),
         sum(launches_l["solve_mega"])),
        ("prep_flat", "hpmpc_tpu/ops/step_kernel.py:222", stk,
         par_calls[("prep_flat", False)], 50, BS * ops["prep"], None),
        ("alpha_sums_flat", "hpmpc_tpu/ops/step_kernel.py:302", stk,
         par_calls[("alpha_sums_flat", False)], 50, BS * ops["alpha"], None),
        ("corr_geff_flat", "hpmpc_tpu/ops/step_kernel.py:379", stk,
         par_calls[("corr_geff_flat", False)], 50, BS * ops["corr"], None),
        ("factor_solve_folded_flat", "hpmpc_tpu/ops/stage_kernel.py:1224",
         sk, par_calls[("factor_solve_folded_flat", False)], 20,
         BS * ops["factor_flat"] + B * (ops["root"]
                                        + n_ng * ops["ng_factor"]), None),
        ("solve_flat", "hpmpc_tpu/ops/stage_kernel.py:1429", sk,
         par_calls[("solve_flat", False)], 20,
         BS * ops["solve_flat"] + B * ops["root"], None),
        ("refine_flat_fused", "hpmpc_tpu/ops/stage_kernel.py:1909", sk,
         par_calls[("refine_flat_fused", False)], 20,
         BS * ops["refine"] + B * (ops["root"] + n_ng * ops["ng_refine"]),
         None)]
    srcs = {"ipm_resident": "ipm_resident", "resid_full": "resid_full",
            "factor_solve_mega": "factor_solve_mega",
            "solve_mega": "solve_mega", "factor_solve_folded_flat":
            "factor_solve_flat", "solve_flat": "solve_flat",
            "refine_flat_fused": "refine_flat",
            **{n: "step_flat" for n in STEP_NAMES}}
    kernels = []
    for name, repl, mod, (a, k), reps, n_ops, n_launch in rows:
        fast, plain = getattr(mod, name), getattr(mod, name + "_ref")
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
        if n_launch is None:
            n_launch = total(launches_p[name])
        kernels.append({"name": name, "route": "cuda",
                        "source": f"hpmpc_tpu_torch/csrc/{srcs[name]}.cu",
                        "replaces": repl, "launches": n_launch,
                        "max_abs_err": max_abs_err[name],
                        "ms": ms, "plain_ms": ms_plain,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None})
    print(f"launches per call: parity path {launches_p}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
