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
    tolerances, which runs the phase-2 forms of the six kernels;
  * the batched soft path at ``tools/bench_soft.py``'s configuration: the
    reference's soft problem (``mass_spring_soft_qp(8, 3, 30, Z=10)``:
    nx=8 nu=3 N=30, input boxes NB=3, every state softly bounded NS=8),
    4096 float32 instances with ``g`` scaled by ``1 + 0.02 N(0,1)``,
    ``IPMConfig(k_max=8, mu0=100, mu_tol=0)``, through
    ``parallel.batch.solve_batched_soft`` -> the soft lanes engine:
    ``factor_solve_soft_mega`` + ``solve_soft_mega``; the same on its
    6-kernel loop (``HPMPC_MEGA_SWEEPS=0``: ``soft_prep_flat``,
    ``factor_solve_folded_flat``, ``soft_alpha_sums_flat``;
    ``soft_corr_flat``, ``solve_flat``, ``soft_alpha_sums_flat``); and the
    soft engine in float64 (``k_max=30``, mu_tol 1e-8).

Each path runs with the launch counters set to 0 just before and read just
after, and its answer is held against a float64 host residual oracle (the
hard one, ``utils/resid64.py``; the soft one, ``ipm_soft.compute_
residuals``).  Then everything is timed and profiled, the default-tolerance
lanes route and the soft route also on their 6-kernel loops beside the
mega routes, and each kernel alone.  Every failed check raises, so the exit
code is non-zero.  Output, one item per line: the card (nvidia-smi name,
power limit), build seconds and ptxas lines, per-check results, timings,
the seconds of each section and of the whole script, a JSON line with the
kernels (time, plain time, bound), and last ``{"ok": true, "device":
{...}}``.

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
# the soft path's kernels: the mega pair, then the soft 6-kernel loop's
# step passes (its sweeps are factor_solve_folded_flat and solve_flat)
SOFT_MEGA = ("factor_solve_soft_mega", "solve_soft_mega")
SOFT_STEP = ("soft_prep_flat", "soft_alpha_sums_flat", "soft_corr_flat")
# the soft problem: tools/bench_soft.py's flagship, and the small problem
# with general rows on stages 2 and N (tests/test_ipm_soft_lanes.py)
SOFT_N, SOFT_NG_N = 30, 5
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


def _stage_ops(NU, NX, NB, NG, NS=0):
    """Floating-point operations per instance and stage of each sweep of
    the kernels (a multiply-add counts 2), counted from the loop bounds of
    the stage helpers in csrc/stage_math.cuh; ``NS`` adds the soft
    kernels' (per soft row: the slack Schur elimination 26, its folds 16,
    the scatters 2, the soft direction 34, the gather 1, the alpha partials
    48, the corrector's centering correction 16 and exact fold 11)."""
    NZ, NB2, NG2 = NU + NX, 2 * NB, 2 * NG
    soft_fold, soft_alpha, soft_corr = 44 * NS, 109 * NS, 71 * NS
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
        ng_refine=4 * NG * NZ,
        # the soft kernels: the hard forms plus the soft rows' work
        soft_factor=fold + factor + fwd + soft_fold + soft_alpha,
        soft_solve=corr + fwd + 2 * NX * NX + soft_corr + soft_alpha
        + 4 * NS,
        soft_prep=fold - NZ + soft_fold, soft_alpha=22 * NB2 + soft_alpha,
        soft_corr=6 * NB2 + fold - NZ + soft_corr)


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
            "factor_solve_flat", "solve_flat", "refine_flat") + SOFT_MEGA \
    + SOFT_STEP


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


def _variant(name, a, k) -> str:
    """The label of a wrapper call's form that a check tells apart: the
    hard alpha pass with the phase-1 centering stream dl0 and the soft
    corrector alpha pass (each the corrector's), "" otherwise."""
    if name == "alpha_sums_flat" and a[6] is not None:
        return "with dl0"
    return "corrector" if k.get("corrector") else ""


@contextlib.contextmanager
def _env(**values):
    """The environment variables ``values`` set while the block runs."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _capture(targets):
    """Record the arguments of the first call of each wrapper ``(module,
    name)`` of ``targets`` while the block runs: {(name, variant): (args,
    kwargs)}, variant as :func:`_variant`."""
    calls, saved = {}, [(m, n, getattr(m, n)) for m, n in targets]

    def spy(name, fn):
        def call(*a, **k):
            calls.setdefault((name, _variant(name, a, k)), (a, k))
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
        tag = f" ({var})" if var else ""
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


def _check_soft_solution(torch, sol, dims, NS, k_max, what):
    """Shapes of a SoftSolution's main fields and finite values."""
    N = dims.N
    shapes = {"z": (B, N + 1, dims.NZ), "pi": (B, N, dims.NX),
              "lam_b": (B, N + 1, 2, dims.NB), "lam_s": (B, N + 1, 4, NS),
              "t_s": (B, N + 1, 4, NS), "kk": (B,), "stat": (B, k_max, 5)}
    for f, shp in shapes.items():
        if tuple(getattr(sol, f).shape) != shp:
            _fail(f"{what}: solution field {f} has shape "
                  f"{tuple(getattr(sol, f).shape)}, expected {shp}")
    for f in sol._fields:
        x = getattr(sol, f)
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            _fail(f"{what}: solution field {f} is not finite")


def _soft_oracle(torch, dims, qpb, soft, sol, primal_max, what):
    """The soft KKT residuals (``ipm_soft.compute_residuals``) in float64
    of a subsample of ``sol``: finite, small primal residuals (dynamics,
    box, soft-bound gaps), and their mu equal to the solver's last stat
    row; returns the largest mu."""
    from hpmpc_tpu_torch.models import ipm_soft

    sub = torch.arange(0, B, B // ORACLE_SUBSAMPLE, device=qpb.b.device)

    def d64(x):
        return x[sub].double() if x.is_floating_point() else x[sub]

    q64 = type(qpb)(**{f.name: d64(getattr(qpb, f.name))
                       for f in dataclasses.fields(qpb)})
    s64 = type(soft)(*[d64(x) for x in soft])
    x64 = type(sol)(*[d64(x) for x in sol])
    res = ipm_soft.compute_residuals(dims, q64, s64, x64)
    rmax = {f: float(getattr(res, f).abs().max()) for f in res._fields}
    if not all(v == v and v != float("inf") for v in rmax.values()):
        _fail(f"{what}: soft oracle residuals not finite: {rmax}")
    kk = x64.kk.long().clamp(min=1) - 1
    mu_eng = x64.stat[torch.arange(len(sub), device=sub.device), kk, 4]
    dmu = float(((res.mu - mu_eng).abs() / res.mu.abs().clamp(min=1e-30))
                .max())
    print(f"{what}: soft f64 oracle ({ORACLE_SUBSAMPLE} instances): "
          + ", ".join(f"max |{f}| {v:.3e}" for f, v in rmax.items())
          + f"; oracle mu vs the solver's last stat row: max rel diff "
          f"{dmu:.3e}", flush=True)
    for f in ("rb", "rd_b", "rd_g", "rd_s"):
        if rmax[f] > primal_max:
            _fail(f"{what}: primal residual {f} {rmax[f]:.3e} > "
                  f"{primal_max:.0e}")
    if dmu > 1e-2:
        _fail(f"{what}: oracle mu disagrees with the solver's ({dmu:.3e})")
    return rmax["mu"]


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

    from hpmpc_tpu_torch.models import ipm_lanes, ipm_resident, ipm_soft_lanes
    from hpmpc_tpu_torch.models.ipm import IPMConfig
    from hpmpc_tpu_torch.ocp import OCPDims
    from hpmpc_tpu_torch.ops import _build
    from hpmpc_tpu_torch.ops import mega_kernel as mk
    from hpmpc_tpu_torch.ops import resident_kernel as rk
    from hpmpc_tpu_torch.ops import stage_kernel as sk
    from hpmpc_tpu_torch.ops import step_kernel as stk
    from hpmpc_tpu_torch.parallel import batch as pbatch
    from hpmpc_tpu_torch.utils.mass_spring import (mass_spring_qp,
                                                   mass_spring_soft_qp)

    if "jax" in sys.modules:
        _fail("jax was imported")
    t_script = time.perf_counter()
    sections = []

    def section_done(label, t_from):
        sections.append((label, time.perf_counter() - t_from))
        print(f"section {label}: {sections[-1][1]:.1f} s", flush=True)
        return time.perf_counter()

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
    # the soft path's config: tools/bench_soft.py's
    cfg_soft = IPMConfig(k_max=8, mu0=100.0, mu_tol=0.0, use_pallas=True)
    cfg_soft64 = IPMConfig(k_max=30, mu0=100.0, use_pallas=True)
    mods = {**{n: stk for n in STEP_NAMES + SOFT_STEP},
            **{n: sk for n in STAGE_NAMES},
            "factor_solve_mega": mk, "solve_mega": mk,
            **{n: mk for n in SOFT_MEGA}}
    six = [(mods[n], n) for n in STEP_NAMES + STAGE_NAMES]
    soft_mega = [(mk, n) for n in SOFT_MEGA]
    soft_six = [(stk, n) for n in SOFT_STEP] + [
        (sk, "factor_solve_folded_flat"), (sk, "solve_flat")]

    def reset_counts():
        rk.LAUNCHES = 0
        stk.RESID_LAUNCHES = 0
        for d in (stk.LAUNCHES, mk.LAUNCHES):
            for v in d.values():
                v[:] = [0, 0]
        for d in (sk.LAUNCHES, mk.SOFT_LAUNCHES, stk.SOFT_LAUNCHES):
            for n in d:
                d[n] = 0

    def read_counts():
        """Launches of every kernel since reset_counts(): [phase 1, phase
        2] for the phase-templated ones, an int for the others."""
        out = {"ipm_resident": rk.LAUNCHES, "resid_full": stk.RESID_LAUNCHES}
        out.update({n: list(v) for n, v in mk.LAUNCHES.items()})
        out.update({n: list(v) for n, v in stk.LAUNCHES.items()})
        out.update(sk.LAUNCHES)
        out.update(mk.SOFT_LAUNCHES)
        out.update(stk.SOFT_LAUNCHES)
        return out

    def total(v):
        return sum(v) if isinstance(v, list) else v
    rng = np.random.default_rng(SEED)
    scales = 1.0 + 0.05 * rng.standard_normal(B)
    soft_scales = 1.0 + 0.02 * rng.standard_normal(B)

    def flagship(dtype):
        dims, qp = mass_spring_qp(8, 3, N_HORIZON, ngN=8, dtype=dtype,
                                  device=dev)
        qpb = pbatch.broadcast_qp(qp, B)
        sc = torch.as_tensor(scales, dtype=dtype, device=dev)
        return dims, dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])

    def soft_problem(dtype, N=SOFT_N, ng=False):
        """(dims, qp, soft, idxbs) of the soft problem at 4096 instances,
        ``g`` scaled per instance; with ``ng`` one general row on stages 2
        and N, 0.25 times the state sum, in [-1, 1]."""
        dims, qp, soft = mass_spring_soft_qp(8, 3, N, Z=10.0, dtype=dtype,
                                             device=dev)
        if ng:
            ngv = [0] * (N + 1)
            ngv[2] = ngv[N] = 1
            dims = OCPDims.create(N, dims.nx, dims.nu, dims.nb, ngv,
                                  idxb=dims.idxb)
            C = torch.zeros(N + 1, 1, dims.NZ, dtype=dtype, device=dev)
            d_lg = torch.zeros(N + 1, 1, dtype=dtype, device=dev)
            for n in (2, N):
                C[n, 0, dims.NU:] = 0.25
                d_lg[n, 0] = -1.0
            qp = dataclasses.replace(
                qp, C=C, d_lg=d_lg, d_ug=-d_lg, ng_mask=torch.as_tensor(
                    dims.ng_mask(), dtype=dtype, device=dev))
        qpb = pbatch.broadcast_qp(qp, B)
        sc = torch.as_tensor(soft_scales, dtype=dtype, device=dev)
        return (dims, dataclasses.replace(qpb, g=qpb.g * sc[:, None, None]),
                pbatch.broadcast_soft(soft, B), soft.idxbs.cpu().numpy())

    # ---- 1. build: one nvcc per library, all at once -----------------------
    t_sec = time.perf_counter()
    dims, _ = mass_spring_qp(8, 3, N_HORIZON, ngN=8, device=dev)
    d3 = dict(NU=dims.NU, NX=dims.NX, NB=dims.NB)
    d2 = dict(NU=dims.NU, NX=dims.NX)
    dims_s, _, soft0 = mass_spring_soft_qp(8, 3, SOFT_N, device=dev)
    NS = soft0.ns_mask.shape[-1]
    ds = dict(NU=dims_s.NU, NX=dims_s.NX, NB=dims_s.NB, NS=NS)
    specs = [("resid_full", d3), ("ipm_resident", dict(d3, NG=dims.NG)),
             ("factor_solve_mega", d3), ("solve_mega", d3),
             ("step_flat", dict(NZ=dims.NZ, NB=dims.NB)),
             ("factor_solve_flat", d2), ("solve_flat", d2),
             ("refine_flat", dict(d2, NG=dims.NG)),
             ("factor_solve_soft_mega", ds), ("solve_soft_mega", ds),
             ("soft_step_flat", dict(NZ=dims_s.NZ, NB=dims_s.NB, NS=NS))]
    t0 = time.perf_counter()
    _build.build_all(specs)
    print(f"build: {time.perf_counter() - t0:.1f} s ({len(specs)} "
          "libraries in parallel)", flush=True)
    for lib, log in sorted(_build.PTXAS_LOG.items()):
        for line in _ptxas_lines(log):
            print(f"ptxas {lib.split('_N')[0]}: {line}", flush=True)
    t_sec = section_done("1 build", t_sec)

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
        # each soft kernel on the soft engine's first calls at the initial
        # iterate, the mega pair and the soft 6-kernel loop's passes, on
        # the flagship soft problem and the small one with general rows,
        # with exact_mehrotra_soft True and False
        for N_s, ng in ((SOFT_N, False), (SOFT_NG_N, True)):
            soft_c = soft_problem(dtype, N_s, ng)
            for exact in (True, False):
                what = (f"{name} soft N={N_s}{' ng' if ng else ''}"
                        f"{'' if exact else ' dropped correction'}")
                for mega, targets, n_calls in (("1", soft_mega, 2),
                                               ("0", soft_six, 6)):
                    with _env(HPMPC_MEGA_SWEEPS=mega), \
                            _capture(targets) as calls:
                        ipm_soft_lanes.solve_batched_soft_lanes(
                            *soft_c[:3], IPMConfig(k_max=1, mu0=100.0,
                                                   use_pallas=True),
                            soft_c[3], exact_mehrotra_soft=exact)
                    if len(calls) != n_calls:
                        _fail(f"soft {what}: captured calls {sorted(calls)}")
                    _check_calls(torch, calls, mods, MEGA_TOL[name], what,
                                 errs)
        del calls, soft_c
        if dtype == torch.float32:
            max_abs_err.update(errs)
    t_sec = section_done("2 kernels vs plain", t_sec)

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
    t_sec = section_done("3-7 hard main paths", t_sec)

    # ---- 8. main path 6: solve_batched_soft, the soft lanes engine, f32 ---
    dims_s, qpb_s, sb_s, idxbs_s = soft_problem(torch.float32)
    engine_s = pbatch.select_soft_engine(dims_s, cfg_soft, torch.float32, NS,
                                         idxbs_s)
    if engine_s != "soft_lanes":
        _fail(f"select_soft_engine chose {engine_s!r}, expected "
              "'soft_lanes'")

    def soft_path(label, mega, targets, need):
        """One solve_batched_soft of the flagship soft batch on route
        ``mega`` with the counters reset just before and read just after:
        (solution, launches, the first call of each wrapper of
        ``targets``)."""
        reset_counts()
        with _env(HPMPC_MEGA_SWEEPS=mega), _capture(targets) as calls:
            sol_ = pbatch.solve_batched_soft(dims_s, qpb_s, sb_s, cfg_soft,
                                             idxbs=idxbs_s)
        torch.cuda.synchronize()
        counts_ = read_counts()
        launches_ = {n: counts_[n] for n in need}
        if min(launches_.values()) < 1:
            _fail(f"{label} skipped a kernel: launches {launches_}")
        _check_soft_solution(torch, sol_, dims_s, NS, cfg_soft.k_max, label)
        kk_ = sol_.kk.double()
        print(f"{label}: engine {engine_s}, launches {launches_}, mean kk "
              f"{float(kk_.mean()):.3f}, kk histogram "
              f"{torch.bincount(sol_.kk.long()).tolist()}, status counts "
              f"(converged, max-iter, frozen) "
              f"{torch.bincount(sol_.status, minlength=3).tolist()}",
              flush=True)
        if float(kk_.mean()) <= 3.0:
            _fail(f"{label}: suspicious mean iteration count "
                  f"{float(kk_.mean())}")
        _soft_oracle(torch, dims_s, qpb_s, sb_s, sol_, 1e-3, label)
        return sol_, launches_, calls

    sol_s, launches_s, soft_calls = soft_path(
        "soft path f32", "1", soft_mega, SOFT_MEGA)
    # ---- 9. main path 7: the same on the soft 6-kernel loop ---------------
    sol_s6, launches_s6, soft6_calls = soft_path(
        "soft path f32, 6-kernel loop", "0", soft_six,
        SOFT_STEP + ("factor_solve_folded_flat", "solve_flat"))
    same = sol_s.kk == sol_s6.kk
    if int(same.sum()) < 0.99 * B:
        _fail("soft path: the mega route and the 6-kernel loop disagree on "
              f"kk ({int(same.sum())} of {B} equal)")
    dz6 = float((sol_s.z - sol_s6.z)[same].abs().max())
    print(f"soft path f32: mega vs 6-kernel loop: kk equal on "
          f"{int(same.sum())} of {B}, max |dz| {dz6:.3e} there", flush=True)

    # ---- 10. main path 8: the soft engine in float64, to mu <= 1e-8 ------
    dims_s64, qpb_s64, sb_s64, _ = soft_problem(torch.float64)
    reset_counts()
    sol_s64 = ipm_soft_lanes.solve_batched_soft_lanes(
        dims_s64, qpb_s64, sb_s64, cfg_soft64, idxbs_s)
    torch.cuda.synchronize()
    launches_s64 = {n: read_counts()[n] for n in SOFT_MEGA}
    if min(launches_s64.values()) < 1:
        _fail(f"soft path f64 skipped a kernel: launches {launches_s64}")
    _check_soft_solution(torch, sol_s64, dims_s64, NS, cfg_soft64.k_max,
                         "soft path f64")
    conv_s = float((sol_s64.status == 0).double().mean())
    print(f"soft path f64: launches {launches_s64}, mean kk "
          f"{float(sol_s64.kk.double().mean()):.3f}, status counts "
          f"{torch.bincount(sol_s64.status, minlength=3).tolist()}, "
          f"converged with mu <= 1e-8: {conv_s:.4f}", flush=True)
    if conv_s < 0.99:
        _fail("soft path f64: fewer than 99% of instances converged")
    mu_o = _soft_oracle(torch, dims_s64, qpb_s64, sb_s64, sol_s64, 1e-6,
                        "soft path f64")
    if mu_o > 1e-8:
        _fail(f"soft path f64: oracle mu {mu_o:.3e} > 1e-8")
    t_sec = section_done("8-10 soft main paths", t_sec)

    # ---- 11. timings --------------------------------------------------------
    def solve_rep(q0, d, c, fn, field="b"):
        def run(r):
            q = dataclasses.replace(
                q0, **{field: getattr(q0, field) * (1.0 + 1e-4 * r)})
            return fn(d, q, c)
        return run

    def soft_solve(d, q, c):
        return pbatch.solve_batched_soft(d, q, sb_s, c, idxbs=idxbs_s)

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
                 (mk, "factor_solve_mega"), (mk, "solve_mega"), *six,
                 *soft_mega, *soft_six[:3]]
        saved = [(m, n, getattr(m, n)) for m, n in swaps]
        for m, n, _ in saved:
            setattr(m, n, getattr(m, n + "_ref"))
        try:
            yield
        finally:
            for m, n, fn in saved:
                setattr(m, n, fn)

    e2e = {}
    for label, q0, d, c, fn, reps, preps, field in (
            ("resident f32", qpb, dims, cfg, pbatch.solve_batched, 10, 2,
             "b"),
            ("lanes f32", qpb, dims, cfg_lanes, pbatch.solve_batched, 5, 1,
             "b"),
            ("lanes f32, 6-kernel loop", qpb, dims, cfg_lanes,
             six_kernel_loop(pbatch.solve_batched), 5, 1, "b"),
            ("lanes f64", qpb64, dims64, cfg_lanes,
             ipm_lanes.solve_batched_lanes, 3, 1, "b"),
            ("parity f32", qpb, dims, cfg_par, pbatch.solve_batched, 5, 1,
             "b"),
            ("soft f32", qpb_s, dims_s, cfg_soft, soft_solve, 5, 1, "g"),
            ("soft f32, 6-kernel loop", qpb_s, dims_s, cfg_soft,
             six_kernel_loop(soft_solve), 5, 1, "g")):
        ms = _time_ms(torch, solve_rep(q0, d, c, fn, field), reps=reps)
        with plain_kernels():
            ms_plain = _time_ms(torch, solve_rep(q0, d, c, fn, field),
                                reps=preps, warmup=0)
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
    for label, q0, d, c, fn, field in (
            ("lanes f32", qpb, dims, cfg_lanes, pbatch.solve_batched, "b"),
            ("lanes f32, 6-kernel loop", qpb, dims, cfg_lanes,
             six_kernel_loop(pbatch.solve_batched), "b"),
            ("lanes f64", qpb64, dims64, cfg_lanes,
             ipm_lanes.solve_batched_lanes, "b"),
            ("parity f32", qpb, dims, cfg_par, pbatch.solve_batched, "b"),
            ("soft f32", qpb_s, dims_s, cfg_soft, soft_solve, "g"),
            ("soft f32, 6-kernel loop", qpb_s, dims_s, cfg_soft,
             six_kernel_loop(soft_solve), "g")):
        pr = _profile(torch, solve_rep(q0, d, c, fn, field))
        print(_profile_line(label, card, pr), flush=True)
    t_sec = section_done("11 end-to-end timings and profiles", t_sec)

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
         lanes_calls[("factor_solve_mega", "")], 20,
         B * ((N + 1) * ops["factor"] + ops["root"]
              + n_ng * ops["ng_factor"]),
         sum(launches_l["factor_solve_mega"])),
        ("solve_mega", "hpmpc_tpu/ops/mega_kernel.py:601", mk,
         lanes_calls[("solve_mega", "")], 20,
         B * ((N + 1) * ops["solve"] + ops["root"]
              + n_ng * ops["ng_solve"]),
         sum(launches_l["solve_mega"])),
        ("prep_flat", "hpmpc_tpu/ops/step_kernel.py:222", stk,
         par_calls[("prep_flat", "")], 50, BS * ops["prep"], None),
        ("alpha_sums_flat", "hpmpc_tpu/ops/step_kernel.py:302", stk,
         par_calls[("alpha_sums_flat", "")], 50, BS * ops["alpha"], None),
        ("corr_geff_flat", "hpmpc_tpu/ops/step_kernel.py:379", stk,
         par_calls[("corr_geff_flat", "")], 50, BS * ops["corr"], None),
        ("factor_solve_folded_flat", "hpmpc_tpu/ops/stage_kernel.py:1224",
         sk, par_calls[("factor_solve_folded_flat", "")], 20,
         BS * ops["factor_flat"] + B * (ops["root"]
                                        + n_ng * ops["ng_factor"]), None),
        ("solve_flat", "hpmpc_tpu/ops/stage_kernel.py:1429", sk,
         par_calls[("solve_flat", "")], 20,
         BS * ops["solve_flat"] + B * ops["root"], None),
        ("refine_flat_fused", "hpmpc_tpu/ops/stage_kernel.py:1909", sk,
         par_calls[("refine_flat_fused", "")], 20,
         BS * ops["refine"] + B * (ops["root"] + n_ng * ops["ng_refine"]),
         None)]
    # the soft pair on the soft path's first calls, the soft step passes on
    # its 6-kernel loop's (the affine alpha pass)
    ops_s = _stage_ops(dims_s.NU, dims_s.NX, dims_s.NB, dims_s.NG, NS)
    BSs = B * (SOFT_N + 1)
    rows += [
        ("factor_solve_soft_mega", "hpmpc_tpu/ops/mega_kernel.py:939", mk,
         soft_calls[("factor_solve_soft_mega", "")], 20,
         BSs * ops_s["soft_factor"] + B * ops_s["root"],
         launches_s["factor_solve_soft_mega"]),
        ("solve_soft_mega", "hpmpc_tpu/ops/mega_kernel.py:1242", mk,
         soft_calls[("solve_soft_mega", "")], 20,
         BSs * ops_s["soft_solve"] + B * ops_s["root"],
         launches_s["solve_soft_mega"]),
        ("soft_prep_flat", "hpmpc_tpu/ops/step_kernel.py:654", stk,
         soft6_calls[("soft_prep_flat", "")], 50, BSs * ops_s["soft_prep"],
         launches_s6["soft_prep_flat"]),
        ("soft_alpha_sums_flat", "hpmpc_tpu/ops/step_kernel.py:758", stk,
         soft6_calls[("soft_alpha_sums_flat", "")], 50,
         BSs * ops_s["soft_alpha"], launches_s6["soft_alpha_sums_flat"]),
        ("soft_corr_flat", "hpmpc_tpu/ops/step_kernel.py:845", stk,
         soft6_calls[("soft_corr_flat", "")], 50, BSs * ops_s["soft_corr"],
         launches_s6["soft_corr_flat"])]
    srcs = {"ipm_resident": "ipm_resident", "resid_full": "resid_full",
            "factor_solve_mega": "factor_solve_mega",
            "solve_mega": "solve_mega", "factor_solve_folded_flat":
            "factor_solve_flat", "solve_flat": "solve_flat",
            "refine_flat_fused": "refine_flat",
            **{n: "step_flat" for n in STEP_NAMES},
            **{n: n for n in SOFT_MEGA},
            **{n: "soft_step_flat" for n in SOFT_STEP}}
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
    section_done("12 kernels alone", t_sec)
    print(f"chip_smoke: total {time.perf_counter() - t_script:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in sections) + ")",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
