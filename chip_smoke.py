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
    soft engine in float64 (``k_max=30``, mu_tol 1e-8);
  * the structured two-phase IPM (``models.ipm.solve``) on the hard
    flagship: route A, the library's default ``IPMConfig()`` (plain
    batched Riccati, no kernel), float32 and float64; route B, its kernel
    backend (``factor_solve_folded`` + ``solve_batched``), reached through
    ``solve_batched`` with ``use_pallas`` on dims without a static
    ``idxb``, float64 at ``k_max=6`` against route A, float64 and float32
    at the default tolerances; route C, ``escalate_stalled`` in float32:
    the lanes engine, then every unconverged instance re-solved in float64
    on route A and merged, at the default tolerances (every instance
    stalls) and on a batch that the float32 stage converges in part;
  * the lanes engine's flat form (the 6-kernel loop with the unfused
    refinement: ``resid_terms_flat`` + ``solve_flat_pb``, into which the
    JAX package's flat engine folds): route D, ``solve_batched`` with
    ``IPMConfig(k_max=8, mu_tol=0, iter_ref=1, use_pallas=True)`` in
    float32 (the ``"flat"`` engine); route E, the first float64
    ``use_pallas`` batches, with and without ``iter_ref``, at the default
    tolerances; route F, bench.py's parity line with the flat stage 2
    (``HPMPC_STAGE2_LANES=0``), its control error held as the parity
    line's and its answer against the lanes stage 2's beside the flat
    stage 2 without refinement, and the float64 lanes engine with the
    unfused refinement (``HPMPC_FUSED_REFINE=0``) against the fused one;
  * the structured soft IPM (``models.ipm_soft.solve``), route G:
    ``tools/bench_soft.py``'s problem and config without ``use_pallas``,
    float32 and float64 (also to mu <= 1e-8), and its kernel backend
    (``use_pallas`` without ``idxbs``: rows 16/15) against the plain one;
    route H, the float64 soft batch through ``solve_batched_soft`` (the
    ``"soft_flat"`` engine: the soft 6-kernel loop) to mu <= 1e-8.  The
    soft lanes engine's two routes are timed side by side in float32 and
    float64 (its default is the 6-kernel loop).
  * the flat engine on a problem with general rows and no box rows
    (section I0: the chain nx=4 nu=2 N=16 with its bounds as C/D rows,
    f64) against the structured solver;
  * the public API (sections I-K): row 23, the dense latency kernel
    (``ops/dense_kernel.dense_ipm``), against its plain version at the
    box-only flagship's dense plan (``mass_spring_qp(8, 3, 30)``: nz=90,
    ngd=120) in f32 (k_max=8, mu_tol=1e-4) and f64 (mu_tol=1e-8), cold and
    warm, and on a QP with an unboxed input against the reference; then, counted from 0, ``api.solve_ocp`` on the golden
    ``ipm_ms_nx8_nu3_N30_ngN8`` problem (f64, read from ``tests/golden/``
    as data: kk and ux against the file), with ``N2=5`` against the direct
    solve, ``OCPSession.solve_new_rhs`` / ``single_newton`` / ``solve``
    along a short x0 sequence against fresh solves, and a closed loop of
    warm ``OCPSession.dense_tick`` s on the box-only flagship (one launch
    of row 23 a tick, u0 against fresh solves); then solve_ocp's wall time,
    the dense tick's latency (cold and warm, f32 and f64, and through the
    session), a tick's profile, row 23 alone with its bound, and one
    ``torch.linalg`` Cholesky + solve of the same Hbar as context;
  * the scenario tree (section T) at ``tools/bench_tree.py``'s width:
    ``mass_spring_tree_qp(nx=4, nu=2)``, 4096 instances with ``b`` scaled
    by ``1 + 0.02 N(0,1)``, f32, ``IPMConfig(k_max=8, mu_tol=0,
    use_pallas=True)``.  Rows 26-28 (``csrc/tree_sweeps.cu``,
    ``csrc/tree_resid_terms.cu``) against their plain versions on the
    reference's 71-node tree (md=2 Nr=3 Nh=10) with general rows on nodes
    0 and 5, f32 and f64, at the flat engine's first and last calls; then,
    counted from 0, ``parallel.batch.solve_batched_tree`` on the 71-node
    tree (rows 26-28 and the step kernels, no other kernel) against the
    f64 structured ``tree.solve_tree_ipm`` on 64 instances and an f64
    host ``tree_residuals``; a warm tree-RTI re-solve on the 31-node tree
    that stays on the flat engine; the 255-node tree once; ms per batch at
    31, 71 and 255 nodes, the structured route at 71, a profile, and each
    kernel alone.
  * the large-NZ band (section L) at ``tools/bench_size_sweep.py``'s
    problem and config: rows 24-25 (``csrc/batch_chol.cu``) against their
    plain versions at n = 72, 144 and 288 in f32 and f64 (a clamped pivot
    included); then, counted from 0, ``solve_batched`` on
    ``mass_spring_qp(64, 8, 30)`` (NZ=72), 1024 f32 instances with ``b``
    scaled by ``1 + 0.02 N(0,1)``, ``IPMConfig(k_max=8, mu_tol=0,
    alpha_min=1e-8, use_pallas=True)``: ``"structured"`` on the blocked
    Riccati, row 24 and no other kernel, no per-thread library built at
    that shape, against the f64 and f32 plain structured routes and the
    f64 host oracle; the same at nx=128 nu=16 (B=512) and at nx=64 in f64;
    ``solve_batched_soft`` on ``mass_spring_soft_qp(64, 8, 30, Z=10)``;
    then ms per batch, a profile, and rows 24-25 alone beside their plain
    versions and ``torch.linalg.cholesky``.
  * the fused sweeps (section S, ``HPMPC_FUSED_SWEEPS=1``): rows 18 and 17
    (the fused forms of ``csrc/factor_solve_flat.cu`` and
    ``csrc/solve_flat.cu``) against their plain versions and against rows
    9 and 10 on the same inputs, on the 6-kernel loops' first and last
    calls, hard and soft flagship, f32 and f64; then, counted from 0, the
    soft path at ``tools/bench_soft.py``'s flagship (the slice's main
    path: rows 6-8, 18 and 17, neither row 9 nor 10), the lanes 6-kernel
    loop at the default tolerances, routes E (no refinement) and D and
    the parity line under the switch, each against the f64 oracle and
    against the same path without the switch (bit for bit); ms a batch
    with and without the switch; the two kernels alone beside rows 9 and
    10.

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
import types

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
# the structured kernels in float32 at the third IPM iteration: the kernel's
# error against the float64 plain version on the same inputs may be at most
# this many times the float32 plain version's own (see section 2)
COND_FACTOR = 10.0
# the wrappers of the 6-kernel lanes loop: step passes, then sweeps
STEP_NAMES = ("prep_flat", "alpha_sums_flat", "corr_geff_flat")
STAGE_NAMES = ("factor_solve_folded_flat", "solve_flat", "refine_flat_fused")
# the unfused refinement pass of the flat form: row 12, then row 11
UNFUSED = ("resid_terms_flat", "solve_flat_pb")
# the soft path's kernels: the mega pair, then the soft 6-kernel loop's
# step passes (its sweeps are factor_solve_folded_flat and solve_flat)
SOFT_MEGA = ("factor_solve_soft_mega", "solve_soft_mega")
SOFT_STEP = ("soft_prep_flat", "soft_alpha_sums_flat", "soft_corr_flat")
# the structured route's kernels: row 16, row 15, and row 14 (the same
# kernel reading the effective Hessian whole; off the solver path)
STRUCT_NAMES = ("factor_solve_folded", "solve_batched",
                "factor_solve_batched")
# the kernels that read only the lower triangle of one (N+1, n, n, B)
# matrix stream argument, {name: (its position, n's field of OCPDims)}:
# row 15's factor, row 14's effective Hessian, the retained Lxx of rows 10,
# 11 and 13; the byte bound charges that triangle
TRIL_READ = {"solve_batched": (0, "NZ"), "factor_solve_batched": (0, "NZ"),
             "solve_flat": (1, "NX"), "solve_flat_pb": (1, "NX"),
             "refine_flat_fused": (11, "NX")}
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


def _tril_nbytes(x, n: int) -> int:
    """Bytes of the lower triangles of the (n, n) blocks of ``x``
    (N+1, n, n, B)."""
    return x.numel() // (n * n) * (n * (n + 1) // 2) * x.element_size()


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
        # the unfused pass: H z on every stage, F' z and F pi on N of them;
        # the re-solve's Pb = Lxx (Lxx' b) on N stages
        hz=2 * NZ * NZ, f_terms=4 * NZ * NX, pb=2 * NX * NX,
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


#: the port's kernels as the profiler names them (``<name>_kernel``; the
#: Pb form of solve_flat.cu is its template instance ``<T, true>``)
PROFILED = ("ipm_resident", "resid_full", "factor_solve_mega", "solve_mega",
            "prep_flat", "alpha_sums_flat", "corr_geff_flat",
            "factor_solve_flat", "solve_flat_pb", "solve_flat",
            "factor_solve_flat_fused", "solve_flat_fused",
            "refine_flat", "resid_terms_flat") + SOFT_MEGA + SOFT_STEP + (
                "factor_solve_folded", "solve_batched", "dense_ipm",
                "tree_factor_solve_flat", "tree_solve_flat",
                "tree_resid_terms_flat", "cholesky", "panel")
_PATTERNS = {k: rf"\b{k}_kernel\b" for k in PROFILED}
_PATTERNS["solve_flat_pb"] = r"\bsolve_flat_kernel<\w+, true>"


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
        part = next((k for k in PROFILED if re.search(_PATTERNS[k], e.key)),
                    "other")
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
def _capture(targets, last=False, when=None):
    """Record the arguments of the first call (with ``last``, the last one)
    of each wrapper ``(module, name)`` of ``targets`` while the block runs
    (with ``when``, among the calls made while ``when()`` holds): {(name,
    variant): (args, kwargs)}, variant as :func:`_variant`."""
    calls, saved = {}, [(m, n, getattr(m, n)) for m, n in targets]

    def spy(name, fn):
        def call(*a, **k):
            key = (name, _variant(name, a, k))
            if (last or key not in calls) and (when is None or when()):
                calls[key] = (a, k)
            return fn(*a, **k)
        return call

    for m, n, fn in saved:
        setattr(m, n, spy(n, fn))
    try:
        yield calls
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


@contextlib.contextmanager
def _phase_watch(stk):
    """{"phase2": bool}: whether the lanes engine has begun its phase 2
    (a prep pass of its 6-kernel loop with ``phase2``) while the block
    runs."""
    seen, prep = {"phase2": False}, stk.prep_flat

    def spy(*a, **k):
        seen["phase2"] |= bool(k.get("phase2"))
        return prep(*a, **k)

    stk.prep_flat = spy
    try:
        yield seen
    finally:
        stk.prep_flat = prep


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


def _check_vs_f64(torch, calls, mods, factor, floor, what):
    """Each captured float32 call: the kernel and its plain version, each
    against the plain version in float64 on the same inputs (upcast).  The
    kernel's largest difference, relative to each output's scale, must be
    at most ``factor`` times the float32 plain version's (both are float32
    roundoff as the inputs' conditioning amplifies it), or ``floor``."""
    def up(x):
        f = hasattr(x, "is_floating_point") and x.is_floating_point()
        return x.double() if f else x

    for (kname, _), (a, k) in sorted(calls.items()):
        plain = getattr(mods[kname], kname + "_ref")
        out_k = _flat(getattr(mods[kname], kname)(*a, **k))
        torch.cuda.synchronize()
        out_p = _flat(plain(*a, **k))
        out_64 = _flat(plain(*[up(x) for x in a],
                             **{n: up(v) for n, v in k.items()}))
        if not all(bool(torch.isfinite(x).all()) for x in out_k):
            _fail(f"{kname} {what}: non-finite output")

        def rel(out):
            return max(_maxdiff(torch, x, y) / max(1.0, float(y.abs().max()))
                       for x, y in zip(out, out_64))

        e_k, e_p = rel(out_k), rel(out_p)
        print(f"{kname} {what}: vs the f64 plain version on the same inputs,"
              f" max |d|/scale: kernel {e_k:.3e}, f32 plain version "
              f"{e_p:.3e} (ratio {e_k / max(e_p, 1e-30):.2f}, limit "
              f"{factor:.0f} or {floor:.0e})", flush=True)
        if e_k > max(factor * e_p, floor):
            _fail(f"{kname} {what}: the kernel's f32 error exceeds "
                  f"{factor:.0f} times its plain version's")


def _check_vs_floor(torch, calls, mods, factor, floor, what):
    """Each captured call on ill-conditioned inputs: the kernel against its
    plain version, beside the plain version's own move when every floating
    input is moved by one ulp (x (1 + eps)), the floor any change of
    rounding meets there.  The kernel's largest difference, relative to
    each output's scale, must be at most ``factor`` times that move, or
    ``floor``."""
    def bump(x):
        if hasattr(x, "is_floating_point") and x.is_floating_point():
            return x * (1.0 + torch.finfo(x.dtype).eps)
        return x

    for (kname, _), (a, k) in sorted(calls.items()):
        plain = getattr(mods[kname], kname + "_ref")
        out_k = _flat(getattr(mods[kname], kname)(*a, **k))
        torch.cuda.synchronize()
        out_p = _flat(plain(*a, **k))
        out_e = _flat(plain(*[bump(x) for x in a],
                            **{n: bump(v) for n, v in k.items()}))
        if not all(bool(torch.isfinite(x).all()) for x in out_k):
            _fail(f"{kname} {what}: non-finite output")

        def rel(out):
            return max(_maxdiff(torch, x, y) / max(1.0, float(y.abs().max()))
                       for x, y in zip(out, out_p))

        e_k, e_e = rel(out_k), rel(out_e)
        print(f"{kname} {what}: vs its plain version, max |d|/scale "
              f"{e_k:.3e}; the plain version on inputs moved by one ulp "
              f"{e_e:.3e} (ratio {e_k / max(e_e, 1e-300):.2f}, limit "
              f"{factor:.0f} or {floor:.0e})", flush=True)
        if e_k > max(factor * e_e, floor):
            _fail(f"{kname} {what}: the kernel's error exceeds {factor:.0f} "
                  "times the plain version's one-ulp move")


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


# row 23 (the dense latency kernel) vs its plain version: equal kk and
# status; y within these of its scale.  f32: the TPU kernel's own test
# holds the Pallas kernel to its oracle at 2e-4 in y (tests/test_ipm_dense.
# py), the kernel and the plain version sum the fold and the products in
# another order and the barrier conditioning (~1/mu) amplifies that
# roundoff; f64 at mu_tol 1e-8: 1e-10 (a host build of the kernel against
# the plain version: 1.7e-15 at the flagship, 4.4e-8 on a random dense QP
# at nz = ngd = 128, whose fold is far from symmetric in roundoff)
DENSE_TOL = {"float32": 2e-4, "float64": 1e-10}
# the API section's tolerances: the golden file's solution (tests/
# test_api.py: 1e-8, stat rtol 1e-6); N2=5 against the direct solve at
# mu_tol 1e-8 (1.0e-6 on the CPU; tests/test_cond.py holds the ngN=8
# problem at N2=5 to 8e-6 at mu_tol 1e-9); each dense tick's u0 against a
# fresh solve's (tests/test_api.py::test_session_dense_tick: 2e-3); the
# retained-factor re-solve and the RTI step against fresh solves of the
# new x0 (tests/test_api.py: 2e-4 and 5e-3 for the same kind of step)
API_TOL = dict(golden=1e-8, n2=1e-5, tick=2e-3, new_rhs=2e-4, rti=5e-3,
               warm=1e-6)
DENSE_TICKS = 24
F64_OPS = 67e12     # H100 SXM float64 peak (tensor cores; data sheet)


def _dense_ops(nz: int, ngd: int, kk: int) -> float:
    """Operations one dense tick of ``kk`` iterations needs (a multiply-add
    counts 2): per iteration the symmetric fold's lower triangle
    ngd nz (nz + 1), the Cholesky nz^3/3, four triangular substitutions
    4 nz^2 and four G / G' products 8 ngd nz; the initial G y0 once."""
    it = ngd * nz * (nz + 1) + nz ** 3 / 3 + 4 * nz * nz + 8 * ngd * nz
    return kk * it + 2 * ngd * nz


def _flat_no_box(torch, np, dev):
    """Section I0: the flat engine on a problem with general rows and no box
    rows (the mass-spring chain nx=4 nu=2 N=16 with its bounds as C/D
    rows), f64, 256 instances with b scaled per instance, against the
    structured solver's plain backend on the same batch (tests/
    test_torch_ipm_structured.py's tolerances): the kernels of the flat
    form must ignore the one masked box slot they are handed."""
    from hpmpc_tpu_torch import api
    from hpmpc_tpu_torch.models import ipm
    from hpmpc_tpu_torch.models.ipm import IPMConfig
    from hpmpc_tpu_torch.parallel import batch as pbatch
    from hpmpc_tpu_torch.utils.mass_spring import mass_spring_data

    dims, qp = api.pack_problem(**mass_spring_data(4, 2, 16,
                                                   bounds_as_rows=True),
                                device=dev)
    nb = 256
    sc = torch.as_tensor(1.0 + 0.05 * np.random.default_rng(SEED)
                         .standard_normal(nb), device=dev)
    qpb = pbatch.broadcast_qp(qp, nb)
    qpb = dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])
    cfg = IPMConfig(use_pallas=True)
    engine = pbatch.select_engine(dims, cfg, nb, torch.float64)
    if engine != "flat" or sum(dims.nb) != 0:
        _fail(f"no-box problem: engine {engine}, nb {dims.nb}")
    sol = pbatch.solve_batched(dims, qpb, cfg)
    ref = ipm.solve(dims, qpb, IPMConfig())
    dz = _maxdiff(torch, sol.z, ref.z)
    same = bool(torch.equal(sol.kk, ref.kk)) and bool(
        torch.equal(sol.status, ref.status))
    print(f"flat, no box rows (nx=4 nu=2 N=16, ng only, f64, {nb} "
          f"instances): engine {engine}, kk equal to the structured "
          f"solver's {same}, converged {int((sol.status == 0).sum())}, max "
          f"|dz| {dz:.3e} (tol 1e-8)", flush=True)
    if not same or dz > 1e-8 or not bool((sol.status == 0).all()):
        _fail("the flat engine on a problem without box rows disagrees "
              "with the structured solver")


def _api_and_dense(torch, np, dev, card, repo, reset_counts, read_counts,
                   total, section_done, t_sec):
    """Sections I-K: row 23 vs its plain version at the flagship dense plan;
    the public API on the card end to end (counted from 0); the dense
    tick's latency, solve_ocp's wall time and row 23 alone.  Returns (row
    23's kernels-line entry, t_sec)."""
    from hpmpc_tpu_torch import api
    from hpmpc_tpu_torch.models import ipm_dense
    from hpmpc_tpu_torch.models.ipm import IPMConfig
    from hpmpc_tpu_torch.ops import dense_kernel as dk
    from hpmpc_tpu_torch.utils.mass_spring import (mass_spring_ab,
                                                   mass_spring_data,
                                                   mass_spring_qp)

    _flat_no_box(torch, np, dev)

    # ---- I. row 23 vs its plain version, f32 and f64, cold and warm ------
    cfg_d = {torch.float32: IPMConfig(k_max=8, mu_tol=1e-4),
             torch.float64: IPMConfig(k_max=30, mu_tol=1e-8)}
    plans, err23, inputs = {}, 0.0, {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        dims_d, qp_d = mass_spring_qp(8, 3, N_HORIZON, dtype=dtype,
                                      device=dev)
        plan = ipm_dense.plan_dense(dims_d, qp_d)
        if (plan.nz, plan.ngd) != (90, 120):
            _fail(f"dense plan {name}: nz={plan.nz}, ngd={plan.ngd}, "
                  "expected 90, 120")
        plans[dtype] = (dims_d, qp_d, plan)
        bflat = qp_d.b.reshape(-1)
        y_cold = None
        for warm in (False, True):
            b_ = bflat * 1.01 if warm else bflat
            args = dk.dense_inputs(plan, b_, y_cold if warm else None)
            kw = dk.dense_config(plan, cfg_d[dtype])
            out_k = dk.dense_ipm(*args, **kw)
            torch.cuda.synchronize()
            out_p = dk.dense_ipm_plain(*args, **kw)
            kk_k, st_k = int(out_k[1]), int(out_k[3])
            kk_p, st_p = int(out_p[1]), int(out_p[3])
            dy = _maxdiff(torch, out_k[0], out_p[0])
            scale = max(1.0, float(out_p[0].abs().max()))
            tag = f"{name} {'warm' if warm else 'cold'}"
            print(f"dense_ipm {tag}: kernel kk {kk_k} status {st_k} mu "
                  f"{float(out_k[2]):.4e}; plain kk {kk_p} status {st_p} mu "
                  f"{float(out_p[2]):.4e}; max|dy| {dy:.3e} (tol "
                  f"{DENSE_TOL[name]:.0e} of scale {scale:.3f})", flush=True)
            if not bool(torch.isfinite(out_k[0]).all()):
                _fail(f"dense_ipm {tag}: non-finite y")
            if (kk_k, st_k) != (kk_p, st_p) or st_k != 0:
                _fail(f"dense_ipm {tag}: kk/status {kk_k}/{st_k} against "
                      f"the plain version's {kk_p}/{st_p}")
            if dy > DENSE_TOL[name] * scale:
                _fail(f"dense_ipm {tag} disagrees with its plain version")
            err23 = max(err23, dy)
            if not warm:
                y_cold = out_k[0]
                inputs[dtype] = (args, kw, kk_k, out_k)
    # a QP with an unboxed input (the N=6 chain, input 2 unboxed), where
    # the port departs from the TPU kernel (it pins unboxed coordinates
    # to 0): kernel, plain version and reference agree, f64
    d6 = mass_spring_data(8, 3, 6)
    for n in range(6):
        keep = [k for k, j in enumerate(d6["idxb"][n]) if j != 2]
        for key in ("idxb", "lb", "ub"):
            d6[key][n] = d6[key][n][keep]
    dims6, qp6 = api.pack_problem(**d6, device=dev)
    plan6 = ipm_dense.plan_dense(dims6, qp6)
    args = dk.dense_inputs(plan6, qp6.b.reshape(-1))
    kw = dk.dense_config(plan6, cfg_d[torch.float64])
    out_k = dk.dense_ipm(*args, **kw)
    torch.cuda.synchronize()
    out_p = dk.dense_ipm_plain(*args, **kw)
    ref = ipm_dense.solve_dense_ref(plan6, qp6.b.reshape(-1),
                                    cfg_d[torch.float64])
    d_kp = _maxdiff(torch, out_k[0], out_p[0])
    d_kr = _maxdiff(torch, out_k[0], ref.y)
    print(f"dense_ipm f64, an unboxed input (N=6, nz {plan6.nz}, nb "
          f"{plan6.nb}): kernel kk {int(out_k[1])} status {int(out_k[3])}, "
          f"max|dy| vs plain {d_kp:.3e}, vs the reference (kk "
          f"{int(ref.kk)}) {d_kr:.3e}; u0 {out_k[0][-3:].tolist()}",
          flush=True)
    if (int(out_k[1]), int(out_k[3])) != (int(out_p[1]), 0) or max(
            d_kp, d_kr) > 1e-8:
        _fail("dense_ipm on an unboxed input disagrees with its plain "
              "version or the reference")
    t_sec = section_done("I row 23 vs plain", t_sec)

    # ---- J. the public API on the card, f64, counted from 0 -------------
    g = json.loads((repo / "tests" / "golden"
                    / "ipm_ms_nx8_nu3_N30_ngN8.json").read_text())
    c = g["config"]
    nx, nu, N = c["nx"], c["nu"], c["N"]
    A = np.array(g["A_colmajor"]).reshape(nx, nx, order="F")
    Bm = np.array(g["B_colmajor"]).reshape(nx, nu, order="F")
    data = mass_spring_data(nx, nu, N, ngN=c["ngN"], A=A, B=Bm)
    gcfg = dict(k_max=c["k_max"], mu0=c["mu0"], mu_tol=c["mu_tol"],
                alpha_min=c["alpha_min"])

    def ux(res):
        return [np.concatenate([res.u[n], res.x[n]]) for n in range(N + 1)]

    def maxdiff(a, b):
        return max(float(np.abs(x - y).max()) for x, y in zip(a, b))

    reset_counts()
    dk.LAUNCHES = 0
    plain0 = dk.PLAIN_CALLS
    res, sess = api.solve_ocp(**data, **gcfg, return_session=True)
    d_gold = maxdiff(ux(res), [np.array(v) for v in g["ux"]])
    stat_ref = np.array(g["stat"]).reshape(-1, 5)[:g["kk"]]
    if (res.kk, res.status) != (g["kk"], 0) or d_gold > API_TOL["golden"]:
        _fail(f"solve_ocp golden: kk {res.kk} (golden {g['kk']}), status "
              f"{res.status}, max |ux - golden| {d_gold:.3e}")
    if not np.allclose(res.stat, stat_ref, rtol=1e-6, atol=1e-9):
        _fail("solve_ocp golden: stat trace disagrees with the golden file")
    part = api.solve_ocp(**data, **gcfg, N2=5)
    d_n2 = maxdiff(ux(part), ux(res))
    if part.status != 0 or d_n2 > API_TOL["n2"]:
        _fail(f"solve_ocp(N2=5): status {part.status}, max |ux - direct| "
              f"{d_n2:.3e}")
    print(f"api golden ipm_ms_nx8_nu3_N30_ngN8 f64: kk {res.kk} (golden "
          f"{g['kk']}), max |ux - golden| {d_gold:.3e}; N2=5 kk {part.kk}, "
          f"max |ux - direct| {d_n2:.3e}", flush=True)

    # the session's re-solves along a short x0 sequence, each against a
    # fresh solve of the new x0
    rng = np.random.default_rng(SEED)
    x0 = data["x0"]
    for step in range(2):
        x0 = x0 + 0.01 * rng.standard_normal(nx)
        fresh = api.solve_ocp(**{**data, "x0": x0}, **gcfg)
        quick = sess.solve_new_rhs(x0=x0)
        d_q = maxdiff(ux(quick), ux(fresh))
        rti = sess.single_newton(k=1, x0=x0)
        d_r = float(np.abs(rti.u[0] - fresh.u[0]).max())
        warm = sess.solve(x0=x0)
        d_w = maxdiff(ux(warm), ux(fresh))
        print(f"api session step {step}: solve_new_rhs max |ux - fresh| "
              f"{d_q:.3e}; single_newton |u0 - fresh| {d_r:.3e}; solve "
              f"(warm) kk {warm.kk} (fresh {fresh.kk}), max |ux - fresh| "
              f"{d_w:.3e}", flush=True)
        if (d_q > API_TOL["new_rhs"] or d_r > API_TOL["rti"]
                or d_w > API_TOL["warm"] or warm.status != 0):
            _fail(f"api session step {step}: a re-solve strayed from the "
                  "fresh solve")

    # the dense tick in closed loop on the box-only flagship: each warm
    # tick launches row 23 once; its u0 against a fresh solve_ocp of the
    # same x0 (run after the loop, so that the tick counts stay clean)
    dbox = mass_spring_data(8, 3, N_HORIZON)
    _, sess_d = api.solve_ocp(**dbox, return_session=True)
    Ad, Bd = mass_spring_ab(8, 3)
    x = dbox["x0"].copy()
    xs, u0s, kks = [], [], []
    for t in range(DENSE_TICKS):
        n0 = dk.LAUNCHES
        u0, r_ = sess_d.dense_tick(x0=x)
        if dk.LAUNCHES != n0 + 1:
            _fail(f"dense tick {t}: row 23 launched {dk.LAUNCHES - n0} "
                  "times")
        if int(r_.status) != 0:
            _fail(f"dense tick {t}: status {int(r_.status)}")
        xs.append(x.copy())
        u0s.append(u0)
        kks.append(int(r_.kk))
        x = Ad @ x + Bd @ u0 + 0.01 * rng.standard_normal(8)
    counts = read_counts()
    launches_23 = dk.LAUNCHES
    other = {k: total(v) for k, v in counts.items() if total(v)}
    if launches_23 != DENSE_TICKS or dk.PLAIN_CALLS != plain0 or other:
        _fail(f"api main path: row 23 launches {launches_23} (expected "
              f"{DENSE_TICKS}), plain calls {dk.PLAIN_CALLS - plain0}, "
              f"other kernels {other}")
    du = 0.0
    for xx, u0 in zip(xs, u0s):
        fresh = api.solve_ocp(**{**dbox, "x0": xx})
        if fresh.status != 0:
            _fail("a fresh solve of a tick's x0 did not converge")
        du = max(du, float(np.abs(u0 - fresh.u[0]).max()))
    print(f"api dense tick: {DENSE_TICKS} warm ticks, row 23 launches "
          f"{launches_23} (one a tick, no plain call, no other kernel), kk "
          f"{kks}, max |u0 - fresh solve_ocp| {du:.3e} (tol "
          f"{API_TOL['tick']:.0e}), final |x| {np.linalg.norm(x):.4f}",
          flush=True)
    if du > API_TOL["tick"]:
        _fail("dense ticks disagree with fresh solves")
    t_sec = section_done("J api main path", t_sec)

    # ---- K. latency and timings ----------------------------------------
    def call_ms(fn, reps):
        """Median ms of ``reps`` calls, each between two CUDA events (a
        tick ends with u0 on the host, so the events bracket all of it)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = []
        for r in range(reps):
            torch.cuda.synchronize()
            start.record()
            fn(r)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return float(np.median(out)), out

    ms_solve, all_solve = call_ms(lambda r: api.solve_ocp(**data, **gcfg), 3)
    print(f"api.solve_ocp [{card}] f64 golden problem: "
          f"{ms_solve:.3f} ms per call (CUDA events, median of 3: "
          + ", ".join(f"{v:.3f}" for v in all_solve) + ")", flush=True)
    for warm in (False, True):
        xq = dbox["x0"]
        ms_t, _ = call_ms(lambda r: sess_d.dense_tick(
            warm=warm, x0=xq * (1.0 + 1e-4 * (r % 7))), 200)
        print(f"api OCPSession.dense_tick [{card}] f64 "
              f"{'warm' if warm else 'cold'}: {ms_t:.4f} ms per tick "
              "(median of 200, CUDA events: b packed on the host, the "
              "vector maps, row 23, u0 to the host)", flush=True)
    # the same warm tick with b taken from a repack of the whole problem
    # (pack_problem, as the JAX session's tick does), to weigh the
    # session's b-only packing
    plan_s, y_s = sess_d._dense_plan, sess_d._dense_y
    ms_r, _ = call_ms(lambda r: ipm_dense.solve_dense_tick(
        plan_s, sess_d._repack(
            x0=dbox["x0"] * (1.0 + 1e-4 * (r % 7))).b.reshape(-1),
        sess_d.cfg, y0=y_s).u0.cpu(), 200)
    print(f"api dense tick [{card}] f64 warm, b from a full repack: "
          f"{ms_r:.4f} ms per tick (median of 200, CUDA events; the "
          f"session's b-only packing: {ms_t:.4f} ms)", flush=True)
    pr = _profile(torch, lambda r: sess_d.dense_tick(
        x0=dbox["x0"] * (1.0 + 1e-4 * r)), reps=20)
    print(_profile_line("api dense tick f64 warm", card, pr), flush=True)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        _, qp_d, plan = plans[dtype]
        bflat = qp_d.b.reshape(-1)
        y_w = ipm_dense.solve_dense_tick(plan, bflat, cfg_d[dtype]).y
        for warm in (False, True):
            ms_t, _ = call_ms(lambda r: ipm_dense.solve_dense_tick(
                plan, bflat * (1.0 + 1e-4 * (r % 7)), cfg_d[dtype],
                y0=y_w if warm else None).u0.cpu(), 200)
            print(f"dense tick [{card}] {name} {'warm' if warm else 'cold'}"
                  f" (k_max {cfg_d[dtype].k_max}, mu_tol "
                  f"{cfg_d[dtype].mu_tol:.0e}): {ms_t:.4f} ms per tick "
                  "(median of 200, CUDA events: the vector maps, row 23, "
                  "u0 to the host)", flush=True)

    # row 23 alone: CUDA events over 50 launches, the plain version over 2,
    # at the flagship's cold inputs; the kernels line's entry is f32
    row = None
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        args, kw, kk, out = inputs[dtype]
        nz, ngd = args[0].shape[0], args[1].shape[0]
        ms = _time_ms(torch, lambda r: dk.dense_ipm(*args, **kw), reps=50)
        ms_p = _time_ms(torch, lambda r: dk.dense_ipm_plain(*args, **kw),
                        reps=2, warmup=0)
        nbytes = _nbytes(args, out)
        ops = _dense_ops(nz, ngd, kk)
        peak = F32_OPS if dtype == torch.float32 else F64_OPS
        bound_ms = max(nbytes / HBM_BPS, ops / peak) * 1e3
        bound_by = "bytes" if nbytes / HBM_BPS >= ops / peak else "operations"
        sm_ms = ops / (peak / 132) * 1e3
        print(f"dense_ipm [{card}] {name}: kernel {ms:.4f} ms, plain "
              f"{ms_p:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: {nbytes} "
              f"B, {ops:.4e} ops at kk {kk}; {bound_ms / ms:.3%} of bound), "
              f"one SM's share of the peak {sm_ms:.4f} ms ({sm_ms / ms:.2%});"
              f" sequential depth {kk * 5 * nz} steps ({5 * nz} an iteration"
              f": {nz} Cholesky columns + 4 x {nz} substitution steps), "
              f"{ms / (kk * 5 * nz) * 1e6:.1f} ns a step (nz {nz}, ngd "
              f"{ngd})", flush=True)
        if dtype == torch.float32:
            row = {"name": "dense_ipm", "route": "cuda",
                   "source": "hpmpc_tpu_torch/csrc/dense_ipm.cu",
                   "replaces": "hpmpc_tpu/ops/dense_kernel.py:396",
                   "launches": launches_23, "max_abs_err": err23, "ms": ms,
                   "plain_ms": ms_p, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": None}
    # context only (the port never calls them): one Cholesky + solve of the
    # flagship's first Hbar (f32) by torch.linalg
    seen = []
    chol = dk._chol_cols

    def spy(A_, tiny):
        seen.append(A_.clone())
        return chol(A_, tiny)

    dk._chol_cols = spy
    try:
        args, kw, _, _ = inputs[torch.float32]
        dk.dense_ipm_plain(*args, **dict(kw, k_max=1))
    finally:
        dk._chol_cols = chol
    Hbar = seen[0]
    rhs = torch.ones(Hbar.shape[0], 1, dtype=Hbar.dtype, device=dev)
    ms_lib = _time_ms(torch, lambda r: torch.cholesky_solve(
        rhs, torch.linalg.cholesky(Hbar)), reps=50)
    print(f"context [{card}]: torch.linalg.cholesky + torch.cholesky_solve "
          f"of the flagship's first Hbar (f32, {Hbar.shape[0]}x"
          f"{Hbar.shape[0]}): {ms_lib:.4f} ms; row 23 per iteration "
          f"{row['ms'] / inputs[torch.float32][2]:.4f} ms", flush=True)
    t_sec = section_done("K api and dense timings", t_sec)
    return row, t_sec

# the scenario-tree section (T).  Rows 26-28 against their plain versions
# on the flat tree engine's first and last calls of a k_max=8 solve on the
# 71-node tree with general rows on nodes 0 and 5, f32 and f64: the same
# algorithm in another summation order (nvcc contracts multiply-adds into
# FMAs).  Host builds of the three kernels against the plain versions
# there (B=64): <= 5.1e-7 of a field's scale in f32, <= 9.5e-16 in f64, at
# the first call and at the last (mu ~2e-8: the tree's depth-10 recursion
# and the barrier Hessian amplified the roundoff less than at the first
# call), so MEGA_TOL.  The main path (f32, k_max 8, mu ~2e-8 at the end)
# against the f64 structured route on ORACLE_SUBSAMPLE instances: equal
# status, max |dz| below TREE_TOL["z"] (the plain versions on the CPU:
# 3.7e-5, f32 roundoff through the barrier Hessian); the f64 host tree
# residuals of its iterate against the engine's own report as _oracle holds
# the chain's (rtol 1e-2, atol 1e-5), the primal ones below 1e-3.
TREE_TOL = dict(z=1e-3)
TREE_NAMES = ("tree_factor_solve_flat", "tree_solve_flat",
              "tree_resid_terms_flat")
# the shapes tools/bench_tree.py times, (md, Nr, Nh): 31 nodes (the
# tree_mpc example), 71 (the reference's tree benchmark,
# test_d_tree_ip_hard_libstr.c:61-66), 255 (a full binary tree)
TREE_TOPOS = ((2, 2, 8), (2, 3, 10), (2, 7, 7))


def _tree_ops(NU, NX, n, n_ng, want_pi):
    """Operations per instance of rows 26-28 on an n-node tree (a
    multiply-add counts 2), from the loops of csrc/tree_sweeps.cu and
    csrc/tree_resid_terms.cu: {name: ops}."""
    NZ = NU + NX
    NT = NZ * (NZ + 1) // 2
    o = _stage_ops(NU, NX, 1, 0)
    chol = sum(2 + (NZ - j) + sum(2 * (NZ - jj) for jj in range(j + 1, NZ))
               for j in range(NZ))
    eupx = NU * NU + 2 * NX * NU
    fwd_z = NU + 2 * NU * NX + NU * NU + 2 * NX * NZ
    pi = 2 * NX * NX + NX
    # per node: dvec, the accumulator's M and m, chol, eu/px; per edge:
    # W = F Lxx, Pb, F (Pb + px), the packed W W' and the parent's RMW
    node = NZ + NT + NZ + chol + eupx
    edge = (NZ * NX * (NX + 1) + 2 * NX * NX + 2 * NZ * NX + NX
            + NT * 2 * NX + NT + NZ)
    factor = (n * (node + fwd_z) + (n - 1) * (edge + want_pi * pi)
              + o["root"] + n_ng * o["ng_factor"])
    solve = (n * (NZ + eupx + NU + fwd_z) + (n - 1) * (2 * NZ * NX + NX + NZ
                                                      + pi) + o["root"])
    resid = n * o["hz"] + (n - 1) * o["f_terms"]
    return dict(zip(TREE_NAMES, (factor, solve, resid)))


def _tree(torch, np, dev, card, reset_counts, read_counts, total,
          section_done, t_sec):
    """Sections T1-T3, the scenario tree at tools/bench_tree.py's width
    (``mass_spring_tree_qp(nx=4, nu=2)``, 4096 instances, ``b`` scaled by
    ``1 + 0.02 N(0,1)``, f32, ``IPMConfig(k_max=8, mu_tol=0,
    use_pallas=True)``): rows 26-28 vs their plain versions; the main path
    ``solve_batched_tree`` on the 71-node tree (counted from 0) against the
    f64 structured route and an f64 host check of ``tree_residuals``; a
    warm tree-RTI re-solve on the 31-node tree; the 255-node tree once;
    then ms per batch, a profile and each kernel alone.  Returns (the
    kernels-line entries of rows 26-28, t_sec)."""
    from hpmpc_tpu_torch.models import tree
    from hpmpc_tpu_torch.models.ipm import IPMConfig, _box_onehot
    from hpmpc_tpu_torch.ops import tree_kernel as tk
    from hpmpc_tpu_torch.parallel import batch as pbatch
    from hpmpc_tpu_torch.utils.mass_spring import mass_spring_tree_qp

    tscales = 1.0 + 0.02 * np.random.default_rng(SEED).standard_normal(B)

    def tree_batch(topo, dtype, ng_nodes=()):
        md, Nr, Nh = topo
        tdef, dims, qp = mass_spring_tree_qp(md=md, Nr=Nr, Nh=Nh, nx=4,
                                             nu=2, ng_nodes=ng_nodes,
                                             dtype=dtype, device=dev)
        qpb = pbatch.broadcast_qp(qp, B)
        sc = torch.as_tensor(tscales, dtype=dtype, device=dev)
        return tdef, dims, dataclasses.replace(qpb,
                                               b=qpb.b * sc[:, None, None])

    cfg_t = IPMConfig(k_max=8, mu_tol=0.0, use_pallas=True)
    mods = {n: tk for n in TREE_NAMES}
    targets = [(tk, n) for n in TREE_NAMES]
    path_names = TREE_NAMES + STEP_NAMES

    # ---- T1. rows 26-28 vs their plain versions, f32 and f64 ------------
    errs = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        tdef, dims, qpb = tree_batch(TREE_TOPOS[1], dtype, ng_nodes=(0, 5))
        if tdef.n_nodes != 71:
            _fail(f"the reference's tree has {tdef.n_nodes} nodes, not 71")
        e_ = {}
        for last in (False, True):
            what = (f"{name} tree 71 nodes, ng nodes (0, 5), "
                    f"{'last' if last else 'first'} call of k_max 8")
            with _capture(targets, last=last) as calls:
                tree.solve_tree_ipm_flat(tdef, dims, qpb, cfg_t)
            if len(calls) != 3:
                _fail(f"tree {what}: captured calls {sorted(calls)}")
            a, k = calls[("tree_factor_solve_flat", "")]
            # the WANT_PI form, which the flat engine does not run
            calls[("tree_factor_solve_flat", "want_pi")] = (
                a, dict(k, want_pi=True))
            _check_calls(torch, calls, mods, MEGA_TOL[name], what, e_)
            del calls
        if dtype == torch.float32:
            errs = e_
    t_sec = section_done("T1 tree kernels vs plain", t_sec)

    # ---- T2. the main path: solve_batched_tree, 71 nodes, f32 ------------
    tdef, dims, qpb = tree_batch(TREE_TOPOS[1], torch.float32)
    plain0 = dict(tk.PLAIN_CALLS)
    reset_counts()
    sol = pbatch.solve_batched_tree(tdef, dims, qpb, cfg_t)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = {n: total(counts[n]) for n in path_names}
    others = {n: v for n, v in counts.items()
              if total(v) and n not in launches}
    if min(launches.values()) < 1 or others or tk.PLAIN_CALLS != plain0:
        _fail(f"tree main path: launches {launches}, other kernels "
              f"{others}, plain calls {tk.PLAIN_CALLS} (before {plain0})")
    _check_solution(torch, sol, dims, cfg_t.k_max, "tree main path")
    status = torch.bincount(sol.status, minlength=3).tolist()
    print(f"tree main path (solve_batched_tree, md=2 Nr=3 Nh=10: 71 nodes, "
          f"f32, B={B}): launches {launches} (no other port kernel, no "
          f"plain call), mean kk {float(sol.kk.double().mean()):.3f}, status "
          f"counts {status}, max mu {float(sol.inf_norm_res[:, 3].max()):.3e}",
          flush=True)
    sub = torch.arange(0, B, B // ORACLE_SUBSAMPLE, device=dev)

    def pick64(x):
        x = x[sub]
        return x.double() if x.is_floating_point() else x

    q64 = type(qpb)(**{f.name: pick64(getattr(qpb, f.name))
                       for f in dataclasses.fields(qpb)})
    s64 = type(sol)(*[pick64(x) for x in sol])
    ref = tree.solve_tree_ipm(tdef, dims, q64, cfg_t)
    dz = _maxdiff(torch, s64.z, ref.z)
    du0 = _maxdiff(torch, s64.z[:, 0, :dims.NU], ref.z[:, 0, :dims.NU])
    same = bool(torch.equal(s64.status, ref.status))
    mu_scal = torch.tensor(1.0 / dims.n_constr, dtype=torch.float64,
                           device=dev)
    res = tree.tree_residuals(tdef, q64, _box_onehot(q64), mu_scal, s64.z,
                              s64.pi, s64.lam_b, s64.t_b, s64.lam_g,
                              s64.t_g, q64.b)

    def amax(x):
        return x.abs().flatten(1).amax(1)

    orc = torch.stack([amax(res.rq), amax(res.rb),
                       torch.maximum(amax(res.rd_b), amax(res.rd_g)),
                       res.mu], 1).cpu().numpy()
    eng = s64.inf_norm_res.cpu().numpy()
    print(f"tree main path vs the f64 structured route "
          f"({ORACLE_SUBSAMPLE} instances, kk {sorted(set(ref.kk.tolist()))}"
          f"): status equal {same}, max |dz| {dz:.3e}, max |du0| {du0:.3e} "
          f"(tol {TREE_TOL['z']:.0e}); f64 host tree_residuals: max |rq| "
          f"{orc[:, 0].max():.3e}, |rb| {orc[:, 1].max():.3e}, |rd| "
          f"{orc[:, 2].max():.3e}, mu {orc[:, 3].max():.3e}, max |oracle - "
          f"engine| {np.abs(orc - eng).max():.3e}", flush=True)
    if not same or dz > TREE_TOL["z"]:
        _fail("the tree main path disagrees with the f64 structured route")
    if (not np.all(np.isfinite(orc))
            or not np.allclose(orc, eng, rtol=1e-2, atol=1e-5)
            or orc[:, 1].max() > 1e-3 or orc[:, 2].max() > 1e-3):
        _fail("the tree main path's f64 residuals disagree with its own "
              "report or are too large")
    del ref, res, q64, s64

    # ---- T3. a warm tree-RTI re-solve (31 nodes) and the 255-node tree ---
    tdef31, dims31, q31 = tree_batch(TREE_TOPOS[0], torch.float32)
    cfg_c = IPMConfig(k_max=12, mu_tol=1e-4, use_pallas=True)
    cfg_w = dataclasses.replace(cfg_c, warm_start=True)
    cold = pbatch.solve_batched_tree(tdef31, dims31, q31, cfg_c)
    qw = dataclasses.replace(q31, b=q31.b * (1.0 + 1e-3))
    reset_counts()
    warm = pbatch.solve_batched_tree(tdef31, dims31, qw, cfg_w, z0=cold.z,
                                     pi0=cold.pi)
    torch.cuda.synchronize()
    counts = read_counts()
    ran = {n: total(v) for n, v in counts.items() if total(v)}
    kk_c, kk_w = float(cold.kk.double().mean()), float(warm.kk.double().mean())
    n_conv = int((warm.status == 0).sum())
    print(f"tree warm re-solve (31 nodes, f32, mu_tol 1e-4, b x 1.001 from "
          f"the cold solution): launches {ran}; mean kk cold {kk_c:.3f} "
          f"(converged {int((cold.status == 0).sum())}), warm {kk_w:.3f} "
          f"(converged {n_conv} of {B})", flush=True)
    if (set(ran) != set(path_names) or n_conv != B or not kk_w < kk_c):
        _fail("the warm tree re-solve left the flat engine or did not "
              "converge faster than the cold solve")
    tdef255, dims255, q255 = tree_batch(TREE_TOPOS[2], torch.float32)
    reset_counts()
    s255 = pbatch.solve_batched_tree(tdef255, dims255, q255, cfg_t)
    torch.cuda.synchronize()
    ran = {n: total(v) for n, v in read_counts().items() if total(v)}
    _check_solution(torch, s255, dims255, cfg_t.k_max, "tree 255 nodes")
    print(f"tree 255 nodes (md=2 Nr=7 Nh=7, f32, B={B}): launches {ran}, "
          f"mean kk {float(s255.kk.double().mean()):.3f}, status counts "
          f"{torch.bincount(s255.status, minlength=3).tolist()}, max mu "
          f"{float(s255.inf_norm_res[:, 3].max()):.3e}", flush=True)
    if set(ran) != set(path_names) or tdef255.n_nodes != 255:
        _fail("the 255-node tree left the flat engine")
    del cold, warm, s255
    t_sec = section_done("T2-T3 tree main path", t_sec)

    # ---- timings: ms per batch, a profile, each kernel alone -------------
    def tree_rep(td, d, q0, c):
        def run(r):
            q = dataclasses.replace(q0, b=q0.b * (1.0 + 1e-4 * r))
            return pbatch.solve_batched_tree(td, d, q, c)
        return run

    @contextlib.contextmanager
    def plain_tree():
        saved = [(n, getattr(tk, n)) for n in TREE_NAMES]
        for n, _ in saved:
            setattr(tk, n, getattr(tk, n + "_ref"))
        try:
            yield
        finally:
            for n, fn in saved:
                setattr(tk, n, fn)

    for topo in TREE_TOPOS:
        td, d, q0 = ((tdef, dims, qpb) if topo == TREE_TOPOS[1]
                     else tree_batch(topo, torch.float32))
        ms = _time_ms(torch, tree_rep(td, d, q0, cfg_t), reps=5)
        line = (f"tree main path [{card}], {td.n_nodes} nodes (md={topo[0]} "
                f"Nr={topo[1]} Nh={topo[2]}), f32, k_max 8: {ms:.3f} ms per "
                f"{B}-batch ({B / ms * 1e3:.1f} solves/s)")
        if topo == TREE_TOPOS[1]:
            with plain_tree():
                ms_p = _time_ms(torch, tree_rep(td, d, q0, cfg_t), reps=1,
                                warmup=0)
            ms_s = _time_ms(torch, tree_rep(
                td, d, q0, dataclasses.replace(cfg_t, use_pallas=False)),
                reps=2, warmup=0)
            line += (f"; plain versions {ms_p:.3f} ms; the structured "
                     f"route (use_pallas=False, solve_tree_ipm) {ms_s:.3f} "
                     "ms")
        print(line, flush=True)
    pr = _profile(torch, tree_rep(tdef, dims, qpb, cfg_t), reps=3)
    print(_profile_line("tree 71 nodes f32", card, pr), flush=True)

    # each kernel alone, on the main path's first calls (f32, 71 nodes)
    with _capture(targets) as calls:
        pbatch.solve_batched_tree(tdef, dims, qpb, cfg_t)
    ops = _tree_ops(dims.NU, dims.NX, tdef.n_nodes, 0, False)
    repl = {"tree_factor_solve_flat": "hpmpc_tpu/ops/tree_kernel.py:490",
            "tree_solve_flat": "hpmpc_tpu/ops/tree_kernel.py:570",
            "tree_resid_terms_flat": "hpmpc_tpu/ops/tree_kernel.py:614"}
    srcs = {"tree_factor_solve_flat": "tree_sweeps",
            "tree_solve_flat": "tree_sweeps",
            "tree_resid_terms_flat": "tree_resid_terms"}
    rows = []
    for name in TREE_NAMES:
        a, k = calls[(name, "")]
        fast, plain = getattr(tk, name), getattr(tk, name + "_ref")
        out = fast(*a, **k)
        nbytes = _nbytes(a, out)
        if name == "tree_solve_flat":   # Lxx: its lower triangle is read
            nbytes += _tril_nbytes(a[2], dims.NX) - _nbytes([a[2]])
        n_ops = B * ops[name]
        bound_ms, bound_by = _bound(nbytes, n_ops)
        ms = _time_ms(torch, lambda r: fast(*a, **k), reps=20)
        ms_p = _time_ms(torch, lambda r: plain(*a, **k), reps=2)
        print(f"{name} [{card}]: kernel {ms:.4f} ms, plain {ms_p:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, "
              f"{n_ops:.4e} ops; {bound_ms / ms:.2%} of bound) (float32, "
              f"B={B}, {tdef.n_nodes} nodes); launches on the main path "
              f"{launches[name]}", flush=True)
        rows.append({"name": name, "route": "cuda",
                     "source": f"hpmpc_tpu_torch/csrc/{srcs[name]}.cu",
                     "replaces": repl[name], "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": ms_p,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None})
    t_sec = section_done("T timings", t_sec)
    return rows, t_sec


# the fused sweeps (section S, HPMPC_FUSED_SWEEPS=1: rows 18 and 17).  Each
# fused kernel against its plain version (the same function as rows 9
# without pi and 10) on the 6-kernel loops' first and last calls of a
# TOL["k_max"]-iteration run, hard flagship (ng rows) and soft flagship, f32
# and f64: at MEGA_TOL on the first call; on the last, past the first
# iterate, the barrier conditioning amplifies any two summation orders
# (section 2), in f64 too at the hard flagship (PERF.md section 6, PR 11),
# so there the f32 kernel and its plain version are each held against the
# f64 plain version, as section 2 holds rows 14-16, and the f64 kernel
# against the plain version's own move on inputs moved by one ulp.
# Against rows 9 and 10 on the same inputs: the same sweep code with the
# eu/px slab elsewhere, so equal bit for bit; a difference (nvcc's FMA
# contraction) is printed and held to FUSED_TOL of the scale.  Each path
# under the switch against the same path without it: bit-equal where the
# kernels are, else equal kk and status and z within FUSED_TOL of its scale.
FUSED_TOL = {"float32": 1e-5, "float64": 1e-12}
FUSED_NAMES = ("factor_solve_folded_flat_fused", "solve_flat_fused")
#: each fused kernel's global-scratch twin (row 9 without pi, row 10)
UNFUSED_TWIN = {"factor_solve_folded_flat_fused": ("factor_solve_folded_flat",
                                                   dict(want_pi=False)),
                "solve_flat_fused": ("solve_flat", {})}


def _fused_sweeps(torch, np, dev, card, reset_counts, read_counts, total,
                  section_done, t_sec, cx):
    """Sections S1-S3, the fused sweeps under ``HPMPC_FUSED_SWEEPS=1``:
    rows 18 and 17 against their plain versions and rows 9 and 10; then,
    counted from 0, the soft main path (``solve_batched_soft`` at
    tools/bench_soft.py's flagship) and the hard paths (the lanes 6-kernel
    loop at the default tolerances, route E without ``iter_ref``, route D,
    the parity line), each against the f64 oracle and against the same path
    without the switch (``cx``: the main paths' data, configs and
    switch-off solutions); then each path's ms a batch with and without the
    switch and the two kernels alone beside rows 9 and 10.  Returns (the
    kernels-line entries of rows 18 and 17, t_sec)."""
    from hpmpc_tpu_torch.models import ipm_lanes, ipm_soft_lanes
    from hpmpc_tpu_torch.models.ipm import IPMConfig
    from hpmpc_tpu_torch.ops import stage_kernel as sk
    from hpmpc_tpu_torch.parallel import batch as pbatch

    mods = {n: sk for n in FUSED_NAMES}
    targets = [(sk, n) for n in FUSED_NAMES]
    bit_equal = True

    def vs_unfused(calls, tol, what):
        """Each captured fused call against its global-scratch twin on the
        same inputs: equal bit for bit, or within ``tol`` of the scale."""
        nonlocal bit_equal
        for (kname, _), (a, k) in sorted(calls.items()):
            twin, extra = UNFUSED_TWIN[kname]
            out_f = _flat(getattr(sk, kname)(*a, **k))
            out_u = _flat(getattr(sk, twin)(*a, **k, **extra))
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(out_f, out_u))
            rel = max(_maxdiff(torch, x, y) / max(1.0, float(y.abs().max()))
                      for x, y in zip(out_f, out_u))
            print(f"{kname} {what} vs {twin} on the same inputs: "
                  + ("equal bit for bit" if same else
                     f"max |d|/scale {rel:.3e} (tol {tol:.0e})"), flush=True)
            bit_equal &= same
            if rel > tol:
                _fail(f"{kname} {what} disagrees with {twin}")

    # ---- S1. rows 18 and 17 vs their plain versions and rows 9, 10 -------
    errs = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        K = TOL[name]["k_max"]
        dims, qpb = cx.flagship(dtype)
        soft_c = cx.soft_problem(dtype)
        runs = (
            ("hard flagship (ng rows)", lambda: ipm_lanes.solve_batched_lanes(
                dims, qpb, IPMConfig(k_max=K, use_pallas=True))),
            ("soft flagship", lambda: ipm_soft_lanes.solve_batched_soft_lanes(
                *soft_c[:3], IPMConfig(k_max=K, mu0=100.0, use_pallas=True),
                soft_c[3])))
        e_ = {}
        for label, run in runs:
            for last in (False, True):
                what = (f"{name} {label}, {'last' if last else 'first'} call "
                        f"of k_max {K}")
                with _env(HPMPC_MEGA_SWEEPS="0", HPMPC_FUSED_SWEEPS="1"), \
                        _capture(targets, last=last) as calls:
                    run()
                if len(calls) != 2:
                    _fail(f"fused sweeps {what}: captured calls "
                          f"{sorted(calls)}")
                if last and dtype == torch.float32:
                    _check_vs_f64(torch, calls, mods, COND_FACTOR,
                                  MEGA_TOL[name], what)
                elif last:
                    _check_vs_floor(torch, calls, mods, COND_FACTOR,
                                    MEGA_TOL[name], what)
                else:
                    _check_calls(torch, calls, mods, MEGA_TOL[name], what,
                                 e_)
                vs_unfused(calls, FUSED_TOL[name], what)
                del calls
        if dtype == torch.float32:
            errs = e_
        del soft_c
    t_sec = section_done("S1 fused sweeps vs plain and rows 9-10", t_sec)

    # ---- S2. the paths under the switch, counted from 0 --------------------
    steps = ("prep_flat", "alpha_sums_flat", "corr_geff_flat")
    soft_steps = ("soft_prep_flat", "soft_alpha_sums_flat", "soft_corr_flat")
    rows910 = ("factor_solve_folded_flat", "solve_flat")
    mega = ("factor_solve_mega", "solve_mega", "factor_solve_soft_mega",
            "solve_soft_mega")
    paths = (
        # label, run, oracle, switch-off solution, kernels it must launch,
        # kernels it must not
        ("soft path f32 (the slice's main path)",
         lambda: pbatch.solve_batched_soft(cx.dims_s, cx.qpb_s, cx.sb_s,
                                           cx.cfg_soft, idxbs=cx.idxbs_s),
         "soft", cx.sol_s6, soft_steps + FUSED_NAMES, rows910 + mega),
        ("lanes f32, 6-kernel loop, default tolerances",
         lambda: pbatch.solve_batched(cx.dims, cx.qpb, cx.cfg_lanes), "f32",
         None, steps + FUSED_NAMES + ("resid_full",),
         rows910 + mega + ("refine_flat_fused",)),
        ("route E f64, no refinement",
         lambda: pbatch.solve_batched(cx.dims64, cx.qpb64, cx.cfg_e0), "f64",
         cx.sol_e0, steps + FUSED_NAMES + ("resid_full",),
         rows910 + mega + UNFUSED + ("refine_flat_fused",)),
        ("route D f32", lambda: pbatch.solve_batched(cx.dims, cx.qpb,
                                                      cx.cfg_d), "f32",
         cx.sol_d, steps + ("factor_solve_folded_flat", "solve_flat_fused",
                            "resid_full") + UNFUSED,
         ("solve_flat", "factor_solve_folded_flat_fused",
                     "refine_flat_fused") + mega),
        ("parity path f32", lambda: pbatch.solve_batched(cx.dims, cx.qpb,
                                                          cx.cfg_par), "f32",
         cx.sol_p, ("ipm_resident", "resid_full") + steps
         + ("factor_solve_folded_flat", "solve_flat_fused",
            "refine_flat_fused"),
         ("solve_flat", "factor_solve_folded_flat_fused") + mega))
    launches, soft_calls = {}, None
    for label, run, oracle, ref, need, banned in paths:
        if ref is None:        # the lanes 6-kernel loop, without the switch
            with _env(HPMPC_MEGA_SWEEPS="0"):
                ref = run()
        reset_counts()
        with _env(HPMPC_MEGA_SWEEPS="0", HPMPC_FUSED_SWEEPS="1"), \
                _capture(targets) as calls:
            sol = run()
        torch.cuda.synchronize()
        counts = read_counts()
        lau = {n: total(counts[n]) for n in need + banned}
        if (min(lau[n] for n in need) < 1 or any(lau[n] for n in banned)
                or any(total(v) for n, v in counts.items()
                       if n not in lau and total(v))):
            _fail(f"{label} under the switch: launches "
                  f"{ {n: total(v) for n, v in counts.items() if total(v)} }"
                  f", must launch {need} and none of {banned}")
        launches[label] = {n: v for n, v in lau.items() if v}
        if oracle == "soft":
            soft_calls = calls
            _check_soft_solution(torch, sol, cx.dims_s, cx.NS,
                                 cx.cfg_soft.k_max, label)
            _soft_oracle(torch, cx.dims_s, cx.qpb_s, cx.sb_s, sol, 1e-3,
                         label)
        else:
            d_, q_ = ((cx.dims64, cx.qpb64) if oracle == "f64"
                      else (cx.dims, cx.qpb))
            _check_solution(torch, sol, d_, int(ref.stat.shape[1]), label)
            tol_o = (1e-6, 1e-9, 1e-6) if oracle == "f64" else (1e-2, 1e-5,
                                                                 1e-3)
            _oracle(torch, np, q_, sol, dev, *tol_o, label)
        same = all(torch.equal(x, y) for x, y in zip(sol, ref))
        dz = _maxdiff(torch, sol.z, ref.z) / max(1.0, float(ref.z.abs().max()))
        kk_eq = bool(torch.equal(sol.kk, ref.kk) and torch.equal(sol.status,
                                                                 ref.status))
        print(f"{label} under HPMPC_FUSED_SWEEPS=1: launches "
              f"{launches[label]}, status counts "
              f"{torch.bincount(sol.status, minlength=3).tolist()}; vs the "
              "same path without the switch: "
              + ("equal bit for bit" if same else
                 f"kk and status equal {kk_eq}, max |dz|/scale {dz:.3e}"),
              flush=True)
        tol = FUSED_TOL["float64" if oracle == "f64" else "float32"]
        if not same and (bit_equal or not kk_eq or dz > tol):
            _fail(f"{label}: the switch changes the answer")
        del sol, ref
    t_sec = section_done("S2 paths under the fused sweeps", t_sec)

    # ---- S3. ms a batch with and without the switch; the kernels alone ----
    def rep(run_q, q0, field):
        def run(r):
            return run_q(dataclasses.replace(
                q0, **{field: getattr(q0, field) * (1.0 + 1e-4 * r)}))
        return run

    timed = (
        ("soft path f32", rep(lambda q: pbatch.solve_batched_soft(
            cx.dims_s, q, cx.sb_s, cx.cfg_soft, idxbs=cx.idxbs_s), cx.qpb_s,
            "g"), 5),
        ("lanes f32, 6-kernel loop", rep(lambda q: pbatch.solve_batched(
            cx.dims, q, cx.cfg_lanes), cx.qpb, "b"), 5),
        ("route E f64, no refinement", rep(lambda q: pbatch.solve_batched(
            cx.dims64, q, cx.cfg_e0), cx.qpb64, "b"), 3),
        ("route D f32", rep(lambda q: pbatch.solve_batched(
            cx.dims, q, cx.cfg_d), cx.qpb, "b"), 5),
        ("parity path f32", rep(lambda q: pbatch.solve_batched(
            cx.dims, q, cx.cfg_par), cx.qpb, "b"), 5))
    for label, run, reps in timed:
        ms = {"0": [], "1": []}
        for sw in ("0", "1", "1", "0"):      # off, on, on, off
            with _env(HPMPC_MEGA_SWEEPS="0", HPMPC_FUSED_SWEEPS=sw):
                ms[sw].append(_time_ms(torch, run, reps=reps))
        on, off = sum(ms["1"]) / 2, sum(ms["0"]) / 2
        lk = next(k for k in launches if k.startswith(label))
        print(f"fused sweeps [{card}], {label}: {on:.3f} ms per {B}-batch "
              f"with HPMPC_FUSED_SWEEPS=1 ({ms['1'][0]:.3f}, "
              f"{ms['1'][1]:.3f}), {off:.3f} ms without ({ms['0'][0]:.3f}, "
              f"{ms['0'][1]:.3f}); launches per call under the switch "
              f"{launches[lk]}", flush=True)

    # rows 18 and 17 alone on the soft main path's first calls (f32), each
    # beside its global-scratch twin on the same inputs (twin, fused,
    # fused, twin)
    ops = _stage_ops(cx.dims_s.NU, cx.dims_s.NX, cx.dims_s.NB,
                     cx.dims_s.NG)
    NX = cx.dims_s.NX
    BS = B * (SOFT_N + 1)
    pi_ops = 2 * NX * NX + NX
    n_ops = {"factor_solve_folded_flat_fused":
             BS * (ops["factor_flat"] - pi_ops) + B * ops["root"],
             "solve_flat_fused": BS * ops["solve_flat"] + B * ops["root"]}
    repl = {"factor_solve_folded_flat_fused":
            "hpmpc_tpu/ops/stage_kernel.py:2162",
            "solve_flat_fused": "hpmpc_tpu/ops/stage_kernel.py:1947"}
    srcs = {"factor_solve_folded_flat_fused": "factor_solve_flat",
            "solve_flat_fused": "solve_flat"}
    main = launches[next(iter(launches))]
    rows = []
    for name in FUSED_NAMES:
        a, k = soft_calls[(name, "")]
        twin, extra = UNFUSED_TWIN[name]
        fast, plain = getattr(sk, name), getattr(sk, name + "_ref")
        slow = getattr(sk, twin)
        out = fast(*a, **k)
        nbytes = _nbytes(a, out)
        if name == "solve_flat_fused":     # Lxx: its lower triangle is read
            nbytes += _tril_nbytes(a[1], NX) - _nbytes([a[1]])
        bound_ms, bound_by = _bound(nbytes, n_ops[name])
        t_tw = [_time_ms(torch, lambda r: slow(*a, **k, **extra), reps=20)]
        ms = [_time_ms(torch, lambda r: fast(*a, **k), reps=20)
              for _ in range(2)]
        t_tw.append(_time_ms(torch, lambda r: slow(*a, **k, **extra),
                             reps=20))
        ms_k, ms_t = sum(ms) / 2, sum(t_tw) / 2
        ms_p = _time_ms(torch, lambda r: plain(*a, **k), reps=2)
        print(f"{name} [{card}]: kernel {ms_k:.4f} ms ({ms[0]:.4f}, "
              f"{ms[1]:.4f}), {twin} on the same inputs {ms_t:.4f} ms "
              f"({t_tw[0]:.4f}, {t_tw[1]:.4f}), plain {ms_p:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B, "
              f"{n_ops[name]:.4e} ops; {bound_ms / ms_k:.2%} of bound) "
              f"(float32, B={B}, N={SOFT_N}, the soft main path's first "
              f"call); launches on the main path {main[name]}", flush=True)
        rows.append({"name": name, "route": "cuda",
                     "source": f"hpmpc_tpu_torch/csrc/{srcs[name]}.cu",
                     "replaces": repl[name], "launches": main[name],
                     "max_abs_err": errs[name], "ms": ms_k,
                     "plain_ms": ms_p, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    t_sec = section_done("S3 fused sweeps timings", t_sec)
    return rows, t_sec


# the large-NZ band (section L).  Rows 24-25 against their plain versions
# on the card: random SPD matrices (A A' + n I, A standard normal: condition
# ~5), 64 of them at each n of LARGE_N, and one whose row and column 3 are
# zero, so the clamp catches its pivot (tiny in place of 0: L's column 3 is
# 0 where an unclamped 1/sqrt(0) would give NaN).  The kernel multiplies
# and subtracts in another rounding (nvcc contracts them into FMAs) and
# reads the lower triangle where the plain version reads the matrix, so the
# two agree to roundoff: a few n eps of L's scale (the plain versions
# against JAX on the CPU: 1e-12 in f64 at n <= 40), held at CHOL_TOL.  The
# main path (f32, k_max 8 at nx=64: mu ~13, far from the f32 floor) against
# the f64 and the f32 plain structured routes on 64 instances: equal kk and
# status, max |dz| below LARGE_TOL["z32"] (the plain versions on the CPU,
# 8 instances: 2.1e-5 against f64); in f64 against the f64 route: below
# LARGE_TOL["z64"] (CPU: 3.3e-14).  At nx=128 the problem's mu grows in
# f64 too (2.4 to 1.9e3 in 8 iterations) and f32 freezes after 4 on either
# backend, so the f64 comparison runs to the first freeze.
LARGE_N = (72, 144, 288)
CHOL_TOL = {"float32": 1e-4, "float64": 1e-12}
LARGE_TOL = dict(z32=1e-3, z64=1e-9)
# (nx, nu, B) of the band's main paths: tools/bench_size_sweep.py's rows
LARGE_SIZES = ((64, 8, 1024), (128, 16, 512))


def _band_oracle(torch, np, qpb, sol, dev, dtype, what):
    """The f64 host oracle (utils/resid64) on ORACLE_SUBSAMPLE instances of
    a band solve.  k_max 8 leaves nx=64 mid-path (mu ~13, |rb| ~1.9), so
    the primal residuals are not held small: the oracle's rb, rd and mu
    must agree with the engine's report (f32: rtol 1e-2, atol 1e-5; f64:
    1e-6, 1e-9) and its backward-error-relative rq stay below 1e-4
    (tools/bench_size_sweep.py's floor; the mid-path iterate's own rq is
    ~7e-7 of scale in either type on the CPU).  The engine's own
    rq is f32 cancellation noise of the dual magnitudes at this width
    (utils/resid64's module doc), so it is not compared."""
    from hpmpc_tpu_torch.utils.resid64 import true_residuals_sol

    Bn = sol.z.shape[0]
    sub = torch.arange(0, Bn, Bn // ORACLE_SUBSAMPLE, device=dev)
    qs = type(qpb)(**{f.name: getattr(qpb, f.name)[sub]
                      for f in dataclasses.fields(qpb)})
    res, rel = true_residuals_sol(qs, type(sol)(*[x[sub] for x in sol]))
    eng = sol.inf_norm_res[sub].double().cpu().numpy()
    f32 = dtype == torch.float32
    rtol, atol, rq_max = (1e-2, 1e-5, 1e-4) if f32 else (1e-6, 1e-9, 1e-4)
    print(f"{what}: f64 oracle ({len(sub)} instances): max |rq| "
          f"{res[:, 0].max():.3e} (relative {rel[:, 0].max():.3e}, limit "
          f"{rq_max:.0e}), |rb| {res[:, 1].max():.3e}, |rd| "
          f"{res[:, 2].max():.3e}, mu {res[:, 3].max():.3e}; max |oracle - "
          f"engine| over rb, rd, mu {np.abs(res - eng)[:, 1:].max():.3e}",
          flush=True)
    if (not np.all(np.isfinite(res)) or rel[:, 0].max() > rq_max
            or not np.allclose(res[:, 1:], eng[:, 1:], rtol=rtol,
                               atol=atol)):
        _fail(f"{what}: the f64 oracle disagrees")


def _chol_ops(n: int) -> float:
    """Operations of one n x n Cholesky in the table's convention: n^3/3
    multiply-adds, 2 operations each."""
    return 2.0 * n ** 3 / 3.0


def _large_nz(torch, np, dev, card, reset_counts, read_counts, total,
              section_done, t_sec):
    """Section L, the large-NZ band: rows 24-25 vs their plain versions at
    n = 72, 144, 288 (f32, f64); the main path ``solve_batched`` at nx=64
    nu=8 N=30 B=1024, f32, ``IPMConfig(k_max=8, mu_tol=0, alpha_min=1e-8,
    use_pallas=True)`` (tools/bench_size_sweep.py's config), counted from
    0, against the f64 plain structured route and the f64 host oracle; the
    same at nx=128 nu=16 B=512 and at nx=64 in f64; the soft problem at
    NZ=72 through ``solve_batched_soft``; then ms per batch, a profile
    and rows 24-25 alone beside their plain versions and the library.
    Returns (the kernels-line entries of rows 24-25, t_sec)."""
    from hpmpc_tpu_torch.models.ipm import IPMConfig
    from hpmpc_tpu_torch.ops import _build
    from hpmpc_tpu_torch.ops import batch_chol as bc
    from hpmpc_tpu_torch.parallel import batch as pbatch
    from hpmpc_tpu_torch.utils.mass_spring import (mass_spring_qp,
                                                   mass_spring_soft_qp)

    rng = np.random.default_rng(SEED)

    def spd(n, dtype, count=64, clamp=False):
        A = rng.standard_normal((count, n, n))
        M = A @ A.transpose(0, 2, 1) + n * np.eye(n)
        if clamp:
            M[:, 3, :] = 0.0
            M[:, :, 3] = 0.0
        return torch.as_tensor(M, dtype=dtype, device=dev)

    # ---- L1. rows 24-25 vs their plain versions, f32 and f64 ------------
    errs = {"cholesky": 0.0, "panel_factor": 0.0}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        for n in LARGE_N:
            for clamp in (False, True):
                M = spd(n, dtype, 1 if clamp else 64, clamp)
                pairs = [("cholesky", bc.cholesky(M), bc.cholesky_ref(M))]
                if not clamp:
                    for p in (8, 16):
                        P = M[:, :p, :p].contiguous()
                        pairs.append(("panel_factor", bc.panel_factor(P),
                                      bc.panel_factor_ref(P)))
                torch.cuda.synchronize()
                for kname, out_k, out_p in pairs:
                    out_k, out_p = _flat([out_k]), _flat([out_p])
                    if not all(bool(torch.isfinite(x).all()) for x in out_k):
                        _fail(f"{kname} n={n} {name}: non-finite output")
                    if not all(bool((torch.triu(x, 1) == 0).all())
                               for x in out_k):
                        _fail(f"{kname} n={n} {name}: upper part not 0")
                    dabs = max(_maxdiff(torch, x, y)
                               for x, y in zip(out_k, out_p))
                    rel = max(_maxdiff(torch, x, y)
                              / max(1.0, float(y.abs().max()))
                              for x, y in zip(out_k, out_p))
                    what = (f"{kname} n={n} {name}"
                            + (" (clamped pivot)" if clamp else "")
                            + (f" (p={out_k[0].shape[-1]})"
                               if kname == "panel_factor" else ""))
                    print(f"{what}: max|d| {dabs:.3e}, max |d|/scale "
                          f"{rel:.3e} (tol {CHOL_TOL[name]:.0e})", flush=True)
                    if rel > CHOL_TOL[name]:
                        _fail(f"{what} disagrees with its plain version")
                    if dtype == torch.float32:
                        errs[kname] = max(errs[kname], dabs)
                # row 25 inside the blocked Cholesky, against row 24's
                if not clamp and n == LARGE_N[0]:
                    Lb = bc.cholesky_blocked(M, p=8)
                    dl = _maxdiff(torch, Lb, pairs[0][2]) / float(
                        pairs[0][2].abs().max())
                    print(f"cholesky_blocked n={n} {name} (p=8) vs row 24's "
                          f"plain version: max |d|/scale {dl:.3e}",
                          flush=True)
                    if dl > CHOL_TOL[name]:
                        _fail("cholesky_blocked disagrees with row 24")
    t_sec = section_done("L1 rows 24-25 vs plain", t_sec)

    # ---- L2. the main path: solve_batched on the blocked band -----------
    cfg_l = IPMConfig(k_max=8, mu_tol=0.0, alpha_min=1e-8, use_pallas=True)
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        _fail("float32 matrix products are not pinned to full precision")

    def band_batch(nx, nu, Bn, dtype):
        dims, qp = mass_spring_qp(nx, nu, N_HORIZON, dtype=dtype, device=dev)
        qpb = pbatch.broadcast_qp(qp, Bn)
        sc = 1 + 0.02 * np.random.default_rng(SEED).standard_normal(Bn)
        return dims, dataclasses.replace(qpb, b=qpb.b * torch.as_tensor(
            sc, dtype=dtype, device=dev)[:, None, None])

    def counted(fn, what):
        """``fn()`` with the counters set to 0 just before and read just
        after: row 24 must run, no other kernel, no plain version."""
        plain0 = dict(bc.PLAIN_CALLS)
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        ran = {n: total(v) for n, v in counts.items() if total(v)}
        if set(ran) != {"cholesky"} or bc.PLAIN_CALLS != plain0:
            _fail(f"{what}: launches {ran}, plain calls {bc.PLAIN_CALLS} "
                  f"(before {plain0})")
        return out, ran["cholesky"]

    def finite(sol, what):
        for f in sol._fields:
            x = getattr(sol, f)
            if x.is_floating_point() and not bool(torch.isfinite(x).all()):
                _fail(f"{what}: solution field {f} is not finite")

    launches, sols = {}, {}
    for nx, nu, Bn in LARGE_SIZES:
        for dtype in ((torch.float32, torch.float64) if nx == 64
                      else (torch.float32,)):
            dname = str(dtype).split(".")[-1]
            what = f"band nx={nx} nu={nu} B={Bn} {dname}"
            dims, qpb = band_batch(nx, nu, Bn, dtype)
            eng = pbatch.select_engine(dims, cfg_l, Bn, dtype)
            if eng != "structured":
                _fail(f"{what}: select_engine chose {eng!r}")
            sol, n24 = counted(lambda: pbatch.solve_batched(dims, qpb, cfg_l),
                               what)
            finite(sol, what)
            if tuple(sol.z.shape) != (Bn, N_HORIZON + 1, dims.NZ):
                _fail(f"{what}: z has shape {tuple(sol.z.shape)}")
            shapes = f"NU{nu}_NX{nx}"
            built = [k for k in _build.PTXAS_LOG if shapes in k]
            if built:
                _fail(f"{what}: per-thread libraries built: {built}")
            sub = torch.arange(0, Bn, Bn // ORACLE_SUBSAMPLE, device=dev)

            def pick(q, dt_):
                return type(q)(**{f.name: getattr(q, f.name)[sub].to(dt_)
                                  if getattr(q, f.name).is_floating_point()
                                  else getattr(q, f.name)[sub]
                                  for f in dataclasses.fields(q)})

            # against the f64 plain route up to the first freeze (f32 at
            # nx=128 freezes after 4 iterations, on either backend: the
            # problem's mu grows in f64 too), and in f32 against the f32
            # plain route at the full budget
            K = int(sol.kk.min())
            solK = sol if K == cfg_l.k_max else pbatch.solve_batched(
                dims, qpb, dataclasses.replace(cfg_l, k_max=K))
            refs = [("f64", torch.float64, solK, K)]
            if dtype == torch.float32:
                refs.append(("f32", torch.float32, sol, cfg_l.k_max))
            tol = LARGE_TOL["z32" if dtype == torch.float32 else "z64"]
            for rname, rdt, mine, k_ in refs:
                ref = pbatch.solve_batched(dims, pick(qpb, rdt), dataclasses
                                           .replace(cfg_l, use_pallas=False,
                                                    k_max=k_))
                s_sub = type(mine)(*[x[sub] for x in mine])
                dz = _maxdiff(torch, s_sub.z, ref.z)
                same = (bool(torch.equal(s_sub.status, ref.status))
                        and bool(torch.equal(s_sub.kk, ref.kk)))
                print(f"{what} vs the {rname} plain structured route at k_max "
                      f"{k_} ({ORACLE_SUBSAMPLE} instances): kk and status "
                      f"equal {same}, max |dz| {dz:.3e} (tol {tol:.0e})",
                      flush=True)
                if not same or dz > tol:
                    _fail(f"{what} disagrees with the {rname} plain "
                          "structured route")
            print(f"{what} (solve_batched -> structured, blocked band): row "
                  f"24 launched {n24} times, no other kernel, no per-thread "
                  f"library at {shapes}; status counts "
                  f"{torch.bincount(sol.status.long(), minlength=3).tolist()}"
                  f", kk {int(sol.kk.min())}..{int(sol.kk.max())}, max mu "
                  f"{float(sol.inf_norm_res[:, 3].max()):.3e}", flush=True)
            _band_oracle(torch, np, qpb, sol, dev, dtype, what)
            launches[(nx, dname)] = n24
            sols[(nx, dname)] = (dims, qpb)
            del sol, solK, ref

    # the soft problem at NZ=72: solve_batched_soft -> "soft_structured"
    dims_s, qp_s, soft = mass_spring_soft_qp(64, 8, N_HORIZON, Z=10.0,
                                             dtype=torch.float32, device=dev)
    Bs = LARGE_SIZES[0][2]
    qps = pbatch.broadcast_qp(qp_s, Bs)
    sc = 1 + 0.02 * np.random.default_rng(SEED).standard_normal(Bs)
    qps = dataclasses.replace(qps, g=qps.g * torch.as_tensor(
        sc, dtype=torch.float32, device=dev)[:, None, None])
    sb = pbatch.broadcast_soft(soft, Bs)
    cfg_s = IPMConfig(k_max=8, mu0=100.0, mu_tol=0.0, use_pallas=True)
    idxbs = soft.idxbs.cpu().numpy()
    eng = pbatch.select_soft_engine(dims_s, cfg_s, torch.float32,
                                    soft.ns_mask.shape[-1], idxbs)
    if eng != "soft_structured":
        _fail(f"soft band: select_soft_engine chose {eng!r}")
    sol_s, n24s = counted(lambda: pbatch.solve_batched_soft(
        dims_s, qps, sb, cfg_s, idxbs=idxbs), "soft band")
    finite(sol_s, "soft band")
    print(f"soft band (mass_spring_soft_qp(64, 8, 30, Z=10), f32, B={Bs}, "
          f"solve_batched_soft -> soft_structured): row 24 launched {n24s} "
          f"times, no other kernel; status counts "
          f"{torch.bincount(sol_s.status.long(), minlength=3).tolist()}",
          flush=True)
    del sol_s
    t_sec = section_done("L2 large-NZ main paths", t_sec)

    # ---- L3. timings: ms per batch, a profile, rows 24-25 alone --------
    def band_rep(d, q0, c=cfg_l):
        def run(r):
            q = dataclasses.replace(q0, b=q0.b * (1.0 + 1e-4 * r))
            return pbatch.solve_batched(d, q, c)
        return run

    e2e = {}
    for key in ((64, "float32"), (128, "float32"), (64, "float64")):
        d, q0 = sols[key]
        ms = _time_ms(torch, band_rep(d, q0), reps=2)
        e2e[key] = ms
        print(f"main path band [{card}], nx={key[0]} nu={d.NU} N="
              f"{N_HORIZON} B={q0.b.shape[0]} {key[1]}, k_max 8: {ms:.3f} ms "
              f"per batch ({q0.b.shape[0] / ms * 1e3:.1f} solves/s)",
              flush=True)
    pr = _profile(torch, band_rep(*sols[(64, "float32")]), reps=1)
    print(_profile_line("band nx=64 f32", card, pr), flush=True)

    # row 24 alone on the main path's first Cholesky batch (f32); row 25's
    # panel kernel alone on that batch's first panel at cholesky_blocked's
    # default p=8, the first input cholesky_blocked gives it
    with _capture([(bc, "cholesky")]) as ccalls:
        pbatch.solve_batched(*sols[(64, "float32")],
                             dataclasses.replace(cfg_l, k_max=1))
    M = ccalls[("cholesky", "")][0][0]
    Bc, n = M.shape[0], M.shape[-1]
    P = M[:, :8, :8].contiguous()
    p = P.shape[-1]
    item = M.element_size()
    rows = []
    for kname, X, fast, plain, lib, nbytes, ops in (
            ("cholesky", M, lambda: bc.cholesky(M),
             lambda: bc.cholesky_ref(M), lambda: torch.linalg.cholesky(M),
             Bc * (n * (n + 1) // 2 + n * n) * item, Bc * _chol_ops(n)),
            # L and L^-1 written; n^3/3 + n^3/6 multiply-adds; no single
            # library call gives both (torch.linalg.cholesky gives L only)
            ("panel_factor", P, lambda: bc.panel_factor(P),
             lambda: bc.panel_factor_ref(P), None,
             Bc * (p * (p + 1) // 2 + 2 * p * p) * item, Bc * 1.0 * p ** 3)):
        bound_ms, bound_by = _bound(nbytes, ops)
        ms = _time_ms(torch, lambda r: fast(), reps=50)
        ms_p = _time_ms(torch, lambda r: plain(), reps=2)
        ms_l = None if lib is None else _time_ms(torch, lambda r: lib(),
                                                 reps=20)
        row24 = kname == "cholesky"
        # row 25 is ported and timed, not routed (as in JAX): 0 launches
        n_launch = launches[(64, "float32")] if row24 else 0
        print(f"{'row 24 (cholesky)' if row24 else 'row 25 (panel_factor)'}"
              f" [{card}]: {ms:.4f} ms, plain {ms_p:.4f} ms, library "
              f"{'none' if ms_l is None else f'{ms_l:.4f} ms'}, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B, {ops:.4e} ops; "
              f"{bound_ms / ms:.2%} of bound) (float32, {tuple(X.shape)}); "
              f"launches on the main path {n_launch}", flush=True)
        rows.append({"name": kname, "route": "cuda",
                     "source": "hpmpc_tpu_torch/csrc/batch_chol.cu",
                     "replaces": ("hpmpc_tpu/ops/batch_chol.py:243" if row24
                                  else "hpmpc_tpu/ops/batch_chol.py:153"),
                     "launches": n_launch,
                     "max_abs_err": errs[kname], "ms": ms, "plain_ms": ms_p,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": ms_l})
    # context: torch.linalg.cholesky on the panels (L without L^-1), and
    # the blocked Cholesky around row 25 (its trsm and syrk are
    # torch.matmul) beside row 24 on the same batch
    ms_pl = _time_ms(torch, lambda r: torch.linalg.cholesky(P), reps=20)
    ms_b = _time_ms(torch, lambda r: bc.cholesky_blocked(M, p=8), reps=10)
    print(f"torch.linalg.cholesky on row 25's panels {tuple(P.shape)} "
          f"[{card}]: {ms_pl:.4f} ms; cholesky_blocked(p=8) on "
          f"{tuple(M.shape)}: {ms_b:.4f} ms (row 24: {rows[0]['ms']:.4f} "
          f"ms)", flush=True)
    t_sec = section_done("L3 large-NZ timings", t_sec)
    return rows, t_sec


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

    from hpmpc_tpu_torch.models import (ipm, ipm_lanes, ipm_resident,
                                        ipm_soft_lanes)
    from hpmpc_tpu_torch.models.ipm import IPMConfig
    from hpmpc_tpu_torch.ocp import OCPDims
    from hpmpc_tpu_torch.ops import _build
    from hpmpc_tpu_torch.ops import batch_chol as bc
    from hpmpc_tpu_torch.ops import mega_kernel as mk
    from hpmpc_tpu_torch.ops import resident_kernel as rk
    from hpmpc_tpu_torch.ops import stage_kernel as sk
    from hpmpc_tpu_torch.ops import step_kernel as stk
    from hpmpc_tpu_torch.ops import tree_kernel as tk
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
            **{n: sk for n in STAGE_NAMES + STRUCT_NAMES + UNFUSED},
            "factor_solve_mega": mk, "solve_mega": mk,
            **{n: mk for n in SOFT_MEGA}}
    six = [(mods[n], n) for n in STEP_NAMES + STAGE_NAMES]
    soft_mega = [(mk, n) for n in SOFT_MEGA]
    soft_six = [(stk, n) for n in SOFT_STEP] + [
        (sk, "factor_solve_folded_flat"), (sk, "solve_flat")]
    struct_targets = [(sk, n) for n in STRUCT_NAMES[:2]]
    unfused = [(sk, n) for n in UNFUSED]

    # row 14's launches over the main paths' runs (sections 3-13): no
    # solver path runs it, so each run adds its count, 0, at the next reset
    row14_main = None

    def reset_counts():
        nonlocal row14_main
        if row14_main is not None:
            row14_main += sk.LAUNCHES["factor_solve_batched"]
        rk.LAUNCHES = 0
        stk.RESID_LAUNCHES = 0
        for d in (stk.LAUNCHES, mk.LAUNCHES):
            for v in d.values():
                v[:] = [0, 0]
        for d in (sk.LAUNCHES, mk.SOFT_LAUNCHES, stk.SOFT_LAUNCHES,
                  tk.LAUNCHES, bc.LAUNCHES):
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
        out.update(tk.LAUNCHES)
        out.update(bc.LAUNCHES)
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
             ("refine_flat", dict(d2, NG=dims.NG)), ("resid_terms_flat", d2),
             ("factor_solve_soft_mega", ds), ("solve_soft_mega", ds),
             ("soft_step_flat", dict(NZ=dims_s.NZ, NB=dims_s.NB, NS=NS)),
             ("factor_solve_folded", d2), ("solve_batched", d2),
             ("dense_ipm", {}),
             # the flat engine on the no-box chain of section I0
             ("step_flat", dict(NZ=6, NB=1)),
             ("factor_solve_flat", dict(NU=2, NX=4)),
             ("solve_flat", dict(NU=2, NX=4)),
             ("resid_full", dict(NU=2, NX=4, NB=1)),
             # the scenario tree (nx=4 nu=2: NZ=6, NB=2) of section T
             ("tree_sweeps", dict(NU=2, NX=4)),
             ("tree_resid_terms", dict(NU=2, NX=4)),
             ("step_flat", dict(NZ=6, NB=2)),
             # the large-NZ band of section L (n is runtime: one library)
             ("batch_chol", {})]
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
        # rows 16 and 15 on the structured kernel route's calls of its
        # second and third iterations (mid-solve iterates: the barrier
        # values in dvec and the ng term after accepted steps), row 14 on
        # the effective Hessian row 16 assembles there.  Each against its
        # plain version at MEGA_TOL, but float32 at the third iteration:
        # from there on the terminal equality block's barrier (P_N ~ 1e4)
        # amplifies any two float32 summation orders ~50x in z and pi
        # (4.5e-4 of pi's scale, kernel vs plain, on the card), so there
        # the kernel and its plain version are each held against the f64
        # plain version on the same inputs (_check_vs_f64)
        for it in (2, 3):
            with _capture(struct_targets, last=True) as calls:
                ipm.solve(dims, qpb, IPMConfig(k_max=it, use_pallas=True))
            if len(calls) != 2:
                _fail(f"structured {name}: captured calls {sorted(calls)}")
            a16 = calls[("factor_solve_folded", "")][0]
            calls[("factor_solve_batched", "")] = (
                (sk.whole_hessian(*a16[:4], dims.NZ),) + tuple(a16[4:]), {})
            what = f"{name} structured, iteration {it}"
            if dtype == torch.float32 and it == 3:
                _check_vs_f64(torch, calls, mods, COND_FACTOR,
                              MEGA_TOL[name], what)
            else:
                _check_calls(torch, calls, mods, MEGA_TOL[name], what, errs)
            del calls, a16
        if dtype == torch.float32:
            max_abs_err.update(errs)
    t_sec = section_done("2 kernels vs plain", t_sec)

    # ---- 3. main path 1: solve_batched, resident route, float32 ----------
    reset_counts()
    row14_main = 0
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

    # ---- D. the flat route, float32: bench.py's parity config without -----
    # iter_ref_mu_thr -> "flat", the lanes engine's flat form: the 6-kernel
    # loop with the unfused refinement (rows 3-5, 9, 10, 12, 11), never the
    # fused pass (row 13) or the mega kernels (rows 19-20)
    flat_need = STEP_NAMES + STAGE_NAMES[:2] + UNFUSED
    flat_banned = ("refine_flat_fused", "factor_solve_mega", "solve_mega")

    def flat_launches(what, counts_, need=flat_need, banned=flat_banned):
        """The launches of ``need`` + ``banned``; fails unless each of
        ``need`` ran and none of ``banned`` did."""
        out = {n: counts_[n] for n in need + banned}
        if (min(total(counts_[n]) for n in need) < 1
                or any(total(counts_[n]) for n in banned)):
            _fail(f"{what}: launches {out}")
        return out

    cfg_d = IPMConfig(k_max=8, mu_tol=0.0, alpha_min=1e-8, iter_ref=1,
                      use_pallas=True)
    engine_d = pbatch.select_engine(dims, cfg_d, B, torch.float32)
    if engine_d != "flat":
        _fail(f"route D: select_engine chose {engine_d!r}, expected 'flat'")
    reset_counts()
    with _capture(unfused) as d_calls:
        sol_d = pbatch.solve_batched(dims, qpb, cfg_d)
    torch.cuda.synchronize()
    launches_d = flat_launches("route D", read_counts())
    _check_solution(torch, sol_d, dims, cfg_d.k_max, "route D")
    err_d, med_d = ctrl_err(sol_d, ref64[cfg_d.k_max])
    print(f"route D f32: engine {engine_d}, launches {launches_d}, kk "
          f"histogram {torch.bincount(sol_d.kk.long()).tolist()}, status "
          f"counts {torch.bincount(sol_d.status, minlength=3).tolist()}, "
          f"control error vs f64 lanes (k_max={cfg_d.k_max}) max "
          f"{err_d:.3e} (median {med_d:.3e}; unrefined {err_r:.3e})",
          flush=True)
    _oracle(torch, np, qpb, sol_d, dev, 1e-2, 1e-5, 1e-3, "route D")
    # rows 12 and 11 vs their plain versions on the first refinement's
    # inputs (iteration 1: no iterate amplifies the two summation orders)
    errs_d = {}
    _check_calls(torch, d_calls, mods, MEGA_TOL["float32"],
                 "float32, route D's first refinement", errs_d)
    max_abs_err.update(errs_d)

    # ---- E. the flat route, float64, default tolerances --------------------
    cfg_e = IPMConfig(use_pallas=True, iter_ref=1)
    cfg_e0 = IPMConfig(use_pallas=True)
    for c_ in (cfg_e, cfg_e0):
        if pbatch.select_engine(dims64, c_, B, torch.float64) != "flat":
            _fail("route E: select_engine did not choose 'flat'")
    reset_counts()
    with _phase_watch(stk) as phase, _capture(
            unfused, when=lambda: phase["phase2"]) as e_calls:
        sol_e = pbatch.solve_batched(dims64, qpb64, cfg_e)
    torch.cuda.synchronize()
    launches_e = flat_launches("route E", read_counts())
    if min(launches_e[n][1] for n in STEP_NAMES) < 1:
        _fail(f"route E skipped phase 2: launches {launches_e}")
    reset_counts()
    sol_e0 = pbatch.solve_batched(dims64, qpb64, cfg_e0)
    torch.cuda.synchronize()
    launches_e0 = flat_launches("route E without refinement", read_counts(),
                                need=STEP_NAMES + STAGE_NAMES[:2],
                                banned=flat_banned + UNFUSED)
    # every instance converges with refinement; without it, as the f64
    # lanes engine's mega route (section 5), at least 99%
    for sol_, c_, what, lau, need_conv in (
            (sol_e, cfg_e, "route E f64", launches_e, B),
            (sol_e0, cfg_e0, "route E f64, no refinement", launches_e0,
             0.99 * B)):
        _check_solution(torch, sol_, dims64, c_.k_max, what)
        n_conv = int(((sol_.status == 0)
                      & (sol_.inf_norm_res[:, 3] <= 1e-8)).sum())
        print(f"{what}: launches {lau}, kk histogram "
              f"{torch.bincount(sol_.kk.long()).tolist()}, status counts "
              f"{torch.bincount(sol_.status, minlength=3).tolist()}, "
              f"{n_conv}/{B} at status 0 with mu <= 1e-8", flush=True)
        if n_conv < need_conv:
            _fail(f"{what}: {B - n_conv} instances did not converge")
        _oracle(torch, np, qpb64, sol_, dev, 1e-6, 1e-9, 1e-6, what)
    _check_calls(torch, e_calls, mods, MEGA_TOL["float64"],
                 "float64, route E's first phase-2 refinement", {})
    if len(e_calls) != 2:
        _fail(f"route E: captured phase-2 calls {sorted(e_calls)}")

    # ---- F. the parity route with the flat stage 2, float32; the f64 -------
    # lanes engine with the unfused refinement against the fused one.  Its
    # control error is held as section 6 holds the parity path's: max (and
    # median) below the unrefined route's.  The max is decided by the few
    # f32 instances whose trajectory a summation order moves near the f32
    # floor (ROADMAP Queue 3, "The parity line at N=30"), so the route is
    # also held against the lanes stage 2 (the fused refinement, the same
    # arithmetic in another order) beside the flat stage 2 without
    # refinement: the refinement must move the flat stage 2 to the lanes
    # stage 2's answer
    reset_counts()
    with _env(HPMPC_STAGE2_LANES="0"):
        sol_f = pbatch.solve_batched(dims, qpb, cfg_par)
    torch.cuda.synchronize()
    counts = read_counts()
    launches_f = flat_launches("route F", counts)
    if counts["ipm_resident"] != 1:
        _fail("route F: stage 1 did not run the resident kernel once")
    _check_solution(torch, sol_f, dims, cfg_par.k_max, "route F")
    err_f, med_f = ctrl_err(sol_f, ref64[cfg_par.k_max])
    print(f"route F f32 (parity, flat stage 2): launches {launches_f}, kk "
          f"histogram {torch.bincount(sol_f.kk.long()).tolist()}, control "
          f"error vs f64 lanes (k_max={cfg_par.k_max}) max {err_f:.3e} "
          f"(median {med_f:.3e}); lanes stage 2 {err_p:.3e} ({med_p:.3e}), "
          f"unrefined {err_r:.3e} ({med_r:.3e})", flush=True)
    if not (err_f < err_r and med_f < med_r):
        _fail(f"route F: refined control error max {err_f:.3e} / median "
              f"{med_f:.3e} is not below the unrefined {err_r:.3e} / "
              f"{med_r:.3e}")
    with _env(HPMPC_STAGE2_LANES="0"):
        sol_f0 = pbatch._solve_two_stage(
            dims, qpb, dataclasses.replace(cfg_par, iter_ref=0),
            "two_stage_resident", None, None)

    # per instance max |du| against the lanes stage 2; "moved": the
    # instances on which the refinement changes the answer (the flat stage
    # 2 without it differs from the lanes stage 2 there).  A refinement
    # that did nothing would leave route F equal to sol_f0 on them
    du_f, du_f0 = ((s_.z[..., :NU] - sol_p.z[..., :NU]).abs().amax((1, 2))
                   .double() for s_ in (sol_f, sol_f0))
    moved = du_f0 > 0
    n_moved = int(moved.sum())
    same_f, same_f0 = (float((s_.kk == sol_p.kk).double().mean())
                       for s_ in (sol_f, sol_f0))
    mdu_f, mdu_f0 = ((float(d[moved].median()) if n_moved else float("nan"))
                     for d in (du_f, du_f0))
    err_f0, med_f0 = ctrl_err(sol_f0, ref64[cfg_par.k_max])
    print(f"route F f32 vs the lanes stage 2 (fused refinement): kk equal "
          f"on {same_f:.4f} of the instances (the flat stage 2 without "
          f"refinement: {same_f0:.4f}); on the {n_moved} instances the "
          f"refinement moves, median max|du| {mdu_f:.3e} (without "
          f"refinement {mdu_f0:.3e}); control error without refinement max "
          f"{err_f0:.3e} (median {med_f0:.3e})", flush=True)
    if not (n_moved and same_f > same_f0 and mdu_f < 0.5 * mdu_f0):
        _fail("route F: the flat stage 2's refinement does not take it to "
              "the lanes stage 2's answer")
    del sol_f0
    _oracle(torch, np, qpb, sol_f, dev, 1e-2, 1e-5, 1e-3, "route F")
    reset_counts()
    with _env(HPMPC_FUSED_REFINE="0"):
        sol_u64 = ipm_lanes.solve_batched_lanes(dims64, qpb64, cfg_ref64)
    torch.cuda.synchronize()
    launches_u = flat_launches("route F, unfused refinement f64",
                               read_counts())
    if not (torch.equal(sol_u64.kk, sol_r64.kk)
            and torch.equal(sol_u64.status, sol_r64.status)):
        _fail("route F f64: the unfused refinement changes kk or status")
    dz_u = _maxdiff(torch, sol_u64.z, sol_r64.z) / max(
        1.0, float(sol_r64.z.abs().max()))
    print(f"route F f64 (lanes, HPMPC_FUSED_REFINE=0): launches {launches_u};"
          f" vs the fused refinement (row 13): kk and status equal, max "
          f"|dz|/scale {dz_u:.3e} (tol 1e-10)", flush=True)
    # the comparison's noise floor: the fused run on b moved by one ulp
    sol_e64 = ipm_lanes.solve_batched_lanes(
        dims64, dataclasses.replace(qpb64, b=qpb64.b * (1.0 + 2.0 ** -52)),
        cfg_ref64)
    dz_e = _maxdiff(torch, sol_e64.z, sol_r64.z) / max(
        1.0, float(sol_r64.z.abs().max()))
    print(f"route F f64: the fused refinement on b * (1 + 2^-52) against "
          f"b: max |dz|/scale {dz_e:.3e} (the floor any change of rounding "
          "meets)", flush=True)
    if dz_u > 1e-10:
        _fail("route F f64: the unfused refinement disagrees with the fused")
    del sol_u64, sol_e64
    t_sec = section_done("D-F flat routes", t_sec)

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

    # ---- 10. main path 8: the soft engine in float64, to mu <= 1e-8, on ----
    # its mega route (the f64 batch's dispatch, "soft_flat", takes the
    # 6-kernel loop: route H)
    dims_s64, qpb_s64, sb_s64, _ = soft_problem(torch.float64)
    reset_counts()
    with _env(HPMPC_MEGA_SWEEPS="1"):
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

    # ---- G. the structured soft route: tools/bench_soft.py's problem and ---
    # config without use_pallas -> "soft_structured", the batch-native
    # ipm_soft.solve on the plain batched Riccati (no kernel), f32 and f64
    cfg_g = IPMConfig(k_max=8, mu0=100.0, mu_tol=0.0)
    cfg_g64 = IPMConfig(k_max=30, mu0=100.0)

    def route_g(d_, q_, s_, c_, what, idxbs=idxbs_s, need=()):
        """One solve_batched_soft with the counters reset just before and
        read just after: it launches exactly the kernels ``need``."""
        if pbatch.select_soft_engine(d_, c_, q_.dtype, NS,
                                     idxbs) != "soft_structured":
            _fail(f"{what}: select_soft_engine did not choose "
                  "'soft_structured'")
        plain0 = dict(sk.PLAIN_CALLS)
        reset_counts()
        sol_ = pbatch.solve_batched_soft(d_, q_, s_, c_, idxbs=idxbs)
        torch.cuda.synchronize()
        ran = {n: v for n, v in read_counts().items() if total(v)}
        if set(ran) != set(need) or sk.PLAIN_CALLS != plain0:
            _fail(f"{what}: launches {ran}, expected {need}")
        _check_soft_solution(torch, sol_, d_, NS, c_.k_max, what)
        print(f"{what}: engine soft_structured, launches {ran}, kk histogram"
              f" {torch.bincount(sol_.kk.long()).tolist()}, status counts "
              f"{torch.bincount(sol_.status, minlength=3).tolist()}",
              flush=True)
        return sol_

    for d_, q_, s_ in ((dims_s, qpb_s, sb_s), (dims_s64, qpb_s64, sb_s64)):
        what = f"route G {str(q_.dtype).split('.')[-1]}"
        _soft_oracle(torch, d_, q_, s_, route_g(d_, q_, s_, cfg_g, what),
                     1e-3, what)
    sol_g64 = route_g(dims_s64, qpb_s64, sb_s64, cfg_g64,
                      "route G f64, mu_tol 1e-8")
    conv_g = float((sol_g64.status == 0).double().mean())
    print(f"route G f64, mu_tol 1e-8: converged {conv_g:.4f}", flush=True)
    if conv_g < 0.99:
        _fail("route G f64: fewer than 99% of instances converged")
    mu_g = _soft_oracle(torch, dims_s64, qpb_s64, sb_s64, sol_g64, 1e-6,
                        "route G f64, mu_tol 1e-8")
    if mu_g > 1e-8:
        _fail(f"route G f64: oracle mu {mu_g:.3e} > 1e-8")
    del sol_g64
    # the kernel backend (use_pallas without idxbs: rows 16/15) against the
    # plain one, f64 at k_max=6 (ROADMAP Queue 3, "Soft multipliers")
    cfg_gk = IPMConfig(k_max=6, mu0=100.0, mu_tol=0.0, use_pallas=True)
    sol_gk = route_g(dims_s64, qpb_s64, sb_s64, cfg_gk,
                     "route G f64, kernel backend, k_max=6", idxbs=None,
                     need=STRUCT_NAMES[:2])
    sol_gp = route_g(dims_s64, qpb_s64, sb_s64,
                     dataclasses.replace(cfg_gk, use_pallas=False),
                     "route G f64, plain backend, k_max=6", idxbs=None)
    if not (torch.equal(sol_gk.kk, sol_gp.kk)
            and torch.equal(sol_gk.status, sol_gp.status)):
        _fail("route G f64 (k_max=6): the kernel backend's kk/status differ")
    dz_g = _maxdiff(torch, sol_gk.z, sol_gp.z) / max(
        1.0, float(sol_gp.z.abs().max()))
    print(f"route G f64, k_max=6: kernel vs plain backend: kk and status "
          f"equal, max |dz|/scale {dz_g:.3e} (tol 1e-8)", flush=True)
    if dz_g > 1e-8:
        _fail("route G f64 (k_max=6): the kernel backend disagrees")
    del sol_gk, sol_gp

    # ---- H. the f64 soft batch through solve_batched_soft: "soft_flat", ----
    # the soft lanes engine's 6-kernel loop, to mu <= 1e-8
    engine_h = pbatch.select_soft_engine(dims_s64, cfg_soft64, torch.float64,
                                         NS, idxbs_s)
    if engine_h != "soft_flat":
        _fail(f"route H: select_soft_engine chose {engine_h!r}")
    reset_counts()
    sol_h = pbatch.solve_batched_soft(dims_s64, qpb_s64, sb_s64, cfg_soft64,
                                      idxbs=idxbs_s)
    torch.cuda.synchronize()
    launches_h = flat_launches(
        "route H", read_counts(), need=SOFT_STEP + STAGE_NAMES[:2],
        banned=SOFT_MEGA)
    _check_soft_solution(torch, sol_h, dims_s64, NS, cfg_soft64.k_max,
                         "route H")
    conv_h = float((sol_h.status == 0).double().mean())
    same = sol_h.kk == sol_s64.kk
    dz_h = (float((sol_h.z - sol_s64.z)[same].abs().max())
            if bool(same.any()) else float("nan"))
    print(f"route H f64: engine {engine_h}, launches {launches_h}, mean kk "
          f"{float(sol_h.kk.double().mean()):.3f}, converged {conv_h:.4f}; "
          f"vs the mega route (section 10): kk equal on {int(same.sum())} "
          f"of {B}, max |dz| {dz_h:.3e} there", flush=True)
    if conv_h < 0.99 or int(same.sum()) < 0.99 * B:
        _fail("route H: fewer than 99% converged or agree with the mega "
              "route on kk")
    mu_h = _soft_oracle(torch, dims_s64, qpb_s64, sb_s64, sol_h, 1e-6,
                        "route H f64")
    if mu_h > 1e-8:
        _fail(f"route H: oracle mu {mu_h:.3e} > 1e-8")
    del sol_h
    t_sec = section_done("G-H soft routes", t_sec)

    # ---- 11. main path 9: the structured route A, IPMConfig() ------------
    # the library's default config: no use_pallas -> "structured" on the
    # plain batched Riccati, in both types; it launches no kernel
    cfg_def = IPMConfig()
    sols_a = {}
    for d_, q_ in ((dims, qpb), (dims64, qpb64)):
        dt_ = q_.dtype
        what = f"route A {str(dt_).split('.')[-1]}"
        if pbatch.select_engine(d_, cfg_def, B, dt_) != "structured":
            _fail(f"{what}: select_engine did not choose 'structured'")
        reset_counts()
        sol_ = pbatch.solve_batched(d_, q_, cfg_def)
        torch.cuda.synchronize()
        if any(total(v) for v in read_counts().values()):
            _fail(f"{what} launched a kernel: {read_counts()}")
        _check_solution(torch, sol_, d_, cfg_def.k_max, what)
        mu_f = sol_.inf_norm_res[:, 3]
        print(f"{what}: status counts (converged, max-iter, frozen) "
              f"{torch.bincount(sol_.status, minlength=3).tolist()}, kk "
              f"histogram {torch.bincount(sol_.kk.long()).tolist()}, mu "
              f"{float(mu_f.min()):.3e}..{float(mu_f.max()):.3e}",
              flush=True)
        sols_a[dt_] = sol_
    if not bool((sols_a[torch.float64].status == 0).all()):
        _fail("route A f64: not every instance converged")
    _oracle(torch, np, qpb64, sols_a[torch.float64], dev, 1e-6, 1e-9, 1e-6,
            "route A f64")

    # ---- 12. main path 10: the structured route B, the kernel backend ----
    # use_pallas on dims without a static idxb: "structured" (the JAX
    # rule), each factorization one launch of row 16, each re-solve one of
    # row 15
    cfg_b = IPMConfig(use_pallas=True)
    dims_n = dataclasses.replace(dims, idxb=None)
    dims64_n = dataclasses.replace(dims64, idxb=None)
    if pbatch.select_engine(dims_n, cfg_b, B, torch.float32) != "structured":
        _fail("route B: select_engine did not choose 'structured'")
    # f64 at k_max=6 against route A (deeper runs amplify the two
    # summation orders through the ngN=8 block, ROADMAP Queue 3)
    sol_b6 = pbatch.solve_batched(dims64_n, qpb64,
                                  dataclasses.replace(cfg_b, k_max=6))
    sol_a6 = pbatch.solve_batched(dims64, qpb64, IPMConfig(k_max=6))
    if not (torch.equal(sol_b6.kk, sol_a6.kk)
            and torch.equal(sol_b6.status, sol_a6.status)):
        _fail("route B f64 (k_max=6): kk/status differ from route A")
    dz_ab = _maxdiff(torch, sol_b6.z, sol_a6.z) / max(
        1.0, float(sol_a6.z.abs().max()))
    print(f"route B vs route A, f64, k_max=6: kk and status equal, max "
          f"|dz|/scale {dz_ab:.3e} (tol 1e-8)", flush=True)
    if dz_ab > 1e-8:
        _fail("route B f64 (k_max=6) disagrees with route A")
    del sol_b6, sol_a6

    def route_b(d_, q_, what, capture=False):
        """One route-B solve with the counters reset just before and read
        just after; no plain version may run."""
        plain0 = dict(sk.PLAIN_CALLS)
        reset_counts()
        with _capture(struct_targets if capture else []) as calls_:
            sol_ = pbatch.solve_batched(d_, q_, cfg_b)
        torch.cuda.synchronize()
        launches_ = {n: read_counts()[n] for n in STRUCT_NAMES[:2]}
        if min(launches_.values()) < 1 or sk.PLAIN_CALLS != plain0:
            _fail(f"{what}: launches {launches_}, plain calls "
                  f"{ {n: sk.PLAIN_CALLS[n] - plain0[n] for n in plain0} }")
        others = {n: v for n, v in read_counts().items()
                  if n not in STRUCT_NAMES[:2] and total(v)}
        if others:
            _fail(f"{what} launched other kernels: {others}")
        _check_solution(torch, sol_, d_, cfg_b.k_max, what)
        mu_f = sol_.inf_norm_res[:, 3]
        print(f"{what}: engine structured, launches {launches_}, status "
              f"counts (converged, max-iter, frozen) "
              f"{torch.bincount(sol_.status, minlength=3).tolist()}, kk "
              f"histogram {torch.bincount(sol_.kk.long()).tolist()}, mu "
              f"{float(mu_f.min()):.3e}..{float(mu_f.max()):.3e}",
              flush=True)
        return sol_, launches_, calls_

    sol_b64, _, _ = route_b(dims64_n, qpb64, "route B f64")
    n_conv = int((sol_b64.status == 0).sum())
    print(f"route B f64: {n_conv}/{B} at status 0", flush=True)
    if n_conv != B:
        _fail(f"route B f64: {B - n_conv} instances did not converge")
    _oracle(torch, np, qpb64, sol_b64, dev, 1e-6, 1e-9, 1e-6, "route B f64")
    sol_b32, launches_b, struct_calls = route_b(dims_n, qpb, "route B f32",
                                                capture=True)
    _oracle(torch, np, qpb, sol_b32, dev, 1e-2, 1e-5, 1e-3, "route B f32")

    # ---- 13. main path 11: route C, escalate_stalled, float32 ------------
    # the lanes engine solves the batch; every instance with status != 0
    # is re-solved in f64 on route A and merged back
    cfg_c = IPMConfig(use_pallas=True, escalate_stalled=True)

    def route_c(cfg_e, what, mixed):
        """One escalated solve with the counters reset just before and read
        just after, held against the same solve without escalation: the
        converged instances keep their bits, the stalled ones converge;
        with ``mixed`` the f32 stage must leave some, not all, stalled."""
        cfg_e0 = dataclasses.replace(cfg_e, escalate_stalled=False)
        if pbatch.select_engine(dims, cfg_e0, B, torch.float32) != "lanes":
            _fail(f"{what}: the f32 stage does not go to the lanes engine")
        sol_0 = pbatch.solve_batched(dims, qpb, cfg_e0)
        reset_counts()
        sol_ = pbatch.solve_batched(dims, qpb, cfg_e)
        torch.cuda.synchronize()
        counts_ = read_counts()
        launches_ = {n: counts_[n] for n in ("factor_solve_mega",
                                             "solve_mega", "resid_full")}
        if min(total(v) for v in launches_.values()) < 1:
            _fail(f"{what} skipped a kernel: launches {launches_}")
        _check_solution(torch, sol_, dims, cfg_e.k_max, what)
        stalled = sol_0.status != 0
        n_st = int(stalled.sum())
        if mixed and not 0 < n_st < B:
            _fail(f"{what}: the f32 stage left {n_st} of {B} instances "
                  "stalled; the check needs a mixed batch")
        for f in sol_._fields:
            if not torch.equal(getattr(sol_, f)[~stalled],
                               getattr(sol_0, f)[~stalled]):
                _fail(f"{what} changed converged instances' {f}")
        if not bool((sol_.status[stalled] == 0).all()):
            _fail(f"{what}: a re-solved instance did not converge")
        print(f"{what} f32: launches {launches_}; status counts (converged, "
              f"max-iter, frozen) before escalation "
              f"{torch.bincount(sol_0.status, minlength=3).tolist()}, after "
              f"{torch.bincount(sol_.status, minlength=3).tolist()}; {n_st} "
              f"re-solved in f64, {B - n_st} converged instances unchanged "
              f"bit for bit; max mu after "
              f"{float(sol_.inf_norm_res[:, 3].max()):.3e}", flush=True)
        _oracle(torch, np, qpb, sol_, dev, 1e-2, 1e-5, 1e-3, what)

    route_c(cfg_c, "route C", mixed=False)
    # the same on a batch that the f32 stage converges in part (mu_tol
    # 5e-5 above the f32 floor's low end, mu_switch 1e-3 above mu_tol so
    # that the lanes engine keeps it), so that the per-instance merge runs
    # at the flagship size
    route_c(dataclasses.replace(cfg_c, mu_tol=5e-5, mu_switch=1e-3),
            "route C, mixed batch", mixed=True)
    reset_counts()
    launches_14, row14_main = row14_main, None
    print(f"row 14 (factor_solve_batched) launches over the main paths: "
          f"{launches_14}", flush=True)
    t_sec = section_done("11-13 structured routes", t_sec)

    # ---- S. the fused sweeps (rows 18 and 17) ---------------------------
    fused_rows, t_sec = _fused_sweeps(
        torch, np, dev, card, reset_counts, read_counts, total, section_done,
        t_sec, types.SimpleNamespace(
            flagship=flagship, soft_problem=soft_problem, dims=dims, qpb=qpb,
            dims64=dims64, qpb64=qpb64, dims_s=dims_s, qpb_s=qpb_s,
            sb_s=sb_s, idxbs_s=idxbs_s, NS=NS, cfg_lanes=cfg_lanes,
            cfg_e0=cfg_e0, cfg_d=cfg_d, cfg_par=cfg_par, cfg_soft=cfg_soft,
            sol_p=sol_p, sol_d=sol_d, sol_e0=sol_e0, sol_s6=sol_s6))

    # ---- I-K. the public API and the dense latency tick (row 23) ---------
    row23, t_sec = _api_and_dense(torch, np, dev, card, repo, reset_counts,
                                  read_counts, total, section_done, t_sec)

    # ---- T. the scenario tree (rows 26-28) --------------------------------
    tree_rows, t_sec = _tree(torch, np, dev, card, reset_counts, read_counts,
                             total, section_done, t_sec)

    # ---- L. the large-NZ band (rows 24-25) -------------------------------
    band_rows, t_sec = _large_nz(torch, np, dev, card, reset_counts,
                                 read_counts, total, section_done, t_sec)

    # ---- 14. timings --------------------------------------------------------
    def solve_rep(q0, d, c, fn, field="b"):
        def run(r):
            q = dataclasses.replace(
                q0, **{field: getattr(q0, field) * (1.0 + 1e-4 * r)})
            return fn(d, q, c)
        return run

    def soft_solve(d, q, c):
        sb = sb_s if q.dtype == torch.float32 else sb_s64
        return pbatch.solve_batched_soft(d, q, sb, c, idxbs=idxbs_s)

    def soft_lanes(d, q, c):
        return ipm_soft_lanes.solve_batched_soft_lanes(d, q, sb_s64, c,
                                                       idxbs_s)

    def with_env(fn, **env):
        """``fn`` with the environment variables ``env`` set for the
        duration of each call."""
        def call(d, q, c):
            with _env(**env):
                return fn(d, q, c)
        return call

    def six_kernel_loop(fn):
        """``fn`` with the lanes engines on their 6-kernel loop."""
        return with_env(fn, HPMPC_MEGA_SWEEPS="0")

    def mega_route(fn):
        """``fn`` with the lanes engines on their mega route."""
        return with_env(fn, HPMPC_MEGA_SWEEPS="1")

    @contextlib.contextmanager
    def plain_kernels():
        """Every kernel wrapper of the port replaced by its plain version."""
        swaps = [(rk, "ipm_resident"), (stk, "resid_full"),
                 (mk, "factor_solve_mega"), (mk, "solve_mega"), *six,
                 *soft_mega, *soft_six[:3], *struct_targets, *unfused]
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
            # the soft lanes engine's two routes side by side, f32 and f64
            # (the f64 batch's dispatch, "soft_flat", is route H)
            ("soft f32, mega", qpb_s, dims_s, cfg_soft,
             mega_route(soft_solve), 5, 1, "g"),
            ("soft f32, 6-kernel loop", qpb_s, dims_s, cfg_soft,
             six_kernel_loop(soft_solve), 5, 1, "g"),
            ("soft f64, mega", qpb_s64, dims_s64, cfg_soft64,
             mega_route(soft_lanes), 3, 0, "g"),
            ("soft f64, 6-kernel loop (route H)", qpb_s64, dims_s64,
             cfg_soft64, soft_solve, 3, 0, "g"),
            ("flat D f32", qpb, dims, cfg_d, pbatch.solve_batched, 5, 1,
             "b"),
            ("flat E f64", qpb64, dims64, cfg_e, pbatch.solve_batched, 3, 0,
             "b"),
            ("flat E f64, no refinement", qpb64, dims64, cfg_e0,
             pbatch.solve_batched, 3, 0, "b"),
            ("parity F f32, flat stage 2", qpb, dims, cfg_par,
             with_env(pbatch.solve_batched, HPMPC_STAGE2_LANES="0"), 5, 0,
             "b"),
            ("lanes F f64, fused refinement", qpb64, dims64, cfg_ref64,
             ipm_lanes.solve_batched_lanes, 3, 0, "b"),
            ("lanes F f64, unfused refinement", qpb64, dims64, cfg_ref64,
             with_env(ipm_lanes.solve_batched_lanes, HPMPC_FUSED_REFINE="0"),
             3, 0, "b"),
            ("structured soft G f32", qpb_s, dims_s, cfg_g, soft_solve, 2, 0,
             "g"),
            ("structured soft G f64", qpb_s64, dims_s64, cfg_g, soft_solve, 2,
             0, "g"),
            # the structured routes; A runs no kernel (no plain version to
            # time apart), C's plain version is the lanes route's and A's
            ("structured A f32", qpb, dims, cfg_def, pbatch.solve_batched,
             2, 0, "b"),
            ("structured A f64", qpb64, dims64, cfg_def,
             pbatch.solve_batched, 2, 0, "b"),
            ("structured B f32", qpb, dims_n, cfg_b, pbatch.solve_batched,
             5, 1, "b"),
            ("structured B f64", qpb64, dims64_n, cfg_b, pbatch.solve_batched,
             5, 1, "b"),
            ("structured C f32", qpb, dims, cfg_c, pbatch.solve_batched, 2,
             0, "b")):
        ms = _time_ms(torch, solve_rep(q0, d, c, fn, field), reps=reps)
        ms_plain = float("nan")
        if preps:
            with plain_kernels():
                ms_plain = _time_ms(torch, solve_rep(q0, d, c, fn, field),
                                    reps=preps, warmup=0)
        e2e[label] = (ms, ms_plain)
        print(f"main path {label} [{card}]: {ms:.3f} ms per {B}-batch "
              f"({B / ms * 1e3:.1f} solves/s); plain version "
              + (f"{ms_plain:.3f} ms" if preps else "not timed"),
              flush=True)
    for dt_ in ("f32", "f64"):
        m_, s6_ = (e2e[f"soft {dt_}, mega"][0],
                   e2e[next(k for k in e2e
                            if k.startswith(f"soft {dt_}, 6-kernel"))][0])
        print(f"soft lanes routes [{card}], {dt_}: 6-kernel loop {s6_:.3f} "
              f"ms, mega {m_:.3f} ms per {B}-batch: the default (6-kernel "
              f"loop) is {'faster' if s6_ < m_ else 'slower'}", flush=True)
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
            ("soft f32, mega", qpb_s, dims_s, cfg_soft,
             mega_route(soft_solve), "g"),
            ("soft f32, 6-kernel loop", qpb_s, dims_s, cfg_soft,
             six_kernel_loop(soft_solve), "g"),
            ("soft f64, mega", qpb_s64, dims_s64, cfg_soft64,
             mega_route(soft_lanes), "g"),
            ("soft f64, 6-kernel loop (route H)", qpb_s64, dims_s64,
             cfg_soft64, soft_solve, "g"),
            ("flat D f32", qpb, dims, cfg_d, pbatch.solve_batched, "b"),
            ("flat E f64", qpb64, dims64, cfg_e, pbatch.solve_batched, "b"),
            ("parity F f32, flat stage 2", qpb, dims, cfg_par,
             with_env(pbatch.solve_batched, HPMPC_STAGE2_LANES="0"), "b"),
            ("lanes F f64, unfused refinement", qpb64, dims64, cfg_ref64,
             with_env(ipm_lanes.solve_batched_lanes, HPMPC_FUSED_REFINE="0"),
             "b"),
            ("structured soft G f32", qpb_s, dims_s, cfg_g, soft_solve, "g"),
            ("structured soft G f64", qpb_s64, dims_s64, cfg_g, soft_solve,
             "g"),
            ("structured A f32", qpb, dims, cfg_def, pbatch.solve_batched,
             "b"),
            ("structured A f64", qpb64, dims64, cfg_def, pbatch.solve_batched,
             "b"),
            ("structured B f32", qpb, dims_n, cfg_b, pbatch.solve_batched,
             "b"),
            ("structured B f64", qpb64, dims64_n, cfg_b, pbatch.solve_batched,
             "b"),
            ("structured C f32", qpb, dims, cfg_c, pbatch.solve_batched,
             "b")):
        # one profiled call of the routes that launch ~10^5 small kernels
        reps = 1 if label.startswith(("structured A", "structured C",
                                      "structured soft")) else 3
        pr = _profile(torch, solve_rep(q0, d, c, fn, field), reps=reps)
        print(_profile_line(label, card, pr), flush=True)
    t_sec = section_done("14 end-to-end timings and profiles", t_sec)

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
    # rows 16 and 15 on route B's first calls (f32), row 14 on the
    # effective Hessian row 16 assembles there (its launches: those of the
    # main paths' runs, read above)
    a16, k16 = struct_calls[("factor_solve_folded", "")]
    ng16 = len(a16[3])
    rows += [
        ("factor_solve_folded", "hpmpc_tpu/ops/stage_kernel.py:1069", sk,
         (a16, k16), 20,
         BS * ops["factor_flat"] + B * (ops["root"] + ng16 * ops["ng_factor"]),
         launches_b["factor_solve_folded"]),
        ("solve_batched", "hpmpc_tpu/ops/stage_kernel.py:902", sk,
         struct_calls[("solve_batched", "")], 20,
         BS * ops["solve_flat"] + B * ops["root"],
         launches_b["solve_batched"]),
        ("factor_solve_batched", "hpmpc_tpu/ops/stage_kernel.py:764", sk,
         ((sk.whole_hessian(*a16[:4], dims.NZ),) + tuple(a16[4:]), {}),
         20, BS * (ops["factor_flat"] - dims.NZ) + B * ops["root"],
         launches_14)]
    # rows 11 and 12 on route D's first refinement (f32)
    rows += [
        ("solve_flat_pb", "hpmpc_tpu/ops/stage_kernel.py:1385", sk,
         d_calls[("solve_flat_pb", "")], 20,
         BS * ops["solve_flat"] + B * (N * ops["pb"] + ops["root"]),
         total(launches_d["solve_flat_pb"])),
        ("resid_terms_flat", "hpmpc_tpu/ops/stage_kernel.py:1523", sk,
         d_calls[("resid_terms_flat", "")], 50,
         BS * ops["hz"] + B * N * ops["f_terms"],
         total(launches_d["resid_terms_flat"]))]
    srcs = {"ipm_resident": "ipm_resident", "resid_full": "resid_full",
            "factor_solve_mega": "factor_solve_mega",
            "solve_mega": "solve_mega", "factor_solve_folded_flat":
            "factor_solve_flat", "solve_flat": "solve_flat",
            "refine_flat_fused": "refine_flat", "solve_flat_pb": "solve_flat",
            "resid_terms_flat": "resid_terms_flat",
            **{n: "step_flat" for n in STEP_NAMES},
            **{n: n for n in SOFT_MEGA},
            **{n: "soft_step_flat" for n in SOFT_STEP},
            "factor_solve_folded": "factor_solve_folded",
            "factor_solve_batched": "factor_solve_folded",
            "solve_batched": "solve_batched"}
    kernels = []
    for name, repl, mod, (a, k), reps, n_ops, n_launch in rows:
        fast, plain = getattr(mod, name), getattr(mod, name + "_ref")
        out = fast(*a, **k)
        kw_in = [v for v in k.values() if hasattr(v, "is_floating_point")]
        nbytes = _nbytes(a, kw_in, out)
        if name in TRIL_READ:
            i, n_ = TRIL_READ[name]
            nbytes += (_tril_nbytes(a[i], getattr(dims, n_))
                       - _nbytes([a[i]]))
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
    kernels += fused_rows
    kernels.append(row23)
    kernels += tree_rows
    kernels += band_rows
    print(f"launches per call: parity path {launches_p}", flush=True)
    section_done("15 kernels alone", t_sec)
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
