#!/usr/bin/env python3
"""Problem-size sweep of the port's hard engines on the card: the data of
the per-thread engines' size envelope (``ops/stage_kernel.engine_fits``).

The twin of ``tools/bench_size_sweep.py``, cut down to what the envelope
needs.  For each size (nx, nu, B, N) of ``SIZES`` it builds the
mass-spring problem (``mass_spring_qp(nx, nu, N)``, float32, ``b`` scaled by
``1 + 0.02 N(0,1)`` per instance, seed 0) and runs it through every engine
the port can pick, at ``IPMConfig(k_max=8, mu_tol=0, alpha_min=1e-8,
use_pallas=True)``:

  * ``resident``: ``ipm_resident.solve_batched_resident`` (``mu_switch=0``,
    the engine's contract);
  * ``lanes``: ``ipm_lanes.solve_batched_lanes`` (the mega kernels);
  * ``flat``: the same with ``flat=True`` (the 6-kernel loop);
  * ``rows16_15``: the structured ``ipm.solve`` on the per-thread kernels
    (Queue 2 rows 16/15), the envelope forced open;
  * ``blocked``: the structured ``ipm.solve`` on the blocked band
    (``models/riccati_blocked`` on Queue 2 row 24), the envelope forced
    shut.

The scenario tree's two engines run on ``mass_spring_tree_qp`` with the
reference's 71-node tree (md=2 Nr=3 Nh=10, tools/bench_tree.py's) at each
(nx, nu) of ``TREE_SIZES`` (stage widths NZ 11, 17, 19 and 27), B=1024,
``b`` scaled as above, the same config:

  * ``tree_flat``: ``tree.solve_tree_ipm_flat`` (Queue 2 rows 26-28 and
    the step kernels, per-shape builds), called directly: past the
    envelope ``parallel.batch.solve_batched_tree`` does not take it;
  * ``tree_structured``: ``tree.solve_tree_ipm`` (plain torch, no build).

Their oracle is the float64 host tree residuals (``tree.tree_residuals``)
on 64 instances: ``ok`` when finite, agreeing with the engine's report
(rtol 1e-2, atol 1e-5) and with primal residuals (rb, rd) below 1e-3, as
chip_smoke.py section T holds the tree's main path.

The soft engines run on the reference's soft problem
(``mass_spring_soft_qp(nx, nu, 30, Z=10)``: input boxes, every state of
stages 1..N softly bounded, NS = nx) at each (nx, nu) of ``SOFT_SIZES``
(NZ 11, 17 and 19, the per-thread engines' envelope), B=1024, ``g``
scaled by ``1 + 0.02 N(0,1)``, at tools/bench_soft.py's config
(``IPMConfig(k_max=8, mu0=100, mu_tol=0, use_pallas=True)``):

  * ``soft_resident``: ``ipm_soft_resident.solve_batched_soft_resident``
    (Queue 2 row 1s, the ``HPMPC_RESIDENT=1`` engine), whose size gate
    these rows decide;
  * ``soft_lanes``: ``ipm_soft_lanes.solve_batched_soft_lanes`` on its
    default 6-kernel loop, beside it.

Their oracle is the float64 soft KKT residuals (``ipm_soft.
compute_residuals``) on 64 instances: ``ok`` when finite, with primal
residuals (rb, rd_b, rd_g, rd_s) below 1e-3 and mu within 1e-2
(relative) of the engine's last stat row, as chip_smoke.py holds the soft
main path.

Per engine and size it records the nvcc seconds of each library the engine
needs (all of a size's libraries built at once, one nvcc each, each capped
at ``CAP_S`` = 300 seconds: a build that runs over is killed with the
compilers it started and recorded as such, and its engines are not run),
registers and spill bytes from ``ptxas -v`` (``ops/_build.PTXAS_LOG``), ms
per batch (CUDA events, mean of ``REPS`` calls after one warm-up, ``b``
perturbed per call), and the
verdict of the float64 host oracle (``utils/resid64``) on 64 instances:
``ok`` when its residuals are finite, its rb, rd and mu agree with the
engine's report (rtol 1e-2, atol 1e-5) and its backward-error-relative rq
and rb are within 10x of the blocked route's at the same size (floors 1e-4
and 1e-5), as ``tools/bench_size_sweep.py`` gates its engines against its
anchor (the resident engine, phase 1 only, is not held to the two-phase
engines' rq).

    python3 -m hpmpc_tpu_torch.tools.size_sweep
    python3 -m hpmpc_tpu_torch.tools.size_sweep --sizes 64,8,1024,30 \\
        --engines blocked     # one size, one engine
    python3 -m hpmpc_tpu_torch.tools.size_sweep --sizes 8,3,64,10 \\
        --device cpu          # plain versions, no build: a rehearsal
    python3 -m hpmpc_tpu_torch.tools.size_sweep \\
        --engines tree_flat,tree_structured   # the tree rows only
    python3 -m hpmpc_tpu_torch.tools.size_sweep \\
        --engines soft_resident,soft_lanes    # the soft rows only

One JSON line per (size, engine) goes to stdout (and to
``--out FILE``); the last line is a JSON object with the card and the
table.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import time

# (nx, nu, B, N): tools/bench_size_sweep.py's SIZES up to nx=64, and its
# nx=128 row
SIZES = ((8, 3, 1024, 30), (16, 1, 1024, 30), (16, 3, 1024, 30),
         (24, 3, 1024, 30), (32, 4, 1024, 30), (48, 6, 1024, 30),
         (64, 8, 1024, 30), (128, 16, 512, 30))
ENGINES = ("resident", "lanes", "flat", "rows16_15", "blocked")
# (nx, nu) of the tree rows: NZ 11, 17, 19 (the chain's envelope) and 27;
# the reference's 71-node tree, (md, Nr, Nh), at B instances
TREE_SIZES = ((8, 3), (16, 1), (16, 3), (24, 3))
TREE_ENGINES = ("tree_flat", "tree_structured")
TREE_TOPO, TREE_B = (2, 3, 10), 1024
# (nx, nu) of the soft rows: NZ 11, 17, 19 at N=30, SOFT_B instances
SOFT_SIZES = ((8, 3), (16, 1), (16, 3))
SOFT_ENGINES = ("soft_resident", "soft_lanes")
SOFT_N, SOFT_B = 30, 1024
K_MAX = 8
SUBSAMPLE = 64
#: seconds a per-shape build may take; timed calls after the warm-up
CAP_S, REPS = 300.0, 3
GATE_RATIO, GATE_RQ_FLOOR, GATE_RB_FLOOR = 10.0, 1e-4, 1e-5


def _libs(engine: str, dims, NS: int = 0) -> list:
    """The (kernel, dims) of each library ``engine`` launches at ``dims``
    (the soft engines: with ``NS`` soft rows a stage)."""
    d2 = dict(NU=dims.NU, NX=dims.NX)
    d3 = dict(d2, NB=dims.NB)
    return {
        "resident": [("ipm_resident", dict(d3, NG=dims.NG)),
                     ("resid_full", d3)],
        "lanes": [("factor_solve_mega", d3), ("solve_mega", d3),
                  ("resid_full", d3)],
        "flat": [("step_flat", dict(NZ=dims.NZ, NB=dims.NB)),
                 ("factor_solve_flat", d2), ("solve_flat", d2),
                 ("resid_full", d3)],
        "rows16_15": [("factor_solve_folded", d2), ("solve_batched", d2)],
        "blocked": [("batch_chol", {})],
        "tree_flat": [("tree_sweeps", d2), ("tree_resid_terms", d2),
                      ("step_flat", dict(NZ=dims.NZ, NB=dims.NB))],
        "tree_structured": [],
        "soft_resident": [("ipm_resident", dict(d3, NG=dims.NG, NS=NS))],
        "soft_lanes": [("soft_step_flat", dict(NZ=dims.NZ, NB=dims.NB,
                                               NS=NS)),
                       ("factor_solve_flat", d2), ("solve_flat", d2)],
    }[engine]


def _ptxas(log: str) -> dict:
    """Max registers and total spill bytes over a library's kernels."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spill = sum(int(v) for v in re.findall(
        r"(\d+) bytes spill (?:stores|loads)", log))
    return dict(regs=max(regs, default=0), spill_bytes=spill)


def build_capped(specs, cap: float) -> dict:
    """Build every (kernel, dims) of ``specs`` at once, one nvcc each, each
    killed after ``cap`` seconds.  Returns {(kernel, dims items): {"status":
    "ok" | "cached" | "over" | "failed", "s": seconds, "regs",
    "spill_bytes"}}."""
    from ..ops import _build

    key = lambda k, d: (k, tuple(sorted(d.items())))  # noqa: E731
    jobs, out = {}, {}
    t0 = time.perf_counter()
    for k, d in specs:
        if key(k, d) not in jobs:
            jobs[key(k, d)] = _build._start(k, d)
    running = dict(jobs)
    while running:
        for kd, (path, job) in list(running.items()):
            el = time.perf_counter() - t0
            if job is None or job[0].poll() is not None:
                try:
                    _build._finish(path, job)
                    st = "ok" if job is not None else "cached"
                except RuntimeError as e:
                    st, path = "failed", None
                    print(str(e)[-2000:], file=sys.stderr, flush=True)
                out[kd] = dict(status=st, s=el, **_ptxas(
                    _build.PTXAS_LOG.get(path.name, "") if path else ""))
                del running[kd]
            elif el > cap:
                _build.kill(job[0])
                with contextlib.suppress(FileNotFoundError):
                    pathlib.Path(job[2]).unlink()
                out[kd] = dict(status="over", s=el, regs=None,
                               spill_bytes=None)
                del running[kd]
        time.sleep(0.2)
    return out


@contextlib.contextmanager
def envelope(open_: bool):
    """``stage_kernel.engine_fits`` forced to ``open_`` while the block
    runs (the structured route's two forms at one size)."""
    from ..ops import stage_kernel as sk

    saved = sk.engine_fits
    sk.engine_fits = lambda *a, **k: open_
    try:
        yield
    finally:
        sk.engine_fits = saved


def _runner(engine: str, dims, cfg):
    from ..models import ipm, ipm_lanes, ipm_resident

    def run(q):
        if engine == "resident":
            return ipm_resident.solve_batched_resident(
                dims, q, dataclasses.replace(cfg, mu_switch=0.0))
        if engine in ("lanes", "flat"):
            return ipm_lanes.solve_batched_lanes(dims, q, cfg,
                                                 flat=engine == "flat")
        with envelope(engine == "rows16_15"):
            return ipm.solve(dims, q, cfg)
    return run


def _timer(torch, dev):
    """ms of ``fn()``: CUDA events on the card, the host clock else."""
    def ms(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b), out
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out
    return ms


def _oracle(qpb, sol, sub) -> dict:
    """The float64 host oracle on instances ``sub``: the relative
    (backward-error) rq and rb maxima, and whether the residuals are finite
    and the oracle's rb, rd and mu agree with the engine's own
    ``inf_norm_res`` (rtol 1e-2, atol 1e-5).  The engine's rq is left out
    of that comparison: in float32 at large NZ it is cancellation noise of
    the dual magnitudes (utils/resid64's module doc); its relative form is
    what the gate reads."""
    import numpy as np

    from ..utils.resid64 import true_residuals_sol

    qs = type(qpb)(**{f.name: getattr(qpb, f.name)[sub]
                      for f in dataclasses.fields(qpb)})
    ss = type(sol)(*[x[sub] for x in sol])
    res, rel = true_residuals_sol(qs, ss)
    eng = ss.inf_norm_res.double().cpu().numpy()
    fin = bool(np.all(np.isfinite(res)) and np.all(np.isfinite(rel)))
    agree = fin and bool(np.allclose(res[:, 1:], eng[:, 1:], rtol=1e-2,
                                     atol=1e-5))
    return dict(rel_rq=float(rel[:, 0].max()) if fin else float("inf"),
                rel_rb=float(rel[:, 1].max()) if fin else float("inf"),
                agrees=agree)


def _build_row(dev, engine, dims, builds, ns=0, **size) -> dict:
    """The row of ``engine`` at ``dims`` (``ns`` soft rows a stage) before
    it runs: its libraries' build seconds, status, registers and
    spills."""
    libs = [builds.get((k, tuple(sorted(d.items()))))
            for k, d in _libs(engine, dims, ns)]
    row = dict(size, NZ=dims.NZ, engine=engine,
               build_s=max((b["s"] for b in libs if b), default=None),
               build=("ok" if all(b and b["status"] in ("ok", "cached")
                                  for b in libs) else "not built")
               if dev.type == "cuda" else "cpu",
               regs=max((b["regs"] or 0 for b in libs if b), default=None),
               spill_bytes=(sum(b["spill_bytes"] or 0 for b in libs if b)
                            if libs and libs[0] else None))
    if any(b and b["status"] == "over" for b in libs):
        row["build"] = f"over {CAP_S:.0f} s"
    elif any(b and b["status"] == "failed" for b in libs):
        row["build"] = "failed"
    return row


def _timed(torch, np, dev, row, run, qpb):
    """Run ``run`` on ``qpb`` once and ``REPS`` times more with ``b``
    perturbed; ms a batch into ``row``; returns the first solution."""
    ms_of = _timer(torch, dev)
    first, sol = ms_of(lambda: run(qpb))
    times = [first]
    for r in range(REPS if first < 5000 else 0):
        q = dataclasses.replace(qpb, b=qpb.b * (1 + 1e-4 * (r + 1)))
        times.append(ms_of(lambda: run(q))[0])
    row["ms"] = float(np.mean(times[1:] or times))
    row["first_ms"] = first
    row["mean_kk"] = float(sol.kk.double().mean())
    row["status_counts"] = torch.bincount(sol.status.long(),
                                          minlength=3).tolist()
    return sol


def _tree_oracle(torch, tdef, dims, qpb, sol, sub) -> dict:
    """The float64 host tree residuals of instances ``sub``: finite,
    agreeing with the engine's report (rtol 1e-2, atol 1e-5), rb and rd
    below 1e-3."""
    import numpy as np

    from ..models import tree
    from ..models.ipm import _box_onehot

    def pick(x):
        x = x[sub]
        return x.double() if x.is_floating_point() else x

    q = type(qpb)(**{f.name: pick(getattr(qpb, f.name))
                     for f in dataclasses.fields(qpb)})
    s = type(sol)(*[pick(x) for x in sol])
    mu_scal = torch.tensor(1.0 / dims.n_constr, dtype=torch.float64,
                           device=q.b.device)
    res = tree.tree_residuals(tdef, q, _box_onehot(q), mu_scal, s.z, s.pi,
                              s.lam_b, s.t_b, s.lam_g, s.t_g, q.b)

    def amax(x):
        return x.abs().flatten(1).amax(1)

    orc = torch.stack([amax(res.rq), amax(res.rb),
                       torch.maximum(amax(res.rd_b), amax(res.rd_g)),
                       res.mu], 1).cpu().numpy()
    eng = s.inf_norm_res.cpu().numpy()
    ok = bool(np.all(np.isfinite(orc))
              and np.allclose(orc, eng, rtol=1e-2, atol=1e-5)
              and orc[:, 1].max() <= 1e-3 and orc[:, 2].max() <= 1e-3)
    return dict(oracle="ok" if ok else "fail",
                max_rb=float(orc[:, 1].max()), max_rd=float(orc[:, 2].max()))


def sweep_tree(torch, np, dev, size, engines, emit):
    """The tree rows at (nx, nu) = ``size``: both tree engines on the
    71-node tree, the flat engine's libraries built first (capped)."""
    from ..models import tree
    from ..models.ipm import IPMConfig
    from ..ops import _build
    from ..parallel import batch as pbatch
    from ..utils.mass_spring import mass_spring_tree_qp

    nx, nu = size
    md, Nr, Nh = TREE_TOPO
    tdef, dims, qp = mass_spring_tree_qp(md=md, Nr=Nr, Nh=Nh, nx=nx, nu=nu,
                                         dtype=torch.float32, device=dev)
    qpb = pbatch.broadcast_qp(qp, TREE_B)
    sc = 1 + 0.02 * np.random.default_rng(0).standard_normal(TREE_B)
    qpb = dataclasses.replace(qpb, b=qpb.b * torch.as_tensor(
        sc, dtype=torch.float32, device=dev)[:, None, None])
    cfg = IPMConfig(k_max=K_MAX, mu_tol=0.0, alpha_min=1e-8, use_pallas=True)
    builds = {}
    if dev.type == "cuda":
        builds = build_capped([s for e in engines for s in _libs(e, dims)],
                              CAP_S)
    sub = torch.arange(0, TREE_B, max(1, TREE_B // SUBSAMPLE), device=dev)
    rows, sols = {}, {}
    for engine in engines:
        row = _build_row(dev, engine, dims, builds, nx=nx, nu=nu, B=TREE_B,
                         nodes=tdef.n_nodes)
        if row["build"] in ("ok", "cpu"):
            fn = (tree.solve_tree_ipm_flat if engine == "tree_flat"
                  else tree.solve_tree_ipm)
            try:
                sols[engine] = _timed(torch, np, dev, row,
                                      lambda q: fn(tdef, dims, q, cfg), qpb)
                row.update(_tree_oracle(torch, tdef, dims, qpb,
                                        sols[engine], sub))
            except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
                row["error"] = str(e)[:300]
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        rows[engine] = row
    if len(sols) == 2:          # the two engines' answers side by side
        a, b = sols["tree_flat"], sols["tree_structured"]
        rows["tree_flat"]["vs_structured"] = dict(
            status_equal=float((a.status == b.status).double().mean()),
            max_dz=float((a.z.double() - b.z.double()).abs().max()))
    for row in rows.values():
        row.setdefault("oracle", "not run")
        emit(row)
    _build._LIBS.clear()
    return rows


def _soft_oracle(dims, qpb, soft, sol, sub) -> dict:
    """The float64 soft KKT residuals of instances ``sub``
    (``ipm_soft.residuals64``): finite, rb, rd_b, rd_g and rd_s below
    1e-3, mu within 1e-2 (relative) of the engine's last stat row."""
    from ..models import ipm_soft

    rmax, dmu = ipm_soft.residuals64(dims, qpb, soft, sol, sub)
    fin = all(v == v and v != float("inf") for v in rmax.values())
    ok = (fin and max(rmax[f] for f in ("rb", "rd_b", "rd_g", "rd_s"))
          <= 1e-3 and dmu <= 1e-2)
    return dict(oracle="ok" if ok else "fail", max_rb=rmax["rb"],
                max_rd_s=rmax["rd_s"], max_mu=rmax["mu"], mu_rel_diff=dmu)


def sweep_soft(torch, np, dev, size, engines, emit):
    """The soft rows at (nx, nu) = ``size``: the soft resident and the soft
    lanes engine (its 6-kernel loop) on the reference's soft problem, their
    libraries built first (capped)."""
    from ..models import ipm_soft_lanes, ipm_soft_resident
    from ..models.ipm import IPMConfig
    from ..ops import _build
    from ..parallel import batch as pbatch
    from ..utils.mass_spring import mass_spring_soft_qp

    nx, nu = size
    dims, qp, soft = mass_spring_soft_qp(nx, nu, SOFT_N, Z=10.0,
                                         dtype=torch.float32, device=dev)
    NS = soft.ns_mask.shape[-1]
    qpb = pbatch.broadcast_qp(qp, SOFT_B)
    sb = pbatch.broadcast_soft(soft, SOFT_B)
    sc = 1 + 0.02 * np.random.default_rng(0).standard_normal(SOFT_B)
    qpb = dataclasses.replace(qpb, g=qpb.g * torch.as_tensor(
        sc, dtype=torch.float32, device=dev)[:, None, None])
    idxbs = soft.idxbs.cpu().numpy()
    cfg = IPMConfig(k_max=K_MAX, mu0=100.0, mu_tol=0.0, use_pallas=True)
    builds = {}
    if dev.type == "cuda":
        builds = build_capped([s for e in engines
                               for s in _libs(e, dims, NS)], CAP_S)
    sub = torch.arange(0, SOFT_B, max(1, SOFT_B // SUBSAMPLE), device=dev)
    runs = {"soft_resident": ipm_soft_resident.solve_batched_soft_resident,
            "soft_lanes": ipm_soft_lanes.solve_batched_soft_lanes}
    rows = {}
    for engine in engines:
        row = _build_row(dev, engine, dims, builds, ns=NS, nx=nx, nu=nu,
                         B=SOFT_B, N=SOFT_N, NS=NS)
        if row["build"] in ("ok", "cpu"):
            try:
                sol = _timed(torch, np, dev, row, lambda q: runs[engine](
                    dims, q, sb, cfg, idxbs), qpb)
                row.update(_soft_oracle(dims, qpb, sb, sol, sub))
            except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
                row["error"] = str(e)[:300]
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        row.setdefault("oracle", "not run")
        rows[engine] = row
        emit(row)
    _build._LIBS.clear()
    return rows


def sweep_size(torch, np, dev, size, engines, emit):
    from ..models.ipm import IPMConfig
    from ..ops import _build
    from ..parallel import batch as pbatch
    from ..utils.mass_spring import mass_spring_qp

    nx, nu, B, N = size
    dims, qp = mass_spring_qp(nx, nu, N, dtype=torch.float32, device=dev)
    qpb = pbatch.broadcast_qp(qp, B)
    sc = 1 + 0.02 * np.random.default_rng(0).standard_normal(B)
    qpb = dataclasses.replace(qpb, b=qpb.b * torch.as_tensor(
        sc, dtype=torch.float32, device=dev)[:, None, None])
    cfg = IPMConfig(k_max=K_MAX, mu_tol=0.0, alpha_min=1e-8, use_pallas=True)
    builds = {}
    if dev.type == "cuda":
        specs = [s for e in engines for s in _libs(e, dims)]
        builds = build_capped(specs, CAP_S)
    sub = torch.arange(0, B, max(1, B // SUBSAMPLE), device=dev)
    rows = {}
    for engine in engines:
        row = _build_row(dev, engine, dims, builds, nx=nx, nu=nu, B=B, N=N)
        if row["build"] in ("ok", "cpu"):
            run = _runner(engine, dims, cfg)
            try:
                sol = _timed(torch, np, dev, row, run, qpb)
                row.update(_oracle(qpb, sol, sub))
            except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
                row["error"] = str(e)[:300]
            del run
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        rows[engine] = row
    anchor = rows.get("blocked", {})
    for engine, row in rows.items():
        # the resident engine runs phase 1 only (mu_switch=0): its iterate
        # is not held to the two-phase engines' stationarity
        ran = "rel_rq" in row and "rel_rq" in anchor
        gate = ran and (engine == "resident" or (
            row["rel_rq"] <= max(GATE_RATIO * anchor["rel_rq"], GATE_RQ_FLOOR)
            and row["rel_rb"] <= max(GATE_RATIO * anchor["rel_rb"],
                                     GATE_RB_FLOOR)))
        row["oracle"] = ("not run" if not ran else
                         "ok" if row["agrees"] and gate else "fail")
        emit(row)
    _build._LIBS.clear()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", nargs="*", default=None,
                    help="nx,nu,B,N tuples (default: SIZES)")
    ap.add_argument("--engines",
                    default=",".join(ENGINES + TREE_ENGINES + SOFT_ENGINES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("size_sweep: no CUDA device", file=sys.stderr)
        return 2
    sizes = (tuple(tuple(int(v) for v in s.split(",")) for s in args.sizes)
             if args.sizes else SIZES)
    engines = tuple(args.engines.split(","))
    chain = tuple(e for e in engines if e in ENGINES)
    tree_e = tuple(e for e in engines if e in TREE_ENGINES)
    soft_e = tuple(e for e in engines if e in SOFT_ENGINES)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    fh = None
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        fh = out.open("w")

    def emit(row):
        row = dict(row, card=card)
        print(json.dumps(row), flush=True)
        if fh:
            fh.write(json.dumps(row) + "\n")
            fh.flush()

    table = []
    t0 = time.perf_counter()
    for size in sizes if chain else ():
        table += list(sweep_size(torch, np, dev, size, chain, emit).values())
    for size in TREE_SIZES if tree_e else ():
        table += list(sweep_tree(torch, np, dev, size, tree_e, emit).values())
    for size in SOFT_SIZES if soft_e else ():
        table += list(sweep_soft(torch, np, dev, size, soft_e, emit).values())
    print(json.dumps({"card": card, "seconds": time.perf_counter() - t0,
                      "table": table}), flush=True)
    if fh:
        fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
