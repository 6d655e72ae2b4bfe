#!/usr/bin/env python3
"""Bit-for-bit comparison of this checkout's routes and kernels with
another checkout's, on the card.

Both packages build their kernels from their own sources (one ``nvcc``
per library, the two builds at once) and run bench.py's parity route
(``IPMConfig(k_max=8, mu_tol=0, alpha_min=1e-8, iter_ref=1,
iter_ref_mu_thr=1e-3, use_pallas=True)``, float32: resident stage 1, then
the lanes engine's 6-kernel loop with the fused refinement) on
chip_smoke.py's batch: the mass-spring flagship (nx=8, nu=3, N=30, nb=7,
ngN=8) at 4096 instances, ``b`` scaled by ``1 + 0.05 N(0,1)``, seed 0.
It reports:

  * for the stage kernels of the 6-kernel loop (``factor_solve_folded_flat``,
    ``solve_flat``, ``refine_flat_fused``): the first two calls' inputs
    of this checkout's run, handed to both builds' wrappers, and whether
    the outputs are equal bit for bit (else the largest difference);
  * whether the two runs' solutions are equal bit for bit, and each run's
    max and median control error (per instance, max |u| difference over
    the stages) against the f64 lanes engine at the same budget, beside
    the unrefined route's: chip_smoke.py section 6's measure;
  * whether the chain's flat form (``solve_batched_lanes(..., flat=True)``
    at ``IPMConfig(k_max=8, mu_tol=0, use_pallas=True)``, without and with
    ``iter_ref=1``: the 6-kernel loop, its unfused refinement and
    ``resid_full``) gives the two checkouts the same solution bit for
    bit;
  * the resident kernel (``ipm_resident``), hard (Queue 2 row 1) on this
    checkout's inputs of bench.py's headline config (``IPMConfig(k_max=8,
    mu_tol=0, alpha_min=1e-8, mu_switch=0, use_pallas=True)``) and soft
    (row 1s) on the soft flagship's (``mass_spring_soft_qp(8, 3, 30,
    Z=10)``, ``g`` scaled by ``1 + 0.02 N(0,1)``, ``IPMConfig(k_max=8,
    mu0=100, mu_tol=0, use_pallas=True)``, both ``exact`` values) and on
    the small soft problem with general rows (N=5, one row on stages 2 and
    N), float32 and float64, handed to both builds' wrappers: equal bit for
    bit (else the largest difference), each build's ms a call in turns
    (other, this, this, other) with CUDA events, and both builds' ptxas
    lines (registers, stack, spills) and this build's team width;
  * the headline route (``solve_batched``: the resident engine and
    ``resid_full``) and the soft resident route (``solve_batched_soft``
    under ``HPMPC_RESIDENT=1``) of both checkouts in float32: the solution
    equal bit for bit or not, ms a batch in turns, one profiled call of
    each (device busy ms, idle share, the resident kernel's ms), and the
    soft 6-kernel loop's ms a batch (``HPMPC_RESIDENT=0``,
    ``HPMPC_MEGA_SWEEPS=0``) in the same turns;
  * the lanes engine's mega half-iterations (``factor_solve_mega``,
    ``solve_mega``, Queue 2 rows 19 and 20) on this checkout's inputs of
    their first phase-1 and first phase-2 call in the f32 flagship route
    (``solve_batched`` at ``IPMConfig(k_max=30, use_pallas=True)``), the
    f64 lanes run (``solve_batched_lanes``), the box-only problem and the
    NZ=19 shape (nx=16), f32 and f64, handed to both builds' wrappers:
    equal bit for bit (else the largest difference and the first output
    and stage apart), each build's ms a call in turns with CUDA events
    (flagship and NZ=19), both builds' ptxas lines and this build's team
    width; then the lanes route in f32, the f64 lanes run and route C
    (``escalate_stalled``) of both checkouts: the solution equal bit for
    bit or not, ms a batch in turns, one profiled call of each (device
    busy ms, idle share, rows 19 and 20's ms and launches);
  * the large-NZ band's batched Cholesky (``batch_chol.cholesky``, Queue
    2 row 24) on the first input the band gives it (``solve_batched`` at
    nx=64 nu=8 N=30, 1024 instances, ``IPMConfig(k_max=8, mu_tol=0,
    alpha_min=1e-8, use_pallas=True)``) and on random SPD batches at n=144
    (512) and n=288 (64), float32 and float64, handed to both builds:
    equal bit for bit (else the largest difference), and each build's ms
    a call, timed in turns (other, this, this, other) with CUDA events,
    beside ``torch.linalg.cholesky`` on the same batch;
  * the band's ``solve_batched`` of both checkouts (that config at k_max
    8) at nx=64 in float32 and float64 and at nx=128 nu=16 (half the
    batch) in float32: the solution equal bit for bit or not, its ms a
    batch in turns, and one profiled call of each (device busy ms, idle
    share, row 24's summed ms and launches).
  * the scenario tree's sweep kernels (``tree_factor_solve_flat``,
    ``tree_solve_flat``, Queue 2 rows 26 and 27) on this checkout's inputs
    of the first and the last call of a k_max-8 flat tree solve
    (``tree.solve_tree_ipm_flat`` at ``IPMConfig(k_max=8, mu_tol=0,
    use_pallas=True)``, ``mass_spring_tree_qp(nx=4, nu=2)``, ``b`` scaled
    by ``1 + 0.02 N(0,1)``) on the 31-, 71- and 255-node trees (the
    71-node one also with general rows on nodes 0 and 5), float32 and
    float64, row 26 also in its ``want_pi`` form, handed to both builds'
    wrappers: equal bit for bit (else the largest difference and the first
    output and node apart), each build's ms a call in turns (float32, the
    first call), both builds' ptxas lines and this build's launch layout
    per tree, and both rows on random data with one state (NX = 1, NU =
    1, the 15-node tree); then ``solve_batched_tree`` of both checkouts on
    the 71-node tree in float32 at that config: the solution equal bit for bit or not
    (in PyTorch's deterministic mode: the route's edge scatter,
    ``index_add``, adds with atomics on the card, so it is also run twice
    in the default mode against itself), ms a batch in turns, one profiled
    call of each (device busy ms, idle share, rows 26 and 27's summed ms
    and launches).

  * the refinement re-solve kernels (``solve_flat_pb``,
    ``refine_flat_fused``, Queue 2 rows 11 and 13) on this checkout's
    inputs of the first and the last call of each phase: row 13 in
    bench.py's parity route (float32) and in the float64 lanes engine with
    the same refinement (``IPMConfig(k_max=30, iter_ref=1,
    iter_ref_mu_thr=1e-3, use_pallas=True)``), row 11 in route D (float32,
    ``IPMConfig(k_max=8, mu_tol=0, alpha_min=1e-8, iter_ref=1,
    use_pallas=True)``: the ``"flat"`` engine) and route E (float64,
    ``IPMConfig(iter_ref=1, use_pallas=True)``), on the flagship, the
    flagship without its ngN=8 block and the NZ=19 shape (nx=16, no ng
    block); a phase a route does not reach is taken from the lanes engine
    run in it alone (``mu_switch=1e9``, two iterations).  Handed to both
    builds' wrappers: equal bit for bit (else the largest difference and
    the first output and stage apart), each build's ms a call in turns
    (the first phase-1 call; flagship and NZ=19, float32 and float64), both
    builds' ptxas lines and this build's launch layout; the fused pass
    against the unfused one (``stage_kernel.refine_flat_unfused``) on the
    float64 flagship's first row-13 inputs, as captured and with the
    iterate moved by 0.1 N(0,1); then the parity route and route D of both
    checkouts in float32: the solution equal bit for bit or not, ms a batch
    in turns, one profiled call of each (device busy ms, idle share, rows
    11 and 13's summed ms and launches).
  * the 6-kernel loop's sweeps (``factor_solve_folded_flat``,
    ``solve_flat``, Queue 2 rows 9 and 10) and their fused forms
    (``factor_solve_folded_flat_fused`` on row 9's call without pi,
    ``solve_flat_fused``, rows 18 and 17) on this checkout's inputs of
    the first and the last call of rows 9 and 10 in the default routes of
    the loop: the parity line and route D (float32, configs as above),
    route E (float64, ``IPMConfig(iter_ref=1, use_pallas=True)``: the
    ``"flat"`` engine) on the flagship, the box-only flagship and the
    NZ=19 shape (nx=16, no ng block), and the soft 6-kernel loop
    (``HPMPC_RESIDENT=0``, ``HPMPC_MEGA_SWEEPS=0``) in float32 and float64
    on the soft flagship, the small soft problem with general rows and
    the soft NZ=19 shape.  Handed to both builds' wrappers: equal bit for
    bit (else the largest difference and the first output and stage
    apart), each build's ms a call of rows 9 and 10 in turns (the first
    call; not on the box-only problem), both builds' ptxas lines and this
    build's launch layout; then the five routes of both checkouts on their
    flagship: the solution equal bit for bit or not, ms a batch in turns,
    one profiled call of each (device busy ms, idle share, rows 9 and
    10's ms and launches).
  * rows 16, 15 and 14, the structured route's kernels: both builds on
    this checkout's inputs of route B's first calls of rows 16 and 15
    (``solve_batched`` with ``IPMConfig(use_pallas=True)`` on the
    flagship's dims without a static ``idxb``; row 14 on the effective
    Hessian row 16 assembles there) in float32 and float64 at NZ 11 (the
    flagship), 12 (nu=4) and 19 (nx=16): bits, ms a call in turns, ptxas
    and the launch layout; then route B (float32, float64) and the
    structured soft IPM's kernel backend (``solve_batched_soft`` at
    ``IPMConfig(k_max=8, mu0=100, mu_tol=0, use_pallas=True)`` without
    ``idxbs``, float32 and float64) of both checkouts: bits per field, ms
    a batch in turns, one profiled call each (device busy ms, idle share,
    rows 16 + 15's summed ms and launches).
  * the two forms of rows 9 and 16: ``factor_solve_folded_flat`` on the
    flat engine's first call and ``factor_solve_folded`` on route B's, in
    float32 and float64 at NZ 6 to 19 (``FORM_CASES``), captured through
    the plain versions on the CPU, handed to both builds: bits, ms a call
    in turns, each build's form and ptxas lines.  Against a copy of this
    checkout whose ``Row9::REG`` is negated it times the register form
    against the shared-memory form at each size.

Imports no JAX.  ``--other`` is a directory holding the other checkout's
``hpmpc_tpu_torch/`` (for the parent commit: ``git archive HEAD~1
hpmpc_tpu_torch | tar -x -C <dir>``, into a git-ignored directory).
Runs on the card unless asked for the CPU (plain versions; keep
``--batch`` small):

    python3 -m hpmpc_tpu_torch.tools.compare_builds --other _archive/parent
    python3 -m hpmpc_tpu_torch.tools.compare_builds --other _archive/parent \\
        --sections resident,routes        # rows 1 and 1s and their routes
    python3 -m hpmpc_tpu_torch.tools.compare_builds --other _archive/parent \\
        --sections mega                   # rows 19 and 20 and their routes
    python3 -m hpmpc_tpu_torch.tools.compare_builds --other _archive/parent \\
        --sections tree                   # rows 26 and 27 and their route
    python3 -m hpmpc_tpu_torch.tools.compare_builds --other _archive/parent \\
        --sections refine                 # rows 11 and 13 and their routes
    python3 -m hpmpc_tpu_torch.tools.compare_builds --other _archive/parent \\
        --sections sweeps                 # rows 9 and 10 and their routes
    python3 -m hpmpc_tpu_torch.tools.compare_builds --other _archive/parent \\
        --sections structured             # rows 16, 15, 14 and their routes
    python3 -m hpmpc_tpu_torch.tools.compare_builds --other _archive/swap \\
        --sections forms                  # rows 9 and 16: both forms
    python3 -m hpmpc_tpu_torch.tools.compare_builds --other DIR \\
        --device cpu --batch 16 --band-batch 8

(``_archive/swap``: ``git archive HEAD hpmpc_tpu_torch`` unpacked there,
its ``csrc/folded_team.cuh`` edited so that ``Row9::REG`` is the negation
of its expression: ``static constexpr bool REG = !(...);``.)

``--sections`` picks any of ``resident``, ``routes``, ``mega``, ``parity``,
``flat``, ``band``, ``tree``, ``refine``, ``sweeps``, ``structured``,
``forms`` (default: all). The resident section also
runs rows 1 and 1s at the NZ=19 shape (nx=16, nu=3; float32: the hard
problem with ngN=8 and the soft one, N=30), bits and ms.

The last line of the output is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import importlib.util
import itertools
import json
import os
import pathlib
import sys
import threading

KERNELS = ("factor_solve_folded_flat", "solve_flat", "refine_flat_fused")
#: rows 19 and 20, the lanes engine's mega half-iterations
MEGA = ("factor_solve_mega", "solve_mega")
CALLS = 2
#: the band's (nx, nu) and row 24's random batches beside its input, (n, B)
BAND = (64, 8)
CHOL_RANDOM = ((144, 512), (288, 64))
#: the band's end-to-end runs, (nx, nu, dtype name): nx=128 at half the batch
BAND_RUNS = ((64, 8, "float32"), (128, 16, "float32"), (64, 8, "float64"))
#: rows 26 and 27, the scenario tree's sweeps
TREE = ("tree_factor_solve_flat", "tree_solve_flat")
#: the trees, (md, Nr, Nh): 31, 71 (the reference's tree benchmark) and 255
#: nodes, as chip_smoke.py's section T
TREE_TOPOS = ((2, 2, 8), (2, 3, 10), (2, 7, 7))
#: rows 11 and 13, the refinement re-solve kernels
REFINE = ("solve_flat_pb", "refine_flat_fused")
#: row 11's and row 13's kernels as the profiler names them, both builds
REFINE_PROFILE = {"row 11": r"solve_flat_kernel<\w+, true>|"
                            r"\bsolve_flat_pb_kernel\b",
                  "row 13": r"\brefine_flat_kernel\b"}
#: rows 9 and 10, the 6-kernel loop's sweeps, with their fused forms (rows
#: 18 and 17: the pi-less factorization and the re-solve, one thread an
#: instance)
SWEEPS = {"factor_solve_folded_flat": "factor_solve_folded_flat_fused",
          "solve_flat": "solve_flat_fused"}
#: rows 9 and 10's kernels as the profiler names them (both builds)
SWEEP_PROFILE = {"row 9": r"\bfactor_solve_flat(_smem)?_kernel\b",
                 "row 10": r"\bsolve_flat_kernel\b"}
#: rows 16 and 15, the structured route's kernel backend
STRUCT = ("factor_solve_folded", "solve_batched")
#: the structured route's stage shapes, (nu, nx): NZ 11 (the flagship), 12
#: and 19 (the engine envelope's last)
STRUCT_SHAPES = ((3, 8), (4, 8), (3, 16))
#: rows 16 (both forms) and 15 as the profiler names them (both builds)
STRUCT_PROFILE = {"row 16": r"\bfactor_solve_folded(_smem)?_kernel\b",
                  "row 15": r"\bsolve_batched_kernel\b"}


def _load_other(root: pathlib.Path):
    """The other checkout's package, imported as ``hpmpc_other``."""
    pkg = root / "hpmpc_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "hpmpc_other", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["hpmpc_other"] = mod
    spec.loader.exec_module(mod)
    return "hpmpc_other"


def _mods(name: str):
    m = lambda s: importlib.import_module(f"{name}.{s}")  # noqa: E731
    return dict(batch=m("parallel.batch"), sk=m("ops.stage_kernel"),
                build=m("ops._build"), ipm=m("models.ipm"),
                lanes=m("models.ipm_lanes"), ms=m("utils.mass_spring"),
                rk=m("ops.resident_kernel"), res=m("models.ipm_resident"),
                sres=m("models.ipm_soft_resident"), ocp=m("ocp"),
                bc=m("ops.batch_chol"), mk=m("ops.mega_kernel"),
                tree=m("models.tree"), tk=m("ops.tree_kernel"),
                stk=m("ops.step_kernel"))


def _clone(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


def _diff(a, b):
    """(bitwise equal, largest |a - b|) over the tensors of two outputs."""
    import torch

    if isinstance(a, torch.Tensor):
        if a.is_floating_point():
            same = torch.equal(a.contiguous().view(torch.uint8),
                               b.contiguous().view(torch.uint8))
            d = (a.double() - b.double()).abs()
            d = torch.where((a == b) | (torch.isnan(a) & torch.isnan(b)),
                            0.0, d)
            return same, float(torch.nan_to_num(d, nan=float("inf")).max())
        return torch.equal(a, b), float((a != b).sum())
    if isinstance(a, (tuple, list)):
        parts = [_diff(u, v) for u, v in zip(a, b)]
        return (all(p[0] for p in parts),
                max((p[1] for p in parts), default=0.0))
    return a == b, 0.0


SECTIONS = ("resident", "routes", "mega", "parity", "flat", "band", "tree",
            "refine", "sweeps", "structured", "forms")
#: row 9's two forms (``struct Row9`` in csrc/folded_team.cuh): the
#: (dtype, nu, nx) of NZ 6, 11 (the flagship), 12-14 and 19 (the engine
#: envelope's last)
FORM_CASES = (("float32", 2, 4), ("float32", 3, 8), ("float32", 3, 10),
              ("float32", 3, 16), ("float64", 2, 4), ("float64", 3, 8),
              ("float64", 2, 10), ("float64", 3, 10), ("float64", 4, 10),
              ("float64", 3, 16))
#: the state width of rows 1 and 1s's second shape: NZ = 19 (nu = 3), the
#: largest inside stage_kernel.engine_fits
NX19 = 16
#: the soft flagship: tools/bench_soft.py's problem and config
SOFT_N, SOFT_NG_N = 30, 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=pathlib.Path)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--band-batch", type=int, default=1024)
    ap.add_argument("--sections", default=",".join(SECTIONS))
    args = ap.parse_args()
    import numpy as np
    import torch

    dev, B, band_B = torch.device(args.device), args.batch, args.band_batch
    sections = [x for x in args.sections.split(",") if x]
    if set(sections) - set(SECTIONS):
        raise SystemExit(f"unknown sections {set(sections) - set(SECTIONS)}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    trees = {"this": _mods("hpmpc_tpu_torch"),
             "other": _mods(_load_other(args.other.resolve()))}
    rng = np.random.default_rng(0)
    scales = 1.0 + 0.05 * rng.standard_normal(B)
    soft_scales = 1.0 + 0.02 * np.random.default_rng(0).standard_normal(B)

    def flagship(m, dt, nx=8, ngN=8, nu=3):
        dims, qp = m["ms"].mass_spring_qp(nx, nu, 30, ngN=ngN, dtype=dt,
                                          device=dev)
        qpb = m["batch"].broadcast_qp(qp, B)
        sc = torch.as_tensor(scales, dtype=dt, device=dev)
        return dims, dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])

    def soft_flagship(m, dt, N=SOFT_N, ng=False, nx=8):
        """(dims, qp, soft, idxbs) of the soft problem, ``g`` scaled; with
        ``ng`` one general row on stages 2 and N (0.25 x the state sum in
        [-1, 1]), as chip_smoke.py's section R."""
        dims, qp, soft = m["ms"].mass_spring_soft_qp(nx, 3, N, Z=10.0,
                                                     dtype=dt, device=dev)
        if ng:
            ngv = [0] * (N + 1)
            ngv[2] = ngv[N] = 1
            dims = m["ocp"].OCPDims.create(N, dims.nx, dims.nu, dims.nb, ngv,
                                           idxb=dims.idxb)
            C = torch.zeros(N + 1, 1, dims.NZ, dtype=dt, device=dev)
            d_lg = torch.zeros(N + 1, 1, dtype=dt, device=dev)
            for n in (2, N):
                C[n, 0, dims.NU:] = 0.25
                d_lg[n, 0] = -1.0
            qp = dataclasses.replace(
                qp, C=C, d_lg=d_lg, d_ug=-d_lg, ng_mask=torch.as_tensor(
                    dims.ng_mask(), dtype=dt, device=dev))
        qpb = m["batch"].broadcast_qp(qp, B)
        sc = torch.as_tensor(soft_scales, dtype=dt, device=dev)
        return (dims, dataclasses.replace(qpb, g=qpb.g * sc[:, None, None]),
                m["batch"].broadcast_soft(soft, B),
                soft.idxbs.cpu().numpy())

    if dev.type == "cuda":
        dims, _ = flagship(trees["this"], torch.float32)
        dims_s, _, soft0, _ = soft_flagship(trees["this"], torch.float32)
        NS = soft0.ns_mask.shape[-1]
        d2 = dict(NU=dims.NU, NX=dims.NX)
        d3 = dict(d2, NB=dims.NB)
        ds = dict(NU=dims_s.NU, NX=dims_s.NX, NB=dims_s.NB, NS=NS)
        specs = [] if sections == ["tree"] else [
                 ("resid_full", d3), ("ipm_resident", dict(d3, NG=dims.NG)),
                 ("ipm_resident", dict(ds, NG=dims_s.NG)),
                 ("soft_step_flat", dict(NZ=dims_s.NZ, NB=dims_s.NB, NS=NS)),
                 ("factor_solve_mega", d3), ("solve_mega", d3),
                 ("step_flat", dict(NZ=dims.NZ, NB=dims.NB)),
                 ("factor_solve_flat", d2), ("solve_flat", d2),
                 ("refine_flat", dict(d2, NG=dims.NG)),
                 ("resid_terms_flat", d2), ("batch_chol", {})]
        if "mega" in sections:
            # the NZ=19 shape of rows 19 and 20 (nx=16)
            d19, _ = flagship(trees["this"], torch.float32, nx=NX19)
            specs += [(k, dict(NU=d19.NU, NX=d19.NX, NB=d19.NB))
                      for k in MEGA]
        if "resident" in sections:
            # the NZ=19 shapes of rows 1 and 1s (nx=16)
            d19, _ = flagship(trees["this"], torch.float32, nx=NX19)
            d19s, _, soft19, _ = soft_flagship(trees["this"], torch.float32,
                                               nx=NX19)
            specs += [("ipm_resident", dict(NU=d19.NU, NX=d19.NX, NB=d19.NB,
                                            NG=d19.NG)),
                      ("ipm_resident", dict(NU=d19s.NU, NX=d19s.NX,
                                            NB=d19s.NB, NG=d19s.NG,
                                            NS=soft19.ns_mask.shape[-1]))]
        if "refine" in sections:
            # the NZ=19 shape's flat engine and two-stage route (nx=16)
            d19, _ = flagship(trees["this"], torch.float32, nx=NX19, ngN=0)
            e19 = dict(NU=d19.NU, NX=d19.NX)
            specs += [("step_flat", dict(NZ=d19.NZ, NB=d19.NB)),
                      ("factor_solve_flat", e19), ("solve_flat", e19),
                      ("refine_flat", dict(e19, NG=1)),
                      ("resid_terms_flat", e19),
                      ("resid_full", dict(e19, NB=d19.NB)),
                      ("ipm_resident", dict(e19, NB=d19.NB, NG=d19.NG)),
                      ("refine_flat", dict(d2, NG=1))]
        if "sweeps" in sections:
            # the NZ=19 shape's routes, hard and soft (nx=16)
            d19, _ = flagship(trees["this"], torch.float32, nx=NX19, ngN=0)
            d19s, _, soft19, _ = soft_flagship(trees["this"], torch.float32,
                                               nx=NX19)
            e19 = dict(NU=d19.NU, NX=d19.NX)
            specs += [("step_flat", dict(NZ=d19.NZ, NB=d19.NB)),
                      ("factor_solve_flat", e19), ("solve_flat", e19),
                      ("refine_flat", dict(e19, NG=1)),
                      ("resid_terms_flat", e19),
                      ("resid_full", dict(e19, NB=d19.NB)),
                      ("ipm_resident", dict(e19, NB=d19.NB, NG=d19.NG)),
                      ("refine_flat", dict(d2, NG=1)),
                      ("soft_step_flat", dict(NZ=d19s.NZ, NB=d19s.NB,
                                              NS=soft19.ns_mask.shape[-1]))]
        if "structured" in sections:
            # rows 9 and 10 too: timed on the same inputs, the factor split
            specs += [(k, dict(NU=nu, NX=nx)) for nu, nx in STRUCT_SHAPES
                      for k in STRUCT + ("factor_solve_flat", "solve_flat")]
        if "forms" in sections:
            specs += [(k, dict(NU=nu, NX=nx))
                      for nu, nx in sorted({c[1:] for c in FORM_CASES})
                      for k in ("factor_solve_flat", "factor_solve_folded")]
        if "tree" in sections:
            # nx=4 nu=2: NZ=6, two input boxes
            specs += [("tree_sweeps", dict(NU=2, NX=4)),
                      ("tree_sweeps", dict(NU=1, NX=1)),
                      ("tree_resid_terms", dict(NU=2, NX=4)),
                      ("step_flat", dict(NZ=6, NB=2))]
        errors = []

        def build(m):
            try:
                m["build"].build_all(specs)
            except Exception as e:  # noqa: BLE001 -- re-raised below
                errors.append(e)

        jobs = [threading.Thread(target=build, args=(m,))
                for m in trees.values()]
        for j in jobs:
            j.start()
        for j in jobs:
            j.join()
        if errors:
            raise errors[0]

    out = {"batch": B, "device": str(dev)}
    if dev.type == "cuda":
        out["card"] = _card()
        print(f"card: {out['card']}", flush=True)
    if "resident" in sections:
        out["resident"] = _resident(trees, dev, flagship, soft_flagship)
    if "routes" in sections:
        out["routes"] = _routes(trees, dev, flagship, soft_flagship)
    if "mega" in sections:
        out["mega"] = _mega(trees, dev, flagship)
    if "parity" in sections:
        out.update(_parity(trees, dev, flagship))
    if "flat" in sections:
        out["flat_bitwise_equal"] = _flat(trees, flagship)
    if "band" in sections:
        out["band"] = _band(trees, dev, band_B)
    if "tree" in sections:
        out["tree"] = _tree(trees, dev, B)
    if "refine" in sections:
        out["refine"] = _refine(trees, dev, flagship)
    if "sweeps" in sections:
        out["sweeps"] = _sweeps(trees, dev, flagship, soft_flagship)
    if "structured" in sections:
        out["structured"] = _structured(trees, dev, flagship, soft_flagship)
    if "forms" in sections:
        out["forms"] = _forms(trees, dev, scales)
    print(json.dumps(out), flush=True)
    return 0


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


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


def _ptxas(m, tag: str, kernel: str = "ipm_resident"):
    """The ptxas lines of a build's ``kernel`` libraries whose name holds
    ``tag``: (library, entry, registers, stack and spills)."""
    out = []
    for lib, log in sorted(m["build"].PTXAS_LOG.items()):
        if not (lib.startswith(f"lib{kernel}_") and tag in lib):
            continue
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "bytes stack frame" in line and entry:
                frame = line.strip()
            elif "Used" in line and "registers" in line and entry:
                regs = line.split("Used")[1].split(",")[0].strip()
                out.append(f"{lib}: {entry}: {regs}, {frame}")
                entry = None
    return out


def _resident(trees, dev, flagship, soft_flagship):
    """Rows 1 and 1s: both builds on the same inputs, bits and ms."""
    import torch

    this = trees["this"]
    res = {"bitwise_equal": {}, "max_abs_diff": {}, "ms": {}}
    for dt in (torch.float32, torch.float64):
        dims, qpb = flagship(this, dt)
        cfg = this["ipm"].IPMConfig(k_max=8, mu_tol=0.0, alpha_min=1e-8,
                                    mu_switch=0.0, use_pallas=True)
        a, kw, _, _ = this["res"].resident_inputs(dims, qpb, cfg)
        cases = [(f"row 1 {dt}", a, kw)]
        cfg_s = this["ipm"].IPMConfig(k_max=8, mu0=100.0, mu_tol=0.0,
                                      use_pallas=True)
        for N, ng in ((SOFT_N, False), (SOFT_NG_N, True)):
            d_s, q_s, sb, idxbs = soft_flagship(this, dt, N, ng)
            for exact in (True, False):
                a_s, kw_s = this["sres"].soft_resident_inputs(
                    d_s, q_s, sb, cfg_s, idxbs, exact)
                cases.append((f"row 1s {dt} N={N}{' ng' if ng else ''} "
                              f"exact={exact}", a_s, kw_s))
        if dt == torch.float32:
            # NZ=19: f32, the hard problem and the soft one (exact)
            d19, q19 = flagship(this, dt, nx=NX19)
            a19, kw19, _, _ = this["res"].resident_inputs(d19, q19, cfg)
            cases.append((f"row 1 NZ=19 {dt}", a19, kw19))
            d_s, q_s, sb, idxbs = soft_flagship(this, dt, nx=NX19)
            a_s, kw_s = this["sres"].soft_resident_inputs(
                d_s, q_s, sb, cfg_s, idxbs, True)
            cases.append((f"row 1s NZ=19 {dt} N={SOFT_N} exact=True", a_s,
                          kw_s))
        for key, a_, kw_ in cases:
            got = [m["rk"].ipm_resident(*_clone(a_), **kw_)
                   for m in trees.values()]
            same, d = _diff(*got)
            kk = got[0][5]
            res["bitwise_equal"][key] = same
            res["max_abs_diff"][key] = d
            print(f"{key}, this vs other build on the same inputs: bitwise "
                  f"equal {same} (max |diff| {d:.3e}); kk {int(kk.min())}-"
                  f"{int(kk.max())}", flush=True)
            if dev.type != "cuda" or not (key.startswith("row 1 ")
                                          or f"N={SOFT_N} exact=True" in key):
                continue
            fns = {k: (lambda m=m: m["rk"].ipm_resident(*a_, **kw_))
                   for k, m in trees.items()}
            ms = _turns(torch, fns, reps=5)
            res["ms"][key] = ms
            print(f"{key} ms a call (other, this, this, other): "
                  + ", ".join(f"{v:.4f}" for v in (ms["other"][0],
                                                   *ms["this"],
                                                   ms["other"][1])),
                  flush=True)
    if dev.type == "cuda":
        dims, _ = flagship(this, torch.float32)
        lib = this["build"].load("ipm_resident", NU=dims.NU, NX=dims.NX,
                                 NB=dims.NB, NG=dims.NG)
        res["team"] = int(lib.hp_ipm_resident_team())
        res["threads"] = int(lib.hp_ipm_resident_threads())
        res["ptxas"] = {k: _ptxas(m, "") for k, m in trees.items()}
        for k, lines in res["ptxas"].items():
            for line in lines:
                print(f"ptxas {k}: {line}", flush=True)
        print(f"this build: team {res['team']} lanes an instance, "
              f"{res['threads']} threads a block", flush=True)
    return res


def _routes(trees, dev, flagship, soft_flagship):
    """The headline and the soft resident routes of both checkouts."""
    import torch

    out = {"bitwise_equal": {}, "ms": {}, "profile": {}}
    runs = {"headline f32": {}, "soft resident f32": {}}
    fns = {"headline f32": {}, "soft resident f32": {}, "soft six f32": {}}
    for label, m in trees.items():
        dims, qpb = flagship(m, torch.float32)
        cfg = m["ipm"].IPMConfig(k_max=8, mu_tol=0.0, alpha_min=1e-8,
                                 mu_switch=0.0, use_pallas=True)
        runs["headline f32"][label] = m["batch"].solve_batched(dims, qpb, cfg)
        fns["headline f32"][label] = (
            lambda m=m, d=dims, q=qpb, c=cfg: m["batch"].solve_batched(d, q,
                                                                       c))
        d_s, q_s, sb, idxbs = soft_flagship(m, torch.float32)
        cfg_s = m["ipm"].IPMConfig(k_max=8, mu0=100.0, mu_tol=0.0,
                                   use_pallas=True)

        def soft(env, m=m, d=d_s, q=q_s, sb=sb, c=cfg_s, i=idxbs):
            with _env(**env):
                return m["batch"].solve_batched_soft(d, q, sb, c, idxbs=i)

        res_env = dict(HPMPC_RESIDENT="1")
        six_env = dict(HPMPC_RESIDENT="0", HPMPC_MEGA_SWEEPS="0")
        runs["soft resident f32"][label] = soft(res_env)
        fns["soft resident f32"][label] = lambda s=soft: s(res_env)
        fns["soft six f32"][label] = lambda s=soft: s(six_env)
    for key, sols in runs.items():
        t, o = sols["this"], sols["other"]
        fields = {f: _diff(getattr(t, f), getattr(o, f))[0]
                  for f in t._fields}
        out["bitwise_equal"][key] = all(fields.values())
        print(f"{key} route, this vs other: bitwise equal per field "
              f"{fields}", flush=True)
    if dev.type != "cuda":
        return out
    for key, f in fns.items():
        ms = _turns(torch, f, reps=3)
        out["ms"][key] = ms
        print(f"{key} ms a batch (other, this, this, other): " + ", ".join(
            f"{v:.3f}" for v in (ms["other"][0], *ms["this"],
                                 ms["other"][1])), flush=True)
        if key == "soft six f32":
            continue
        prof = {k: _profile(torch, fn, r"\bipm_resident_kernel\b")
                for k, fn in f.items()}
        out["profile"][key] = prof
        for k in ("other", "this"):
            p = prof[k]
            print(f"{key} profile, {k}: wall {p['wall']:.3f} ms, device "
                  f"busy {p['busy']:.3f} ms (idle share {p['idle']:.1%}), "
                  f"ipm_resident {p['kern_ms']:.3f} ms in "
                  f"{p['kern_n']:.0f}", flush=True)
    return out


def _first_apart(a, b, row="stage") -> str:
    """The first output (by its place in the flattened outputs, None
    skipped) whose bits differ between two builds' outputs, and its first
    leading-axis ``row`` (a stage, a node or an edge) apart."""
    import torch

    flat = lambda o: [x for v in o if v is not None for x in (
        v if isinstance(v, tuple) else (v,))]  # noqa: E731
    for i, (x, y) in enumerate(zip(flat(a), flat(b))):
        apart = (x.contiguous().view(torch.uint8).reshape(x.shape[0], -1)
                 != y.contiguous().view(torch.uint8).reshape(y.shape[0], -1)
                 ).any(1).nonzero()
        if apart.numel():
            return f"output {i}, {row} {int(apart[0])}"
    return "none"


def _mega_inputs(m, dims, qpb, cfg, run):
    """The first phase-1 and the first phase-2 call of rows 19 and 20 in
    ``run(dims, qpb, cfg)`` on the checkout ``m``: {(name, phase2): (args,
    kwargs)}; a phase the run does not reach is taken from the lanes
    engine run in it alone (``mu_switch=1e9``, two iterations)."""
    mk = m["mk"]
    calls, saved = {}, {k: getattr(mk, k) for k in MEGA}

    def spy(name, fn):
        def call(*a, **k):
            calls.setdefault((name, bool(k["phase2"])), (_clone(a), dict(k)))
            return fn(*a, **k)
        return call

    for k, fn in saved.items():
        setattr(mk, k, spy(k, fn))
    try:
        run(dims, qpb, cfg)
        if len(calls) < 2 * len(MEGA):
            m["lanes"].solve_batched_lanes(dims, qpb, dataclasses.replace(
                cfg, k_max=2, mu_switch=1e9))
    finally:
        for k, fn in saved.items():
            setattr(mk, k, fn)
    return calls


def _mega(trees, dev, flagship):
    """Rows 19 and 20: both builds on this checkout's lanes-engine inputs,
    bits, ms in turns and ptxas; the lanes route f32, the f64 lanes run and
    route C of both checkouts: bits, ms a batch in turns, one profile."""
    import torch

    this = trees["this"]
    out = {"bitwise_equal": {}, "max_abs_diff": {}, "ms": {}}
    cfg = this["ipm"].IPMConfig(k_max=30, use_pallas=True)
    solve = this["batch"].solve_batched
    lanes = this["lanes"].solve_batched_lanes
    problems = [("flagship f32", torch.float32, {}, solve),
                ("flagship f64", torch.float64, {}, lanes),
                ("box-only f32", torch.float32, dict(ngN=0), lanes),
                ("box-only f64", torch.float64, dict(ngN=0), lanes),
                ("NZ=19 f32", torch.float32, dict(nx=NX19, ngN=0), lanes),
                ("NZ=19 f64", torch.float64, dict(nx=NX19, ngN=0), lanes)]
    for what, dt, kw, run in problems:
        dims, qpb = flagship(this, dt, nx=kw.get("nx", 8),
                             ngN=kw.get("ngN", 8))
        calls = _mega_inputs(this, dims, qpb, cfg, run)
        for (name, ph), (a, k) in sorted(calls.items()):
            key = f"{name} {what} phase {2 if ph else 1}"
            got = [getattr(m["mk"], name)(*_clone(a), **k)
                   for m in trees.values()]
            same, d = _diff(*got)
            out["bitwise_equal"][key] = same
            out["max_abs_diff"][key] = d
            line = (f"{key}, this vs other build on the same inputs: "
                    f"bitwise equal {same} (max |diff| {d:.3e})")
            if not same:
                line += f"; first apart: {_first_apart(*got)}"
            if dev.type == "cuda" and what.startswith(("flagship", "NZ")):
                fns = {lbl: (lambda m=m: getattr(m["mk"], name)(*a, **k))
                       for lbl, m in trees.items()}
                ms = _turns(torch, fns, reps=20)
                out["ms"][key] = ms
                line += "; ms a call (other, this, this, other): " + (
                    ", ".join(f"{v:.4f}" for v in (ms["other"][0],
                                                   *ms["this"],
                                                   ms["other"][1])))
            print(line, flush=True)
    if dev.type != "cuda":
        return out
    dims, _ = flagship(this, torch.float32)
    shape = dict(NU=dims.NU, NX=dims.NX, NB=dims.NB)
    out["team"] = {k: int(getattr(this["build"].load(k, **shape),
                                  f"hp_{k}_team")()) for k in MEGA}
    out["ptxas"] = {lbl: [x for k in MEGA for x in _ptxas(m, "", k)]
                    for lbl, m in trees.items()}
    for lbl, lines in out["ptxas"].items():
        for line in lines:
            print(f"ptxas {lbl}: {line}", flush=True)
    print(f"this build: team {out['team']} lanes an instance", flush=True)
    # the routes: lanes f32 (solve_batched), the f64 lanes run, route C
    out["route_bitwise_equal"], out["route_ms"] = {}, {}
    out["route_profile"] = {}
    routes = (("lanes f32", torch.float32, {}, False),
              ("lanes f64", torch.float64, {}, True),
              ("route C f32", torch.float32, dict(escalate_stalled=True),
               False))
    for key, dt, extra, direct in routes:
        sols, fns = {}, {}
        for lbl, m in trees.items():
            d, q = flagship(m, dt)
            c = m["ipm"].IPMConfig(k_max=30, use_pallas=True, **extra)
            fn = m["lanes"].solve_batched_lanes if direct else \
                m["batch"].solve_batched
            sols[lbl] = fn(d, q, c)
            fns[lbl] = (lambda fn=fn, d=d, q=q, c=c: fn(d, q, c))
        t, o = sols["this"], sols["other"]
        fields = {f: _diff(getattr(t, f), getattr(o, f))[0]
                  for f in t._fields}
        out["route_bitwise_equal"][key] = all(fields.values())
        print(f"{key} route, this vs other: bitwise equal per field "
              f"{fields}", flush=True)
        ms = _turns(torch, fns, reps=3)
        out["route_ms"][key] = ms
        print(f"{key} ms a batch (other, this, this, other): " + ", ".join(
            f"{v:.3f}" for v in (ms["other"][0], *ms["this"],
                                 ms["other"][1])), flush=True)
        prof = {lbl: _profile(torch, fn, r"\bfactor_solve_mega_kernel\b",
                              parts={"row 20": r"\bsolve_mega_kernel\b"})
                for lbl, fn in fns.items()}
        out["route_profile"][key] = prof
        for lbl in ("other", "this"):
            p = prof[lbl]
            print(f"{key} profile, {lbl}: wall {p['wall']:.3f} ms, device "
                  f"busy {p['busy']:.3f} ms (idle share {p['idle']:.1%}), "
                  f"row 19 {p['kern_ms']:.3f} ms in {p['kern_n']:.0f}, row "
                  f"20 {p['parts']['row 20'][0]:.3f} ms in "
                  f"{p['parts']['row 20'][1]:.0f}", flush=True)
    return out


def _parity(trees, dev, flagship):
    """bench.py's parity route of both checkouts: its stage kernels on the
    same inputs and the solutions, bit for bit, and the control errors."""
    import torch

    out = {}
    runs = {}
    for label, m in trees.items():
        dims, qpb = flagship(m, torch.float32)
        cfg = m["ipm"].IPMConfig(k_max=8, mu_tol=0.0, alpha_min=1e-8,
                                 iter_ref=1, iter_ref_mu_thr=1e-3,
                                 use_pallas=True)
        calls = {k: [] for k in KERNELS}
        saved = {k: getattr(m["sk"], k) for k in KERNELS}

        def spy(name, fn, calls=calls):
            def call(*a, **k):
                res = fn(*a, **k)
                if len(calls[name]) < CALLS:
                    calls[name].append((_clone(a), dict(k), _clone(res)))
                return res
            return call

        for k, fn in saved.items():
            setattr(m["sk"], k, spy(k, fn))
        try:
            engine = m["batch"].select_engine(dims, cfg, qpb.b.shape[0],
                                              torch.float32)
            sol = m["batch"].solve_batched(dims, qpb, cfg)
            raw = m["batch"].solve_batched(
                dims, qpb, dataclasses.replace(cfg, iter_ref=0))
        finally:
            for k, fn in saved.items():
                setattr(m["sk"], k, fn)
        runs[label] = (sol, raw, calls, engine)
        print(f"{label}: engine {engine}, calls captured "
              f"{ {k: len(v) for k, v in calls.items()} }", flush=True)

    this, other = trees["this"], trees["other"]
    kern = {}
    for name in KERNELS:
        for i, (a, k, res) in enumerate(runs["this"][2][name]):
            got_t = getattr(this["sk"], name)(*_clone(a), **k)
            got_o = getattr(other["sk"], name)(*_clone(a), **k)
            same, d = _diff(got_t, got_o)
            rerun, _ = _diff(got_t, res)
            kern[f"{name}#{i}"] = dict(bitwise_equal=same, max_abs_diff=d,
                                       rerun_equal=rerun)
            print(f"{name} call {i}: this vs other build on the same inputs"
                  f": bitwise equal {same} (max |diff| {d:.3e}); rerun "
                  f"equals the route's output {rerun}", flush=True)
    out["kernels"] = kern

    dims64, q64 = flagship(this, torch.float64)
    ref = this["lanes"].solve_batched_lanes(
        dims64, q64, this["ipm"].IPMConfig(k_max=8, mu_tol=0.0,
                                           use_pallas=True)).z
    NU = dims64.NU

    def ctrl_err(sol):
        e = (sol.z[..., :NU].double() - ref[..., :NU]).abs().amax((1, 2))
        return float(e.max()), float(e.median())

    for label, (sol, raw, _, engine) in runs.items():
        (mx, md), (rmx, rmd) = ctrl_err(sol), ctrl_err(raw)
        out[label] = dict(engine=engine, ctrl_max=mx, ctrl_median=md,
                          unrefined_max=rmx, unrefined_median=rmd)
        print(f"{label}: parity control error max {mx:.6e} (median "
              f"{md:.6e}); unrefined max {rmx:.6e} (median {rmd:.6e})",
              flush=True)
    sol_t, sol_o = runs["this"][0], runs["other"][0]
    fields = {f: _diff(getattr(sol_t, f), getattr(sol_o, f))[0]
              for f in sol_t._fields}
    out["route_bitwise_equal"] = all(fields.values())
    print(f"parity route, this vs other: bitwise equal per field {fields}",
          flush=True)
    return out


def _flat(trees, flagship):
    """The chain's flat form, unrefined and with the unfused refinement,
    of both checkouts: bit for bit."""
    import torch

    out = {}
    for iter_ref in (0, 1):
        sols = []
        for m in trees.values():
            dims, qpb = flagship(m, torch.float32)
            cfg = m["ipm"].IPMConfig(k_max=8, mu_tol=0.0, iter_ref=iter_ref,
                                     use_pallas=True)
            sols.append(m["lanes"].solve_batched_lanes(dims, qpb, cfg,
                                                       flat=True))
        fields = {f: _diff(getattr(sols[0], f), getattr(sols[1], f))[0]
                  for f in sols[0]._fields}
        out[f"iter_ref={iter_ref}"] = all(fields.values())
        print(f"flat form iter_ref={iter_ref}, this vs other: bitwise equal "
              f"per field {fields}", flush=True)
    return out


def _turns(torch, fns: dict, reps: int) -> dict:
    """ms a call of each of ``fns`` ("other", "this"), CUDA events after a
    warm-up, in turns other, this, this, other; each one's two means."""
    times = {k: [] for k in fns}
    for k in ("other", "this", "this", "other"):
        fns[k]()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fns[k]()
        end.record()
        torch.cuda.synchronize()
        times[k].append(start.elapsed_time(end) / reps)
    return times


def _time(torch, fn, reps: int = 20) -> float:
    """ms a call of ``fn``, CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profile(torch, fn, kernel=r"\bcholesky_kernel\b", parts=None) -> dict:
    """One call of ``fn`` under ``torch.profiler`` after a warm-up: host
    wall ms, device busy ms (the kernels' summed time), the idle share, and
    the summed ms and launches of the kernels whose name matches ``kernel``
    (row 24's ``cholesky_kernel`` by default); ``parts`` ({label: regex})
    adds (ms, launches) of more kernels under ``out["parts"]``."""
    import re
    import time

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out = dict(wall=wall, busy=0.0, kern_ms=0.0, kern_n=0,
               parts={k: [0.0, 0] for k in (parts or {})})
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        out["busy"] += ms
        if re.search(kernel, e.key):
            out["kern_ms"] += ms
            out["kern_n"] += e.count
        for k, pat in (parts or {}).items():
            if re.search(pat, e.key):
                out["parts"][k][0] += ms
                out["parts"][k][1] += e.count
    out["idle"] = 1 - out["busy"] / wall
    return out


def _band(trees, dev, B):
    """Row 24 on the band's first input and on random SPD batches, both
    builds, bits and ms; the band's solve_batched of both checkouts."""
    import numpy as np
    import torch

    this = trees["this"]
    out = {"chol": {}, "chol_ms": {}}
    for dt in (torch.float32, torch.float64):
        dims, qp = this["ms"].mass_spring_qp(*BAND, 30, dtype=dt, device=dev)
        qpb = this["batch"].broadcast_qp(qp, B)
        cfg = this["ipm"].IPMConfig(k_max=1, mu_tol=0.0, alpha_min=1e-8,
                                    use_pallas=True)
        seen, saved = [], this["bc"].cholesky

        def spy(M):
            if not seen:
                seen.append(M.clone())
            return saved(M)

        this["bc"].cholesky = spy
        try:
            this["batch"].solve_batched(dims, qpb, cfg)
        finally:
            this["bc"].cholesky = saved
        inputs = [("band", seen[0])]
        for n, Bn in CHOL_RANDOM:
            X = np.random.default_rng(n).standard_normal((Bn, n, n))
            inputs.append((f"random n={n}", torch.as_tensor(
                X @ X.transpose(0, 2, 1) + n * np.eye(n), dtype=dt,
                device=dev)))
        for what, M in inputs:
            key = f"{what} {tuple(M.shape)} {dt}"
            got = [m["bc"].cholesky(M) for m in trees.values()]
            same, d = _diff(*got)
            out["chol"][key] = dict(bitwise_equal=same, max_abs_diff=d)
            line = (f"row 24 {key}, this vs other build: bitwise equal "
                    f"{same} (max |diff| {d:.3e})")
            if dev.type == "cuda":
                ms = _turns(torch, {k: (lambda m=m: m["bc"].cholesky(M))
                                    for k, m in trees.items()}, reps=50)
                # the yardstick: one library call on the same batch
                lib = _turns(torch, {k: (lambda: torch.linalg.cholesky(M))
                                     for k in trees}, reps=20)
                ms["library"] = lib["this"] + lib["other"]
                out["chol_ms"][key] = ms
                line += "; ms a call (other, this, this, other): " + (
                    ", ".join(f"{v:.4f}" for v in (ms["other"][0],
                                                   *ms["this"],
                                                   ms["other"][1])))
                line += ("; torch.linalg.cholesky " + ", ".join(
                    f"{v:.4f}" for v in ms["library"]))
            print(line, flush=True)
    # the band end to end, k_max 8: nx=64 f32 and f64 (B), nx=128 f32 (B/2)
    out["band_bitwise_equal"], out["band_ms"], out["band_profile"] = {}, {}, {}
    for nx, nu, dname in BAND_RUNS:
        dt = getattr(torch, dname)
        Bn = B if nx == BAND[0] else max(1, B // 2)
        key = f"nx={nx} {dname} B={Bn}"
        runs, fns = {}, {}
        for label, m in trees.items():
            dims, qp = m["ms"].mass_spring_qp(nx, nu, 30, dtype=dt,
                                              device=dev)
            qpb = m["batch"].broadcast_qp(qp, Bn)
            sc = 1 + 0.02 * np.random.default_rng(0).standard_normal(Bn)
            qpb = dataclasses.replace(qpb, b=qpb.b * torch.as_tensor(
                sc, dtype=dt, device=dev)[:, None, None])
            cfg = m["ipm"].IPMConfig(k_max=8, mu_tol=0.0, alpha_min=1e-8,
                                     use_pallas=True)
            runs[label] = m["batch"].solve_batched(dims, qpb, cfg)
            fns[label] = (lambda m=m, d=dims, q=qpb, c=cfg:
                          m["batch"].solve_batched(d, q, c))
        fields = {f: _diff(getattr(runs["this"], f),
                           getattr(runs["other"], f))[0]
                  for f in runs["this"]._fields}
        out["band_bitwise_equal"][key] = all(fields.values())
        print(f"band solve_batched {key}, this vs other: bitwise equal per "
              f"field {fields}", flush=True)
        if dev.type != "cuda":
            continue
        ms = _turns(torch, fns, reps=2)
        prof = {k: _profile(torch, fn) for k, fn in fns.items()}
        out["band_ms"][key], out["band_profile"][key] = ms, prof
        print(f"band solve_batched {key} ms a batch (other, this, this, "
              "other): " + ", ".join(f"{v:.3f}" for v in (
                  ms["other"][0], *ms["this"], ms["other"][1])), flush=True)
        for k in ("other", "this"):
            p = prof[k]
            print(f"band {key} profile, {k}: wall {p['wall']:.3f} ms, device "
                  f"busy {p['busy']:.3f} ms (idle share {p['idle']:.1%}), "
                  f"row 24 {p['kern_ms']:.3f} ms in {p['kern_n']:.0f} "
                  f"launches ({p['kern_ms'] / p['busy']:.1%} of busy)",
                  flush=True)
    return out


def _tree_inputs(m, tdef, dims, qpb, cfg):
    """The first and the last call of rows 26 and 27 in a flat tree solve
    on the checkout ``m``: {(name, "first" / "last"): (args, kwargs)}."""
    tk, calls = m["tk"], {}
    saved = {k: getattr(tk, k) for k in TREE}

    def spy(name, fn):
        def call(*a, **k):
            calls.setdefault((name, "first"), (_clone(a), dict(k)))
            calls[(name, "last")] = (_clone(a), dict(k))
            return fn(*a, **k)
        return call

    for k, fn in saved.items():
        setattr(tk, k, spy(k, fn))
    try:
        m["tree"].solve_tree_ipm_flat(tdef, dims, qpb, cfg)
    finally:
        for k, fn in saved.items():
            setattr(tk, k, fn)
    return calls


def _tree(trees, dev, B):
    """Rows 26 and 27: both builds on this checkout's flat-tree inputs,
    bits, ms in turns, ptxas and the launch layout; solve_batched_tree of
    both checkouts at 71 nodes f32: bits, ms a batch in turns, a profile."""
    import numpy as np
    import torch

    this = trees["this"]
    out = {"bitwise_equal": {}, "max_abs_diff": {}, "ms": {}, "layout": {}}
    sc = 1 + 0.02 * np.random.default_rng(0).standard_normal(B)

    def batch(m, topo, dt, ng_nodes=()):
        md, Nr, Nh = topo
        tdef, dims, qp = m["ms"].mass_spring_tree_qp(
            md=md, Nr=Nr, Nh=Nh, nx=4, nu=2, ng_nodes=ng_nodes, dtype=dt,
            device=dev)
        qpb = m["batch"].broadcast_qp(qp, B)
        s = torch.as_tensor(sc, dtype=dt, device=dev)
        return tdef, dims, dataclasses.replace(qpb, b=qpb.b * s[:, None, None])

    cfg = this["ipm"].IPMConfig(k_max=8, mu_tol=0.0, use_pallas=True)
    cases = [(topo, ng, dt) for topo in TREE_TOPOS for ng in ((), (0, 5))
             for dt in (torch.float32, torch.float64)
             if not ng or topo == TREE_TOPOS[1]]
    for topo, ng, dt in cases:
        tdef, dims, qpb = batch(this, topo, dt, ng)
        n = tdef.n_nodes
        calls = _tree_inputs(this, tdef, dims, qpb, cfg)
        a, k = calls[("tree_factor_solve_flat", "first")]
        calls[("tree_factor_solve_flat", "first want_pi")] = (
            a, dict(k, want_pi=True))
        a, k = calls[("tree_factor_solve_flat", "last")]
        calls[("tree_factor_solve_flat", "last want_pi")] = (
            a, dict(k, want_pi=True))
        what = (f"{n} nodes{' ng nodes (0, 5)' if ng else ''} "
                f"{str(dt).split('.')[-1]}")
        if dev.type == "cuda":
            wmax = max(map(len, tdef.levels))
            for solve in (False, True):
                lay = this["tk"].layout(n, wmax, solve, dt, NU=dims.NU,
                                        NX=dims.NX)
                out["layout"][f"{TREE[solve]} {what}"] = lay
                print(f"{TREE[solve]} {what}: this build's layout {lay}",
                      flush=True)
        for (name, when), (a, k) in sorted(calls.items()):
            key = f"{name} {what} {when} call"
            got = [getattr(m["tk"], name)(*_clone(a), **k)
                   for m in trees.values()]
            same, d = _diff(*got)
            out["bitwise_equal"][key] = same
            out["max_abs_diff"][key] = d
            line = (f"{key}, this vs other build on the same inputs: "
                    f"bitwise equal {same} (max |diff| {d:.3e})")
            if not same:
                line += (f"; first apart: "
                         f"{_first_apart(*got, 'node (edge: node - 1)')}")
            if (dev.type == "cuda" and dt == torch.float32 and not ng
                    and when.startswith("first")):
                fns = {lbl: (lambda m=m: getattr(m["tk"], name)(*a, **k))
                       for lbl, m in trees.items()}
                ms = _turns(torch, fns, reps=20)
                out["ms"][key] = ms
                line += "; ms a call (other, this, this, other): " + (
                    ", ".join(f"{v:.4f}" for v in (ms["other"][0],
                                                   *ms["this"],
                                                   ms["other"][1])))
            print(line, flush=True)
    # one state (NX = 1): a child's terms reach its parent as factors;
    # random SPD data on the 15-node tree (md=2 Nr=2 Nh=4), NU = 1
    rng = np.random.default_rng(1)
    dad = this["tree"].TreeDef.from_md_nr_nh(2, 2, 4).dad
    n = len(dad)
    for dt in (torch.float32, torch.float64):
        def t(x, dt=dt):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                                   device=dev)
        A = rng.standard_normal((n, 2, 2, B))
        M = np.einsum("nijb,nkjb->nikb", A, A) + 2 * np.eye(2)[..., None]
        g, F, b = (t(rng.standard_normal((n, 2, B))),
                   t(0.5 * rng.standard_normal((n - 1, 2, 1, B))),
                   t(rng.standard_normal((n - 1, 1, B))))
        a = (dad, t(M[:, [0, 1, 1], [0, 0, 1]]),
             t(rng.uniform(0.1, 1.0, (n, 2, B))), None, (), g, F, b)
        ks = dict(NU=1, NZ=2, NX=1)
        _, _, (Ll, Lxx, Pb) = this["tk"].tree_factor_solve_flat(
            *a, want_pi=False, **ks)
        for name, a_, k_ in (
                ("tree_factor_solve_flat", a, dict(ks, want_pi=True)),
                ("tree_solve_flat", (dad, Ll, Lxx, Pb, g, F, b), ks)):
            key = f"{name} NX=1 random {str(dt).split('.')[-1]}"
            got = [getattr(m["tk"], name)(*_clone(a_), **k_)
                   for m in trees.values()]
            same, d = _diff(*got)
            out["bitwise_equal"][key] = same
            out["max_abs_diff"][key] = d
            print(f"{key}, this vs other build on the same inputs: bitwise "
                  f"equal {same} (max |diff| {d:.3e})", flush=True)
    if dev.type != "cuda":
        return out
    out["ptxas"] = {lbl: _ptxas(m, "", "tree_sweeps")
                    for lbl, m in trees.items()}
    for lbl, lines in out["ptxas"].items():
        for line in lines:
            print(f"ptxas {lbl}: {line}", flush=True)
    # the route: solve_batched_tree, 71 nodes, f32
    sols, fns = {}, {}
    for lbl, m in trees.items():
        tdef, dims, qpb = batch(m, TREE_TOPOS[1], torch.float32)
        c = m["ipm"].IPMConfig(k_max=8, mu_tol=0.0, use_pallas=True)
        sols[lbl] = m["batch"].solve_batched_tree(tdef, dims, qpb, c)
        fns[lbl] = (lambda m=m, t=tdef, d=dims, q=qpb, c=c:
                    m["batch"].solve_batched_tree(t, d, q, c))
    # the route's edge scatter (models/tree.py apply_fpi, index_add over
    # siblings) adds with atomics on the card: a checkout against itself
    # first, then both in PyTorch's deterministic mode
    again = fns["other"]()

    def per_field(t, o):
        return {f: _diff(getattr(t, f), getattr(o, f))[0] for f in t._fields}

    fields = per_field(sols["other"], again)
    out["route_rerun_bitwise_equal"] = all(fields.values())
    print(f"tree route 71 nodes f32, other vs other (a second run): bitwise "
          f"equal per field {fields}", flush=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det = {lbl: fn() for lbl, fn in fns.items()}
    finally:
        torch.use_deterministic_algorithms(False)
    fields = per_field(det["this"], det["other"])
    out["route_bitwise_equal"] = all(fields.values())
    print(f"tree route 71 nodes f32 in deterministic mode, this vs other: "
          f"bitwise equal per field {fields}", flush=True)
    fields = per_field(sols["this"], sols["other"])
    print(f"tree route 71 nodes f32, this vs other (default mode): bitwise "
          f"equal per field {fields}", flush=True)
    ms = _turns(torch, fns, reps=3)
    out["route_ms"] = ms
    print("tree route 71 nodes f32 ms a batch (other, this, this, other): "
          + ", ".join(f"{v:.3f}" for v in (ms["other"][0], *ms["this"],
                                           ms["other"][1])), flush=True)
    prof = {lbl: _profile(torch, fn, r"\btree_factor_solve_flat_kernel\b",
                          parts={"row 27": r"\btree_solve_flat_kernel\b"})
            for lbl, fn in fns.items()}
    out["route_profile"] = prof
    for lbl in ("other", "this"):
        p = prof[lbl]
        print(f"tree route profile, {lbl}: wall {p['wall']:.3f} ms, device "
              f"busy {p['busy']:.3f} ms (idle share {p['idle']:.1%}), row 26 "
              f"{p['kern_ms']:.3f} ms in {p['kern_n']:.0f}, row 27 "
              f"{p['parts']['row 27'][0]:.3f} ms in "
              f"{p['parts']['row 27'][1]:.0f}", flush=True)
    return out


def _refine_inputs(m, dims, qpb, cfg, run, flat):
    """The first and the last call of each phase of rows 11 and 13 in
    ``run(dims, qpb, cfg)`` on the checkout ``m``: {(name, phase, "first" /
    "last"): (args, kwargs)}, the phase from the lanes engine's prep pass;
    a phase the run does not reach is taken from the lanes engine (its
    flat form with ``flat``) run in it alone (``mu_switch=1e9``, two
    iterations)."""
    sk, stk = m["sk"], m["stk"]
    calls, phase = {}, [1]
    saved = [(sk, k, getattr(sk, k)) for k in REFINE] + [
        (stk, "prep_flat", stk.prep_flat)]

    def spy(name, fn):
        def call(*a, **k):
            if name == "prep_flat":
                phase[0] = 2 if k.get("phase2") else 1
            else:
                calls.setdefault((name, phase[0], "first"), (_clone(a),
                                                              dict(k)))
                calls[(name, phase[0], "last")] = (_clone(a), dict(k))
            return fn(*a, **k)
        return call

    for mod, k, fn in saved:
        setattr(mod, k, spy(k, fn))
    try:
        run(dims, qpb, cfg)
        if not any(ph == 2 for _, ph, _ in calls):
            m["lanes"].solve_batched_lanes(
                dims, qpb, dataclasses.replace(cfg, k_max=2, mu_switch=1e9),
                flat=flat)
    finally:
        for mod, k, fn in saved:
            setattr(mod, k, fn)
    return calls


def _refine(trees, dev, flagship):
    """Rows 11 and 13: both builds on this checkout's inputs of their
    routes, bits, ms in turns, ptxas, the launch layout and the
    fused-vs-unfused check; the parity route and route D of both
    checkouts: bits, ms a batch in turns, one profile each."""
    import torch

    this = trees["this"]
    IPMConfig = this["ipm"].IPMConfig
    out = {"bitwise_equal": {}, "max_abs_diff": {}, "ms": {}, "layout": {}}
    cfg_par = IPMConfig(k_max=8, mu_tol=0.0, alpha_min=1e-8, iter_ref=1,
                        iter_ref_mu_thr=1e-3, use_pallas=True)
    cfg_ref64 = IPMConfig(k_max=30, iter_ref=1, iter_ref_mu_thr=1e-3,
                          use_pallas=True)
    cfg_d = IPMConfig(k_max=8, mu_tol=0.0, alpha_min=1e-8, iter_ref=1,
                      use_pallas=True)
    cfg_e = IPMConfig(iter_ref=1, use_pallas=True)
    solve = this["batch"].solve_batched
    lanes = this["lanes"].solve_batched_lanes
    runs = (("refine_flat_fused", torch.float32, cfg_par, solve, False),
            ("refine_flat_fused", torch.float64, cfg_ref64, lanes, False),
            ("solve_flat_pb", torch.float32, cfg_d, solve, True),
            ("solve_flat_pb", torch.float64, cfg_e, solve, True))
    problems = (("flagship", {}), ("box-only", dict(ngN=0)),
                ("NZ=19", dict(nx=NX19, ngN=0)))
    fused_inputs = None
    for (what, kw), (row, dt, cfg, run, flat) in itertools.product(
            problems, runs):
        dn = str(dt).split(".")[-1]
        dims, qpb = flagship(this, dt, **kw)
        calls = _refine_inputs(this, dims, qpb, cfg, run, flat)
        for (name, ph, when), (a, k) in sorted(calls.items()):
            if name != row:
                continue
            if (name, what, dn, ph, when) == (
                    "refine_flat_fused", "flagship", "float64", 1, "first"):
                fused_inputs = (a, k)
            key = f"{name} {what} {dn} phase {ph} {when} call"
            got = [getattr(m["sk"], name)(*_clone(a), **k)
                   for m in trees.values()]
            same, d = _diff(*got)
            out["bitwise_equal"][key] = same
            out["max_abs_diff"][key] = d
            line = (f"{key}, this vs other build on the same inputs: "
                    f"bitwise equal {same} (max |diff| {d:.3e})")
            if not same:
                line += f"; first apart: {_first_apart(*got)}"
            if (dev.type == "cuda" and what != "box-only" and ph == 1
                    and when == "first"):
                fns = {lbl: (lambda m=m: getattr(m["sk"], name)(*a, **k))
                       for lbl, m in trees.items()}
                ms = _turns(torch, fns, reps=20)
                out["ms"][key] = ms
                line += "; ms a call (other, this, this, other): " + (
                    ", ".join(f"{v:.4f}" for v in (ms["other"][0],
                                                   *ms["this"],
                                                   ms["other"][1])))
            print(line, flush=True)
        if dev.type == "cuda" and what != "box-only":
            dims_ = dict(NU=dims.NU, NX=dims.NX)
            if row == "refine_flat_fused":
                dims_["NG"] = max(dims.NG, 1)
            lay = this["sk"].resolve_layout(row, dims.N, dt, **dims_)
            out["layout"][f"{row} {what} {dn}"] = lay
            print(f"{row} {what} {dn}: this build's layout {lay}",
                  flush=True)
    # the fused pass against the unfused one, float64, the kernels
    sk = this["sk"]
    a, k = fused_inputs
    out["fused_vs_unfused"] = {}
    for moved in (False, True):
        a_ = list(_clone(a))
        if moved:
            gen = torch.Generator().manual_seed(1)
            for i in (8, 9):
                a_[i] = a_[i] + 0.1 * torch.randn(
                    a_[i].shape, generator=gen, dtype=a_[i].dtype).to(dev)
        f = sk.refine_flat_fused(*a_, **k)
        u = sk.refine_flat_unfused(*a_, **k)
        rel = [float((x - y).abs().max()) / max(1.0, float(y.abs().max()))
               for x, y in zip(f, u)]
        key = "moved" if moved else "as captured"
        out["fused_vs_unfused"][key] = rel
        print(f"fused vs unfused refinement pass, flagship float64 first "
              f"call {key}: max |diff| / scale z {rel[0]:.3e}, pi "
              f"{rel[1]:.3e}", flush=True)
    if dev.type != "cuda":
        return out
    out["ptxas"] = {lbl: _ptxas(m, "", "refine_flat")
                    + [x for x in _ptxas(m, "", "solve_flat")
                       if "pb" in x or "Lb1E" in x]
                    for lbl, m in trees.items()}
    for lbl, lines in out["ptxas"].items():
        for line in lines:
            print(f"ptxas {lbl}: {line}", flush=True)
    # the routes: the parity line and route D, float32
    out["route_bitwise_equal"], out["route_ms"] = {}, {}
    out["route_profile"] = {}
    for key, cfg in (("parity f32", cfg_par), ("route D f32", cfg_d)):
        sols, fns = {}, {}
        for lbl, m in trees.items():
            d, q = flagship(m, torch.float32)
            c = dataclasses.replace(cfg)
            fn = m["batch"].solve_batched
            sols[lbl] = fn(d, q, c)
            fns[lbl] = (lambda fn=fn, d=d, q=q, c=c: fn(d, q, c))
        t, o = sols["this"], sols["other"]
        fields = {f: _diff(getattr(t, f), getattr(o, f))[0]
                  for f in t._fields}
        out["route_bitwise_equal"][key] = all(fields.values())
        print(f"{key} route, this vs other: bitwise equal per field "
              f"{fields}", flush=True)
        ms = _turns(torch, fns, reps=3)
        out["route_ms"][key] = ms
        print(f"{key} ms a batch (other, this, this, other): " + ", ".join(
            f"{v:.3f}" for v in (ms["other"][0], *ms["this"],
                                 ms["other"][1])), flush=True)
        prof = {lbl: _profile(torch, fn, REFINE_PROFILE["row 13"],
                              parts={"row 11": REFINE_PROFILE["row 11"]})
                for lbl, fn in fns.items()}
        out["route_profile"][key] = prof
        for lbl in ("other", "this"):
            p = prof[lbl]
            print(f"{key} profile, {lbl}: wall {p['wall']:.3f} ms, device "
                  f"busy {p['busy']:.3f} ms (idle share {p['idle']:.1%}), "
                  f"row 13 {p['kern_ms']:.3f} ms in {p['kern_n']:.0f}, row "
                  f"11 {p['parts']['row 11'][0]:.3f} ms in "
                  f"{p['parts']['row 11'][1]:.0f}", flush=True)
    return out


def _sweep_inputs(m, run, names=tuple(SWEEPS)):
    """The first and the last call of the wrappers ``names`` (rows 9 and
    10) in ``run()`` on the checkout ``m``: {(name, "first" / "last"):
    (args, kwargs)}."""
    sk = m["sk"]
    calls = {}
    saved = {k: getattr(sk, k) for k in names}

    def spy(name, fn):
        def call(*a, **k):
            calls.setdefault((name, "first"), (_clone(a), dict(k)))
            calls[(name, "last")] = (_clone(a), dict(k))
            return fn(*a, **k)
        return call

    for k, fn in saved.items():
        setattr(sk, k, spy(k, fn))
    try:
        run()
    finally:
        for k, fn in saved.items():
            setattr(sk, k, fn)
    return calls


def _sweeps(trees, dev, flagship, soft_flagship):
    """Rows 9 and 10 (and their fused forms, rows 18 and 17): both builds
    on this checkout's inputs of the first and the last call in each
    default route of the 6-kernel loop, bits, ms in turns, ptxas and the
    launch layout; then the routes of both checkouts: bits, ms a batch in
    turns, one profile each (busy ms, idle share, rows 9 and 10's ms and
    launches)."""
    import torch

    this = trees["this"]
    out = {"bitwise_equal": {}, "max_abs_diff": {}, "ms": {}, "layout": {},
           "route_bitwise_equal": {}, "route_ms": {}, "route_profile": {}}

    def route(m, key, dt, **kw):
        """(solve(), the route's solution fields) of route ``key`` on the
        checkout ``m``: the parity line, route D, route E or a soft 6-kernel
        loop, on the flagship (``kw``: its changes) in ``dt``."""
        IPMConfig = m["ipm"].IPMConfig
        if key.startswith("soft"):
            d, q, sb, idxbs = soft_flagship(m, dt, **kw)
            c = IPMConfig(k_max=8, mu0=100.0, mu_tol=0.0, use_pallas=True)

            def run():
                with _env(HPMPC_RESIDENT="0", HPMPC_MEGA_SWEEPS="0"):
                    return m["batch"].solve_batched_soft(d, q, sb, c,
                                                         idxbs=idxbs)
            return run
        d, q = flagship(m, dt, **kw)
        c = {"parity": IPMConfig(k_max=8, mu_tol=0.0, alpha_min=1e-8,
                                 iter_ref=1, iter_ref_mu_thr=1e-3,
                                 use_pallas=True),
             "route D": IPMConfig(k_max=8, mu_tol=0.0, alpha_min=1e-8,
                                  iter_ref=1, use_pallas=True),
             "route E": IPMConfig(iter_ref=1, use_pallas=True)}[
                 key.rsplit(" ", 1)[0]]
        return lambda: m["batch"].solve_batched(d, q, c)

    routes = (("parity f32", torch.float32), ("route D f32", torch.float32),
              ("route E f64", torch.float64),
              ("soft six f32", torch.float32), ("soft six f64", torch.float64))
    problems = {"hard": (("flagship", {}), ("box-only", dict(ngN=0)),
                         ("NZ=19", dict(nx=NX19, ngN=0))),
                "soft": (("flagship", {}),
                         ("ng", dict(N=SOFT_NG_N, ng=True)),
                         ("NZ=19", dict(nx=NX19)))}
    for key, dt in routes:
        for what, kw in problems["soft" if key.startswith("soft") else
                                 "hard"]:
            calls = _sweep_inputs(this, route(this, key, dt, **kw))
            for (name, when), (a, k) in sorted(calls.items()):
                # the fused form takes the call without pi (row 18)
                fused_k = {x: v for x, v in k.items() if x != "want_pi"}
                for fname, fk in ((name, k), (SWEEPS[name], fused_k)):
                    label = f"{fname} {key} {what} {when} call"
                    got = [getattr(m["sk"], fname)(*_clone(a), **fk)
                           for m in trees.values()]
                    same, dmax = _diff(*got)
                    out["bitwise_equal"][label] = same
                    out["max_abs_diff"][label] = dmax
                    line = (f"{label}, this vs other build on the same "
                            f"inputs: bitwise equal {same} (max |diff| "
                            f"{dmax:.3e})")
                    if not same:
                        line += f"; first apart: {_first_apart(*got)}"
                    if (dev.type == "cuda" and fname == name
                            and when == "first" and what != "box-only"):
                        fns = {lbl: (lambda m=m: getattr(m["sk"], name)(
                            *a, **k)) for lbl, m in trees.items()}
                        ms = _turns(torch, fns, reps=20)
                        out["ms"][label] = ms
                        line += "; ms a call (other, this, this, other): " + (
                            ", ".join(f"{v:.4f}" for v in (
                                ms["other"][0], *ms["this"],
                                ms["other"][1])))
                    print(line, flush=True)
            if dev.type == "cuda" and what != "box-only" and calls:
                a, k = calls[("solve_flat", "first")]
                NU, NX = k["NU"], k["NX"]
                N_ = a[3].shape[0] - 1
                lay = dict(row9=this["sk"].factor_flat_layout(NU, NX, N_, dt),
                           row10=this["sk"].resolve_layout(
                               "solve_flat", N_, dt, NU=NU, NX=NX))
                out["layout"][f"{key} {what}"] = lay
                print(f"{key} {what}: this build's layout {lay}", flush=True)
    if dev.type != "cuda":
        return out
    out["ptxas"] = {lbl: _ptxas(m, "", "factor_solve_flat")
                    + _ptxas(m, "", "solve_flat")
                    for lbl, m in trees.items()}
    for lbl, lines in out["ptxas"].items():
        for line in lines:
            print(f"ptxas {lbl}: {line}", flush=True)
    # the routes of both checkouts on the flagship
    for key, dt in routes:
        fns = {lbl: route(m, key, dt) for lbl, m in trees.items()}
        sols = {lbl: fn() for lbl, fn in fns.items()}
        t, o = sols["this"], sols["other"]
        fields = {f: _diff(getattr(t, f), getattr(o, f))[0]
                  for f in t._fields}
        out["route_bitwise_equal"][key] = all(fields.values())
        print(f"{key} route, this vs other: bitwise equal per field "
              f"{fields}", flush=True)
        ms = _turns(torch, fns, reps=3)
        out["route_ms"][key] = ms
        print(f"{key} ms a batch (other, this, this, other): " + ", ".join(
            f"{v:.3f}" for v in (ms["other"][0], *ms["this"],
                                 ms["other"][1])), flush=True)
        prof = {lbl: _profile(torch, fn, SWEEP_PROFILE["row 9"],
                              parts={"row 10": SWEEP_PROFILE["row 10"]})
                for lbl, fn in fns.items()}
        out["route_profile"][key] = prof
        for lbl in ("other", "this"):
            p = prof[lbl]
            print(f"{key} profile, {lbl}: wall {p['wall']:.3f} ms, device "
                  f"busy {p['busy']:.3f} ms (idle share {p['idle']:.1%}), "
                  f"row 9 {p['kern_ms']:.3f} ms in {p['kern_n']:.0f}, row "
                  f"10 {p['parts']['row 10'][0]:.3f} ms in "
                  f"{p['parts']['row 10'][1]:.0f}", flush=True)
    return out



def _structured(trees, dev, flagship, soft_flagship):
    """Rows 16, 15 and 14: both builds on this checkout's inputs of route
    B's first calls at ``STRUCT_SHAPES`` in float32 and float64, bits, ms
    a call in turns, ptxas and the launch layout; then route B and the
    structured soft kernel backend of both checkouts on the flagship: bits
    per field, ms a batch in turns, one profile each (busy ms, idle share,
    rows 16 + 15's ms and launches)."""
    import torch

    this = trees["this"]
    out = {"bitwise_equal": {}, "max_abs_diff": {}, "ms": {}, "layout": {},
           "route_bitwise_equal": {}, "route_ms": {}, "route_profile": {}}

    def route(m, key, dt, **kw):
        """solve() of route ``key`` on the checkout ``m``: route B (the
        flagship's dims without a static idxb) or the structured soft IPM's
        kernel backend (the soft flagship, no idxbs)."""
        IPMConfig = m["ipm"].IPMConfig
        if key.startswith("soft"):
            d, q, sb, _ = soft_flagship(m, dt, **kw)
            c = IPMConfig(k_max=8, mu0=100.0, mu_tol=0.0, use_pallas=True)
            return lambda: m["batch"].solve_batched_soft(d, q, sb, c,
                                                         idxbs=None)
        d, q = flagship(m, dt, **kw)
        d = dataclasses.replace(d, idxb=None)
        c = IPMConfig(use_pallas=True)
        return lambda: m["batch"].solve_batched(d, q, c)

    for dt in (torch.float32, torch.float64):
        for nu, nx in STRUCT_SHAPES:
            what = f"route B {str(dt)[6:]} NZ={nu + nx} (nu={nu}, nx={nx})"
            calls = _sweep_inputs(this, route(this, "B", dt, nu=nu, nx=nx),
                                  STRUCT)
            a16, k16 = calls[("factor_solve_folded", "first")]
            H, dvec, ngl, ids, g, F, b, NU = a16
            cases = [("factor_solve_folded", a16, k16),
                     ("solve_batched",) + calls[("solve_batched", "first")],
                     ("factor_solve_batched",
                      (this["sk"].whole_hessian(H, dvec, ngl, ids, nu + nx),
                       g, F, b, NU), {})]
            for name, a, k in cases:
                label = f"{name} {what} first call"
                got = [getattr(m["sk"], name)(*_clone(a), **k)
                       for m in trees.values()]
                same, dmax = _diff(*got)
                out["bitwise_equal"][label] = same
                out["max_abs_diff"][label] = dmax
                line = (f"{label}, this vs other build on the same inputs: "
                        f"bitwise equal {same} (max |diff| {dmax:.3e})")
                if not same:
                    line += f"; first apart: {_first_apart(*got)}"
                if dev.type == "cuda":
                    fns = {lbl: (lambda m=m, name=name, a=a, k=k: getattr(
                        m["sk"], name)(*a, **k)) for lbl, m in trees.items()}
                    ms = _turns(torch, fns, reps=20)
                    out["ms"][label] = ms
                    line += "; ms a call (other, this, this, other): " + (
                        ", ".join(f"{v:.4f}" for v in (
                            ms["other"][0], *ms["this"], ms["other"][1])))
                print(line, flush=True)
            if dev.type == "cuda":
                # the same functions on the split factor in this build: row
                # 9 on row 16's inputs, row 10 on row 15's with the factor
                # split into Ll and Lxx
                sk_ = this["sk"]
                L, g2, F2, b2, Pb, _ = calls[("solve_batched", "first")][0]
                split = (L[:, :, :NU].contiguous(),
                         L[:, NU:, NU:].contiguous())
                kw = dict(NU=NU, NZ=nu + nx, NX=nx)
                ms9 = _time(torch, lambda: sk_.factor_solve_folded_flat(
                    H, dvec, ngl, ids, g, F, b, **kw, want_pi=True))
                ms10 = _time(torch, lambda: sk_.solve_flat(
                    *split, Pb, g2, F2, b2, **kw))
                out["ms"][f"row 9 {what}"] = ms9
                out["ms"][f"row 10 {what}"] = ms10
                print(f"{what}, this build on the same inputs with the split "
                      f"factor: row 9 (want_pi) {ms9:.4f} ms, row 10 "
                      f"{ms10:.4f} ms a call", flush=True)
                lay = dict(row16=this["sk"].folded_layout(nu, nx, 30, dt),
                           row15=this["sk"].resolve_layout(
                               "solve_batched", 30, dt, NU=nu, NX=nx))
                out["layout"][what] = lay
                print(f"{what}: this build's layout {lay}", flush=True)
    if dev.type != "cuda":
        return out
    out["ptxas"] = {lbl: _ptxas(m, "", "factor_solve_folded")
                    + _ptxas(m, "", "solve_batched")
                    for lbl, m in trees.items()}
    for lbl, lines in out["ptxas"].items():
        for line in lines:
            print(f"ptxas {lbl}: {line}", flush=True)
    for key, dt in (("B f32", torch.float32), ("B f64", torch.float64),
                    ("soft kernel backend f32", torch.float32),
                    ("soft kernel backend f64", torch.float64)):
        fns = {lbl: route(m, key, dt) for lbl, m in trees.items()}
        sols = {lbl: fn() for lbl, fn in fns.items()}
        t, o = sols["this"], sols["other"]
        fields = {f: _diff(getattr(t, f), getattr(o, f))[0]
                  for f in t._fields}
        out["route_bitwise_equal"][key] = all(fields.values())
        print(f"route {key}, this vs other: bitwise equal per field "
              f"{fields}", flush=True)
        ms = _turns(torch, fns, reps=3)
        out["route_ms"][key] = ms
        print(f"route {key} ms a batch (other, this, this, other): "
              + ", ".join(f"{v:.3f}" for v in (
                  ms["other"][0], *ms["this"], ms["other"][1])), flush=True)
        prof = {lbl: _profile(torch, fn, STRUCT_PROFILE["row 16"],
                              parts={"row 15": STRUCT_PROFILE["row 15"]})
                for lbl, fn in fns.items()}
        out["route_profile"][key] = prof
        for lbl in ("other", "this"):
            p = prof[lbl]
            print(f"route {key} profile, {lbl}: wall {p['wall']:.3f} ms, "
                  f"device busy {p['busy']:.3f} ms (idle share "
                  f"{p['idle']:.1%}), rows 16 + 15 "
                  f"{p['kern_ms'] + p['parts']['row 15'][0]:.3f} ms (row 16 "
                  f"{p['kern_ms']:.3f} in {p['kern_n']:.0f}, row 15 "
                  f"{p['parts']['row 15'][0]:.3f} in "
                  f"{p['parts']['row 15'][1]:.0f})", flush=True)
    return out


def _to(x, dev):
    """``x`` (tensors, nested in tuples and lists) on ``dev``."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, dev) for v in x)
    return x


def _forms(trees, dev, scales):
    """Rows 9 and 16 at the ``FORM_CASES`` (N=30, box-only mass-spring
    chains, ``b`` scaled as the flagship's): row 9 on the first call of
    the ``"flat"`` engine (``IPMConfig(iter_ref=1, use_pallas=True)``:
    route E in float64), row 16 on route B's (``IPMConfig(k_max=1,
    use_pallas=True)`` on the dims without a static ``idxb``), each
    captured through the plain versions on the CPU and moved to ``dev``:
    both builds on the same inputs, bits, ms a call in turns, each build's
    form (the layout's ``registers``) and ptxas lines.  With ``--other`` a
    copy of this checkout whose ``Row9::REG`` is negated, each shape runs
    both forms of rows 9 and 16."""
    import torch

    this = trees["this"]
    out = {"bitwise_equal": {}, "ms": {}, "registers": {}, "ptxas": {}}
    rows = (("row 9", "factor_solve_folded_flat", "factor_flat_layout",
             "factor_solve_flat", "the flat engine's",
             dict(k_max=1, iter_ref=1, use_pallas=True), True),
            ("row 16", "factor_solve_folded", "folded_layout",
             "factor_solve_folded", "route B's",
             dict(k_max=1, use_pallas=True), False))
    for dname, nu, nx in FORM_CASES:
        dt = getattr(torch, dname)
        dims, qp = this["ms"].mass_spring_qp(nx, nu, 30, dtype=dt,
                                             device="cpu")
        qpb = this["batch"].broadcast_qp(qp, len(scales))
        sc = torch.as_tensor(scales, dtype=dt)
        qpb = dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])
        for row, name, layout, lib, which, cfg_kw, idxb in rows:
            cfg = this["ipm"].IPMConfig(**cfg_kw)
            d = dims if idxb else dataclasses.replace(dims, idxb=None)
            calls = _sweep_inputs(
                this, lambda: this["batch"].solve_batched(d, qpb, cfg),
                (name,))
            a, k = calls[(name, "first")]
            a = _to(a, dev)
            label = f"{row} {dname} NZ={nu + nx} (nu={nu}, nx={nx})"
            got = [getattr(m["sk"], name)(*_clone(a), **k)
                   for m in trees.values()]
            same, dmax = _diff(*got)
            out["bitwise_equal"][label] = same
            line = (f"{label}, {which} first call, this vs other "
                    f"build: bitwise equal {same} (max |diff| {dmax:.3e})")
            if dev.type == "cuda":
                regs = {lbl: getattr(m["sk"], layout)(nu, nx, 30, dt)[
                    "registers"] for lbl, m in trees.items()}
                out["registers"][label] = regs
                line += (f"; register form (1) or shared-memory form (0): "
                         f"{regs}")
                fns = {lbl: (lambda m=m: getattr(m["sk"], name)(*a, **k))
                       for lbl, m in trees.items()}
                ms = _turns(torch, fns, reps=20)
                out["ms"][label] = ms
                line += "; ms a call (other, this, this, other): " + (
                    ", ".join(f"{v:.4f}" for v in (
                        ms["other"][0], *ms["this"], ms["other"][1])))
            print(line, flush=True)
            if dev.type == "cuda":
                for lbl, m in trees.items():
                    lines = [x for x in _ptxas(m, f"NU{nu}_NX{nx}_", lib)
                             if "fused" not in x
                             and ("Id" if dname == "float64" else "If") in x]
                    out["ptxas"][f"{label} {lbl}"] = lines
                    for x in lines:
                        print(f"ptxas {lbl}: {x}", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
