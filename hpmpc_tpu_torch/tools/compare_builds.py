#!/usr/bin/env python3
"""Bit-for-bit comparison of this checkout's parity route and its stage
kernels with another checkout's, on the card.

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
  * the hard resident kernel (``ipm_resident``, Queue 2 row 1) on this
    checkout's inputs of bench.py's headline config (``IPMConfig(k_max=8,
    mu_tol=0, alpha_min=1e-8, mu_switch=0, use_pallas=True)``), float32
    and float64, handed to both builds' wrappers, and the headline route
    (``solve_batched``: the resident engine and ``resid_full``) of both
    checkouts in float32: equal bit for bit or not.

Imports no JAX.  ``--other`` is a directory holding the other checkout's
``hpmpc_tpu_torch/`` (for the parent commit: ``git archive HEAD~1
hpmpc_tpu_torch | tar -x -C <dir>``, into a git-ignored directory).
Runs on the card unless asked for the CPU (plain versions; keep
``--batch`` small):

    python3 -m hpmpc_tpu_torch.tools.compare_builds --other _archive/parent
    python3 -m hpmpc_tpu_torch.tools.compare_builds --other DIR \\
        --device cpu --batch 16

The last line of the output is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import pathlib
import sys
import threading

KERNELS = ("factor_solve_folded_flat", "solve_flat", "refine_flat_fused")
CALLS = 2


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
                rk=m("ops.resident_kernel"), res=m("models.ipm_resident"))


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=pathlib.Path)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args()
    import numpy as np
    import torch

    dev, B = torch.device(args.device), args.batch
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    trees = {"this": _mods("hpmpc_tpu_torch"),
             "other": _mods(_load_other(args.other.resolve()))}
    scales = 1.0 + 0.05 * np.random.default_rng(0).standard_normal(B)

    def flagship(m, dt):
        dims, qp = m["ms"].mass_spring_qp(8, 3, 30, ngN=8, dtype=dt,
                                          device=dev)
        qpb = m["batch"].broadcast_qp(qp, B)
        sc = torch.as_tensor(scales, dtype=dt, device=dev)
        return dims, dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])

    if dev.type == "cuda":
        dims, _ = flagship(trees["this"], torch.float32)
        d2 = dict(NU=dims.NU, NX=dims.NX)
        d3 = dict(d2, NB=dims.NB)
        specs = [("resid_full", d3), ("ipm_resident", dict(d3, NG=dims.NG)),
                 ("factor_solve_mega", d3), ("solve_mega", d3),
                 ("step_flat", dict(NZ=dims.NZ, NB=dims.NB)),
                 ("factor_solve_flat", d2), ("solve_flat", d2),
                 ("refine_flat", dict(d2, NG=dims.NG)),
                 ("resid_terms_flat", d2)]
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
            engine = m["batch"].select_engine(dims, cfg, B, torch.float32)
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

    # the chain's flat form, unrefined and with the unfused refinement
    out["flat_bitwise_equal"] = {}
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
        out["flat_bitwise_equal"][f"iter_ref={iter_ref}"] = all(
            fields.values())
        print(f"flat form iter_ref={iter_ref}, this vs other: bitwise equal "
              f"per field {fields}", flush=True)

    # the hard resident kernel (row 1) alone, and the headline route
    out["resident_bitwise_equal"] = {}
    for dt in (torch.float32, torch.float64):
        dims, qpb = flagship(this, dt)
        cfg = this["ipm"].IPMConfig(k_max=8, mu_tol=0.0, alpha_min=1e-8,
                                    mu_switch=0.0, use_pallas=True)
        args, kw, _, _ = this["res"].resident_inputs(dims, qpb, cfg)
        got = [m["rk"].ipm_resident(*_clone(args), **kw)
               for m in trees.values()]
        same, d = _diff(*got)
        out["resident_bitwise_equal"][str(dt)] = same
        print(f"ipm_resident {dt}, this vs other build on the same inputs: "
              f"bitwise equal {same} (max |diff| {d:.3e})", flush=True)
    sols = []
    for m in trees.values():
        dims, qpb = flagship(m, torch.float32)
        cfg = m["ipm"].IPMConfig(k_max=8, mu_tol=0.0, alpha_min=1e-8,
                                 mu_switch=0.0, use_pallas=True)
        sols.append(m["batch"].solve_batched(dims, qpb, cfg))
    fields = {f: _diff(getattr(sols[0], f), getattr(sols[1], f))[0]
              for f in sols[0]._fields}
    out["headline_bitwise_equal"] = all(fields.values())
    print(f"headline route (resident), this vs other: bitwise equal per "
          f"field {fields}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
