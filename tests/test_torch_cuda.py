"""Hand-written CUDA kernels of the PyTorch port vs their plain PyTorch
versions, on the card, at small shapes; the engines on the card vs on the
CPU; and the wrappers' input checks.

Needs a CUDA card and nvcc: skipped where torch sees no card.  Imports no
JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hpmpc_tpu_torch.models import (  # noqa: E402
    ipm, ipm_lanes, ipm_resident, ipm_soft, ipm_soft_lanes,
    ipm_soft_resident)
from hpmpc_tpu_torch.models.ipm import IPMConfig  # noqa: E402
from hpmpc_tpu_torch.ocp import OCPDims  # noqa: E402
from hpmpc_tpu_torch.ops import mega_kernel as mk  # noqa: E402
from hpmpc_tpu_torch.ops import resident_kernel as rk  # noqa: E402
from hpmpc_tpu_torch.ops import stage_kernel as sk  # noqa: E402
from hpmpc_tpu_torch.ops import step_kernel as stk  # noqa: E402
from hpmpc_tpu_torch.parallel import batch as pbatch  # noqa: E402
from hpmpc_tpu_torch.utils.mass_spring import (  # noqa: E402
    mass_spring_qp, mass_spring_soft_qp)

pytestmark = pytest.mark.cuda

# f64: same algorithm, other summation order, shallow budget -> roundoff.
# f32: tests/test_resident.py's configs (k_max=3, mu_tol=1e-4) and
# tolerances; as there, pi is compared on the box-only problem only (the
# small-N ngN problem is infeasible, its multipliers grow every step).
_CFG = {torch.float64: dict(k_max=4, mu_tol=1e-10, mu_switch=1e-10),
        torch.float32: dict(k_max=3, mu_tol=1e-4, mu_switch=0.0)}
_TOL = {torch.float64: dict(z=1e-10, pi=1e-10, lam=1e-9, lam_rtol=1e-9,
                            stat=1e-9, stat_atol=1e-9, resid=1e-12),
        torch.float32: dict(z=2e-3, pi=5e-3, lam=5e-3, lam_rtol=5e-3,
                            stat=2e-2, stat_atol=2e-4, resid=1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


def _batch(dev, dtype, N, ngN, B, nx=8, spread=0.02, seed=0, nu=3):
    dims, qp = mass_spring_qp(nx, nu, N, ngN=ngN, dtype=dtype, device=dev)
    qpb = pbatch.broadcast_qp(qp, B)
    rng = np.random.default_rng(seed)
    sc = torch.as_tensor(1 + spread * rng.standard_normal(B), dtype=dtype,
                         device=dev)
    return dims, dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])


# Row 1 runs a team of lanes an instance, several instances a warp (4 at
# NZ=11, 2 at NZ=19): B=1 and B=33/37 leave warps part empty; nx=16 is the
# NZ=19 shape, the largest inside stage_kernel.engine_fits (box-only: the
# ngN problem's multipliers outgrow the f64 absolute tolerance there).
# "apart": b scaled by 1 + 0.3 N(0,1) (seed 2), mu_tol 1e-2, k_max 12: the
# instances of the first warp converge at different iterations (kk 3, 3,
# 3, 2 on the plain version; every mu at least 1.5x from mu_tol).
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nx,ngN,B", [(8, 0, 64), (8, 4, 37), (8, 0, 1),
                                      (8, 4, 33), (16, 0, 37), (16, 0, 1),
                                      (8, 0, "apart")])
def test_ipm_resident_kernel_matches_plain(cuda, dtype, nx, ngN, B):
    cfg = IPMConfig(**_CFG[dtype])
    apart = B == "apart"
    if apart:
        dims, qpb = _batch(cuda, dtype, 4, ngN, 8, spread=0.3, seed=2)
        cfg = IPMConfig(k_max=12, mu_tol=1e-2, mu_switch=0.0)
    else:
        dims, qpb = _batch(cuda, dtype, 4, ngN, B, nx=nx)
    args, kw, _, _ = ipm_resident.resident_inputs(dims, qpb, cfg)
    n0 = dict(rk.LAUNCHES)
    out_k = rk.ipm_resident(*args, **kw)
    torch.cuda.synchronize()
    assert rk.LAUNCHES == dict(n0, ipm_resident=n0["ipm_resident"] + 1)
    out_p = rk.ipm_resident_ref(*args, **kw)
    tol = _TOL[dtype]
    assert torch.equal(out_k[5], out_p[5])            # kk
    assert torch.equal(out_k[6], out_p[6])            # frozen
    torch.testing.assert_close(out_k[0], out_p[0], rtol=0, atol=tol["z"])
    if ngN == 0 or dtype == torch.float64:
        torch.testing.assert_close(out_k[1], out_p[1], rtol=0,
                                   atol=tol["pi"])
    for i in (2, 3, 4) + ((8, 9) if ngN else ()):     # lam, t, mu, ng
        torch.testing.assert_close(out_k[i], out_p[i], rtol=tol["lam_rtol"],
                                   atol=tol["lam"])
    torch.testing.assert_close(out_k[7], out_p[7], rtol=tol["stat"],
                               atol=tol["stat_atol"])
    if apart:
        assert out_p[5][:4].unique().numel() > 1      # within one warp


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_resid_full_kernel_matches_plain(cuda, dtype):
    dims, qpb = _batch(cuda, dtype, 4, 4, 50)
    cfg = IPMConfig(k_max=2, mu_tol=0.0, mu_switch=0.0)
    args, kw, cm, _ = ipm_resident.resident_inputs(dims, qpb, cfg)
    z, pi, lam, t = rk.ipm_resident_ref(*args, **kw)[:4]
    r_args, r_kw = ipm_resident.exit_resid_inputs(dims, qpb, cm, z, pi, lam,
                                                  t)
    n0 = stk.RESID_LAUNCHES
    out_k = stk.resid_full(*r_args, **r_kw)
    torch.cuda.synchronize()
    assert stk.RESID_LAUNCHES == n0 + 1
    out_p = stk.resid_full_ref(*r_args, **r_kw)
    for a, b in zip(out_k, out_p):
        torch.testing.assert_close(a, b, rtol=_TOL[dtype]["resid"],
                                   atol=_TOL[dtype]["resid"])


def test_resident_engine_on_card_matches_cpu(cuda):
    """The resident engine on the card (both kernels) vs the same call on
    the CPU (plain versions), float64, with general constraints."""
    dims, qpb = _batch(cuda, torch.float64, 4, 4, 40)
    cfg = IPMConfig(k_max=4, mu_tol=1e-10, mu_switch=0.0)
    sol_g = ipm_resident.solve_batched_resident(dims, qpb, cfg)
    sol_c = ipm_resident.solve_batched_resident(dims, qpb.to("cpu"), cfg)
    assert torch.equal(sol_g.kk.cpu(), sol_c.kk)
    for f in ("z", "pi", "lam_b", "t_b", "lam_g", "t_g", "stat",
              "inf_norm_res"):
        torch.testing.assert_close(getattr(sol_g, f).cpu(),
                                   getattr(sol_c, f), rtol=1e-9, atol=1e-10)


_MEGA = [(mk, "factor_solve_mega"), (mk, "solve_mega")]
_SIX = [(stk, n) for n in ("prep_flat", "alpha_sums_flat", "corr_geff_flat")
        ] + [(sk, n) for n in ("factor_solve_folded_flat", "solve_flat",
                               "refine_flat_fused")]


def _capture(monkeypatch, dims, qpb, cfg, targets, **kw):
    """Arguments of the first call of each wrapper ``(module, name)`` of
    ``targets`` in one lanes-engine solve (``kw``: the engine's keywords):
    {(name, phase2, with_dl0): (args, kwargs)}; phase2 is None for the
    sweeps, which take no phase, and with_dl0 marks the alpha pass with the
    phase-1 centering stream."""
    calls = {}
    for mod, name in targets:
        def spy(*a, _name=name, _fn=getattr(mod, name), **k):
            key = (_name, k.get("phase2"),
                   _name == "alpha_sums_flat" and a[6] is not None)
            calls.setdefault(key, (a, k))
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    ipm_lanes.solve_batched_lanes(dims, qpb, cfg, **kw)
    monkeypatch.undo()
    return calls


def _flat(out):
    """Tensors of a mega wrapper's output, the factor state unpacked."""
    return [x for o in out for x in (o if isinstance(o, tuple) else (o,))]


# one mega call, kernel vs plain: no iteration amplifies the roundoff of the
# two summation orders (host builds of the kernels measured <= 1.5e-6 of
# each field's scale in f32, 2.3e-15 in f64), so 5e-5 / 1e-11 of the scale
_MEGA_TOL = {torch.float32: 5e-5, torch.float64: 1e-11}


# Rows 19 and 20 run a team of lanes an instance, several instances a
# warp (4 at NZ=11, 2 at NZ=19): B=1, 33 and 37 leave warps part empty;
# nx=16 is the NZ=19 shape; ngN=8 the flagship's terminal block.
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nx,ngN,B", [(8, 0, 37), (8, 4, 37), (8, 0, 1),
                                      (8, 4, 33), (16, 0, 37), (16, 4, 33),
                                      (8, 8, 37)])
@pytest.mark.parametrize("phase2", [False, True])
def test_mega_kernels_match_plain(cuda, monkeypatch, dtype, nx, ngN, B,
                                  phase2):
    """Each mega kernel on the arguments of the engine's first call of that
    phase (phase 1: the initial iterate; phase 2, run alone with
    mu_switch=1e9: A = rd, M = rm at the initial iterate)."""
    dims, qpb = _batch(cuda, dtype, 4, ngN, B, nx=nx)
    kw = dict(mu_switch=1e9) if phase2 else {}
    calls = _capture(monkeypatch, dims, qpb,
                     IPMConfig(k_max=2, use_pallas=True, **kw), _MEGA)
    for name, ref in (("factor_solve_mega", mk.factor_solve_mega_ref),
                      ("solve_mega", mk.solve_mega_ref)):
        a, k = calls[(name, phase2, False)]
        n0 = list(mk.LAUNCHES[name])
        out_k = _flat(getattr(mk, name)(*a, **k))
        torch.cuda.synchronize()
        n0[int(phase2)] += 1
        assert mk.LAUNCHES[name] == n0
        out_p = _flat(ref(*a, **k))
        for i, (x, y) in enumerate(zip(out_k, out_p)):
            assert bool(torch.isfinite(x).all()), (name, i)
            scale = max(1.0, float(y.abs().max()))
            assert float((x - y).abs().max()) <= _MEGA_TOL[dtype] * scale, (
                name, i)


def test_lanes_engine_on_card_matches_cpu(cuda):
    """The lanes engine on the card (mega kernels, resid_full) vs the same
    call on the CPU (plain versions): float64, both phases, the ngN=4
    block at N=16 (feasible there).  ~9 iterations amplify the two
    summation orders to <= 3e-7 of a field's scale (host builds of the
    kernels, 40 instances), so 1e-6 of the scale."""
    dims, qpb = _batch(cuda, torch.float64, 16, 4, 40)
    cfg = IPMConfig(k_max=12, mu_tol=1e-10, use_pallas=True)
    n0 = [list(v) for v in mk.LAUNCHES.values()]
    sol_g = ipm_lanes.solve_batched_lanes(dims, qpb, cfg)
    assert all(min(a - b for a, b in zip(v, v0)) >= 1
               for v, v0 in zip(mk.LAUNCHES.values(), n0))
    sol_c = ipm_lanes.solve_batched_lanes(dims, qpb.to("cpu"), cfg)
    assert torch.equal(sol_g.kk.cpu(), sol_c.kk)
    assert torch.equal(sol_g.status.cpu(), sol_c.status)
    for f in ("z", "pi", "lam_b", "t_b", "lam_g", "t_g", "stat",
              "inf_norm_res"):
        g, c = getattr(sol_g, f).cpu(), getattr(sol_c, f)
        scale = max(1.0, float(c.abs().max()))
        assert float((g - c).abs().max()) <= 1e-6 * scale, f


def test_wrappers_reject_bad_inputs(cuda):
    dims, qpb = _batch(cuda, torch.float32, 4, 0, 16)
    cfg = IPMConfig(k_max=2, mu_tol=0.0, mu_switch=0.0)
    args, kw, _, _ = ipm_resident.resident_inputs(dims, qpb, cfg)
    bad = list(args)
    bad[3] = args[3].double()                       # z0 in another dtype
    with pytest.raises(TypeError):
        rk.ipm_resident(*bad, **kw)
    bad = list(args)
    bad[7] = args[7].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):                 # non-contiguous H
        rk.ipm_resident(*bad, **kw)
    bad = list(args)
    bad[8] = args[8].cpu()                          # F on the CPU
    with pytest.raises(ValueError):
        rk.ipm_resident(*bad, **kw)
    with pytest.raises(TypeError):                  # half precision
        rk.ipm_resident(*[a.half() if a.is_floating_point() else a
                          for a in args], **kw)



def test_mega_wrappers_reject_bad_inputs(cuda, monkeypatch):
    dims, qpb = _batch(cuda, torch.float32, 4, 4, 16)
    calls = _capture(monkeypatch, dims, qpb,
                     IPMConfig(k_max=1, mu_switch=1e9, use_pallas=True), _MEGA)
    for name in ("factor_solve_mega", "solve_mega"):
        fn = getattr(mk, name)
        a, k = calls[(name, True, False)]
        i_lam, i_m = (1, 4) if name == "factor_solve_mega" else (2, 5)
        bad = list(a)
        bad[i_lam] = a[i_lam].double()               # lam in another dtype
        with pytest.raises(TypeError):
            fn(*bad, **k)
        bad = list(a)
        bad[i_lam + 1] = a[i_lam + 1].transpose(0, 1).contiguous(
        ).transpose(0, 1)                            # non-contiguous t
        with pytest.raises(ValueError):
            fn(*bad, **k)
        bad = list(a)
        bad[i_m] = None                              # phase 2 without M
        with pytest.raises(ValueError):
            fn(*bad, **k)
        bad = list(a)
        bad[i_lam + 1] = a[i_lam + 1][..., :8].contiguous()  # batch
        with pytest.raises(ValueError):
            fn(*bad, **k)
        with pytest.raises(TypeError):               # half precision
            fn(*[x.half() if isinstance(x, torch.Tensor)
                 and x.is_floating_point() else x for x in a], **k)


def _launches(mod, name):
    n = mod.LAUNCHES[name]
    return sum(n) if isinstance(n, list) else n


# Row 13 runs a team of lanes an instance, several instances a block (8 at
# NZ=11, 4 at NZ=19): B=1 and B=33 leave blocks part empty; nx=16 is the
# NZ=19 shape.
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ngN", [0, 4])
@pytest.mark.parametrize("phase2", [False, True])
@pytest.mark.parametrize("nx,B", [(8, 37), (16, 37), (8, 1), (16, 33)])
def test_six_kernels_match_plain(cuda, monkeypatch, dtype, ngN, phase2, nx,
                                 B):
    """Each kernel of the 6-kernel loop (rows 3-5, 9, 10 and 13) on the
    arguments of the engine's first call of it in one iteration with
    ungated refinement (phase 2 alone with mu_switch=1e9); one call, so the
    tolerance of the mega kernels' check."""
    dims, qpb = _batch(cuda, dtype, 4, ngN, B, nx=nx)
    kw = dict(mu_switch=1e9) if phase2 else {}
    calls = _capture(monkeypatch, dims, qpb,
                     IPMConfig(k_max=1, iter_ref=1, use_pallas=True, **kw),
                     _SIX)
    assert len(calls) == (6 if phase2 else 7), sorted(calls)
    mods = {n: m for m, n in _SIX}
    for (name, _, _), (a, k) in sorted(calls.items()):
        mod = mods[name]
        n0 = _launches(mod, name)
        out_k = _flat(getattr(mod, name)(*a, **k))
        torch.cuda.synchronize()
        assert _launches(mod, name) == n0 + 1, name
        out_p = _flat(getattr(mod, name + "_ref")(*a, **k))
        out_k = [x for x in out_k if x is not None]
        out_p = [x for x in out_p if x is not None]
        assert len(out_k) == len(out_p), name
        for i, (x, y) in enumerate(zip(out_k, out_p)):
            assert bool(torch.isfinite(x).all()), (name, i)
            scale = max(1.0, float(y.abs().max()))
            assert float((x - y).abs().max()) <= _MEGA_TOL[dtype] * scale, (
                name, i)


_SWEEPS = [(sk, "factor_solve_folded_flat"), (sk, "solve_flat")]


def _sweeps_vs_plain(calls, dtype):
    """Rows 9 (with and without pi) and 10 on captured arguments against
    their plain versions: one launch each, finite, within the mega
    kernels' tolerance of each field's scale."""
    for (name, _, _), (a, k) in sorted(calls.items()):
        forms = [k] if name == "solve_flat" else [
            dict(k, want_pi=w) for w in (True, False)]
        for kw in forms:
            n0 = sk.LAUNCHES[name]
            out_k = [x for x in _flat(getattr(sk, name)(*a, **kw))
                     if x is not None]
            torch.cuda.synchronize()
            assert sk.LAUNCHES[name] == n0 + 1, name
            out_p = [x for x in _flat(getattr(sk, name + "_ref")(*a, **kw))
                     if x is not None]
            assert len(out_k) == len(out_p), (name, kw)
            for i, (x, y) in enumerate(zip(out_k, out_p)):
                assert x.shape == y.shape, (name, kw, i)
                assert bool(torch.isfinite(x).all()), (name, kw, i)
                scale = max(1.0, float(y.abs().max()))
                assert float((x - y).abs().max()) <= (
                    _MEGA_TOL[dtype] * scale), (name, kw, i)


# Rows 9 and 10 run a team of lanes an instance, 4 lanes at NZ <= 12 and 8
# past it.  Row 9, 32 / team instances a one-warp block: f32 and f64 at 4
# lanes at NZ=6 (nx=4 nu=2) and NZ=11, the register form; 8 lanes at NZ=19
# (nx=16), the register form in f32 and the shared-memory form in f64.
# Row 10: 8 or 4 instances a block.  B=1: one instance in a block; B=37:
# the last block ragged.
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nx,nu", [(4, 2), (8, 3), (16, 3)])
@pytest.mark.parametrize("ngN", [0, 4])
@pytest.mark.parametrize("B", [1, 37])
def test_sweep_kernels_match_plain(cuda, monkeypatch, dtype, nx, nu, ngN,
                                   B):
    """Rows 9 and 10 at every team width on the arguments of the lanes
    engine's first call of them (ungated refinement: row 9 with pi, and
    the same call without pi)."""
    dims, qpb = _batch(cuda, dtype, 4, ngN, B, nx=nx, nu=nu)
    calls = _capture(monkeypatch, dims, qpb,
                     IPMConfig(k_max=1, iter_ref=1, use_pallas=True),
                     _SWEEPS)
    assert len(calls) == 2, sorted(calls)
    _sweeps_vs_plain(calls, dtype)


def test_sweep_kernels_long_horizon(cuda, monkeypatch):
    """Rows 9 and 10 at a long horizon (N=100: 101 stages a team; row 10's
    202 chain steps, 34 stages a worker, its kept rows in device memory)
    against their plain versions on the first call of a float64 run of
    the flat form, the ngN=4 block, B=9 (two blocks each, the second
    ragged)."""
    dims, qpb = _batch(cuda, torch.float64, 100, 4, 9)
    lay = sk.resolve_layout("solve_flat", 100, torch.float64, NU=3, NX=8)
    assert lay["work_block"] == lay["instances"] * 101 * 42, lay
    lay9 = sk.factor_flat_layout(3, 8, 100, torch.float64)
    assert lay9["scratch_rows"] == 101 * 11, lay9
    assert lay9["team"] * lay9["instances"] == lay9["threads"] == 32, lay9
    calls = _capture(monkeypatch, dims, qpb,
                     IPMConfig(k_max=1, iter_ref=1, use_pallas=True),
                     _SWEEPS, flat=True)
    assert len(calls) == 2, sorted(calls)
    _sweeps_vs_plain(calls, torch.float64)


@pytest.mark.parametrize("ng", [False, True])
def test_soft_sweep_kernels_match_plain(cuda, monkeypatch, ng):
    """Rows 9 (no pi) and 10 on the arguments of their first call in the
    soft float64 route (``solve_batched_soft``: the ``"soft_flat"``
    6-kernel loop), B=37."""
    dims, qpb, sb, idxbs = _soft_batch(cuda, torch.float64, 5, ng, 37)
    cfg = IPMConfig(k_max=1, mu0=100.0, use_pallas=True)
    monkeypatch.delenv("HPMPC_RESIDENT", raising=False)
    monkeypatch.setenv("HPMPC_MEGA_SWEEPS", "0")
    assert pbatch.select_soft_engine(
        dims, cfg, torch.float64, sb.ns_mask.shape[-1], idxbs) == "soft_flat"
    calls = {}
    for _, name in _SWEEPS:
        def spy(*a, _name=name, _fn=getattr(sk, name), **k):
            calls.setdefault((_name, None, False), (a, k))
            return _fn(*a, **k)

        monkeypatch.setattr(sk, name, spy)
    pbatch.solve_batched_soft(dims, qpb, sb, cfg, idxbs=idxbs)
    monkeypatch.undo()
    assert len(calls) == 2, sorted(calls)
    assert calls[("factor_solve_folded_flat", None, False)][1][
        "want_pi"] is False
    _sweeps_vs_plain(calls, torch.float64)


def test_six_kernel_engine_on_card_matches_cpu(cuda):
    """The lanes engine's 6-kernel loop with mu-gated refinement on the
    card vs the same call on the CPU (plain versions): float64, both
    phases, the ngN=4 block at N=16, as the mega-route check above."""
    dims, qpb = _batch(cuda, torch.float64, 16, 4, 40)
    cfg = IPMConfig(k_max=12, mu_tol=1e-10, iter_ref=1, iter_ref_mu_thr=1e-3,
                    use_pallas=True)
    n0 = {n: _launches(m, n) for m, n in _SIX}
    sol_g = ipm_lanes.solve_batched_lanes(dims, qpb, cfg)
    assert all(_launches(m, n) > n0[n] for m, n in _SIX)
    sol_c = ipm_lanes.solve_batched_lanes(dims, qpb.to("cpu"), cfg)
    assert torch.equal(sol_g.kk.cpu(), sol_c.kk)
    assert torch.equal(sol_g.status.cpu(), sol_c.status)
    for f in ("z", "pi", "lam_b", "t_b", "lam_g", "t_g", "stat",
              "inf_norm_res"):
        g, c = getattr(sol_g, f).cpu(), getattr(sol_c, f)
        scale = max(1.0, float(c.abs().max()))
        assert float((g - c).abs().max()) <= 1e-6 * scale, f


def test_parity_route_on_card(cuda):
    """bench.py's parity config through solve_batched on the card, f32,
    N=4: the two-stage route; controls within 1e-6 of the f64 lanes
    engine at matched iterations, closer than the unrefined f32 route
    (tests/test_resident.py, tests/test_stage_kernel.py)."""
    K = 6
    dims, q32 = _batch(cuda, torch.float32, 4, 0, 64)
    _, q64 = _batch(cuda, torch.float64, 4, 0, 64)
    cfg = IPMConfig(k_max=K, mu_tol=0.0, iter_ref=1, iter_ref_mu_thr=1e-3,
                    use_pallas=True)
    assert pbatch.select_engine(dims, cfg, 64, torch.float32) == (
        "two_stage_resident")
    sol = pbatch.solve_batched(dims, q32, cfg)
    raw = pbatch.solve_batched(dims, q32, dataclasses.replace(cfg,
                                                              iter_ref=0))
    s64 = ipm_lanes.solve_batched_lanes(
        dims, q64, IPMConfig(k_max=K, mu_tol=0.0, use_pallas=True))
    assert int(sol.kk.max()) <= K
    err = float((sol.z[..., :3].double() - s64.z[..., :3]).abs().max())
    err_raw = float((raw.z[..., :3].double() - s64.z[..., :3]).abs().max())
    assert err <= 1e-6, err
    assert err < err_raw, (err, err_raw)


_SOFT_MEGA = [(mk, "factor_solve_soft_mega"), (mk, "solve_soft_mega")]
_SOFT_STEP = [(stk, n) for n in ("soft_prep_flat", "soft_alpha_sums_flat",
                                 "soft_corr_flat")]


def _soft_batch(dev, dtype, N, ng, B, masked=False, nx=8, spread=0.02):
    """The reference's soft problem (mass_spring_soft_qp(nx, 3, N, Z=10)),
    ``g`` scaled per instance; with ``ng`` one general row on stages 2
    and N (tests/test_ipm_soft_lanes.py's ng problem); with ``masked``
    instance b (odd) drops its first 1 + b % NS soft rows on stage
    1 + (b // 2) % N, so the instances' soft masks and mu scalings
    differ."""
    dims, qp, soft = mass_spring_soft_qp(nx, 3, N, Z=10.0, dtype=dtype,
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
            qp, C=C, d_lg=d_lg, d_ug=-d_lg,
            ng_mask=torch.as_tensor(dims.ng_mask(), dtype=dtype, device=dev))
    qpb = pbatch.broadcast_qp(qp, B)
    rng = np.random.default_rng(0)
    sc = torch.as_tensor(1 + spread * rng.standard_normal(B), dtype=dtype,
                         device=dev)
    sb = pbatch.broadcast_soft(soft, B)
    if masked:
        m = sb.ns_mask.clone()
        for b in range(1, B, 2):
            m[b, 1 + (b // 2) % N, :1 + b % m.shape[-1]] = 0
        sb = sb._replace(ns_mask=m)
    return (dims, dataclasses.replace(qpb, g=qpb.g * sc[:, None, None]),
            sb, soft.idxbs.cpu().numpy())


def _soft_capture(monkeypatch, batch, cfg, targets, exact):
    """Arguments of the first call of each soft wrapper of ``targets`` in
    one soft lanes solve: {(name, corrector): (args, kwargs)}."""
    calls = {}
    for mod, name in targets:
        def spy(*a, _name=name, _fn=getattr(mod, name), **k):
            calls.setdefault((_name, bool(k.get("corrector"))), (a, k))
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    dims, qpb, sb, idxbs = batch
    ipm_soft_lanes.solve_batched_soft_lanes(dims, qpb, sb, cfg, idxbs,
                                            exact_mehrotra_soft=exact)
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ng", [False, True])
@pytest.mark.parametrize("exact", [True, False])
def test_soft_kernels_match_plain(cuda, monkeypatch, dtype, ng, exact):
    """Each soft kernel (rows 21, 22, 6, 7, 8) on the arguments of the soft
    engine's first call of it (the initial iterate; the mega route with
    HPMPC_MEGA_SWEEPS=1, the 6-kernel loop with =0), B=37; one call, so
    the mega kernels' tolerance."""
    batch = _soft_batch(cuda, dtype, 5, ng, 37)
    cfg = IPMConfig(k_max=1, mu0=100.0, use_pallas=True)
    monkeypatch.setenv("HPMPC_MEGA_SWEEPS", "1")
    calls = _soft_capture(monkeypatch, batch, cfg, _SOFT_MEGA, exact)
    monkeypatch.setenv("HPMPC_MEGA_SWEEPS", "0")
    calls.update(_soft_capture(monkeypatch, batch, cfg, _SOFT_STEP, exact))
    assert len(calls) == 6, sorted(calls)
    for (name, _), (a, k) in sorted(calls.items()):
        mod = mk if name.endswith("mega") else stk
        n0 = mod.SOFT_LAUNCHES[name]
        out_k = _flat(getattr(mod, name)(*a, **k))
        torch.cuda.synchronize()
        assert mod.SOFT_LAUNCHES[name] == n0 + 1, name
        out_p = _flat(getattr(mod, name + "_ref")(*a, **k))
        assert len(out_k) == len(out_p), name
        for i, (x, y) in enumerate(zip(out_k, out_p)):
            assert bool(torch.isfinite(x).all()), (name, i)
            scale = max(1.0, float(y.abs().max()))
            assert float((x - y).abs().max()) <= _MEGA_TOL[dtype] * scale, (
                name, i)


@pytest.mark.parametrize("mega", ["1", "0"])
def test_soft_route_on_card_matches_cpu(cuda, monkeypatch, mega):
    """solve_batched_soft on the card (f32 -> the soft lanes engine, both
    routes) vs the same call on the CPU (plain versions), the ng problem:
    kk equal, fields within 2e-3 of their scale (f32 roundoff of two
    summation orders through 4 iterations); then the f64 engine on the
    card converges and its soft residuals are small (f64 oracle)."""
    monkeypatch.setenv("HPMPC_MEGA_SWEEPS", mega)
    dims, qpb, sb, idxbs = _soft_batch(cuda, torch.float32, 5, True, 40)
    cfg = IPMConfig(k_max=4, mu0=100.0, mu_tol=1e-5, use_pallas=True)
    n0 = {**mk.SOFT_LAUNCHES, **stk.SOFT_LAUNCHES}
    sol_g = pbatch.solve_batched_soft(dims, qpb, sb, cfg, idxbs=idxbs)
    n1 = {**mk.SOFT_LAUNCHES, **stk.SOFT_LAUNCHES}
    ran = {k for k in n0 if n1[k] > n0[k]}
    assert ran == ({"factor_solve_soft_mega", "solve_soft_mega"}
                   if mega == "1" else set(stk.SOFT_LAUNCHES)), ran
    sol_c = pbatch.solve_batched_soft(
        dims, qpb.to("cpu"), type(sb)(*[x.cpu() for x in sb]), cfg,
        idxbs=idxbs)
    assert torch.equal(sol_g.kk.cpu(), sol_c.kk)
    for f in ("z", "pi", "lam_b", "t_b", "lam_g", "t_g", "lam_s", "t_s",
              "stat"):
        g, c = getattr(sol_g, f).cpu(), getattr(sol_c, f)
        scale = max(1.0, float(c.abs().max()))
        assert float((g - c).abs().max()) <= 2e-3 * scale, f
    dims, qpb, sb, idxbs = _soft_batch(cuda, torch.float64, 5, True, 40)
    sol = ipm_soft_lanes.solve_batched_soft_lanes(
        dims, qpb, sb, IPMConfig(k_max=30, mu0=100.0, use_pallas=True),
        idxbs)
    assert bool((sol.status == 0).all())
    res = ipm_soft.compute_residuals(dims, qpb, sb, sol)
    assert float(res.mu.max()) <= 1e-8
    for f in ("rb", "rd_b", "rd_g", "rd_s"):
        assert float(getattr(res, f).abs().max()) <= 1e-6, f


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ng", [False, True])
@pytest.mark.parametrize("exact", [True, False])
def test_soft_resident_kernel_matches_plain(cuda, dtype, ng, exact):
    """Row 1s (the soft variant of csrc/ipm_resident.cu) against its plain
    version on the soft resident engine's inputs, B=37, at the hard
    kernel's budgets and tolerances (f64 k_max 4, f32 k_max 3)."""
    _soft_resident_vs_plain(cuda, dtype, ng, exact, False)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_soft_resident_kernel_per_instance_masks(cuda, dtype):
    """The same with per-instance soft masks (``_soft_batch``'s
    ``masked``): each instance's own mu scaling (the ``musc`` stream)."""
    _soft_resident_vs_plain(cuda, dtype, False, True, True)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nx,B", [(8, 1), (8, 33), (16, 37)])
def test_soft_resident_kernel_batch_edges(cuda, dtype, nx, B):
    """The same at B=1 and B=33 (warps left part empty) and at the NZ=19
    shape (nx=16: NS=16 soft rows), with general rows."""
    _soft_resident_vs_plain(cuda, dtype, True, True, False, B=B, nx=nx)


def test_soft_resident_kernel_instances_stop_apart(cuda):
    """Per-instance masks, general rows, N=2 and mu_tol 3 at k_max 12, f64:
    the instances of the first warp stop at different iterations (kk 3, 3,
    3, 0 on the plain version: instance 3 freezes at its first step, the
    others converge, every mu at least 2.6x from mu_tol).  In f32 that
    first-step freeze sits on roundoff (the plain version on the card and
    on the CPU disagree), so the case runs in f64."""
    _soft_resident_vs_plain(cuda, torch.float64, True, True, True, B=8,
                            N=2, mu_tol=3.0, k_max=12)


def _soft_resident_vs_plain(cuda, dtype, ng, exact, masked, B=37, nx=8,
                            mu_tol=0.0, k_max=None, N=5):
    dims, qpb, sb, idxbs = _soft_batch(cuda, dtype, N, ng, B, masked, nx)
    cfg = IPMConfig(k_max=k_max or _CFG[dtype]["k_max"], mu0=100.0,
                    mu_tol=mu_tol, use_pallas=True)
    args, kw = ipm_soft_resident.soft_resident_inputs(dims, qpb, sb, cfg,
                                                      idxbs, exact)
    assert (kw["musc"].unique().numel() > 1) == (masked and B > 1)
    n0 = dict(rk.LAUNCHES)
    out_k = rk.ipm_resident(*args, **kw)
    torch.cuda.synchronize()
    assert rk.LAUNCHES == dict(
        n0, ipm_resident_soft=n0["ipm_resident_soft"] + 1)
    out_p = rk.ipm_resident_ref(*args, **kw)
    tol = _TOL[dtype]
    assert len(out_k) == len(out_p) == 8 + (2 if ng else 0) + 2
    assert torch.equal(out_k[5], out_p[5])            # kk
    assert torch.equal(out_k[6], out_p[6])            # frozen
    torch.testing.assert_close(out_k[0], out_p[0], rtol=0, atol=tol["z"])
    torch.testing.assert_close(out_k[1], out_p[1], rtol=0, atol=tol["pi"])
    for i in (2, 3, 4) + ((8, 9) if ng else ()) + (-2, -1):
        torch.testing.assert_close(out_k[i], out_p[i], rtol=tol["lam_rtol"],
                                   atol=tol["lam"])
    torch.testing.assert_close(out_k[7], out_p[7], rtol=tol["stat"],
                               atol=tol["stat_atol"])
    if mu_tol > 0:
        assert out_p[5][:4].unique().numel() > 1      # within one warp


def test_soft_resident_route_on_card_matches_cpu(cuda, monkeypatch):
    """solve_batched_soft under HPMPC_RESIDENT=1 on the card (f32 -> the
    soft resident: one launch of row 1s, no other soft kernel) vs the same
    call on the CPU (the plain version), the ng problem: kk equal, fields
    within 2e-3 of their scale; then the f64 soft resident on the card
    against the soft lanes engine on the card at the CPU tests' tolerances
    (tests/test_torch_soft_lanes.py (a), tests/test_torch_ipm_soft.py's pi
    bound)."""
    monkeypatch.setenv("HPMPC_RESIDENT", "1")
    dims, qpb, sb, idxbs = _soft_batch(cuda, torch.float32, 5, True, 40)
    cfg = IPMConfig(k_max=4, mu0=100.0, mu_tol=1e-5, use_pallas=True)
    n0 = {**rk.LAUNCHES, **mk.SOFT_LAUNCHES, **stk.SOFT_LAUNCHES}
    sol_g = pbatch.solve_batched_soft(dims, qpb, sb, cfg, idxbs=idxbs)
    n1 = {**rk.LAUNCHES, **mk.SOFT_LAUNCHES, **stk.SOFT_LAUNCHES}
    assert {k: n1[k] - n0[k] for k in n0 if n1[k] > n0[k]} == {
        "ipm_resident_soft": 1}
    sol_c = pbatch.solve_batched_soft(
        dims, qpb.to("cpu"), type(sb)(*[x.cpu() for x in sb]), cfg,
        idxbs=idxbs)
    assert torch.equal(sol_g.kk.cpu(), sol_c.kk)
    assert torch.equal(sol_g.status.cpu(), sol_c.status)
    for f in ("z", "pi", "lam_b", "t_b", "lam_g", "t_g", "lam_s", "t_s",
              "stat"):
        g, c = getattr(sol_g, f).cpu(), getattr(sol_c, f)
        scale = max(1.0, float(c.abs().max()))
        assert float((g - c).abs().max()) <= 2e-3 * scale, f
    dims, qpb, sb, idxbs = _soft_batch(cuda, torch.float64, 5, True, 40)
    cfg = IPMConfig(k_max=6, mu0=100.0, mu_tol=0.0, use_pallas=True)
    sol_r = ipm_soft_resident.solve_batched_soft_resident(dims, qpb, sb, cfg,
                                                          idxbs)
    monkeypatch.setenv("HPMPC_MEGA_SWEEPS", "0")
    sol_l = ipm_soft_lanes.solve_batched_soft_lanes(dims, qpb, sb, cfg,
                                                    idxbs)
    assert torch.equal(sol_r.kk, sol_l.kk)
    for f, atol in (("z", 1e-8), ("pi", 1e-7), ("lam_s", 1e-8),
                    ("t_s", 1e-8), ("lam_g", 1e-8), ("t_g", 1e-8)):
        torch.testing.assert_close(getattr(sol_r, f), getattr(sol_l, f),
                                   rtol=0, atol=atol)


def test_soft_resident_wrapper_rejects_bad_inputs(cuda):
    dims, qpb, sb, idxbs = _soft_batch(cuda, torch.float32, 5, False, 16)
    cfg = IPMConfig(k_max=2, mu0=100.0, mu_tol=0.0, use_pallas=True)
    args, kw = ipm_soft_resident.soft_resident_inputs(dims, qpb, sb, cfg,
                                                      idxbs)
    for name, bad, err in (
            ("lams0", kw["lams0"].double(), TypeError),       # dtype
            ("softc", kw["softc"][..., :8].contiguous(), ValueError),
            ("idxs_tab", kw["idxs_tab"].long(), TypeError),   # table type
            ("msk", kw["msk"].cpu(), ValueError),             # device
            ("musc", kw["musc"][:8].contiguous(), ValueError)):
        with pytest.raises(err):
            rk.ipm_resident(*args, **dict(kw, **{name: bad}))


def test_soft_wrappers_reject_bad_inputs(cuda, monkeypatch):
    batch = _soft_batch(cuda, torch.float32, 5, True, 16)
    cfg = IPMConfig(k_max=1, mu0=100.0, use_pallas=True)
    monkeypatch.setenv("HPMPC_MEGA_SWEEPS", "1")
    calls = _soft_capture(monkeypatch, batch, cfg, _SOFT_MEGA, True)
    monkeypatch.setenv("HPMPC_MEGA_SWEEPS", "0")
    calls.update(_soft_capture(monkeypatch, batch, cfg, _SOFT_STEP, True))
    for (name, _), (a, k) in sorted(calls.items()):
        fn = getattr(mk if name.endswith("mega") else stk, name)
        # lam follows fstate / dz in these two
        i = 3 if name in ("solve_soft_mega", "soft_alpha_sums_flat") else 2
        bad = list(a)
        bad[i] = a[i].double()                          # another dtype
        with pytest.raises(TypeError):
            fn(*bad, **k)
        bad = list(a)
        bad[i] = a[i][..., :8].contiguous()             # batch
        with pytest.raises(ValueError):
            fn(*bad, **k)
        bad = list(a)
        bad[1] = a[1].long()                            # soft index table
        with pytest.raises(TypeError):
            fn(*bad, **k)
        bad = list(a)
        bad[i + 1] = a[i + 1].cpu()                     # t on another device
        with pytest.raises(ValueError):
            fn(*bad, **k)


def test_six_kernel_wrappers_reject_bad_inputs(cuda, monkeypatch):
    dims, qpb = _batch(cuda, torch.float32, 4, 4, 16)
    calls = _capture(monkeypatch, dims, qpb,
                     IPMConfig(k_max=1, mu_switch=1e9, iter_ref=1,
                               use_pallas=True), _SIX)
    mods = {n: m for m, n in _SIX}
    for (name, _, _), (a, k) in sorted(calls.items()):
        fn = getattr(mods[name], name)
        i = 1 if mods[name] is stk else 0             # lam / H
        bad = list(a)
        bad[i] = a[i].double()
        with pytest.raises(TypeError):
            fn(*bad, **k)
        bad = list(a)
        bad[i] = a[i][..., :8].contiguous()           # batch
        with pytest.raises(ValueError):
            fn(*bad, **k)
        bad = list(a)
        bad[-1] = a[-1].cpu()                         # another device
        with pytest.raises(ValueError):
            fn(*bad, **k)


_STRUCT = [(sk, "factor_solve_folded"), (sk, "solve_batched")]


def _struct_capture(monkeypatch, dims, qpb, cfg):
    """Arguments of the first call of rows 16 and 15 in one structured
    solve: {name: (args, kwargs)}."""
    calls = {}
    for mod, name in _STRUCT:
        def spy(*a, _name=name, _fn=getattr(mod, name), **k):
            calls.setdefault(_name, (a, k))
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    ipm.solve(dims, qpb, cfg)
    monkeypatch.undo()
    return calls


# Rows 16 and 14 run row 9's team (4 lanes an instance to NZ=12, 8 past it,
# 32 / team instances a one-warp block) in the register form (f32; f64 to
# NZ=11) or the shared-memory form (f64 past NZ=11); row 15 row 10's
# (hp::ReSolve, the cached-Pb mode on the full factor).  Cases (dtype, nx,
# nu, N, ng, ngN, B): the flagship's stage (NZ=11) in both dtypes with no ng
# stage and with the ng block at N; f64 NZ=12 (nu=4) and NZ=19 (nx=16), the
# shared-memory form, and f32 NZ=19, the register form at 8 lanes; N=1 and
# N=2; ng rows on the interior stage 1 and at N=2 (mass_spring_qp's ng=1
# bounds x_0 on stages 1..N-1: n_ng = 2); B=37 leaves the last block
# ragged (a team past the batch), B=1 one instance in a block.
_STRUCT_CASES = [
    (torch.float64, 8, 3, 4, 0, 0, 37), (torch.float64, 8, 3, 4, 0, 4, 37),
    (torch.float32, 8, 3, 4, 0, 0, 37), (torch.float32, 8, 3, 4, 0, 4, 37),
    (torch.float64, 8, 4, 4, 0, 4, 37), (torch.float64, 16, 3, 4, 0, 4, 37),
    (torch.float64, 16, 3, 4, 0, 0, 1), (torch.float32, 16, 3, 4, 0, 4, 37),
    (torch.float64, 8, 3, 1, 0, 0, 37), (torch.float32, 8, 3, 1, 0, 0, 37),
    (torch.float64, 8, 3, 2, 1, 1, 37), (torch.float32, 8, 3, 2, 1, 1, 37)]


@pytest.mark.parametrize("dtype,nx,nu,N,ng,ngN,B", _STRUCT_CASES)
def test_structured_kernels_match_plain(cuda, monkeypatch, dtype, nx, nu, N,
                                        ng, ngN, B):
    """Rows 16 and 15 on the arguments of the structured solve's first
    calls (the initial iterate), row 14 on the effective Hessian row 16
    assembles; one call each, so the tolerance of the mega kernels'
    check.  Row 14 and row 16 also agree with each other."""
    dims, qp = mass_spring_qp(nx, nu, N, ng=ng, ngN=ngN, dtype=dtype,
                              device=cuda)
    qpb = pbatch.broadcast_qp(qp, B)
    rng = np.random.default_rng(0)
    sc = torch.as_tensor(1 + 0.02 * rng.standard_normal(B), dtype=dtype,
                         device=cuda)
    qpb = dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])
    calls = _struct_capture(monkeypatch, dims, qpb,
                            IPMConfig(k_max=1, use_pallas=True))
    assert sorted(calls) == ["factor_solve_folded", "solve_batched"]
    a16, k16 = calls["factor_solve_folded"]
    H, dvec, ngl, ids, g, F, b, NU = a16
    assert len(ids) == (N - 1) * (ng > 0) + (ngN > 0), ids
    cases = [("factor_solve_folded", a16, k16),
             ("solve_batched",) + calls["solve_batched"],
             ("factor_solve_batched",
              (sk.whole_hessian(H, dvec, ngl, ids, dims.NZ), g, F, b, NU), {})]
    outs = {}
    for name, a, k in cases:
        n0 = sk.LAUNCHES[name]
        out_k = getattr(sk, name)(*a, **k)
        torch.cuda.synchronize()
        assert sk.LAUNCHES[name] == n0 + 1, name
        out_p = getattr(sk, name + "_ref")(*a, **k)
        assert len(out_k) == len(out_p), name
        for i, (x, y) in enumerate(zip(out_k, out_p)):
            assert x.shape == y.shape, (name, i)
            assert bool(torch.isfinite(x).all()), (name, i)
            scale = max(1.0, float(y.abs().max()))
            assert float((x - y).abs().max()) <= _MEGA_TOL[dtype] * scale, (
                name, i)
        outs[name] = out_k
    for i, (x, y) in enumerate(zip(outs["factor_solve_batched"],
                                   outs["factor_solve_folded"])):
        scale = max(1.0, float(y.abs().max()))
        assert float((x - y).abs().max()) <= _MEGA_TOL[dtype] * scale, i
    # the factor's strictly upper part and eu past NU are written as 0
    L, eu = outs["factor_solve_folded"][2], outs["factor_solve_folded"][3]
    upper = torch.triu(torch.ones(dims.NZ, dims.NZ, dtype=torch.bool,
                                  device=cuda), 1)
    assert not bool(L[:, upper].any())
    assert not bool(eu[:, NU:].any())
    lay = sk.folded_layout(NU, dims.NX, N, dtype)
    assert lay["team"] * lay["instances"] == lay["threads"] == 32, lay
    assert lay["registers"] == int(dtype == torch.float32 or dims.NZ <= 11)


@pytest.mark.parametrize("nx", [8, 16])
def test_structured_route_on_card_matches_cpu(cuda, nx):
    """The structured IPM's kernel backend on the card vs the same call on
    the CPU (plain versions): float64, both phases, the ngN=4 block at
    N=16 (a feasible horizon), 40 instances, at NZ=11 (the register form
    of rows 16/14) and NZ=19 (nx=16: their shared-memory form, 8 lanes
    an instance); ~9 iterations amplify the two summation orders, so 1e-6
    of a field's scale, as the lanes engine's check."""
    dims, qpb = _batch(cuda, torch.float64, 16, 4, 40, nx=nx)
    cfg = IPMConfig(k_max=12, mu_tol=1e-10, use_pallas=True)
    n0 = {n: sk.LAUNCHES[n] for _, n in _STRUCT}
    p0 = {n: sk.PLAIN_CALLS[n] for _, n in _STRUCT}
    sol_g = ipm.solve(dims, qpb, cfg)
    assert all(sk.LAUNCHES[n] > n0[n] for n in n0)
    assert all(sk.PLAIN_CALLS[n] == p0[n] for n in p0)
    sol_c = ipm.solve(dims, qpb.to("cpu"), cfg)
    assert torch.equal(sol_g.kk.cpu(), sol_c.kk)
    assert torch.equal(sol_g.status.cpu(), sol_c.status)
    for f in ("z", "pi", "lam_b", "t_b", "lam_g", "t_g", "stat",
              "inf_norm_res"):
        g, c = getattr(sol_g, f).cpu(), getattr(sol_c, f)
        scale = max(1.0, float(c.abs().max()))
        assert float((g - c).abs().max()) <= 1e-6 * scale, f


def test_structured_wrappers_reject_bad_inputs(cuda, monkeypatch):
    dims, qpb = _batch(cuda, torch.float32, 4, 4, 16)
    calls = _struct_capture(monkeypatch, dims, qpb,
                            IPMConfig(k_max=1, use_pallas=True))
    H, dvec, ngl, ids, g, F, b, NU = calls["factor_solve_folded"][0]
    He = sk.whole_hessian(H, dvec, ngl, ids, dims.NZ)
    L, g2, F2, b2, Pb, _ = calls["solve_batched"][0]
    forms = [(sk.factor_solve_folded, (H, dvec, ngl, ids, g, F, b, NU), 4),
             (sk.factor_solve_batched, (He, g, F, b, NU), 1),
             (sk.solve_batched, (L, g2, F2, b2, Pb, NU), 1)]
    for fn, a, i in forms:                            # i: the gradient
        bad = list(a)
        bad[i] = a[i].double()                        # another dtype
        with pytest.raises(TypeError):
            fn(*bad)
        bad = list(a)
        bad[i] = a[i][..., :8].contiguous()           # batch
        with pytest.raises(ValueError):
            fn(*bad)
        bad = list(a)
        bad[i + 1] = a[i + 1].cpu()                   # F on the CPU
        with pytest.raises(ValueError):
            fn(*bad)
        bad = list(a)
        bad[-1] = NU + 1                              # NU != NZ - NX
        with pytest.raises(ValueError):
            fn(*bad)
    with pytest.raises(ValueError):                   # ng term missing
        sk.factor_solve_folded(H, dvec, None, ids, g, F, b, NU)


_UNFUSED = [(sk, "resid_terms_flat"), (sk, "solve_flat_pb")]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ngN", [0, 4])
@pytest.mark.parametrize("phase2", [False, True])
@pytest.mark.parametrize("nx,B", [(8, 37), (16, 37), (8, 1), (16, 33)])
def test_unfused_refine_kernels_match_plain(cuda, monkeypatch, dtype, ngN,
                                            phase2, nx, B):
    """Rows 12 and 11 (the unfused refinement pass) on the arguments of the
    flat form's first refinement of one phase (phase 2 alone with
    mu_switch=1e9); B=37 and 33 leave the last warp and block ragged, B=1
    one instance in a block (row 11 runs 8 instances a block at NZ=11, 4
    at NZ=19, the nx=16 shape); one call each, so the tolerance of the mega
    kernels' check."""
    dims, qpb = _batch(cuda, dtype, 4, ngN, B, nx=nx)
    kw = dict(mu_switch=1e9) if phase2 else {}
    calls = _capture(monkeypatch, dims, qpb,
                     IPMConfig(k_max=1, iter_ref=1, use_pallas=True, **kw),
                     _UNFUSED, flat=True)
    assert sorted(k[0] for k in calls) == ["resid_terms_flat",
                                           "solve_flat_pb"], sorted(calls)
    for (name, _, _), (a, k) in sorted(calls.items()):
        n0 = sk.LAUNCHES[name]
        out_k = getattr(sk, name)(*a, **k)
        torch.cuda.synchronize()
        assert sk.LAUNCHES[name] == n0 + 1, name
        out_p = getattr(sk, name + "_ref")(*a, **k)
        assert len(out_k) == len(out_p), name
        for i, (x, y) in enumerate(zip(out_k, out_p)):
            assert x.shape == y.shape, (name, i)
            assert bool(torch.isfinite(x).all()), (name, i)
            scale = max(1.0, float(y.abs().max()))
            assert float((x - y).abs().max()) <= _MEGA_TOL[dtype] * scale, (
                name, i)


def test_resolve_kernels_long_horizon(cuda, monkeypatch):
    """Rows 11 and 13 at a long horizon (N=100: 202 chain steps, 34 stages
    a worker, 253 KB of kept rows a block in device memory) against their
    plain versions on the first refinement of a float64 run, the ngN=4
    block, B=9 (two blocks, the second ragged)."""
    dims, qpb = _batch(cuda, torch.float64, 100, 4, 9)
    for name, dims_ in (("solve_flat_pb", dict(NU=3, NX=8)),
                        ("refine_flat_fused", dict(NU=3, NX=8, NG=4))):
        lay = sk.resolve_layout(name, 100, torch.float64, **dims_)
        assert lay["work_block"] == lay["instances"] * 101 * 42, (name, lay)
    for flat in (True, False):
        targets = _UNFUSED[1:] if flat else [(sk, "refine_flat_fused")]
        calls = _capture(monkeypatch, dims, qpb,
                         IPMConfig(k_max=1, iter_ref=1, use_pallas=True),
                         targets, flat=flat)
        assert len(calls) == 1, sorted(calls)
        ((name, _, _), (a, k)), = calls.items()
        out_k = getattr(sk, name)(*a, **k)
        out_p = getattr(sk, name + "_ref")(*a, **k)
        for i, (x, y) in enumerate(zip(out_k, out_p)):
            assert bool(torch.isfinite(x).all()), (name, i)
            scale = max(1.0, float(y.abs().max()))
            assert float((x - y).abs().max()) <= (
                _MEGA_TOL[torch.float64] * scale), (name, i)


@pytest.mark.parametrize("moved", [False, True])
def test_fused_refine_matches_unfused_on_card(cuda, monkeypatch, moved):
    """ROADMAP Queue 3's check: one fused pass (row 13) against one
    unfused pass (rows 12 + the elementwise assembly + row 11, ``stage_
    kernel.refine_flat_unfused``) on the same captured inputs, the
    kernels on the card: the flagship shape (N=30, the ngN=8 block), B=37,
    float64, the first refinement of a lanes run.  As captured the
    correction is ~1e-15 of the iterate; ``moved`` adds 0.1 N(0,1) to z
    and pi, so the correction is of the iterate's order and the check
    holds the two re-solves, whose pi the terminal block's conditioning
    moves more (the plain versions on these inputs: 1.6e-16 as captured,
    1.6e-11 moved, of pi's scale).  Tolerance 1e-12 (as captured) and 1e-9
    (moved) of each output's scale (the card's measure: PERF.md section
    6, PR 17)."""
    dims, qpb = _batch(cuda, torch.float64, 30, 8, 37)
    calls = _capture(monkeypatch, dims, qpb,
                     IPMConfig(k_max=1, iter_ref=1, use_pallas=True),
                     [(sk, "refine_flat_fused")])
    ((_, (a, k)),) = calls.items()
    a = list(a)
    if moved:
        gen = torch.Generator().manual_seed(1)
        for i in (8, 9):
            a[i] = a[i] + 0.1 * torch.randn(a[i].shape, generator=gen,
                                            dtype=a[i].dtype).to(cuda)
    n0 = {n: sk.LAUNCHES[n] for n in ("refine_flat_fused",
                                      "resid_terms_flat", "solve_flat_pb")}
    fused = sk.refine_flat_fused(*a, **k)
    unfused = sk.refine_flat_unfused(*a, **k)
    torch.cuda.synchronize()
    assert {n: sk.LAUNCHES[n] - v for n, v in n0.items()} == dict(
        refine_flat_fused=1, resid_terms_flat=1, solve_flat_pb=1)
    tol = 1e-9 if moved else 1e-12
    for x, y, x0 in zip(fused, unfused, a[8:10]):
        scale = max(1.0, float(y.abs().max()))
        assert float((x - y).abs().max()) <= tol * scale
        if moved:
            assert float((x - x0).abs().max()) > 0.1


def test_flat_engine_on_card_matches_cpu(cuda):
    """The lanes engine's flat form (6-kernel loop, unfused refinement:
    rows 3-5, 9-12) on the card vs the same call on the CPU (plain
    versions): float64, both phases, the ngN=4 block at N=16, as the
    6-kernel check above; the fused pass (row 13) never runs."""
    dims, qpb = _batch(cuda, torch.float64, 16, 4, 40)
    cfg = IPMConfig(k_max=12, mu_tol=1e-10, iter_ref=1, use_pallas=True)
    names = [n for _, n in _SIX[3:5] + _UNFUSED]
    n0 = {n: sk.LAUNCHES[n] for n in names + ["refine_flat_fused"]}
    sol_g = ipm_lanes.solve_batched_lanes(dims, qpb, cfg, flat=True)
    assert all(sk.LAUNCHES[n] > n0[n] for n in names)
    assert sk.LAUNCHES["refine_flat_fused"] == n0["refine_flat_fused"]
    sol_c = ipm_lanes.solve_batched_lanes(dims, qpb.to("cpu"), cfg,
                                          flat=True)
    assert torch.equal(sol_g.kk.cpu(), sol_c.kk)
    assert torch.equal(sol_g.status.cpu(), sol_c.status)
    for f in ("z", "pi", "lam_b", "t_b", "lam_g", "t_g", "stat",
              "inf_norm_res"):
        g, c = getattr(sol_g, f).cpu(), getattr(sol_c, f)
        scale = max(1.0, float(c.abs().max()))
        assert float((g - c).abs().max()) <= 1e-6 * scale, f


def test_structured_soft_route_on_card_matches_cpu(cuda):
    """The structured soft IPM on the kernel backend (rows 16/15) on the
    card vs the same call on the CPU, float64, the soft problem at N=5,
    ``k_max=6`` (ROADMAP Queue 3, "Soft multipliers")."""
    dims, qp, soft = mass_spring_soft_qp(8, 3, 5, Z=10.0, device=cuda)
    qpb, sb = pbatch.broadcast_qp(qp, 40), pbatch.broadcast_soft(soft, 40)
    rng = np.random.default_rng(0)
    qpb = dataclasses.replace(qpb, g=qpb.g * torch.as_tensor(
        1 + 0.02 * rng.standard_normal(40), device=cuda)[:, None, None])
    cfg = IPMConfig(k_max=6, mu0=100.0, mu_tol=1e-10, use_pallas=True)
    n0 = {n: sk.LAUNCHES[n] for _, n in _STRUCT}
    sol_g = ipm_soft.solve(dims, qpb, sb, cfg)
    assert all(sk.LAUNCHES[n] > n0[n] for n in n0)
    sol_c = ipm_soft.solve(dims, qpb.to("cpu"),
                           type(sb)(*[x.cpu() for x in sb]), cfg)
    assert torch.equal(sol_g.kk.cpu(), sol_c.kk)
    assert torch.equal(sol_g.status.cpu(), sol_c.status)
    for f in ("z", "pi", "lam_b", "t_b", "lam_s", "t_s", "stat"):
        g, c = getattr(sol_g, f).cpu(), getattr(sol_c, f)
        scale = max(1.0, float(c.abs().max()))
        assert float((g - c).abs().max()) <= 1e-8 * scale, f


def test_unfused_wrappers_reject_bad_inputs(cuda, monkeypatch):
    dims, qpb = _batch(cuda, torch.float32, 4, 4, 16)
    calls = _capture(monkeypatch, dims, qpb,
                     IPMConfig(k_max=1, iter_ref=1, use_pallas=True),
                     _UNFUSED, flat=True)
    for (name, _, _), (a, k) in sorted(calls.items()):
        fn = getattr(sk, name)
        i = 2                                          # z / the gradient
        bad = list(a)
        bad[i] = a[i].double()
        with pytest.raises(TypeError):
            fn(*bad, **k)
        bad = list(a)
        bad[i] = a[i][..., :8].contiguous()            # batch
        with pytest.raises(ValueError):
            fn(*bad, **k)
        bad = list(a)
        bad[1] = a[1].cpu()                            # another device
        with pytest.raises(ValueError):
            fn(*bad, **k)
        bad = list(a)
        bad[-1] = a[-1].transpose(0, 1).contiguous().transpose(0, 1)
        with pytest.raises(ValueError):                # non-contiguous
            fn(*bad, **k)


def _dense_case(dev, dtype, unboxed):
    """The dense plan of the N=6 chain (input 2 unboxed at every stage
    with ``unboxed``) and its tick inputs."""
    from hpmpc_tpu_torch import api
    from hpmpc_tpu_torch.models import ipm_dense
    from hpmpc_tpu_torch.ops import dense_kernel as dk
    from hpmpc_tpu_torch.utils.mass_spring import mass_spring_data

    d = mass_spring_data(8, 3, 6)
    if unboxed:
        for n in range(6):
            keep = [k for k, j in enumerate(d["idxb"][n]) if j != 2]
            for key in ("idxb", "lb", "ub"):
                d[key][n] = d[key][n][keep]
    dims, qp = api.pack_problem(**d, dtype=dtype, device=dev)
    plan = ipm_dense.plan_dense(dims, qp)
    cfg = IPMConfig(k_max=30, mu_tol=1e-8 if dtype == torch.float64
                    else 1e-4)
    return plan, dk.dense_inputs(plan, qp.b.reshape(-1)), dk.dense_config(
        plan, cfg)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("unboxed", [False, True])
def test_dense_ipm_kernel_matches_plain(cuda, dtype, unboxed):
    """Row 23 vs its plain version: equal kk and status, y within 1e-10
    (f64) / 2e-4 (f32, chip_smoke.py's DENSE_TOL)."""
    from hpmpc_tpu_torch.ops import dense_kernel as dk

    _, args, kw = _dense_case(cuda, dtype, unboxed)
    n0 = dk.LAUNCHES
    out_k = dk.dense_ipm(*args, **kw)
    torch.cuda.synchronize()
    assert dk.LAUNCHES == n0 + 1
    out_p = dk.dense_ipm_plain(*args, **kw)
    assert (int(out_k[1]), int(out_k[3])) == (int(out_p[1]), int(out_p[3]))
    assert int(out_k[3]) == 0
    tol = 1e-10 if dtype == torch.float64 else 2e-4
    torch.testing.assert_close(out_k[0], out_p[0], rtol=0, atol=tol)


def test_dense_ipm_envelope_edge_f64(cuda):
    """Row 23 at the envelope's edge, nz = ngd = 128 in f64, where Hbar and
    G do not fit in shared memory together, so G is read from global
    memory (the kernel's other branch): a random SPD dense QP (3 of 4
    coordinates boxed), against the plain version.  kk and status equal;
    y within 3e-7: relative perturbations of 1e-15 in Hd and G move the
    plain version's y by up to 1.3e-8 at this QP's final mu (8.0e-9, kk
    8), and the kernel's summation order is such a perturbation."""
    from hpmpc_tpu_torch.ops import dense_kernel as dk

    nz = ngd = dk.MAX_DIM
    # csrc/dense_ipm.cu's smem_bytes: Hbar (odd stride), 24 vectors, G
    hbar_vecs = (nz * (nz | 1) + 24 * dk.MAX_DIM) * 8
    assert hbar_vecs <= 232448 < hbar_vecs + ngd * nz * 8
    rng = np.random.default_rng(0)
    M = rng.standard_normal((nz, nz))
    r = np.abs(rng.standard_normal(ngd))
    mz = (np.arange(nz) % 4 != 3).astype(float)
    data = (M @ M.T / nz + np.eye(nz),
            rng.standard_normal((ngd, nz)) / np.sqrt(nz),
            rng.standard_normal(nz), -0.5 * np.ones(nz), 0.5 * np.ones(nz),
            mz, -0.2 - r, 0.2 + r, np.zeros(nz))
    args = [torch.as_tensor(a, dtype=torch.float64, device=cuda)
            for a in data]
    kw = dict(k_max=30, mu0=2.0, mu_tol=1e-8, alpha_min=1e-8,
              mu_scal=1.0 / (2 * (int(mz.sum()) + ngd)))
    n0 = dk.LAUNCHES
    out_k = dk.dense_ipm(*args, **kw)
    torch.cuda.synchronize()
    assert dk.LAUNCHES == n0 + 1
    out_p = dk.dense_ipm_plain(*args, **kw)
    assert (int(out_k[1]), int(out_k[3])) == (int(out_p[1]), int(out_p[3]))
    assert int(out_k[3]) == 0
    torch.testing.assert_close(out_k[0], out_p[0], rtol=0, atol=3e-7)


def test_dense_ipm_rejects_bad_inputs(cuda):
    from hpmpc_tpu_torch.ops import dense_kernel as dk

    plan, args, kw = _dense_case(cuda, torch.float64, False)
    with pytest.raises(TypeError):
        dk.dense_ipm(args[0], args[1].float(), *args[2:], **kw)
    with pytest.raises(ValueError):
        dk.dense_ipm(args[0], args[1][:, :-1].contiguous(), *args[2:], **kw)
    with pytest.raises(ValueError):
        dk.dense_ipm(args[0].t().contiguous().t(), *args[1:], **kw)
    with pytest.raises(ValueError, match="envelope"):
        big = torch.zeros(129, 129, dtype=torch.float64, device=cuda)
        dk.dense_ipm(big, *args[1:], **kw)


def test_api_on_card_matches_cpu(cuda):
    """solve_ocp on the card (device=None) against the CPU, and a dense
    tick of the card's session (row 23) against the CPU session's (the
    kernel's plain version)."""
    from hpmpc_tpu_torch import api
    from hpmpc_tpu_torch.utils.mass_spring import mass_spring_data

    data = mass_spring_data(8, 3, 10)
    res_g, sess_g = api.solve_ocp(**data, return_session=True)
    res_c, sess_c = api.solve_ocp(**data, return_session=True,
                                  device="cpu")
    assert (res_g.kk, res_g.status) == (res_c.kk, res_c.status)
    for a, b in zip(res_g.x + res_g.u, res_c.x + res_c.u):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    x0 = data["x0"] * 0.9
    u_g, r_g = sess_g.dense_tick(x0=x0)
    u_c, r_c = sess_c.dense_tick(x0=x0)
    assert (int(r_g.kk), int(r_g.status)) == (int(r_c.kk), int(r_c.status))
    np.testing.assert_allclose(u_g, u_c, rtol=0, atol=1e-10)


def _tree_case(dev, dtype, ng_nodes, n_inst=37, topo=(2, 3, 10)):
    from hpmpc_tpu_torch.utils.mass_spring import mass_spring_tree_qp

    md, Nr, Nh = topo
    tdef, dims, qp = mass_spring_tree_qp(md=md, Nr=Nr, Nh=Nh,
                                         ng_nodes=ng_nodes, dtype=dtype,
                                         device=dev)
    qpb = pbatch.broadcast_qp(qp, n_inst)
    rng = np.random.default_rng(0)
    sc = torch.as_tensor(1 + 0.02 * rng.standard_normal(n_inst),
                         dtype=dtype, device=dev)
    return tdef, dims, dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])


def _tree_calls(monkeypatch, tdef, dims, qpb, k_max):
    """The first call of each tree wrapper in a flat tree solve."""
    from hpmpc_tpu_torch.models import tree
    from hpmpc_tpu_torch.ops import tree_kernel as tk

    calls = {}
    for name in ("tree_factor_solve_flat", "tree_solve_flat",
                 "tree_resid_terms_flat"):
        fn = getattr(tk, name)

        def spy(*a, _n=name, _fn=fn, **k):
            calls.setdefault(_n, (a, k))
            return _fn(*a, **k)
        monkeypatch.setattr(tk, name, spy)
    tree.solve_tree_ipm_flat(tdef, dims, qpb,
                             IPMConfig(k_max=k_max, use_pallas=True))
    monkeypatch.undo()
    return calls


def _flat_out(out):
    """A wrapper's output tensors, the factor state unpacked, None
    dropped."""
    if len(out) == 3 and isinstance(out[2], tuple):
        out = (*out[:2], *out[2])
    return [x for x in out if x is not None]


# (md, Nr, Nh) and ng nodes: the 71-node tree with and without general
# rows; 255 nodes (levels to 128 wide, past a block's teams; rows 26 and
# 27's kept rows past the size rule of csrc/tree_sweeps.cu: device memory);
# a chain (one node a level); md=3 (three children)
_TREE_TOPOS = [((2, 3, 10), ()), ((2, 3, 10), (0, 5)), ((2, 7, 7), ()),
               ((2, 0, 12), ()), ((3, 2, 4), ())]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("topo,ng_nodes", _TREE_TOPOS,
                         ids=["71", "71-ng", "255", "chain", "md3"])
def test_tree_kernels_match_plain(cuda, monkeypatch, dtype, topo, ng_nodes):
    """Rows 26-28 vs their plain versions on the flat tree engine's first
    calls (B=37), both forms of row 26: f64 within 1e-11 of a field's
    scale, f32 5e-5 (chip_smoke.py's MEGA_TOL); the 71- and 255-node trees
    on each side of rows 26-27's size rule."""
    from hpmpc_tpu_torch.ops import tree_kernel as tk

    tdef, dims, qpb = _tree_case(cuda, dtype, ng_nodes, topo=topo)
    wmax = max(map(len, tdef.levels))
    on_chip = [tk.layout(tdef.n_nodes, wmax, solve, dtype, NU=dims.NU,
                         NX=dims.NX)["on_chip"] for solve in (False, True)]
    if tdef.n_nodes == 71:
        assert on_chip == [1, 1]
    if tdef.n_nodes == 255:
        assert on_chip == [0, 0]
    calls = _tree_calls(monkeypatch, tdef, dims, qpb, 2)
    a, k = calls["tree_factor_solve_flat"]
    calls["tree_factor_solve_flat/want_pi"] = (a, dict(k, want_pi=True))
    tol = 1e-11 if dtype == torch.float64 else 5e-5
    for key, (a, k) in calls.items():
        name = key.split("/")[0]
        n0 = tk.LAUNCHES[name]
        out_k = getattr(tk, name)(*a, **k)
        torch.cuda.synchronize()
        assert tk.LAUNCHES[name] == n0 + 1
        out_p = getattr(tk, name + "_ref")(*a, **k)
        for x, y in zip(_flat_out(out_k), _flat_out(out_p)):
            scale = max(1.0, float(y.abs().max()))
            torch.testing.assert_close(x, y, rtol=0, atol=tol * scale)


def test_tree_engine_on_card_matches_cpu(cuda):
    """solve_batched_tree (f32, use_pallas: the flat tree engine, rows
    26-28 on the card) against the same call on the CPU (the plain
    versions): equal kk and status, z within 1e-3; and the f64 flat engine
    on the card against the f64 structured route within 1e-8."""
    from hpmpc_tpu_torch.models import tree
    from hpmpc_tpu_torch.ops import tree_kernel as tk

    cfg = IPMConfig(k_max=8, mu_tol=0.0, use_pallas=True)
    tdef, dims, qpb = _tree_case(cuda, torch.float32, (), n_inst=64,
                                 topo=(2, 2, 8))
    n0 = dict(tk.LAUNCHES)
    sol_g = pbatch.solve_batched_tree(tdef, dims, qpb, cfg)
    assert all(tk.LAUNCHES[k] > n0[k] for k in n0)
    sol_c = pbatch.solve_batched_tree(tdef, dims, qpb.to(device="cpu"), cfg)
    assert torch.equal(sol_g.kk.cpu(), sol_c.kk)
    assert torch.equal(sol_g.status.cpu(), sol_c.status)
    torch.testing.assert_close(sol_g.z.cpu(), sol_c.z, rtol=0, atol=1e-3)
    q64 = qpb.to(dtype=torch.float64)
    cfg64 = IPMConfig(k_max=30, use_pallas=True)
    sol_f = tree.solve_tree_ipm_flat(tdef, dims, q64, cfg64)
    sol_s = tree.solve_tree_ipm(tdef, dims, q64, cfg64)
    assert torch.equal(sol_f.kk, sol_s.kk)
    assert bool((sol_f.status == 0).all())
    torch.testing.assert_close(sol_f.z, sol_s.z, rtol=0, atol=1e-8)


def test_tree_wrappers_reject_bad_inputs(cuda, monkeypatch):
    from hpmpc_tpu_torch.ops import tree_kernel as tk

    tdef, dims, qpb = _tree_case(cuda, torch.float64, (0, 5), n_inst=8)
    calls = _tree_calls(monkeypatch, tdef, dims, qpb, 1)
    a, k = calls["tree_resid_terms_flat"]
    fn = tk.tree_resid_terms_flat
    bad = list(a)
    bad[3] = a[3].float()                              # dtype
    with pytest.raises(TypeError):
        fn(*bad, **k)
    bad = list(a)
    bad[3] = a[3][..., :4].contiguous()                # batch
    with pytest.raises(ValueError):
        fn(*bad, **k)
    bad = list(a)
    bad[1] = a[1].cpu()                                # another device
    with pytest.raises(ValueError):
        fn(*bad, **k)
    bad = list(a)
    bad[0] = (-1, 0, 3) + tuple(a[0][3:])              # not breadth-first
    with pytest.raises(ValueError, match="breadth-first"):
        fn(*bad, **k)
    a, k = calls["tree_factor_solve_flat"]
    with pytest.raises(ValueError, match="ngl"):       # ng nodes, no ngl
        tk.tree_factor_solve_flat(a[0], a[1], a[2], None, *a[4:], **k)


# ---- the large-NZ band: rows 24-25 and the blocked Riccati ---------------

def _spd_batch(dev, dtype, B, n, seed=0):
    A = np.random.default_rng(seed).standard_normal((B, n, n))
    return torch.as_tensor(A @ A.transpose(0, 2, 1) + n * np.eye(n),
                           dtype=dtype, device=dev)


# the kernel and the plain version round the update apart (FMA) and read
# different triangles of a symmetric input: roundoff of L's scale
_CHOL_TOL = {torch.float64: 1e-12, torch.float32: 1e-4}


# row 24's n: each side of a panel edge (8 columns), a non-multiple of the
# panel and of the 16-byte row (37), the band's 72 and 144, and the last n
# of the shared-memory form and the first past it in either type (332 in
# f32, 232 in f64: csrc/batch_chol.cu::chol)
_CHOL_N = [1, 5, 7, 8, 9, 37, 72, 144, 232, 233, 250, 332, 333]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", _CHOL_N)
def test_batch_chol_kernel_matches_plain(cuda, dtype, n):
    """Row 24 in both forms (the packed triangle in shared memory, the
    device-memory form)."""
    from hpmpc_tpu_torch.ops import batch_chol as bc

    M = _spd_batch(cuda, dtype, 9, n).reshape(3, 3, n, n)
    n0 = bc.LAUNCHES["cholesky"]
    L = bc.cholesky(M)
    torch.cuda.synchronize()
    assert bc.LAUNCHES["cholesky"] == n0 + 1 and L.shape == M.shape
    Lp = bc.cholesky_ref(M)
    assert bool((torch.triu(L, 1) == 0).all())
    scale = float(Lp.abs().max())
    assert float((L - Lp).abs().max()) <= _CHOL_TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [8, 72, 144, 250])
def test_batch_chol_kernel_clamped_pivot(cuda, dtype, n):
    """Row 24 with row and column 3 zero: the clamp takes tiny for the
    pivot, so L's column 3 is 0 (an unclamped 1/sqrt(0) would give NaN)."""
    from hpmpc_tpu_torch.ops import batch_chol as bc

    M = _spd_batch(cuda, dtype, 5, n)
    M[:, 3, :] = 0.0
    M[:, :, 3] = 0.0
    L = bc.cholesky(M)
    torch.cuda.synchronize()
    Lp = bc.cholesky_ref(M)
    assert bool(torch.isfinite(L).all())
    assert bool((torch.triu(L, 1) == 0).all())
    assert bool((L[:, :, 3] == 0).all())
    scale = float(Lp.abs().max())
    assert float((L - Lp).abs().max()) <= _CHOL_TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p", [1, 8, 16, 32])
def test_panel_factor_kernel_matches_plain(cuda, dtype, p):
    from hpmpc_tpu_torch.ops import batch_chol as bc

    A = _spd_batch(cuda, dtype, 37, p)
    n0 = bc.LAUNCHES["panel_factor"]
    L, Li = bc.panel_factor(A)
    torch.cuda.synchronize()
    assert bc.LAUNCHES["panel_factor"] == n0 + 1
    for x, y in zip((L, Li), bc.panel_factor_ref(A)):
        scale = max(1.0, float(y.abs().max()))
        assert float((x - y).abs().max()) <= _CHOL_TOL[dtype] * scale
    Lb = bc.cholesky_blocked(_spd_batch(cuda, dtype, 5, 45), p=p)
    Lr = bc.cholesky_ref(_spd_batch(cuda, dtype, 5, 45))
    assert float((Lb - Lr).abs().max()) <= _CHOL_TOL[dtype] * float(
        Lr.abs().max())


def test_batch_chol_wrappers_reject_bad_inputs(cuda):
    from hpmpc_tpu_torch.ops import batch_chol as bc

    M = _spd_batch(cuda, torch.float32, 4, 8)
    with pytest.raises(TypeError):
        bc.cholesky(M.half())
    with pytest.raises(ValueError):
        bc.cholesky(M[:, :, :7])
    with pytest.raises(TypeError):
        bc.panel_factor(M.half())
    with pytest.raises(ValueError):
        bc.panel_factor(_spd_batch(cuda, torch.float32, 2, 33))


def test_band_on_card_matches_cpu(cuda, monkeypatch):
    """The structured IPM on the blocked band (the envelope forced shut)
    on the card vs the same call on the CPU: float64, the ngN=4 block at
    N=16, 40 instances, 1e-6 of a field's scale (as the kernel backend's
    check); row 24 launches, the per-thread kernels do not."""
    from hpmpc_tpu_torch.ops import batch_chol as bc

    monkeypatch.setattr(sk, "engine_fits", lambda *a, **k: False)
    dims, qpb = _batch(cuda, torch.float64, 16, 4, 40)
    cfg = IPMConfig(k_max=12, mu_tol=1e-10, use_pallas=True)
    n0 = bc.LAUNCHES["cholesky"]
    s0 = {n: sk.LAUNCHES[n] for _, n in _STRUCT}
    sol_g = ipm.solve(dims, qpb, cfg)
    assert bc.LAUNCHES["cholesky"] > n0
    assert all(sk.LAUNCHES[n] == s0[n] for n in s0)
    sol_c = ipm.solve(dims, qpb.to("cpu"), cfg)
    assert torch.equal(sol_g.kk.cpu(), sol_c.kk)
    assert torch.equal(sol_g.status.cpu(), sol_c.status)
    for f in ("z", "pi", "lam_b", "t_b", "stat", "inf_norm_res"):
        g, c = getattr(sol_g, f).cpu(), getattr(sol_c, f)
        scale = max(1.0, float(c.abs().max()))
        assert float((g - c).abs().max()) <= 1e-6 * scale, f
