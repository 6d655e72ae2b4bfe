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
    ipm_lanes, ipm_resident, ipm_soft, ipm_soft_lanes)
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


def _batch(dev, dtype, N, ngN, B):
    dims, qp = mass_spring_qp(8, 3, N, ngN=ngN, dtype=dtype, device=dev)
    qpb = pbatch.broadcast_qp(qp, B)
    rng = np.random.default_rng(0)
    sc = torch.as_tensor(1 + 0.02 * rng.standard_normal(B), dtype=dtype,
                         device=dev)
    return dims, dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ngN,B", [(0, 64), (4, 37)])
def test_ipm_resident_kernel_matches_plain(cuda, dtype, ngN, B):
    dims, qpb = _batch(cuda, dtype, 4, ngN, B)
    args, kw, _, _ = ipm_resident.resident_inputs(dims, qpb,
                                                  IPMConfig(**_CFG[dtype]))
    n0 = rk.LAUNCHES
    out_k = rk.ipm_resident(*args, **kw)
    torch.cuda.synchronize()
    assert rk.LAUNCHES == n0 + 1
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


def _capture(monkeypatch, dims, qpb, cfg, targets):
    """Arguments of the first call of each wrapper ``(module, name)`` of
    ``targets`` in one lanes-engine solve: {(name, phase2, with_dl0):
    (args, kwargs)}; phase2 is None for the sweeps, which take no phase,
    and with_dl0 marks the alpha pass with the phase-1 centering stream."""
    calls = {}
    for mod, name in targets:
        def spy(*a, _name=name, _fn=getattr(mod, name), **k):
            key = (_name, k.get("phase2"),
                   _name == "alpha_sums_flat" and a[6] is not None)
            calls.setdefault(key, (a, k))
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    ipm_lanes.solve_batched_lanes(dims, qpb, cfg)
    monkeypatch.undo()
    return calls


def _flat(out):
    """Tensors of a mega wrapper's output, the factor state unpacked."""
    return [x for o in out for x in (o if isinstance(o, tuple) else (o,))]


# one mega call, kernel vs plain: no iteration amplifies the roundoff of the
# two summation orders (host builds of the kernels measured <= 1.5e-6 of
# each field's scale in f32, 2.3e-15 in f64), so 5e-5 / 1e-11 of the scale
_MEGA_TOL = {torch.float32: 5e-5, torch.float64: 1e-11}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ngN", [0, 4])
@pytest.mark.parametrize("phase2", [False, True])
def test_mega_kernels_match_plain(cuda, monkeypatch, dtype, ngN, phase2):
    """Each mega kernel on the arguments of the engine's first call of that
    phase (phase 1: the initial iterate; phase 2, run alone with
    mu_switch=1e9: A = rd, M = rm at the initial iterate), B=37 so the
    last warp is ragged."""
    dims, qpb = _batch(cuda, dtype, 4, ngN, 37)
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ngN", [0, 4])
@pytest.mark.parametrize("phase2", [False, True])
def test_six_kernels_match_plain(cuda, monkeypatch, dtype, ngN, phase2):
    """Each kernel of the 6-kernel loop (rows 3-5, 9, 10 and 13) on the
    arguments of the engine's first call of it in one iteration with
    ungated refinement (phase 2 alone with mu_switch=1e9), B=37; one call,
    so the tolerance of the mega kernels' check."""
    dims, qpb = _batch(cuda, dtype, 4, ngN, 37)
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


def _soft_batch(dev, dtype, N, ng, B):
    """The reference's soft problem (mass_spring_soft_qp(8, 3, N, Z=10)),
    ``g`` scaled per instance; with ``ng`` one general row on stages 2
    and N (tests/test_ipm_soft_lanes.py's ng problem)."""
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
            qp, C=C, d_lg=d_lg, d_ug=-d_lg,
            ng_mask=torch.as_tensor(dims.ng_mask(), dtype=dtype, device=dev))
    qpb = pbatch.broadcast_qp(qp, B)
    rng = np.random.default_rng(0)
    sc = torch.as_tensor(1 + 0.02 * rng.standard_normal(B), dtype=dtype,
                         device=dev)
    return (dims, dataclasses.replace(qpb, g=qpb.g * sc[:, None, None]),
            pbatch.broadcast_soft(soft, B), soft.idxbs.cpu().numpy())


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
    engine's first call of it (the initial iterate; the 6-kernel loop with
    HPMPC_MEGA_SWEEPS=0), B=37; one call, so the mega kernels' tolerance."""
    batch = _soft_batch(cuda, dtype, 5, ng, 37)
    cfg = IPMConfig(k_max=1, mu0=100.0, use_pallas=True)
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


def test_soft_wrappers_reject_bad_inputs(cuda, monkeypatch):
    batch = _soft_batch(cuda, torch.float32, 5, True, 16)
    cfg = IPMConfig(k_max=1, mu0=100.0, use_pallas=True)
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
