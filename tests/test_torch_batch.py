"""The port's slices as a whole: ``parallel.batch.solve_batched`` of the
PyTorch port vs the JAX package's ``solve_batched`` on the resident route
(``HPMPC_RESIDENT=1``, Pallas in interpret mode), the dispatch rule, the
default-tolerance route into the lanes engine, the structured route (the
library's default ``IPMConfig()``, and ``use_pallas`` without a static
``idxb``), the float32 escalation, ``solve_single``, the engines folded
into the lanes engine, and the fused sweeps that still raise.  The
JAX references compile without XLA's backend optimisations
(tests/test_torch_ipm_structured.py's ``jit_fast``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from hpmpc_tpu.models import ipm as jipm  # noqa: E402
from hpmpc_tpu.parallel import batch as jbatch  # noqa: E402
from hpmpc_tpu.utils.mass_spring import mass_spring_qp as j_mass_spring  # noqa: E402
from hpmpc_tpu_torch.convert import QP_FIELDS, qp_from_numpy  # noqa: E402
from hpmpc_tpu_torch.models.ipm import IPMConfig  # noqa: E402
from hpmpc_tpu_torch.parallel import batch as tbatch  # noqa: E402
from hpmpc_tpu_torch.utils.mass_spring import mass_spring_qp  # noqa: E402
from test_torch_ipm_structured import jax_batch, jit_fast  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_solve_batched_matches_jax(interpret_pallas, monkeypatch):
    """f32 box-only, the 2-mass chain (nx=4, nu=2, N=3): both packages'
    library entry point on the resident route, at tests/test_resident.py's
    tolerances.  The width keeps the interpret-mode compilation of the JAX
    resident kernel short (see tests/test_torch_resident.py (a))."""
    monkeypatch.setenv("HPMPC_RESIDENT", "1")
    B = 1024
    dims, qp_j = j_mass_spring(4, 2, 3, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    qpb = jax_batch(qp_j, B, b=1 + 0.02 * rng.standard_normal(B))
    qp_t = qp_from_numpy(dims, {f: np.asarray(getattr(qpb, f))
                                for f in QP_FIELDS}, device="cpu",
                         dtype=torch.float32)
    kw = dict(k_max=3, mu_tol=1e-4, mu_switch=0.0, use_pallas=True)
    cfg_j, cfg_t = jipm.IPMConfig(**kw), IPMConfig(**kw)
    assert jbatch.select_engine(dims, cfg_j, B, jnp.float32) == "resident"
    assert tbatch.select_engine(dims, cfg_t, B, torch.float32) == "resident"
    sol_j = jit_fast(jbatch.solve_batched, dims, qpb, cfg_j)
    sol_t = tbatch.solve_batched(dims, qp_t, cfg_t)

    np.testing.assert_array_equal(_np(sol_t.kk), _np(sol_j.kk))
    np.testing.assert_array_equal(_np(sol_t.status), _np(sol_j.status))
    np.testing.assert_allclose(_np(sol_t.z), _np(sol_j.z), atol=2e-3)
    np.testing.assert_allclose(_np(sol_t.pi), _np(sol_j.pi), atol=5e-3)
    np.testing.assert_allclose(_np(sol_t.lam_b), _np(sol_j.lam_b),
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(_np(sol_t.t_b), _np(sol_j.t_b),
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(_np(sol_t.stat), _np(sol_j.stat),
                               rtol=2e-2, atol=2e-4)
    np.testing.assert_allclose(_np(sol_t.inf_norm_res),
                               _np(sol_j.inf_norm_res), rtol=5e-2, atol=5e-3)
    for f in sol_t._fields:
        assert _np(getattr(sol_t, f)).shape == _np(getattr(sol_j, f)).shape, f


_CFGS = [
    dict(mu_tol=0.0, mu_switch=0.0),                   # bench headline
    dict(mu_tol=1e-8, mu_switch=1e-5),                 # library default
    dict(mu_tol=1e-8, mu_switch=1e-8),
    dict(mu_tol=0.0, iter_ref=1, iter_ref_mu_thr=1e-3),  # bench parity
    dict(mu_tol=0.0, iter_ref=1, iter_ref_mu_thr=1e-3, mu_switch=1e-2),
    dict(mu_tol=0.0, iter_ref=1),
    dict(mu_tol=1e-8, use_pallas=False),
    dict(mu_tol=1e-8, iter_ref=2, iter_ref_mu_thr=1e-4),  # two-stage, gated
    dict(mu_tol=1e-8, iter_ref=1, iter_ref_mu_thr=1e-6),  # mu_switch above
]


@pytest.mark.parametrize("env", [{}, {"HPMPC_RESIDENT": "0"},
                                 {"HPMPC_LANES_LOOP": "0"},
                                 {"HPMPC_LANES_LOOP": "0",
                                  "HPMPC_MEGA_SWEEPS": "1"}])
@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("ci", range(len(_CFGS)))
def test_select_engine_agrees_with_jax(monkeypatch, ci, f32, env):
    for k in ("HPMPC_RESIDENT", "HPMPC_LANES_LOOP", "HPMPC_MEGA_SWEEPS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(k_max=8, use_pallas=True)
    kw.update(_CFGS[ci])
    dims, _ = mass_spring_qp(8, 3, 30, ngN=8, device="cpu")
    jdt, tdt = ((jnp.float32, torch.float32) if f32
                else (jnp.float64, torch.float64))
    e_j = jbatch.select_engine(dims, jipm.IPMConfig(**kw), 4096, jdt)
    e_t = tbatch.select_engine(dims, IPMConfig(**kw), 4096, tdt)
    assert e_t == e_j


@pytest.mark.parametrize("kw", [
    dict(mu_tol=1e-8, mu_switch=1e-5, use_pallas=True,
         dtype=torch.float64),                              # -> flat
    dict(mu_tol=0.0, iter_ref=1, iter_ref_mu_thr=1e-3, use_pallas=True,
         env={"HPMPC_STAGE2_LANES": "0"}),    # -> two-stage, flat stage 2
    dict(mu_tol=0.0, iter_ref=1, use_pallas=True,
         env={"HPMPC_FUSED_SWEEPS": "1"}),   # -> flat, row 9 + row 17
])
def test_unported_engines_raise(monkeypatch, kw):
    """The engines the port folded in run (the flat form of the lanes
    engine: a finite solution), the fused sweeps too: under
    ``HPMPC_FUSED_SWEEPS=1`` the f32 ``iter_ref`` batch's flat engine
    re-solves on row 17 (``solve_flat_fused``) and, as its refinement reads
    the affine pi, keeps row 9 for the factorization."""
    monkeypatch.delenv("HPMPC_RESIDENT", raising=False)
    monkeypatch.delenv("HPMPC_FUSED_SWEEPS", raising=False)
    kw = dict(kw)
    env = kw.pop("env", {})
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    from hpmpc_tpu_torch.ops import stage_kernel as sk

    dims, qp = mass_spring_qp(8, 3, 4, dtype=kw.pop("dtype", torch.float32),
                              device="cpu")
    qpb = tbatch.broadcast_qp(qp, 8)
    n0 = dict(sk.PLAIN_CALLS)
    sol = tbatch.solve_batched(dims, qpb, IPMConfig(k_max=2, **kw))
    ran = {k: v - n0[k] for k, v in sk.PLAIN_CALLS.items()}
    if env.get("HPMPC_FUSED_SWEEPS"):   # both iterations on rows 9 and 17
        assert ran["factor_solve_folded_flat"] == ran["solve_flat_fused"] \
            == 2, ran
        assert ran["factor_solve_folded_flat_fused"] == ran["solve_flat"] \
            == 0, ran
    assert int(sol.kk.min()) == 2
    assert all(bool(torch.isfinite(x).all()) for x in sol
               if x.is_floating_point())


def test_solve_batched_default_tolerances_run_lanes(monkeypatch):
    """The library's default tolerances (mu_tol 1e-8, mu_switch 1e-5) with
    the kernels on (f32) go to the lanes engine, which here runs both
    phases through both mega wrappers (on the CPU: their plain versions),
    converges, and returns what calling the engine directly returns.  With
    ``HPMPC_MEGA_SWEEPS=0`` the same call runs the 6-kernel sequence and
    returns the same bits: on the CPU the mega wrappers' plain versions are
    that sequence's plain passes composed."""
    from hpmpc_tpu_torch.models import ipm_lanes
    from hpmpc_tpu_torch.ops import mega_kernel as mk
    from hpmpc_tpu_torch.ops import stage_kernel as sk

    for k in ("HPMPC_RESIDENT", "HPMPC_LANES_LOOP", "HPMPC_MEGA_SWEEPS"):
        monkeypatch.delenv(k, raising=False)
    dims, qp = mass_spring_qp(8, 3, 4, dtype=torch.float32, device="cpu")
    qpb = tbatch.broadcast_qp(qp, 8)
    cfg = IPMConfig(k_max=12, use_pallas=True)
    assert tbatch.select_engine(dims, cfg, 8, torch.float32) == "lanes"
    before = {k: list(v) for k, v in mk.PLAIN_CALLS.items()}
    sol = tbatch.solve_batched(dims, qpb, cfg)
    for name, counts in mk.PLAIN_CALLS.items():
        assert all(a > b for a, b in zip(counts, before[name])), name
    assert bool((sol.status == 0).all())
    ref = ipm_lanes.solve_batched_lanes(dims, qpb, cfg)
    for f in sol._fields:
        assert torch.equal(getattr(sol, f), getattr(ref, f)), f
    monkeypatch.setenv("HPMPC_MEGA_SWEEPS", "0")
    n_mega = {k: list(v) for k, v in mk.PLAIN_CALLS.items()}
    n_six = dict(sk.PLAIN_CALLS)
    six = tbatch.solve_batched(dims, qpb, cfg)
    assert mk.PLAIN_CALLS == n_mega
    assert all(sk.PLAIN_CALLS[k] > n_six[k]
               for k in ("factor_solve_folded_flat", "solve_flat"))
    for f in sol._fields:
        assert torch.equal(getattr(six, f), getattr(sol, f)), f


def _small_batch(dtype, B=8, spread=0.3):
    """The nx=8 nu=3 N=4 mass-spring batch with ``b`` scaled by 1 +
    ``spread`` N(0,1) per instance (numpy seed 0)."""
    dims, qp = mass_spring_qp(8, 3, 4, dtype=dtype, device="cpu")
    qpb = tbatch.broadcast_qp(qp, B)
    rng = np.random.default_rng(0)
    sc = torch.as_tensor(1 + spread * rng.standard_normal(B), dtype=dtype)
    return dims, dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])


def _equal(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _kernel_calls():
    from hpmpc_tpu_torch.ops import mega_kernel as mk
    from hpmpc_tpu_torch.ops import stage_kernel as sk

    return (dict(sk.PLAIN_CALLS),
            {k: list(v) for k, v in mk.PLAIN_CALLS.items()})


def test_library_default_config_runs_structured(monkeypatch):
    """``IPMConfig()`` (no ``use_pallas``) goes to the structured route on
    its plain backend, in both types: no kernel wrapper runs."""
    from hpmpc_tpu_torch.models import ipm

    monkeypatch.delenv("HPMPC_RESIDENT", raising=False)
    for dt in (torch.float32, torch.float64):
        dims, qpb = _small_batch(dt, B=4)
        assert tbatch.select_engine(dims, IPMConfig(), 4, dt) == "structured"
        before = _kernel_calls()
        sol = tbatch.solve_batched(dims, qpb, IPMConfig())
        assert _kernel_calls() == before
        _equal(sol, ipm.solve(dims, qpb, IPMConfig()))
        assert sol.z.dtype == dt
    assert bool((sol.status == 0).all())


def test_no_idxb_kernel_config_runs_rows_16_and_15():
    """``use_pallas`` on dims without a static ``idxb`` dispatches to
    ``"structured"`` (the JAX rule) and its kernel backend: the
    factorization and the re-solve wrappers run (their plain versions on
    the CPU), every iteration."""
    from hpmpc_tpu_torch.models import ipm
    from hpmpc_tpu_torch.ops import stage_kernel as sk

    dims, qpb = _small_batch(torch.float64, B=4)
    dims0 = dataclasses.replace(dims, idxb=None)
    cfg = IPMConfig(k_max=12, use_pallas=True)
    assert tbatch.select_engine(dims0, cfg, 4, torch.float64) == "structured"
    assert jbatch.select_engine(dims0, jipm.IPMConfig(k_max=12,
                                                      use_pallas=True),
                                4, jnp.float64) == "structured"
    n0 = dict(sk.PLAIN_CALLS)
    sol = tbatch.solve_batched(dims0, qpb, cfg)
    ran = {k: sk.PLAIN_CALLS[k] - n0[k]
           for k in ("factor_solve_folded", "solve_batched")}
    assert ran["factor_solve_folded"] == ran["solve_batched"] >= int(
        sol.kk.max()), ran
    _equal(sol, ipm.solve(dims, qpb, cfg))
    assert bool((sol.status == 0).all())


def test_escalate_stalled_resolves_in_float64(monkeypatch):
    """float32 with ``use_pallas`` and ``escalate_stalled``: the lanes
    engine solves the batch, every instance it leaves unconverged (here at
    ``k_max=6``: 5 of 8 hit the budget) is re-solved in float64 by the
    structured route on its plain backend and merged back; the converged
    instances keep their bits.  Each re-solved instance equals the float64
    structured solve of the whole batch, cast back (instances are
    independent: kk and status equal, values within a float32 ulp)."""
    from hpmpc_tpu_torch.models import ipm

    for k in ("HPMPC_RESIDENT", "HPMPC_LANES_LOOP", "HPMPC_MEGA_SWEEPS"):
        monkeypatch.delenv(k, raising=False)
    dims, qpb = _small_batch(torch.float32)
    cfg = IPMConfig(k_max=6, use_pallas=True, escalate_stalled=True)
    base_cfg = dataclasses.replace(cfg, escalate_stalled=False)
    assert tbatch.select_engine(dims, base_cfg, 8, torch.float32) == "lanes"
    base = tbatch.solve_batched(dims, qpb, base_cfg)
    stalled = base.status != 0
    assert 0 < int(stalled.sum()) < 8
    sol = tbatch.solve_batched(dims, qpb, cfg)
    ref = ipm.solve(dims, qpb.to(dtype=torch.float64),
                    dataclasses.replace(base_cfg, use_pallas=False))
    for f in sol._fields:
        a, b, r = getattr(sol, f), getattr(base, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a[~stalled], b[~stalled]), f
        r = r[stalled].to(a.dtype)
        if a.is_floating_point():
            torch.testing.assert_close(a[stalled], r, rtol=2e-7, atol=1e-30)
        else:
            assert torch.equal(a[stalled], r), f
    # nothing stalled: the solution is returned as it is
    again = tbatch._escalate_stalled(dims, qpb, base_cfg, sol._replace(
        status=torch.zeros_like(sol.status)), None, None)
    assert again.z is sol.z


@pytest.mark.parametrize("dt,kw", [(torch.float64, {}),
                                   (torch.float32, dict(use_pallas=True))])
def test_solve_single_is_row_0_of_the_batch(monkeypatch, dt, kw):
    """``solve_single`` on an unbatched QP equals row 0 of the batched
    solve of copies of it (structured route in f64, lanes route in f32)."""
    monkeypatch.delenv("HPMPC_RESIDENT", raising=False)
    dims, qp = mass_spring_qp(8, 3, 4, dtype=dt, device="cpu")
    cfg = IPMConfig(k_max=12, **kw)
    one = tbatch.solve_single(dims, qp, cfg)
    many = tbatch.solve_batched(dims, tbatch.broadcast_qp(qp, 3), cfg)
    for f in one._fields:
        assert getattr(one, f).shape == getattr(many, f).shape[1:], f
        assert torch.equal(getattr(one, f), getattr(many, f)[0]), f
