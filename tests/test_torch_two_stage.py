"""The 6-kernel lanes loop with iterative refinement and bench.py's parity
route (``parallel.batch.solve_batched`` -> two-stage resident -> lanes +
``iter_ref``) of the PyTorch port vs the JAX package's structured solver
``ipm.solve`` (vmapped, plain XLA, no Pallas), on the same batch handed
over through ``convert.qp_from_numpy``.  On the CPU the port's kernel
wrappers run their plain versions; their call counters show which ran.

  (a) float64, ``iter_ref=2`` ungated, default two-phase tolerances,
      iterate for iterate: kk and status equal, z within 1e-8 (the
      tolerance of tests/test_torch_lanes.py, whose setups these are:
      box-only at N=5, the ngN=4 terminal block at N=16).
  (b) ``HPMPC_MEGA_SWEEPS=0`` (the 6-kernel loop without refinement)
      equals the mega route, float64, N=16 ngN=4: kk and status equal, z
      within 1e-10 (the same arithmetic; only the ng gradient rows are
      added by another einsum).
  (c) the parity route, float32, N=4, B=64, K=6, stage 1 on the resident
      engine and (``HPMPC_RESIDENT=0``) on the lanes engine, against the
      f64 structured solve: max control error <= 1e-6, kk <= K, and below
      the unrefined f32 route's (the assertions of tests/test_resident.py
      and tests/test_stage_kernel.py for the same route in the JAX
      package).
  (d) the hand-off across packages: a JAX structured stage-1 solution
      (f64, phase 1 to mu <= 1e-3, no refinement), handed over with
      ``convert.solution_from_numpy``, continued by the port's lanes
      engine (``state0``) ends where the JAX structured solve run from the
      start ends: kk and status equal, z within 1e-8.

The JAX references compile without XLA's backend optimisations
(tests/test_torch_ipm_structured.py's ``jit_fast``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hpmpc_tpu.models import ipm as jipm  # noqa: E402
from hpmpc_tpu.parallel import batch as jbatch  # noqa: E402
from hpmpc_tpu.utils.mass_spring import mass_spring_qp as j_mass_spring  # noqa: E402
from hpmpc_tpu_torch.convert import (QP_FIELDS, qp_from_numpy,  # noqa: E402
                                     solution_from_numpy)
from hpmpc_tpu_torch.models import ipm_lanes  # noqa: E402
from hpmpc_tpu_torch.models.ipm import IPMConfig, IPMSolution  # noqa: E402
from hpmpc_tpu_torch.ops import mega_kernel as mk  # noqa: E402
from hpmpc_tpu_torch.ops import stage_kernel as sk  # noqa: E402
from hpmpc_tpu_torch.ops import step_kernel as stk  # noqa: E402
from hpmpc_tpu_torch.parallel import batch as tbatch  # noqa: E402
from test_torch_ipm_structured import jit_fast  # noqa: E402

torch.set_num_threads(1)


def _twin(N, B, ngN, jdt, tdt):
    """The same perturbed batch for both packages: (dims, jax qp, port qp)."""
    dims, qp_j = j_mass_spring(8, 3, N, ngN=ngN, dtype=jdt)
    qpb = jbatch.broadcast_qp(qp_j, B)
    rng = np.random.default_rng(0)
    qpb = dataclasses.replace(
        qpb, b=qpb.b * jnp.asarray(1 + 0.02 * rng.standard_normal(B),
                                   jdt)[:, None, None])
    qpt = qp_from_numpy(dims, {f: np.asarray(getattr(qpb, f))
                               for f in QP_FIELDS}, device="cpu", dtype=tdt)
    return dims, qpb, qpt


def _structured(dims, qpb, **kw):
    cfg = jipm.IPMConfig(**kw)
    return jit_fast(jax.vmap(lambda q: jipm.solve(dims, q, cfg)), qpb)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _counts():
    return ({k: sum(v) for k, v in stk.PLAIN_CALLS.items()}
            | dict(sk.PLAIN_CALLS)
            | {k: sum(v) for k, v in mk.PLAIN_CALLS.items()})


def _ran(before):
    return {k: v - before[k] for k, v in _counts().items()}


_REF_KW = dict(k_max=12, mu_tol=1e-10, iter_ref=2)
_STRUCTURED = {}


def _structured_ref(N, ngN):
    """(dims, jax qp, port qp, the structured f64 ``iter_ref=2`` solve),
    made once per (N, ngN) in this process: (a) and (d) share N=5."""
    if (N, ngN) not in _STRUCTURED:
        dims, qpb, qpt = _twin(N, 8, ngN, jnp.float64, torch.float64)
        _STRUCTURED[(N, ngN)] = (dims, qpb, qpt,
                                 _structured(dims, qpb, **_REF_KW))
    return _STRUCTURED[(N, ngN)]


@pytest.mark.parametrize("N,ngN", [(5, 0), (16, 4)])
def test_lanes_iter_ref_f64_matches_structured(N, ngN):
    kw = _REF_KW
    dims, qpb, qpt, sol_x = _structured_ref(N, ngN)
    n0 = _counts()
    sol_t = ipm_lanes.solve_batched_lanes(dims, qpt,
                                          IPMConfig(use_pallas=True, **kw))
    ran = _ran(n0)
    # two refinement passes after each of the two solves of an iteration
    assert ran["refine_flat_fused"] == 4 * ran["factor_solve_folded_flat"]
    assert ran["solve_flat"] == ran["factor_solve_folded_flat"] >= 1
    assert ran["factor_solve_mega"] == ran["solve_mega"] == 0
    np.testing.assert_array_equal(_np(sol_t.kk), _np(sol_x.kk))
    np.testing.assert_array_equal(_np(sol_t.status), _np(sol_x.status))
    assert (_np(sol_t.status) == 0).sum() >= 7, _np(sol_t.status)
    np.testing.assert_allclose(_np(sol_t.z), _np(sol_x.z), atol=1e-8)


def test_six_kernel_loop_equals_mega_route_f64(monkeypatch):
    monkeypatch.delenv("HPMPC_MEGA_SWEEPS", raising=False)
    dims, _, qpt = _twin(16, 8, 4, jnp.float64, torch.float64)
    cfg = IPMConfig(k_max=12, mu_tol=1e-10, use_pallas=True)
    mega = ipm_lanes.solve_batched_lanes(dims, qpt, cfg)
    monkeypatch.setenv("HPMPC_MEGA_SWEEPS", "0")
    n0 = _counts()
    six = ipm_lanes.solve_batched_lanes(dims, qpt, cfg)
    ran = _ran(n0)
    assert ran["factor_solve_mega"] == ran["solve_mega"] == 0
    assert ran["refine_flat_fused"] == 0
    assert min(ran[k] for k in ("prep_flat", "alpha_sums_flat",
                                "corr_geff_flat", "factor_solve_folded_flat",
                                "solve_flat")) >= 1, ran
    np.testing.assert_array_equal(_np(six.kk), _np(mega.kk))
    np.testing.assert_array_equal(_np(six.status), _np(mega.status))
    np.testing.assert_allclose(_np(six.z), _np(mega.z), atol=1e-10)


_PARITY = {}


def _parity_ref(K, B):
    """(dims, port qp, the f64 structured solve at ``k_max=K``) of the
    parity tests' f32 batch, made once per process."""
    if (K, B) not in _PARITY:
        dims, qpb, qpt = _twin(4, B, 0, jnp.float32, torch.float32)
        qpb64 = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32
            else x, qpb)
        _PARITY[(K, B)] = (dims, qpt,
                           _structured(dims, qpb64, k_max=K, mu_tol=0.0))
    return _PARITY[(K, B)]


@pytest.mark.parametrize("resident,engine", [
    ("1", "two_stage_resident"), ("0", "two_stage_lanes")])
def test_parity_route_f32_meets_f64_control_parity(monkeypatch, resident,
                                                    engine):
    """Stage 1 on the resident engine, or with ``HPMPC_RESIDENT=0`` on the
    lanes engine (its mega route), then the refined lanes stage 2."""
    for k in ("HPMPC_LANES_LOOP", "HPMPC_MEGA_SWEEPS",
              "HPMPC_STAGE2_LANES"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HPMPC_RESIDENT", resident)
    K, B = 6, 64
    dims, qpt, sol64 = _parity_ref(K, B)
    cfg = IPMConfig(k_max=K, mu_tol=0.0, iter_ref=1, iter_ref_mu_thr=1e-3,
                    use_pallas=True)
    assert tbatch.select_engine(dims, cfg, B, torch.float32) == engine
    n0 = _counts()
    sol = tbatch.solve_batched(dims, qpt, cfg)
    ran = _ran(n0)
    for k in ("prep_flat", "alpha_sums_flat", "corr_geff_flat",
              "factor_solve_folded_flat", "solve_flat", "refine_flat_fused"):
        assert ran[k] >= 1, ran
    raw_cfg = dataclasses.replace(cfg, iter_ref=0)
    assert tbatch.select_engine(dims, raw_cfg, B, torch.float32) == "lanes"
    raw = tbatch.solve_batched(dims, qpt, raw_cfg)
    assert int(sol.kk.max()) <= K
    u64 = _np(sol64.z)[:, :, :dims.NU]
    err = np.abs(_np(sol.z).astype(np.float64)[:, :, :dims.NU] - u64).max()
    err_raw = np.abs(_np(raw.z).astype(np.float64)[:, :, :dims.NU]
                     - u64).max()
    assert err <= 1e-6, f"refined control error {err:.2e} > 1e-6"
    assert err < err_raw, (err, err_raw)


def test_hot_continuation_from_a_jax_stage1_solution():
    """The two-stage hand-off across packages: a JAX stage-1 solution
    (structured, f64, stopped at mu <= 1e-3) becomes the port's
    ``IPMSolution`` through ``solution_from_numpy`` and seeds the port's
    lanes engine (``state0``, refinement on), which carries kk and the
    stat rows and finishes like the JAX structured solve run to the end."""
    dims, qpb, qpt, full = _structured_ref(5, 0)
    s1 = _structured(dims, qpb, k_max=12, mu_tol=1e-3, mu_switch=1e-3)
    state0 = solution_from_numpy({f: np.asarray(getattr(s1, f))
                                  for f in IPMSolution._fields},
                                 device="cpu")
    assert state0.kk.dtype == torch.int32 and state0.z.dtype == torch.float64
    sol = ipm_lanes.solve_batched_lanes(
        dims, qpt, IPMConfig(use_pallas=True, **_REF_KW), state0=state0)
    assert np.all(_np(s1.kk) >= 1)
    np.testing.assert_array_equal(_np(sol.stat)[:, 0], _np(s1.stat)[:, 0])
    np.testing.assert_array_equal(_np(sol.kk), _np(full.kk))
    np.testing.assert_array_equal(_np(sol.status), _np(full.status))
    np.testing.assert_allclose(_np(sol.z), _np(full.z), atol=1e-8)
