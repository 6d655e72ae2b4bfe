"""The lanes engine of the PyTorch port (``solve_batched_lanes``, the
two-phase ``d_ip2_res_hard`` algorithm on the mega kernels) vs the JAX
package's structured two-phase solver ``ipm.solve`` (vmapped, plain XLA,
no Pallas), on the same batch handed over through
``convert.qp_from_numpy``.  On the CPU the port's kernel wrappers run
their plain versions; their per-phase call counters show which phases
ran.

  (a) float64, default two-phase tolerances (phase 1 to ``mu_switch``,
      phase 2 to ``mu_tol``), iterate for iterate: kk and status equal, z
      within 1e-8 and pi within 1e-7 (tests/test_ipm_lanes.py's
      tolerances for its lanes-vs-structured check).  Box-only at N=5,
      and with the ngN=4 terminal equality block at N=16: at N=5 that
      block cannot be met (|u| <= 0.5 cannot bring the chain to rest in 5
      steps), mu climbs to ~1e7 and the multipliers grow without bound;
      N=16 is the shortest horizon tried (5, 8, 10, 12, 16, 20) on which
      every instance converges (7 of 8 within this budget).  At N=16 also
      on the 6-kernel loop under ``HPMPC_FUSED_SWEEPS=1`` (rows 18 and 17,
      the fused sweeps, in place of the mega kernels), against the same
      JAX solve.
  (b) float32, phase 2 only (``mu_switch=1e9``) with the ngN=4 block, the
      setup of tests/test_ipm_lanes.py::test_lanes_engine_mega_phase2_ng:
      kk on at least 15 of 16 instances, z within 2e-3 where kk agrees.

The JAX references compile without XLA's backend optimisations
(tests/test_torch_ipm_structured.py's ``jit_fast``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hpmpc_tpu.models import ipm as jipm  # noqa: E402
from hpmpc_tpu.utils.mass_spring import mass_spring_qp as j_mass_spring  # noqa: E402
from hpmpc_tpu_torch.convert import QP_FIELDS, qp_from_numpy  # noqa: E402
from hpmpc_tpu_torch.models import ipm_lanes  # noqa: E402
from hpmpc_tpu_torch.models.ipm import IPMConfig  # noqa: E402
from hpmpc_tpu_torch.ops import mega_kernel as mk  # noqa: E402
from hpmpc_tpu_torch.ops import stage_kernel as sk  # noqa: E402
from test_torch_ipm_structured import jax_batch, jit_fast  # noqa: E402

torch.set_num_threads(1)


def _twin(N, B, ngN, jdt, tdt):
    """The same perturbed batch for both packages: (dims, jax qp, port qp)."""
    dims, qp_j = j_mass_spring(8, 3, N, ngN=ngN, dtype=jdt)
    rng = np.random.default_rng(0)
    qpb = jax_batch(qp_j, B, b=1 + 0.02 * rng.standard_normal(B))
    qpt = qp_from_numpy(dims, {f: np.asarray(getattr(qpb, f))
                               for f in QP_FIELDS}, device="cpu", dtype=tdt)
    return dims, qpb, qpt


_JAX = {}


def _solve_both(N, B, ngN, jdt, tdt, kw):
    """Structured JAX solve (compiled once per case in this process) and
    port lanes solve of one batch; also the port's plain-call counts during
    its solve: per phase for the mega kernels, and the fused sweeps'."""
    dims, qpb, qpt = _twin(N, B, ngN, jdt, tdt)
    key = (N, B, ngN, jdt, tuple(sorted(kw.items())))
    if key not in _JAX:
        cfg = jipm.IPMConfig(**kw)
        _JAX[key] = jit_fast(jax.vmap(lambda q: jipm.solve(dims, q, cfg)),
                             qpb)
    before = {k: list(v) for k, v in mk.PLAIN_CALLS.items()}
    before_sk = dict(sk.PLAIN_CALLS)
    sol_t = ipm_lanes.solve_batched_lanes(dims, qpt,
                                          IPMConfig(use_pallas=True, **kw))
    calls = {k: [a - b for a, b in zip(v, before[k])]
             for k, v in mk.PLAIN_CALLS.items()}
    calls.update({k: v - before_sk[k] for k, v in sk.PLAIN_CALLS.items()})
    return _JAX[key], sol_t, calls


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("N,ngN,fused", [
    pytest.param(5, 0, False, id="5-0"), pytest.param(16, 4, False, id="16-4"),
    pytest.param(16, 4, True, id="16-4-fused")])
def test_lanes_f64_matches_structured(monkeypatch, N, ngN, fused):
    if fused:
        monkeypatch.setenv("HPMPC_MEGA_SWEEPS", "0")
        monkeypatch.setenv("HPMPC_FUSED_SWEEPS", "1")
    sol_x, sol_t, calls = _solve_both(
        N, 8, ngN, jnp.float64, torch.float64, dict(k_max=12, mu_tol=1e-10))
    if fused:
        # the 6-kernel loop on the fused sweeps, once per iteration each;
        # no mega kernel, neither of rows 9 and 10
        assert (calls["factor_solve_folded_flat_fused"]
                == calls["solve_flat_fused"] >= 1), calls
        assert max(sum(calls["factor_solve_mega"]), sum(calls["solve_mega"]),
                   calls["factor_solve_folded_flat"],
                   calls["solve_flat"]) == 0, calls
    else:
        # both halves ran in both phases, once per iteration of each
        assert calls["factor_solve_mega"] == calls["solve_mega"]
        assert min(calls["solve_mega"]) >= 1, calls
    np.testing.assert_array_equal(_np(sol_t.kk), _np(sol_x.kk))
    np.testing.assert_array_equal(_np(sol_t.status), _np(sol_x.status))
    conv = _np(sol_t.status) == 0
    assert conv.sum() >= 7, _np(sol_t.status)   # one needs 13 at N=16
    np.testing.assert_allclose(_np(sol_t.z), _np(sol_x.z), atol=1e-8)
    np.testing.assert_allclose(_np(sol_t.pi), _np(sol_x.pi), atol=1e-7)
    np.testing.assert_allclose(_np(sol_t.stat), _np(sol_x.stat),
                               rtol=1e-5, atol=1e-10)
    assert np.all(_np(sol_t.inf_norm_res)[conv, 3] <= 1e-10)
    for f in sol_t._fields:
        assert _np(getattr(sol_t, f)).shape == _np(getattr(sol_x, f)).shape


def test_lanes_f32_phase2_ng_matches_structured():
    sol_x, sol_t, calls = _solve_both(
        4, 16, 4, jnp.float32, torch.float32,
        dict(k_max=3, mu_tol=1e-4, mu_switch=1e9))
    assert calls["factor_solve_mega"][0] == calls["solve_mega"][0] == 0
    assert calls["factor_solve_mega"][1] == calls["solve_mega"][1] >= 1
    kk_t, kk_x = _np(sol_t.kk), _np(sol_x.kk)
    same = kk_t == kk_x
    assert same.sum() >= 15, (kk_t, kk_x)
    np.testing.assert_allclose(_np(sol_t.z)[same], _np(sol_x.z)[same],
                               atol=2e-3)
