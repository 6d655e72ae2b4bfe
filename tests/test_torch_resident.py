"""Resident engine of the PyTorch port vs the JAX package.

On the CPU the port's kernel wrappers run their plain versions
(``ipm_resident_ref``, ``resid_full_ref``).  Inputs are built once in
numpy (seeded) and handed to both packages.

  (a) f32 with general constraints vs the JAX resident engine itself
      (Pallas in interpret mode) at tests/test_resident.py's tolerances;
  (b)-(d) f64 vs the vmapped JAX structured ``ipm.solve`` pinned to phase
      1 (``mu_switch = mu_tol``), the golden-parity solver, at
      tests/test_ipm_lanes.py's tolerances.
"""

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
from hpmpc_tpu_torch.convert import qp_from_numpy  # noqa: E402
from hpmpc_tpu_torch.models import ipm_resident  # noqa: E402
from hpmpc_tpu_torch.models.ipm import IPMConfig  # noqa: E402
from hpmpc_tpu_torch.utils.mass_spring import mass_spring_qp  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _twin_batch(N, B, ngN, jdt, tdt, nx=8, nu=3):
    """The same perturbed batch for both packages: (dims, jax qp, port qp)."""
    _, qp_j = j_mass_spring(nx, nu, N, ngN=ngN, dtype=jdt)
    dims, _ = mass_spring_qp(nx, nu, N, ngN=ngN, device="cpu")
    qpb = jbatch.broadcast_qp(qp_j, B)
    rng = np.random.default_rng(0)
    qpb = dataclasses.replace(
        qpb, b=qpb.b * jnp.asarray(1 + 0.02 * rng.standard_normal(B),
                                   jdt)[:, None, None])
    arrays = {f.name: np.asarray(getattr(qpb, f.name))
              for f in dataclasses.fields(qpb)}
    return dims, qpb, qp_from_numpy(dims, arrays, device="cpu", dtype=tdt)


def _structured(dims, qpb, k_max, mu_tol):
    cfg = jipm.IPMConfig(k_max=k_max, mu_tol=mu_tol, mu_switch=mu_tol)
    return jax.jit(jax.vmap(lambda q: jipm.solve(dims, q, cfg)))(qpb)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_resident_f32_ng_matches_jax_resident(interpret_pallas):
    """(a): interpret-mode JAX resident kernel vs the port, f32, with the
    terminal equality block (ngN=2), on the 2-mass chain (nx=4, nu=2,
    N=6, feasible): the interpret-mode compilation of the resident kernel
    grows with the unrolled stage width far more than with the horizon,
    and the code paths are the same at any width."""
    import os

    from hpmpc_tpu.models import ipm_resident as j_resident

    dims, qpb, qpt = _twin_batch(6, 1024, 2, jnp.float32, torch.float32,
                                 nx=4, nu=2)
    cfg_j = jipm.IPMConfig(k_max=3, mu_tol=1e-4, use_pallas=True)
    assert os.environ.get("JAX_PLATFORMS") == "cpu"
    sol_j = jax.jit(
        lambda q: j_resident.solve_batched_resident(dims, q, cfg_j))(qpb)
    cfg_t = IPMConfig(k_max=3, mu_tol=1e-4, use_pallas=True)
    sol_t = ipm_resident.solve_batched_resident(dims, qpt, cfg_t)

    np.testing.assert_array_equal(_np(sol_t.kk), _np(sol_j.kk))
    np.testing.assert_array_equal(_np(sol_t.status), _np(sol_j.status))
    np.testing.assert_allclose(_np(sol_t.z), _np(sol_j.z), atol=2e-3)
    np.testing.assert_allclose(_np(sol_t.pi), _np(sol_j.pi), atol=5e-3)
    for f in ("lam_b", "t_b", "lam_g", "t_g"):
        np.testing.assert_allclose(_np(getattr(sol_t, f)),
                                   _np(getattr(sol_j, f)),
                                   rtol=5e-3, atol=5e-3, err_msg=f)
    np.testing.assert_allclose(_np(sol_t.stat), _np(sol_j.stat),
                               rtol=2e-2, atol=2e-4)
    np.testing.assert_allclose(_np(sol_t.inf_norm_res),
                               _np(sol_j.inf_norm_res), rtol=5e-2, atol=5e-3)


def test_resident_f64_box_matches_structured():
    """(b): deep f64 box-only solve, iterate-for-iterate."""
    dims, qpb, qpt = _twin_batch(5, 32, 0, jnp.float64, torch.float64)
    sol_x = _structured(dims, qpb, 12, 1e-10)
    cfg = IPMConfig(k_max=12, mu_tol=1e-10, mu_switch=1e-10)
    sol_t = ipm_resident.solve_batched_resident(dims, qpt, cfg)
    np.testing.assert_array_equal(_np(sol_t.kk), _np(sol_x.kk))
    np.testing.assert_array_equal(_np(sol_t.status), _np(sol_x.status))
    np.testing.assert_allclose(_np(sol_t.z), _np(sol_x.z), atol=1e-8)
    np.testing.assert_allclose(_np(sol_t.pi), _np(sol_x.pi), atol=1e-7)
    np.testing.assert_allclose(_np(sol_t.t_b), _np(sol_x.t_b), atol=1e-8)
    # phase 1 run to mu ~ 1e-11 recovers the active-set multipliers from
    # slacks of ~1e-11: they carry ~1e-4 relative roundoff in any summation
    # order (so does |rq|, which they dominate); the duality measure and
    # the primal/dynamics/slack residuals stay tight
    np.testing.assert_allclose(_np(sol_t.lam_b), _np(sol_x.lam_b),
                               rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose(_np(sol_t.inf_norm_res)[:, 1:],
                               _np(sol_x.inf_norm_res)[:, 1:],
                               rtol=1e-3, atol=1e-9)
    assert np.all(_np(sol_t.inf_norm_res)[:, 0] < 1e-4)


def test_resident_f64_ng_shallow_matches_structured():
    """(c): f64 with the terminal equality block, shallow budget (the
    small-N ngN configs are infeasible when run deep)."""
    dims, qpb, qpt = _twin_batch(3, 32, 4, jnp.float64, torch.float64)
    sol_x = _structured(dims, qpb, 4, 1e-10)
    cfg = IPMConfig(k_max=4, mu_tol=1e-10, mu_switch=1e-10)
    sol_t = ipm_resident.solve_batched_resident(dims, qpt, cfg)
    np.testing.assert_array_equal(_np(sol_t.kk), _np(sol_x.kk))
    np.testing.assert_allclose(_np(sol_t.stat), _np(sol_x.stat),
                               rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(_np(sol_t.z), _np(sol_x.z), atol=1e-7)
    np.testing.assert_allclose(_np(sol_t.lam_g), _np(sol_x.lam_g),
                               rtol=1e-6, atol=1e-7)


def test_resident_f64_early_stop_freeze():
    """(d): loose mu_tol, some instances stop before k_max: per-instance
    liveness reproduces the structured solver's while-loop exit."""
    dims, qpb, qpt = _twin_batch(3, 64, 0, jnp.float64, torch.float64)
    sol_x = _structured(dims, qpb, 8, 5e-3)
    cfg = IPMConfig(k_max=8, mu_tol=5e-3, mu_switch=5e-3)
    sol_t = ipm_resident.solve_batched_resident(dims, qpt, cfg)
    kk_t, kk_x = _np(sol_t.kk), _np(sol_x.kk)
    assert np.mean(kk_t == kk_x) >= 0.99, (kk_t[:8], kk_x[:8])
    assert kk_t.max() < 8, "expected early convergence in this test"
    same = kk_t == kk_x
    np.testing.assert_allclose(_np(sol_t.z)[same], _np(sol_x.z)[same],
                               atol=1e-8)
    np.testing.assert_array_equal(_np(sol_t.status)[same],
                                  _np(sol_x.status)[same])
    # rows of iterations after the exit stay zero (stat contract)
    np.testing.assert_allclose(_np(sol_t.stat)[same], _np(sol_x.stat)[same],
                               rtol=1e-6, atol=1e-10)
