"""The soft path of the PyTorch port as a whole: the soft lanes engine
(``models/ipm_soft_lanes.solve_batched_soft_lanes``) vs the JAX package's
structured soft solver ``ipm_soft.solve`` (vmapped, plain XLA, no
Pallas), ``parallel.batch.solve_batched_soft``'s dispatch, the soft
mass-spring fixture and the soft KKT residuals.  The same batch goes to
both packages through ``convert.qp_from_numpy`` / ``soft_from_numpy``; on
the CPU the port's kernel wrappers run their plain versions, whose call
counters show which route ran.

  (a) float64, B=16, N=5 (the reference's soft problem,
      ``mass_spring_soft_qp(8, 3, 5, Z=10)``, ``g`` scaled by 1 + 0.02
      N(0,1)), both routes (mega, ``HPMPC_MEGA_SWEEPS=0``) and both
      ``exact_mehrotra_soft`` values: kk and status equal, z, lam_s and t_s
      within 1e-8.  The budget is ``k_max=6`` (mu ~1e-7): deeper, the
      multipliers of the active soft bounds are recovered from slacks of
      ~1e-10 and carry ~1e-4 relative roundoff in any summation order
      (measured: lam_s 2e-7 apart at ``k_max=7``, 4e-3 at convergence,
      while z and t_s stay within 1e-12).  The two routes agree to 1e-12
      (on the CPU the mega kernels' plain versions are the 6-kernel
      loop's plain passes composed).
  (b) the same with general-constraint rows on stages 2 and N
      (tests/test_ipm_soft_lanes.py's ng problem), also lam_g within 1e-8.
  (c) float32, ``k_max=4``: kk on more than 99% of the instances, z within
      rtol 1e-3 / atol 2e-3 where kk agrees
      (tests/test_ipm_soft_lanes.py:102-107).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hpmpc_tpu.models import ipm as jipm  # noqa: E402
from hpmpc_tpu.models import ipm_soft as jsoft  # noqa: E402
from hpmpc_tpu.ocp import OCPDims as JDims  # noqa: E402
from hpmpc_tpu.utils.mass_spring import mass_spring_soft_qp as j_soft_qp  # noqa: E402
from hpmpc_tpu_torch.convert import (  # noqa: E402
    QP_FIELDS, qp_from_numpy, soft_from_numpy)
from hpmpc_tpu_torch.models import ipm_soft, ipm_soft_lanes  # noqa: E402
from hpmpc_tpu_torch.models.ipm import IPMConfig  # noqa: E402
from hpmpc_tpu_torch.ops import mega_kernel as mk  # noqa: E402
from hpmpc_tpu_torch.ops import stage_kernel as sk  # noqa: E402
from hpmpc_tpu_torch.ops import step_kernel as stk  # noqa: E402
from hpmpc_tpu_torch.parallel import batch as tbatch  # noqa: E402
from hpmpc_tpu_torch.utils.mass_spring import mass_spring_soft_qp  # noqa: E402

torch.set_num_threads(1)

B, N = 16, 5
F64 = dict(k_max=6, mu0=100.0, mu_tol=1e-10)
F32 = dict(k_max=4, mu0=100.0, mu_tol=1e-5)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _with_ng(dims0, qp):
    """tests/test_ipm_soft_lanes.py's ng rows: one general constraint on
    stages 2 and N, 0.25 times the state sum, in [-1, 1]."""
    ng = [0] * (N + 1)
    ng[2] = ng[N] = 1
    dims = JDims.create(N, dims0.nx, dims0.nu, dims0.nb, ng, idxb=dims0.idxb)
    C = np.zeros((N + 1, dims.NG, dims.NZ))
    d_lg, d_ug = np.zeros((N + 1, dims.NG)), np.zeros((N + 1, dims.NG))
    for n in (2, N):
        C[n, 0, dims.NU:dims.NU + dims0.nx[n]] = 0.25
        d_lg[n, 0], d_ug[n, 0] = -1.0, 1.0
    dt = qp.dtype
    return dims, dataclasses.replace(
        qp, C=jnp.asarray(C, dt), d_lg=jnp.asarray(d_lg, dt),
        d_ug=jnp.asarray(d_ug, dt), ng_mask=jnp.asarray(dims.ng_mask(), dt))


def _twin(jdt, tdt, ng=False, seed=5):
    """The same perturbed soft batch for both packages: (dims, jax qp, jax
    soft, port qp, port soft, idxbs)."""
    dims, qp, soft = j_soft_qp(8, 3, N, Z=10.0, dtype=jdt)
    if ng:
        dims, qp = _with_ng(dims, qp)
    bc = lambda x: jnp.broadcast_to(x, (B,) + x.shape)  # noqa: E731
    qpb = jax.tree_util.tree_map(bc, qp)
    sb = jax.tree_util.tree_map(bc, soft)
    rng = np.random.default_rng(seed)
    qpb = dataclasses.replace(qpb, g=qpb.g * jnp.asarray(
        1 + 0.02 * rng.standard_normal(B), jdt)[:, None, None])
    qpt = qp_from_numpy(dims, {f: np.asarray(getattr(qpb, f))
                               for f in QP_FIELDS}, device="cpu", dtype=tdt)
    st = soft_from_numpy({f: np.asarray(getattr(sb, f)) for f in sb._fields},
                         device="cpu", dtype=tdt)
    return dims, qpb, sb, qpt, st, np.asarray(soft.idxbs)


def _structured(dims, qpb, sb, kw, exact=True):
    cfg = jipm.IPMConfig(**kw)
    return jax.jit(jax.vmap(lambda q, s: jsoft.solve(
        dims, q, s, cfg, exact_mehrotra_soft=exact)))(qpb, sb)


@pytest.fixture(scope="module")
def f64_case():
    """The f64 batch (without and with ng rows) and the structured JAX
    solves: (exact, ng) -> (twin, solution)."""
    out = {}
    for exact, ng in ((True, False), (False, False), (True, True)):
        tw = _twin(jnp.float64, torch.float64, ng=ng)
        out[exact, ng] = (tw, _structured(*tw[:3], F64, exact))
    return out


def _port(monkeypatch, tw, kw, exact, mega):
    """The port's soft lanes solve on route ``mega``; also checks that the
    route's plain versions ran and the other route's did not."""
    dims, _, _, qpt, st, idxbs = tw
    monkeypatch.setenv("HPMPC_MEGA_SWEEPS", "1" if mega else "0")
    n_mega = dict(mk.SOFT_PLAIN_CALLS)
    n_step = dict(stk.SOFT_PLAIN_CALLS)
    n_solve = sk.PLAIN_CALLS["solve_flat"]
    sol = ipm_soft_lanes.solve_batched_soft_lanes(
        dims, qpt, st, IPMConfig(use_pallas=True, **kw), idxbs,
        exact_mehrotra_soft=exact)
    ran_mega = all(mk.SOFT_PLAIN_CALLS[k] > n_mega[k] for k in n_mega)
    ran_six = (all(stk.SOFT_PLAIN_CALLS[k] > n_step[k] for k in n_step)
               and sk.PLAIN_CALLS["solve_flat"] > n_solve)
    assert (ran_mega, ran_six) == ((True, False) if mega else (False, True))
    return sol


def _check_f64(sol_t, sol_x, fields=("z", "lam_s", "t_s")):
    np.testing.assert_array_equal(_np(sol_t.kk), _np(sol_x.kk))
    np.testing.assert_array_equal(_np(sol_t.status), _np(sol_x.status))
    for f in fields:
        np.testing.assert_allclose(_np(getattr(sol_t, f)),
                                   _np(getattr(sol_x, f)), rtol=0, atol=1e-8,
                                   err_msg=f)
    for f in sol_t._fields:
        assert _np(getattr(sol_t, f)).shape == _np(getattr(sol_x, f)).shape, f


@pytest.mark.parametrize("mega", [True, False])
@pytest.mark.parametrize("exact", [True, False])
def test_soft_lanes_f64_matches_structured(monkeypatch, f64_case, exact,
                                           mega):
    tw, sol_x = f64_case[exact, False]
    sol_t = _port(monkeypatch, tw, F64, exact, mega)
    _check_f64(sol_t, sol_x)
    assert int(_np(sol_t.kk).min()) == F64["k_max"]
    np.testing.assert_allclose(_np(sol_t.stat), _np(sol_x.stat), rtol=1e-8,
                               atol=1e-12)


@pytest.mark.parametrize("exact", [True, False])
def test_soft_mega_route_equals_six_kernel_route(monkeypatch, f64_case,
                                                 exact):
    tw, _ = f64_case[exact, False]
    a = _port(monkeypatch, tw, F64, exact, True)
    b = _port(monkeypatch, tw, F64, exact, False)
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert float((x.double() - y.double()).abs().max()) <= 1e-12, f


@pytest.mark.parametrize("mega", [True, False])
def test_soft_lanes_ng_matches_structured(monkeypatch, f64_case, mega):
    tw, sol_x = f64_case[True, True]
    sol_t = _port(monkeypatch, tw, F64, True, mega)
    _check_f64(sol_t, sol_x, ("z", "lam_s", "t_s", "lam_g", "t_g"))


def test_soft_lanes_f32_matches_structured(monkeypatch):
    tw = _twin(jnp.float32, torch.float32, seed=6)
    sol_x = _structured(*tw[:3], F32)
    sol_t = _port(monkeypatch, tw, F32, True, True)
    kk_t, kk_x = _np(sol_t.kk), _np(sol_x.kk)
    assert np.mean(kk_t == kk_x) > 0.99, (kk_t, kk_x)
    same = kk_t == kk_x
    np.testing.assert_allclose(_np(sol_t.z)[same], _np(sol_x.z)[same],
                               rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_mass_spring_soft_bit_for_bit(dt):
    dims_j, qp_j, soft_j = j_soft_qp(8, 3, 7, Z=10.0,
                                     dtype=getattr(jnp, dt))
    dims_t, qp_t, soft_t = mass_spring_soft_qp(
        8, 3, 7, Z=10.0, dtype=getattr(torch, dt), device="cpu")
    assert dataclasses.asdict(dims_t) == dataclasses.asdict(dims_j)
    for f in QP_FIELDS:
        x, y = _np(getattr(qp_t, f)), np.asarray(getattr(qp_j, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in soft_j._fields:
        x, y = _np(getattr(soft_t, f)), np.asarray(getattr(soft_j, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_compute_residuals_matches_jax(f64_case):
    """The port's batched soft oracle on the JAX solution (ng rows on)
    against the JAX package's, vmapped: within 1e-12."""
    (dims, qpb, sb, qpt, st, _), sol_x = f64_case[True, True]
    res_j = jax.jit(jax.vmap(lambda q, s, x: jsoft.compute_residuals(
        dims, q, s, x)))(qpb, sb, sol_x)
    sol = ipm_soft.SoftSolution(*[
        torch.as_tensor(np.array(x)) for x in sol_x])
    res_t = ipm_soft.compute_residuals(dims, qpt, st, sol)
    for f in res_t._fields:
        np.testing.assert_allclose(_np(getattr(res_t, f)),
                                   np.asarray(getattr(res_j, f)), rtol=0,
                                   atol=1e-12, err_msg=f)
    assert float(res_t.mu.max()) < 1e-3


@pytest.mark.parametrize("case", [
    dict(),                                                   # -> soft_lanes
    dict(env={"HPMPC_RESIDENT": "1"}, match="row 1s"),
    dict(env={"HPMPC_LANES_LOOP": "0"}, match="#7"),
    dict(dtype=torch.float64, match="#7"),
    dict(use_pallas=False, match="#10"),
])
def test_solve_batched_soft_dispatch(monkeypatch, case):
    for k in ("HPMPC_RESIDENT", "HPMPC_LANES_LOOP", "HPMPC_MEGA_SWEEPS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in case.get("env", {}).items():
        monkeypatch.setenv(k, v)
    dims, qp, soft = mass_spring_soft_qp(
        8, 3, 3, Z=10.0, dtype=case.get("dtype", torch.float32),
        device="cpu")
    qpb, sb = tbatch.broadcast_qp(qp, 4), tbatch.broadcast_soft(soft, 4)
    cfg = IPMConfig(k_max=1, mu0=100.0,
                    use_pallas=case.get("use_pallas", True))
    idxbs = soft.idxbs.numpy()
    if "match" in case:
        with pytest.raises(NotImplementedError, match=case["match"]):
            tbatch.solve_batched_soft(dims, qpb, sb, cfg, idxbs=idxbs)
        return
    assert tbatch.select_soft_engine(dims, cfg, torch.float32, 8,
                                     idxbs) == "soft_lanes"
    n0 = dict(mk.SOFT_PLAIN_CALLS)
    sol = tbatch.solve_batched_soft(dims, qpb, sb, cfg, idxbs=idxbs)
    assert all(mk.SOFT_PLAIN_CALLS[k] == n0[k] + 1 for k in n0)
    assert int(sol.kk.max()) == 1
    assert all(bool(torch.isfinite(x).all()) for x in sol
               if x.is_floating_point())
