"""The dense latency engine of the PyTorch port (``models.ipm_dense``,
``ops.dense_kernel``: Queue 2 row 23) against the JAX package's, float64,
on the mass-spring chain nx=8 nu=3 at N=4 (nz=12, ngd=16: interpret mode
unrolls the kernel's nz-column loops, so its compilation grows with nz).

* ``plan_dense`` (Hd, Sel, G and the five affine maps with their
  constants) against JAX's at 1e-12;
* ``solve_dense_ref`` against JAX's ``solve_dense_ref``: equal kk and
  status, y within 1e-10 (the same formulas in another summation order;
  4e-16 apart at N=6);
* ``dense_ipm_plain`` (the kernel's plain version, what a CPU tensor runs)
  against JAX's Pallas kernel in interpret mode, cold and warm: equal kk
  and status, y within 1e-10 and mu within rtol 1e-8 (2.8e-16 apart at
  N=6);
* the warm tick (tests/test_ipm_dense.py::test_dense_warm_tick's twin),
  the flagship against the structured solver (its
  ``test_dense_ref_matches_sequential_solver``), a QP with an unboxed
  input (where the port departs from the TPU kernel, see
  ``ops/dense_kernel.py``), the envelope, and
  ``examples/dense_tick_mpc_torch.py`` in-process at a small N.

The JAX plan and the interpret-mode kernel (one compilation, the warm
start an argument) are shared by the module.

The JAX references compile without XLA's backend optimisations
(tests/test_torch_ipm_structured.py's ``jit_fast`` /
``_FAST_COMPILE``).
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from hpmpc_tpu.models import cond as jcond  # noqa: E402
from hpmpc_tpu.models import ipm as jipm  # noqa: E402
from hpmpc_tpu.models import ipm_dense as jdense  # noqa: E402
from hpmpc_tpu.utils.mass_spring import mass_spring_qp as j_mass_spring  # noqa: E402
from hpmpc_tpu_torch.models import ipm, ipm_dense  # noqa: E402
from hpmpc_tpu_torch.ops import dense_kernel as dk  # noqa: E402
from hpmpc_tpu_torch.utils.mass_spring import mass_spring_qp  # noqa: E402
from test_torch_ipm_structured import _FAST_COMPILE  # noqa: E402

torch.set_num_threads(1)
N_SMALL = 4
CFG = dict(k_max=30, mu_tol=1e-8, alpha_min=1e-8)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def plans():
    """(JAX plan, port plan, JAX bflat, port bflat) at N_SMALL, f64.  The
    JAX plan's condensing and vector pipeline run under ``jax.jit`` (the
    module functions wrapped while the plan is built: the same
    computations, compiled once instead of op by op, ~5 s instead of
    ~13 s)."""
    dims, qp_j = j_mass_spring(8, 3, N_SMALL)
    _, qp_t = mass_spring_qp(8, 3, N_SMALL, device="cpu")
    cond_jit = jax.jit(jcond.condense, static_argnums=1)
    vec_jit = jax.jit(jdense._dense_vectors, static_argnums=(0, 2, 3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdense._cond, "condense", lambda q, pl: cond_jit(q, pl))
        mp.setattr(jdense, "_dense_vectors", lambda d, q, pl, sl, bf:
                   vec_jit(d, q, pl, sl, bf))
        plan_j = jdense.plan_dense(dims, qp_j)
    return (plan_j, ipm_dense.plan_dense(dims, qp_t), qp_j.b.reshape(-1),
            qp_t.b.reshape(-1))


@pytest.fixture(scope="module")
def interpret_tick(plans):
    """JAX's kernel tick in interpret mode, compiled once; (bflat, y0) ->
    DenseTickResult (y0 zeros: cold)."""
    mp = pytest.MonkeyPatch()
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    mp.setattr(pl, "pallas_call", patched)
    cfg = jipm.IPMConfig(**CFG)
    fn = jax.jit(lambda bf, y0: jdense.solve_dense_tick(plans[0], bf, cfg,
                                                        y0=y0),
                 compiler_options=_FAST_COMPILE)
    yield fn
    mp.undo()


def test_plan_dense_matches_jax(plans):
    pj, pt = plans[:2]
    for f in pj._fields:
        a, b = getattr(pj, f), getattr(pt, f)
        if isinstance(a, int):
            assert a == b, f
            continue
        assert tuple(b.shape) == tuple(np.asarray(a).shape), f
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0, atol=1e-12,
                                   err_msg=f)


def test_solve_dense_ref_matches_jax(plans):
    pj, pt, bj, bt = plans
    rj = jax.jit(lambda bf: jdense.solve_dense_ref(
        pj, bf, jipm.IPMConfig(**CFG)), compiler_options=_FAST_COMPILE)(bj)
    rt = ipm_dense.solve_dense_ref(pt, bt, ipm.IPMConfig(**CFG))
    assert (int(rt.kk), int(rt.status)) == (int(rj.kk), int(rj.status))
    assert int(rt.status) == 0
    np.testing.assert_allclose(_np(rt.y), np.asarray(rj.y), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(_np(rt.u0), np.asarray(rj.u0), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("warm", [False, True])
def test_plain_kernel_matches_interpret(plans, interpret_tick, warm):
    """The kernel's plain version against the Pallas kernel (interpret
    mode), the warm tick seeded from the cold one's y at b * 1.01."""
    pj, pt, bj, bt = plans
    cfg = ipm.IPMConfig(**CFG)
    y0_t = None
    if warm:
        y0_t = ipm_dense.solve_dense_tick(pt, bt, cfg).y
        bj, bt = bj * 1.01, bt * 1.01
    rj = interpret_tick(bj, jnp.zeros(pt.nz) if y0_t is None
                        else jnp.asarray(_np(y0_t)))
    n0 = dk.PLAIN_CALLS
    rt = ipm_dense.solve_dense_tick(pt, bt, cfg, y0=y0_t)
    assert dk.PLAIN_CALLS == n0 + 1
    assert (int(rt.kk), int(rt.status)) == (int(rj.kk), int(rj.status))
    assert int(rt.status) == 0
    np.testing.assert_allclose(_np(rt.y), np.asarray(rj.y), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(float(rt.mu), float(rj.mu), rtol=1e-8)


def test_dense_warm_tick(plans):
    """Seeding a tick from the previous tick's y (the RTI hot loop) takes at
    most the cold tick's iterations; the kernel's plain version and the
    reference agree on the warm path (y within 1e-8: the column and the
    blocked Cholesky round apart), and the warm u0 matches a cold solve of
    the same b (2e-3, tests/test_ipm_dense.py)."""
    _, pt, _, bt = plans
    cfg = ipm.IPMConfig(k_max=10, mu_tol=1e-8)
    cold = ipm_dense.solve_dense_ref(pt, bt, cfg)
    b2 = bt * 1.01
    warm_ref = ipm_dense.solve_dense_ref(pt, b2, cfg, y0=cold.y)
    warm_k = ipm_dense.solve_dense_tick(pt, b2, cfg, y0=cold.y)
    cold2 = ipm_dense.solve_dense_ref(pt, b2, cfg)
    assert int(warm_ref.status) == 0
    assert int(warm_ref.kk) <= int(cold2.kk)
    assert int(warm_k.kk) == int(warm_ref.kk)
    np.testing.assert_allclose(_np(warm_k.y), _np(warm_ref.y), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(_np(warm_ref.u0), _np(cold2.u0), atol=2e-3)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dense_flagship_matches_structured_solver(dtype):
    """At N=30 (nz=90, ngd=120) the reference and the kernel's plain
    version converge with the structured solver's iteration count and its
    controls within 1e-3, in both dtypes (tests/test_ipm_dense.py)."""
    dims, qp = mass_spring_qp(8, 3, 30, dtype=dtype, device="cpu")
    cfg = ipm.IPMConfig(k_max=10, mu_tol=1e-4, alpha_min=1e-8)
    sol = ipm.solve(dims, type(qp)(**{f.name: getattr(qp, f.name)[None]
                                      for f in dataclasses.fields(qp)}), cfg)
    plan = ipm_dense.plan_dense(dims, qp)
    assert (plan.nz, plan.ngd) == (90, 120)
    for res in (ipm_dense.solve_dense_ref(plan, qp.b.reshape(-1), cfg),
                ipm_dense.solve_dense_tick(plan, qp.b.reshape(-1), cfg)):
        assert int(res.status) == 0 and int(res.kk) == int(sol.kk[0])
        du = (res.u0.double() - sol.z[0, 0, :dims.NU].double()).abs().max()
        assert float(du) < 1e-3


def test_dense_unboxed_input_matches_reference():
    """A QP with an unboxed input (the N=6 chain with input 2 unboxed at
    every stage): the kernel's plain version agrees with the reference
    and the structured solver (y within 1e-8 of the reference, u0 within
    1e-6 of the structured solve).  The TPU kernel pins unboxed
    coordinates to 0 (u0[2] = 0 with status 0 where the answer is -1.21);
    the port does not mask y (ROADMAP Queue 3)."""
    from hpmpc_tpu_torch import api
    from hpmpc_tpu_torch.utils.mass_spring import mass_spring_data

    d = mass_spring_data(8, 3, 6)
    for n in range(6):
        keep = [k for k, j in enumerate(d["idxb"][n]) if j != 2]
        for key in ("idxb", "lb", "ub"):
            d[key][n] = d[key][n][keep]
    dims, qp = api.pack_problem(**d, device="cpu")
    plan = ipm_dense.plan_dense(dims, qp)
    assert plan.nb == 12 and plan.nz == 18
    cfg = ipm.IPMConfig(**CFG)
    ref = ipm_dense.solve_dense_ref(plan, qp.b.reshape(-1), cfg)
    tick = ipm_dense.solve_dense_tick(plan, qp.b.reshape(-1), cfg)
    sol = ipm.solve(dims, type(qp)(**{f.name: getattr(qp, f.name)[None]
                                      for f in dataclasses.fields(qp)}), cfg)
    assert (int(tick.kk), int(tick.status)) == (int(ref.kk), 0)
    np.testing.assert_allclose(_np(tick.y), _np(ref.y), rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(tick.u0), _np(sol.z[0, 0, :3]), rtol=0,
                               atol=1e-6)
    assert float(tick.u0[2]) < -1.0


def test_dense_envelope_raises(plans):
    pt, bt = plans[1], plans[3]
    with pytest.raises(ValueError, match="nz, ngd <= 128"):
        dk.dense_ipm_call(pt._replace(nz=129), bt, ipm.IPMConfig())
    with pytest.raises(ValueError, match="nz, ngd <= 128"):
        dk.dense_ipm_call(pt._replace(ngd=129), bt, ipm.IPMConfig())


def test_example_dense_tick_mpc_torch():
    """examples/dense_tick_mpc_torch.py's closed loop, in-process on the
    CPU at N=6 and 16 ticks (its own asserts: every tick converges, the
    input bounds hold, the warm ticks take fewer iterations)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "examples"))
    try:
        import dense_tick_mpc_torch
    finally:
        sys.path.remove(str(root / "examples"))
    dense_tick_mpc_torch.main(N=6, ticks=16, device="cpu")
