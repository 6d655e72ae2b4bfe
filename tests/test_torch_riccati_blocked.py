"""The blocked batched Riccati of the PyTorch port's large-NZ band
(``hpmpc_tpu_torch.models.riccati_blocked``) vs the JAX package's
(``hpmpc_tpu.models.riccati_blocked``, its Pallas Cholesky in interpret
mode), the band end to end through the structured solvers, and the
dispatch rules' size envelope.

  * ``factor_solve``, ``factor_solve_folded`` and ``solve`` with and
    without Pb at (NX, NU) in {(4, 2), (7, 3)}, B=8, N=5, float64: z, pi, L
    and Pb within 1e-9 (tests/test_riccati_blocked.py's tolerance); the
    NX=96 NU=4 B=2 N=3 x0 recovery (two triangular solves, where JAX takes
    the explicit inverse of Lxx_0) against ``jax.vmap(riccati.
    factor_solve)`` (no Pallas) within 1e-8, as there.
  * The band end to end: the port's envelope (``stage_kernel.
    engine_fits``) forced shut, as JAX's
    ``test_custom_vmap_dispatches_oversized_to_blocked`` forces its own, so
    ``ipm.solve(use_pallas=True)`` on ``mass_spring_qp(4, 2, 16)`` (float64,
    B=4, b scaled by [1, 0.5, 0.7, 0.9]) runs the blocked band on the plain
    Cholesky; against ``jax.vmap(ipm.solve)`` (no Pallas) with
    tests/test_torch_ipm_structured.py's tolerances (equal kk and status,
    stat rtol 1e-6, z within 1e-8).  The same for ``ipm_soft.solve``
    against ``jax.vmap(ipm_soft.solve)`` at k_max 6 on
    ``mass_spring_soft_qp(8, 3, 5, Z=10)`` (tests/test_torch_ipm_soft.py's
    batch and tolerances).  ``batch_chol.PLAIN_CALLS["cholesky"]`` shows
    the band ran, the per-thread kernels' counters that it did not.
  * ``select_engine`` / ``select_soft_engine`` pick ``"structured"`` /
    ``"soft_structured"`` at nx=64 nu=8 (NZ=72) and the engines they picked
    before the envelope at the sizes the port drives.

The JAX references compile once per module (``jit_fast``: no XLA backend
optimisations), at NZ <= 10 in interpret mode.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from hpmpc_tpu.models import ipm as jipm  # noqa: E402
from hpmpc_tpu.models import ipm_soft as jsoft  # noqa: E402
from hpmpc_tpu.models import riccati as jric  # noqa: E402
from hpmpc_tpu.models import riccati_blocked as jrb  # noqa: E402
from hpmpc_tpu.utils.mass_spring import mass_spring_qp as j_mass_spring  # noqa: E402
from hpmpc_tpu.utils.mass_spring import mass_spring_soft_qp as j_soft_qp  # noqa: E402
from hpmpc_tpu_torch.convert import (  # noqa: E402
    QP_FIELDS, qp_from_numpy, soft_from_numpy)
from hpmpc_tpu_torch.models import ipm, ipm_soft  # noqa: E402
from hpmpc_tpu_torch.models import riccati_blocked as rb  # noqa: E402
from hpmpc_tpu_torch.ops import batch_chol as bc  # noqa: E402
from hpmpc_tpu_torch.ops import stage_kernel as sk  # noqa: E402
from hpmpc_tpu_torch.parallel import batch as tbatch  # noqa: E402
from hpmpc_tpu_torch.utils.mass_spring import (  # noqa: E402
    mass_spring_qp, mass_spring_soft_qp)
from test_torch_ipm_structured import _compare, jit_fast  # noqa: E402
from test_torch_ipm_soft import _compare as _compare_soft  # noqa: E402

torch.set_num_threads(1)

B, N = 8, 5


@pytest.fixture(scope="module")
def interpret_pallas():
    with pytest.MonkeyPatch.context() as mp:
        orig = pl.pallas_call

        def patched(*a, **k):
            k["interpret"] = True
            return orig(*a, **k)

        mp.setattr(pl, "pallas_call", patched)
        yield


def _chain_data(rng, B_, N_, NX, NU):
    NZ = NX + NU
    A = rng.standard_normal((B_, N_ + 1, NZ, NZ))
    H = A @ A.transpose(0, 1, 3, 2) + NZ * np.eye(NZ)
    g = rng.standard_normal((B_, N_ + 1, NZ))
    F = 0.3 * rng.standard_normal((B_, N_, NZ, NX))
    b = rng.standard_normal((B_, N_, NX))
    return H, g, F, b


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.fixture(scope="module")
def ref(interpret_pallas):
    """Per (NX, NU): the numpy data and JAX's factor_solve, folded
    factor_solve and solve with and without Pb, compiled once each."""
    out = {}
    for NX, NU in ((4, 2), (7, 3)):
        rng = np.random.default_rng(NX)
        NZ, NG = NX + NU, 3
        H, g, F, b = _chain_data(rng, B, N, NX, NU)
        dvec = np.abs(rng.standard_normal((B, N + 1, NZ))) + 0.1
        C = rng.standard_normal((B, N + 1, NG, NZ))
        Qxg = np.abs(rng.standard_normal((B, N + 1, NG)))
        Qxg[:, 1] = Qxg[:, 3] = 0.0            # two inactive stages
        g2 = rng.standard_normal(g.shape)

        def jax_all(H, dvec, C, Qxg, g, F, b, g2):
            sol, L, _, _, Pb = jrb.factor_solve(H, g, F, b, NU)
            solf, Lf, _, _, Pbf = jrb.factor_solve_folded(H, dvec, C, Qxg, g,
                                                          F, b, NU)
            s_pb, _ = jrb.solve(L, g2, F, b, NU, Pb=Pb)
            s_nopb, Pb2 = jrb.solve(L, g2, F, b, NU)
            return (sol.z, sol.pi, L, Pb, solf.z, solf.pi, Lf, Pbf,
                    s_pb.z, s_pb.pi, s_nopb.z, s_nopb.pi, Pb2)

        data = (H, dvec, C, Qxg, g, F, b, g2)
        out[(NX, NU)] = (data, [np.asarray(x)
                                for x in jit_fast(jax_all, *data)])
    return out


@pytest.mark.parametrize("NX,NU", [(4, 2), (7, 3)])
def test_factor_solve_matches_jax(ref, NX, NU):
    (H, dvec, C, Qxg, g, F, b, g2), j = ref[(NX, NU)]
    Ht, dt, Ct, Qt, gt, Ft, bt, g2t = _t(H, dvec, C, Qxg, g, F, b, g2)
    n0 = bc.PLAIN_CALLS["cholesky"]
    sol, L, _, _, Pb = rb.factor_solve(Ht, gt, Ft, bt, NU)
    assert bc.PLAIN_CALLS["cholesky"] - n0 == N + 1
    solf, Lf, _, _, Pbf = rb.factor_solve_folded(Ht, dt, Ct, Qt, gt, Ft, bt,
                                                 NU)
    got = (sol.z, sol.pi, L, Pb, solf.z, solf.pi, Lf, Pbf)
    for name, a, e in zip(("z", "pi", "L", "Pb", "folded z", "folded pi",
                           "folded L", "folded Pb"), got, j[:8]):
        np.testing.assert_allclose(a.numpy(), e, rtol=1e-9, atol=1e-9,
                                   err_msg=name)


@pytest.mark.parametrize("NX,NU", [(4, 2), (7, 3)])
def test_solve_matches_jax(ref, NX, NU):
    (H, _, _, _, g, F, b, g2), j = ref[(NX, NU)]
    Ht, gt, Ft, bt, g2t = _t(H, g, F, b, g2)
    _, L, _, _, Pb = rb.factor_solve(Ht, gt, Ft, bt, NU)
    s_pb, _ = rb.solve(L, g2t, Ft, bt, NU, Pb=Pb)
    s_nopb, Pb2 = rb.solve(L, g2t, Ft, bt, NU)
    for name, a, e in zip(("z (Pb)", "pi (Pb)", "z", "pi", "Pb"),
                          (s_pb.z, s_pb.pi, s_nopb.z, s_nopb.pi, Pb2),
                          j[8:]):
        np.testing.assert_allclose(a.numpy(), e, rtol=1e-9, atol=1e-9,
                                   err_msg=name)


def test_large_nx_x0_matches_jax():
    """The x0 recovery at NX=96 (two triangular solves; JAX takes the
    explicit inverse of Lxx_0 from there) against the vmapped structured
    solver, as JAX's own test."""
    B_, N_, NX, NU = 2, 3, 96, 4
    H, g, F, b = _chain_data(np.random.default_rng(1), B_, N_, NX, NU)
    z_j, pi_j = jit_fast(lambda *a: (lambda s: (s[0].z, s[0].pi))(jax.vmap(
        lambda *x: jric.factor_solve(*x, NU))(*a)), H, g, F, b)
    sol, *_ = rb.factor_solve(*_t(H, g, F, b), NU)
    np.testing.assert_allclose(sol.z.numpy(), np.asarray(z_j),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(sol.pi.numpy(), np.asarray(pi_j),
                               rtol=1e-8, atol=1e-8)


# ---- the band end to end -------------------------------------------------

SCALES = [1.0, 0.5, 0.7, 0.9]
SOFT_SCALES = [1.0, 0.3, 0.05, 1.5]
SOFT_CFG = dict(k_max=6, mu0=100.0, mu_tol=2e-6)
_PER_THREAD = ("factor_solve_folded", "solve_batched")


@pytest.fixture(scope="module")
def band_refs():
    """The hard and soft batches (port side) and their JAX solves."""
    dims, qp = j_mass_spring(4, 2, 16)
    qpb = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (len(SCALES),) + x.shape), qp)
    qpb = dataclasses.replace(qpb, b=qpb.b * jnp.asarray(SCALES)[:, None,
                                                                   None])
    cfg = jipm.IPMConfig()
    sol_h = jit_fast(jax.vmap(lambda q: jipm.solve(dims, q, cfg)), qpb)
    qpt = qp_from_numpy(dims, {f: np.asarray(getattr(qpb, f))
                               for f in QP_FIELDS}, device="cpu")

    dims_s, qp_s, soft = j_soft_qp(8, 3, 5, Z=10.0, dtype=jnp.float64)
    bcast = lambda x: jnp.broadcast_to(x, (len(SOFT_SCALES),) + x.shape)  # noqa: E731
    qps = jax.tree_util.tree_map(bcast, qp_s)
    sb = jax.tree_util.tree_map(bcast, soft)
    qps = dataclasses.replace(qps, b=qps.b * jnp.asarray(SOFT_SCALES)[
        :, None, None])
    cfg_s = jipm.IPMConfig(**SOFT_CFG)
    sol_s = jit_fast(jax.vmap(lambda q, s: jsoft.solve(dims_s, q, s, cfg_s)),
                     qps, sb)
    qpst = qp_from_numpy(dims_s, {f: np.asarray(getattr(qps, f))
                                  for f in QP_FIELDS}, device="cpu")
    st = soft_from_numpy({f: np.asarray(getattr(sb, f)) for f in sb._fields},
                         device="cpu")
    return (dims, qpt, sol_h), (dims_s, qpst, st, sol_s)


@pytest.fixture
def band_forced(monkeypatch):
    """The port's envelope shut: every size takes the blocked band."""
    monkeypatch.setattr(sk, "engine_fits", lambda *a, **k: False)


def _counts():
    return (bc.PLAIN_CALLS["cholesky"],
            {k: sk.PLAIN_CALLS[k] for k in _PER_THREAD})


def test_band_structured_solve_matches_jax(band_refs, band_forced):
    dims, qpt, sol_j = band_refs[0]
    (c0, p0) = _counts()
    sol_t = ipm.solve(dims, qpt, ipm.IPMConfig(use_pallas=True))
    (c1, p1) = _counts()
    assert c1 > c0 and p1 == p0, (c1 - c0, p0, p1)
    _compare(sol_t, sol_j)


def test_band_carry_is_batch_first(band_refs, band_forced):
    dims, qpt, _ = band_refs[0]
    cfg = ipm.IPMConfig(use_pallas=True, k_max=3)
    sol_b, carry_b = ipm.solve(dims, qpt, cfg, return_carry=True)
    sol_p, carry_p = ipm.solve(dims, qpt, dataclasses.replace(
        cfg, use_pallas=False), return_carry=True)
    for f, a, e in zip(carry_b._fields, carry_b, carry_p):
        assert a.shape == e.shape, f
        np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=0,
                                   atol=1e-8 * max(1.0, float(e.abs().max())),
                                   err_msg=f)


def test_band_soft_solve_matches_jax(band_refs, band_forced):
    dims, qpt, st, sol_j = band_refs[1]
    (c0, p0) = _counts()
    sol_t = ipm_soft.solve(dims, qpt, st, ipm.IPMConfig(use_pallas=True,
                                                        **SOFT_CFG))
    (c1, p1) = _counts()
    assert c1 > c0 and p1 == p0, (c1 - c0, p0, p1)
    _compare_soft(sol_t, sol_j)


# ---- the dispatch rules' envelope ----------------------------------------

PALLAS_CFG = dict(k_max=8, mu_tol=0.0, alpha_min=1e-8, use_pallas=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rules_send_nz72_to_structured(dtype):
    dims, _ = mass_spring_qp(64, 8, 30, device="cpu")
    assert not sk.engine_fits(dims.NX, dims.NU)
    for kw in (PALLAS_CFG, dict(PALLAS_CFG, mu_switch=0.0),
               dict(PALLAS_CFG, iter_ref=1, iter_ref_mu_thr=1e-3)):
        assert tbatch.select_engine(dims, ipm.IPMConfig(**kw), 1024,
                                    dtype) == "structured", kw
    dims_s, _, soft = mass_spring_soft_qp(64, 8, 30, device="cpu")
    assert tbatch.select_soft_engine(
        dims_s, ipm.IPMConfig(**PALLAS_CFG), dtype, soft.ns_mask.shape[-1],
        soft.idxbs.numpy()) == "soft_structured"


def test_rules_keep_driven_sizes(monkeypatch):
    """The flagship (NZ=11), the chain nx=4 nu=2 (NZ=6) and the soft
    problem pick the engines they picked before the envelope."""
    for k in ("HPMPC_RESIDENT", "HPMPC_LANES_LOOP", "HPMPC_MEGA_SWEEPS"):
        monkeypatch.delenv(k, raising=False)
    f32, f64 = torch.float32, torch.float64
    for nx, nu, ngN in ((8, 3, 8), (4, 2, 0)):
        dims, _ = mass_spring_qp(nx, nu, 30, ngN=ngN, device="cpu")
        assert sk.engine_fits(dims.NX, dims.NU)
        rule = lambda kw, dt: tbatch.select_engine(  # noqa: E731
            dims, ipm.IPMConfig(**kw), 4096, dt)
        assert rule(dict(PALLAS_CFG, mu_switch=0.0), f32) == "resident"
        assert rule(dict(use_pallas=True), f32) == "lanes"
        assert rule(dict(use_pallas=True), f64) == "flat"
        assert rule(dict(PALLAS_CFG, iter_ref=1, iter_ref_mu_thr=1e-3),
                    f32) == "two_stage_resident"
        assert rule(dict(PALLAS_CFG, iter_ref=1), f32) == "flat"
        assert rule({}, f32) == "structured"
    dims_s, _, soft = mass_spring_soft_qp(8, 3, 30, device="cpu")
    ns, idxbs = soft.ns_mask.shape[-1], soft.idxbs.numpy()
    cfg = ipm.IPMConfig(k_max=8, mu0=100.0, mu_tol=0.0, use_pallas=True)
    assert tbatch.select_soft_engine(dims_s, cfg, f32, ns, idxbs) == \
        "soft_lanes"
    assert tbatch.select_soft_engine(dims_s, cfg, f64, ns, idxbs) == \
        "soft_flat"
