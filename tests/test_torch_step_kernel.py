"""Exit-residual kernel of the PyTorch port vs the JAX package.

``resid_full`` (on the CPU: its plain version ``resid_full_ref``) against
the JAX ``resid_full_flat`` Pallas kernel run in interpret mode, float64,
on the 2-mass chain (nx=4, nu=2; its interpret-mode compilation grows with
the unrolled stage width), N=3 (4 grid steps), on a mid-solve iterate —
the port's own resident solve stopped after two iterations.  Plus the per-stage helpers of
``ops/stage_math.py`` against numpy.

The JAX references compile without XLA's backend optimisations
(tests/test_torch_ipm_structured.py's ``jit_fast`` /
``_FAST_COMPILE``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from hpmpc_tpu.models import ipm as jipm  # noqa: E402
from hpmpc_tpu.models import ipm_lanes as jl  # noqa: E402
from hpmpc_tpu.ops import stage_kernel as jsk  # noqa: E402
from hpmpc_tpu.ops import step_kernel as jstk  # noqa: E402
from hpmpc_tpu.utils.mass_spring import mass_spring_qp as j_mass_spring  # noqa: E402
from hpmpc_tpu_torch.convert import QP_FIELDS, qp_from_numpy  # noqa: E402
from hpmpc_tpu_torch.models import ipm_resident  # noqa: E402
from hpmpc_tpu_torch.models.ipm import IPMConfig  # noqa: E402
from hpmpc_tpu_torch.ops import stage_math as sm  # noqa: E402
from hpmpc_tpu_torch.ops import step_kernel as stk  # noqa: E402
from test_torch_ipm_structured import jax_batch, jit_fast  # noqa: E402

torch.set_num_threads(1)

B = 1024


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _lanes(x):
    a = x.numpy()
    a = a.reshape(a.shape[:-1] + (B // jsk.BI, jsk.SUBS, jsk.LANES))
    return np.moveaxis(a, -3, 0)


def test_resid_full_matches_jax(interpret_pallas):
    dims, qp_j = j_mass_spring(4, 2, 3, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    qpb = jax_batch(qp_j, B, b=1 + 0.02 * rng.standard_normal(B))
    qp_t = qp_from_numpy(dims, {f: np.asarray(getattr(qpb, f))
                                for f in QP_FIELDS}, device="cpu")
    # mid-solve iterate: two resident iterations from the cold start
    cfg = IPMConfig(k_max=2, mu_tol=0.0, mu_switch=0.0)
    args, kw, cm, _ = ipm_resident.resident_inputs(dims, qp_t, cfg)
    z, pi, lam, t = ipm_resident.rk.ipm_resident(*args, **kw)[:4]
    r_args, r_kw = ipm_resident.exit_resid_inputs(dims, qp_t, cm, z, pi,
                                                  lam, t)
    out_t = stk.resid_full(*r_args, **r_kw)

    cj = jl.make_lanes_common(dims, qpb, jipm.IPMConfig())
    out_j = jit_fast(
        jstk.resid_full_flat, cj.idxT, cj.Hl, cj.Fl, jnp.asarray(_lanes(z)),
        jnp.asarray(_lanes(pi)), cj.gL, cj.bL, jnp.asarray(_lanes(lam)),
        jnp.asarray(_lanes(t)),
        cj.dcatL, cj.mbL, cj.to_lanes3(qpb.z_mask),
        cj.to_lanes3(qpb.x_mask[:, 1:]),
        NB=dims.NB, NU=dims.NU, NZ=dims.NZ, NX=dims.NX)
    for name, a, b in zip(("rq", "rb", "rd", "rm", "musum"), out_t, out_j):
        assert np.abs(np.asarray(b)).max() > 0, name
        np.testing.assert_allclose(_lanes(a), np.asarray(b), rtol=0,
                                   atol=1e-12, err_msg=name)


def _spd(rng, Bn, n):
    A = rng.standard_normal((Bn, n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


def test_stage_math_chol_and_solves():
    rng = np.random.default_rng(5)
    M = _spd(rng, 6, 11)
    L, Dinv = sm.chol(torch.as_tensor(M))
    Lr = np.linalg.cholesky(M)
    np.testing.assert_allclose(L.numpy(), Lr, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Dinv.numpy(),
                               1.0 / np.diagonal(Lr, axis1=1, axis2=2),
                               rtol=1e-12)
    b = rng.standard_normal((6, 11))
    y = sm.tril_solve(L, Dinv, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(np.einsum("bij,bj->bi", Lr, y), b, atol=1e-12)
    y = sm.triu_solve_t(L, Dinv, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(np.einsum("bji,bj->bi", Lr, y), b, atol=1e-12)
    # root_x0 solves (Lxx Lxx') x0 = -px
    x0 = sm.root_x0(L, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(np.einsum("bij,bj->bi", M, x0), -b,
                               atol=1e-10)


def test_stage_math_folded_stage_matches_dense():
    """One folded Riccati stage: the factor of H + W W' with W = F Lxx."""
    rng = np.random.default_rng(6)
    NU, NX = 3, 8
    H = _spd(rng, 4, NU + NX)
    P = _spd(rng, 4, NX)
    Lxx = np.linalg.cholesky(P)
    F = rng.standard_normal((4, NU + NX, NX))
    g, bb = rng.standard_normal((4, NU + NX)), rng.standard_normal((4, NX))
    px = rng.standard_normal((4, NX))
    T = lambda a: torch.as_tensor(a)  # noqa: E731
    Lf, eu, pxo, Pb = sm.folded_bwd_core(NU, T(H), T(g), T(F), T(bb),
                                         T(Lxx), T(px))
    Mref = H + F @ P @ np.swapaxes(F, -1, -2)
    np.testing.assert_allclose(Lf.numpy(), np.linalg.cholesky(Mref),
                               rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(Pb.numpy(), np.einsum("bij,bj->bi", P, bb),
                               atol=1e-11)
    m = g + np.einsum("bij,bj->bi", F, Pb.numpy() + px)
    Lr = np.linalg.cholesky(Mref)
    eu_ref = np.linalg.solve(Lr[:, :NU, :NU], m[:, :NU][..., None])[..., 0]
    np.testing.assert_allclose(eu.numpy(), eu_ref, atol=1e-11)
    np.testing.assert_allclose(
        pxo.numpy(),
        m[:, NU:] - np.einsum("bij,bj->bi", Lr[:, NU:, :NU], eu_ref),
        atol=1e-11)
