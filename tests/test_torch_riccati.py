"""The plain Riccati layer of the PyTorch port (``ops/tri.py``,
``models/riccati.py``) vs the JAX package's ``hpmpc_tpu.ops.tri`` and
``hpmpc_tpu.models.riccati`` (vmapped over the instances), and against the
reference C solver's golden Riccati files.

Tolerances: float64 1e-12 of a field's scale (the same recursion, matmul
summation orders of two libraries); float32 2e-5 relative (the clamped
recursion on a well-conditioned batch; factors and inverses differ by a
few ulp per level); the golden files at tests/test_riccati.py's 1e-9.
The clamp cases (zero and negative pivots) must match exactly: the clamped
branch of the recursion only takes square roots and quotients of exact
values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import golden_ab, load_golden  # noqa: E402
from hpmpc_tpu.models import riccati as jric  # noqa: E402
from hpmpc_tpu.ops import tri as jtri  # noqa: E402
from hpmpc_tpu.utils.mass_spring import mass_spring_qp as j_mass_spring  # noqa: E402
from hpmpc_tpu_torch.models import riccati  # noqa: E402
from hpmpc_tpu_torch.ops import tri  # noqa: E402
from hpmpc_tpu_torch.parallel.batch import broadcast_qp  # noqa: E402
from hpmpc_tpu_torch.utils.mass_spring import mass_spring_qp  # noqa: E402

torch.set_num_threads(1)

TOL = {"float64": 1e-12, "float32": 2e-5}


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _spd(rng, shape, n):
    A = rng.standard_normal(shape + (n, n))
    return np.einsum("...ij,...kj->...ik", A, A) / n + 0.5 * np.eye(n)


@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_tri_matches_jax(dt):
    rng = np.random.default_rng(1)
    M = _spd(rng, (4,), 7).astype(dt)
    L = np.tril(rng.standard_normal((4, 7, 7))).astype(dt) + 3 * np.eye(7,
                                                                      dtype=dt)
    x = rng.standard_normal((4, 7)).astype(dt)
    X = rng.standard_normal((4, 7, 3)).astype(dt)
    pad = np.zeros((4, 7), dt)
    pad[:, 5:] = 1.0
    T = torch.as_tensor

    @jax.jit
    def jax_all(M, L, x, X, pad):
        return (jtri.cholesky(M), jax.vmap(jtri.chol_masked)(M, pad),
                jtri.tril_inverse(L), jax.vmap(jtri.solve_tril)(L, x),
                jax.vmap(jtri.solve_triu)(L.swapaxes(1, 2), X))

    want = jax_all(*(jnp.asarray(a) for a in (M, L, x, X, pad)))
    got = (tri.cholesky(T(M)), tri.chol_masked(T(M), T(pad)),
           tri.tril_inverse(T(L)), tri.solve_tril(T(L), T(x)),
           tri.solve_triu(T(L).transpose(1, 2), T(X)))
    for g_, w_, n_ in zip(got, want, ("cholesky", "chol_masked",
                                      "tril_inverse", "solve_tril",
                                      "solve_triu")):
        assert g_.dtype == getattr(torch, dt), n_
        _close(g_, w_, TOL[dt], n_)


@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_cholesky_clamps_pivots_like_jax(dt):
    """A rank-one block (zero pivot) and an indefinite one (negative pivot
    argument): the clamp gives the same huge-but-finite factor as JAX."""
    M = np.zeros((3, 5, 5), dt)
    M[0] = 1.0                                  # rank one: pivots 1, 0, 0...
    M[1] = np.eye(5) + 2.0 * (np.eye(5, k=1) + np.eye(5, k=-1))
    M[2, :2, :2] = [[1.0, 2.0], [2.0, 1.0]]     # 2x2 base case, c - b^2/a < 0
    M[2, 2:, 2:] = np.eye(3)
    got = tri.cholesky(torch.as_tensor(M))
    want = np.asarray(jax.jit(jtri.cholesky)(jnp.asarray(M)))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(got.numpy(), want)
    tiny = 1e-30 if dt == "float64" else 1e-20
    assert float(got[2, 1, 1]) == pytest.approx(np.sqrt(np.asarray(tiny, dt)))


def _batch(B, seed):
    """The nx=8 nu=3 N=10 mass-spring stage data for B instances with
    random positive barrier diagonals, gradients and right-hand sides
    (float64 numpy), and the dims."""
    dims, qp = j_mass_spring(8, 3, 10)
    rng = np.random.default_rng(seed)
    H = np.asarray(qp.H)[None] + np.einsum(
        "bnz,zw->bnzw", np.asarray(qp.pad_diag)[None]
        + rng.uniform(0.1, 2.0, (B,) + qp.pad_diag.shape), np.eye(dims.NZ))
    g = rng.standard_normal((B,) + qp.g.shape)
    F = np.broadcast_to(np.asarray(qp.F), (B,) + qp.F.shape).copy()
    b = rng.standard_normal((B,) + qp.b.shape)
    g2 = rng.standard_normal((B,) + qp.g.shape)
    return dims, dict(H=H, g=g, F=F, b=b, g2=g2)


def test_riccati_matches_jax():
    """factor_solve, factor, solve with and without the Pb cache, and
    kkt_residuals (float64, B=3)."""
    dims, p = _batch(3, 7)
    NU = dims.NU
    J = {k: jnp.asarray(v) for k, v in p.items()}
    T = {k: torch.as_tensor(v) for k, v in p.items()}

    @jax.jit
    def jax_all(H, g, F, b, g2):
        def one(H, g, F, b, g2):
            sol, L, eu, px, Pb = jric.factor_solve(H, g, F, b, NU)
            L2 = jric.factor(H, F, NU)
            s_pb, _ = jric.solve(L, g2, F, b, NU, Pb=Pb)
            s_nopb, Pb2 = jric.solve(L, g2, F, b, NU)
            rq, rb = jric.kkt_residuals(H, g2, F, b, s_pb.z, s_pb.pi, NU)
            return (sol.z, sol.pi, L, eu, px, Pb, L2, s_pb.z, s_pb.pi,
                    s_nopb.z, s_nopb.pi, Pb2, rq, rb)
        return jax.vmap(one)(H, g, F, b, g2)

    want = jax_all(J["H"], J["g"], J["F"], J["b"], J["g2"])
    sol, L, eu, px, Pb = riccati.factor_solve(T["H"], T["g"], T["F"],
                                              T["b"], NU)
    L2 = riccati.factor(T["H"], T["F"], NU)
    s_pb, Pb_same = riccati.solve(L, T["g2"], T["F"], T["b"], NU, Pb=Pb)
    s_nopb, Pb2 = riccati.solve(L, T["g2"], T["F"], T["b"], NU)
    rq, rb = riccati.kkt_residuals(T["H"], T["g2"], T["F"], T["b"], s_pb.z,
                                   s_pb.pi, NU)
    got = (sol.z, sol.pi, L, eu, px, Pb, L2, s_pb.z, s_pb.pi, s_nopb.z,
           s_nopb.pi, Pb2, rq, rb)
    names = ("z", "pi", "L", "eu", "px", "Pb", "L (factor)", "z (Pb)",
             "pi (Pb)", "z (no Pb)", "pi (no Pb)", "Pb (solve)", "rq", "rb")
    for g_, w_, n_ in zip(got, want, names):
        assert tuple(g_.shape) == tuple(w_.shape), n_
        _close(g_, w_, 1e-12, n_)
    assert torch.equal(Pb_same, Pb)
    # the solve satisfies its KKT system
    assert float(rq.abs().max()) < 1e-9 and float(rb.abs().max()) < 1e-9


@pytest.mark.parametrize("name", ["ric_ms_nx8_nu3_N10", "ric_ms_nx16_nu1_N30"])
def test_riccati_golden(name):
    g = load_golden(name)
    cfg = g["config"]
    A, Bm = golden_ab(g)
    dims, qp = mass_spring_qp(cfg["nx"], cfg["nu"], cfg["N"], A=A, B=Bm,
                              device="cpu")
    qp = broadcast_qp(qp, 1)
    H_eff = qp.H + torch.diag_embed(qp.pad_diag)
    sol, *_ = riccati.factor_solve(H_eff, qp.g, qp.F, qp.b, dims.NU)
    z, pi = sol.z[0].numpy(), sol.pi[0].numpy()
    for n in range(dims.N + 1):
        got = np.concatenate([z[n, :dims.nu[n]],
                              z[n, dims.NU:dims.NU + dims.nx[n]]])
        np.testing.assert_allclose(got, np.array(g["ux"][n]), rtol=0,
                                   atol=1e-9, err_msg=f"stage {n}")
    for n in range(dims.N):
        np.testing.assert_allclose(pi[n, :dims.nx[n + 1]],
                                   np.array(g["pi"][n]), rtol=0, atol=1e-9,
                                   err_msg=f"pi {n}")


def test_riccati_float32_matches_jax():
    """The same sweep in float32 (the plain backend of an f32 structured
    solve) at the float32 tolerance."""
    dims, p = _batch(2, 11)
    NU = dims.NU
    p32 = {k: v.astype(np.float32) for k, v in p.items()}
    want = jax.jit(jax.vmap(lambda H, g, F, b: jric.factor_solve(
        H, g, F, b, NU)[0]))(*(jnp.asarray(p32[k]) for k in "HgFb"))
    sol, *_ = riccati.factor_solve(*(torch.as_tensor(p32[k]) for k in "HgFb"),
                                   NU)
    _close(sol.z, want.z, 2e-5, "z")
    _close(sol.pi, want.pi, 2e-5, "pi")
