"""The structured route's Riccati kernels of the PyTorch port
(``ops/stage_kernel.py``: ``factor_solve_folded``, ``factor_solve_batched``,
``solve_batched``, Queue 2 rows 16, 14, 15) vs the JAX package's Pallas
kernels in interpret mode, as tests/test_stage_kernel.py runs them.

On the CPU the port's wrappers run their plain versions (counted in
``PLAIN_CALLS``).  Inputs: one 1024-lane block of the 2-mass chain's stage
shapes (nx=4, nu=2: NZ=6), N=4, float64, built in numpy from a seed: SPD
stage Hessians, a positive barrier diagonal, general rows on two stages
(2 and N, so that the slot of each stage's packed term is exercised) with
a positive barrier diagonal Qx_g.  Row 14 gets the same effective Hessian
whole; row 15 re-solves a second gradient on the factor state of the JAX
row 16.  The port takes batch-last streams and the packed ng term, the
JAX wrappers batch-first arrays and the dense one: the same numbers.

Tolerance: 1e-12 of a field's largest magnitude (the same algorithm in
another summation order; the TPU wrappers' stage-N tail solves u_N by
substitution in XLA, the port in the kernel's reciprocal form).

The JAX references compile without XLA's backend optimisations
(tests/test_torch_ipm_structured.py's ``jit_fast`` /
``_FAST_COMPILE``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from hpmpc_tpu.ops import stage_kernel as jsk  # noqa: E402
from hpmpc_tpu_torch.ops import stage_kernel as sk  # noqa: E402
from hpmpc_tpu_torch.ops.layout import sym_compress, to_lanes  # noqa: E402
from test_torch_ipm_structured import jit_fast  # noqa: E402

torch.set_num_threads(1)

B, N, NU, NX, NG = 1024, 4, 2, 4, 2
NZ = NU + NX
NG_IDS = (2, N)
TOL = 1e-12


def _problem():
    rng = np.random.default_rng(5)
    Hs = rng.standard_normal((B, N + 1, NZ, NZ))
    C = rng.standard_normal((B, len(NG_IDS), NG, NZ))
    q = rng.uniform(0.1, 1.0, (B, len(NG_IDS), NG))
    p = dict(H=np.einsum("bnij,bnkj->bnik", Hs, Hs) / NZ + 0.5 * np.eye(NZ),
             dvec=rng.uniform(0.1, 1.0, (B, N + 1, NZ)),
             ngterm=np.einsum("bjgr,bjg,bjgc->bjrc", C, q, C),
             g=rng.standard_normal((B, N + 1, NZ)),
             g2=rng.standard_normal((B, N + 1, NZ)),
             F=0.4 * rng.standard_normal((B, N, NZ, NX)),
             b=rng.standard_normal((B, N, NX)))
    H_eff = p["H"] + np.einsum("bnz,zw->bnzw", p["dvec"], np.eye(NZ))
    for j, n in enumerate(NG_IDS):
        H_eff[:, n] += p["ngterm"][:, j]
    p["H_eff"] = H_eff
    return p


def _lanes(a):
    """numpy (B, ...) -> the port's batch-last stream."""
    return to_lanes(torch.as_tensor(np.array(a)))


def _close(got, want, what):
    """Port batch-last ``got`` vs JAX batch-first ``want``."""
    want = np.asarray(want)
    got = np.moveaxis(got.numpy(), -1, 0)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


def _interpret(mp):
    orig = pl.pallas_call
    mp.setattr(pl, "pallas_call",
               lambda *a, **k: orig(*a, **{**k, "interpret": True}))


@pytest.fixture(scope="module")
def problem():
    return _problem()


@pytest.fixture(scope="module")
def jax_folded(problem):
    p = problem
    with pytest.MonkeyPatch.context() as mp:
        _interpret(mp)
        return jit_fast(jsk.factor_solve_folded,
            jnp.asarray(p["H"]), jnp.asarray(p["dvec"]),
            jnp.asarray(p["ngterm"]), NG_IDS, jnp.asarray(p["g"]),
            jnp.asarray(p["F"]), jnp.asarray(p["b"]), NU)


@pytest.fixture(scope="module")
def jax_batched(problem):
    p = problem
    with pytest.MonkeyPatch.context() as mp:
        _interpret(mp)
        return jit_fast(jsk.factor_solve_batched,
            jnp.asarray(p["H_eff"]), jnp.asarray(p["g"]), jnp.asarray(p["F"]),
            jnp.asarray(p["b"]), NU)


@pytest.fixture(scope="module")
def jax_trs(problem, jax_folded):
    p = problem
    _, _, L, _, _, Pb = jax_folded
    with pytest.MonkeyPatch.context() as mp:
        _interpret(mp)
        return jit_fast(jsk.solve_batched, L, jnp.asarray(p["g2"]),
                        jnp.asarray(p["F"]), jnp.asarray(p["b"]), Pb, NU)


_OUT = ("z", "pi", "L", "eu", "px", "Pb")


def _plain(name, fn):
    """Run ``fn`` and check that it took the plain version once."""
    n0 = sk.PLAIN_CALLS[name]
    out = fn()
    assert sk.PLAIN_CALLS[name] == n0 + 1
    return out


def test_factor_solve_folded_matches_jax(problem, jax_folded):
    p = problem
    ngl = to_lanes(sym_compress(torch.as_tensor(p["ngterm"])))
    out = _plain("factor_solve_folded", lambda: sk.factor_solve_folded(
        to_lanes(sym_compress(torch.as_tensor(p["H"]))), _lanes(p["dvec"]),
        ngl, NG_IDS, _lanes(p["g"]), _lanes(p["F"]), _lanes(p["b"]), NU))
    for got, want, what in zip(out, jax_folded, _OUT):
        _close(got, want, what)
    L, eu = out[2], out[3]
    assert not bool(torch.triu(L.movedim(-1, 0), 1).any())
    assert not bool(eu[:, NU:].any())


def test_factor_solve_batched_matches_jax(problem, jax_batched, jax_folded):
    p = problem
    out = _plain("factor_solve_batched", lambda: sk.factor_solve_batched(
        _lanes(p["H_eff"]), _lanes(p["g"]), _lanes(p["F"]), _lanes(p["b"]),
        NU))
    for got, want, what in zip(out, jax_batched, _OUT):
        _close(got, want, what)
    # row 14 on the assembled Hessian = row 16 on its pieces
    for got, want, what in zip(out, jax_folded, _OUT):
        _close(got, want, what + " (vs the folded form)")


def test_solve_batched_matches_jax(problem, jax_folded, jax_trs):
    p = problem
    L, Pb = (_lanes(x) for x in (jax_folded[2], jax_folded[5]))
    z, pi = _plain("solve_batched", lambda: sk.solve_batched(
        L, _lanes(p["g2"]), _lanes(p["F"]), _lanes(p["b"]), Pb, NU))
    _close(z, jax_trs[0], "z")
    _close(pi, jax_trs[1], "pi")
