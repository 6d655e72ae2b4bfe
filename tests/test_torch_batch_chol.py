"""The batched Cholesky of the PyTorch port's large-NZ band
(``hpmpc_tpu_torch.ops.batch_chol``, Queue 2 rows 24-25) vs the JAX
package's Pallas kernels (``hpmpc_tpu.ops.batch_chol``) in interpret mode,
on the same inputs made with numpy.

On the CPU the wrappers run their plain versions (``cholesky_ref``,
``panel_factor_ref``; counted in ``PLAIN_CALLS``).  Row 24 at n in {3, 8,
11, 24, 37} (B=24, JAX's tb=8), with leading dimensions (2, 3) and on a
matrix whose pivot the clamp catches (row and column 3 zero: the factor's
column 3 is 0 where an unclamped rsqrt(0) would give NaN), float64 and
float32; row 25 through ``cholesky_blocked`` (p=8, n in {8, 12}) and
``_panel_factor``'s L and L^-1.  Tolerances: tests/test_batch_chol.py's
1e-12 (rtol and atol) in float64, 1e-6 of the factor's scale in float32 (the
plain version and the Pallas kernel in interpret mode sum in the same
order; XLA may fuse a multiply and subtract).  The strictly upper part of
every factor must be exactly 0.  The JAX kernels compile once per shape
(module-scoped interpret patch); n <= 40 keeps interpret mode cheap.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from hpmpc_tpu.ops import batch_chol as jbc  # noqa: E402
from hpmpc_tpu_torch.ops import batch_chol as bc  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def interpret_pallas():
    with pytest.MonkeyPatch.context() as mp:
        orig = pl.pallas_call

        def patched(*a, **k):
            k["interpret"] = True
            return orig(*a, **k)

        mp.setattr(pl, "pallas_call", patched)
        yield


def _spd(rng, shape, n, clamp=False):
    A = rng.standard_normal(shape + (n, n))
    M = A @ np.swapaxes(A, -1, -2) + n * np.eye(n)
    if clamp:
        M[..., 3, :] = 0.0
        M[..., :, 3] = 0.0
    return M


def _both(fn_t, fn_j, M, dtype):
    """(port result, JAX result) of the same numpy input, as numpy."""
    out_t = fn_t(torch.as_tensor(M, dtype=dtype))
    out_j = fn_j(jnp.asarray(M, {torch.float64: jnp.float64,
                                 torch.float32: jnp.float32}[dtype]))
    if isinstance(out_t, tuple):
        return [x.numpy() for x in out_t], [np.asarray(x) for x in out_j]
    return [out_t.numpy()], [np.asarray(out_j)]


@pytest.mark.parametrize("n", [3, 8, 11, 24, 37])
def test_cholesky_matches_jax(interpret_pallas, n):
    M = _spd(np.random.default_rng(0), (24,), n)
    n0 = bc.PLAIN_CALLS["cholesky"]
    (L,), (L_j,) = _both(bc.cholesky, lambda x: jbc.cholesky(x, tb=8), M,
                         torch.float64)
    assert bc.PLAIN_CALLS["cholesky"] == n0 + 1
    np.testing.assert_allclose(L, L_j, rtol=1e-12, atol=1e-12)
    assert np.all(np.triu(L, 1) == 0.0)


def test_cholesky_leading_dims(interpret_pallas):
    M = _spd(np.random.default_rng(1), (2, 3), 5)   # B=6, not a TB multiple
    (L,), (L_j,) = _both(bc.cholesky, jbc.cholesky, M, torch.float64)
    assert L.shape == (2, 3, 5, 5)
    np.testing.assert_allclose(L, L_j, rtol=1e-12, atol=1e-12)
    assert np.all(np.triu(L, 1) == 0.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cholesky_clamped_pivot(interpret_pallas, dtype):
    M = _spd(np.random.default_rng(2), (8,), 8, clamp=True)
    (L,), (L_j,) = _both(bc.cholesky, jbc.cholesky, M, dtype)
    assert np.all(np.isfinite(L)) and np.all(L[:, :, 3] == 0.0)
    assert np.all(np.triu(L, 1) == 0.0)
    if dtype == torch.float64:
        np.testing.assert_allclose(L, L_j, rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_allclose(L, L_j, rtol=0,
                                   atol=1e-6 * np.abs(L_j).max())


@pytest.mark.parametrize("n", [8, 12])
def test_cholesky_blocked_matches_jax(interpret_pallas, n):
    M = _spd(np.random.default_rng(3), (16,), n)
    n0 = bc.PLAIN_CALLS["panel_factor"]
    (L,), (L_j,) = _both(lambda x: bc.cholesky_blocked(x, p=8),
                         lambda x: jbc.cholesky_blocked(x, p=8), M,
                         torch.float64)
    assert bc.PLAIN_CALLS["panel_factor"] - n0 == -(-n // 8)
    np.testing.assert_allclose(L, L_j, rtol=1e-12, atol=1e-12)
    assert np.all(np.triu(L, 1) == 0.0)


def test_panel_factor_matches_jax(interpret_pallas):
    M = _spd(np.random.default_rng(4), (16,), 8)
    (L, Li), (L_j, Li_j) = _both(bc.panel_factor,
                                 lambda x: jbc._panel_factor(x, p=8), M,
                                 torch.float64)
    np.testing.assert_allclose(L, L_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Li, Li_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(L @ Li, np.broadcast_to(np.eye(8), L.shape),
                               rtol=0, atol=1e-12)
