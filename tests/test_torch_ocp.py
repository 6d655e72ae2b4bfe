"""Problem data of the PyTorch port vs the JAX package: the mass-spring
fixture bit for bit, the numpy parameter carry-over, the stream layout,
and the import boundary (the port never imports jax)."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hpmpc_tpu.ops import stage_kernel as jsk  # noqa: E402
from hpmpc_tpu.utils import mass_spring as jms  # noqa: E402
from hpmpc_tpu.utils import resid64 as jr64  # noqa: E402
from hpmpc_tpu_torch.convert import (  # noqa: E402
    QP_FIELDS, qp_from_numpy, qp_to_numpy, warm_from_numpy)
from hpmpc_tpu_torch.ops import layout  # noqa: E402
from hpmpc_tpu_torch.ocp import resolve_device  # noqa: E402
from hpmpc_tpu_torch.parallel.batch import broadcast_qp  # noqa: E402
from hpmpc_tpu_torch.utils import mass_spring as tms  # noqa: E402
from hpmpc_tpu_torch.utils import resid64 as tr64  # noqa: E402

torch.set_num_threads(1)

_DT = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32,
                                                    torch.float32)}


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("cfg", [dict(N=30, ngN=8), dict(N=4)])
def test_mass_spring_bit_for_bit(cfg, dt):
    jdt, tdt = _DT[dt]
    dims_j, qp_j = jms.mass_spring_qp(8, 3, dtype=jdt, **cfg)
    dims_t, qp_t = tms.mass_spring_qp(8, 3, dtype=tdt, device="cpu",
                                      **cfg)
    assert dataclasses.astuple(dims_j) == dataclasses.astuple(dims_t)
    assert dims_j.n_constr == dims_t.n_constr
    for name in QP_FIELDS:
        a = np.asarray(getattr(qp_j, name))
        b = getattr(qp_t, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(qp_t.pad_diag.numpy(),
                                  np.asarray(qp_j.pad_diag))
    assert qp_t.dtype == tdt


def test_mass_spring_ab_matches():
    A_j, B_j = jms.mass_spring_ab(8, 3)
    A_t, B_t = tms.mass_spring_ab(8, 3)
    np.testing.assert_array_equal(A_t, A_j)
    np.testing.assert_array_equal(B_t, B_j)


@pytest.mark.parametrize("batched", [False, True])
def test_qp_numpy_round_trip(batched):
    dims, qp_j = jms.mass_spring_qp(8, 3, 4, ngN=4, dtype=jnp.float64)
    arrays = {f: np.asarray(getattr(qp_j, f)) for f in QP_FIELDS}
    if batched:
        rng = np.random.default_rng(1)
        arrays = {f: np.broadcast_to(a, (3,) + a.shape).copy()
                  for f, a in arrays.items()}
        arrays["b"] = arrays["b"] * (1 + 0.1 * rng.standard_normal(
            (3, 1, 1)))
    qp = qp_from_numpy(dims, arrays, device="cpu", dtype=torch.float64)
    assert qp.idxb.dtype == torch.int32
    back = qp_to_numpy(qp)
    for f in QP_FIELDS:
        np.testing.assert_array_equal(back[f], arrays[f], err_msg=f)
    qp32 = qp.to(dtype=torch.float32)
    assert qp32.dtype == torch.float32 and qp32.idxb.dtype == torch.int32
    with pytest.raises(KeyError):
        qp_from_numpy(dims, {k: v for k, v in arrays.items() if k != "H"},
                      device="cpu")


def test_warm_from_numpy():
    rng = np.random.default_rng(2)
    z0 = rng.standard_normal((4, 5, 11))
    z, pi = warm_from_numpy({"z0": z0}, device="cpu", dtype=torch.float32)
    assert pi is None and z.dtype == torch.float32
    np.testing.assert_array_equal(z.numpy(), z0.astype(np.float32))


def test_entry_points_default_to_the_card():
    """With no device named, the entry points build on the CUDA card; they
    never fall back to the CPU, so without a card they raise."""
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        _, qp = tms.mass_spring_qp(8, 3, 4)
        assert qp.device.type == "cuda"
        return
    dims, qp = tms.mass_spring_qp(8, 3, 4, device="cpu")
    arrays = qp_to_numpy(qp)
    for call in (lambda: tms.mass_spring_qp(8, 3, 4),
                 lambda: qp_from_numpy(dims, arrays),
                 lambda: warm_from_numpy({"z0": np.zeros((1, 5, 11))})):
        with pytest.raises((AssertionError, RuntimeError)):
            call()


def test_broadcast_qp_shapes():
    _, qp = tms.mass_spring_qp(8, 3, 4, device="cpu")
    qpb = broadcast_qp(qp, 5)
    for f in QP_FIELDS:
        assert tuple(getattr(qpb, f).shape) == (5,) + tuple(
            getattr(qp, f).shape), f


def test_sym_compress_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 11, 11))
    x = x + np.swapaxes(x, -1, -2)
    p_t = layout.sym_compress(torch.as_tensor(x))
    p_j = np.asarray(jsk.sym_compress(jnp.asarray(x)))
    np.testing.assert_array_equal(p_t.numpy(), p_j)
    np.testing.assert_array_equal(layout.sym_expand(p_t, 11).numpy(), x)
    assert layout.sym_nt(11) == jsk._sym_nt(11) == 66
    assert all(layout.sym_idx(i, j) == jsk._sym_idx(i, j)
               for i in range(11) for j in range(i + 1))


def test_batch_last_layout_is_the_lanes_layout():
    """The port's (…, B) stream is the TPU's (nb, …, 8, 128) one with the
    three batch axes flattened and moved last."""
    B = 2048
    x = np.random.default_rng(4).standard_normal((B, 3, 5))
    jl = np.asarray(jsk._to_lanes(jnp.asarray(x), B))      # (2, 3, 5, 8, 128)
    tl = layout.to_lanes(torch.as_tensor(x)).numpy()        # (3, 5, 2048)
    np.testing.assert_array_equal(
        tl, np.moveaxis(jl, 0, -3).reshape(3, 5, B))
    np.testing.assert_array_equal(
        layout.from_lanes(torch.as_tensor(tl)).numpy(), x)


@pytest.mark.parametrize("batched_qp", [False, True])
def test_resid64_copy_matches_jax(batched_qp):
    """The port's numpy copy of the f64 host oracle gives the JAX package's
    numbers on the same (random) iterate, shared or batched QP leaves."""
    dims, qp_j = jms.mass_spring_qp(8, 3, 4, ngN=4, dtype=jnp.float64)
    arrays = {f: np.asarray(getattr(qp_j, f)) for f in QP_FIELDS}
    Bn = 3
    if batched_qp:
        arrays = {f: np.broadcast_to(a, (Bn,) + a.shape).copy()
                  for f, a in arrays.items()}
    rng = np.random.default_rng(7)
    N, NZ, NX, NB, NG = dims.N, dims.NZ, dims.NX, dims.NB, dims.NG
    it = dict(z=rng.standard_normal((Bn, N + 1, NZ)),
              pi=rng.standard_normal((Bn, N, NX)),
              lam_b=rng.random((Bn, N + 1, 2, NB)),
              t_b=rng.random((Bn, N + 1, 2, NB)),
              lam_g=rng.random((Bn, N + 1, 2, NG)),
              t_g=rng.random((Bn, N + 1, 2, NG)))
    qp_t = qp_from_numpy(dims, arrays, device="cpu")
    qp_jb = type(qp_j)(**{f: jnp.asarray(a) for f, a in arrays.items()})
    got = tr64.true_residuals(qp_t, **{k: torch.as_tensor(v)
                                       for k, v in it.items()})
    want = jr64.true_residuals(qp_jb, **it)
    for g, w in zip(got, want):
        assert np.all(np.isfinite(g)) and g.shape == (Bn, 4)
        np.testing.assert_allclose(g, w, rtol=1e-14, atol=0)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import hpmpc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'hpmpc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'hpmpc_tpu.')) or m == 'hpmpc_tpu']\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "print('ok')\n"
    )
    import pathlib

    repo = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
