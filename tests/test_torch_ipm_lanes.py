"""Stream scaffolding of the PyTorch port (``make_lanes_common``,
``make_ng_lanes``) vs the JAX package's, on the same batch: index table,
constant streams, the d_init_var initial iterate and the ng init.  Plain
XLA on the JAX side (no Pallas call), so this is cheap."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hpmpc_tpu.models import ipm as jipm  # noqa: E402
from hpmpc_tpu.models import ipm_lanes as jl  # noqa: E402
from hpmpc_tpu.ops import stage_kernel as jsk  # noqa: E402
from hpmpc_tpu.parallel import batch as jbatch  # noqa: E402
from hpmpc_tpu.utils.mass_spring import mass_spring_qp as j_mass_spring  # noqa: E402
from hpmpc_tpu_torch.convert import QP_FIELDS, qp_from_numpy  # noqa: E402
from hpmpc_tpu_torch.models import ipm_lanes as tl  # noqa: E402
from hpmpc_tpu_torch.models.ipm import IPMConfig  # noqa: E402

torch.set_num_threads(1)

B = 1024  # the JAX lanes layout needs whole 1024-instance blocks


def _lanes(x):
    """Port stream (…, B) -> the JAX lanes layout (nb, …, 8, 128)."""
    a = x.numpy()
    a = a.reshape(a.shape[:-1] + (B // jsk.BI, jsk.SUBS, jsk.LANES))
    return np.moveaxis(a, -3, 0)


@pytest.mark.parametrize("warm", [False, True])
def test_lanes_common_matches_jax(warm):
    dims, qp_j = j_mass_spring(8, 3, 4, ngN=4, dtype=jnp.float64)
    qpb = jbatch.broadcast_qp(qp_j, B)
    rng = np.random.default_rng(0)
    qpb = dataclasses.replace(
        qpb, b=qpb.b * jnp.asarray(1 + 0.02 * rng.standard_normal(B))[
            :, None, None])
    qp_t = qp_from_numpy(dims, {f: np.asarray(getattr(qpb, f))
                                for f in QP_FIELDS}, device="cpu")
    z0 = pi0 = None
    if warm:
        z0 = 0.3 * rng.standard_normal((B, dims.N + 1, dims.NZ))
        pi0 = rng.standard_normal((B, dims.N, dims.NX))
    cfg_j = jipm.IPMConfig(warm_start=warm, reg_eps=1e-6)
    cfg_t = IPMConfig(warm_start=warm, reg_eps=1e-6)
    cj = jl.make_lanes_common(
        dims, qpb, cfg_j,
        z0=None if z0 is None else jnp.asarray(z0),
        pi0=None if pi0 is None else jnp.asarray(pi0))
    ct = tl.make_lanes_common(
        dims, qp_t, cfg_t,
        z0=None if z0 is None else torch.as_tensor(z0),
        pi0=None if pi0 is None else torch.as_tensor(pi0))

    np.testing.assert_array_equal(ct.idxT.numpy(), np.asarray(cj.idxT))
    for name in ("mbL", "dcatL", "gL", "pdregL", "bL", "Hl", "Fl", "zL0",
                 "lamL0", "tL0"):
        np.testing.assert_allclose(_lanes(getattr(ct, name)),
                                   np.asarray(getattr(cj, name)),
                                   rtol=1e-15, atol=1e-15, err_msg=name)
    if warm:
        np.testing.assert_allclose(_lanes(ct.piL0), np.asarray(cj.piL0),
                                   rtol=1e-15, atol=1e-15)
    else:
        assert ct.piL0 is None and cj.piL0 is None

    ng_stages = tuple(n for n in range(dims.N + 1) if dims.ng[n] > 0)
    nj = jl.make_ng_lanes(dims, qpb, ng_stages, jnp.float64, B)
    nt = tl.make_ng_lanes(dims, qp_t, ng_stages, torch.float64, B)
    for name in ("mgF", "dg_cat", "mg2", "sgn_g"):
        np.testing.assert_array_equal(getattr(nt, name).numpy(),
                                      np.asarray(getattr(nj, name)))
    lg_j, tg_j = cj.ng_init(nj)
    lg_t, tg_t = ct.ng_init(nt)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=1e-15)
    np.testing.assert_allclose(tg_t.numpy(), np.asarray(tg_j), rtol=1e-15)
    # C' v scatter on the active stages, on a random v
    v = rng.standard_normal((B, nt.NGF))
    out_t = nt.ct_add_lanes(ct.gL, torch.as_tensor(v))
    out_j = nj.ct_add_lanes(cj.gL, jnp.asarray(v))
    np.testing.assert_allclose(_lanes(out_t), np.asarray(out_j),
                               rtol=1e-14, atol=1e-14)
