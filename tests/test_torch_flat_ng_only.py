"""The lanes engine's flat form on a problem with general rows and NO box
rows, which the JAX package's ``select_engine`` sends to ``"flat"``
(``ipm_fast``) and solves.

The problem: the 2-mass chain (nx=4 nu=2) at N=16 with its bounds (u in
[-0.5, 0.5], the first two states in [-4, 4]) given as ``C``/``D`` rows
(``utils.mass_spring.mass_spring_data(bounds_as_rows=True)``), ``idxb``
one empty list per stage so both packages' ``select_engine`` get past the
structured gate, packed by both packages' ``api.pack_problem``; 4
instances with ``b`` scaled by [1, 0.5, 0.7, 0.9], float64.  The port's
engine runs its stage kernels' plain versions with one masked box slot
(``OCPDims.NB`` is at least 1, ``nb_mask`` 0 there), and is held against
``jax.vmap(ipm.solve)`` at ``tests/test_torch_ipm_structured.py``'s
``_compare`` tolerances.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hpmpc_tpu import api as japi  # noqa: E402
from hpmpc_tpu.models import ipm as jipm  # noqa: E402
from hpmpc_tpu.parallel import batch as jbatch  # noqa: E402
from hpmpc_tpu_torch import api  # noqa: E402
from hpmpc_tpu_torch.convert import QP_FIELDS, qp_from_numpy  # noqa: E402
from hpmpc_tpu_torch.models import ipm  # noqa: E402
from hpmpc_tpu_torch.ops import stage_kernel as sk  # noqa: E402
from hpmpc_tpu_torch.parallel import batch as tbatch  # noqa: E402
from hpmpc_tpu_torch.utils.mass_spring import mass_spring_data  # noqa: E402
from test_torch_ipm_structured import _FAST_COMPILE, _compare  # noqa: E402

torch.set_num_threads(1)


def test_flat_no_box_rows_matches_jax(monkeypatch):
    for k in ("HPMPC_RESIDENT", "HPMPC_LANES_LOOP", "HPMPC_MEGA_SWEEPS"):
        monkeypatch.delenv(k, raising=False)
    data = mass_spring_data(4, 2, 16, bounds_as_rows=True)
    dims, qp_j = japi.pack_problem(**data)
    dims_t, qp_t = api.pack_problem(**data, device="cpu")
    assert sum(dims.nb) == 0 and min(dims.ng) > 0
    assert (dims_t.nb, dims_t.ng, dims_t.idxb) == (dims.nb, dims.ng,
                                                   dims.idxb)
    assert all(len(r) == 0 for r in dims.idxb)
    sc = np.asarray([1.0, 0.5, 0.7, 0.9])
    qpb = jbatch.broadcast_qp(qp_j, len(sc))
    qpb = dataclasses.replace(qpb, b=qpb.b * jnp.asarray(sc)[:, None, None])
    qpt = qp_from_numpy(dims_t, {f: np.asarray(getattr(qpb, f))
                                 for f in QP_FIELDS}, device="cpu")
    cfg = ipm.IPMConfig(use_pallas=True)
    assert jbatch.select_engine(dims, jipm.IPMConfig(use_pallas=True), 1024,
                                jnp.float64) == "flat"
    assert tbatch.select_engine(dims_t, cfg, len(sc), torch.float64) == "flat"
    n0 = sk.PLAIN_CALLS["factor_solve_folded_flat"]
    sol_t = tbatch.solve_batched(dims_t, qpt, cfg)
    assert sk.PLAIN_CALLS["factor_solve_folded_flat"] > n0
    sol_j = jax.jit(jax.vmap(lambda q: jipm.solve(
        dims, q, jipm.IPMConfig()))).lower(qpb).compile(_FAST_COMPILE)(qpb)
    _compare(sol_t, sol_j)
    assert bool((sol_t.status == 0).all())
