"""The flat engines folded into the lanes engines, and their two kernels.

  (a) Queue 2 rows 11-12, ``stage_kernel.solve_flat_pb`` and
      ``resid_terms_flat``: the port's plain versions (what the wrappers
      run on CPU tensors) vs the JAX package's Pallas kernels in interpret
      mode, float64, one 1024-lane block, N=3, NZ=3 (NU=1, NX=2: the
      interpret-mode compilation grows with the unrolled stage width), to
      1e-12 of a field's scale.  The retained factor handed to both is the
      port's factorization of random SPD stage Hessians
      (``factor_solve_folded_flat_ref``, itself held against JAX in
      tests/test_torch_stage_flat.py).
  (b) float32 into the hard flat form through ``solve_batched``: the
      flat stage 2 of bench.py's parity route and ``HPMPC_LANES_LOOP=0``
      with refinement without a threshold (``"flat"``); finite solutions,
      the unfused refinement (rows 12 + 11) ran.  The float64 flat form
      (``"flat"`` with and without ``iter_ref``, ``HPMPC_FUSED_REFINE=0``,
      ``HPMPC_STAGE2_LANES=0``) is held against ``jax.vmap(ipm.solve)`` in
      tests/test_torch_ipm_structured.py (``test_flat_form_matches_jax``),
      which reuses that file's JAX compilations.
  (c) the fused refinement pass (row 13) against the unfused one (rows 12
      + the elementwise assembly + row 11, ``stage_kernel.
      refine_flat_unfused``) on the same captured inputs: the plain
      versions, float64, N=4; tests/test_torch_cuda.py holds the kernels.
  The float64 soft batch through ``solve_batched_soft`` (``"soft_flat"``)
  is held against ``jax.vmap(ipm_soft.solve)`` in
  tests/test_torch_ipm_soft.py (``test_soft_flat_matches_jax``).

The JAX references compile without XLA's backend optimisations
(tests/test_torch_ipm_structured.py's ``jit_fast`` /
``_FAST_COMPILE``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from hpmpc_tpu.ops import stage_kernel as jsk  # noqa: E402
from hpmpc_tpu_torch.models import ipm_lanes  # noqa: E402
from hpmpc_tpu_torch.models.ipm import IPMConfig  # noqa: E402
from hpmpc_tpu_torch.ops import mega_kernel as mk  # noqa: E402
from hpmpc_tpu_torch.ops import stage_kernel as sk  # noqa: E402
from hpmpc_tpu_torch.ops.layout import sym_compress, to_lanes  # noqa: E402
from hpmpc_tpu_torch.parallel import batch as tbatch  # noqa: E402
from hpmpc_tpu_torch.utils.mass_spring import mass_spring_qp  # noqa: E402
from test_torch_ipm_structured import jit_fast  # noqa: E402

torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# (a) rows 11 and 12 vs the Pallas kernels
# ---------------------------------------------------------------------------

BL, NP1, NZ, NU, NX = 1024, 4, 3, 1, 2
N3 = NP1 - 1
DIMS = dict(NU=NU, NZ=NZ, NX=NX)


def _jl(x):
    """Port stream (..., B) -> the JAX lanes layout (nb, ..., 8, 128)."""
    a = np.asarray(x)
    a = a.reshape(a.shape[:-1] + (BL // jsk.BI, jsk.SUBS, jsk.LANES))
    return np.moveaxis(a, -3, 0)


@pytest.fixture(scope="module")
def kernel_case():
    """Random float64 inputs, the port's factor state, and the JAX
    kernels' outputs in interpret mode."""
    rng = np.random.default_rng(40)
    T = lambda a: to_lanes(torch.as_tensor(a))  # noqa: E731
    Hs = rng.standard_normal((BL, NP1, NZ, NZ))
    H = np.einsum("bnij,bnkj->bnik", Hs, Hs) / NZ + 2.0 * np.eye(NZ)
    p = dict(H=to_lanes(sym_compress(torch.as_tensor(H))),
             dvec=T(rng.uniform(0.1, 1.0, (BL, NP1, NZ))),
             g=T(rng.standard_normal((BL, NP1, NZ))),
             F=T(0.4 * rng.standard_normal((BL, N3, NZ, NX))),
             b=T(rng.standard_normal((BL, N3, NX))),
             rq=T(rng.standard_normal((BL, NP1, NZ))),
             rb=T(rng.standard_normal((BL, N3, NX))),
             z=T(rng.standard_normal((BL, NP1, NZ))),
             pi=T(rng.standard_normal((BL, N3, NX))))
    _, _, (Ll, Lxx, _) = sk.factor_solve_folded_flat_ref(
        p["H"], p["dvec"], None, (), p["g"], p["F"], p["b"], want_pi=False,
        **DIMS)
    p["Ll"], p["Lxx"] = Ll, Lxx
    J = lambda x: jnp.asarray(_jl(x))  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        orig = pl.pallas_call
        mp.setattr(pl, "pallas_call",
                   lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        pb = jit_fast(jsk.solve_flat_pb, J(Ll), J(Lxx), J(p["rq"]),
                      J(p["F"]), J(p["rb"]), NU, NZ, NX, lanes_io=True)
        terms = jit_fast(jsk.resid_terms_flat, J(p["H"]), J(p["F"]),
                         J(p["z"]), J(p["pi"]), NZ, NX, lanes_io=True)
    return p, pb, terms


def _close(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(_jl(got.numpy()), want, rtol=0,
                               atol=1e-12 * scale, err_msg=what)


def test_solve_flat_pb_matches_jax(kernel_case):
    p, (jz, jpi), _ = kernel_case
    n0 = sk.PLAIN_CALLS["solve_flat_pb"]
    z, pi = sk.solve_flat_pb(p["Ll"], p["Lxx"], p["rq"], p["F"], p["rb"],
                             **DIMS)
    assert sk.PLAIN_CALLS["solve_flat_pb"] == n0 + 1
    _close(z, jz, "z")
    _close(pi, jpi, "pi")


def test_resid_terms_flat_matches_jax(kernel_case):
    """hz on every stage; fz and fpi on stages < N (the TPU kernel leaves
    stage N unspecified; the port writes zeros there)."""
    p, _, (jhz, jfz, jfpi) = kernel_case
    n0 = sk.PLAIN_CALLS["resid_terms_flat"]
    hz, fz, fpi = sk.resid_terms_flat(p["H"], p["F"], p["z"], p["pi"],
                                      NZ=NZ, NX=NX)
    assert sk.PLAIN_CALLS["resid_terms_flat"] == n0 + 1
    _close(hz, jhz, "hz")
    _close(fz[:N3], np.asarray(jfz)[:, :N3], "fz")
    _close(fpi[:N3], np.asarray(jfpi)[:, :N3], "fpi")
    assert not fz[N3].any() and not fpi[N3].any()


# ---------------------------------------------------------------------------
# (b) float32 into the hard flat form
# ---------------------------------------------------------------------------

_ROWS = ("resid_terms_flat", "solve_flat_pb", "refine_flat_fused",
         "factor_solve_folded_flat", "solve_flat")


def _batch(dtype, N=5, B=8, ngN=0):
    dims, qp = mass_spring_qp(8, 3, N, ngN=ngN, dtype=dtype, device="cpu")
    qpb = tbatch.broadcast_qp(qp, B)
    rng = np.random.default_rng(0)
    sc = torch.as_tensor(1 + 0.02 * rng.standard_normal(B), dtype=dtype)
    return dims, dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])


def _counts():
    return ({k: sk.PLAIN_CALLS[k] for k in _ROWS},
            {k: sum(v) for k, v in mk.PLAIN_CALLS.items()})


def _ran(n0):
    n1 = _counts()
    return ({k: n1[0][k] - n0[0][k] for k in _ROWS},
            {k: n1[1][k] - n0[1][k] for k in n1[1]})


@pytest.mark.parametrize("env", [{"HPMPC_STAGE2_LANES": "0"},
                                 {"HPMPC_LANES_LOOP": "0"}])
def test_flat_dispatch_f32_runs(monkeypatch, env):
    """float32 into the flat form through ``solve_batched``: the flat
    stage 2 of bench.py's parity route, and ``HPMPC_LANES_LOOP=0`` with
    refinement without a threshold (``"flat"``); finite solutions, the
    unfused refinement ran."""
    for k in ("HPMPC_RESIDENT", "HPMPC_LANES_LOOP", "HPMPC_MEGA_SWEEPS",
              "HPMPC_STAGE2_LANES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    dims, qpb = _batch(torch.float32, N=4)
    cfg = IPMConfig(k_max=8, mu_tol=0.0, iter_ref=1, use_pallas=True,
                    iter_ref_mu_thr=1e-3 if "HPMPC_STAGE2_LANES" in env
                    else 0.0)
    n0 = _counts()
    sol = tbatch.solve_batched(dims, qpb, cfg)
    ran, _ = _ran(n0)
    assert ran["resid_terms_flat"] >= 1 and ran["solve_flat_pb"] >= 1, ran
    assert ran["refine_flat_fused"] == 0, ran
    assert int(sol.kk.max()) <= 8
    assert all(bool(torch.isfinite(x).all()) for x in sol
               if x.is_floating_point())


# ---------------------------------------------------------------------------
# (c) the fused refinement pass against the unfused one
# ---------------------------------------------------------------------------


def _first_refine(dims, qpb):
    """The arguments of the first fused refinement pass of a float64 lanes
    run with ``iter_ref=1`` (the initial iterate's affine direction)."""
    calls, orig = [], sk.refine_flat_fused

    def spy(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    sk.refine_flat_fused = spy
    try:
        ipm_lanes.solve_batched_lanes(
            dims, qpb, IPMConfig(k_max=1, iter_ref=1, use_pallas=True))
    finally:
        sk.refine_flat_fused = orig
    return calls[0]


@pytest.mark.parametrize("moved", [False, True])
def test_fused_refine_matches_unfused(moved):
    """One fused pass against one unfused pass on the same captured
    inputs (N=4, the ngN=4 block, 6 instances, float64; ROADMAP Queue 3's
    check, which the route-level comparison of chip_smoke.py's section F
    cannot make: it sits at its noise floor).  As captured the correction
    is ~1e-15 of the iterate; ``moved`` adds 0.1 N(0,1) to z and pi, so the
    correction is of the iterate's order and the check holds the two
    re-solves, not the update's rounding.  Measured on these plain
    versions: 0 in both; on the card the kernels (test_torch_cuda.py).
    Tolerance 1e-12 of each output's scale."""
    dims, qpb = _batch(torch.float64, N=4, B=6, ngN=4)
    a, k = _first_refine(dims, qpb)
    a = list(a)
    if moved:
        gen = torch.Generator().manual_seed(1)
        for i in (8, 9):
            a[i] = a[i] + 0.1 * torch.randn(a[i].shape, generator=gen,
                                            dtype=a[i].dtype)
    n0 = {n: sk.PLAIN_CALLS[n] for n in _ROWS}
    fused = sk.refine_flat_fused(*a, **k)
    unfused = sk.refine_flat_unfused(*a, **k)
    ran = {n: sk.PLAIN_CALLS[n] - n0[n] for n in _ROWS}
    assert ran == dict(refine_flat_fused=1, resid_terms_flat=1,
                       solve_flat_pb=1, factor_solve_folded_flat=0,
                       solve_flat=0), ran
    for x, y, x0 in zip(fused, unfused, a[8:10]):
        scale = max(1.0, float(y.abs().max()))
        assert float((x - y).abs().max()) <= 1e-12 * scale
        if moved:
            assert float((x - x0).abs().max()) > 0.1
