"""The structured soft IPM of the PyTorch port (``models.ipm_soft.solve``,
batch-native) vs ``jax.vmap(hpmpc_tpu.models.ipm_soft.solve)`` on the same
batch (handed over through ``convert.qp_from_numpy`` /
``soft_from_numpy``), and against the reference C solver's golden soft
runs.

Both KKT backends run: the plain batched Riccati and, with
``use_pallas``, the kernel backend, which on the CPU runs the plain
versions of ``stage_kernel.factor_solve_folded`` / ``solve_batched``
(Queue 2 rows 16 and 15; counted in ``PLAIN_CALLS``).  The JAX solve at
B=4 takes its XLA Riccati with or without ``use_pallas`` (its Pallas gate
wants 1024 instances): the same function, so each kernel-backend case is
held against the JAX solve of its config without ``use_pallas``.

The batch: the reference's soft problem at N=5 (``mass_spring_soft_qp(8,
3, 5, Z=10)``), float64, 4 instances with ``b`` scaled by [1, 0.3, 0.05,
1.5], ``IPMConfig(k_max=6, mu0=100, mu_tol=2e-6)``: the third instance
converges at kk 5, the others stop at the budget (mixed exit iterations
and statuses).  Six iterations keep the soft multipliers comparable: near
convergence the active soft bounds recover them from slacks of ~1e-10
(ROADMAP Queue 3, "Soft multipliers").  Three JAX compilations: both
``exact_mehrotra_soft`` values, and a warm start from a perturbed iterate
on the problem with general rows on stages 2 and N.  Tolerances:
equal kk and status, stat rows rtol 1e-6 (atol 1e-9), z, lam_s and t_s
within 1e-8, pi within 1e-7, the box and general multipliers and slacks
rtol 1e-6 / atol 1e-8 (tests/test_ipm.py's).  The float64 soft batch
through ``solve_batched_soft`` (``"soft_flat"``: the soft lanes engine's
6-kernel loop) is held against the same two unwarmed JAX solves.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import golden_ab, load_golden  # noqa: E402
from hpmpc_tpu.models import ipm as jipm  # noqa: E402
from hpmpc_tpu.models import ipm_soft as jsoft  # noqa: E402
from hpmpc_tpu.ocp import OCPDims as JDims  # noqa: E402
from hpmpc_tpu.ops import tri as jtri  # noqa: E402
from hpmpc_tpu.utils.mass_spring import mass_spring_soft_qp as j_soft_qp  # noqa: E402
from hpmpc_tpu_torch.convert import (  # noqa: E402
    QP_FIELDS, qp_from_numpy, soft_from_numpy, warm_from_numpy)
from hpmpc_tpu_torch.models import ipm_soft  # noqa: E402
from hpmpc_tpu_torch.models import riccati as tric  # noqa: E402
from hpmpc_tpu_torch.models.ipm import IPMConfig  # noqa: E402
from hpmpc_tpu_torch.ops import mega_kernel as mk  # noqa: E402
from hpmpc_tpu_torch.ops import tri as ttri  # noqa: E402
from hpmpc_tpu_torch.ops import stage_kernel as sk  # noqa: E402
from hpmpc_tpu_torch.parallel.batch import (  # noqa: E402
    broadcast_qp, broadcast_soft, select_soft_engine, solve_batched_soft)
from hpmpc_tpu_torch.utils.mass_spring import mass_spring_soft_qp  # noqa: E402

torch.set_num_threads(1)

N = 5
SCALES = [1.0, 0.3, 0.05, 1.5]
CFG = dict(k_max=6, mu0=100.0, mu_tol=2e-6)
_FAST_COMPILE = {"xla_backend_optimization_level": 0}
CASES = {"exact": (True, False), "dropped_correction": (False, False),
         "warm_ng": (True, True)}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _with_ng(dims0, qp):
    """One general row on stages 2 and N, 0.25 times the state sum, in
    [-1, 1] (tests/test_ipm_soft_lanes.py's ng problem)."""
    ng = [0] * (N + 1)
    ng[2] = ng[N] = 1
    dims = JDims.create(N, dims0.nx, dims0.nu, dims0.nb, ng, idxb=dims0.idxb)
    C = np.zeros((N + 1, dims.NG, dims.NZ))
    d_lg, d_ug = np.zeros((N + 1, dims.NG)), np.zeros((N + 1, dims.NG))
    for n in (2, N):
        C[n, 0, dims.NU:dims.NU + dims0.nx[n]] = 0.25
        d_lg[n, 0], d_ug[n, 0] = -1.0, 1.0
    return dims, dataclasses.replace(
        qp, C=jnp.asarray(C), d_lg=jnp.asarray(d_lg), d_ug=jnp.asarray(d_ug),
        ng_mask=jnp.asarray(dims.ng_mask(), qp.dtype))


@pytest.fixture(scope="module")
def cases():
    """Per case: (dims, port qp, port soft, z0, pi0) and the JAX solve,
    compiled once each."""
    out = {}
    for case, (exact, warm_ng) in CASES.items():
        dims, qp, soft = j_soft_qp(8, 3, N, Z=10.0, dtype=jnp.float64)
        if warm_ng:
            dims, qp = _with_ng(dims, qp)
        bc = lambda x: jnp.broadcast_to(x, (len(SCALES),) + x.shape)  # noqa: E731
        qpb = jax.tree_util.tree_map(bc, qp)
        sb = jax.tree_util.tree_map(bc, soft)
        qpb = dataclasses.replace(
            qpb, b=qpb.b * jnp.asarray(SCALES)[:, None, None])
        z0 = pi0 = None
        if warm_ng:
            rng = np.random.default_rng(3)
            z0 = 0.1 * rng.standard_normal(qpb.g.shape)
            pi0 = 0.1 * rng.standard_normal(qpb.b.shape)
        cfg = jipm.IPMConfig(warm_start=warm_ng, **CFG)

        def one(q, s, zz, pp, exact=exact):
            return jsoft.solve(dims, q, s, cfg, exact_mehrotra_soft=exact,
                               z0=zz, pi0=pp)

        axes = 0 if warm_ng else None
        args = (qpb, sb, None if z0 is None else jnp.asarray(z0),
                None if pi0 is None else jnp.asarray(pi0))
        sol_j = jax.jit(jax.vmap(one, in_axes=(0, 0, axes, axes))).lower(
            *args).compile(_FAST_COMPILE)(*args)
        qpt = qp_from_numpy(dims, {f: np.asarray(getattr(qpb, f))
                                   for f in QP_FIELDS}, device="cpu")
        st = soft_from_numpy({f: np.asarray(getattr(sb, f))
                              for f in sb._fields}, device="cpu")
        z0t, pi0t = warm_from_numpy(dict(z0=z0, pi0=pi0), device="cpu")
        out[case] = ((dims, qpt, st, z0t, pi0t), sol_j)
    return out


def _compare(sol_t, sol_j):
    np.testing.assert_array_equal(_np(sol_t.kk), _np(sol_j.kk))
    np.testing.assert_array_equal(_np(sol_t.status), _np(sol_j.status))
    np.testing.assert_allclose(_np(sol_t.stat), _np(sol_j.stat), rtol=1e-6,
                               atol=1e-9)
    for f, rtol, atol in (("z", 0, 1e-8), ("pi", 0, 1e-7),
                          ("lam_s", 0, 1e-8), ("t_s", 0, 1e-8),
                          ("lam_b", 1e-6, 1e-8), ("t_b", 1e-6, 1e-8),
                          ("lam_g", 1e-6, 1e-8), ("t_g", 1e-6, 1e-8)):
        np.testing.assert_allclose(_np(getattr(sol_t, f)),
                                   _np(getattr(sol_j, f)), rtol=rtol,
                                   atol=atol, err_msg=f)
    for f in sol_t._fields:
        assert _np(getattr(sol_t, f)).shape == _np(getattr(sol_j, f)).shape


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_soft_solve_matches_jax(cases, case, use_pallas):
    (dims, qpt, st, z0, pi0), sol_j = cases[case]
    exact, warm_ng = CASES[case]
    n0 = dict(sk.PLAIN_CALLS)
    sol_t = ipm_soft.solve(
        dims, qpt, st, IPMConfig(use_pallas=use_pallas, warm_start=warm_ng,
                                 **CFG),
        exact_mehrotra_soft=exact, z0=z0, pi0=pi0)
    ran = {k: sk.PLAIN_CALLS[k] - n0[k]
           for k in ("factor_solve_folded", "solve_batched")}
    assert (min(ran.values()) >= 1) if use_pallas else (max(ran.values())
                                                        == 0), ran
    _compare(sol_t, sol_j)
    if case == "exact":
        assert len(set(_np(sol_t.kk).tolist())) > 1   # mixed exit iterations


@pytest.mark.parametrize("case", ["exact", "dropped_correction"])
def test_soft_flat_matches_jax(monkeypatch, cases, case):
    """The float64 soft batch through ``solve_batched_soft`` with
    ``use_pallas`` and a static ``idxbs``: ``"soft_flat"``, the soft lanes
    engine's 6-kernel loop (no mega kernel runs), on the same batch."""
    for k in ("HPMPC_RESIDENT", "HPMPC_LANES_LOOP", "HPMPC_MEGA_SWEEPS"):
        monkeypatch.delenv(k, raising=False)
    (dims, qpt, st, _, _), sol_j = cases[case]
    exact, _ = CASES[case]
    cfg = IPMConfig(use_pallas=True, **CFG)
    idxbs = st.idxbs[0].numpy()
    assert select_soft_engine(dims, cfg, torch.float64, idxbs.shape[-1],
                              idxbs) == "soft_flat"
    n_mega = dict(mk.SOFT_PLAIN_CALLS)
    n_solve = sk.PLAIN_CALLS["solve_flat"]
    sol_t = solve_batched_soft(dims, qpt, st, cfg, idxbs=idxbs,
                               exact_mehrotra_soft=exact)
    assert mk.SOFT_PLAIN_CALLS == n_mega
    assert sk.PLAIN_CALLS["solve_flat"] > n_solve
    _compare(sol_t, sol_j)


def _knife_edge_witness(H, F, NU):
    """The port's Riccati recursion on the stage Hessians ``H`` of a
    factorization: its first stage matrix with a clamped pivot (1e-15, the
    clamp of ``tri.cholesky`` in float64) is conditioned past float64's
    precision, and the JAX package's Cholesky of that matrix clamps the
    same pivot."""
    clamp = 1.0000001e-15
    Lxx = None
    for n in range(H.shape[0] - 1, -1, -1):
        M = H[n] if Lxx is None else H[n] + (F[n] @ Lxx) @ (F[n] @ Lxx).T
        L = ttri.cholesky(M[None])[0]
        d = torch.diagonal(L).abs()
        if bool((d <= clamp).any()):
            assert np.linalg.cond(M.numpy()) > 1e16
            Lj = jax.jit(jtri.cholesky)(jnp.asarray(M.numpy()))
            dj = np.abs(np.diag(np.asarray(Lj)))
            i = int(torch.argmin(d))
            assert dj[i] <= clamp and int(np.argmin(dj)) == i, (n, i, dj)
            return
        Lxx = L[NU:, NU:]
    raise AssertionError("no clamped pivot in the last factorization")


@pytest.mark.parametrize("exact,use_pallas", [(False, False), (False, True),
                                              (True, False)])
@pytest.mark.parametrize("name", ["ipm_soft_ms_nx8_nu3_N30_Z0",
                                  "ipm_soft_ms_nx8_nu3_N30_Z10"])
def test_golden_soft_runs(monkeypatch, name, exact, use_pallas):
    """The reference C solver's soft runs: the first iteration's affine
    trace (the corrector entries carry the reference's stale-pointer
    writes) and the converged solution, at tests/test_ipm_soft.py's
    tolerances, with the reference's dropped corrector correction
    (``exact_mehrotra_soft=False``) on both backends, and with the full
    correction, which converges in fewer iterations than the reference.

    One run breaks down one step short of mu_tol: ``_Z10`` with the
    dropped correction on the plain backend.  The two packages' iterates
    drift apart by summation order (the batched products of the Riccati
    recursion), growing with the barrier's conditioning.  The last step
    meets a Riccati stage matrix conditioned past float64's precision, on
    which a change in the last bits decides whether the blocked Cholesky
    keeps a positive pivot.
    JAX's run and the kernel backend pass it; the port's plain run keeps
    its last iterate (status 2, mu < 3e-8), whose solution still meets the
    golden tolerances.  The test then requires the witness: in the last
    factorization, the first stage whose pivot is clamped has a condition
    number above 1e16, and the JAX package's ``tri.cholesky`` clamps the
    same pivot of that same matrix (ROADMAP Queue 3, "Knife-edge
    Cholesky")."""
    g = load_golden(name)
    c = g["config"]
    A, Bm = golden_ab(g)
    dims, qp, soft = mass_spring_soft_qp(c["nx"], c["nu"], c["N"], Z=c["Z"],
                                         z_lin=c["zlin"], A=A, B=Bm,
                                         device="cpu")
    knife_edge = name.endswith("Z10") and not exact and not use_pallas
    factored = []
    if knife_edge:
        fs = tric.factor_solve
        monkeypatch.setattr(tric, "factor_solve", lambda H, *a, **k: (
            factored.append(H[0]), fs(H, *a, **k))[1])
    sol = ipm_soft.solve(
        dims, broadcast_qp(qp, 1), broadcast_soft(soft, 1),
        IPMConfig(k_max=c["k_max"], mu0=c["mu0"], mu_tol=c["mu_tol"],
                  alpha_min=c["alpha_min"], use_pallas=use_pallas),
        exact_mehrotra_soft=exact)
    stat_ref = np.array(g["stat"]).reshape(-1, 5)[0][:3]
    np.testing.assert_allclose(_np(sol.stat[0, 0, :3]), stat_ref, rtol=1e-9,
                               atol=1e-12)
    kk, status = int(sol.kk[0]), int(sol.status[0])
    if exact:
        assert status == 0 and kk < g["kk"]
    elif knife_edge:
        assert status in (0, 2) and float(sol.stat[0, kk - 1, 4]) < 3e-8
        if status == 2:
            _knife_edge_witness(factored[-1], qp.F, dims.NU)
    else:
        assert status == 0
    z, pi = _np(sol.z[0]), _np(sol.pi[0])
    for n in range(dims.N + 1):
        got = np.concatenate([z[n, :dims.nu[n]],
                              z[n, dims.NU:dims.NU + dims.nx[n]]])
        np.testing.assert_allclose(got, np.array(g["ux"][n]), rtol=1e-3,
                                   atol=5e-5, err_msg=f"ux {n}")
    for n in range(dims.N):
        np.testing.assert_allclose(pi[n, :dims.nx[n + 1]],
                                   np.array(g["pi"][n]), rtol=1e-3,
                                   atol=1e-4, err_msg=f"pi {n}")
