"""Partial and full condensing of the PyTorch port (``models.cond``) and the
pivoted LU (``ops.tri.getrf``/``getrs``), held against the JAX package on
the same inputs and against the reference C solver's golden files.

* ``getrf``/``getrs`` against JAX's on a seeded batch of 6x6 matrices (one
  with a zero first column below a zero pivot), to 1e-12;
* ``plan`` sizes (``tests/test_cond.py``'s twin) and every static field
  against JAX's plan for several N2;
* ``condense`` against JAX's at 1e-12 (the general-row problem nx=8 nu=3
  N=8 ng=2 ngN=4 at N2 = 4; full condensing, N2 = 1, is held against JAX
  through ``plan_dense`` in ``test_torch_dense.py``), and against the golden ``partcond_*``
  (matrix parity with ``d_part_cond``) and ``condlqcp_*`` files (full
  condensing against ``d_cond_lqcp``, with the two reference bugs that
  ``tests/test_cond.py`` documents, at its 1e-10);
* ``expand_solution`` against JAX's on the same condensed solution, and
  ``condense_rhs`` against a full recondense (1e-12);
* ``solve_partial_cond`` against the port's direct solve
  (``test_cond.py::_check``: z within 1e-6, pi within 1e-5, the expanded
  KKT residuals on the original problem) and ``solve_batched_partial_cond``
  against it per instance.

Every QP goes batch-first through the port; JAX's condense and expand run
under ``jax.jit`` on the unbatched QP (the plan static), compiled without
XLA's backend optimisations (tests/test_torch_ipm_structured.py's
``_FAST_COMPILE``).
"""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hpmpc_tpu.models import cond as jcond  # noqa: E402
from hpmpc_tpu.models import ipm as jipm  # noqa: E402
from hpmpc_tpu.ops import tri as jtri  # noqa: E402
from hpmpc_tpu.utils.mass_spring import mass_spring_qp as j_mass_spring  # noqa: E402
from hpmpc_tpu_torch.convert import QP_FIELDS, qp_from_numpy  # noqa: E402
from hpmpc_tpu_torch.models import cond, ipm  # noqa: E402
from hpmpc_tpu_torch.ocp import OCPDims, pack_ocp  # noqa: E402
from hpmpc_tpu_torch.ops import tri  # noqa: E402
from hpmpc_tpu_torch.utils.mass_spring import mass_spring_qp  # noqa: E402
from test_torch_ipm_structured import _FAST_COMPILE  # noqa: E402

torch.set_num_threads(1)
GOLDEN = pathlib.Path(__file__).parent / "golden"


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_qp(dims, qp_j, B=1):
    """The JAX QP's leaves as the port's batch of ``B`` copies."""
    return qp_from_numpy(dims, {f: np.broadcast_to(
        np.asarray(getattr(qp_j, f)), (B,) + np.asarray(
            getattr(qp_j, f)).shape) for f in QP_FIELDS}, device="cpu")


def test_getrf_getrs_match_jax():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((4, 6, 6))
    A[3, :, 0] = 0.0          # a zero pivot column: multipliers stay 0
    A[3, 0, 0] = 0.0
    b = rng.standard_normal((4, 6))
    LU_j, piv_j = jtri.getrf(jnp.asarray(A))
    LU_t, piv_t = tri.getrf(torch.as_tensor(A))
    np.testing.assert_array_equal(_np(piv_t), np.asarray(piv_j))
    np.testing.assert_allclose(_np(LU_t), np.asarray(LU_j), rtol=0,
                               atol=1e-12)
    x_j = jtri.getrs(LU_j[:3], piv_j[:3], jnp.asarray(b[:3]))
    x_t = tri.getrs(LU_t[:3], piv_t[:3], torch.as_tensor(b[:3]))
    np.testing.assert_allclose(_np(x_t), np.asarray(x_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A[:3], _np(x_t)),
                               b[:3], atol=1e-12)


def test_cond_plan_sizes():
    """Group partition of d_part_cond_compute_problem_size
    (tests/test_cond.py::test_cond_plan_sizes), and every static field of
    the plan equal to JAX's."""
    dims, _ = mass_spring_qp(8, 3, 10, device="cpu")
    pl = cond.plan(dims, 3)
    assert pl.group_T == (4, 3, 3)
    assert pl.group_start == (0, 4, 7)
    d2 = pl.dims2
    assert (d2.nu[0], d2.nx[0], d2.nb[0], d2.ng[0], d2.nx[1]) == (
        12, 0, 12, 12, 8)
    dims_g, _ = mass_spring_qp(8, 3, 12, ng=2, ngN=4, device="cpu")
    for N2 in (1, 4, 5, 12):
        pj, pt = jcond.plan(dims_g, N2), cond.plan(dims_g, N2)
        for f in ("N2", "group_start", "group_T", "box_map", "gen_from_box",
                  "gen_from_gen"):
            assert getattr(pt, f) == getattr(pj, f), f
        for f in ("N", "nx", "nu", "nb", "ng", "idxb"):
            assert getattr(pt.dims2, f) == getattr(pj.dims2, f), f


def test_condense_matches_jax():
    N2 = 4
    dims, qp_j = j_mass_spring(8, 3, 8, ng=2, ngN=4)
    qp_t = _port_qp(dims, qp_j)
    q2j = jax.jit(jcond.condense, static_argnums=1,
                  compiler_options=_FAST_COMPILE)(qp_j, jcond.plan(dims, N2))
    q2t = cond.condense(qp_t, cond.plan(dims, N2))
    for f in QP_FIELDS:
        a, b = _np(getattr(q2t, f))[0], np.asarray(getattr(q2j, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=f)


@pytest.mark.parametrize(
    "name", ["partcond_ms_nx8_nu3_N12_N2_4",
             "partcond_ms_nx8_nu3_N30_N2_5_ngN8"])
def test_condense_golden_matrix_parity(name):
    """Matrix-level parity with the reference's d_part_cond
    (tests/test_cond.py's twin): condensed dynamics, cost (lower
    triangle), constraint rows, bounds, box indices and sizes, 1e-12."""
    d = json.loads((GOLDEN / f"{name}.json").read_text())
    c = d["config"]
    N, N2, nx, nu = c["N"], c["N2"], c["nx"], c["nu"]
    A = np.array(d["A"]).reshape(nx, nx, order="F")
    B = np.array(d["B"]).reshape(nx, nu, order="F")
    dims, qp = mass_spring_qp(nx, nu, N, ngN=d["ng2"][N2], A=A, B=B,
                              device="cpu")
    pl = cond.plan(dims, N2)
    qp2 = cond.condense(type(qp)(**{f: getattr(qp, f)[None]
                                    for f in QP_FIELDS}), pl)
    d2 = pl.dims2
    assert list(d2.nx) == d["nx2"] and list(d2.nu) == d["nu2"]
    assert list(d2.nb) == d["nb2"] and list(d2.ng) == d["ng2"]
    for g in range(N2 + 1):
        assert list(d2.idxb[g]) == d["idxb2"][g], f"idxb2 stage {g}"
    F2, b2, H2, g2, C2 = (_np(getattr(qp2, f))[0]
                          for f in ("F", "b", "H", "g", "C"))
    bnd = {f: _np(getattr(qp2, f))[0] for f in ("d_lb", "d_ub", "d_lg",
                                                "d_ug")}
    NU2 = d2.NU
    for g in range(N2 + 1):
        sel = list(range(d2.nu[g])) + [NU2 + i for i in range(d2.nx[g])]
        nux = len(sel)
        if g < N2:
            cols = d["nx2"][g + 1]
            BAbt = np.array(d["BAbt2"][g]).reshape(nux + 1, cols, order="F")
            np.testing.assert_allclose(F2[g][np.ix_(sel, range(cols))],
                                       BAbt[:-1], atol=1e-12)
            np.testing.assert_allclose(b2[g][:cols], BAbt[-1], atol=1e-12)
        RSQ = np.array(d["RSQrq2"][g]).reshape(nux + 1, nux, order="F")
        lo = np.tril_indices(nux)
        np.testing.assert_allclose(H2[g][np.ix_(sel, sel)][lo], RSQ[:-1][lo],
                                   atol=1e-12)
        np.testing.assert_allclose(g2[g][sel], RSQ[-1], atol=1e-12)
        ngg, nb2g = d["ng2"][g], d["nb2"][g]
        if ngg:
            DCt = np.array(d["DCt2"][g]).reshape(nux, ngg, order="F")
            np.testing.assert_allclose(C2[g][np.ix_(range(ngg), sel)].T, DCt,
                                       atol=1e-12)
        got = np.concatenate([bnd["d_lb"][g][:nb2g], bnd["d_ub"][g][:nb2g],
                              bnd["d_lg"][g][:ngg], bnd["d_ug"][g][:ngg]])
        np.testing.assert_allclose(got, np.array(d["d2"][g]), atol=1e-12)


@pytest.mark.parametrize("name", ["condlqcp_nx6_nu2_N8",
                                  "condlqcp_nx8_nu3_N12"])
def test_full_condensing_golden_lqcp(name):
    """Full condensing (N2=1) against the reference's d_cond_lqcp
    (tests/test_cond.py's twin, 1e-10): R2/B2/b2 against alg=0, r2 against
    alg=2, in the reversed-u layout; the fixture's two reference bugs
    (alg=1's last block row of R2, alg=0/1's missing S Gamma_b gradient
    term) are present in the reference values and absent here."""
    d = json.loads((GOLDEN / f"{name}.json").read_text())
    c = d["config"]
    nx, nu, N = c["nx"], c["nu"], c["N"]
    Nnu = N * nu
    A, B, Q, R, S = (np.array(d[f"{k}_colmajor"]).reshape(shape, order="F")
                     for k, shape in (("A", (nx, nx)), ("B", (nx, nu)),
                                      ("Q", (nx, nx)), ("R", (nu, nu)),
                                      ("S", (nu, nx))))
    q, r, b, b0 = (np.array(d[k]) for k in ("q", "r", "b", "b0"))
    dims = OCPDims.create(N, nx=(0,) + (nx,) * N, nu=(nu,) * N + (0,),
                          nb=0, ng=0, idxb=[[] for _ in range(N + 1)])
    qp = pack_ocp(
        dims, A=[np.zeros((nx, 0))] + [A] * (N - 1), B=[B] * N,
        b=[b0] + [b] * (N - 1), Q=[np.zeros((0, 0))] + [Q] * N,
        S=[np.zeros((nu, 0))] + [S] * (N - 1) + [np.zeros((0, nx))],
        R=[R] * N + [np.zeros((0, 0))], q=[np.zeros(0)] + [q] * N,
        r=[r] * N + [np.zeros(0)], device="cpu")
    pl = cond.plan(dims, 1)
    qp2 = cond.condense(type(qp)(**{f: getattr(qp, f)[None]
                                    for f in QP_FIELDS}), pl)
    assert pl.dims2.nu[0] == Nnu and pl.dims2.nx[0] == 0
    R2_ref = np.array(d["R2_colmajor_alg0"]).reshape(Nnu, Nnu, order="F")
    R2_ref = np.tril(R2_ref) + np.tril(R2_ref, -1).T
    B2_ref = np.array(d["B2_colmajor_alg0"]).reshape(nx, Nnu, order="F")
    P = np.zeros((Nnu, Nnu))          # reversed-u -> natural order
    for i in range(N):
        P[i * nu:(i + 1) * nu, (N - 1 - i) * nu:(N - i) * nu] = np.eye(nu)
    H2, F2, b2, g2 = (_np(getattr(qp2, f))[0] for f in ("H", "F", "b", "g"))
    np.testing.assert_allclose(P @ H2[0][:Nnu, :Nnu] @ P.T, R2_ref,
                               atol=1e-10)
    np.testing.assert_allclose(P @ F2[0][:Nnu, :nx], B2_ref.T, atol=1e-10)
    np.testing.assert_allclose(b2[0][:nx], np.array(d["b2_alg0"]),
                               atol=1e-10)
    np.testing.assert_allclose(P @ g2[0][:Nnu], np.array(d["r2_alg2"]),
                               atol=1e-10)
    R2_alg1 = np.array(d["R2_colmajor_alg1"]).reshape(Nnu, Nnu, order="F")
    R2_alg1 = np.tril(R2_alg1) + np.tril(R2_alg1, -1).T
    assert np.abs((R2_alg1 - R2_ref)[(N - 1) * nu:, :]).max() > 1e-3
    # r2_alg0 = r2 - S Gamma_b: the omitted coupling term, recomputed
    cvec, omitted = np.zeros(nx), np.zeros(Nnu)
    for k in range(N):
        cvec = A @ cvec + (b0 if k == 0 else b)
        if k + 1 < N:
            omitted[(k + 1) * nu:(k + 2) * nu] = S @ cvec
    np.testing.assert_allclose(np.array(d["r2_alg0"]),
                               np.array(d["r2_alg2"]) - omitted, atol=1e-10)


def test_expand_and_condense_rhs_match():
    """expand_solution against JAX's on the same condensed solution (the
    port's, handed over as numpy), 1e-12; condense_rhs against a full
    recondense after b, g and bounds change (tests/test_cond.py's twin,
    the nx=8 nu=3 N=12 ng=2 ngN=4 problem), 1e-12.  The expansion runs on
    the feasible ng=2 problem without the terminal block."""
    dims, qp_j = j_mass_spring(8, 3, 12, ng=2)
    qp_t = _port_qp(dims, qp_j)
    pl_j, pl_t = jcond.plan(dims, 4), cond.plan(dims, 4)
    cfg = ipm.IPMConfig(k_max=30, mu_tol=1e-9)
    sol2 = ipm.solve(pl_t.dims2, cond.condense(qp_t, pl_t), cfg)
    assert int(sol2.status[0]) == 0
    exp_t = cond.expand_solution(qp_t, pl_t, sol2)
    sol2_j = jipm.IPMSolution(*[jnp.asarray(_np(x)[0]) for x in sol2])
    exp_j = jax.jit(jcond.expand_solution, static_argnums=1,
                    compiler_options=_FAST_COMPILE)(qp_j, pl_j, sol2_j)
    for f in exp_t._fields:
        np.testing.assert_allclose(_np(getattr(exp_t, f))[0],
                                   np.asarray(getattr(exp_j, f)), rtol=0,
                                   atol=1e-12, err_msg=f)

    dims, qp = mass_spring_qp(8, 3, 12, ng=2, ngN=4, device="cpu")
    qp_t = type(qp)(**{f: getattr(qp, f)[None] for f in QP_FIELDS})
    pl_t = cond.plan(dims, 4)
    q2 = cond.condense(qp_t, pl_t)
    new = {f: getattr(qp_t, f) for f in QP_FIELDS}
    new.update(b=qp_t.b * 1.1, g=qp_t.g + 0.05 * qp_t.z_mask,
               d_lb=qp_t.d_lb - 0.1 * qp_t.nb_mask,
               d_ug=qp_t.d_ug + 0.2 * qp_t.ng_mask)
    qp_new = type(qp_t)(**new)
    full = cond.condense(qp_new, pl_t)
    rhs = cond.condense_rhs(qp_new, pl_t, q2)
    for f in ("b", "g", "d_lb", "d_ub", "d_lg", "d_ug", "F", "H", "C"):
        np.testing.assert_allclose(_np(getattr(rhs, f)),
                                   _np(getattr(full, f)), rtol=0, atol=1e-12,
                                   err_msg=f)


@pytest.mark.parametrize("N2", [1, 2, 3, 5, 10])
def test_part_cond_matches_direct_box(N2):
    """Condense -> IPM -> expand against the direct solve
    (tests/test_cond.py::_check at nx=8 nu=3 N=10, mu_tol 1e-10)."""
    atol = 1e-6
    dims, qp = mass_spring_qp(8, 3, 10, device="cpu")
    qpb = type(qp)(**{f: getattr(qp, f)[None] for f in QP_FIELDS})
    cfg = ipm.IPMConfig(k_max=30, mu_tol=1e-10)
    sol_d = ipm.solve(dims, qpb, cfg)
    sol_e, sol2 = cond.solve_partial_cond(dims, qpb, cfg, N2)
    assert int(sol_d.status[0]) == 0 and int(sol2.status[0]) == 0
    np.testing.assert_allclose(_np(sol_e.z), _np(sol_d.z), atol=atol)
    np.testing.assert_allclose(_np(sol_e.pi), _np(sol_d.pi), atol=10 * atol)
    res = ipm.compute_residuals(qpb, ipm._box_onehot(qpb),
                                1.0 / dims.n_constr, *sol_e[:6])
    assert float(res.rq.abs().max()) < 100 * atol
    for r in (res.rb, res.rd_b, res.rd_g):
        assert float(r.abs().max()) < 10 * atol


def test_solve_batched_partial_cond_per_instance():
    """The batched pipeline (condensed batch through parallel.batch) gives
    each instance what its own solve_partial_cond gives (b scaled per
    instance)."""
    dims, qp = mass_spring_qp(8, 3, 10, device="cpu")
    sc = torch.tensor([1.0, 0.6, 1.3], dtype=torch.float64)
    qpb = type(qp)(**{f: getattr(qp, f).expand((3,) + getattr(qp, f).shape)
                      for f in QP_FIELDS})
    qpb = type(qp)(**{**{f: getattr(qpb, f) for f in QP_FIELDS},
                      "b": qpb.b * sc[:, None, None]})
    cfg = ipm.IPMConfig(k_max=30, mu_tol=1e-10)
    sol, sol2 = cond.solve_batched_partial_cond(dims, qpb, cfg, 3)
    for i in range(3):
        one = type(qp)(**{f: getattr(qpb, f)[i:i + 1] for f in QP_FIELDS})
        sol_i, _ = cond.solve_partial_cond(dims, one, cfg, 3)
        np.testing.assert_allclose(_np(sol.z)[i], _np(sol_i.z)[0], rtol=0,
                                   atol=1e-12)
        assert int(sol.kk[i]) == int(sol_i.kk[0])
