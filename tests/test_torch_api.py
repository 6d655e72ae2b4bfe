"""The public API of the PyTorch port (``hpmpc_tpu_torch.api``): the twins
of ``tests/test_api.py`` on the CPU (``device="cpu"``; ``device=None`` is
the card), held against the reference C solver's golden files and, where
the JAX package computes the same thing, against it on the same inputs.

* ``solve_ocp`` against the golden ``ipm_ms_nx8_nu3_N30_ngN8`` (kk equal,
  ux within 1e-8, stat rtol 1e-6, atol 1e-9); the ``N2`` path against the
  direct solve (1e-6); the c-order twin (1e-12); time-varying nx against a
  dense KKT solve (1e-7); the rejected inconsistent B; ``pack_problem``
  against JAX's leaf for leaf (exact: both pack in float64 numpy);
* ``work_space_size_bytes`` with and without condensing, equal to JAX's;
* the session: ``solve_new_rhs`` at the solution and for a new b, the RTI
  step along an x0 sequence, the warm start (``tests/test_api.py``'s
  tolerances);
* ``OCPSession.dense_tick`` with ``use_kernel=False`` (the plain
  reference) and with the kernel's plain version (a CPU session), against
  fresh solves (2e-3, the JAX test's);
* ``solve_ocp_soft`` against JAX's ``solve_ocp_soft`` (same kk, status and
  stat trace (rtol 1e-5), x/u within 1e-6, the residual norms within
  ``tests/test_ipm_soft.py``'s bounds and mu to 1e-4), the soft
  session's warm re-solve and its N2 path (``tests/test_ipm_soft.py``'s);
* the printers.

``tests/test_api.py::test_solver_cache_no_recompile`` (and the soft
front door's twin) have no counterpart: PyTorch runs eagerly and the port
keeps no compiled-solver cache.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import golden_ab, load_golden  # noqa: E402
from hpmpc_tpu import api as japi  # noqa: E402
from hpmpc_tpu_torch import api  # noqa: E402
from hpmpc_tpu_torch.convert import QP_FIELDS  # noqa: E402
from hpmpc_tpu_torch.models import ipm  # noqa: E402
from hpmpc_tpu_torch.ops import dense_kernel as dk  # noqa: E402
from hpmpc_tpu_torch.utils import printing  # noqa: E402
from hpmpc_tpu_torch.utils.mass_spring import (mass_spring_ab,  # noqa: E402
                                               mass_spring_data,
                                               mass_spring_qp)

torch.set_num_threads(1)
CPU = dict(device="cpu")


def _ux(res):
    return [np.concatenate([u, x]) for u, x in zip(res.u, res.x)]


def _small_ms(N=10):
    return mass_spring_data(8, 3, N)


def test_solve_ocp_matches_golden():
    g = load_golden("ipm_ms_nx8_nu3_N30_ngN8")
    c = g["config"]
    A, B = golden_ab(g)
    data = mass_spring_data(c["nx"], c["nu"], c["N"], ngN=c["ngN"], A=A, B=B)
    res = api.solve_ocp(**data, k_max=c["k_max"], mu0=c["mu0"],
                        mu_tol=c["mu_tol"], alpha_min=c["alpha_min"], **CPU)
    assert res.status == 0 and res.kk == g["kk"]
    for n, got in enumerate(_ux(res)):
        np.testing.assert_allclose(got, np.array(g["ux"][n]), atol=1e-8,
                                   err_msg=f"stage {n}")
    assert res.inf_norm_res[3] <= c["mu_tol"]
    stat_ref = np.array(g["stat"]).reshape(-1, 5)[:g["kk"]]
    np.testing.assert_allclose(res.stat, stat_ref, rtol=1e-6, atol=1e-9)


def test_solve_ocp_partial_condensing_path():
    data = mass_spring_data(8, 3, 12)
    full = api.solve_ocp(**data, mu_tol=1e-10, **CPU)
    part = api.solve_ocp(**data, mu_tol=1e-10, N2=3, **CPU)
    assert part.status == 0
    for a, b in zip(_ux(part), _ux(full)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    with pytest.raises(ValueError, match="warm_start"):
        api.solve_ocp(**data, N2=3, warm_start=full, **CPU)


def test_pack_problem_matches_jax():
    """Leaf for leaf the JAX package's packing (x0 eliminated, general
    rows, a terminal block): both assemble in float64 numpy."""
    data = mass_spring_data(8, 3, 6, ngN=4)
    dims_j, qp_j = japi.pack_problem(**data)
    dims_t, qp_t = api.pack_problem(**data, **CPU)
    for f in ("N", "nx", "nu", "nb", "ng", "idxb"):
        assert getattr(dims_t, f) == getattr(dims_j, f), f
    for f in QP_FIELDS:
        np.testing.assert_array_equal(getattr(qp_t, f).numpy(),
                                      np.asarray(getattr(qp_j, f)),
                                      err_msg=f)


@pytest.mark.skipif(not api.native_available(),
                    reason="native packing library not built "
                           "(native/build.sh)")
def test_native_packing_matches_numpy():
    dims, qp = mass_spring_qp(8, 3, 10, device="cpu")
    A, B = mass_spring_ab(8, 3)
    x0 = np.r_[2.5, 2.5, np.zeros(6)]
    b_l = [0.1 * np.ones(8) + A @ x0] + [0.1 * np.ones(8)] * 9
    F, bb = api.pack_dynamics_native(dims, [np.zeros((8, 0))] + [A] * 9,
                                      [B] * 10, b_l)
    np.testing.assert_array_equal(F, qp.F.numpy())
    np.testing.assert_array_equal(bb, qp.b.numpy())


def test_work_space_size_bytes():
    """Positive, the numpy formulas', JAX's; with N2 < N the condensed
    problem's (and N2 = N the identity)."""
    n_bytes = api.work_space_size_bytes(30, 8, 3, nb=7, ng=0, k_max=30)
    assert n_bytes > 0
    assert n_bytes == japi.work_space_size_bytes(30, 8, 3, nb=7, ng=0,
                                                 k_max=30)
    saved = api._native
    try:
        api._native = None
        assert api.work_space_size_bytes(30, 8, 3, nb=7, ng=0,
                                         k_max=30) == n_bytes
    finally:
        api._native = saved
    full = api.work_space_size_bytes(30, 8, 3, nb=7)
    cnd = api.work_space_size_bytes(30, 8, 3, nb=7, N2=5)
    assert full > 0 and cnd > 0 and cnd != full
    assert cnd == japi.work_space_size_bytes(30, 8, 3, nb=7, N2=5)
    assert api.work_space_size_bytes(30, 8, 3, nb=7, N2=30) == full


def test_c_order_api_matches_fortran_order():
    nx, nu, N = 6, 2, 8
    A, B = mass_spring_ab(nx, nu, 0.5)
    S = 0.1 * np.random.default_rng(3).standard_normal((nu, nx))
    kw = dict(idxb=[np.arange(nu + nx // 2)] * (N + 1),
              lb=[np.r_[-0.5 * np.ones(nu), -4.0 * np.ones(nx // 2)]]
              * (N + 1),
              ub=[np.r_[0.5 * np.ones(nu), 4.0 * np.ones(nx // 2)]] * (N + 1),
              x0=np.r_[2.5, 2.5, np.zeros(nx - 2)], **CPU)
    b, q, r = ([0.1 * np.ones(nx)] * N, [0.1 * np.ones(nx)] * (N + 1),
               [0.2 * np.ones(nu)] * (N + 1))
    rf = api.solve_ocp(N, [A] * N, [B] * N, b, [np.eye(nx)] * (N + 1),
                       [S] * (N + 1), [2 * np.eye(nu)] * (N + 1), q, r, **kw)
    rc = api.solve_ocp_c_order(N, [A.T] * N, [B.T] * N, b,
                               [np.eye(nx)] * (N + 1), [S.T] * (N + 1),
                               [2 * np.eye(nu)] * (N + 1), q, r, **kw)
    assert rc.kk == rf.kk and rc.status == rf.status == 0
    for a, b_ in zip(_ux(rc), _ux(rf)):
        np.testing.assert_allclose(a, b_, atol=1e-12)


def _tv_nx_problem():
    """Time-varying state sizes nx=[2, 4, 2, 3] (tests/test_api.py's)."""
    rng = np.random.default_rng(7)
    nx, nu, N = [2, 4, 2, 3], [1, 2, 1], 3
    A_l = [rng.standard_normal((nx[n + 1], nx[n])) * 0.4 for n in range(N)]
    B_l = [rng.standard_normal((nx[n + 1], nu[n])) for n in range(N)]
    b_l = [0.05 * rng.standard_normal(nx[n + 1]) for n in range(N)]
    Q_l = [np.eye(nx[n]) for n in range(N + 1)]
    S_l = [np.zeros((nu[n], nx[n])) for n in range(N)] + [np.zeros((0, nx[N]))]
    R_l = [2.0 * np.eye(nu[n]) for n in range(N)] + [np.zeros((0, 0))]
    q_l = [0.1 * np.ones(nx[n]) for n in range(N + 1)]
    r_l = [0.2 * np.ones(nu[n]) for n in range(N)] + [np.zeros(0)]
    return N, nx, nu, A_l, B_l, b_l, Q_l, S_l, R_l, q_l, r_l


def test_solve_ocp_time_varying_nx():
    """tv-nx through the front door against a dense KKT solve."""
    N, nx, nu, A_l, B_l, b_l, Q_l, S_l, R_l, q_l, r_l = _tv_nx_problem()
    res = api.solve_ocp(N, A_l, B_l, b_l, Q_l, S_l, R_l, q_l, r_l,
                        mu_tol=1e-10, **CPU)
    nz = [nu[n] + nx[n] for n in range(N)] + [nx[N]]
    off = np.cumsum([0] + nz)
    H, gv = np.zeros((off[-1],) * 2), np.zeros(off[-1])
    for n in range(N + 1):
        o, un = off[n], (nu[n] if n < N else 0)
        if un:
            H[o:o + un, o:o + un] = R_l[n]
            gv[o:o + un] = r_l[n]
        H[o + un:o + nz[n], o + un:o + nz[n]] = Q_l[n]
        gv[o + un:o + nz[n]] = q_l[n]
    ne = sum(nx[1:])
    E, ev, ro = np.zeros((ne, off[-1])), np.zeros(ne), 0
    for n in range(N):
        o = off[n]
        E[ro:ro + nx[n + 1], o:o + nu[n]] = B_l[n]
        E[ro:ro + nx[n + 1], o + nu[n]:o + nz[n]] = A_l[n]
        x1 = off[n + 1] + (nu[n + 1] if n + 1 < N else 0)
        E[ro:ro + nx[n + 1], x1:x1 + nx[n + 1]] = -np.eye(nx[n + 1])
        ev[ro:ro + nx[n + 1]] = -b_l[n]
        ro += nx[n + 1]
    KKT = np.block([[H, E.T], [E, np.zeros((ne, ne))]])
    sol = np.linalg.solve(KKT, np.concatenate([-gv, ev]))
    for n, got in enumerate(_ux(res)):
        assert res.x[n].shape == (nx[n],)
        np.testing.assert_allclose(got, sol[off[n]:off[n] + nz[n]],
                                   atol=1e-7, err_msg=f"stage {n}")


def test_pack_problem_rejects_inconsistent_B():
    N, nx, nu, A_l, B_l, b_l, Q_l, S_l, R_l, q_l, r_l = _tv_nx_problem()
    B_bad = list(B_l)
    B_bad[1] = np.zeros((nx[1], nu[1]))  # nx[1] rows where stage 2 has nx[2]
    with pytest.raises(ValueError, match="rows but stage"):
        api.pack_problem(N, A_l, B_bad, b_l, Q_l, S_l, R_l, q_l, r_l, **CPU)


def test_session_new_rhs_fixed_point_and_new_b():
    """solve_new_rhs keeps a converged solution for unchanged vectors, and
    tracks a fresh solve for a new b (tests/test_api.py: 1e-7, 2e-4)."""
    data = _small_ms()
    res, sess = api.solve_ocp(**data, mu_tol=1e-10, return_session=True,
                              **CPU)
    for a, b in zip(_ux(sess.solve_new_rhs()), _ux(res)):
        np.testing.assert_allclose(a, b, atol=1e-7)
    b_new = [bb + 0.003 for bb in data["b"]]
    quick = sess.solve_new_rhs(b=b_new)
    fresh = api.solve_ocp(**{**data, "b": b_new}, mu_tol=1e-10, **CPU)
    for a, b in zip(_ux(quick), _ux(fresh)):
        np.testing.assert_allclose(a, b, atol=2e-4)


def test_session_single_newton_and_warm_solve():
    """One RTI step per new x0 stays near the converged solution (5e-3 on
    u0, tests/test_api.py); the warm full re-solve matches a fresh solve
    (1e-6) and the warm start saves iterations."""
    data = _small_ms()
    _, sess = api.solve_ocp(**data, mu_tol=1e-10, return_session=True, **CPU)
    rng = np.random.default_rng(3)
    x0 = data["x0"]
    for _ in range(3):
        x0 = x0 + 0.01 * rng.standard_normal(8)
        rti = sess.single_newton(k=1, x0=x0)
        assert rti.kk == 1
        fresh = api.solve_ocp(**{**data, "x0": x0}, mu_tol=1e-10, **CPU)
        np.testing.assert_allclose(rti.u[0], fresh.u[0], atol=5e-3)
    warm = sess.solve(x0=x0)
    assert warm.status == 0 and warm.kk <= fresh.kk
    for a, b in zip(_ux(warm), _ux(fresh)):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_warm_start_converges_and_saves_iterations():
    data = _small_ms()
    cold = api.solve_ocp(**data, mu_tol=1e-8, **CPU)
    x0b = data["x0"] + 0.02
    warm = api.solve_ocp(**{**data, "x0": x0b}, mu_tol=1e-8, warm_start=cold,
                         **CPU)
    fresh = api.solve_ocp(**{**data, "x0": x0b}, mu_tol=1e-8, **CPU)
    assert warm.status == 0 and warm.kk <= fresh.kk
    for a, b in zip(warm.x, fresh.x):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_session_dense_tick(use_kernel):
    """OCPSession.dense_tick: the plan is built and cached on first use;
    ticks with new b agree with fresh solves' controls (2e-3,
    tests/test_api.py).  ``use_kernel=True`` on a CPU session runs the
    kernel's plain version (one call a tick); False the plain reference."""
    data = _small_ms()
    res, sess = api.solve_ocp(**data, mu_tol=1e-5, return_session=True,
                              **CPU)
    n0 = dk.PLAIN_CALLS
    u0, r0 = sess.dense_tick(use_kernel=use_kernel)
    assert int(r0.status) == 0
    np.testing.assert_allclose(u0, res.u[0], atol=2e-3)
    plan = sess._dense_plan
    b_new = [bb + 0.003 for bb in data["b"]]
    fresh = api.solve_ocp(**{**data, "b": b_new}, mu_tol=1e-5, **CPU)
    u1, r1 = sess.dense_tick(use_kernel=use_kernel, b=b_new)
    assert sess._dense_plan is plan and int(r1.status) == 0
    np.testing.assert_allclose(u1, fresh.u[0], atol=2e-3)
    assert dk.PLAIN_CALLS - n0 == (2 if use_kernel else 0)
    # the tick's b-only packing is the full repack's offsets, bit for bit
    x0_new = data["x0"] * 0.9
    for vec in (dict(b=b_new), dict(x0=x0_new), dict(b=b_new, x0=x0_new)):
        torch.testing.assert_close(sess._tick_bflat(**vec),
                                   sess._repack(**vec).b.reshape(-1),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="geometry"):
        _, s2 = api.solve_ocp(**{**data, "x0": None}, return_session=True,
                              **CPU)
        s2.dense_tick(x0=data["x0"])


def _soft_data(nx=4, nu=2, N=6, seed=1):
    """tests/test_ipm_soft.py's soft front-door problem (hard input boxes,
    soft bounds on two states of stages 1..N)."""
    rng = np.random.default_rng(seed)
    A = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx))
    B = rng.standard_normal((nx, nu)) * 0.3
    ns = 2
    return dict(
        N=N, A=[A] * N, B=[B] * N, b=[0.05 * np.ones(nx)] * N,
        Q=[np.eye(nx)] * (N + 1),
        S=[np.zeros((nu, nx))] * N + [np.zeros((0, nx))],
        R=[np.eye(nu)] * N + [np.zeros((0, 0))],
        q=[0.1 * np.ones(nx)] * (N + 1), r=[0.1 * np.ones(nu)] * N
        + [np.zeros(0)],
        idxb=[np.arange(nu)] * N + [np.zeros(0, dtype=np.int32)],
        lb=[-2.0 * np.ones(nu)] * N + [np.zeros(0)],
        ub=[2.0 * np.ones(nu)] * N + [np.zeros(0)],
        idxs=[np.zeros(0, dtype=np.int32)] + [np.arange(nu, nu + ns)] * N,
        lbs=[np.zeros(0)] + [-0.3 * np.ones(ns)] * N,
        ubs=[np.zeros(0)] + [0.3 * np.ones(ns)] * N,
        Zs=[np.zeros(0)] + [10.0 * np.ones(ns)] * N,
        zs=[np.zeros(0)] + [100.0 * np.ones(ns)] * N, x0=np.ones(nx))


def test_solve_ocp_soft_matches_jax():
    """Same kk and status; x and u within 1e-6, the stat trace within rtol
    1e-5 (the soft multipliers near convergence amplify the two summation
    orders: 1.4e-7 in one state and 1.2e-6 relative in one mu_aff entry at
    mu 1e-8 on this problem; ROADMAP Queue 3, "Soft multipliers near
    convergence")."""
    data = _soft_data()
    res_j = japi.solve_ocp_soft(**data, mu_tol=1e-8)
    res_t = api.solve_ocp_soft(**data, mu_tol=1e-8, **CPU)
    assert (res_t.kk, res_t.status) == (res_j.kk, res_j.status) == (
        res_j.kk, 0)
    for a, b in zip(_ux(res_t), _ux(res_j)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res_t.stat, res_j.stat, rtol=1e-5, atol=1e-9)
    # the residual norms: both within tests/test_ipm_soft.py's bounds
    # (stationarity is roundoff of the large soft multipliers: 3.2e-5
    # against 2.0e-5), mu to rtol 1e-4
    for r in (res_t.inf_norm_res, np.asarray(res_j.inf_norm_res)):
        assert r[0] < 1e-3 and r[1] < 1e-8 and r[2] < 1e-8 and r[3] < 1e-8
    np.testing.assert_allclose(res_t.inf_norm_res[3], res_j.inf_norm_res[3],
                               rtol=1e-4)


def test_soft_session_and_n2_path():
    """SoftOCPSession.solve for a new b matches a fresh cold solve (1e-6,
    at most one more iteration); the N2 path through the hard slack
    reformulation matches the plain soft solve (tests/test_ipm_soft.py:
    5e-6 on x and u, 5e-5 on pi)."""
    data = _soft_data()
    res0, sess = api.solve_ocp_soft(**data, mu_tol=1e-8, return_session=True,
                                    **CPU)
    b2 = [0.06 * np.ones(4)] * data["N"]
    warm = sess.solve(b=b2)
    cold = api.solve_ocp_soft(**{**data, "b": b2}, mu_tol=1e-8, **CPU)
    assert res0.status == warm.status == 0 and warm.kk <= cold.kk + 1
    for a, b in zip(_ux(warm), _ux(cold)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    plain = api.solve_ocp_soft(**data, mu_tol=1e-9, k_max=40, **CPU)
    n2 = api.solve_ocp_soft(**data, mu_tol=1e-9, k_max=40, N2=3, **CPU)
    assert plain.status == 0 and n2.status == 0
    for a, b in zip(_ux(n2), _ux(plain)):
        np.testing.assert_allclose(a, b, atol=5e-6)
    for a, b in zip(n2.pi, plain.pi):
        np.testing.assert_allclose(a, b, atol=5e-5)


def test_printing_utils():
    """The printers show the logical (padding-stripped) problem."""
    dims, qp = mass_spring_qp(4, 1, 3, device="cpu")
    buf = io.StringIO()
    printing.print_ocp_qp(dims, qp, file=buf)
    out = buf.getvalue()
    assert "stage 0" in out and "H=[R S'; S Q]" in out and "idxb" in out
    assert "F=[B';A'] (1x4)" in out     # nx[0]=0: (nu x nx1) = 1x4
    qpb = type(qp)(**{f: getattr(qp, f)[None] for f in QP_FIELDS})
    sol = ipm.solve(dims, qpb, ipm.IPMConfig(k_max=20))
    buf = io.StringIO()
    printing.print_solution(dims, sol, file=buf)
    out = buf.getvalue()
    assert "u[0]" in out and "pi[2]" in out and "status: 0" in out
