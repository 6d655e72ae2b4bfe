"""The structured two-phase IPM of the PyTorch port (``models.ipm.solve``,
batch-native) vs ``jax.vmap(hpmpc_tpu.models.ipm.solve)`` on the same
batch (handed over through ``convert.qp_from_numpy``), and against the
reference C solver's golden stat trace.

Both KKT backends run: the plain batched Riccati and, with
``use_pallas``, the kernel backend, which on the CPU runs the plain
versions of ``stage_kernel.factor_solve_folded`` / ``solve_batched``
(Queue 2 rows 16 and 15; counted in ``PLAIN_CALLS``).  The JAX solve at
B=4 takes its XLA Riccati with or without ``use_pallas`` (its Pallas gate
wants 1024 instances): the same function, so each kernel-backend case is
held against the JAX solve of its config without ``use_pallas``, one
compilation less each.

Two sizes, float64, 4 instances with ``b`` scaled per instance: the
nx=8 nu=3 N=10 mass-spring problem (box constraints; the scales [1, 0.5,
0.25, 1.2] converge at kk 7, 7, 5, 7, so the batch mixes exit
iterations), and the 2-mass chain (nx=4 nu=2) at N=16 with the ngN=4
terminal equality block (the shortest horizon tried on which the block
can be met; scales [1, 0.5, 0.7, 0.9], all converge).  Tolerances are
tests/test_ipm.py's: equal kk and status, stat rows rtol 1e-6 (atol
1e-9), z atol 1e-8 (pi 1e-7).

The configurations (~4-7 s each on this sandbox, nearly all of it the
JAX compilation; cached per module): the defaults, the kernel backend,
both correctors off (phase 1 without ``corrector_low``, phase 2 without
``corrector_high``), ``mu_switch`` 0 (phase 1 to mu_tol) and 1e3 (phase
2 from the start), ``iter_ref=1``, and a warm start from a perturbed
iterate with ``return_carry`` on the kernel backend (the JAX ``KKTCarry``
brought over with ``convert.carry_from_numpy``).  The unconstrained
route (``n_constr == 0``) and the golden ``ipm_ms_nx8_nu3_N10`` trace have
tests of their own.

The lanes engine's flat form (``ipm_lanes.solve_batched_lanes(flat=
True)``: the 6-kernel loop with the unfused refinement, rows 12 + 11) is
held against the same JAX solves on the ``ms`` batch, with ``_compare``'s
tolerances: the ``"flat"`` engine of ``solve_batched`` (float64
``use_pallas`` with a static ``idxb``) without and with ``iter_ref`` (the
JAX solves of ``defaults`` and ``iter_ref``), the unfused refinement on
the lanes engine (``HPMPC_FUSED_REFINE=0``) and the two-stage route with
the flat stage 2 (``HPMPC_STAGE2_LANES=0``), both against ``iter_ref``;
and the ``"flat"`` engine without and with ``iter_ref`` under
``HPMPC_FUSED_SWEEPS=1``, on the same JAX solves.  The wrappers' call
counters show the route: rows 11/12 run, the fused pass (row 13) and the
mega kernels (rows 19/20) do not; under the switch the re-solve takes the
fused sweep (row 17) and, without ``iter_ref``, so does the factorization
(row 18), in place of rows 10 and 9.  The JAX references are compiled without XLA's
backend optimisations (``_FAST_COMPILE``: no fast-math either way).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import golden_ab, load_golden  # noqa: E402
from hpmpc_tpu.models import ipm as jipm  # noqa: E402
from hpmpc_tpu.utils.mass_spring import mass_spring_qp as j_mass_spring  # noqa: E402
from hpmpc_tpu_torch.convert import QP_FIELDS, carry_from_numpy, qp_from_numpy  # noqa: E402
from hpmpc_tpu_torch.models import ipm, ipm_lanes  # noqa: E402
from hpmpc_tpu_torch.ops import mega_kernel as mk  # noqa: E402
from hpmpc_tpu_torch.ops import stage_kernel as sk  # noqa: E402
from hpmpc_tpu_torch.parallel import batch as tbatch  # noqa: E402
from hpmpc_tpu_torch.parallel.batch import broadcast_qp  # noqa: E402
from hpmpc_tpu_torch.utils.mass_spring import mass_spring_qp  # noqa: E402

torch.set_num_threads(1)

SIZES = {"ms": ((8, 3, 10, 0), [1.0, 0.5, 0.25, 1.2]),
         "chain": ((4, 2, 16, 4), [1.0, 0.5, 0.7, 0.9])}
CASES = {
    "defaults": ("ms", {}),
    "kernels": ("ms", dict(use_pallas=True)),
    "chain": ("chain", {}),
    "chain_kernels": ("chain", dict(use_pallas=True)),
    "correctors_off": ("ms", dict(corrector_low=False, corrector_high=False)),
    "mu_switch_0": ("ms", dict(mu_switch=0.0)),
    "mu_switch_1e3": ("ms", dict(mu_switch=1e3)),
    "iter_ref": ("ms", dict(iter_ref=1)),
    "warm_carry_kernels": ("ms", dict(use_pallas=True, warm_start=True)),
}


def _twin(size):
    """The same scaled batch for both packages: (dims, jax qp, port qp)."""
    (nx, nu, N, ngN), sc = SIZES[size]
    sc = np.asarray(sc)
    dims, qp = j_mass_spring(nx, nu, N, ngN=ngN)
    qpb = jax_batch(qp, len(sc), b=sc)
    qpt = qp_from_numpy(dims, {f: np.asarray(getattr(qpb, f))
                               for f in QP_FIELDS}, device="cpu")
    return dims, qpb, qpt


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _compare(sol_t, sol_j):
    np.testing.assert_array_equal(_np(sol_t.kk), _np(sol_j.kk))
    np.testing.assert_array_equal(_np(sol_t.status), _np(sol_j.status))
    np.testing.assert_allclose(_np(sol_t.stat), _np(sol_j.stat), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(_np(sol_t.z), _np(sol_j.z), rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(sol_t.pi), _np(sol_j.pi), rtol=0,
                               atol=1e-7)
    for f in ("lam_b", "t_b", "lam_g", "t_g"):
        np.testing.assert_allclose(_np(getattr(sol_t, f)),
                                   _np(getattr(sol_j, f)), rtol=1e-6,
                                   atol=1e-8, err_msg=f)
    # |rq|_inf at convergence is roundoff of the multiplier products (1e-7
    # apart between summation orders, tests/test_ipm.py bounds it by 1e-5):
    # 1e-6 absolute; |rb|, |rd| and mu at the stat rows' tolerance
    res_t, res_j = _np(sol_t.inf_norm_res), _np(sol_j.inf_norm_res)
    np.testing.assert_allclose(res_t[:, 0], res_j[:, 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(res_t[:, 1:], res_j[:, 1:], rtol=1e-6,
                               atol=1e-9)
    for f in sol_t._fields:
        assert _np(getattr(sol_t, f)).shape == _np(getattr(sol_j, f)).shape


_JAX = {}
_FAST_COMPILE = {"xla_backend_optimization_level": 0}


def jax_batch(tree, B, **scales):
    """The JAX QP or soft spec ``tree`` tiled to ``B`` instances, each field
    named in ``scales`` multiplied per instance by its (B,) factors in the
    field's dtype: the arrays of ``jbatch.broadcast_qp`` and ``x *
    jnp.asarray(s, x.dtype)[:, None, None]``, built in numpy and handed to
    JAX leaf by leaf (eagerly, JAX compiles one small program per leaf
    shape for the tiling)."""
    tiled = jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x), (B,) + np.shape(x)), tree)
    for f, sc in scales.items():
        x = getattr(tiled, f)
        tiled = dataclasses.replace(tiled, **{f: x * np.asarray(
            sc, x.dtype).reshape((B,) + (1,) * (x.ndim - 1))})
    return jax.tree_util.tree_map(jnp.asarray, tiled)


def jit_fast(f, *args, **kw):
    """``f(*args, **kw)`` under ``jax.jit``, compiled with
    ``_FAST_COMPILE``: the array leaves of the arguments are traced, every
    other leaf (static sizes, flags, configs) is closed over.  The JAX
    references of the port's tests run through it: XLA's backend
    optimisations change how fast the reference compiles, not what it
    computes (no fast-math either way)."""
    return jit_fast_each(lambda a, k: f(*a, **k), [(args, kw)])[0]


def jit_fast_each(f, argsets):
    """``[f(*args) for args in argsets]`` through one :func:`jit_fast`
    compilation, made for the first set: the sets differ only in the
    values of their array leaves."""
    leaves, tree = jax.tree_util.tree_flatten(argsets[0])
    is_arr = [isinstance(x, (jax.Array, np.ndarray)) for x in leaves]

    def arrays(args):
        lv, tr = jax.tree_util.tree_flatten(args)
        assert tr == tree
        return [x for x, m in zip(lv, is_arr) if m]

    def g(*xs):
        it = iter(xs)
        return f(*jax.tree_util.tree_unflatten(
            tree, [next(it) if m else x for x, m in zip(leaves, is_arr)]))

    fn = jax.jit(g).lower(*arrays(argsets[0])).compile(_FAST_COMPILE)
    return [fn(*arrays(args)) for args in argsets]


def _jax_solve(dims, qpb, size, kw, z0, pi0, carry):
    """``jax.vmap(ipm.solve)`` of the case's config without ``use_pallas``
    (see the module doc), compiled once per module."""
    kw = {k: v for k, v in kw.items() if k != "use_pallas"}
    key = (size, tuple(sorted(kw.items())), carry)
    if key not in _JAX:
        cfg = jipm.IPMConfig(**kw)
        warm = z0 is not None

        def one(q, zz, pp):
            return jipm.solve(dims, q, cfg, z0=zz, pi0=pp,
                              return_carry=carry)

        axes = 0 if warm else None
        args = (qpb, None if z0 is None else jnp.asarray(z0),
                None if pi0 is None else jnp.asarray(pi0))
        _JAX[key] = jax.jit(jax.vmap(one, in_axes=(0, axes, axes))).lower(
            *args).compile(_FAST_COMPILE)(*args)
    return _JAX[key]


@pytest.mark.parametrize("case", list(CASES))
def test_structured_solve_matches_jax(case):
    size, kw = CASES[case]
    dims, qpb, qpt = _twin(size)
    carry = case.startswith("warm_carry")
    z0 = pi0 = None
    if kw.get("warm_start"):
        rng = np.random.default_rng(3)
        z0 = 0.1 * rng.standard_normal(qpt.g.shape)
        pi0 = 0.1 * rng.standard_normal(qpt.b.shape)
    out_j = _jax_solve(dims, qpb, size, kw, z0, pi0, carry)
    cfg_t = ipm.IPMConfig(**kw)

    n0 = dict(sk.PLAIN_CALLS)
    out_t = ipm.solve(dims, qpt, cfg_t,
                      z0=None if z0 is None else torch.as_tensor(z0),
                      pi0=None if pi0 is None else torch.as_tensor(pi0),
                      return_carry=carry)
    ran = {k: sk.PLAIN_CALLS[k] - n0[k]
           for k in ("factor_solve_folded", "solve_batched")}
    if kw.get("use_pallas") and not kw.get("iter_ref"):
        assert min(ran.values()) >= 1, ran
    else:
        assert max(ran.values()) == 0, ran

    sol_j, sol_t = (out_j[0], out_t[0]) if carry else (out_j, out_t)
    _compare(sol_t, sol_j)
    if case == "defaults":
        assert len(set(_np(sol_t.kk).tolist())) > 1   # mixed exit iterations
    if carry:
        carry_j = carry_from_numpy({f: np.asarray(getattr(out_j[1], f))
                                    for f in jipm.KKTCarry._fields},
                                   device="cpu")
        for f, a, b in zip(carry_j._fields, out_t[1], carry_j):
            assert a.shape == b.shape, f
            scale = max(1.0, float(b.abs().max()))
            np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                       atol=1e-8 * scale, err_msg=f)


_FLAT_ROWS = ("resid_terms_flat", "solve_flat_pb", "refine_flat_fused",
              "factor_solve_folded_flat", "solve_flat",
              "factor_solve_folded_flat_fused", "solve_flat_fused")
_FUSED = {"HPMPC_FUSED_SWEEPS": "1"}
# case: (config beside use_pallas, environment)
FLAT_CASES = {
    "flat": ({}, {}),
    "flat_iter_ref": (dict(iter_ref=1), {}),
    "unfused_refine": (dict(iter_ref=1), {"HPMPC_FUSED_REFINE": "0"}),
    "flat_stage2": (dict(iter_ref=1, iter_ref_mu_thr=1e-3),
                    {"HPMPC_STAGE2_LANES": "0"}),
    "flat_fused": ({}, _FUSED),
    "flat_iter_ref_fused": (dict(iter_ref=1), _FUSED),
}


def _flat_counts():
    return ({k: sk.PLAIN_CALLS[k] for k in _FLAT_ROWS},
            {k: sum(v) for k, v in mk.PLAIN_CALLS.items()})


@pytest.mark.parametrize("case", list(FLAT_CASES))
def test_flat_form_matches_jax(monkeypatch, case):
    kw, env = FLAT_CASES[case]
    for k in ("HPMPC_RESIDENT", "HPMPC_LANES_LOOP", "HPMPC_MEGA_SWEEPS",
              "HPMPC_FUSED_REFINE", "HPMPC_STAGE2_LANES",
              "HPMPC_FUSED_SWEEPS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    dims, qpb, qpt = _twin("ms")
    B = qpt.g.shape[0]
    cfg = ipm.IPMConfig(use_pallas=True, **kw)
    n0 = _flat_counts()
    if case == "unfused_refine":
        sol_t = ipm_lanes.solve_batched_lanes(dims, qpt, cfg)
    elif case == "flat_stage2":
        assert tbatch.select_engine(dims, cfg, B, torch.float32) == \
            "two_stage_resident"
        sol_t = tbatch._solve_two_stage(dims, qpt, cfg, "two_stage_lanes",
                                        None, None)
    else:
        assert tbatch.select_engine(dims, cfg, B, torch.float64) == "flat"
        sol_t = tbatch.solve_batched(dims, qpt, cfg)
    n1 = _flat_counts()
    ran = {k: n1[0][k] - n0[0][k] for k in _FLAT_ROWS}
    ran_mega = {k: n1[1][k] - n0[1][k] for k in n1[1]}
    assert ran["refine_flat_fused"] == 0, ran
    if case != "flat_stage2":      # stage 1 of the two-stage route is mega
        assert max(ran_mega.values()) == 0, ran_mega
    # the factorization and the re-solve, once an iteration: rows 9 and 10,
    # or under the switch row 17 and (without iter_ref) row 18
    fused = bool(env.get("HPMPC_FUSED_SWEEPS"))
    factor = ("factor_solve_folded_flat_fused"
              if fused and not kw.get("iter_ref")
              else "factor_solve_folded_flat")
    resolve = "solve_flat_fused" if fused else "solve_flat"
    assert ran[factor] == ran[resolve] >= 1, ran
    assert sum(ran[k] for k in _FLAT_ROWS[3:]) == 2 * ran[factor], ran
    if kw.get("iter_ref"):
        # one unfused pass after each of the two solves of an iteration
        assert (ran["resid_terms_flat"] == ran["solve_flat_pb"]
                == 2 * ran[factor]), ran
    else:
        assert ran["resid_terms_flat"] == ran["solve_flat_pb"] == 0, ran
    kw_j = {k: v for k, v in kw.items() if k != "iter_ref_mu_thr"}
    sol_j = _jax_solve(dims, qpb, "ms", kw_j, None, None, False)
    _compare(sol_t, sol_j)
    assert bool((sol_t.status == 0).all())
    assert len(set(_np(sol_t.kk).tolist())) > 1   # mixed exit iterations


def test_unconstrained_route_matches_jax():
    """n_constr == 0 (no box or general rows): one Riccati solve, kk 0,
    status 0, with the retained factor."""
    dims, qpb, qpt = _twin("ms")
    N = dims.N
    dims0 = dataclasses.replace(dims, nb=(0,) * (N + 1), ng=(0,) * (N + 1),
                                idxb=None)
    assert dims0.n_constr == 0
    cfg = dict(k_max=5)
    sol_j, car_j = jax.jit(jax.vmap(lambda q: jipm.solve(
        dims0, q, jipm.IPMConfig(**cfg), return_carry=True)))(qpb)
    sol_t, car_t = ipm.solve(dims0, qpt, ipm.IPMConfig(**cfg),
                             return_carry=True)
    for f in sol_t._fields:
        a, b = _np(getattr(sol_t, f)), _np(getattr(sol_j, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10, err_msg=f)
    np.testing.assert_allclose(_np(car_t.L), _np(car_j.L), rtol=0,
                               atol=1e-12)


def test_golden_stat_trace():
    """The reference C solver's ipm_ms_nx8_nu3_N10 run, iteration for
    iteration (tests/test_ipm.py's tolerances), on both backends."""
    g = load_golden("ipm_ms_nx8_nu3_N10")
    c = g["config"]
    A, Bm = golden_ab(g)
    dims, qp = mass_spring_qp(c["nx"], c["nu"], c["N"], ng=c["ng"],
                              ngN=c["ngN"], A=A, B=Bm, device="cpu")
    qpb = broadcast_qp(qp, 1)
    stat_ref = np.array(g["stat"]).reshape(-1, 5)[:g["kk"]]
    for use_pallas in (False, True):
        sol = ipm.solve(dims, qpb, ipm.IPMConfig(
            k_max=c["k_max"], mu0=c["mu0"], mu_tol=c["mu_tol"],
            alpha_min=c["alpha_min"], use_pallas=use_pallas))
        assert int(sol.kk[0]) == g["kk"]
        assert int(sol.status[0]) == 0
        np.testing.assert_allclose(_np(sol.stat[0])[:g["kk"]], stat_ref,
                                   rtol=1e-6, atol=1e-9)
        z = _np(sol.z[0])
        for n in range(dims.N + 1):
            got = np.concatenate([z[n, :dims.nu[n]],
                                  z[n, dims.NU:dims.NU + dims.nx[n]]])
            np.testing.assert_allclose(got, np.array(g["ux"][n]), rtol=0,
                                       atol=1e-8, err_msg=f"ux {n}")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", ["ipm_ms_nx16_nu1_N30",
                                  "ipm_ms_nx8_nu3_N30_ng2_ngN8"])
def test_golden_ipm_runs(name, use_pallas):
    """The reference C solver's runs on the (16, 1) chain and on the
    flagship with two general rows on every stage and the ngN=8 terminal
    block, on both KKT backends, at tests/test_ipm.py:37-80's tolerances:
    kk, the stat trace, ux, pi, and the multipliers and slacks in the
    file's order (lb, ub, lg, ug)."""
    g = load_golden(name)
    c = g["config"]
    A, Bm = golden_ab(g)
    dims, qp = mass_spring_qp(c["nx"], c["nu"], c["N"], ng=c["ng"],
                              ngN=c["ngN"], A=A, B=Bm, device="cpu")
    sol = ipm.solve(dims, broadcast_qp(qp, 1), ipm.IPMConfig(
        k_max=c["k_max"], mu0=c["mu0"], mu_tol=c["mu_tol"],
        alpha_min=c["alpha_min"], use_pallas=use_pallas))
    assert int(sol.kk[0]) == g["kk"]
    assert int(sol.status[0]) == 0
    stat_ref = np.array(g["stat"]).reshape(-1, 5)[:g["kk"]]
    np.testing.assert_allclose(_np(sol.stat[0])[:g["kk"]], stat_ref,
                               rtol=1e-6, atol=1e-9)
    z, pi = _np(sol.z[0]), _np(sol.pi[0])
    for n in range(dims.N + 1):
        got = np.concatenate([z[n, :dims.nu[n]],
                              z[n, dims.NU:dims.NU + dims.nx[n]]])
        np.testing.assert_allclose(got, np.array(g["ux"][n]), rtol=0,
                                   atol=1e-8, err_msg=f"ux {n}")
    for n in range(dims.N):
        np.testing.assert_allclose(pi[n, :dims.nx[n + 1]],
                                   np.array(g["pi"][n]), rtol=0, atol=1e-7,
                                   err_msg=f"pi {n}")
    for n in range(dims.N + 1):
        nbn, ngn = dims.nb[n], dims.ng[n]
        if not nbn + ngn:
            continue
        for field, ref in (("lam", g["lam"][n]), ("t", g["t"][n])):
            b_, g_ = (_np(getattr(sol, f"{field}_{k}")[0, n])
                      for k in ("b", "g"))
            got = np.concatenate([b_[0, :nbn], b_[1, :nbn], g_[0, :ngn],
                                  g_[1, :ngn]])
            np.testing.assert_allclose(got, np.array(ref), rtol=1e-6,
                                       atol=1e-8, err_msg=f"{field} {n}")


def test_iterate0_and_rti_mode_raise():
    """``rti_mode`` and ``iterate0`` no longer raise (ported with
    ``solve_single_newton``; held against JAX in test_torch_ipm_rti.py):
    rti_mode skips phase 1 and runs exactly k_max residual-phase
    iterations with no tolerance exit, per instance; iterate0 starts from
    the given iterate."""
    dims, _, qpt = _twin("ms")
    sol = ipm.solve(dims, qpt, ipm.IPMConfig(k_max=3, mu_tol=1.0),
                    rti_mode=True)
    assert bool((sol.kk == 3).all())
    assert all(bool(torch.isfinite(x).all()) for x in sol
               if x.is_floating_point())
    it = (sol.z, sol.pi, sol.lam_b, sol.t_b, sol.lam_g, sol.t_g)
    sol0 = ipm.solve(dims, qpt, ipm.IPMConfig(k_max=0), iterate0=it,
                     rti_mode=True)
    for a, b in zip(sol0[:6], it):
        assert torch.equal(a, b)
