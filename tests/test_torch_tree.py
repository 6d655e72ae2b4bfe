"""The scenario-tree model of the PyTorch port (``hpmpc_tpu_torch.models.
tree``, ``utils.mass_spring.mass_spring_tree_qp``) against the JAX package.

  (a) ``mass_spring_tree_qp``: the arrays equal JAX's, and the ``TreeDef``
      node count follows the reference's formula.
  (b) ``tree_factor_solve``, ``tree_resolve`` and ``tree_residuals`` match
      JAX (``jax.vmap`` under ``jax.jit``) in float64 to 1e-12 of each
      field's scale, on random SPD node Hessians.
  (c) ``solve_tree_ipm`` matches ``jax.jit(jax.vmap(tree.solve_tree_ipm))``
      in float64, cold and warm: equal kk and status, stat rtol 1e-6, z
      within 1e-8, pi within 1e-7; and the flat tree engine
      (``solve_tree_ipm_flat``, float64, on the tree kernels' plain
      versions) matches the same JAX solves at the same tolerances.
  (d) a chain-shaped tree (every node one child) on the flat tree engine
      reproduces the chain's flat form, whose residuals come from
      ``resid_full``.

The tree is JAX's test tree (md=2 Nr=1 Nh=3: 7 nodes, nx=4 nu=2, NZ=6)
with a general row on nodes 0 and 5; the JAX compilations are shared
through module-scoped fixtures and made without XLA's backend
optimisations (``_FAST_COMPILE``, as tests/test_torch_ipm_structured.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hpmpc_tpu.models import ipm as jipm  # noqa: E402
from hpmpc_tpu.models import tree as jtree  # noqa: E402
from hpmpc_tpu.ocp import OCPQP as JQP  # noqa: E402
from hpmpc_tpu.utils.mass_spring import (  # noqa: E402
    mass_spring_tree_qp as j_tree_qp)
from hpmpc_tpu_torch.models import ipm as tipm  # noqa: E402
from hpmpc_tpu_torch.models import ipm_lanes, tree  # noqa: E402
from hpmpc_tpu_torch.ops import stage_kernel as sk  # noqa: E402
from hpmpc_tpu_torch.ops import tree_kernel as tk  # noqa: E402
from hpmpc_tpu_torch.parallel import batch as tbatch  # noqa: E402
from hpmpc_tpu_torch.utils.mass_spring import (  # noqa: E402
    mass_spring_qp, mass_spring_tree_qp)
from test_torch_ipm_structured import _FAST_COMPILE, jit_fast  # noqa: E402

torch.set_num_threads(1)

B = 6
NG_NODES = (0, 5)
# the reference's IPM test tolerances (ROADMAP Queue 3)
TOL = dict(z=1e-8, pi=1e-7, stat_rtol=1e-6)


def _scales(n=B, seed=0):
    return 1 + 0.02 * np.random.default_rng(seed).standard_normal(n)


def _port_batch(dtype=torch.float64, ng_nodes=NG_NODES, n=B, **kw):
    tdef, dims, qp = mass_spring_tree_qp(ng_nodes=ng_nodes, dtype=dtype,
                                         device="cpu", **kw)
    qpb = tbatch.broadcast_qp(qp, n)
    sc = torch.as_tensor(_scales(n), dtype=dtype)
    return tdef, dims, dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])


def _jax_batch(qpb):
    """The port's batch as a JAX OCPQP (same numbers)."""
    return JQP(**{f.name: jnp.asarray(getattr(qpb, f.name).numpy())
                  for f in dataclasses.fields(JQP)})


def _close(got, want, rtol_scale, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol_scale * scale,
                               err_msg=what)


# ---------------------------------------------------------------------------
# (a) the fixture and the topology
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("md,Nr,Nh", [(2, 1, 3), (2, 3, 10), (3, 2, 4),
                                      (2, 7, 7)])
def test_treedef_node_count(md, Nr, Nh):
    """``from_md_nr_nh``: (Nh-Nr) md^Nr + (md^{Nr+1}-1)/(md-1) nodes,
    breadth-first (dad[k] < k), levels as JAX's."""
    td = tree.TreeDef.from_md_nr_nh(md, Nr, Nh)
    assert td.n_nodes == (Nh - Nr) * md ** Nr + (md ** (Nr + 1) - 1) // (
        md - 1)
    assert td.dad[0] == -1 and all(0 <= td.dad[k] < k
                                   for k in range(1, td.n_nodes))
    jd = jtree.TreeDef.from_md_nr_nh(md, Nr, Nh)
    assert td.dad == jd.dad and td.levels == jd.levels
    assert td.depth == jd.depth and max(td.depth) == Nh


@pytest.mark.parametrize("kw", [dict(), dict(md=2, Nr=3, Nh=10,
                                             ng_nodes=(0, 5))])
def test_mass_spring_tree_qp_matches_jax(kw):
    tdef, dims, qp = mass_spring_tree_qp(dtype=torch.float64, device="cpu",
                                         **kw)
    jdef, jdims, jqp = j_tree_qp(dtype=jnp.float64, **kw)
    assert tdef.dad == jdef.dad
    for f in ("N", "nx", "nu", "nb", "ng"):
        assert getattr(dims, f) == getattr(jdims, f), f
    assert [list(map(int, i)) for i in dims.idxb] == [
        list(map(int, i)) for i in jdims.idxb]
    for f in dataclasses.fields(JQP):
        a, b = getattr(qp, f.name).numpy(), np.asarray(getattr(jqp, f.name))
        assert a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert qp.dtype == torch.float64 and qp.idxb.dtype == torch.int32


# ---------------------------------------------------------------------------
# (b) the level-batched pieces
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pieces():
    """Random float64 KKT data on the 7-node tree, the port's pieces and
    JAX's (vmap under jit)."""
    tdef, dims, qpb = _port_batch()
    NU, NZ, NX, n = dims.NU, dims.NZ, dims.NX, tdef.n_nodes
    rng = np.random.default_rng(7)
    Hs = rng.standard_normal((B, n, NZ, NZ))
    H_eff = np.einsum("bnij,bnkj->bnik", Hs, Hs) / NZ + np.eye(NZ)
    g1, g2 = (rng.standard_normal((B, n, NZ)) for _ in range(2))
    rb = rng.standard_normal((B, n - 1, NX))
    z = rng.standard_normal((B, n, NZ))
    pi = rng.standard_normal((B, n - 1, NX))
    lam_b = rng.uniform(0.1, 1, (B, n, 2, dims.NB))
    t_b = rng.uniform(0.1, 1, (B, n, 2, dims.NB))
    lam_g = rng.uniform(0.1, 1, (B, n, 2, dims.NG))
    t_g = rng.uniform(0.1, 1, (B, n, 2, dims.NG))
    T = torch.as_tensor

    z_p, pi_p, fac = tree.tree_factor_solve(tdef, qpb, T(H_eff), T(g1),
                                            T(rb), NU)
    z2_p, pi2_p = tree.tree_resolve(tdef, qpb, fac, T(g2), T(rb), NU)
    oh = tipm._box_onehot(qpb)
    res_p = tree.tree_residuals(tdef, qpb, oh, T(np.float64(0.1)), T(z),
                                T(pi), T(lam_b), T(t_b), T(lam_g), T(t_g),
                                T(rb))

    jdef = jtree.TreeDef(dad=tdef.dad)

    def one(q, He, g1, g2, rb, z, pi, lb, tb, lg, tg):
        z1, pi1, f = jtree.tree_factor_solve(jdef, q, He, g1, rb, NU)
        z2, pi2 = jtree.tree_resolve(jdef, q, f, g2, rb, NU)
        res = jtree.tree_residuals(jdef, q, jipm._box_onehot(q), 0.1, z, pi,
                                   lb, tb, lg, tg, rb)
        return z1, pi1, f, z2, pi2, res

    out_j = jit_fast(jax.vmap(one), _jax_batch(qpb), H_eff, g1, g2, rb, z,
                     pi, lam_b, t_b, lam_g, t_g)
    return (z_p, pi_p, fac, z2_p, pi2_p, res_p), out_j


def test_tree_factor_solve_matches_jax(pieces):
    (z, pi, fac, *_), (jz, jpi, jf, *_) = pieces
    _close(z, jz, 1e-12, "z")
    _close(pi, jpi, 1e-12, "pi")
    for name in ("L", "eu", "px", "Pb"):
        _close(getattr(fac, name), getattr(jf, name), 1e-12, name)


def test_tree_resolve_matches_jax(pieces):
    (_, _, _, z2, pi2, _), (_, _, _, jz2, jpi2, _) = pieces
    _close(z2, jz2, 1e-12, "z")
    _close(pi2, jpi2, 1e-12, "pi")


def test_tree_residuals_matches_jax(pieces):
    (*_, res), (*_, jres) = pieces
    for name in ("rq", "rb", "rd_b", "rd_g", "rm_b", "rm_g", "mu"):
        _close(getattr(res, name), getattr(jres, name), 1e-12, name)


# ---------------------------------------------------------------------------
# (c) the tree IPM, structured and flat, float64, cold and warm
# ---------------------------------------------------------------------------


CFG = dict(k_max=20, mu_tol=1e-10)


@pytest.fixture(scope="module")
def ipm_case():
    """The port's batch and JAX's cold and warm solves (warm: b scaled by
    1.01, from the cold solution).  One compilation serves both: a warm
    start from z0 = 0, pi0 = 0 is the cold start (``init_vars`` starts
    from zero either way)."""
    tdef, dims, qpb = _port_batch()
    jdef, jdims, _ = j_tree_qp(ng_nodes=NG_NODES, dtype=jnp.float64)
    jqp = _jax_batch(qpb)
    cfg_w = jipm.IPMConfig(warm_start=True, **CFG)
    n = tdef.n_nodes
    args = (jqp, jnp.zeros((B, n, dims.NZ)), jnp.zeros((B, n - 1, dims.NX)))
    solve = jax.jit(jax.vmap(
        lambda q, z, p: jtree.solve_tree_ipm(jdef, jdims, q, cfg_w, z0=z,
                                             pi0=p))).lower(*args).compile(
        _FAST_COMPILE)
    sol_c = solve(*args)
    sol_w = solve(dataclasses.replace(jqp, b=jqp.b * 1.01), sol_c.z,
                  sol_c.pi)
    return tdef, dims, qpb, sol_c, sol_w


def _check_sol(sol, jsol, what):
    np.testing.assert_array_equal(sol.kk.numpy(), np.asarray(jsol.kk),
                                  err_msg=what)
    np.testing.assert_array_equal(sol.status.numpy(),
                                  np.asarray(jsol.status), err_msg=what)
    np.testing.assert_allclose(sol.stat.numpy(), np.asarray(jsol.stat),
                               rtol=TOL["stat_rtol"], atol=1e-12,
                               err_msg=what)
    np.testing.assert_allclose(sol.z.numpy(), np.asarray(jsol.z), rtol=0,
                               atol=TOL["z"], err_msg=what)
    np.testing.assert_allclose(sol.pi.numpy(), np.asarray(jsol.pi), rtol=0,
                               atol=TOL["pi"], err_msg=what)


def _solve(route, tdef, dims, qpb, cfg, z0=None, pi0=None):
    fn = tree.solve_tree_ipm if route == "structured" else \
        tree.solve_tree_ipm_flat
    return fn(tdef, dims, qpb, cfg, z0=z0, pi0=pi0)


@pytest.mark.parametrize("route", ["structured", "flat"])
def test_solve_tree_ipm_cold_matches_jax(ipm_case, route):
    tdef, dims, qpb, sol_c, _ = ipm_case
    n0 = dict(tk.PLAIN_CALLS)
    sol = _solve(route, tdef, dims, qpb, tipm.IPMConfig(**CFG))
    _check_sol(sol, sol_c, f"{route} cold")
    assert bool((sol.status == 0).all())
    ran = {k: tk.PLAIN_CALLS[k] - n0[k] for k in n0}
    if route == "flat":
        assert all(v > 0 for v in ran.values()), ran
    else:
        assert not any(ran.values()), ran


@pytest.mark.parametrize("route", ["structured", "flat"])
def test_solve_tree_ipm_warm_matches_jax(ipm_case, route):
    tdef, dims, qpb, sol_c, sol_w = ipm_case
    qpw = dataclasses.replace(qpb, b=qpb.b * 1.01)
    cfg = tipm.IPMConfig(warm_start=True, **CFG)
    sol = _solve(route, tdef, dims, qpw, cfg,
                 z0=torch.tensor(np.asarray(sol_c.z)),
                 pi0=torch.tensor(np.asarray(sol_c.pi)))
    _check_sol(sol, sol_w, f"{route} warm")
    # the warm start from a nearby solution takes fewer iterations
    assert int(sol.kk.max()) < int(np.asarray(sol_c.kk).min())


# ---------------------------------------------------------------------------
# (d) a chain as a tree
# ---------------------------------------------------------------------------


def test_chain_shaped_tree_matches_chain_flat_form():
    """A tree whose every node has one child is the chain: the flat tree
    engine (rows 26-28's plain versions through the ``kkt_factory`` hook,
    the hook's residual assembly) reproduces the chain's flat form (rows
    9-10 and ``resid_full``), float64, on the chain mass-spring problem
    with general rows on stages 1..N-1."""
    N, n = 6, 5
    dims, qp = mass_spring_qp(4, 2, N, ng=1, device="cpu")
    qpb = tbatch.broadcast_qp(qp, n)
    sc = torch.as_tensor(_scales(n, seed=3))
    qpb = dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])
    chain = tree.TreeDef(dad=(-1,) + tuple(range(N)))
    cfg = tipm.IPMConfig(k_max=25, use_pallas=True)
    n_sk = sk.PLAIN_CALLS["factor_solve_folded_flat"]
    sol_t = tree.solve_tree_ipm_flat(chain, dims, qpb, cfg)
    assert sk.PLAIN_CALLS["factor_solve_folded_flat"] == n_sk
    sol_c = ipm_lanes.solve_batched_lanes(dims, qpb, cfg, flat=True)
    assert sk.PLAIN_CALLS["factor_solve_folded_flat"] > n_sk
    np.testing.assert_array_equal(sol_t.kk.numpy(), sol_c.kk.numpy())
    np.testing.assert_array_equal(sol_t.status.numpy(), sol_c.status.numpy())
    assert bool((sol_c.status == 0).all())
    np.testing.assert_allclose(sol_t.z.numpy(), sol_c.z.numpy(), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(sol_t.pi.numpy(), sol_c.pi.numpy(), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(sol_t.inf_norm_res.numpy(),
                               sol_c.inf_norm_res.numpy(), rtol=1e-6,
                               atol=1e-12)
