"""The flat tree engine of the PyTorch port and its three kernels (Queue 2
rows 26-28, ``hpmpc_tpu_torch.ops.tree_kernel``).

  (a) The plain versions (what the wrappers run on CPU tensors) vs the JAX
      package's Pallas tree kernels in interpret mode, float64, one
      1024-lane block, on the 7-node tree (md=2 Nr=1 Nh=3) with and
      without general rows (nodes 0 and 5), to 1e-12 of a field's scale.
      The stage width is NZ=3 (NU=1, NX=2): the interpret-mode compilation
      grows with the unrolled width.  Random SPD data; the retained factor
      handed to the re-solve is the plain factorization's.
  (b) float32: ``solve_batched_tree`` with ``use_pallas`` routes to the
      flat tree engine and matches ``tree.solve_tree_ipm_flat`` (interpret
      mode) at tests/test_tree_flat.py's tolerances: equal kk, z 5e-4, pi
      5e-3, stat 5e-4; the JAX engine compiled without XLA's backend
      optimisations (tests/test_torch_ipm_structured.py's ``jit_fast``).
      (The float64 flat engine is held against the f64
      structured JAX route in tests/test_torch_tree.py.)
  (c) the routing of ``solve_batched_tree``: float64, no ``use_pallas`` or
      ``iter_ref`` take the structured tree IPM, a warm start stays on the
      flat engine; and the engine's hook refuses the forms it does not
      serve.
  (d) examples/tree_mpc_torch.py, a few ticks on the CPU.
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from hpmpc_tpu.models import ipm as jipm  # noqa: E402
from hpmpc_tpu.models import tree as jtree  # noqa: E402
from hpmpc_tpu.ocp import OCPQP as JQP  # noqa: E402
from hpmpc_tpu.ops import stage_kernel as jsk  # noqa: E402
from hpmpc_tpu.ops import tree_kernel as jtk  # noqa: E402
from hpmpc_tpu.utils.mass_spring import (  # noqa: E402
    mass_spring_tree_qp as j_tree_qp)
from hpmpc_tpu_torch.models import ipm_lanes, tree  # noqa: E402
from hpmpc_tpu_torch.models.ipm import IPMConfig  # noqa: E402
from hpmpc_tpu_torch.ops import tree_kernel as tk  # noqa: E402
from hpmpc_tpu_torch.ops.layout import (  # noqa: E402
    from_lanes, sym_compress, to_lanes)
from hpmpc_tpu_torch.parallel import batch as tbatch  # noqa: E402
from hpmpc_tpu_torch.utils.mass_spring import mass_spring_tree_qp  # noqa: E402
from test_torch_ipm_structured import jit_fast  # noqa: E402

torch.set_num_threads(1)

BL = 1024
TDEF = tree.TreeDef.from_md_nr_nh(2, 1, 3)
N_NODES = TDEF.n_nodes


def _interpret():
    """pl.pallas_call in interpret mode while the block runs."""
    mp = pytest.MonkeyPatch.context()
    m = mp.__enter__()
    orig = pl.pallas_call
    m.setattr(pl, "pallas_call",
              lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    return mp


def _jl(x):
    """Port stream (..., B) -> the JAX lanes layout (nb, ..., 8, 128)."""
    a = np.asarray(x)
    a = a.reshape(a.shape[:-1] + (BL // jsk.BI, jsk.SUBS, jsk.LANES))
    return jnp.asarray(np.moveaxis(a, -3, 0))


def _jflat(x):
    """Port stream (n, k, B) -> JAX's flat (B, n*k)."""
    return jnp.asarray(from_lanes(x).reshape(x.shape[-1], -1).numpy())


def _unflat(y, shape):
    """JAX's flat (B, n*k) -> port stream (n, k, B)."""
    return np.moveaxis(np.asarray(y).reshape((BL,) + shape), 0, -1)


def _unlanes(y):
    """JAX lanes (nb, ..., 8, 128) -> port stream (..., B)."""
    a = np.moveaxis(np.asarray(y), 0, -3)
    return a.reshape(a.shape[:-3] + (BL,))


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale,
                               err_msg=what)


# ---------------------------------------------------------------------------
# (a) rows 26-28's plain versions vs the Pallas kernels
# ---------------------------------------------------------------------------

NU, NX = 1, 2
NZ = NU + NX
KS = dict(NU=NU, NZ=NZ, NX=NX)


@pytest.fixture(scope="module", params=[(), (0, 5)], ids=["no_ng", "ng"])
def kernel_case(request):
    """Random float64 inputs, the port's plain outputs, and the JAX
    kernels' outputs in interpret mode."""
    ng = request.param
    n = N_NODES
    rng = np.random.default_rng(26 + len(ng))

    def spd(*lead):
        A = rng.standard_normal(lead + (NZ, NZ))
        return np.einsum("...ij,...kj->...ik", A, A) / NZ

    T = lambda a: to_lanes(torch.as_tensor(a))  # noqa: E731
    p = dict(H=to_lanes(sym_compress(torch.as_tensor(spd(BL, n)
                                                     + np.eye(NZ)))),
             dvec=T(rng.uniform(0.1, 1.0, (BL, n, NZ))),
             ngl=(to_lanes(sym_compress(torch.as_tensor(spd(BL, len(ng)))))
                  if ng else None),
             g=T(rng.standard_normal((BL, n, NZ))),
             g2=T(rng.standard_normal((BL, n, NZ))),
             F=T(0.4 * rng.standard_normal((BL, n - 1, NZ, NX))),
             b=T(rng.standard_normal((BL, n - 1, NX))),
             z=T(rng.standard_normal((BL, n, NZ))),
             pi=T(rng.standard_normal((BL, n - 1, NX))))
    dad = TDEF.dad
    port = dict(
        fs=tk.tree_factor_solve_flat(dad, p["H"], p["dvec"], p["ngl"], ng,
                                     p["g"], p["F"], p["b"], want_pi=True,
                                     **KS))
    Ll, Lxx, Pb = port["fs"][2]
    port["fs_nopi"] = tk.tree_factor_solve_flat(
        dad, p["H"], p["dvec"], p["ngl"], ng, p["g"], p["F"], p["b"],
        want_pi=False, **KS)
    port["trs"] = tk.tree_solve_flat(dad, Ll, Lxx, Pb, p["g2"], p["F"],
                                     p["b"], **KS)
    port["res"] = tk.tree_resid_terms_flat(dad, p["H"], p["F"], p["z"],
                                           p["pi"], NZ=NZ, NX=NX)

    dad_arr = jnp.asarray(np.maximum(np.asarray(dad), 0).reshape(1, n),
                          jnp.int32)
    ngl_j = _jl(p["ngl"]) if ng else jnp.zeros(
        (BL // jsk.BI, 1, NZ * (NZ + 1) // 2, jsk.SUBS, jsk.LANES))
    mp = _interpret()
    try:
        # the wrappers' own jit caches: the second case recompiles only
        # what its ng nodes change
        jfs = jtk.tree_factor_solve_flat(
            dad_arr, _jl(p["H"]), _jflat(p["dvec"]), ngl_j, ng,
            _jflat(p["g"]), _jl(p["F"]), _jflat(p["b"]), NU, NZ, NX)
        jLl, jLxx, jPb = jfs[2]
        jtrs = jtk.tree_solve_flat(dad_arr, jLl, jLxx, jPb, _jflat(p["g2"]),
                                   _jl(p["F"]), _jflat(p["b"]), NU, NZ, NX)
        jres = jtk.tree_resid_terms_flat(dad_arr, _jl(p["H"]), _jl(p["F"]),
                                         _jflat(p["z"]), _jflat(p["pi"]),
                                         NZ, NX)
    finally:
        mp.__exit__(None, None, None)
    return port, dict(fs=jfs, trs=jtrs, res=jres)


def test_tree_factor_solve_flat_matches_jax(kernel_case):
    port, jax_ = kernel_case
    z, pi, (Ll, Lxx, Pb) = port["fs"]
    jz, jpi, (jLl, jLxx, jPb) = jax_["fs"]
    n = N_NODES
    _close(z, _unflat(jz, (n, NZ)), "z")
    _close(pi, _unflat(jpi, (n - 1, NX)), "pi")
    _close(Ll, _unlanes(jLl), "Ll")
    _close(Lxx, _unlanes(jLxx), "Lxx")
    _close(Pb, _unlanes(jPb), "Pb")
    # the WANT_PI=False form: the same z and factor, no pi
    z2, pi2, fs2 = port["fs_nopi"]
    assert pi2 is None
    torch.testing.assert_close(z2, z, rtol=0, atol=0)
    for a, b in zip(fs2, (Ll, Lxx, Pb)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_tree_solve_flat_matches_jax(kernel_case):
    port, jax_ = kernel_case
    (z, pi), (jz, jpi) = port["trs"], jax_["trs"]
    _close(z, _unflat(jz, (N_NODES, NZ)), "z")
    _close(pi, _unflat(jpi, (N_NODES - 1, NX)), "pi")


def test_tree_resid_terms_flat_matches_jax(kernel_case):
    port, jax_ = kernel_case
    (hz, fz, fpi), (jhz, jfz, jfpi) = port["res"], jax_["res"]
    n = N_NODES
    _close(hz, _unflat(jhz, (n, NZ)), "hz")
    _close(fz, _unflat(jfz, (n - 1, NX)), "fz")
    _close(fpi, _unflat(jfpi, (n - 1, NZ)), "fpi")


def test_wrappers_take_cpu_tensors_only_as_plain(kernel_case):
    """On CPU tensors each wrapper runs (and counts) its plain version;
    a tensor on another device type is refused, never solved on the
    CPU."""
    n0 = dict(tk.PLAIN_CALLS)
    p = torch.zeros(N_NODES, NZ, 4, dtype=torch.float64)
    H = torch.zeros(N_NODES, NZ * (NZ + 1) // 2, 4, dtype=torch.float64)
    F = torch.zeros(N_NODES - 1, NZ, NX, 4, dtype=torch.float64)
    pi = torch.zeros(N_NODES - 1, NX, 4, dtype=torch.float64)
    tk.tree_resid_terms_flat(TDEF.dad, H, F, p, pi, NZ=NZ, NX=NX)
    assert tk.PLAIN_CALLS["tree_resid_terms_flat"] == \
        n0["tree_resid_terms_flat"] + 1
    assert tk.LAUNCHES["tree_resid_terms_flat"] == 0
    with pytest.raises(ValueError, match="unsupported device"):
        tk.tree_resid_terms_flat(TDEF.dad, H.to("meta"), F.to("meta"),
                                 p.to("meta"), pi.to("meta"), NZ=NZ, NX=NX)


@pytest.mark.parametrize("md,Nr,Nh", [(2, 1, 3), (2, 3, 10), (3, 2, 4),
                                      (2, 7, 7), (2, 0, 12)],
                         ids=["7", "71", "md3", "255", "chain"])
def test_level_schedule(md, Nr, Nh):
    """The level schedule rows 26-27 read: the levels partition the nodes
    (JAX's ``TreeDef.levels``), each node's parent sits in the level before
    and each node's children are listed in descending id; the int32 table
    lays them out as csrc/tree_sweeps.cu's ``Sched`` reads them."""
    tdef = tree.TreeDef.from_md_nr_nh(md, Nr, Nh)
    dad, n = tdef.dad, tdef.n_nodes
    s = tk.level_schedule(dad)
    assert s.levels == jtree.TreeDef.from_md_nr_nh(md, Nr, Nh).levels
    assert sorted(k for lev in s.levels for k in lev) == list(range(n))
    level_of = {k: d for d, lev in enumerate(s.levels) for k in lev}
    assert s.levels[0] == (0,)
    assert all(level_of[dad[k]] == level_of[k] - 1 for k in range(1, n))
    assert all(s.levels[level_of[k]][s.pos[k]] == k for k in range(n))
    assert all(list(ch) == sorted((c for c in range(1, n) if dad[c] == k),
                                  reverse=True)
               for k, ch in enumerate(s.children))
    L = len(s.levels)
    tab = tk.schedule_table(dad)
    lev_off, rest = tab[:L + 1], tab[L + 1:]
    nodes, pos, dads = rest[:n], rest[n:2 * n], rest[2 * n:3 * n]
    ch_off, ch = rest[3 * n:4 * n + 1], rest[4 * n + 1:]
    assert len(ch) == n - 1 and ch_off[-1] == n - 1
    assert tuple(nodes[lev_off[d]:lev_off[d + 1]]
                 for d in range(L)) == s.levels
    assert pos == s.pos and dads == (0, *dad[1:])
    assert tuple(ch[ch_off[k]:ch_off[k + 1]] for k in range(n)) == s.children


# ---------------------------------------------------------------------------
# (b) float32: the flat tree engine vs JAX's
# ---------------------------------------------------------------------------

NG_NODES = (0, 5)


def _batch(dtype, n=BL, ng_nodes=NG_NODES, **kw):
    tdef, dims, qp = mass_spring_tree_qp(ng_nodes=ng_nodes, dtype=dtype,
                                         device="cpu", **kw)
    qpb = tbatch.broadcast_qp(qp, n)
    sc = torch.as_tensor(1 + 0.02 * np.random.default_rng(0)
                         .standard_normal(n), dtype=dtype)
    return tdef, dims, dataclasses.replace(qpb, b=qpb.b * sc[:, None, None])


def test_flat_tree_f32_matches_jax_flat():
    """``solve_batched_tree`` (float32, ``use_pallas``) -> the flat tree
    engine, against JAX's ``solve_tree_ipm_flat`` in interpret mode
    (tests/test_tree_flat.py's config and tolerances), on the one-mass
    plant (nx=2, nu=1: NZ=3, the interpret-mode compilation's width; the
    float64 engines are held to JAX at NZ=6 in tests/test_torch_tree.py)."""
    tdef, dims, qpb = _batch(torch.float32, nx=2, nu=1)
    cfg = IPMConfig(k_max=3, mu_tol=1e-4, use_pallas=True)
    n0 = dict(tk.PLAIN_CALLS)
    sol = tbatch.solve_batched_tree(tdef, dims, qpb, cfg)
    assert all(tk.PLAIN_CALLS[k] > n0[k] for k in n0), tk.PLAIN_CALLS

    jdef, jdims, _ = j_tree_qp(ng_nodes=NG_NODES, nx=2, nu=1,
                               dtype=jnp.float32)
    jqp = JQP(**{f.name: jnp.asarray(getattr(qpb, f.name).numpy())
                 for f in dataclasses.fields(JQP)})
    jcfg = jipm.IPMConfig(k_max=3, mu_tol=1e-4)
    mp = _interpret()
    try:
        jsol = jit_fast(jtree.solve_tree_ipm_flat, jdef, jdims, jqp, jcfg)
    finally:
        mp.__exit__(None, None, None)
    np.testing.assert_array_equal(sol.kk.numpy(), np.asarray(jsol.kk))
    np.testing.assert_allclose(sol.z.numpy(), np.asarray(jsol.z), atol=5e-4)
    np.testing.assert_allclose(sol.pi.numpy(), np.asarray(jsol.pi),
                               atol=5e-3)
    np.testing.assert_allclose(sol.stat.numpy(), np.asarray(jsol.stat),
                               atol=5e-4)


# ---------------------------------------------------------------------------
# (c) routing
# ---------------------------------------------------------------------------


def _ran(fn):
    n0 = dict(tk.PLAIN_CALLS)
    out = fn()
    return out, sum(tk.PLAIN_CALLS[k] - n0[k] for k in n0)


@pytest.mark.parametrize("case", ["f64", "no_pallas", "iter_ref"])
def test_solve_batched_tree_structured_routes(case):
    """float64, no ``use_pallas`` and ``iter_ref`` take the structured tree
    IPM (no tree kernel runs), and it is ``solve_tree_ipm``."""
    dtype = torch.float64 if case == "f64" else torch.float32
    tdef, dims, qpb = _batch(dtype, n=4)
    cfg = IPMConfig(k_max=4, mu_tol=1e-4, use_pallas=case != "no_pallas",
                    iter_ref=int(case == "iter_ref"))
    sol, ran = _ran(lambda: tbatch.solve_batched_tree(tdef, dims, qpb, cfg))
    assert ran == 0
    ref = tree.solve_tree_ipm(tdef, dims, qpb, cfg)
    for a, b in zip(sol, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_solve_batched_tree_warm_start_stays_flat():
    """A warm re-solve (tree RTI) with ``use_pallas`` in float32 runs the
    flat engine, agrees with a direct ``solve_tree_ipm_flat`` call, and
    converges in fewer iterations than the cold solve."""
    tdef, dims, qpb = _batch(torch.float32, n=8)
    cfg = IPMConfig(k_max=12, mu_tol=1e-4, use_pallas=True)
    cold, ran = _ran(lambda: tbatch.solve_batched_tree(tdef, dims, qpb, cfg))
    assert ran > 0
    cfg_w = dataclasses.replace(cfg, warm_start=True)
    qpw = dataclasses.replace(qpb, b=qpb.b * 1.001)
    warm, ran = _ran(lambda: tbatch.solve_batched_tree(
        tdef, dims, qpw, cfg_w, z0=cold.z, pi0=cold.pi))
    assert ran > 0
    direct = tree.solve_tree_ipm_flat(tdef, dims, qpw, cfg_w, z0=cold.z,
                                      pi0=cold.pi)
    for a, b in zip(warm, direct):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(warm.kk.max()) < int(cold.kk.min())
    assert bool((warm.status == 0).all())


def test_kkt_hook_refuses_other_forms():
    tdef, dims, qpb = _batch(torch.float64, n=2)
    hook = tree._flat_tree_kkt_factory(tdef)
    for kw in (dict(flat=False), dict(flat=True)):
        cfg = IPMConfig(k_max=2, use_pallas=True,
                        iter_ref=int(kw["flat"]))
        with pytest.raises(ValueError, match="kkt_factory"):
            ipm_lanes.solve_batched_lanes(dims, qpb, cfg, kkt_factory=hook,
                                          **kw)


# ---------------------------------------------------------------------------
# (d) the example
# ---------------------------------------------------------------------------


def test_example_tree_mpc_torch():
    """examples/tree_mpc_torch.py's closed loop, in-process on the CPU for
    3 ticks (its own asserts: every tick converges, the root input stays
    within its bound, and the bound is active on some tick)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "examples"))
    try:
        import tree_mpc_torch
    finally:
        sys.path.remove(str(root / "examples"))
    xn, sat = tree_mpc_torch.main(ticks=3, device="cpu")
    assert sat > 0 and np.isfinite(xn)
