"""The soft kernels of the PyTorch port (``ops/step_kernel.py``:
``soft_prep_flat``, ``soft_alpha_sums_flat``, ``soft_corr_flat``;
``ops/mega_kernel.py``: ``factor_solve_soft_mega``, ``solve_soft_mega``)
vs the JAX package's Pallas kernels in interpret mode.

On the CPU the port's wrappers run their plain versions (counted in
``SOFT_PLAIN_CALLS``).  Inputs: one 1024-lane block, N=4, NZ=3 (NU=1,
NX=2: the interpret-mode compilation grows with the unrolled stage
width), NB=2, NS=2, float64, built once in numpy from a seed.  The soft
index table overlaps the box one (the scatters must add), stage 0 has no
soft rows and one other soft slot is padded; the masked slots keep random
multipliers and slacks, so every ``where(ms > 0, ...)`` guard is
exercised.  Each JAX call runs once (module fixture): the affine soft
alpha pass's directions feed both packages' corrector passes, the soft
factorization's outputs both packages' soft solve, so every comparison
is on identical inputs.  Cases: the alpha pass affine and corrector, the
corrector pass and the soft solve with ``exact`` True and False, the soft
pair with and without general-constraint rows (stages 1 and N).

Tolerance, of a field's largest magnitude: 1e-12 (float64, the same
arithmetic in another summation order, through five stages of a
well-conditioned factorization).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from hpmpc_tpu.ops import mega_kernel as jmk  # noqa: E402
from hpmpc_tpu.ops import stage_kernel as jsk  # noqa: E402
from hpmpc_tpu.ops import step_kernel as jstk  # noqa: E402
from hpmpc_tpu_torch.ops import mega_kernel as mk  # noqa: E402
from hpmpc_tpu_torch.ops import step_kernel as stk  # noqa: E402
from hpmpc_tpu_torch.ops.layout import sym_compress, to_lanes  # noqa: E402

torch.set_num_threads(1)

B, NP1, NZ, NU, NX, NB, NS = 1024, 5, 3, 1, 2, 2, 2
N = NP1 - 1
NT = NZ * (NZ + 1) // 2
SDIMS = dict(NB=NB, NS=NS, NZ=NZ)
MDIMS = dict(NB=NB, NS=NS, NU=NU, NZ=NZ, NX=NX)
TOL = 1e-12
# (exact, with_ng) of the soft solve; the factorization runs once per ng
SOLVE_CASES = [(True, False), (False, True)]


def _jl(x):
    """Port stream (..., B) -> the JAX lanes layout (nb, ..., 8, 128)."""
    a = np.asarray(x)
    a = a.reshape(a.shape[:-1] + (B // jsk.BI, jsk.SUBS, jsk.LANES))
    return np.moveaxis(a, -3, 0)


def _pt(a):
    """JAX lanes array (nb, ..., 8, 128) -> port stream (..., B)."""
    a = np.moveaxis(np.asarray(a), 0, -3)
    return torch.as_tensor(a.reshape(a.shape[:-3] + (B,)).copy())


def _problem(seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform
    mb = np.ones((B, NP1, 2 * NB))
    mb[:, -1, 1] = mb[:, -1, 1 + NB] = 0.0
    ms = np.ones((B, NP1, NS))
    ms[:, 0] = 0.0
    ms[:, 2, NS - 1] = 0.0
    soft_c = np.concatenate([
        -1.0 - u(0, 1, (B, NP1, NS)), 1.0 + u(0, 1, (B, NP1, NS)),
        u(0, 10, (B, NP1, 2 * NS)), u(0.5, 5, (B, NP1, 2 * NS))], -1)
    Hs = rng.standard_normal((B, NP1, NZ, NZ))
    H = np.einsum("bnij,bnkj->bnik", Hs, Hs) / NZ + 2.0 * np.eye(NZ)
    T = lambda a: to_lanes(torch.as_tensor(a, dtype=torch.float64))  # noqa
    p = {k: T(v) for k, v in dict(
        lam=u(0.1, 2.0, (B, NP1, 2 * NB)) * mb,
        t=u(0.1, 2.0, (B, NP1, 2 * NB)),
        A=rng.standard_normal((B, NP1, 2 * NB)), mb=mb,
        lam_s=u(0.1, 2.0, (B, NP1, 4 * NS)),
        t_s=u(0.1, 2.0, (B, NP1, 4 * NS)), soft_c=soft_c, ms=ms,
        base=rng.standard_normal((B, NP1, NZ)),
        pdreg=np.full((B, NP1, NZ), 1e-8),
        dz=rng.standard_normal((B, NP1, NZ)),
        dl0b=rng.standard_normal((B, NP1, 2 * NB)),
        dl2s=rng.standard_normal((B, NP1, 4 * NS)),
        F=0.4 * rng.standard_normal((B, N, NZ, NX)),
        b=rng.standard_normal((B, N, NX)),
        ngl=u(0.0, 0.2, (B, 2, NT)) * np.isin(
            np.arange(NT), [i * (i + 1) // 2 + i for i in range(NZ)]),
        ngadd=rng.standard_normal((B, 2, NZ))).items()}
    p["H"] = to_lanes(sym_compress(torch.as_tensor(H)))
    p["sm"] = torch.as_tensor(u(0.01, 0.2, (B,)))
    idx, idxs = np.zeros((NP1, NB), np.int32), np.zeros((NP1, NS), np.int32)
    for n in range(NP1):
        idx[n] = np.sort(rng.choice(NZ, size=NB, replace=False))
        if n:
            idxs[n] = np.sort(rng.choice(NZ, size=NS, replace=False))
    assert any(set(idx[n]) & set(idxs[n]) for n in range(1, NP1))
    p["idx"], p["idxs"] = torch.as_tensor(idx), torch.as_tensor(idxs)
    return p


def _soft_in(p):
    """The streams every soft pass takes, in the wrappers' order."""
    return [p[k] for k in ("idx", "idxs", "lam", "t", "A", "mb", "lam_s",
                           "t_s", "soft_c", "ms")]


def _ng(p, with_ng):
    return ((1, N), p["ngl"], p["ngadd"]) if with_ng else ((), None, None)


@pytest.fixture(scope="module")
def case():
    """The problem and every JAX call, run once in interpret mode."""
    p = _problem(40)
    J = lambda x: jnp.asarray(_jl(x))  # noqa: E731
    nb = B // jsk.BI
    soft = [jnp.asarray(p["idx"].numpy()), jnp.asarray(p["idxs"].numpy())] + [
        J(x) for x in _soft_in(p)[2:]]
    sm_l = jnp.asarray(
        p["sm"].numpy().reshape(-1, jsk.SUBS, jsk.LANES)[:, None])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        orig = pl.pallas_call
        mp.setattr(pl, "pallas_call",
                   lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        out["prep"] = jstk.soft_prep_flat(*soft, J(p["base"]), J(p["pdreg"]),
                                          **SDIMS)
        aff = jstk.soft_alpha_sums_flat(*soft[:2], J(p["dz"]), *soft[2:],
                                        None, None, corrector=False, **SDIMS)
        out["alpha", False] = aff
        out["alpha", True] = jstk.soft_alpha_sums_flat(
            *soft[:2], J(p["dz"]), *soft[2:], J(p["dl0b"]), J(p["dl2s"]),
            corrector=True, **SDIMS)
        for exact in (True, False):
            out["corr", exact] = jstk.soft_corr_flat(
                *soft, *aff[:4], sm_l, J(p["base"]), exact=exact, **SDIMS)
        for with_ng in (False, True):
            ids, ngl, ngadd = _ng(p, with_ng)
            if not with_ng:
                ngl = jnp.zeros((nb, 1, NT, jsk.SUBS, jsk.LANES))
                ngadd = jnp.zeros((nb, 1, NZ, jsk.SUBS, jsk.LANES))
            else:
                ngl, ngadd = J(ngl), J(ngadd)
            fac = jmk.factor_solve_soft_mega(
                *soft, J(p["base"]), J(p["pdreg"]), J(p["H"]), ngl, ngadd,
                ids, J(p["F"]), J(p["b"]), **MDIMS)
            out["factor", with_ng] = fac
            for exact in (True, False):
                if (exact, with_ng) in SOLVE_CASES:
                    out["solve", exact, with_ng] = jmk.solve_soft_mega(
                        *soft[:2], fac[1], *soft[2:], *fac[2:6], sm_l,
                        J(p["base"]), ngadd, ids, J(p["F"]), J(p["b"]),
                        exact=exact, **MDIMS)
    return p, out


def _close(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want[np.isfinite(want)]).max())
    np.testing.assert_allclose(_jl(got.numpy()), want, rtol=TOL,
                               atol=TOL * scale, err_msg=what)


def _calls(mod, name, fn):
    """Run ``fn`` and check it took the plain version once."""
    n0 = mod.SOFT_PLAIN_CALLS[name]
    out = fn()
    assert mod.SOFT_PLAIN_CALLS[name] == n0 + 1
    return out


def test_soft_prep_flat_matches_jax(case):
    p, out = case
    got = _calls(stk, "soft_prep_flat", lambda: stk.soft_prep_flat(
        *_soft_in(p), p["base"], p["pdreg"], **SDIMS))
    for name, g, w in zip(("dvec", "geff"), got, out["prep"]):
        _close(g, w, name)


@pytest.mark.parametrize("corrector", [False, True])
def test_soft_alpha_sums_flat_matches_jax(case, corrector):
    p, out = case
    dl = (p["dl0b"], p["dl2s"]) if corrector else (None, None)
    s = _soft_in(p)
    got = _calls(stk, "soft_alpha_sums_flat", lambda: stk.soft_alpha_sums_flat(
        *s[:2], p["dz"], *s[2:], *dl, corrector=corrector, **SDIMS))
    names = ("dtb", "dlb", "dts", "dls", "amin", "s0", "s1", "s2")
    for name, g, w in zip(names, got, out["alpha", corrector]):
        _close(g, w, name)


@pytest.mark.parametrize("exact", [True, False])
def test_soft_corr_flat_matches_jax(case, exact):
    p, out = case
    aff = [_pt(x) for x in out["alpha", False][:4]]
    got = _calls(stk, "soft_corr_flat", lambda: stk.soft_corr_flat(
        *_soft_in(p), *aff, p["sm"], p["base"], exact=exact, **SDIMS))
    for name, g, w in zip(("geff2", "dl2b", "dl2s"), got, out["corr", exact]):
        _close(g, w, name)
    if not exact:   # the dropped correction changes the gradient only
        _close(got[1], out["corr", True][1], "dl2b vs exact")
        assert not np.allclose(np.asarray(out["corr", True][0]),
                               np.asarray(out["corr", False][0]))


@pytest.mark.parametrize("with_ng", [False, True])
def test_factor_solve_soft_mega_matches_jax(case, with_ng):
    p, out = case
    ids, ngl, ngadd = _ng(p, with_ng)
    got = _calls(mk, "factor_solve_soft_mega",
                 lambda: mk.factor_solve_soft_mega(
                     *_soft_in(p), p["base"], p["pdreg"], p["H"], ngl, ngadd,
                     ids, p["F"], p["b"], **MDIMS))
    want = out["factor", with_ng]
    _close(got[0], want[0], "z")
    for name, g, w in zip(("Ll", "Lxx", "Pb"), got[1], want[1]):
        _close(g, w, name)
    names = ("dtb", "dlb", "dts", "dls", "amin", "s0", "s1", "s2")
    for name, g, w in zip(names, got[2:], want[2:]):
        _close(g, w, name)


@pytest.mark.parametrize("exact,with_ng", SOLVE_CASES)
def test_solve_soft_mega_matches_jax(case, exact, with_ng):
    p, out = case
    ids, _, ngadd = _ng(p, with_ng)
    fac = out["factor", with_ng]
    s = _soft_in(p)
    got = _calls(mk, "solve_soft_mega", lambda: mk.solve_soft_mega(
        *s[:2], tuple(_pt(x) for x in fac[1]), *s[2:],
        *[_pt(x) for x in fac[2:6]], p["sm"], p["base"], ngadd, ids, p["F"],
        p["b"], exact=exact, **MDIMS))
    names = ("z", "pi", "dt2b", "dl2b", "dt2s", "dl2s", "amin", "s0", "s1",
             "s2")
    for name, g, w in zip(names, got, out["solve", exact, with_ng]):
        _close(g, w, name)
