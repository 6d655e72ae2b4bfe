"""Mega-sweep kernels of the PyTorch port vs the JAX package's.

On the CPU the port's wrappers run their plain versions
(``factor_solve_mega_ref``, ``solve_mega_ref``); the JAX side is
``hpmpc_tpu.ops.mega_kernel`` in Pallas interpret mode, float32, on
tests/test_mega_kernel.py's tiny problem (B=1024, N=3, NZ=5, NB=2) built
once in numpy from a seed.  Each JAX call runs once per case (module
fixture): the factor call's outputs also feed both packages' solve call,
so the solve is compared on identical inputs.

Tolerance: float32 roundoff of two summation orders, rtol 1e-5 and an
absolute floor of 1e-5 times the largest magnitude of the field.
tests/test_mega_kernel.py holds rtol 1e-5 / atol 1e-6..1e-4 between two
JAX compositions that share every helper and so sum in the same order;
the port's plain versions sum the stage products in torch's order, which
leaves up to ~4e-7 of the field's scale (Pb 1.9e-5 at |Pb| 78, the
corrector's s2 2.2e-3 at 4875) and ~2.5e-6 in the alpha minimum (a ratio
of two rounded values), measured on these inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from hpmpc_tpu.ops import mega_kernel as jmk  # noqa: E402
from hpmpc_tpu.ops import stage_kernel as jsk  # noqa: E402
from hpmpc_tpu_torch.ops import mega_kernel as mk  # noqa: E402
from hpmpc_tpu_torch.ops.layout import sym_compress, to_lanes  # noqa: E402

torch.set_num_threads(1)

B, NP1, NZ, NU, NX, NB = 1024, 4, 5, 2, 3, 2
N = NP1 - 1
NB2 = 2 * NB
NT = NZ * (NZ + 1) // 2
DIMS = dict(NB=NB, NU=NU, NZ=NZ, NX=NX)
CASES = [(False, False), (True, True)]      # (phase2, with_ng)


def _jl(x):
    """Port stream (..., B) -> the JAX lanes layout (nb, ..., 8, 128)."""
    a = np.asarray(x)
    a = a.reshape(a.shape[:-1] + (B // jsk.BI, jsk.SUBS, jsk.LANES))
    return np.moveaxis(a, -3, 0)


def _pt(a):
    """JAX lanes array (nb, ..., 8, 128) -> port stream (..., B)."""
    a = np.moveaxis(np.asarray(a), 0, -3)
    return torch.as_tensor(a.reshape(a.shape[:-3] + (B,)).copy())


def _problem(seed, with_ng):
    """tests/test_mega_kernel.py's problem, batch-last for the port."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    lam = rng.uniform(0.1, 2.0, (B, NP1, NB2)).astype(f32)
    t = rng.uniform(0.1, 2.0, (B, NP1, NB2)).astype(f32)
    A = rng.standard_normal((B, NP1, NB2)).astype(f32)
    M = rng.uniform(0.01, 1.0, (B, NP1, NB2)).astype(f32)
    mb = np.ones((B, NP1, NB2), f32)
    mb[:, -1, 1] = mb[:, -1, 1 + NB] = 0.0
    lam *= mb
    base = rng.standard_normal((B, NP1, NZ)).astype(f32)
    pdreg = np.full((B, NP1, NZ), 1e-8, f32)
    Hs = rng.standard_normal((B, NP1, NZ, NZ)).astype(f32)
    H = (np.einsum("bnij,bnkj->bnik", Hs, Hs) / NZ
         + 2.0 * np.eye(NZ, dtype=f32))
    F = (0.4 * rng.standard_normal((B, N, NZ, NX))).astype(f32)
    b = rng.standard_normal((B, N, NX)).astype(f32)
    idx = np.zeros((NP1, NB), np.int32)
    for n in range(NP1):
        idx[n] = np.sort(rng.choice(NZ, size=NB, replace=False))
    T = lambda a: to_lanes(torch.as_tensor(a))  # noqa: E731
    p = dict(idx=torch.as_tensor(idx), lam=T(lam), t=T(t), A=T(A), M=T(M),
             mb=T(mb), base=T(base), pdreg=T(pdreg),
             H=to_lanes(sym_compress(torch.as_tensor(H))), F=T(F), b=T(b),
             ng_ids=(), ngl=None, ngadd=None)
    if with_ng:
        p["ng_ids"] = (1, N)
        ngt = rng.uniform(0.0, 0.2, (B, 2, NT)).astype(f32)
        mask = np.zeros(NT, f32)
        mask[[i * (i + 1) // 2 + i for i in range(NZ)]] = 1.0
        p["ngl"] = T(ngt * mask)
        p["ngadd"] = T(rng.standard_normal((B, 2, NZ)).astype(f32))
    p["sm"] = torch.as_tensor(rng.uniform(0.01, 0.2, (B,)).astype(f32))
    return p


def _jax_streams(p):
    nb = B // jsk.BI
    J = lambda x: jnp.asarray(_jl(x))  # noqa: E731
    ngl = (J(p["ngl"]) if p["ng_ids"]
           else jnp.zeros((nb, 1, NT, jsk.SUBS, jsk.LANES), jnp.float32))
    ngadd = (J(p["ngadd"]) if p["ng_ids"]
             else jnp.zeros((nb, 1, NZ, jsk.SUBS, jsk.LANES), jnp.float32))
    return dict(idx=jnp.asarray(p["idx"].numpy()), lam=J(p["lam"]),
                t=J(p["t"]), A=J(p["A"]), M=J(p["M"]), mb=J(p["mb"]),
                base=J(p["base"]), pdreg=J(p["pdreg"]), H=J(p["H"]),
                F=J(p["F"]), b=J(p["b"]), ngl=ngl, ngadd=ngadd)


@pytest.fixture(scope="module")
def cases():
    """Per (phase2, with_ng): the problem and both JAX mega calls, run
    once in interpret mode."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        orig = pl.pallas_call
        mp.setattr(pl, "pallas_call",
                   lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        for phase2, with_ng in CASES:
            p = _problem(10 + int(phase2), with_ng)
            j = _jax_streams(p)
            M = j["M"] if phase2 else None
            fj = jmk.factor_solve_mega(
                j["idx"], j["lam"], j["t"], j["A"], M, j["mb"], j["base"],
                j["pdreg"], j["H"], j["ngl"], j["ngadd"], p["ng_ids"],
                j["F"], j["b"], phase2=phase2, **DIMS)
            sm_l = jnp.asarray(
                p["sm"].numpy().reshape(-1, jsk.SUBS, jsk.LANES)[:, None])
            sj = jmk.solve_mega(
                j["idx"], fj[1], j["lam"], j["t"], j["A"], M, j["mb"],
                fj[2], fj[3], sm_l, j["base"], j["ngadd"], p["ng_ids"],
                j["F"], j["b"], phase2=phase2, **DIMS)
            out[(phase2, with_ng)] = (p, fj, sj)
    return out


def _close(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want[np.isfinite(want)]).max())
    np.testing.assert_allclose(_jl(got.numpy()), want, rtol=1e-5,
                               atol=1e-5 * scale, err_msg=what)


@pytest.mark.parametrize("phase2,with_ng", CASES)
def test_factor_solve_mega_matches_jax(cases, phase2, with_ng):
    p, fj, _ = cases[(phase2, with_ng)]
    n0 = list(mk.PLAIN_CALLS["factor_solve_mega"])
    out = mk.factor_solve_mega(
        p["idx"], p["lam"], p["t"], p["A"], p["M"] if phase2 else None,
        p["mb"], p["base"], p["pdreg"], p["H"], p["ngl"], p["ngadd"],
        p["ng_ids"], p["F"], p["b"], phase2=phase2, **DIMS)
    n0[int(phase2)] += 1
    assert mk.PLAIN_CALLS["factor_solve_mega"] == n0
    z, fstate, dtl, dll, amin, s0, s1, s2 = out
    _close(z, fj[0], "z")
    for name, got, want in zip(("Ll", "Lxx", "Pb"), fstate, fj[1]):
        _close(got, want, name)
    for name, got, want in zip(("dt", "dl", "amin", "s0", "s1", "s2"),
                               (dtl, dll, amin, s0, s1, s2), fj[2:]):
        _close(got, want, name)


@pytest.mark.parametrize("phase2,with_ng", CASES)
def test_solve_mega_matches_jax(cases, phase2, with_ng):
    p, fj, sj = cases[(phase2, with_ng)]
    fstate = tuple(_pt(x) for x in fj[1])
    out = mk.solve_mega(
        p["idx"], fstate, p["lam"], p["t"], p["A"],
        p["M"] if phase2 else None, p["mb"], _pt(fj[2]), _pt(fj[3]),
        p["sm"], p["base"], p["ngadd"], p["ng_ids"], p["F"], p["b"],
        phase2=phase2, **DIMS)
    z2, pi2 = out[0], out[1]
    _close(z2, sj[0], "z2")
    _close(pi2, sj[1], "pi2")
    for name, got, want in zip(("dt2", "dl2", "amin", "s0", "s1", "s2"),
                               out[2:], sj[2:]):
        _close(got, want, name)
