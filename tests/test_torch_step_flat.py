"""Step passes of the 6-kernel lanes loop (``ops/step_kernel.py``:
``prep_flat``, ``alpha_sums_flat``, ``corr_geff_flat``) of the PyTorch port
vs the JAX package's Pallas kernels in interpret mode.

On the CPU the port's wrappers run their plain versions (counted in
``PLAIN_CALLS``).  Inputs: tests/test_torch_mega.py's tiny problem (B=1024,
N=3, NZ=5, NB=2), built once per (dtype, phase) in numpy from a seed; the
affine alpha pass takes a random z direction, the corrector pass the
affine box direction of the JAX alpha call, so both packages see the same
inputs.  Phase 1 runs the alpha pass without and with the centering
stream ``dl0``; phase 2 with ``M`` (rm).

Tolerance, of a field's largest magnitude: float64 1e-13 (both sides do
the same elementwise arithmetic, the sums over 2NB slots in other orders);
float32 rtol 1e-5 and 1e-5 of the scale, as tests/test_torch_mega.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from hpmpc_tpu.ops import stage_kernel as jsk  # noqa: E402
from hpmpc_tpu.ops import step_kernel as jstk  # noqa: E402
from hpmpc_tpu_torch.ops import step_kernel as stk  # noqa: E402
from hpmpc_tpu_torch.ops.layout import to_lanes  # noqa: E402

torch.set_num_threads(1)

B, NP1, NZ, NB = 1024, 4, 5, 2
NB2 = 2 * NB
DIMS = dict(NB=NB, NZ=NZ)
CASES = [(dt, ph) for dt in ("float64", "float32") for ph in (False, True)]
TOL = {"float64": (1e-13, 1e-13), "float32": (1e-5, 1e-5)}


def _jl(x):
    """Port stream (..., B) -> the JAX lanes layout (nb, ..., 8, 128)."""
    a = np.asarray(x)
    a = a.reshape(a.shape[:-1] + (B // jsk.BI, jsk.SUBS, jsk.LANES))
    return np.moveaxis(a, -3, 0)


def _pt(a):
    """JAX lanes array (nb, ..., 8, 128) -> port stream (..., B)."""
    a = np.moveaxis(np.asarray(a), 0, -3)
    return torch.as_tensor(a.reshape(a.shape[:-3] + (B,)).copy())


def _problem(seed, dt):
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.1, 2.0, (B, NP1, NB2))
    mb = np.ones((B, NP1, NB2))
    mb[:, -1, 1] = mb[:, -1, 1 + NB] = 0.0
    p = dict(lam=lam * mb, t=rng.uniform(0.1, 2.0, (B, NP1, NB2)),
             A=rng.standard_normal((B, NP1, NB2)),
             M=rng.uniform(0.01, 1.0, (B, NP1, NB2)), mb=mb,
             dl0=rng.standard_normal((B, NP1, NB2)),
             base=rng.standard_normal((B, NP1, NZ)),
             pdreg=np.full((B, NP1, NZ), 1e-8),
             dz=rng.standard_normal((B, NP1, NZ)))
    p = {k: to_lanes(torch.as_tensor(v, dtype=getattr(torch, dt)))
         for k, v in p.items()}
    idx = np.zeros((NP1, NB), np.int32)
    for n in range(NP1):
        idx[n] = np.sort(rng.choice(NZ, size=NB, replace=False))
    p["idx"] = torch.as_tensor(idx)
    p["sm"] = torch.as_tensor(rng.uniform(0.01, 0.2, (B,)),
                              dtype=getattr(torch, dt))
    return p


@pytest.fixture(scope="module")
def cases():
    """Per (dtype, phase2): the problem and the JAX passes, run once in
    interpret mode: prep, the affine alpha pass (and in phase 1 the one
    with dl0), the corrector pass on the affine box direction."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        orig = pl.pallas_call
        mp.setattr(pl, "pallas_call",
                   lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        for dt, phase2 in CASES:
            p = _problem(20 + int(phase2), dt)
            j = {k: jnp.asarray(_jl(v)) for k, v in p.items()
                 if k not in ("idx", "sm")}
            idx = jnp.asarray(p["idx"].numpy())
            M = j["M"] if phase2 else None
            kw = dict(DIMS, phase2=phase2)
            prep = jstk.prep_flat(idx, j["lam"], j["t"], j["A"], M, j["mb"],
                                  j["base"], j["pdreg"], **kw)
            alpha = {False: jstk.alpha_sums_flat(
                idx, j["dz"], j["lam"], j["t"], j["A"], M, None, j["mb"],
                **kw)}
            if not phase2:
                alpha[True] = jstk.alpha_sums_flat(
                    idx, j["dz"], j["lam"], j["t"], j["A"], None, j["dl0"],
                    j["mb"], **kw)
            sm_l = jnp.asarray(p["sm"].numpy().reshape(
                -1, jsk.SUBS, jsk.LANES)[:, None])
            corr = jstk.corr_geff_flat(
                idx, j["lam"], j["t"], j["A"], M, alpha[False][0],
                alpha[False][1], sm_l, j["base"], j["mb"], **kw)
            out[(dt, phase2)] = (p, prep, alpha, corr)
    return out


def _close(got, want, dt, what):
    want = np.asarray(want)
    scale = float(np.abs(want[np.isfinite(want)]).max())
    rtol, atol = TOL[dt]
    np.testing.assert_allclose(_jl(got.numpy()), want, rtol=rtol,
                               atol=atol * scale, err_msg=what)


def _calls(name, phase2, fn):
    """Run ``fn`` and check it took the plain version once in that phase."""
    n0 = list(stk.PLAIN_CALLS[name])
    out = fn()
    n0[int(phase2)] += 1
    assert stk.PLAIN_CALLS[name] == n0
    return out


@pytest.mark.parametrize("dt,phase2", CASES)
def test_prep_flat_matches_jax(cases, dt, phase2):
    p, prep, _, _ = cases[(dt, phase2)]
    out = _calls("prep_flat", phase2, lambda: stk.prep_flat(
        p["idx"], p["lam"], p["t"], p["A"], p["M"] if phase2 else None,
        p["mb"], p["base"], p["pdreg"], **DIMS, phase2=phase2))
    for name, got, want in zip(("dvec", "geff"), out, prep):
        _close(got, want, dt, name)


@pytest.mark.parametrize("dt,phase2,with_dl0", [c + (False,) for c in CASES]
                         + [(dt, False, True) for dt in ("float64",
                                                         "float32")])
def test_alpha_sums_flat_matches_jax(cases, dt, phase2, with_dl0):
    p, _, alpha, _ = cases[(dt, phase2)]
    out = _calls("alpha_sums_flat", phase2, lambda: stk.alpha_sums_flat(
        p["idx"], p["dz"], p["lam"], p["t"], p["A"],
        p["M"] if phase2 else None, p["dl0"] if with_dl0 else None,
        p["mb"], **DIMS, phase2=phase2))
    for name, got, want in zip(("dt", "dl", "amin", "s0", "s1", "s2"), out,
                               alpha[with_dl0]):
        _close(got, want, dt, name)


@pytest.mark.parametrize("dt,phase2", CASES)
def test_corr_geff_flat_matches_jax(cases, dt, phase2):
    p, _, alpha, corr = cases[(dt, phase2)]
    out = _calls("corr_geff_flat", phase2, lambda: stk.corr_geff_flat(
        p["idx"], p["lam"], p["t"], p["A"], p["M"] if phase2 else None,
        _pt(alpha[False][0]), _pt(alpha[False][1]), p["sm"], p["base"],
        p["mb"], **DIMS, phase2=phase2))
    for name, got, want in zip(("geff2", "co"), out, corr):
        _close(got, want, dt, name)
