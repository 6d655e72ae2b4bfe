"""Riccati sweep kernels of the 6-kernel lanes loop (``ops/stage_kernel.py``:
``factor_solve_folded_flat``, ``solve_flat``, ``refine_flat_fused``) of the
PyTorch port vs the JAX package's Pallas kernels in interpret mode.

On the CPU the port's wrappers run their plain versions (counted in
``PLAIN_CALLS``).  Inputs: one 1024-lane block, N=3, the narrowest stage
that has both an input and a state block coupled through F (NZ=3: NU=1,
NX=2; the interpret-mode compilation of the sweeps grows with the
unrolled stage width), built in numpy from a seed, without and with
general constraints (NG=2 rows on stages 1 and N; float32 with them only,
float64 both ways): SPD stage
Hessians, a positive barrier diagonal, the packed C' diag(Qx_g) C term of
the same C and Qx_g that the refinement pass takes.  The re-solve and the
refinement pass run on the JAX factorization's factor state (handed to
both packages), the refinement on the factor's solution plus noise, so
the pass has a residual to correct.

Tolerance, of a field's largest magnitude: float64 1e-12 (the same
algorithm in another summation order, through three stages of a
well-conditioned factorization); float32 rtol 1e-5 and 1e-5 of the scale,
as tests/test_torch_mega.py.

The JAX references compile without XLA's backend optimisations
(tests/test_torch_ipm_structured.py's ``jit_fast`` /
``_FAST_COMPILE``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from hpmpc_tpu.ops import stage_kernel as jsk  # noqa: E402
from hpmpc_tpu_torch.ops import stage_kernel as sk  # noqa: E402
from hpmpc_tpu_torch.ops.layout import sym_compress, to_lanes  # noqa: E402
from test_torch_ipm_structured import jit_fast  # noqa: E402

torch.set_num_threads(1)

B, NP1, NZ, NU, NX, NG = 1024, 4, 3, 1, 2, 2
N = NP1 - 1
NT = NZ * (NZ + 1) // 2
DIMS = dict(NU=NU, NZ=NZ, NX=NX)
# float32 only with general constraints (the superset of the code paths):
# each case costs four interpret-mode compilations
CASES = [("float64", False), ("float64", True), ("float32", True)]
TOL = {"float64": (1e-12, 1e-12), "float32": (1e-5, 1e-5)}


def _jl(x):
    """Port stream (..., B) -> the JAX lanes layout (nb, ..., 8, 128)."""
    a = np.asarray(x)
    a = a.reshape(a.shape[:-1] + (B // jsk.BI, jsk.SUBS, jsk.LANES))
    return np.moveaxis(a, -3, 0)


def _pt(a):
    """JAX lanes array (nb, ..., 8, 128) -> port stream (..., B)."""
    a = np.moveaxis(np.asarray(a), 0, -3)
    return torch.as_tensor(a.reshape(a.shape[:-3] + (B,)).copy())


def _problem(seed, dt, with_ng):
    rng = np.random.default_rng(seed)
    Hs = rng.standard_normal((B, NP1, NZ, NZ))
    H = np.einsum("bnij,bnkj->bnik", Hs, Hs) / NZ + 2.0 * np.eye(NZ)
    tdt = getattr(torch, dt)
    T = lambda a: to_lanes(torch.as_tensor(a, dtype=tdt))  # noqa: E731
    p = dict(H=to_lanes(sym_compress(torch.as_tensor(H, dtype=tdt))),
             dvec=T(rng.uniform(0.1, 1.0, (B, NP1, NZ))),
             g=T(rng.standard_normal((B, NP1, NZ))),
             g2=T(rng.standard_normal((B, NP1, NZ))),
             F=T(0.4 * rng.standard_normal((B, N, NZ, NX))),
             b=T(rng.standard_normal((B, N, NX))),
             dz=T(1e-2 * rng.standard_normal((B, NP1, NZ))),
             dpi=T(1e-2 * rng.standard_normal((B, N, NX))),
             ng_ids=(), ngl=None, C=None, qxg=None)
    if with_ng:
        p["ng_ids"] = (1, N)
        C = rng.standard_normal((B, 2, NG, NZ))
        q = rng.uniform(0.1, 1.0, (B, 2, NG))
        ngl = np.einsum("bjgr,bjg,bjgc->bjrc", C, q, C)
        p["ngl"] = to_lanes(sym_compress(torch.as_tensor(ngl, dtype=tdt)))
        p["C"], p["qxg"] = T(C), T(q)
    return p


@pytest.fixture(scope="module")
def cases():
    """Per (dtype, with_ng): the problem and the JAX calls, run once in
    interpret mode: the factorization with pi (the port's call without
    pi must give the same z and factor state), the re-solve of a second
    gradient and one refinement pass, both on that factor state."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        orig = pl.pallas_call
        mp.setattr(pl, "pallas_call",
                   lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        for dt, with_ng in CASES:
            p = _problem(30 + int(with_ng), dt, with_ng)
            J = lambda x: jnp.asarray(_jl(x))  # noqa: E731
            ngl = (J(p["ngl"]) if with_ng else
                   jnp.zeros((B // jsk.BI, 1, NT, jsk.SUBS, jsk.LANES),
                             getattr(jnp, dt)))
            fac = jit_fast(
                jsk.factor_solve_folded_flat, J(p["H"]), J(p["dvec"]), ngl,
                p["ng_ids"], J(p["g"]), J(p["F"]), J(p["b"]), NU, NZ, NX,
                want_pi=True, lanes_io=True)
            z, pi, (Ll, Lxx, Pb) = fac
            solve = jit_fast(jsk.solve_flat, Ll, Lxx, Pb, J(p["g2"]),
                             J(p["F"]), J(p["b"]), NU, NZ, NX, lanes_io=True)
            zc, pic = z + J(p["dz"]), pi + J(p["dpi"])
            ref = jit_fast(
                jsk.refine_flat_fused, J(p["H"]), J(p["dvec"]),
                J(p["C"]) if with_ng else None,
                J(p["qxg"]) if with_ng else None, p["ng_ids"], J(p["g"]),
                J(p["F"]), J(p["b"]), zc, pic, Ll, Lxx, NU, NZ, NX)
            out[(dt, with_ng)] = (p, fac, solve, (zc, pic), ref)
    return out


def _close(got, want, dt, what):
    want = np.asarray(want)
    scale = float(np.abs(want[np.isfinite(want)]).max())
    rtol, atol = TOL[dt]
    np.testing.assert_allclose(_jl(got.numpy()), want, rtol=rtol,
                               atol=atol * scale, err_msg=what)


def _calls(name, fn):
    """Run ``fn`` and check it took the plain version once."""
    n0 = sk.PLAIN_CALLS[name]
    out = fn()
    assert sk.PLAIN_CALLS[name] == n0 + 1
    return out


@pytest.mark.parametrize("want_pi", [False, True])
@pytest.mark.parametrize("dt,with_ng", CASES)
def test_factor_solve_folded_flat_matches_jax(cases, dt, with_ng, want_pi):
    p, fac, _, _, _ = cases[(dt, with_ng)]
    z, pi, fstate = _calls("factor_solve_folded_flat",
                           lambda: sk.factor_solve_folded_flat(
                               p["H"], p["dvec"], p["ngl"], p["ng_ids"],
                               p["g"], p["F"], p["b"], **DIMS,
                               want_pi=want_pi))
    jz, jpi, jstate = fac
    _close(z, jz, dt, "z")
    if want_pi:
        _close(pi, jpi, dt, "pi")
    else:
        assert pi is None
    Ll, Lxx, Pb = fstate
    _close(Ll, jstate[0], dt, "Ll")
    tril = np.tril(np.ones((NX, NX)))[None, None, :, :, None, None]
    _close(Lxx, np.asarray(jstate[1]) * tril, dt, "Lxx")
    _close(Pb, jstate[2], dt, "Pb")


@pytest.mark.parametrize("dt,with_ng", CASES)
def test_solve_flat_matches_jax(cases, dt, with_ng):
    p, fac, solve, _, _ = cases[(dt, with_ng)]
    fstate = tuple(_pt(x) for x in fac[2])
    z, pi = _calls("solve_flat", lambda: sk.solve_flat(
        *fstate, p["g2"], p["F"], p["b"], **DIMS))
    _close(z, solve[0], dt, "z")
    _close(pi, solve[1], dt, "pi")


@pytest.mark.parametrize("dt,with_ng", CASES)
def test_refine_flat_fused_matches_jax(cases, dt, with_ng):
    p, fac, _, (zc, pic), ref = cases[(dt, with_ng)]
    Ll, Lxx, _ = (_pt(x) for x in fac[2])
    z, pi = _calls("refine_flat_fused", lambda: sk.refine_flat_fused(
        p["H"], p["dvec"], p["C"], p["qxg"], p["ng_ids"], p["g"], p["F"],
        p["b"], _pt(zc), _pt(pic), Ll, Lxx, **DIMS))
    _close(z, ref[0], dt, "z")
    _close(pi, ref[1], dt, "pi")
    # the pass corrects the perturbation back toward the solution
    err0 = float(np.abs(np.asarray(zc) - np.asarray(fac[0])).max())
    err1 = float(np.abs(_jl(z.numpy()) - np.asarray(fac[0])).max())
    assert err1 < 1e-2 * err0, (err0, err1)
