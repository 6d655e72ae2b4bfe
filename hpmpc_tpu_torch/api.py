"""High-level NumPy front door (PyTorch twin of :mod:`hpmpc_tpu.api`), the
reference's fortran-order interface.

Mirrors ``fortran_order_d_ip_ocp_hard_tv`` (``interfaces/c/
fortran_order_interface.c``; ``include/c_interface.h:62-76``): the user
supplies per-stage column-major NumPy arrays ``A, B, b, Q, S, R, q, r``
(+ box bounds on logical ``[u;x]`` indices, general rows ``C/D`` with
two-sided bounds), an optional partial-condensing horizon ``N2 < N``, and
gets back ``x, u, pi, lam, t``, the per-iteration ``stat`` trace and
``inf_norm_res = {|rq|inf, |rb|inf, |rd|inf, mu}`` (``doc/guide.tex:
313-315``).  NumPy in, NumPy out; every entry point takes ``device=None``,
the CUDA card (:func:`..ocp.resolve_device`), or e.g. ``device="cpu"``.

One problem is a batch of one through the port's batch-first solvers: the
structured two-phase IPM (:func:`.models.ipm.solve`, plain Riccati: the
JAX package's ``IPMConfig`` defaults, no ``use_pallas``), partial
condensing (:mod:`.models.cond`), the soft IPM (:func:`.models.ipm_soft.
solve`) and the dense latency tick (:mod:`.models.ipm_dense`, Queue 2 row
23's kernel on the card).  The JAX package caches one compiled executable
per geometry (its ``_jit_*`` functions); PyTorch runs eagerly, so there is
nothing to compile and no cache.

Packing: the native C++ layer (``native/src/packing.cpp``, built by
``native/build.sh``) loads through ctypes when its library is built, with
the numpy formulas when it is absent (host-side packing, as in the JAX
package; it decides no device work).  :func:`work_space_size_bytes` is the
analogue of ``hpmpc_d_ip_ocp_hard_tv_work_space_size_bytes``
(``c_interface.h:40``): PyTorch's allocator manages memory, so it is a
planning figure (device bytes per solve).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .models import cond as _cond
from .models import ipm as _ipm
from .models import ipm_dense as _ipd
from .models import ipm_soft as _soft
from .ocp import OCPDims, OCPQP, pack_ocp, pack_offsets, resolve_device
from .parallel.batch import broadcast_qp

# the library native/build.sh builds in the repository checkout
_NATIVE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native",
    "lib", "libhpmpc_tpu_native.so")


def _load_native():
    try:
        lib = ctypes.CDLL(_NATIVE_PATH)
        lib.hpmpc_tpu_ip_ocp_hard_tv_work_space_size_bytes.restype = (
            ctypes.c_int64)
        # self-test: a trivial workspace query must return a sane size, else
        # the numpy formulas (guards against a stale or mis-built library)
        one = (ctypes.c_int * 2)(1, 1)
        n = int(lib.hpmpc_tpu_ip_ocp_hard_tv_work_space_size_bytes(
            1, one, one, one, one, 1, 8))
        if not (0 < n < 1 << 40):
            return None
        return lib
    except OSError:
        return None


_native = _load_native()


def native_available() -> bool:
    return _native is not None


def _ptr_array(mats: Sequence[np.ndarray]):
    """Array of double* pointers to Fortran-contiguous copies."""
    fortran = [np.asfortranarray(np.asarray(m, dtype=np.float64))
               for m in mats]
    arr = (ctypes.POINTER(ctypes.c_double) * len(fortran))()
    for i, m in enumerate(fortran):
        arr[i] = m.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    return arr, fortran  # keep the copies alive


def _c_ints(v):
    return (ctypes.c_int * len(v))(*v)


def _torch_dtype(dtype):
    if dtype in (np.float32, torch.float32, "float32"):
        return torch.float32
    if dtype in (np.float64, torch.float64, "float64", None):
        return torch.float64
    raise TypeError(f"unsupported dtype {dtype}")


class OCPResult(NamedTuple):
    x: list  # per-stage states (N+1, each (nx[n],))
    u: list  # per-stage inputs (N+1, each (nu[n],))
    pi: list  # equality multipliers (N, each (nx[n+1],))
    lam: list  # per-stage multipliers [lb, ub, lg, ug] concatenated
    t: list  # per-stage slacks, same layout
    kk: int
    status: int
    stat: np.ndarray  # (kk, 5) {sigma, alpha_aff, mu_aff, alpha, mu}
    inf_norm_res: np.ndarray  # (4,)


def _b_with_x0(b, A0, x0) -> list:
    """The dynamics offsets with the fixed initial state eliminated:
    ``b_0 + A_0 x0``, the others as given."""
    x0 = np.asarray(x0, dtype=np.float64).reshape(-1)
    return [np.asarray(b[0]).reshape(-1) + np.asarray(A0) @ x0] + [
        np.asarray(v) for v in b[1:]]


def pack_problem(N, A, B, b, Q, S, R, q, r, idxb=None, lb=None, ub=None,
                 C=None, D=None, lg=None, ug=None, x0=None,
                 dtype=np.float64, device=None):
    """``(dims, qp)`` from fortran-order per-stage data; ``qp`` without an
    instance axis, on ``device`` (default: the card).

    ``x0`` given: the fixed initial state is eliminated as the reference
    tests do (``test_d_ip_hard.c:199-204``): nx[0]=0, b_0 <- b_0 + A_0 x0,
    r_0 <- r_0 + S_0 x0, stage-0 state bounds dropped.  nx[n] is the column
    count of A[n] (the terminal size from Q[N]); terminal inputs (nu[N] >
    0, the slacks of :func:`soft_to_hard_data`) come from R[N].  Raises
    ``ValueError`` when B[n]'s rows disagree with stage n+1's nx."""
    A = list(A); B = list(B); b = list(b)  # noqa: E702
    Q = list(Q); S = list(S); R = list(R); q = list(q); r = list(r)  # noqa: E702
    nx_v = [np.asarray(An).shape[1] for An in A] + [np.asarray(Q[-1]).shape[0]]
    nuN = int(np.asarray(R[-1]).shape[0]) if len(R) == N + 1 else 0
    nu_v = [np.asarray(Bn).shape[1] for Bn in B] + [nuN]
    for n, Bn in enumerate(B):
        if np.asarray(Bn).shape[0] != nx_v[n + 1]:
            raise ValueError(
                f"B[{n}] has {np.asarray(Bn).shape[0]} rows but stage "
                f"{n + 1} has nx={nx_v[n + 1]} (from A/Q shapes)")

    if x0 is not None:
        x0 = np.asarray(x0, dtype=np.float64).reshape(-1)
        b = _b_with_x0(b, A[0], x0)
        r = [np.asarray(r[0]).reshape(-1)
             + np.asarray(S[0]).reshape(nu_v[0], -1) @ x0] + [
            np.asarray(rr) for rr in r[1:]]
        A = [np.zeros((nx_v[1], 0))] + [np.asarray(a) for a in A[1:]]
        S = [np.zeros((nu_v[0], 0))] + [np.asarray(s) for s in S[1:]]
        Q = [np.zeros((0, 0))] + [np.asarray(qq) for qq in Q[1:]]
        q = [np.zeros(0)] + [np.asarray(qq) for qq in q[1:]]
        nx_v[0] = 0
        if idxb is not None:
            # drop stage-0 state bounds (those coordinates are eliminated)
            keep = [j for j, v in enumerate(np.asarray(idxb[0]))
                    if v < nu_v[0]]
            idxb = [np.asarray(idxb[0])[keep]] + [np.asarray(i)
                                                  for i in idxb[1:]]
            lb = [np.asarray(lb[0])[keep]] + [np.asarray(v) for v in lb[1:]]
            ub = [np.asarray(ub[0])[keep]] + [np.asarray(v) for v in ub[1:]]

    nb_v = ([len(np.asarray(i)) for i in idxb] if idxb is not None
            else [0] * (N + 1))
    ng_v = ([np.asarray(c).shape[0] if c is not None else 0 for c in C]
            if C is not None else [0] * (N + 1))
    dims = OCPDims.create(N, nx_v, nu_v, nb_v, ng_v, idxb=idxb)
    qp = pack_ocp(dims, A, B, b, Q, S, R, q, r, idxb=idxb, lb=lb, ub=ub,
                  C=C, D=D, lg=lg, ug=ug, dtype=_torch_dtype(dtype),
                  device=device)
    return dims, qp


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _unpack_result(dims: OCPDims, sol) -> OCPResult:
    """Per-stage numpy views of instance 0 of a batched solution."""
    N, NU = dims.N, dims.NU
    z, pi = _host(sol.z[0]), _host(sol.pi[0])
    lam_b, lam_g = _host(sol.lam_b[0]), _host(sol.lam_g[0])
    t_b, t_g = _host(sol.t_b[0]), _host(sol.t_g[0])
    lam_out, t_out = [], []
    for n in range(N + 1):
        nbn, ngn = dims.nb[n], dims.ng[n]
        lam_out.append(np.concatenate([lam_b[n, 0, :nbn], lam_b[n, 1, :nbn],
                                       lam_g[n, 0, :ngn], lam_g[n, 1, :ngn]]))
        t_out.append(np.concatenate([t_b[n, 0, :nbn], t_b[n, 1, :nbn],
                                     t_g[n, 0, :ngn], t_g[n, 1, :ngn]]))
    kk = int(sol.kk[0])
    return OCPResult(
        x=[z[n, NU:NU + dims.nx[n]].copy() for n in range(N + 1)],
        u=[z[n, :dims.nu[n]].copy() for n in range(N + 1)],
        pi=[pi[n, :dims.nx[n + 1]].copy() for n in range(N)],
        lam=lam_out, t=t_out, kk=kk, status=int(sol.status[0]),
        stat=_host(sol.stat[0])[:kk], inf_norm_res=_host(sol.inf_norm_res[0]))


class OCPSession:
    """Retained-state front door for re-solves at fixed matrix data (the
    reference's workspace-reuse family, ``include/c_interface.h:62-76``):
    after :func:`solve_ocp` with ``return_session=True``,

    - :meth:`solve_new_rhs`: re-solve for changed vector data (b, q, r,
      bounds, x0) with the retained Riccati factor, one triangular
      re-solve (``fortran_order_d_solve_kkt_new_rhs_ocp_hard_tv``,
      ``fortran_order_interface.c:985``);
    - :meth:`single_newton`: RTI-style warm Newton step(s) from the last
      solution (``..._single_newton_step``, ``c_interface.h:67``);
    - :meth:`solve`: the full IPM warm-started from the last solution;
    - :meth:`dense_tick`: the minimum-latency tick through the dense
      condensed-QP engine.

    Runs on the session's device (that of the first solve)."""

    def __init__(self, dims, cfg, matrices, sol, carry, device):
        self.dims = dims
        self.cfg = cfg
        self.device = device
        self._mat = matrices   # the original per-stage data
        self._sol = sol        # the last solution (a batch of one)
        self._carry = carry    # KKTCarry or None
        self._dense_plan = None
        self._dense_y = None

    def _repack(self, b=None, q=None, r=None, lb=None, ub=None, lg=None,
                ug=None, x0=None) -> OCPQP:
        """The session's QP (no instance axis) with new vector data."""
        m = self._mat
        pick = lambda new, key: m[key] if new is None else new  # noqa: E731
        dims, qp = pack_problem(
            m["N"], m["A"], m["B"], pick(b, "b"), m["Q"], m["S"], m["R"],
            pick(q, "q"), pick(r, "r"), idxb=m["idxb"], lb=pick(lb, "lb"),
            ub=pick(ub, "ub"), C=m["C"], D=m["D"], lg=pick(lg, "lg"),
            ug=pick(ug, "ug"), x0=pick(x0, "x0"), device=self.device)
        if dims != self.dims:
            raise ValueError("new-rhs data changed the problem geometry; "
                             "start a new session via solve_ocp")
        return qp

    def solve_new_rhs(self, **vectors) -> OCPResult:
        """Triangular re-solve with the retained factor for new vector data
        (kwargs: b, q, r, lb, ub, lg, ug, x0)."""
        if self._carry is None:
            raise ValueError("session has no retained factorization")
        qp = broadcast_qp(self._repack(**vectors), 1)
        return _unpack_result(self.dims, _ipm.kkt_solve_new_rhs(
            self.dims, qp, self._carry))

    def single_newton(self, k: int = 1, **vectors) -> OCPResult:
        """``k`` warm Newton iterations from the last solution for new
        vector data (classic RTI: k=1)."""
        qp = broadcast_qp(self._repack(**vectors), 1)
        cfg = dataclasses.replace(self.cfg, k_max=k)
        s = self._sol
        sol, carry = _ipm.solve_single_newton(
            self.dims, qp, cfg, s.z, s.pi, s.lam_b, s.t_b, s.lam_g, s.t_g,
            return_carry=True)
        self._sol, self._carry = sol, carry
        return _unpack_result(self.dims, sol)

    def solve(self, **vectors) -> OCPResult:
        """Full IPM re-solve warm-started from the last solution."""
        qp = broadcast_qp(self._repack(**vectors), 1)
        cfg = dataclasses.replace(self.cfg, warm_start=True)
        sol, carry = _ipm.solve(self.dims, qp, cfg, z0=self._sol.z,
                                pi0=self._sol.pi, return_carry=True)
        self._sol, self._carry = sol, carry
        return _unpack_result(self.dims, sol)

    def _tick_bflat(self, b=None, x0=None) -> torch.Tensor:
        """``vec(b)`` of :func:`pack_problem`'s padded dynamics offsets for
        new ``b`` / ``x0``, without repacking the fixed matrices (the tick's
        latency: ``chip_smoke.py`` section K times both)."""
        m = self._mat
        b = m["b"] if b is None else b
        x0 = m["x0"] if x0 is None else x0
        if (x0 is None) != (m["x0"] is None):
            raise ValueError("new-rhs data changed the problem geometry; "
                             "start a new session via solve_ocp")
        if x0 is not None:
            b = _b_with_x0(b, m["A"][0], x0)
        return torch.as_tensor(pack_offsets(self.dims, b).reshape(-1)).to(
            device=self.device, dtype=self._dense_plan.Hd.dtype)

    def dense_tick(self, use_kernel: bool = True, warm: bool = True,
                   **vectors):
        """Minimum-latency tick through the dense condensed-QP engine
        (:mod:`.models.ipm_dense`): the plan (condensed matrices + exact
        affine raw-b -> dense-rhs maps) is built and cached on first use;
        each tick maps the new ``b`` / ``x0`` (the only data that may vary:
        cost or bound changes need a new session) through the plan and
        runs the whole phase-1 IPM at ``cfg.mu_tol``, on the card in one
        launch of Queue 2 row 23's kernel (``use_kernel=False``: the plain
        reference ``solve_dense_ref``; a CPU session runs the kernel's
        plain version).  ``warm=True`` seeds each tick from the previous
        tick's iterate.  Returns ``(u0 (numpy), DenseTickResult)``.

        Envelope: the kernel takes condensed sizes nz = sum(nu) <= 128
        inputs and <= 128 general rows (state boxes + terminal rows);
        beyond it ``use_kernel=True`` raises ``ValueError`` (solve with
        :meth:`solve`)."""
        vec = {k: v for k, v in vectors.items() if k in ("b", "x0")}
        if self._dense_plan is None:
            self._dense_plan = _ipd.plan_dense(self.dims, self._repack(**vec))
            self._dense_y = None
        plan = self._dense_plan
        y0 = self._dense_y if (warm and self._dense_y is not None) else None
        res = _ipd.solve_dense_tick(plan, self._tick_bflat(**vec), self.cfg,
                                    use_kernel=use_kernel, y0=y0)
        self._dense_y = res.y
        return _host(res.u0), res


def solve_ocp(N, A, B, b, Q, S, R, q, r, idxb=None, lb=None, ub=None,
              C=None, D=None, lg=None, ug=None, x0=None, N2=None, k_max=30,
              mu0=2.0, mu_tol=1e-8, alpha_min=1e-8, warm_start=None,
              return_session=False, device=None):
    """One-call hard-constrained OCP solve (the reference's
    ``fortran_order_d_ip_ocp_hard_tv``; ``N2 < N`` runs partial
    condensing -> IPM -> expand, ``fortran_order_interface.c:434-528``).

    ``warm_start``: a previous :class:`OCPResult` (or ``(x, u)`` per-stage
    lists) initializes the iterate (the reference's ``warm_start``).
    ``return_session=True`` also returns an :class:`OCPSession`.
    ``device``: None = the CUDA card."""
    device = resolve_device(device)
    dims, qp = pack_problem(N, A, B, b, Q, S, R, q, r, idxb=idxb, lb=lb,
                            ub=ub, C=C, D=D, lg=lg, ug=ug, x0=x0,
                            device=device)
    qpb = broadcast_qp(qp, 1)
    cfg = _ipm.IPMConfig(k_max=k_max, mu0=mu0, mu_tol=mu_tol,
                         alpha_min=alpha_min)
    carry = None
    if N2 is not None and N2 < N:
        if warm_start is not None:
            raise ValueError("warm_start is not supported with N2 < N")
        sol, _ = _cond.solve_partial_cond(dims, qpb, cfg, int(N2))
    elif warm_start is not None:
        wx, wu = ((warm_start.x, warm_start.u)
                  if isinstance(warm_start, OCPResult) else warm_start)
        z0 = np.zeros((1, N + 1, dims.NZ))
        pi0 = np.zeros((1, N, dims.NX))
        for n in range(N + 1):
            z0[0, n, :dims.nu[n]] = np.asarray(wu[n]).reshape(-1)[:dims.nu[n]]
            z0[0, n, dims.NU:dims.NU + dims.nx[n]] = np.asarray(
                wx[n]).reshape(-1)[:dims.nx[n]]
        cfg = dataclasses.replace(cfg, warm_start=True)
        sol, carry = _ipm.solve(
            dims, qpb, cfg, z0=torch.as_tensor(z0).to(device, qp.dtype),
            pi0=torch.as_tensor(pi0).to(device, qp.dtype), return_carry=True)
    else:
        sol, carry = _ipm.solve(dims, qpb, cfg, return_carry=True)

    result = _unpack_result(dims, sol)
    if not return_session:
        return result
    mats = dict(N=N, A=A, B=B, b=b, Q=Q, S=S, R=R, q=q, r=r, idxb=idxb,
                lb=lb, ub=ub, C=C, D=D, lg=lg, ug=ug, x0=x0)
    return result, OCPSession(dims, cfg, mats, sol, carry, device)


def _per_stage(v, N, default=None):
    if v is None:
        return [default] * (N + 1)
    if np.isscalar(v):
        return [int(v)] * (N + 1)
    return [int(x) for x in v]


def work_space_size_bytes(N, nx, nu, nb=None, ng=None, k_max=30,
                          dtype=np.float64, N2=None, idxb=None):
    """Device-memory planning figure per solve (the reference's
    ``hpmpc_d_ip_ocp_hard_tv_work_space_size_bytes``, with its ``N2``
    partial-condensing argument, ``include/c_interface.h:40``): with ``N2 <
    N`` the figure covers the condensed problem the IPM solves (state boxes
    become general rows; sizes from :func:`.models.cond.plan`, which needs
    the static ``idxb`` lists: the first nb[n] coordinates by default)."""
    nx, nu = _per_stage(nx, N), _per_stage(nu, N)
    nb, ng = _per_stage(nb, N, 0), _per_stage(ng, N, 0)
    if N2 is not None and N2 < N:
        if idxb is None:
            idxb = [list(range(nb[n])) for n in range(N + 1)]
        dims = OCPDims.create(N, nx, nu, nb, ng, idxb=idxb)
        d2 = _cond.plan(dims, N2).dims2
        return work_space_size_bytes(N2, list(d2.nx), list(d2.nu),
                                     list(d2.nb), list(d2.ng), k_max=k_max,
                                     dtype=dtype)
    elem = np.dtype(dtype).itemsize
    if _native is not None:
        return int(_native.hpmpc_tpu_ip_ocp_hard_tv_work_space_size_bytes(
            N, _c_ints(nx), _c_ints(nu), _c_ints(nb), _c_ints(ng), k_max,
            elem))
    # numpy formulas, the native library's
    NX, NU = max(nx), max(nu)
    NB, NG = max(max(nb), 1), max(max(ng), 1)
    NZ = NX + NU
    elems = N * NZ * NX + N * NX
    elems += (N + 1) * (NZ * NZ + NZ)
    elems += (N + 1) * (3 * NB + 3 * NG + NG * NZ)
    elems += (N + 1) * (NZ + NX + NB + NG)
    elems += 2 * ((N + 1) * NZ + N * NX + 4 * (N + 1) * (NB + NG))
    elems += (N + 1) * NZ * NZ
    elems += k_max * 5
    return elems * elem


def pack_dynamics_native(dims: OCPDims, A, B, b):
    """Native packing of the dynamics stack ``(F (N, NZ, NX), b (N, NX))``
    as numpy arrays (the library's testable fast path)."""
    if _native is None:
        raise RuntimeError("native packing library not built "
                           "(native/build.sh)")
    N, NU, NX, NZ = dims.N, dims.NU, dims.NX, dims.NZ
    Ap, _a = _ptr_array([np.asarray(a, dtype=np.float64).reshape(
        dims.nx[n + 1], dims.nx[n]) for n, a in enumerate(A)])
    Bp, _b = _ptr_array([np.asarray(x, dtype=np.float64).reshape(
        dims.nx[n + 1], dims.nu[n]) for n, x in enumerate(B)])
    bp, _c = _ptr_array([np.asarray(x, dtype=np.float64).reshape(
        dims.nx[n + 1], 1) for n, x in enumerate(b)])
    F = np.zeros((N, NZ, NX))
    bb = np.zeros((N, NX))
    _native.hpmpc_tpu_pack_dynamics(
        N, _c_ints(dims.nx), _c_ints(dims.nu), NU, NX, NZ, Ap, Bp, bp,
        F.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        bb.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return F, bb


def _build_soft_spec(dims: OCPDims, idxs, lbs, ubs, Zs, zs, dtype, device):
    """Per-stage soft data -> a padded :class:`.models.ipm_soft.SoftSpec`
    with an instance axis of one (logical [u;x] coordinates mapped to
    padded z coordinates)."""
    N, NU = dims.N, dims.NU
    NS = max(max(len(np.asarray(i)) for i in idxs), 1)
    Np1 = N + 1
    idxbs = np.zeros((Np1, NS), dtype=np.int32)
    ns_mask, d_lbs, d_ubs = (np.zeros((Np1, NS)) for _ in range(3))
    Zp, zp = np.zeros((Np1, 2, NS)), np.zeros((Np1, 2, NS))
    for n in range(Np1):
        ii = np.asarray(idxs[n], dtype=np.int64)
        ns_n = len(ii)
        Zrow = np.asarray(Zs[n]).reshape(-1)
        zrow = np.asarray(zs[n]).reshape(-1)
        for k, j in enumerate(ii):
            idxbs[n, k] = j if j < dims.nu[n] else NU + (j - dims.nu[n])
            ns_mask[n, k] = 1.0
            d_lbs[n, k] = np.asarray(lbs[n])[k]
            d_ubs[n, k] = np.asarray(ubs[n])[k]
            Zp[n, 0, k] = Zrow[k]
            Zp[n, 1, k] = Zrow[ns_n + k] if len(Zrow) >= 2 * ns_n else Zrow[k]
            zp[n, 0, k] = zrow[k]
            zp[n, 1, k] = zrow[ns_n + k] if len(zrow) >= 2 * ns_n else zrow[k]
    as_t = lambda x: torch.as_tensor(x).to(device=device, dtype=dtype)[None]  # noqa: E731
    return _soft.SoftSpec(
        idxbs=torch.as_tensor(idxbs, device=device)[None], d_lbs=as_t(d_lbs),
        d_ubs=as_t(d_ubs), Z=as_t(Zp), z_lin=as_t(zp), ns_mask=as_t(ns_mask))


def _unpack_soft_result(dims: OCPDims, sol, res) -> OCPResult:
    """Instance 0 of a soft solution, with the exact soft-QP residual norms
    (``d_res_mpc_soft_tv``): {max(|rq|, |rz|), |rb|, |rd| over every
    constraint family, mu}."""
    N, NU = dims.N, dims.NU
    z, pi = _host(sol.z[0]), _host(sol.pi[0])
    kk = int(sol.kk[0])

    def amax(*xs):
        return max((float(x[0].abs().max()) if x[0].numel() else 0.0)
                   for x in xs)

    inf_norm_res = np.array([amax(res.rq, res.rz), amax(res.rb),
                             amax(res.rd_b, res.rd_g, res.rd_s),
                             float(res.mu[0])])
    lam_s, t_s = _host(sol.lam_s[0]), _host(sol.t_s[0])
    return OCPResult(
        x=[z[n, NU:NU + dims.nx[n]].copy() for n in range(N + 1)],
        u=[z[n, :dims.nu[n]].copy() for n in range(N + 1)],
        pi=[pi[n, :dims.nx[n + 1]].copy() for n in range(N)],
        lam=[lam_s[n] for n in range(N + 1)],
        t=[t_s[n] for n in range(N + 1)], kk=kk, status=int(sol.status[0]),
        stat=_host(sol.stat[0])[:kk], inf_norm_res=inf_norm_res)


_SLACK_BIG = 1e6  # inactive side of a one-sided soft row / slack upper bound


def soft_to_hard_data(N, A, B, b, Q, S, R, q, r, idxb, lb, ub, idxs, lbs,
                      ubs, Zs, zs):
    """The soft-constrained QP as a HARD QP (the exact slack reformulation
    of :func:`hpmpc_tpu.api.soft_to_hard_data`): 2*ns_n extra inputs per
    stage (s_lo, s_up >= 0, cost diag(Z), z) and 2*ns_n general rows

        z[j] + s_lo_k >= lbs_k      (upper side inactive at +BIG)
        z[j] - s_up_k <= ubs_k      (lower side inactive at -BIG)

    so the soft problem rides the hard pipeline, partial condensing
    included (the reference has no N2 for its soft solver,
    ``fortran_order_interface.c:1442``).  Returns ``(A, B, b, Q, S, R, q, r,
    idxb, lb, ub, C, D, lg, ug, nu_orig)``, the slack inputs after each
    stage's own (terminal stage included: nu[N] = 2 ns_N)."""
    idxs = [np.asarray(i, dtype=np.int64) for i in idxs]
    ns_v = [len(i) for i in idxs]
    nu_v = [np.asarray(Bn).shape[1] for Bn in B] + [0]
    nx_v = [np.asarray(An).shape[1] for An in A] + [np.asarray(Q[-1]).shape[0]]

    A2, B2, b2, Q2, q2 = list(A), list(B), list(b), list(Q), list(q)
    S2, R2, r2 = [], [], []
    idxb2, lb2, ub2 = [], [], []
    C2, D2, lg2, ug2 = [], [], [], []
    for n in range(N + 1):
        ns_n, nu_n, nx_n = ns_v[n], nu_v[n], nx_v[n]
        if n < N:
            B2[n] = np.hstack([np.asarray(B[n], dtype=np.float64),
                               np.zeros((np.asarray(B[n]).shape[0],
                                         2 * ns_n))])
        Zrow = np.asarray(Zs[n]).reshape(-1)
        zrow = np.asarray(zs[n]).reshape(-1)
        Z_lo = Zrow[:ns_n]
        Z_up = Zrow[ns_n:2 * ns_n] if len(Zrow) >= 2 * ns_n else Z_lo
        z_lo = zrow[:ns_n]
        z_up = zrow[ns_n:2 * ns_n] if len(zrow) >= 2 * ns_n else z_lo
        Rn = np.asarray(R[n], dtype=np.float64).reshape(nu_n, nu_n)
        R2.append(np.block([
            [Rn, np.zeros((nu_n, 2 * ns_n))],
            [np.zeros((2 * ns_n, nu_n)), np.diag(np.concatenate([Z_lo,
                                                                 Z_up]))]]))
        Sn = np.asarray(S[n], dtype=np.float64).reshape(nu_n, nx_n)
        S2.append(np.vstack([Sn, np.zeros((2 * ns_n, nx_n))]))
        r2.append(np.concatenate([
            np.asarray(r[n], dtype=np.float64).reshape(-1), z_lo, z_up]))
        ib = (np.asarray(idxb[n], dtype=np.int64) if idxb is not None
              else np.zeros(0, np.int64))
        ib2 = np.where(ib >= nu_n, ib + 2 * ns_n, ib)
        idxb2.append(np.concatenate([ib2, nu_n + np.arange(2 * ns_n)]).astype(
            np.int32))
        lb2.append(np.concatenate([
            np.asarray(lb[n], dtype=np.float64).reshape(-1),
            np.zeros(2 * ns_n)]))
        ub2.append(np.concatenate([
            np.asarray(ub[n], dtype=np.float64).reshape(-1),
            np.full(2 * ns_n, _SLACK_BIG)]))
        Cn = np.zeros((2 * ns_n, nx_n))
        Dn = np.zeros((2 * ns_n, nu_n + 2 * ns_n))
        lg_n, ug_n = np.zeros(2 * ns_n), np.zeros(2 * ns_n)
        for k, j in enumerate(idxs[n]):
            for side, (row, sgn_s) in enumerate(((k, +1.0),
                                                 (ns_n + k, -1.0))):
                if j < nu_n:
                    Dn[row, j] = 1.0
                else:
                    Cn[row, j - nu_n] = 1.0
                Dn[row, nu_n + side * ns_n + k] = sgn_s
            lg_n[k] = np.asarray(lbs[n])[k]
            ug_n[k] = _SLACK_BIG
            lg_n[ns_n + k] = -_SLACK_BIG
            ug_n[ns_n + k] = np.asarray(ubs[n])[k]
        C2.append(Cn)
        D2.append(Dn)
        lg2.append(lg_n)
        ug2.append(ug_n)
    return (A2, B2, b2, Q2, S2, R2, q2, r2, idxb2, lb2, ub2, C2, D2, lg2,
            ug2, nu_v)


class SoftOCPSession:
    """Retained-state front door for soft re-solves at fixed matrix data
    (the soft twin of :class:`OCPSession`; the reference's soft interface
    offers ``warm_start`` only, ``fortran_order_interface.c:1442`` arg 12):
    :meth:`solve` re-solves for new vector data (b, q, r, lb, ub, lbs, ubs,
    x0) warm-started from the last solution."""

    def __init__(self, dims, cfg, mats, spec, sol, device):
        self.dims = dims
        self.cfg = cfg
        self.device = device
        self._mat = mats
        self._spec = spec
        self._sol = sol

    def solve(self, lbs=None, ubs=None, **vectors) -> OCPResult:
        m = self._mat
        dims, qp = pack_problem(
            m["N"], m["A"], m["B"], vectors.get("b", m["b"]), m["Q"],
            m["S"], m["R"], vectors.get("q", m["q"]), vectors.get("r", m["r"]),
            idxb=m["idxb"], lb=vectors.get("lb", m["lb"]),
            ub=vectors.get("ub", m["ub"]), x0=vectors.get("x0", m["x0"]),
            device=self.device)
        if dims != self.dims:
            raise ValueError("new data changed the problem geometry; start "
                             "a new session via solve_ocp_soft")
        if lbs is not None or ubs is not None:
            self._spec = _build_soft_spec(
                dims, m["idxs"], m["lbs"] if lbs is None else lbs,
                m["ubs"] if ubs is None else ubs, m["Zs"], m["zs"],
                qp.dtype, self.device)
        qpb = broadcast_qp(qp, 1)
        cfg = dataclasses.replace(self.cfg, warm_start=True)
        sol = _soft.solve(dims, qpb, self._spec, cfg, z0=self._sol.z,
                          pi0=self._sol.pi)
        self._sol = sol
        return _unpack_soft_result(
            dims, sol, _soft.compute_residuals(dims, qpb, self._spec, sol))


def solve_ocp_soft(N, A, B, b, Q, S, R, q, r, idxb, lb, ub, idxs, lbs, ubs,
                   Zs, zs, x0=None, N2=None, k_max=30, mu0=100.0,
                   mu_tol=1e-8, alpha_min=1e-8, return_session=False,
                   device=None):
    """Soft-constrained front door (the reference's
    ``fortran_order_d_ip_ocp_soft_tv``, ``test_d_ip_soft.c:420``): soft
    bounds ``lbs/ubs`` on logical ``[u;x]`` entries ``idxs`` with slack
    penalties ``Zs`` (quadratic) / ``zs`` (linear), per stage (ns_n,)
    arrays (or 2 ns_n for split lower/upper).

    ``N2 < N`` runs the partial-condensing pipeline on the exact hard
    slack reformulation (:func:`soft_to_hard_data`).  ``return_session``
    returns a :class:`SoftOCPSession`.  ``device``: None = the card."""
    device = resolve_device(device)
    cfg = _ipm.IPMConfig(k_max=k_max, mu0=mu0, mu_tol=mu_tol,
                         alpha_min=alpha_min)
    if N2 is not None and N2 < N:
        if return_session:
            raise ValueError("sessions are not supported with N2 < N")
        (A2, B2, b2, Q2, S2, R2, q2, r2, idxb2, lb2, ub2, C2, D2, lg2, ug2,
         nu_orig) = soft_to_hard_data(N, A, B, b, Q, S, R, q, r, idxb, lb,
                                      ub, idxs, lbs, ubs, Zs, zs)
        dims_h, qp_h = pack_problem(N, A2, B2, b2, Q2, S2, R2, q2, r2,
                                    idxb=idxb2, lb=lb2, ub=ub2, C=C2, D=D2,
                                    lg=lg2, ug=ug2, x0=x0, device=device)
        sol, _ = _cond.solve_partial_cond(dims_h, broadcast_qp(qp_h, 1), cfg,
                                          int(N2))
        result = _unpack_result(dims_h, sol)
        # the user's u is the first nu_orig[n] entries (slacks stripped)
        return result._replace(u=[un[:nu_orig[n]]
                                  for n, un in enumerate(result.u)])

    dims, qp = pack_problem(N, A, B, b, Q, S, R, q, r, idxb=idxb, lb=lb,
                            ub=ub, x0=x0, device=device)
    qpb = broadcast_qp(qp, 1)
    spec = _build_soft_spec(dims, idxs, lbs, ubs, Zs, zs, qp.dtype, device)
    sol = _soft.solve(dims, qpb, spec, cfg)
    result = _unpack_soft_result(
        dims, sol, _soft.compute_residuals(dims, qpb, spec, sol))
    if not return_session:
        return result
    mats = dict(N=N, A=A, B=B, b=b, Q=Q, S=S, R=R, q=q, r=r, idxb=idxb,
                lb=lb, ub=ub, x0=x0, idxs=idxs, lbs=lbs, ubs=ubs, Zs=Zs,
                zs=zs)
    return result, SoftOCPSession(dims, cfg, mats, spec, sol, device)


def solve_ocp_c_order(N, A, B, b, Q, S, R, q, r, idxb=None, lb=None,
                      ub=None, C=None, D=None, lg=None, ug=None, x0=None,
                      N2=None, k_max=30, mu0=2.0, mu_tol=1e-8,
                      alpha_min=1e-8, device=None) -> OCPResult:
    """Row-major twin of :func:`solve_ocp` (the reference's
    ``c_order_d_ip_ocp_hard_tv``, ``interfaces/c/c_order_interface.c``):
    every 2-D matrix argument is the TRANSPOSE of the fortran-order layout
    (the reference packs with ``d_cvt_tran_mat2pmat``); vectors and index
    lists are the same in both conventions."""
    tr = lambda seq: None if seq is None else [np.asarray(m).T for m in seq]  # noqa: E731
    return solve_ocp(N, tr(A), tr(B), b, tr(Q), tr(S), tr(R), q, r,
                     idxb=idxb, lb=lb, ub=ub, C=tr(C), D=tr(D), lg=lg, ug=ug,
                     x0=x0, N2=N2, k_max=k_max, mu0=mu0, mu_tol=mu_tol,
                     alpha_min=alpha_min, device=device)
