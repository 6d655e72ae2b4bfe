"""Mass-spring benchmark fixture (PyTorch twin of
:mod:`hpmpc_tpu.utils.mass_spring`).

nx/2 masses in a chain connected by unit springs, nu forces on the first
masses, zero-order-hold discretization at Ts.  The arrays are built in
float64 numpy exactly as the JAX fixture builds them and cast once, so
both packages see the same numbers bit for bit; :func:`mass_spring_soft_qp`
is the reference's soft benchmark problem on the same plant and
:func:`mass_spring_tree_qp` its scenario-tree problem.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from ..ocp import OCPDims, OCPQP, pack_ocp


def mass_spring_ab(nx: int, nu: int, Ts: float = 0.5):
    """Discrete-time (A, B) of the mass-spring chain (ZOH discretization)."""
    pp = nx // 2
    T = np.zeros((pp, pp))
    np.fill_diagonal(T, -2.0)
    for i in range(pp - 1):
        T[i + 1, i] = 1.0
        T[i, i + 1] = 1.0
    Ac = np.zeros((nx, nx))
    Ac[:pp, pp:] = np.eye(pp)
    Ac[pp:, :pp] = T
    Bc = np.zeros((nx, nu))
    Bc[pp : pp + nu, :] = np.eye(nu)

    A = scipy.linalg.expm(Ts * Ac)
    B = np.linalg.solve(Ac, (A - np.eye(nx)) @ Bc)
    return A, B


def mass_spring_qp(
    nx: int,
    nu: int,
    N: int,
    ng: int = 0,
    ngN: int = 0,
    Ts: float = 0.5,
    dtype=torch.float64,
    device=None,
    A: np.ndarray | None = None,
    B: np.ndarray | None = None,
) -> tuple[OCPDims, OCPQP]:
    """Box(+general)-constrained mass-spring MPC QP.

    x0 eliminated (nx[0]=0, b0 = b + A x0), u in [-0.5, 0.5], first nx/2
    states in [-4, 4], Q=I, R=2I, S=0, q=0.1, r=0.2, b=0.1,
    x0=(2.5, 2.5, 0, ...).  Optional general constraints: stages 1..N-1
    bound states x[0:ng] in [-100, 100]; stage N imposes x[0:ngN] == 0.
    The QP lands on ``device``, by default the CUDA card."""
    nb = nu + nx // 2
    nbu = min(nu, nb)
    nbx = max(nb - nu, 0)

    if A is None or B is None:
        A, B = mass_spring_ab(nx, nu, Ts)
    b = 0.1 * np.ones(nx)
    x0 = np.zeros(nx)
    x0[0] = 2.5
    x0[1] = 2.5
    b0 = b + A @ x0

    nx_v = (0,) + (nx,) * N
    nu_v = (nu,) * N + (0,)
    nb_v = (nbu,) + (nb,) * (N - 1) + (nbx,)
    ng_v = (0,) + (ng,) * (N - 1) + (ngN,)

    A_l = [np.zeros((nx, 0))] + [A] * (N - 1)
    B_l = [B] * N
    b_l = [b0] + [b] * (N - 1)
    Q_l = [np.zeros((0, 0))] + [np.eye(nx)] * N
    R_l = [2.0 * np.eye(nu)] * N + [np.zeros((0, 0))]
    S_l = [np.zeros((nu, 0))] + [np.zeros((nu, nx))] * (N - 1) + [np.zeros((0, nx))]
    q_l = [np.zeros(0)] + [0.1 * np.ones(nx)] * N
    r_l = [0.2 * np.ones(nu)] * N + [np.zeros(0)]

    idxb, lb, ub = [], [], []
    for n in range(N + 1):
        if n < N:
            idx = list(range(nbu)) + list(range(nu, nu + (nb_v[n] - nbu)))
            lo = [-0.5] * nbu + [-4.0] * (nb_v[n] - nbu)
            hi = [0.5] * nbu + [4.0] * (nb_v[n] - nbu)
        else:
            idx = list(range(nbx))
            lo = [-4.0] * nbx
            hi = [4.0] * nbx
        idxb.append(np.array(idx, dtype=np.int32))
        lb.append(np.array(lo))
        ub.append(np.array(hi))

    dims = OCPDims.create(N, nx_v, nu_v, nb_v, ng_v, idxb=idxb)

    C_l, D_l, lg_l, ug_l = [], [], [], []
    for n in range(N + 1):
        g_n = ng_v[n]
        Cn = np.zeros((g_n, nx_v[n]))
        for j in range(g_n):
            Cn[j, j] = 1.0
        C_l.append(Cn)
        D_l.append(np.zeros((g_n, nu_v[n])))
        if n == N:
            lg_l.append(np.zeros(g_n))
            ug_l.append(np.zeros(g_n))
        else:
            lg_l.append(-100.0 * np.ones(g_n))
            ug_l.append(100.0 * np.ones(g_n))

    qp = pack_ocp(
        dims,
        A_l, B_l, b_l,
        Q_l, S_l, R_l, q_l, r_l,
        idxb=idxb, lb=lb, ub=ub,
        C=C_l, D=D_l, lg=lg_l, ug=ug_l,
        dtype=dtype, device=device,
    )
    return dims, qp


def mass_spring_soft_qp(
    nx: int,
    nu: int,
    N: int,
    Z: float = 0.0,
    z_lin: float = 100.0,
    Ts: float = 0.5,
    dtype=torch.float64,
    device=None,
    A: np.ndarray | None = None,
    B: np.ndarray | None = None,
):
    """Soft-constrained mass-spring fixture (reference
    ``test_problems/test_d_ip_soft.c:165-258``): hard input boxes u in
    [-0.5, 0.5], soft state constraints x in [-1, 1] with slack penalties
    (quadratic ``Z``, linear ``z_lin``); Q=0, q=0.1, R=2I, r=0.2, b=0,
    x0=(3.5, 3.5, 0, ...).  Returns (dims, qp, :class:`SoftSpec`) on
    ``device``, by default the CUDA card."""
    from ..models.ipm_soft import SoftSpec
    from ..ocp import resolve_device

    if A is None or B is None:
        A, B = mass_spring_ab(nx, nu, Ts)
    b = np.zeros(nx)
    x0 = np.zeros(nx)
    x0[0] = 3.5
    x0[1] = 3.5
    b0 = A @ x0

    nx_v = (0,) + (nx,) * N
    nu_v = (nu,) * N + (0,)
    nb_v = (nu,) * N + (0,)
    ng_v = (0,) * (N + 1)

    idxb = [np.arange(nb_v[n], dtype=np.int32) for n in range(N + 1)]
    dims = OCPDims.create(N, nx_v, nu_v, nb_v, ng_v, idxb=idxb)

    A_l = [np.zeros((nx, 0))] + [A] * (N - 1)
    B_l = [B] * N
    b_l = [b0] + [b] * (N - 1)
    Q_l = [np.zeros((0, 0))] + [np.zeros((nx, nx))] * N
    R_l = [2.0 * np.eye(nu)] * N + [np.zeros((0, 0))]
    S_l = [np.zeros((nu, 0))] + [np.zeros((nu, nx))] * (N - 1) + [np.zeros((0, nx))]
    q_l = [np.zeros(0)] + [0.1 * np.ones(nx)] * N
    r_l = [0.2 * np.ones(nu)] * N + [np.zeros(0)]
    lb = [-0.5 * np.ones(nb_v[n]) for n in range(N + 1)]
    ub = [0.5 * np.ones(nb_v[n]) for n in range(N + 1)]

    qp = pack_ocp(
        dims, A_l, B_l, b_l, Q_l, S_l, R_l, q_l, r_l,
        idxb=idxb, lb=lb, ub=ub, dtype=dtype, device=device,
    )

    # soft spec: states of stages 1..N, padded coords NU + j
    NS = nx
    NU = dims.NU
    idxbs = np.zeros((N + 1, NS), dtype=np.int32)
    ns_mask = np.zeros((N + 1, NS))
    for n in range(1, N + 1):
        idxbs[n] = NU + np.arange(NS)
        ns_mask[n] = 1.0
    device = resolve_device(device)

    def as_t(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    soft = SoftSpec(
        idxbs=torch.as_tensor(idxbs, device=device),
        d_lbs=as_t(-1.0 * np.ones((N + 1, NS))),
        d_ubs=as_t(1.0 * np.ones((N + 1, NS))),
        Z=as_t(Z * np.ones((N + 1, 2, NS))),
        z_lin=as_t(z_lin * np.ones((N + 1, 2, NS))),
        ns_mask=as_t(ns_mask),
    )
    return dims, qp, soft


def mass_spring_data(nx: int, nu: int, N: int, ngN: int = 0,
                     A: np.ndarray | None = None,
                     B: np.ndarray | None = None,
                     bounds_as_rows: bool = False) -> dict:
    """The per-stage fortran-order data of :func:`mass_spring_qp` for the
    public API (:func:`..api.solve_ocp` keyword arguments, ``N`` included):
    the free initial state x0=(2.5, 2.5, 0, ...) passed as ``x0``, u in
    [-0.5, 0.5], the first nx/2 states in [-4, 4] (stage 0's state bounds
    dropped with x0, as the API does), Q=I, R=2I, S=0, q=0.1, r=0.2,
    b=0.1; ``ngN`` > 0 adds the terminal equality x[0:ngN] == 0.

    ``bounds_as_rows``: the same bounds as general rows (``D`` rows for
    u, ``C`` rows for x) and no box rows (``idxb`` one empty list per
    stage): a problem with general rows and no box rows."""
    if A is None or B is None:
        A, B = mass_spring_ab(nx, nu)
    x0 = np.zeros(nx)
    x0[0] = x0[1] = 2.5
    data = dict(
        N=N, A=[A] * N, B=[B] * N, b=[0.1 * np.ones(nx)] * N,
        Q=[np.eye(nx)] * (N + 1),
        S=[np.zeros((nu, nx))] * N + [np.zeros((0, nx))],
        R=[2.0 * np.eye(nu)] * N + [np.zeros((0, 0))],
        q=[0.1 * np.ones(nx)] * (N + 1),
        r=[0.2 * np.ones(nu)] * N + [np.zeros(0)], x0=x0)
    # logical [u; x] indices and bounds per stage (stage 0's state bounds
    # go with the eliminated x0)
    idx = [list(range(nu + (nx // 2 if n else 0))) if n < N
           else list(range(nx // 2)) for n in range(N + 1)]
    lo = [np.array([-0.5 if (j < nu and n < N) else -4.0 for j in idx[n]])
          for n in range(N + 1)]
    rows_C = [np.zeros((0, nx))] * (N + 1)
    rows_D = [np.zeros((0, nu if n < N else 0)) for n in range(N + 1)]
    rows_lo = [np.zeros(0)] * (N + 1)
    if bounds_as_rows:
        rows_C, rows_D, rows_lo = [], [], lo
        for n in range(N + 1):
            nun = nu if n < N else 0
            Cn, Dn = np.zeros((len(idx[n]), nx)), np.zeros((len(idx[n]), nun))
            for i, j in enumerate(idx[n]):
                if j < nun:
                    Dn[i, j] = 1.0
                else:
                    Cn[i, j - nun] = 1.0
            rows_C.append(Cn)
            rows_D.append(Dn)
        idx = [[] for _ in range(N + 1)]
        lo = [np.zeros(0)] * (N + 1)
    if ngN:
        rows_C[N] = np.vstack([rows_C[N], np.eye(ngN, nx)])
        rows_D[N] = np.zeros((rows_C[N].shape[0], 0))
        rows_lo[N] = np.concatenate([rows_lo[N], np.zeros(ngN)])
    data.update(idxb=[np.array(i, dtype=np.int32) for i in idx], lb=lo,
                ub=[-v for v in lo])
    if bounds_as_rows or ngN:
        ug = [np.where(v == 0, 0.0, -v) for v in rows_lo]
        data.update(C=rows_C, D=rows_D, lg=rows_lo, ug=ug)
    return data


def mass_spring_tree_qp(md=2, Nr=1, Nh=3, nx=4, nu=2, u_max=0.35,
                        ng_nodes=(), dtype=torch.float32, device=None):
    """Input-boxed scenario-tree QP on the mass-spring plant (twin of
    :func:`hpmpc_tpu.utils.mass_spring.mass_spring_tree_qp`): the
    reference's tree topology ``setup_tree(md, Nr, Nh)``
    (``test_problems/test_d_tree_ric_libstr.c:61-93``), per-EDGE dynamics
    and offsets (edge e into node e+1: A scaled by ``1 + 0.03 (e+1 mod
    5)``, ``b[e, 0]`` grows with e), node costs with ``rng(3)`` diagonal
    jitter in Q, and an optional general row (input sum + 0.3 state sum in
    [-1.2, 1.2]) on ``ng_nodes``.

    Returns ``(tdef, dims, qp)`` with node/edge arrays as in
    :mod:`..models.tree`, built in float64 numpy as the JAX fixture builds
    them and cast once, on ``device`` (by default the CUDA card)."""
    from ..models import tree as _tree
    from ..ocp import resolve_device

    A, B_ = mass_spring_ab(nx, nu)
    tdef = _tree.TreeDef.from_md_nr_nh(md, Nr, Nh)
    n, dad = tdef.n_nodes, tdef.dad
    is_leaf = [True] * n
    for k in range(1, n):
        is_leaf[dad[k]] = False

    nx_v = [0] + [nx] * (n - 1)
    nu_v = [0 if is_leaf[k] else nu for k in range(n)]
    nb_v = list(nu_v)
    ng_v = [1 if k in ng_nodes else 0 for k in range(n)]
    idxb = [np.arange(m, dtype=np.int32) for m in nb_v]
    dims = OCPDims.create(n - 1, nx_v, nu_v, nb_v, ng_v, idxb=idxb)
    NU, NX, NZ, NB, NG = dims.NU, dims.NX, dims.NZ, dims.NB, dims.NG

    F = np.zeros((n - 1, NZ, NX))
    for k in range(1, n):
        p = dad[k]
        Ak = A * (1.0 + 0.03 * (k % 5))
        F[k - 1, : nu_v[p], :nx] = B_.T[: nu_v[p]]
        F[k - 1, NU : NU + nx_v[p], :nx] = Ak.T[: nx_v[p]]
    b = np.zeros((n - 1, NX))
    b[:, :nx] = 0.1
    b[:, 0] += 0.02 * np.arange(n - 1)

    H = np.zeros((n, NZ, NZ))
    rng = np.random.default_rng(3)
    for k in range(n):
        H[k, : nu_v[k], : nu_v[k]] = 0.5 * np.eye(nu_v[k])
        Qk = np.eye(nx_v[k]) + 0.05 * np.diag(rng.random(nx_v[k]))
        H[k, NU : NU + nx_v[k], NU : NU + nx_v[k]] = Qk
    g = np.zeros((n, NZ))
    g[:, NU : NU + nx] = 0.05

    idxb_p = np.zeros((n, NB), dtype=np.int32)
    d_lb = np.zeros((n, NB))
    d_ub = np.zeros((n, NB))
    for k in range(n):
        idxb_p[k, : nb_v[k]] = np.arange(nb_v[k])
        d_lb[k, : nb_v[k]] = -u_max
        d_ub[k, : nb_v[k]] = u_max

    C = np.zeros((n, NG, NZ))
    d_lg = np.zeros((n, NG))
    d_ug = np.zeros((n, NG))
    for k in ng_nodes:
        C[k, 0, : nu_v[k]] = 1.0
        C[k, 0, NU : NU + nx_v[k]] = 0.3
        d_lg[k, 0] = -1.2
        d_ug[k, 0] = 1.2

    device = resolve_device(device)

    def as_t(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    qp = OCPQP(
        F=as_t(F), b=as_t(b), H=as_t(H), g=as_t(g),
        idxb=torch.as_tensor(idxb_p, device=device), d_lb=as_t(d_lb),
        d_ub=as_t(d_ub), C=as_t(C), d_lg=as_t(d_lg), d_ug=as_t(d_ug),
        z_mask=as_t(dims.z_mask()), x_mask=as_t(dims.x_mask()),
        nb_mask=as_t(dims.nb_mask()), ng_mask=as_t(dims.ng_mask()))
    return tdef, dims, qp
