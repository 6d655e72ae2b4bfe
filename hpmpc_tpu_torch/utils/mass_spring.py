"""Mass-spring benchmark fixture (PyTorch twin of
:mod:`hpmpc_tpu.utils.mass_spring`).

nx/2 masses in a chain connected by unit springs, nu forces on the first
masses, zero-order-hold discretization at Ts.  The arrays are built in
float64 numpy exactly as the JAX fixture builds them and cast once, so
both packages see the same numbers bit for bit; :func:`mass_spring_soft_qp`
is the reference's soft benchmark problem on the same plant.
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
