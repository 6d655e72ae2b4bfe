"""Debug printers (PyTorch twin of :mod:`hpmpc_tpu.utils.printing`): the
reference's ``d_print_mat`` / ``d_print_e_mat`` family
(``auxiliary/d_aux_extern_depend_lib4.c:212-334``), and structured printers
that strip the padding with the static dims, so what is printed is the
logical time-variant problem, not the padded tensors.  Tensors are copied
to the host; a batched QP or solution prints its instance ``index``.
"""

from __future__ import annotations

import numpy as np

from ..ocp import OCPDims, OCPQP


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def print_mat(M, name: str = "", fmt: str = "%9.5f", file=None) -> None:
    """Dense matrix printer (``d_print_mat``, ``:262``)."""
    M = np.atleast_2d(_np(M))
    if name:
        print(f"{name} ({M.shape[0]}x{M.shape[1]}):", file=file)
    for row in M:
        print(" ".join(fmt % v for v in row), file=file)


def print_e_mat(M, name: str = "", file=None) -> None:
    """Exponential-format printer (``d_print_e_mat``, ``:298``)."""
    print_mat(M, name=name, fmt="%9.2e", file=file)


def print_ocp_qp(dims: OCPDims, qp: OCPQP, file=None, index: int = 0) -> None:
    """Per-stage logical view of a packed OCP QP: [B'; A'; b'], [R S'; S Q],
    gradients, bounds and general-constraint rows with padding stripped
    (the reference prints its workspaces after packing,
    ``test_problems/test_d_ip_hard.c:481-493``)."""
    NU = dims.NU
    batched = qp.H.ndim == 4
    pick = lambda x: _np(x)[index] if batched else _np(x)  # noqa: E731
    F, H, g, b = pick(qp.F), pick(qp.H), pick(qp.g), pick(qp.b)
    idxb, d_lb, d_ub = pick(qp.idxb), pick(qp.d_lb), pick(qp.d_ub)
    C, d_lg, d_ug = pick(qp.C), pick(qp.d_lg), pick(qp.d_ug)
    for n in range(dims.N + 1):
        nun, nxn = dims.nu[n], dims.nx[n]
        zsel = list(range(nun)) + [NU + j for j in range(nxn)]
        print(f"--- stage {n}: nu={nun} nx={nxn} nb={dims.nb[n]} "
              f"ng={dims.ng[n]}", file=file)
        if n < dims.N:
            nxn1 = dims.nx[n + 1]
            print_mat(F[n][np.ix_(zsel, range(nxn1))], "F=[B';A']", file=file)
            print_mat(b[n][:nxn1], "b", file=file)
        print_mat(H[n][np.ix_(zsel, zsel)], "H=[R S'; S Q]", file=file)
        print_mat(g[n][zsel], "g=[r; q]", file=file)
        nbn = dims.nb[n]
        if nbn:
            print_mat(idxb[n, :nbn], "idxb", fmt="%5d", file=file)
            print_mat(d_lb[n, :nbn], "lb", file=file)
            print_mat(d_ub[n, :nbn], "ub", file=file)
        ngn = dims.ng[n]
        if ngn:
            print_mat(C[n][np.ix_(range(ngn), zsel)], "[D C]", file=file)
            print_mat(d_lg[n, :ngn], "lg", file=file)
            print_mat(d_ug[n, :ngn], "ug", file=file)


def print_solution(dims: OCPDims, sol, file=None, index: int = 0) -> None:
    """Logical per-stage view of an IPMSolution (u, x, pi) and its stat
    trace (the reference's post-solve printout, ``test_d_ip_hard.c:
    884-905``); of instance ``index`` when the solution is batched."""
    NU = dims.NU
    batched = _np(sol.z).ndim == 3
    pick = lambda x: _np(x)[index] if batched else _np(x)  # noqa: E731
    z, pi = pick(sol.z), pick(sol.pi)
    for n in range(dims.N + 1):
        print_mat(z[n, :dims.nu[n]], f"u[{n}]", file=file)
        print_mat(z[n, NU:NU + dims.nx[n]], f"x[{n}]", file=file)
    for n in range(dims.N):
        print_mat(pi[n, :dims.nx[n + 1]], f"pi[{n}]", file=file)
    kk = int(pick(sol.kk))
    print(f"iterations: {kk}  status: {int(pick(sol.status))}", file=file)
    print_e_mat(pick(sol.stat)[:kk],
                "stat {sigma, alpha_aff, mu_aff, alpha, mu}", file=file)
