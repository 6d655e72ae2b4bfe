"""Problem containers for time-variant linear-quadratic optimal control.

PyTorch twin of :mod:`hpmpc_tpu.ocp`: static padded maxima plus masks, stage
data stacked along a leading stage axis, coordinate convention
``z_n = [u_n (NU padded); x_n (NX padded)]``.  ``OCPQP`` is a dataclass of
tensors; every leaf may carry a leading batch axis (instances).

Padding invariants (relied on by the solvers):
  * ``F``/``b``/``g``/``C`` are zero in padded rows/columns;
  * ``H`` is zero in padded rows/columns; solvers add ``diag(pad_diag)``
    before factorizing;
  * padded ``idxb`` entries are 0 and always multiplied by ``nb_mask``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


def _round_tuple(v, n) -> tuple:
    if np.isscalar(v):
        return tuple(int(v) for _ in range(n))
    return tuple(int(x) for x in v)


@dataclasses.dataclass(frozen=True)
class OCPDims:
    """Static dimensions of a time-variant OCP QP (hashable).

    Mirrors the reference's ``(N, nx[], nu[], nb[], ng[])`` signature;
    ``idxb`` is the static copy of the box index lists (logical ``[u;x]``
    indices per stage), or None if unknown."""

    N: int
    nx: tuple  # length N+1, nx[0] == 0 when the initial state is eliminated
    nu: tuple  # length N+1, nu[N] == 0
    nb: tuple  # length N+1
    ng: tuple  # length N+1
    idxb: tuple | None = None

    @staticmethod
    def create(N, nx, nu, nb=0, ng=0, idxb=None) -> "OCPDims":
        if idxb is not None:
            idxb = tuple(tuple(int(i) for i in row) for row in idxb)
        return OCPDims(
            N=int(N),
            nx=_round_tuple(nx, N + 1),
            nu=_round_tuple(nu, N + 1),
            nb=_round_tuple(nb, N + 1),
            ng=_round_tuple(ng, N + 1),
            idxb=idxb,
        )

    @property
    def NX(self) -> int:
        return max(self.nx)

    @property
    def NU(self) -> int:
        return max(self.nu)

    @property
    def NZ(self) -> int:
        return self.NU + self.NX

    @property
    def NB(self) -> int:
        return max(max(self.nb), 1)

    @property
    def NG(self) -> int:
        return max(max(self.ng), 1)

    @property
    def n_constr(self) -> int:
        """Total two-sided constraint count sum(2 nb + 2 ng): the
        duality-measure scaling is 1/n_constr."""
        return 2 * sum(self.nb) + 2 * sum(self.ng)

    def z_mask(self) -> np.ndarray:
        m = np.zeros((self.N + 1, self.NZ))
        for n in range(self.N + 1):
            m[n, : self.nu[n]] = 1.0
            m[n, self.NU : self.NU + self.nx[n]] = 1.0
        return m

    def x_mask(self) -> np.ndarray:
        m = np.zeros((self.N + 1, self.NX))
        for n in range(self.N + 1):
            m[n, : self.nx[n]] = 1.0
        return m

    def nb_mask(self) -> np.ndarray:
        m = np.zeros((self.N + 1, self.NB))
        for n in range(self.N + 1):
            m[n, : self.nb[n]] = 1.0
        return m

    def ng_mask(self) -> np.ndarray:
        m = np.zeros((self.N + 1, self.NG))
        for n in range(self.N + 1):
            m[n, : self.ng[n]] = 1.0
        return m


@dataclasses.dataclass(frozen=True)
class OCPQP:
    """Stacked-stage OCP QP data (tensors; an optional leading batch axis).

    min  sum_n 1/2 z_n' H_n z_n + g_n' z_n
    s.t. x_{n+1} = F_n' z_n + b_n                      (n = 0..N-1)
         d_lb <= z_n[idxb_n] <= d_ub
         d_lg <= C_n z_n     <= d_ug
    """

    F: torch.Tensor  # (N, NZ, NX)   rows [B'; A'] per stage
    b: torch.Tensor  # (N, NX)
    H: torch.Tensor  # (N+1, NZ, NZ) [[R, S'], [S, Q]]
    g: torch.Tensor  # (N+1, NZ)     [r; q]
    idxb: torch.Tensor  # (N+1, NB) int32, padded-coordinate indices into z
    d_lb: torch.Tensor  # (N+1, NB)
    d_ub: torch.Tensor  # (N+1, NB)
    C: torch.Tensor  # (N+1, NG, NZ)
    d_lg: torch.Tensor  # (N+1, NG)
    d_ug: torch.Tensor  # (N+1, NG)
    z_mask: torch.Tensor  # (N+1, NZ)
    x_mask: torch.Tensor  # (N+1, NX)
    nb_mask: torch.Tensor  # (N+1, NB)
    ng_mask: torch.Tensor  # (N+1, NG)

    @property
    def pad_diag(self) -> torch.Tensor:
        """Ones on padded z coordinates: added to diag(H) before factorizing."""
        return 1.0 - self.z_mask

    @property
    def dtype(self) -> torch.dtype:
        return self.H.dtype

    @property
    def device(self) -> torch.device:
        return self.H.device

    def to(self, device=None, dtype=None) -> "OCPQP":
        """Move every leaf to ``device``; float leaves also cast to ``dtype``
        (the int32 ``idxb`` keeps its type)."""
        out = {}
        for f in dataclasses.fields(self):
            x = getattr(self, f.name)
            dt = dtype if (dtype is not None and x.is_floating_point()) else None
            out[f.name] = x.to(device=device, dtype=dt)
        return OCPQP(**out)


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds its tensors on: ``device`` as
    given, or the CUDA card when it is None.  There is no fallback: where
    torch has no card, the first tensor made there raises."""
    return torch.device("cuda") if device is None else torch.device(device)


def pack_offsets(dims: OCPDims, b: Sequence[np.ndarray]) -> np.ndarray:
    """The dynamics offsets ``b[n]`` (n < N) padded to ``(N, NX)`` float64,
    as :func:`pack_ocp` stores them."""
    bb = np.zeros((dims.N, dims.NX))
    for n in range(dims.N):
        nx1 = dims.nx[n + 1]
        bb[n, :nx1] = np.asarray(b[n]).reshape(nx1)
    return bb


def pack_ocp(
    dims: OCPDims,
    A: Sequence[np.ndarray],
    B: Sequence[np.ndarray],
    b: Sequence[np.ndarray],
    Q: Sequence[np.ndarray],
    S: Sequence[np.ndarray],
    R: Sequence[np.ndarray],
    q: Sequence[np.ndarray],
    r: Sequence[np.ndarray],
    idxb: Sequence[np.ndarray] | None = None,
    lb: Sequence[np.ndarray] | None = None,
    ub: Sequence[np.ndarray] | None = None,
    C: Sequence[np.ndarray] | None = None,
    D: Sequence[np.ndarray] | None = None,
    lg: Sequence[np.ndarray] | None = None,
    ug: Sequence[np.ndarray] | None = None,
    dtype=torch.float64,
    device=None,
) -> OCPQP:
    """Pack per-stage dense numpy data into an :class:`OCPQP`.

    Stage lists follow the reference's high-level API semantics:
    ``A[n], B[n], b[n]`` map stage n to n+1; ``Q[n], S[n], R[n]`` are the
    stage costs with ``Q[N]`` terminal; ``idxb[n]`` indexes the logical
    ``[u;x]`` vector of stage n.  The arrays are assembled in float64 numpy
    exactly as :func:`hpmpc_tpu.ocp.pack_ocp` does, then cast once onto
    ``device`` (default: the CUDA card, see :func:`resolve_device`)."""
    device = resolve_device(device)
    N = dims.N
    NX, NU, NZ, NB, NG = dims.NX, dims.NU, dims.NZ, dims.NB, dims.NG

    F = np.zeros((N, NZ, NX))
    for n in range(N):
        nxn, nun, nx1 = dims.nx[n], dims.nu[n], dims.nx[n + 1]
        Bn = np.asarray(B[n]).reshape(nx1, nun) if nun else np.zeros((nx1, 0))
        An = np.asarray(A[n]).reshape(nx1, nxn) if nxn else np.zeros((nx1, 0))
        F[n, :nun, :nx1] = Bn.T
        F[n, NU : NU + nxn, :nx1] = An.T
    bb = pack_offsets(dims, b)

    H = np.zeros((N + 1, NZ, NZ))
    gg = np.zeros((N + 1, NZ))
    for n in range(N + 1):
        nxn, nun = dims.nx[n], dims.nu[n]
        if nun:
            H[n, :nun, :nun] = np.asarray(R[n]).reshape(nun, nun)
            gg[n, :nun] = np.asarray(r[n]).reshape(nun)
        if nxn:
            H[n, NU : NU + nxn, NU : NU + nxn] = np.asarray(Q[n]).reshape(nxn, nxn)
            gg[n, NU : NU + nxn] = np.asarray(q[n]).reshape(nxn)
        if nun and nxn:
            Sn = np.asarray(S[n]).reshape(nun, nxn)
            H[n, :nun, NU : NU + nxn] = Sn
            H[n, NU : NU + nxn, :nun] = Sn.T

    idxb_p = np.zeros((N + 1, NB), dtype=np.int32)
    dlb = np.zeros((N + 1, NB))
    dub = np.zeros((N + 1, NB))
    for n in range(N + 1):
        nbn, nun = dims.nb[n], dims.nu[n]
        if nbn and idxb is not None:
            for k in range(nbn):
                j = int(idxb[n][k])
                idxb_p[n, k] = j if j < nun else NU + (j - nun)
            dlb[n, :nbn] = np.asarray(lb[n]).reshape(nbn)
            dub[n, :nbn] = np.asarray(ub[n]).reshape(nbn)

    CC = np.zeros((N + 1, NG, NZ))
    dlg = np.zeros((N + 1, NG))
    dug = np.zeros((N + 1, NG))
    for n in range(N + 1):
        ngn, nun, nxn = dims.ng[n], dims.nu[n], dims.nx[n]
        if ngn:
            if D is not None and nun:
                CC[n, :ngn, :nun] = np.asarray(D[n]).reshape(ngn, nun)
            if C is not None and nxn:
                CC[n, :ngn, NU : NU + nxn] = np.asarray(C[n]).reshape(ngn, nxn)
            dlg[n, :ngn] = np.asarray(lg[n]).reshape(ngn)
            dug[n, :ngn] = np.asarray(ug[n]).reshape(ngn)

    def as_t(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    return OCPQP(
        F=as_t(F),
        b=as_t(bb),
        H=as_t(H),
        g=as_t(gg),
        idxb=torch.as_tensor(idxb_p, device=device),
        d_lb=as_t(dlb),
        d_ub=as_t(dub),
        C=as_t(CC),
        d_lg=as_t(dlg),
        d_ug=as_t(dug),
        z_mask=as_t(dims.z_mask()),
        x_mask=as_t(dims.x_mask()),
        nb_mask=as_t(dims.nb_mask()),
        ng_mask=as_t(dims.ng_mask()),
    )
