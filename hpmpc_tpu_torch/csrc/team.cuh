// The team helpers and team stage routines of the kernels that run one
// instance on a team of TEAM lanes of one warp: csrc/ipm_resident.cu (rows
// 1 and 1s), csrc/factor_solve_mega.cu and csrc/solve_mega.cu (rows 19 and
// 20).
//
// A team's lane r owns the rows r, r + TEAM, ... of every NZ-row object of
// a stage (M, F / W, g, m, the Ll / Lxx rows, z), the x indices likewise,
// and the box pairs with k % TEAM == r.  The stage objects live in a
// per-team slab of shared memory; `mask` names the team's lanes, so its
// warp barriers never wait on another team of the warp.
//
// Every entry keeps the expression and the summation order of the
// one-thread kernels (csrc/stage_math.cuh), so a team kernel gives the
// one-thread kernel's outputs bit for bit.  nvcc contracts an unrolled
// one-thread sum in a way a lane's runtime loop does not repeat, so every
// sum over a lane's runtime range is written with explicit roundings
// (mul_rn, fma_rn, dot_chain) as nvcc rounded the one-thread sum.
#pragma once

#include <utility>

#include "stage_math.cuh"

namespace hp {

// Rounded products and FMAs that nvcc never contracts further.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// sum_{q = q0..q1} a_q b_q (term(q, a, b) gives a_q, b_q) over a lane's
// runtime range, rounded as nvcc rounded the unrolled sum in one thread
// (hp::pb_of, hp::pi_of_x): the first product fused with the rounded
// second, each later product into the running sum; one term is a rounded
// product.
template <typename T, typename Term>
__device__ __forceinline__ T dot_chain(int q0, int q1, Term term) {
  T a0, b0;
  term(q0, a0, b0);
  if (q1 == q0) return mul_rn(a0, b0);
  T a1, b1;
  term(q0 + 1, a1, b1);
  T acc = fma_rn(a0, b0, mul_rn(a1, b1));
  for (int q = q0 + 2; q <= q1; ++q) {
    T a, b;
    term(q, a, b);
    acc = fma_rn(a, b, acc);
  }
  return acc;
}

// the fraction-to-boundary candidate pair of one slot (alpha_sums' terms)
template <typename T>
__device__ __forceinline__ T cand_pair(T lam, T t, T mb, T dt, T dl) {
  return nmin(alpha_cand(lam, dl, mb), alpha_cand(t, dt, mb));
}

// hp::alpha_sums on slab rows whose candidate pairs are formed: the
// minimum and the three partial sums in row order, each rounded as nvcc
// rounds the one-thread loop (e2: its first product rounded, each later
// one contracted into the sum).  Slot i's mask is mb[i % MOD] (MOD = K2
// for box and ng rows, NS for soft rows).  RES: after hp::dt_dlam_res,
// whose dl shares the product lam dt, nvcc fused the other product of
// each e1 term, t dl, with lam dt rounded.
template <typename T, int K2, int MOD, bool RES = false>
__device__ __forceinline__ void alpha_chain(const T* lam, const T* t,
                                            const T* mb, const T* dt,
                                            const T* dl, const T* cp,
                                            T& amin, T& s0, T& s1, T& s2) {
  T cmin = cp[0];
  T e0 = lam[0] * t[0] * mb[0];
  T e1;
  if constexpr (RES)
    e1 = fma_rn(t[0], dl[0], mul_rn(lam[0], dt[0]));
  else
    e1 = lam[0] * dt[0] + t[0] * dl[0];
  T e2 = mul_rn(dl[0], dt[0]);
#pragma unroll
  for (int i = 1; i < K2; ++i) {
    cmin = nmin(cmin, cp[i]);
    e0 = e0 + lam[i] * t[i] * mb[i % MOD];
    if constexpr (RES)
      e1 = e1 + fma_rn(t[i], dl[i], mul_rn(lam[i], dt[i]));
    else
      e1 = e1 + (lam[i] * dt[i] + t[i] * dl[i]);
    e2 = fma_rn(dl[i], dt[i], e2);
  }
  amin = nmin(amin, cmin);
  s0 = s0 + e0;
  s1 = s1 + e1;
  s2 = s2 + e2;
}

// The phase-1 box direction of pair i (hp::dt_dlam) with the centering
// values dl0 of its two slots, into the slab rows dt, dl with its
// candidate pairs cp.
template <typename T, int NB>
__device__ __forceinline__ void box_dir(int i, T zb, T dl0_lo, T dl0_up,
                                        const T* lam, const T* t,
                                        const T* mb, const T* A, T* dt,
                                        T* dl, T* cp) {
  const T dt_lo = ((zb - A[i]) - t[i]) * mb[i];
  const T dt_up = ((A[NB + i] - zb) - t[NB + i]) * mb[NB + i];
  T ti, lt_lo, lt_up;
  t_inv_lamt(lam[i], t[i], mb[i], ti, lt_lo);
  t_inv_lamt(lam[NB + i], t[NB + i], mb[NB + i], ti, lt_up);
  const T dl_lo = (dl0_lo - lt_lo * dt_lo - lam[i]) * mb[i];
  const T dl_up = (dl0_up - lt_up * dt_up - lam[NB + i]) * mb[NB + i];
  dt[i] = dt_lo;
  dt[NB + i] = dt_up;
  dl[i] = dl_lo;
  dl[NB + i] = dl_up;
  cp[i] = cand_pair(lam[i], t[i], mb[i], dt_lo, dl_lo);
  cp[NB + i] = cand_pair(lam[NB + i], t[NB + i], mb[NB + i], dt_up, dl_up);
}

// zb = z[j] as hp::gather_box's select chain takes it (slot 0 outside
// [0, NZ))
template <typename T, int NZ>
__device__ __forceinline__ T gather(const T* z, int j) {
  return (j >= 1 && j < NZ) ? z[j] : z[0];
}

// u = -Luu^{-T} (eu + Lxu' x) (hp::u_of_x) from the slab rows Ll (NZ x NU)
// and eu, in every lane
template <typename T, int NU, int NX>
__device__ __forceinline__ void u_of_x(const T* Ll, const T* eu, const T* x,
                                       T (&u)[NU]) {
  T Du[NU], rhs[NU], y[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) Du[i] = T(1) / nmax(Ll[i * NU + i], T(1e-30));
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    T acc = eu[i];
#pragma unroll
    for (int q = 0; q < NX; ++q) acc = acc + Ll[(NU + q) * NU + i] * x[q];
    rhs[i] = acc;
  }
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) {
    T acc = rhs[i];
#pragma unroll
    for (int j = i + 1; j < NU; ++j) acc = acc - Ll[j * NU + i] * y[j];
    y[i] = acc * Du[i];
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = -y[i];
}

// eu = Luu^{-1} m_u (hp::tril_solve) from the slab rows m, L (leading
// dimension ld) with the pivots Dinv, in every lane
template <typename T, int NU>
__device__ __forceinline__ void eu_of_m(const T* m, const T* L, int ld,
                                        const T (&Dinv)[NU], T (&eu)[NU]) {
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    T acc = m[i];
#pragma unroll
    for (int j = 0; j < i; ++j) acc = acc - L[i * ld + j] * eu[j];
    eu[i] = acc * Dinv[i];
  }
}

// x_next = b + F' z, rows j = r, r + TEAM, ... (hp::x_next_of) from the
// slab rows b, F (NZ x NX) and z
template <int TEAM, typename T, int NZ, int NX>
__device__ __forceinline__ void x_next(int r, const T* b, const T* F,
                                       const T* z, T* xn) {
  for (int j = r; j < NX; j += TEAM) {
    T acc = b[j];
#pragma unroll
    for (int i = 0; i < NZ; ++i) acc = acc + F[i * NX + j] * z[i];
    xn[j] = acc;
  }
}

// x0 = -(Lxx Lxx')^{-1} px (hp::root_x0) in every lane, L(i, j) the lower
// triangle; the owners of the x rows store them into x
template <int TEAM, typename T, int NX, typename L>
__device__ __forceinline__ void root_x0(int r, const L& Lxx, const T* px,
                                        T* x) {
  T D[NX], tt[NX], xx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) D[i] = T(1) / nmax(Lxx(i, i), T(1e-30));
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    T acc = -px[i];
#pragma unroll
    for (int j = 0; j < i; ++j) acc = acc - Lxx(i, j) * tt[j];
    tt[i] = acc * D[i];
  }
#pragma unroll
  for (int i = NX - 1; i >= 0; --i) {
    T acc = tt[i];
#pragma unroll
    for (int j = i + 1; j < NX; ++j) acc = acc - Lxx(j, i) * xx[j];
    xx[i] = acc * D[i];
  }
#pragma unroll
  for (int i = 0; i < NX; ++i)
    if (i % TEAM == r) x[i] = xx[i];
}

// pi = Lxx (Lxx' x) + px (hp::pi_of_x) on the packed lower triangle Lx:
// the first half, t1 = Lxx' x, rows r, r + TEAM, ...; a team barrier; the
// second half, pi_i = px_i + sum_q Lxx_iq t1_q, its rows to out(i, pi_i)
template <int TEAM, typename T, int NX>
__device__ __forceinline__ void pi_t1(int r, const T* Lx, const T* x,
                                      T* t1) {
  for (int i = r; i < NX; i += TEAM)
    t1[i] = dot_chain<T>(i, NX - 1, [&](int q, T& u, T& v) {
      u = Lx[sym_idx(q, i)];
      v = x[q];
    });
}

template <int TEAM, typename T, int NX, typename Out>
__device__ __forceinline__ void pi_rows(int r, const T* Lx, const T* px,
                                        const T* t1, Out out) {
  for (int i = r; i < NX; i += TEAM) {
    T acc = px[i];
    for (int q = 0; q <= i; ++q) acc = acc + Lx[sym_idx(i, q)] * t1[q];
    out(i, acc);
  }
}

__host__ __device__ constexpr int team_chunks(int n, int team) {
  return n > 0 ? (n + team - 1) / team : 1;
}

// The helpers of a team of TEAM lanes.
template <int TEAM>
struct Team {
  // registers a lane needs for its share of n rows
  static __host__ __device__ constexpr int chunks(int n) {
    return team_chunks(n, TEAM);
  }

  // A team copy of COUNT rows of a stream into the slab, in two halves:
  // fetch (lane r loads the rows r, r + TEAM, ... into registers) and put
  // (the stores).  A sweep fetches all of a stage's streams before it
  // puts any, so a stage waits on one memory latency, not on one a row.
  template <int COUNT, typename T, typename Src>
  static __device__ __forceinline__ void fetch(
      int r, T (&buf)[team_chunks(COUNT, TEAM)], const Src& src) {
#pragma unroll
    for (int c = 0; c < team_chunks(COUNT, TEAM); ++c) {
      const int e = r + c * TEAM;
      if (e < COUNT) buf[c] = src(e);
    }
  }

  template <int COUNT, typename T>
  static __device__ __forceinline__ void put(
      int r, T* dst, const T (&buf)[team_chunks(COUNT, TEAM)]) {
#pragma unroll
    for (int c = 0; c < team_chunks(COUNT, TEAM); ++c) {
      const int e = r + c * TEAM;
      if (e < COUNT) dst[e] = buf[c];
    }
  }

  template <int COUNT, typename T, typename Src>
  static __device__ __forceinline__ void copy(int r, T* dst, const Src& src) {
    T buf[team_chunks(COUNT, TEAM)];
    fetch<COUNT>(r, buf, src);
    put<COUNT>(r, dst, buf);
  }

  // The pending update of COUNT rows of a state stream from row r0, x += a
  // (dx - x) (TOWARD: z and pi) or x += a dx (the multipliers and slacks),
  // loads first as in copy; keep, if given, takes the new rows.
  template <int COUNT, bool TOWARD, typename T>
  static __device__ __forceinline__ void update(int r, T a, const Col<T>& x,
                                                const Col<T>& dx, int64_t r0,
                                                T* keep) {
    T xv[team_chunks(COUNT, TEAM)], dv[team_chunks(COUNT, TEAM)];
#pragma unroll
    for (int c = 0; c < team_chunks(COUNT, TEAM); ++c) {
      const int e = r + c * TEAM;
      if (e < COUNT) {
        xv[c] = x(r0 + e);
        dv[c] = dx(r0 + e);
      }
    }
#pragma unroll
    for (int c = 0; c < team_chunks(COUNT, TEAM); ++c) {
      const int e = r + c * TEAM;
      if (e < COUNT) {
        // a select, never a multiply: frozen directions may hold NaN
        const T v = TOWARD ? xv[c] + a * (dv[c] - xv[c]) : xv[c] + a * dv[c];
        x(r0 + e) = v;
        if (keep) keep[e] = v;
      }
    }
  }

  // Column J of the team Cholesky (see folded_core), J compile-time: the
  // update of a row runs over the columns J + 1 .. NZ - 1 only, and a chunk
  // of rows that holds no row below J is skipped.
  template <int J, typename T, int NZ, typename Sync>
  static __device__ __forceinline__ void chol_col(
      int r, const Sync& sync, T* M, T* di, T (&pend)[team_chunks(NZ, TEAM)]) {
    sync();
    // column J - 1, scaled: no lane reads it any more
#pragma unroll
    for (int c = 0; c < team_chunks(NZ, TEAM); ++c) {
      const int i = r + c * TEAM;
      if (J > 0 && i >= J - 1 && i < NZ) M[i * NZ + J - 1] = pend[c];
    }
    const T d = T(1) / sqrt(nmax(M[J * NZ + J], T(1e-20)));
#pragma unroll
    for (int c = 0; c < team_chunks(NZ, TEAM); ++c) {
      if ((c + 1) * TEAM - 1 < J) continue;
      const int i = r + c * TEAM;
      if (i == J) {
        pend[c] = mul_rn(M[J * NZ + J], d);
        di[J] = d;
      } else if (i > J && i < NZ) {
        const T aij = mul_rn(M[i * NZ + J], d);
        pend[c] = aij;
        T up[NZ];
#pragma unroll
        for (int jj = J + 1; jj < NZ; ++jj)
          if (jj <= i)
            up[jj] = M[i * NZ + jj] - aij * mul_rn(M[jj * NZ + J], d);
#pragma unroll
        for (int jj = J + 1; jj < NZ; ++jj)
          if (jj <= i) M[i * NZ + jj] = up[jj];
      }
    }
  }

  template <typename T, int NZ, typename Sync, int... J>
  static __device__ __forceinline__ void chol_cols(
      int r, const Sync& sync, T* M, T* di, T (&pend)[team_chunks(NZ, TEAM)],
      std::integer_sequence<int, J...>) {
    (chol_col<J, T, NZ>(r, sync, M, di, pend), ...);
  }

  // The folded backward Riccati stage (hp::folded_bwd_core) on an
  // assembled stage in the slab: the effective Hessian's rows in M (NZ x
  // NZ, lower triangle, each row written by its owner), the gradient g,
  // F (NZ x NX), b, the carry (Lc, NX x NX lower; pxc).  Entry by entry:
  //   t1 = Lc' b, Pb = Lc t1 (pb(i, Pb_i) takes each), Pb + pxc;
  //   m = g + F (Pb + pxc) into mv, W = F Lc in place of F's rows;
  //   M += W W', a row's entries in registers;
  //   M = chol(M), column by column (hp::chol), one barrier a column:
  //   after it every lane forms the pivot d = 1 / sqrt(max(a_jj, 1e-20))
  //   (di takes it), and the owner of row i > j forms l_ij = a_ij d and
  //   updates its row, a_i,jj -= l_ij l_jj,j for jj in (j, i], forming
  //   each l_jj,j = a_jj,j d from the unscaled column as its owner does;
  //   the scaled column j (and the diagonal) is stored after the next
  //   barrier, when no lane reads column j any more.
  // Ends on a team barrier: the factor is in M, m in mv.
  template <typename T, int NU, int NX, typename Sync, typename Pb>
  static __device__ __forceinline__ void folded_core(
      int r, const Sync& sync, T* M, T* F, const T* Lc, const T* b,
      const T* pxc, const T* g, T* t1, T* pbx, T* mv, T* di, Pb pb) {
    constexpr int NZ = NU + NX;
    for (int i = r; i < NX; i += TEAM)
      t1[i] = dot_chain<T>(i, NX - 1, [&](int q, T& u, T& v) {
        u = Lc[q * NX + i];
        v = b[q];
      });
    sync();
    for (int i = r; i < NX; i += TEAM) {
      const T acc = dot_chain<T>(0, i, [&](int q, T& u, T& v) {
        u = Lc[i * NX + q];
        v = t1[q];
      });
      pb(i, acc);
      pbx[i] = acc + pxc[i];
    }
    sync();
    // each row through registers: all its loads go out before its stores
    for (int i = r; i < NZ; i += TEAM) {
      T f[NX], wr[NX];
#pragma unroll
      for (int q = 0; q < NX; ++q) f[q] = F[i * NX + q];
      T acc = g[i];
#pragma unroll
      for (int q = 0; q < NX; ++q) acc = acc + f[q] * pbx[q];
      mv[i] = acc;
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T wv = f[j] * Lc[j * NX + j];
#pragma unroll
        for (int q = j + 1; q < NX; ++q) wv = wv + f[q] * Lc[q * NX + j];
        wr[j] = wv;
      }
#pragma unroll
      for (int j = 0; j < NX; ++j) F[i * NX + j] = wr[j];
    }
    sync();
    for (int i = r; i < NZ; i += TEAM) {
      T wi[NX], mr[NZ];
#pragma unroll
      for (int q = 0; q < NX; ++q) wi[q] = F[i * NX + q];
#pragma unroll
      for (int j = 0; j < NZ; ++j) {
        if (j <= i) {
          T acc = M[i * NZ + j];
#pragma unroll
          for (int q = 0; q < NX; ++q) acc = acc + wi[q] * F[j * NX + q];
          mr[j] = acc;
        }
      }
#pragma unroll
      for (int j = 0; j < NZ; ++j)
        if (j <= i) M[i * NZ + j] = mr[j];
    }
    T pend[team_chunks(NZ, TEAM)];
    chol_cols<T, NZ>(r, sync, M, di, pend,
                     std::make_integer_sequence<int, NZ>{});
    sync();
#pragma unroll
    for (int c = 0; c < team_chunks(NZ, TEAM); ++c)
      if (r + c * TEAM == NZ - 1) M[(NZ - 1) * NZ + NZ - 1] = pend[c];
    sync();
  }
};

}  // namespace hp
