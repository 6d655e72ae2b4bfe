// The team helpers and team stage routines of the kernels that run one
// instance on a team of TEAM lanes of one warp: csrc/ipm_resident.cu (rows
// 1 and 1s), csrc/factor_solve_mega.cu and csrc/solve_mega.cu (rows 19 and
// 20), csrc/factor_solve_flat.cu (row 9), csrc/tree_sweeps.cu (rows 26 and
// 27), and the retained-factor re-solves of csrc/solve_flat.cu (rows 10
// and 11) and csrc/refine_flat.cu (row 13), struct ReSolve at the end,
// which csrc/solve_batched.cu (row 15) runs on the full factor.
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

#include <cuda_pipeline_primitives.h>

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
// product.  QN > 0: q1 < QN, the loop unrolls over it, so a term may index
// a register array with q (row 9's register form).
template <typename T, int QN = 0, typename Term>
__device__ __forceinline__ T dot_chain(int q0, int q1, Term term) {
  T a0, b0;
  term(q0, a0, b0);
  if (q1 == q0) return mul_rn(a0, b0);
  T a1, b1;
  term(q0 + 1, a1, b1);
  T acc = fma_rn(a0, b0, mul_rn(a1, b1));
  if constexpr (QN > 0) {
#pragma unroll
    for (int q = q0 + 2; q < QN; ++q) {
      if (q > q1) break;
      T a, b;
      term(q, a, b);
      acc = fma_rn(a, b, acc);
    }
  } else {
    for (int q = q0 + 2; q <= q1; ++q) {
      T a, b;
      term(q, a, b);
      acc = fma_rn(a, b, acc);
    }
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
// and eu, in every lane; Du: the reciprocal pivots 1 / max(Luu_ii, 1e-30)
template <typename T, int NU, int NX, typename Ev, typename Xv>
__device__ __forceinline__ void u_of_x(const T* Ll, const T (&Du)[NU],
                                       const Ev& eu, const Xv& x,
                                       T (&u)[NU]) {
  T rhs[NU], y[NU];
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

// the same with Du formed here, as rows 19, 20 and 26-27 call it
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
// second half, pi_i = px_i + sum_q Lxx_iq t1_q, its rows to out(i, pi_i).
// x and px: slab or kept rows (x[q], px[i]).
template <int TEAM, typename T, int NX, typename Xv>
__device__ __forceinline__ void pi_t1(int r, const T* Lx, const Xv& x,
                                      T* t1) {
  for (int i = r; i < NX; i += TEAM)
    t1[i] = dot_chain<T>(i, NX - 1, [&](int q, T& u, T& v) {
      u = Lx[sym_idx(q, i)];
      v = x[q];
    });
}

template <int TEAM, typename T, int NX, typename Out, typename Pv>
__device__ __forceinline__ void pi_rows(int r, const T* Lx, const Pv& px,
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

  // The stage products of the Newton residual (hp::sym_mv_acc,
  // hp::f_mv_acc, hp::ft_mv_acc) on the rows a lane owns, y[c] the row r +
  // c TEAM's accumulator; the matrices read through H(e) (the packed lower
  // triangle's entry e) and F(e) (entry e of the (NZ, NX) F), the vectors
  // from slab rows.  y += H z and y += F' z add term by term; y += F v adds
  // the dot product last, its sum rounded as nvcc rounded the unrolled
  // one-thread sum (dot_chain; at NX = 1 the one product fused into y).
  // Branch-free: a chunk past the last row works on the last row and
  // keeps its accumulator, so the compiler may issue every chunk's loads
  // at once.
  template <typename T, int NZ, typename Hf>
  static __device__ __forceinline__ void sym_mv_acc(
      int r, const Hf& H, const T* z, T (&y)[team_chunks(NZ, TEAM)]) {
#pragma unroll
    for (int c = 0; c < team_chunks(NZ, TEAM); ++c) {
      const int i0 = r + c * TEAM, i = i0 < NZ ? i0 : NZ - 1;
      T h[NZ];
#pragma unroll
      for (int j = 0; j < NZ; ++j)
        h[j] = H(i >= j ? sym_idx(i, j) : sym_idx(j, i));
      T acc = y[c];
#pragma unroll
      for (int j = 0; j < NZ; ++j) acc = acc + h[j] * z[j];
      y[c] = i0 < NZ ? acc : y[c];
    }
  }

  template <typename T, int NZ, int NX, typename Ff>
  static __device__ __forceinline__ void f_mv_acc(
      int r, const Ff& F, const T* v, T (&y)[team_chunks(NZ, TEAM)]) {
#pragma unroll
    for (int c = 0; c < team_chunks(NZ, TEAM); ++c) {
      const int i0 = r + c * TEAM, i = i0 < NZ ? i0 : NZ - 1;
      T acc;
      if constexpr (NX == 1) {
        acc = fma_rn(F(i), v[0], y[c]);
      } else {
        T f[NX];
#pragma unroll
        for (int q = 0; q < NX; ++q) f[q] = F(i * NX + q);
        acc = y[c] + dot_chain<T>(0, NX - 1, [&](int q, T& a, T& b) {
                a = f[q];
                b = v[q];
              });
      }
      y[c] = i0 < NZ ? acc : y[c];
    }
  }

  template <typename T, int NZ, int NX, typename Ff>
  static __device__ __forceinline__ void ft_mv_acc(
      int r, const Ff& F, const T* z, T (&y)[team_chunks(NX, TEAM)]) {
#pragma unroll
    for (int c = 0; c < team_chunks(NX, TEAM); ++c) {
      const int q0 = r + c * TEAM, q = q0 < NX ? q0 : NX - 1;
      T f[NZ];
#pragma unroll
      for (int i = 0; i < NZ; ++i) f[i] = F(i * NX + q);
      T acc = y[c];
#pragma unroll
      for (int i = 0; i < NZ; ++i) acc = acc + f[i] * z[i];
      y[c] = q0 < NX ? acc : y[c];
    }
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

// ---------------------------------------------------------------------------
// The retained-factor re-solve of rows 10 and 11 (csrc/solve_flat.cu: the
// cached-Pb and the Pb form), 13 (csrc/refine_flat.cu) and 15
// (csrc/solve_batched.cu: the cached-Pb form on the full factor); the
// design is in csrc/refine_flat.cu's head comment.
// ---------------------------------------------------------------------------

// An instance's kept rows in its block's interleaved store, in shared or
// device memory: row e at p[e stride], stride the block's instances.
template <typename T>
struct Rows {
  T* p;
  int stride;
  __device__ __forceinline__ T& operator[](int64_t e) const {
    return p[e * stride];
  }
  __device__ __forceinline__ Rows at(int64_t e0) const {
    return Rows{p + e0 * stride, stride};
  }
};

// One scalar from device to shared memory without a register: an
// asynchronous copy, complete after __pipeline_wait_prior.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  __pipeline_memcpy_async(dst, src, sizeof(T));
}

// The row i of entry e = sym_idx(i, j) of a packed lower triangle of n
// rows.
template <int n>
__device__ __forceinline__ int tril_row(int e) {
  int i = 0;
#pragma unroll
  for (int q = 1; q < n; ++q) i += e >= q * (q + 1) / 2 ? 1 : 0;
  return i;
}

// Entry e of the packed lower triangle of stage n's (NX, NX) block of a
// batch-last stream (the upper triangle is not read).
template <int NX, typename T>
__device__ __forceinline__ const T& tril_packed(const Col<const T>& L, int n,
                                                int e) {
  const int i = tril_row<NX>(e);
  return L((static_cast<int64_t>(n) * NX + i) * NX + (e - i * (i + 1) / 2));
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Lanes an instance of the re-solves and of row 9 (csrc/factor_solve_flat.cu):
// about three NZ rows a lane to NZ=12, two past it.  8 instances' teams a
// warp at the flagship, so a row load of a batch-last stream is one
// 32-byte sector in f32 (PERF.md section 7).
__host__ __device__ constexpr int narrow_team(int nz) {
  return nz <= 12 ? 4 : nz <= 24 ? 8 : 16;
}


// The geometry and the shared phases of the four re-solve kernels: NG the
// general rows a stage (row 13; 0 for rows 10, 11 and 15), REFINE row 13
// (the iterate's z and pi updated) or rows 10, 11 and 15 (z and pi out),
// CACHED_PB rows 10 and 15 (the prologue keeps the factorization's cached
// Pb_k as values) or rows 11 and 13 (pb_keep forms Pb_k, row 0 as its two
// factors), FULL row 15 (the factor read from the full (N+1, NZ, NZ) stream:
// Ll as the columns 0..NU-1 of a stage's block, Lxx as its (NU:, NU:)
// block, both at row stride NZ) or rows 10, 11 and 13 (the split (N+1, NZ,
// NU) and (N+1, NX, NX) streams; Llc and Lxxc below are then the two
// streams, with FULL both the one factor stream).
template <int NU, int NX, int NG, bool REFINE, bool CACHED_PB = false,
          bool FULL = false>
struct ReSolve {
  static constexpr int NZ = NU + NX;
  static constexpr int NTX = NX * (NX + 1) / 2;
  static constexpr int TEAM = narrow_team(NZ);  // lanes an instance
  static constexpr int IPB = 32 / TEAM;  // instances a block, one team a warp
  static constexpr int WARPS = 4;  // warps a block: the chain's and the workers'
  static constexpr int THREADS = 32 * WARPS;
  // the blocks an SM the launch bound asks registers for, by dtype
  static constexpr int MIN_BLOCKS_F32 = 4;
  static constexpr int MIN_BLOCKS_F64 = 2;
  static constexpr int RING = 2;   // the chain's slots (copies ahead + 1)
  using TM = Team<TEAM>;
  static __host__ __device__ constexpr int chunks(int n) {
    return team_chunks(n, TEAM);
  }
  // a slab's stride: TEAM more than a multiple of 32 scalars, so that the
  // IPB teams of a warp sit on distinct shared-memory banks
  static __host__ __device__ constexpr int pad(int n) {
    return TEAM == 32 ? n : (n - TEAM + 31) / 32 * 32 + TEAM;
  }

  // The kept rows of stage k, in scalars from the stage's first.  Q: rq_k
  // (rows 10, 11: g_k), then the stage's z out; PB: Pb_k, row 0 as its
  // factors Lxx_00 (at PB) and t1_0 (at PB + NX; row 10: Pb_0 a value),
  // then x_k; RB: rb_k (rows 10, 11: b_k);
  // DU: the reciprocal pivots 1 / max(Luu_ii, 1e-30) of Ll_k; EU, PX: the
  // backward sweep's eu_k and px_k.
  static constexpr int K_Q = 0;
  static constexpr int K_PB = K_Q + NZ;
  static constexpr int K_RB = K_PB + NX + 1;
  static constexpr int K_DU = K_RB + NX;
  static constexpr int K_EU = K_DU + NU;
  static constexpr int K_PX = K_EU + NU;
  static constexpr int KS = K_PX + NX;
  // The chain's slab (warp 0's teams): RING slots of F (NZ rows of NX,
  // stride FS = NX + 1: a lane's row reads and its column reads both miss
  // each other's banks), Ll (NZ x NU), with REFINE the iterate's z of a
  // forward stage, and the stage's kept rows; the px
  // carry and x, each double-buffered (a step reads one buffer and writes
  // the other, so one team barrier a step suffices).
  static constexpr int FS = NX + 1;
  static constexpr int S_F = 0;
  static constexpr int S_LL = S_F + NZ * FS;
  static constexpr int S_Z = S_LL + NZ * NU;
  static constexpr int S_K = S_Z + (REFINE ? NZ : 0);  // the stage's kept rows
  static constexpr int SLOT = S_K + KS;
  static constexpr int C_PXC = RING * SLOT;
  static constexpr int C_X = C_PXC + 2 * NX;
  static constexpr int C_END = C_X + 2 * NX;
  // The prologue / epilogue slab of a team: the right-hand side of Pb (b or
  // rb), then the stage's z, pi and ng products (row 13's residuals), or
  // the packed Lxx of Pb or pi with its t1.
  static constexpr int P_B = 0;
  static constexpr int P_Z = P_B + NX;
  static constexpr int P_PI = P_Z + NZ;
  static constexpr int P_QCZ = P_PI + NX;
  static constexpr int P_LX = P_B + NX;
  static constexpr int P_T1 = P_LX + NTX;
  static constexpr int P_END = cmax(P_QCZ + NG, P_T1 + NX);
  static constexpr int PSLAB = P_END;
  static constexpr int CSLAB = pad(C_END);
  // The kept rows live in device memory (the wrapper's `work`), IPB (N+1)
  // KS scalars a block, interleaved over its instances; the chain reads
  // each step's through its ring slot.  Shared memory for them measured
  // slower at the flagship and at NZ=19 (f32: 59 KB a block, three blocks
  // an SM, a small L1 for the prologue's loads; PERF.md section 6, PR 17).

  // Where entry (i, j) of stage k's Ll and, j <= i, of its Lxx lie in
  // their streams.
  static __host__ __device__ constexpr int64_t ll_at(int64_t k, int i,
                                                     int j) {
    return FULL ? (k * NZ + i) * NZ + j : (k * NZ + i) * NU + j;
  }
  static __host__ __device__ constexpr int64_t lxx_at(int64_t k, int i,
                                                      int j) {
    return FULL ? (k * NZ + NU + i) * NZ + NU + j : (k * NX + i) * NX + j;
  }

  // Stage k's packed lower triangle of Lxx into the team's slab rows dst,
  // loads first: element by element from the split stream, or with FULL
  // the owners' rows of the (NU:, NU:) block (the packed index of an
  // element of the full factor is no linear map of its stream row).
  template <typename T>
  static __device__ __forceinline__ void lxx_copy(int r,
                                                  const Col<const T>& L,
                                                  int k, T* dst) {
    if constexpr (FULL) {
      T buf[chunks(NX)][NX];
#pragma unroll
      for (int c = 0; c < chunks(NX); ++c) {
        const int i0 = r + c * TEAM, i = i0 < NX ? i0 : NX - 1;
#pragma unroll
        for (int j = 0; j < NX; ++j)
          if (j <= i) buf[c][j] = L(lxx_at(k, i, j));
      }
#pragma unroll
      for (int c = 0; c < chunks(NX); ++c) {
        const int i = r + c * TEAM;
        if (i < NX) {
#pragma unroll
          for (int j = 0; j < NX; ++j)
            if (j <= i) dst[sym_idx(i, j)] = buf[c][j];
        }
      }
    } else {
      TM::template copy<NTX>(
          r, dst, [&](int e) { return tril_packed<NX>(L, k, e); });
    }
  }

  // The launch geometry at horizon N: an instance's kept rows, the block's
  // shared memory in scalars.
  struct Geo {
    int64_t rows, smem;
  };

  static Geo geo(int64_t N) {
    Geo g;
    g.rows = (N + 1) * KS;
    g.smem = static_cast<int64_t>(IPB) * CSLAB +
             static_cast<int64_t>(WARPS - 1) * IPB * PSLAB + WARPS;
    return g;
  }

  // The launch layout at horizon N in dtype_code: out = {lanes a team,
  // instances a block, threads a block, the kept rows' device memory a
  // block (scalars), shared memory a block (bytes)}.  A wrapper sizes its
  // `work` from it.
  static void layout(int64_t N, int dtype_code, int64_t* out) {
    const Geo g = geo(N);
    out[0] = TEAM;
    out[1] = IPB;
    out[2] = THREADS;
    out[3] = IPB * g.rows;
    out[4] = g.smem * (dtype_code == 1 ? 8 : 4);
  }

  // Launch kernel(a, geo) of element type T over B instances at horizon N:
  // IPB instances a block, geo's shared memory.
  template <typename T, typename K, typename A>
  static int start(K kernel, const A& a, int64_t B, int64_t N,
                   cudaStream_t stream) {
    const Geo g = geo(N);
    const int64_t blocks = (B + IPB - 1) / IPB;
    const int64_t smem = g.smem * static_cast<int64_t>(sizeof(T));
    const int rc = allow_smem(kernel, smem);
    if (rc != 0) return rc;
    kernel<<<static_cast<unsigned>(blocks), THREADS,
             static_cast<size_t>(smem), stream>>>(a, g);
    return static_cast<int>(cudaGetLastError());
  }

  // The block's progress words, the last WARPS scalars of its shared
  // memory: done[j], the last stage worker j (warp j + 1) has kept in its
  // prologue (N + 1: none yet; each worker keeps its stages in descending
  // order), and fwd = done[WARPS - 1], the stages the chain has recovered.
  template <typename T>
  static __device__ __forceinline__ volatile int* progress(
      const Geo& g, unsigned char* smem) {
    return reinterpret_cast<volatile int*>(reinterpret_cast<T*>(smem) +
                                           g.smem - WARPS);
  }

  // Wait (every lane of the warp) until ready() holds, then order the
  // warp's later reads after the writes it announces.
  template <typename F>
  static __device__ __forceinline__ void wait_for(const F& ready) {
    while (!ready()) __nanosleep(32);
    __threadfence_block();
  }

  // Announce (lane 0, after the warp's barrier) that the warp's writes so
  // far are done: word = v.
  static __device__ __forceinline__ void announce(volatile int* word, int v) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      __threadfence_block();
      *word = v;
    }
  }

  // Where a lane sits: its team's lane r and warp w, its instance clamped
  // into the batch for loads (bl; valid: not past it, the lanes that
  // store), its slabs and its instance's kept rows.  A block's IPB instances are consecutive in the batch and each
  // warp holds one team of each, so a team lane's row load of a batch-last
  // stream and its neighbours' cover IPB neighbouring scalars.  Every team
  // of a warp runs the same stages in the same order, so the team barrier
  // is the warp's (a barrier on one team's lanes alone splits the warp).
  template <typename T>
  struct Lane {
    int r, w;
    bool valid;
    int64_t bl;
    T* chain;
    T* pe;
    Rows<T> kp;
    __device__ __forceinline__ void tsync() const { __syncwarp(); }
  };

  template <typename T>
  static __device__ __forceinline__ Lane<T> lane_of(const Geo& g, int64_t B,
                                                    void* work,
                                                    unsigned char* smem) {
    Lane<T> ln;
    const int tid = static_cast<int>(threadIdx.x);
    const int lane = tid & 31, s = lane / TEAM;
    ln.w = tid >> 5;
    ln.r = lane % TEAM;
    const int64_t bi = static_cast<int64_t>(blockIdx.x) * IPB + s;
    ln.valid = bi < B;
    ln.bl = ln.valid ? bi : B - 1;
    T* const sm = reinterpret_cast<T*>(smem);
    ln.chain = sm + s * CSLAB;  // warp 0's
    ln.pe = sm + IPB * CSLAB + ((ln.w > 0 ? ln.w - 1 : 0) * IPB + s) * PSLAB;
    ln.kp = Rows<T>{static_cast<T*>(work) +
                        static_cast<int64_t>(blockIdx.x) * IPB * g.rows + s,
                    IPB};
    return ln;
  }

  // The carry-free rows every prologue keeps: the reciprocal pivots of
  // Ll_k (hp::dinv_diag's), in the owners of their rows.
  template <typename T>
  static __device__ __forceinline__ void du_keep(const Lane<T>& ln, int k,
                                                 const Col<const T>& Llc) {
    const Rows<T> st = ln.kp.at(static_cast<int64_t>(k) * KS);
    for (int i = ln.r; i < NU; i += TEAM)
      st[K_DU + i] = T(1) / nmax(Llc(ll_at(k, i, i)), T(1e-30));
  }

  // Pb_k = Lxx_{k+1} (Lxx_{k+1}' v) (hp::pb_of) for v in the slab's B rows,
  // into the kept PB rows of stage k: row 0 as its factors (one product,
  // which the one-thread kernels fused into Pb_0 + px), the others as
  // values.  It first copies Lxx_{k+1} over the slab's residual rows: the
  // caller's team barrier must follow their last read and B's stores.
  template <typename T>
  static __device__ __forceinline__ void pb_keep(const Lane<T>& ln, int k,
                                                 const Col<const T>& Lxxc) {
    T* const sh = ln.pe;
    const int r = ln.r;
    lxx_copy(r, Lxxc, k + 1, sh + P_LX);
    ln.tsync();
    const T* Lx = sh + P_LX;
    for (int i = r; i < NX; i += TEAM)
      sh[P_T1 + i] = dot_chain<T>(i, NX - 1, [&](int q, T& a, T& b) {
        a = Lx[sym_idx(q, i)];
        b = sh[P_B + q];
      });
    ln.tsync();
    const Rows<T> pb = ln.kp.at(static_cast<int64_t>(k) * KS + K_PB);
    for (int i = r; i < NX; i += TEAM) {
      if (i == 0) {
        pb[0] = Lx[0];
        pb[NX] = sh[P_T1];
      } else {
        pb[i] = dot_chain<T>(0, i, [&](int q, T& a, T& b) {
          a = Lx[sym_idx(i, q)];
          b = sh[P_T1 + q];
        });
      }
    }
  }

  // The serial chain, warp 0: the backward substitution, stages N..0, on
  // the kept rq_k, Pb_k and reciprocal pivots (m = rq + F (Pb + px_c), eu =
  // Luu^{-1} m_u, px = m_x - Lxu eu), then the forward recovery, stages
  // 0..N (x_0 from the root solve, u_s, the stage's z out, x_{s+1} = rb_s +
  // F_s' [u_s; x_s]).  A step is one team barrier: every lane forms Pb + px
  // and m's u rows itself, so eu needs no exchange, and the owners of the
  // x rows form px (backward) or x_{s+1} (forward) into the other buffer.
  // Each step's F and Ll (with REFINE a forward stage's z) and kept rows
  // (after the stage's announcement) come through a ring of RING slots,
  // copied asynchronously RING - 1 steps ahead.  The kept rows the chain writes (eu, px, x, z) go where they
  // live, and the forward reads eu there (eu_0 is the step before's).
  template <typename T>
  static __device__ __forceinline__ void chain(const Lane<T>& ln, int N,
                                               volatile int* prog,
                                               const Col<const T>& Llc,
                                               const Col<const T>& Fc,
                                               const Col<const T>& Lxxc,
                                               const Col<const T>& zc) {
    T* const sh = ln.chain;
    const int r = ln.r;
    const int steps = 2 * N + 2;
    // the prologue worker's announcement of step t's stage (backward)
    auto wait_kept = [&](int t) {
      if (t > N) return;
      volatile int* const done = prog + t % (WARPS - 1);
      wait_for([&] { return *done <= N - t; });
    };
    auto issue = [&](int t) {
      T* const slot = sh + (t % RING) * SLOT;
      const bool bwd = t <= N;
      const int k = bwd ? N - t : t - N - 1;
      {
        // the stage's kept rows, after its worker's announcement
        wait_kept(t);
        const Rows<T> st = ln.kp.at(static_cast<int64_t>(k) * KS);
#pragma unroll
        for (int c = 0; c < chunks(KS); ++c) {
          const int e = r + c * TEAM;
          if (e < KS) cp_async(slot + S_K + e, &st[e]);
        }
      }
      if constexpr (FULL) {
        // the owners' rows of Ll: NU entries each, at row stride NZ
#pragma unroll
        for (int c = 0; c < chunks(NZ); ++c) {
          const int i = r + c * TEAM;
          if (i < NZ) {
#pragma unroll
            for (int j = 0; j < NU; ++j)
              cp_async(slot + S_LL + i * NU + j, &Llc(ll_at(k, i, j)));
          }
        }
      } else {
        const int64_t l0 = static_cast<int64_t>(k) * NZ * NU;
#pragma unroll
        for (int c = 0; c < chunks(NZ * NU); ++c) {
          const int e = r + c * TEAM;
          if (e < NZ * NU) cp_async(slot + S_LL + e, &Llc(l0 + e));
        }
      }
      if (k < N) {
        const int64_t f0 = static_cast<int64_t>(k) * NZ * NX;
#pragma unroll
        for (int c = 0; c < chunks(NZ * NX); ++c) {
          const int e = r + c * TEAM;
          if (e < NZ * NX)
            cp_async(slot + S_F + e / NX * FS + e % NX, &Fc(f0 + e));
        }
      }
      if (REFINE && !bwd) {
        const int64_t z0 = static_cast<int64_t>(k) * NZ;
#pragma unroll
        for (int c = 0; c < chunks(NZ); ++c) {
          const int e = r + c * TEAM;
          if (e < NZ) cp_async(slot + S_Z + e, &zc(z0 + e));
        }
      }
    };
    for (int t = 0; t < RING - 1; ++t) {
      issue(t);
      __pipeline_commit();
    }
    __pipeline_wait_prior(RING - 2);
    ln.tsync();
    for (int t = 0; t < steps; ++t) {
      // the slot of step t - 1 is free: every lane passed its barrier
      if (t + RING - 1 < steps) issue(t + RING - 1);
      __pipeline_commit();
      const T* const sF = sh + (t % RING) * SLOT + S_F;
      const T* const sLl = sh + (t % RING) * SLOT + S_LL;
      // the stage's kept rows: read from the slot (st), written where they
      // live (sw)
      const int stage = t <= N ? N - t : t - N - 1;
      const Rows<T> sw = ln.kp.at(static_cast<int64_t>(stage) * KS);
      const Rows<T> st{sh + (t % RING) * SLOT + S_K, 1};
      if (t <= N) {
        const int k = N - t;
        const T* const pxc = sh + C_PXC + (t & 1) * NX;
        T Du[NU], pbx[NX], eu[NU];
#pragma unroll
        for (int i = 0; i < NU; ++i) Du[i] = st[K_DU + i];
        if (k < N) {
          // Pb + px_c (hp::trs_stage's Pbpx); row 0 as the one-thread
          // kernels rounded it: the cached value added (row 10), or the
          // product Pb_0 fused into the sum (rows 11 and 13)
          if constexpr (CACHED_PB)
            pbx[0] = st[K_PB] + pxc[0];
          else
            pbx[0] = fma_rn(st[K_PB], st[K_PB + NX], pxc[0]);
#pragma unroll
          for (int q = 1; q < NX; ++q) pbx[q] = st[K_PB + q] + pxc[q];
        }
        // m = rq + F (Pb + px_c) (hp::trs_stage), its u rows in every lane,
        // then eu = Luu^{-1} m_u (hp::tril_solve)
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          T acc = st[K_Q + i];
          if (k < N) {
#pragma unroll
            for (int q = 0; q < NX; ++q) acc = acc + sF[i * FS + q] * pbx[q];
          }
#pragma unroll
          for (int j = 0; j < i; ++j) acc = acc - sLl[i * NU + j] * eu[j];
          eu[i] = acc * Du[i];
        }
        // m's x rows and px = m_x - Lxu eu in the owners (branch-free: a
        // chunk past the last row works on the last and stores nothing)
        T* const pxn = sh + C_PXC + ((t + 1) & 1) * NX;
#pragma unroll
        for (int c = 0; c < chunks(NX); ++c) {
          const int i0 = r + c * TEAM, i = i0 < NX ? i0 : NX - 1;
          T acc = st[K_Q + NU + i];
          if (k < N) {
#pragma unroll
            for (int q = 0; q < NX; ++q)
              acc = acc + sF[(NU + i) * FS + q] * pbx[q];
          }
#pragma unroll
          for (int q = 0; q < NU; ++q)
            acc = acc - sLl[(NU + i) * NU + q] * eu[q];
          if (i0 < NX) {
            pxn[i] = acc;
            sw[K_PX + i] = acc;
          }
        }
#pragma unroll
        for (int j = 0; j < NU; ++j)
          if (j % TEAM == r) sw[K_EU + j] = eu[j];
      } else {
        const int s = t - N - 1;
        const T* const zs = sh + (t % RING) * SLOT + S_Z;
        T* const xc = sh + C_X + (s & 1) * NX;
        if (s == 0) {
          // the carry buffer of the last backward step holds px_0
          root_x0<TEAM, T, NX>(
              r,
              [&](int i, int j) { return Lxxc(lxx_at(0, i, j)); },
              sh + C_PXC + ((N + 1) & 1) * NX, xc);
          ln.tsync();
        }
        T x[NX], Du[NU], eu[NU], u[NU];
#pragma unroll
        for (int j = 0; j < NX; ++j) x[j] = xc[j];
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          Du[i] = st[K_DU + i];
          // eu_0 is the last backward step's: read where it was written
          eu[i] = sw[K_EU + i];
        }
        u_of_x<T, NU, NX>(sLl, Du, eu, x, u);
#pragma unroll
        for (int i = 0; i < NU; ++i)
          if (i % TEAM == r) sw[K_Q + i] = REFINE ? zs[i] + u[i] : u[i];
        T* const xn = sh + C_X + ((s + 1) & 1) * NX;
#pragma unroll
        for (int c = 0; c < chunks(NX); ++c) {
          const int j0 = r + c * TEAM, j = j0 < NX ? j0 : NX - 1;
          const T xj = xc[j];
          T acc = T(0);
          if (s < N) {
            // x_{s+1} = rb_s + F_s' [u; x] (hp::x_next_of)
            acc = st[K_RB + j];
#pragma unroll
            for (int i = 0; i < NU; ++i) acc = acc + sF[i * FS + j] * u[i];
#pragma unroll
            for (int i = 0; i < NX; ++i)
              acc = acc + sF[(NU + i) * FS + j] * x[i];
          }
          if (j0 < NX) {
            sw[K_PB + j] = xj;
            sw[K_Q + NU + j] = REFINE ? zs[NU + j] + xj : xj;
            if (s < N) xn[j] = acc;
          }
        }
      }
      // the slot of step t + 1 has landed, and every lane's carry rows
      __pipeline_wait_prior(RING - 2);
      ln.tsync();
      if (t > N) announce(prog + WARPS - 1, t - N);
    }
  }

  // The epilogue of stage s: the stage's z out, pi_{s-1} = Lxx_s (Lxx_s'
  // x_s) + px_s (hp::pi_of_x; REFINE: the iterate's pi + it) out.
  template <typename T>
  static __device__ __forceinline__ void epilogue(const Lane<T>& ln, int s,
                                                  const Col<const T>& Lxxc,
                                                  const Col<const T>& pic,
                                                  const Col<T>& zo,
                                                  const Col<T>& pio) {
    T* const sh = ln.pe;
    const int r = ln.r;
    const Rows<T> st = ln.kp.at(static_cast<int64_t>(s) * KS);
    ln.tsync();  // the team's last stage is done with the slab
    if (ln.valid)
      for (int i = r; i < NZ; i += TEAM)
        zo(static_cast<int64_t>(s) * NZ + i) = st[K_Q + i];
    if (s == 0) return;
    lxx_copy(r, Lxxc, s, sh + P_LX);
    ln.tsync();
    pi_t1<TEAM, T, NX>(r, sh + P_LX, st.at(K_PB), sh + P_T1);
    ln.tsync();
    pi_rows<TEAM, T, NX>(r, sh + P_LX, st.at(K_PX), sh + P_T1,
                         [&](int i, T v) {
                           const int64_t e = static_cast<int64_t>(s - 1) * NX +
                                             i;
                           if (ln.valid) pio(e) = REFINE ? pic(e) + v : v;
                         });
  }

  // A block's run, its three phases overlapped: warp 0 runs the chain;
  // warps 1.. (the workers) keep the prologue's rows of their stages,
  // worker j the stages N - j, N - j - (WARPS - 1), ... in that order,
  // announcing each, then run the epilogue of the stages j, j + (WARPS -
  // 1), ..., each once the chain has announced it.  The chain waits for a
  // stage's announcement before it reads the stage's kept rows, so it
  // starts as the first stages are kept, and the epilogue trails it.
  // prologue(k) keeps stage k's rq, rb (or b), Pb and pivots; it begins
  // with a team barrier.
  template <typename T, typename Pro>
  static __device__ __forceinline__ void run(
      const Lane<T>& ln, volatile int* prog, int N, const Pro& prologue,
      const Col<const T>& Llc, const Col<const T>& Fc,
      const Col<const T>& Lxxc, const Col<const T>& zc,
      const Col<const T>& pic, const Col<T>& zo, const Col<T>& pio) {
    constexpr int NW = WARPS - 1;
    if (threadIdx.x == 0) {
      for (int j = 0; j < NW; ++j) prog[j] = N + 1;
      prog[NW] = 0;
    }
    __syncthreads();
    if (ln.w == 0) {
      chain(ln, N, prog, Llc, Fc, Lxxc, zc);
      return;
    }
    const int j = ln.w - 1;
    for (int i = j; i <= N; i += NW) {
      prologue(N - i);
      announce(prog + j, N - i);
    }
    for (int s = j; s <= N; s += NW) {
      wait_for([&] { return prog[NW] > s; });
      epilogue(ln, s, Lxxc, pic, zo, pio);
    }
  }

  // The cached-Pb re-solve of rows 10 and 15, a block's whole run: the
  // workers keep rq = g_k, the forward's right-hand side b_k, the cached
  // Pb_k and the pivots of each stage, warp 0 runs the chain, the workers
  // the epilogue (z and pi out).  Ll, Lxx: the factor's streams (FULL: the
  // one full factor twice); Pb, g: (N, NX, B), (N+1, NZ, B); F, b; z, pi
  // out; work: the kept rows (geo's size a block).
  template <typename T>
  static __device__ __forceinline__ void run_cached_pb(
      const Geo& geo, unsigned char* smem, int64_t B, int N, void* work,
      const void* Ll, const void* Lxx, const void* Pb, const void* g,
      const void* F, const void* b, void* z, void* pi) {
    static_assert(CACHED_PB && !REFINE, "the cached-Pb re-solve");
    const auto ln = lane_of<T>(geo, B, work, smem);
    const int r = ln.r;
    auto in = [&](const void* p) {
      return Col<const T>{static_cast<const T*>(p) + ln.bl, B};
    };
    auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + ln.bl, B}; };
    const Col<const T> Llc = in(Ll), Lxxc = in(Lxx), Pbc = in(Pb), gc = in(g),
                       Fc = in(F), bc = in(b);
    auto prologue = [&](int k) {
      const Rows<T> st = ln.kp.at(static_cast<int64_t>(k) * KS);
      du_keep(ln, k, Llc);
      T gb[chunks(NZ)], bb[chunks(NX)], pb[chunks(NX)];
      TM::template fetch<NZ>(r, gb, [&](int e) {
        return gc(static_cast<int64_t>(k) * NZ + e);
      });
      if (k < N) {
        TM::template fetch<NX>(r, bb, [&](int e) {
          return bc(static_cast<int64_t>(k) * NX + e);
        });
        TM::template fetch<NX>(r, pb, [&](int e) {
          return Pbc(static_cast<int64_t>(k) * NX + e);
        });
      }
#pragma unroll
      for (int c = 0; c < chunks(NZ); ++c) {
        const int i = r + c * TEAM;
        if (i < NZ) st[K_Q + i] = gb[c];
      }
      if (k < N) {
#pragma unroll
        for (int c = 0; c < chunks(NX); ++c) {
          const int q = r + c * TEAM;
          if (q < NX) {
            st[K_RB + q] = bb[c];
            st[K_PB + q] = pb[c];
          }
        }
      }
    };
    const Col<T> zo = out(z), pio = out(pi);
    run(ln, progress<T>(geo, smem), N, prologue, Llc, Fc, Lxxc, gc,
        Col<const T>{pio.p, B}, zo, pio);
  }
};

}  // namespace hp
