// Per-stage IPM math as __device__ functions, one CUDA thread per instance.
//
// CUDA twin of the in-kernel helpers of the JAX package's TPU kernels:
// the Riccati stage algebra of hpmpc_tpu/ops/stage_kernel.py (_chol,
// _tril_solve, _triu_solve_t, _dinv_ll, _pb_of, _trs_stage, _root_x0,
// _u_of_x, _pi_of_x, _x_next_of, _folded_bwd_core_fb) and the box step
// primitives of hpmpc_tpu/ops/step_kernel.py (_t_inv_lamt, _qx_fold,
// _gather_box, _scatter_add_box, _dt_dlam, _alpha_cands, _corr_co_qx), the
// last three in both forms: phase 1 (delta; qx_fold, dt_dlam, corr_co_qx)
// and phase 2 (residual; qx_fold_res, dt_dlam_res, corr_co_qx_res), and
// the soft-constraint primitives (_soft_schur, _soft_qx, _soft_dt_dls and
// the combined box + soft passes of the soft kernels).
// The plain PyTorch versions are hpmpc_tpu_torch/ops/stage_math.py.
//
// Where the TPU helpers work on lists of (8, 128) tiles -- one tile per
// scalar, 1024 instances in the lanes -- these work on fixed-size
// per-thread arrays: the dimensions are compile-time constants, so every
// loop unrolls and every index is static.  Triangular factors are lower;
// only their lower triangles are read.
//
// Numerics follow the JAX kernels exactly: IEEE sqrt/division (never
// --use_fast_math), pivots clamped at 1e-20 before the rsqrt and at 1e-30
// before a reciprocal, and NaN-propagating min/max (jnp.minimum /
// jnp.maximum semantics), so a numerical breakdown still reaches the
// solver's NaN guard instead of being clamped away.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hp {

// One instance's column of a batch-last (rows, B) stream: element `row`
// of instance b lives at p[row * B + b]; p is pre-offset by b, so
// neighbouring threads touch neighbouring addresses (coalesced).
template <typename T>
struct Col {
  T* p;
  int64_t B;
  __device__ __forceinline__ T& operator()(int64_t row) const {
    return p[row * B];
  }
};

template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}

__host__ __device__ constexpr int sym_idx(int i, int j) {
  return i * (i + 1) / 2 + j;
}

template <typename T, int n, typename C>
__device__ __forceinline__ void load(T (&v)[n], const C& c, int64_t row0) {
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = c(row0 + i);
}

template <typename T, int n>
__device__ __forceinline__ void store(const Col<T>& c, int64_t row0,
                                      const T (&v)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) c(row0 + i) = v[i];
}

// ---------------------------------------------------------------------------
// Riccati stage algebra
// ---------------------------------------------------------------------------

// In-place lower Cholesky on the lower triangle of A (stage_kernel._chol):
// pivot d = rsqrt(max(a_jj, 1e-20)), L_ij = a_ij * d; Dinv = the pivots.
template <typename T, int n>
__device__ __forceinline__ void chol(T (&A)[n][n], T (&Dinv)[n]) {
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const T d = T(1) / sqrt(nmax(A[j][j], T(1e-20)));
    Dinv[j] = d;
#pragma unroll
    for (int i = j; i < n; ++i) A[i][j] = A[i][j] * d;
#pragma unroll
    for (int jj = j + 1; jj < n; ++jj) {
#pragma unroll
      for (int i = jj; i < n; ++i) A[i][jj] = A[i][jj] - A[i][j] * A[jj][j];
    }
  }
}

// y = L^{-1} b on the leading n x n block of L (forward substitution).
template <typename T, int n, int R, int C>
__device__ __forceinline__ void tril_solve(const T (&L)[R][C],
                                           const T (&Dinv)[n],
                                           const T (&b)[n], T (&y)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    T acc = b[i];
#pragma unroll
    for (int j = 0; j < i; ++j) acc = acc - L[i][j] * y[j];
    y[i] = acc * Dinv[i];
  }
}

// y = L^{-T} b on the leading n x n block of L (backward substitution).
template <typename T, int n, int R, int C>
__device__ __forceinline__ void triu_solve_t(const T (&L)[R][C],
                                             const T (&Dinv)[n],
                                             const T (&b)[n], T (&y)[n]) {
#pragma unroll
  for (int i = n - 1; i >= 0; --i) {
    T acc = b[i];
#pragma unroll
    for (int j = i + 1; j < n; ++j) acc = acc - L[j][i] * y[j];
    y[i] = acc * Dinv[i];
  }
}

// Reciprocal diagonal of the leading n x n block, clamped at 1e-30.
template <typename T, int n, int R, int C>
__device__ __forceinline__ void dinv_diag(const T (&L)[R][C], T (&D)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) D[i] = T(1) / nmax(L[i][i], T(1e-30));
}

// Pb = Lxx (Lxx' b).
template <typename T, int NX>
__device__ __forceinline__ void pb_of(const T (&Lxx)[NX][NX],
                                      const T (&bb)[NX], T (&Pb)[NX]) {
  T t1[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    T acc = Lxx[i][i] * bb[i];
#pragma unroll
    for (int k = i + 1; k < NX; ++k) acc = acc + Lxx[k][i] * bb[k];
    t1[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    T acc = Lxx[i][0] * t1[0];
#pragma unroll
    for (int k = 1; k <= i; ++k) acc = acc + Lxx[i][k] * t1[k];
    Pb[i] = acc;
  }
}

// x0 = -(Lxx Lxx')^{-1} px.
template <typename T, int NX>
__device__ __forceinline__ void root_x0(const T (&Lxx)[NX][NX],
                                        const T (&px)[NX], T (&x)[NX]) {
  T D[NX], mpx[NX], t[NX];
  dinv_diag<T, NX>(Lxx, D);
#pragma unroll
  for (int i = 0; i < NX; ++i) mpx[i] = -px[i];
  tril_solve<T, NX>(Lxx, D, mpx, t);
  triu_solve_t<T, NX>(Lxx, D, t, x);
}

// u = -Luu^{-T} (eu + Lxu' x), with Ll = [Luu; Lxu] (NZ x NU).
template <typename T, int NU, int NX>
__device__ __forceinline__ void u_of_x(const T (&Ll)[NU + NX][NU],
                                       const T (&Dinv_u)[NU],
                                       const T (&eu)[NU], const T (&x)[NX],
                                       T (&u)[NU]) {
  T rhs[NU], y[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    T acc = eu[i];
#pragma unroll
    for (int k = 0; k < NX; ++k) acc = acc + Ll[NU + k][i] * x[k];
    rhs[i] = acc;
  }
  triu_solve_t<T, NU>(Ll, Dinv_u, rhs, y);
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = -y[i];
}

// pi = Lxx (Lxx' x) + px.
template <typename T, int NX>
__device__ __forceinline__ void pi_of_x(const T (&Lxx)[NX][NX],
                                        const T (&px)[NX], const T (&x)[NX],
                                        T (&pi)[NX]) {
  T t1[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    T acc = Lxx[i][i] * x[i];
#pragma unroll
    for (int k = i + 1; k < NX; ++k) acc = acc + Lxx[k][i] * x[k];
    t1[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    T acc = px[i];
#pragma unroll
    for (int k = 0; k <= i; ++k) acc = acc + Lxx[i][k] * t1[k];
    pi[i] = acc;
  }
}

// x_{s+1} = b_s + F_s' z_s, F read straight from its (NZ, NX) stream rows.
template <typename T, int NZ, int NX, typename C>
__device__ __forceinline__ void x_next_of(const C& F, int64_t f0,
                                          const C& b, int64_t b0,
                                          const T (&z)[NZ], T (&xn)[NX]) {
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    T acc = b(b0 + j);
#pragma unroll
    for (int i = 0; i < NZ; ++i) acc = acc + F(f0 + i * NX + j) * z[i];
    xn[j] = acc;
  }
}

// Backward substitution on the split factor (stage_kernel._trs_stage):
// m = g at the terminal stage (is_t), else g + F (Pb + px_next) with F read
// from its (NZ, NX) stream rows at f0; eu = Luu^{-1} m_u; px = m_x - Lxu eu.
template <typename T, int NU, int NX, typename C>
__device__ __forceinline__ void trs_stage(const T (&Ll)[NU + NX][NU],
                                          const T (&Dinv_u)[NU],
                                          const T (&g)[NU + NX], const C& F,
                                          int64_t f0, const T (&Pbpx)[NX],
                                          bool is_t, T (&eu)[NU],
                                          T (&px)[NX]) {
  constexpr int NZ = NU + NX;
  T m[NZ];
#pragma unroll
  for (int i = 0; i < NZ; ++i) {
    T acc = g[i];
    if (!is_t) {
#pragma unroll
      for (int q = 0; q < NX; ++q) acc = acc + F(f0 + i * NX + q) * Pbpx[q];
    }
    m[i] = acc;
  }
  T mu_[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) mu_[i] = m[i];
  tril_solve<T, NU>(Ll, Dinv_u, mu_, eu);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    T acc = m[NU + i];
#pragma unroll
    for (int q = 0; q < NU; ++q) acc = acc - Ll[NU + i][q] * eu[q];
    px[i] = acc;
  }
}

// Folded backward Riccati stage (stage_kernel._folded_bwd_core_fb) on an
// assembled effective Hessian M (lower triangle filled) and gradient g:
//   W = F Lxx_c, Pb = Lxx_c (Lxx_c' b), m = g + F (Pb + px_c),
//   M += W W', M = chol(M), eu = Luu^{-1} m_u, px = m_x - Lxu eu.
// On return M holds the factor; the carry becomes (Lxx block, px).  A zero
// carry (terminal stage) collapses this exactly to M = H, Pb = 0, m = g.
template <typename T, int NU, int NX>
__device__ __forceinline__ void folded_bwd_core(
    T (&M)[NU + NX][NU + NX], const T (&g)[NU + NX],
    const T (&F)[NU + NX][NX], const T (&bb)[NX], T (&Lxx_c)[NX][NX],
    T (&px_c)[NX], T (&eu)[NU], T (&px)[NX], T (&Pb)[NX]) {
  constexpr int NZ = NU + NX;
  T W[NZ][NX];
#pragma unroll
  for (int i = 0; i < NZ; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      T acc = F[i][j] * Lxx_c[j][j];
#pragma unroll
      for (int k = j + 1; k < NX; ++k) acc = acc + F[i][k] * Lxx_c[k][j];
      W[i][j] = acc;
    }
  }
  pb_of<T, NX>(Lxx_c, bb, Pb);
  T m[NZ];
#pragma unroll
  for (int i = 0; i < NZ; ++i) {
    T acc = g[i];
#pragma unroll
    for (int k = 0; k < NX; ++k) acc = acc + F[i][k] * (Pb[k] + px_c[k]);
    m[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < NZ; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T acc = M[i][j];
#pragma unroll
      for (int k = 0; k < NX; ++k) acc = acc + W[i][k] * W[j][k];
      M[i][j] = acc;
    }
  }
  T Dinv[NZ];
  chol<T, NZ>(M, Dinv);
  T Dinv_u[NU], mu_[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    Dinv_u[i] = Dinv[i];
    mu_[i] = m[i];
  }
  tril_solve<T, NU>(M, Dinv_u, mu_, eu);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    T acc = m[NU + i];
#pragma unroll
    for (int k = 0; k < NU; ++k) acc = acc - M[NU + i][k] * eu[k];
    px[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    px_c[i] = px[i];
#pragma unroll
    for (int j = 0; j < NX; ++j)
      Lxx_c[i][j] = (j <= i) ? M[NU + i][NU + j] : T(0);
  }
}

// ---------------------------------------------------------------------------
// box step primitives, phase-1 forms; a box vector holds 2K slots:
// [0, K) lower bounds, [K, 2K) upper bounds
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void t_inv_lamt(T lam, T t, T mb, T& t_inv,
                                           T& lamt) {
  const T rec = T(1) / (mb > T(0) ? t : T(1));
  t_inv = rec * mb;
  lamt = lam * t_inv;
}

// Qx = fold(lam/t), qx = fold(-sgn*lam - lam/t*A), masked; fold = lo + up.
template <typename T, int K>
__device__ __forceinline__ void qx_fold(const T (&lam)[2 * K],
                                        const T (&t)[2 * K],
                                        const T (&mb)[2 * K],
                                        const T (&A)[2 * K], T (&Qx)[K],
                                        T (&qx)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    T ti_lo, lt_lo, ti_up, lt_up;
    t_inv_lamt(lam[i], t[i], mb[i], ti_lo, lt_lo);
    t_inv_lamt(lam[K + i], t[K + i], mb[K + i], ti_up, lt_up);
    const T q_lo = -lam[i] - lt_lo * A[i];
    const T q_up = lam[K + i] - lt_up * A[K + i];
    Qx[i] = (lt_lo + lt_up) * mb[i];
    qx[i] = (q_lo + q_up) * mb[i];
  }
}

// zb[k] = z[idx[k]] as a select chain over the NZ slots (keeps z in
// registers; padded slots point at 0 and are masked by the caller).
template <typename T, int K, int NZ>
__device__ __forceinline__ void gather_box(const T (&z)[NZ], const int* idx,
                                           T (&zb)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = idx[k];
    T v = z[0];
#pragma unroll
    for (int c = 1; c < NZ; ++c) v = (j == c) ? z[c] : v;
    zb[k] = v;
  }
}

// base[idx[k]] += v[k] (padded slots carry v == 0).
template <typename T, int K, int NZ>
__device__ __forceinline__ void scatter_add_box(T (&base)[NZ],
                                                const int* idx,
                                                const T (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = idx[k];
#pragma unroll
    for (int c = 0; c < NZ; ++c)
      if (j == c) base[c] = base[c] + v[k];
  }
}

// dt = (sgn*(zb2 - A) - t) * mb; dlam = (dl0 - lam/t*dt - lam) * mb.
template <typename T, int K>
__device__ __forceinline__ void dt_dlam(const T (&lam)[2 * K],
                                        const T (&t)[2 * K],
                                        const T (&mb)[2 * K],
                                        const T (&A)[2 * K],
                                        const T (&zb)[K],
                                        const T (&dl0)[2 * K],
                                        T (&dt)[2 * K], T (&dl)[2 * K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    dt[i] = ((zb[i] - A[i]) - t[i]) * mb[i];
    dt[K + i] = ((A[K + i] - zb[i]) - t[K + i]) * mb[K + i];
  }
#pragma unroll
  for (int i = 0; i < 2 * K; ++i) {
    T t_inv, lamt;
    t_inv_lamt(lam[i], t[i], mb[i], t_inv, lamt);
    dl[i] = (dl0[i] - lamt * dt[i] - lam[i]) * mb[i];
  }
}

// -v/dv where dv < 0 (masked), +inf elsewhere.
template <typename T>
__device__ __forceinline__ T alpha_cand(T v, T dv, T mb) {
  return (dv < T(0) && mb > T(0)) ? -v / dv : T(INFINITY);
}

// Fraction-to-boundary minimum and the mu(alpha) sum partials of one box
// vector: amin = min(amin, min_i cand), s0 += sum lam t mb,
// s1 += sum(lam dt + t dl), s2 += sum(dl dt).
template <typename T, int K2>
__device__ __forceinline__ void alpha_sums(const T (&lam)[K2],
                                           const T (&t)[K2],
                                           const T (&mb)[K2],
                                           const T (&dt)[K2],
                                           const T (&dl)[K2], T& amin, T& s0,
                                           T& s1, T& s2) {
  T cmin = nmin(alpha_cand(lam[0], dl[0], mb[0]),
                alpha_cand(t[0], dt[0], mb[0]));
  T e0 = lam[0] * t[0] * mb[0];
  T e1 = lam[0] * dt[0] + t[0] * dl[0];
  T e2 = dl[0] * dt[0];
#pragma unroll
  for (int i = 1; i < K2; ++i) {
    cmin = nmin(cmin, nmin(alpha_cand(lam[i], dl[i], mb[i]),
                           alpha_cand(t[i], dt[i], mb[i])));
    e0 = e0 + lam[i] * t[i] * mb[i];
    e1 = e1 + (lam[i] * dt[i] + t[i] * dl[i]);
    e2 = e2 + dl[i] * dt[i];
  }
  amin = nmin(amin, cmin);
  s0 = s0 + e0;
  s1 = s1 + e1;
  s2 = s2 + e2;
}

// co = t_inv (sigma mu - dl dt) mb and the corrected gradient fold
// qx = fold(-sgn*lam - lam/t*A) + fold(-sgn*co).
template <typename T, int K>
__device__ __forceinline__ void corr_co_qx(const T (&lam)[2 * K],
                                           const T (&t)[2 * K],
                                           const T (&mb)[2 * K],
                                           const T (&A)[2 * K],
                                           const T (&dtb)[2 * K],
                                           const T (&dlb)[2 * K], T sm,
                                           T (&co)[2 * K], T (&qx)[K]) {
#pragma unroll
  for (int i = 0; i < 2 * K; ++i) {
    T t_inv, lamt;
    t_inv_lamt(lam[i], t[i], mb[i], t_inv, lamt);
    co[i] = t_inv * (sm - dlb[i] * dtb[i]) * mb[i];
  }
  T Qx[K], qx0[K];
  qx_fold<T, K>(lam, t, mb, A, Qx, qx0);
#pragma unroll
  for (int i = 0; i < K; ++i) qx[i] = qx0[i] + (co[K + i] - co[i]) * mb[i];
}

// ---------------------------------------------------------------------------
// box step primitives, phase-2 (residual) forms: A = rd, M = rm
// ---------------------------------------------------------------------------

// Qx = fold(lam/t), qx = fold(sgn*t_inv*M - lam/t*A), masked.
template <typename T, int K>
__device__ __forceinline__ void qx_fold_res(const T (&lam)[2 * K],
                                            const T (&t)[2 * K],
                                            const T (&mb)[2 * K],
                                            const T (&A)[2 * K],
                                            const T (&M)[2 * K], T (&Qx)[K],
                                            T (&qx)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    T ti_lo, lt_lo, ti_up, lt_up;
    t_inv_lamt(lam[i], t[i], mb[i], ti_lo, lt_lo);
    t_inv_lamt(lam[K + i], t[K + i], mb[K + i], ti_up, lt_up);
    const T q_lo = ti_lo * M[i] - lt_lo * A[i];
    const T q_up = -ti_up * M[K + i] - lt_up * A[K + i];
    Qx[i] = (lt_lo + lt_up) * mb[i];
    qx[i] = (q_lo + q_up) * mb[i];
  }
}

// dt = sgn*(zb2 - A) * mb (the full slack step: no "- t" as in phase 1);
// dlam = -t_inv*(lam*dt + M) * mb.
template <typename T, int K>
__device__ __forceinline__ void dt_dlam_res(const T (&lam)[2 * K],
                                            const T (&t)[2 * K],
                                            const T (&mb)[2 * K],
                                            const T (&A)[2 * K],
                                            const T (&M)[2 * K],
                                            const T (&zb)[K],
                                            T (&dt)[2 * K], T (&dl)[2 * K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    dt[i] = (zb[i] - A[i]) * mb[i];
    dt[K + i] = (A[K + i] - zb[i]) * mb[K + i];
  }
#pragma unroll
  for (int i = 0; i < 2 * K; ++i) {
    T t_inv, lamt;
    t_inv_lamt(lam[i], t[i], mb[i], t_inv, lamt);
    dl[i] = -t_inv * (lam[i] * dt[i] + M[i]) * mb[i];
  }
}

// Corrector residual rm2 = (M + (dt dl - sigma mu)) * mb and the gradient
// fold of qx_fold_res on it.
template <typename T, int K>
__device__ __forceinline__ void corr_co_qx_res(
    const T (&lam)[2 * K], const T (&t)[2 * K], const T (&mb)[2 * K],
    const T (&A)[2 * K], const T (&M)[2 * K], const T (&dtb)[2 * K],
    const T (&dlb)[2 * K], T sm, T (&co)[2 * K], T (&qx)[K]) {
#pragma unroll
  for (int i = 0; i < 2 * K; ++i)
    co[i] = (M[i] + (dtb[i] * dlb[i] - sm)) * mb[i];
  T Qx[K];
  qx_fold_res<T, K>(lam, t, mb, A, co, Qx, qx);
}

// ---------------------------------------------------------------------------
// soft-constraint step primitives (step_kernel._soft_schur, _soft_qx,
// _soft_dt_dls, the soft half of _soft_corr_kernel, and
// mega_kernel._soft_alpha_from_out), always in the phase-1 forms.  A soft
// vector holds 4NS slots [lo; up; s_lo; s_up], the constants 6NS slots
// [d_lbs; d_ubs; Z0; Z1; zlin0; zlin1], the mask NS slots.
// ---------------------------------------------------------------------------

// Everything the soft step formulas read of one stage's slack Schur
// elimination; rQx0/rQx1 are the first two families of lamt.
template <typename T, int NS>
struct SoftSchur {
  T ms4[4 * NS], t_inv[4 * NS], lamt[4 * NS];
  T rqx0[NS], rqx1[NS], Zl0[NS], Zl1[NS], zl0[NS], zl1[NS];
  T dlbs[NS], dubs[NS];
};

// The slack Schur elimination of one stage; every "ms > 0" guard stays (a
// masked slot may hold anything).
template <typename T, int NS>
__device__ __forceinline__ void soft_schur(const T (&lam_s)[4 * NS],
                                           const T (&t_s)[4 * NS],
                                           const T (&ms)[NS],
                                           const T (&c)[6 * NS],
                                           SoftSchur<T, NS>& S) {
#pragma unroll
  for (int i = 0; i < 4 * NS; ++i) {
    const T m = ms[i % NS];
    S.ms4[i] = m;
    const T rec = T(1) / (m > T(0) ? t_s[i] : T(1));
    S.t_inv[i] = rec * m;
    S.lamt[i] = lam_s[i] * S.t_inv[i];
  }
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const bool on = ms[k] > T(0);
    S.dlbs[k] = c[k];
    S.dubs[k] = c[NS + k];
    S.rqx0[k] = lam_s[k] + S.lamt[k] * S.dlbs[k];
    S.rqx1[k] = lam_s[NS + k] - S.lamt[NS + k] * S.dubs[k];
    S.Zl0[k] = on ? T(1) / (c[2 * NS + k] + S.lamt[k] + S.lamt[2 * NS + k])
                  : T(0);
    S.Zl1[k] = on ? T(1) / (c[3 * NS + k] + S.lamt[NS + k] +
                            S.lamt[3 * NS + k])
                  : T(0);
    S.zl0[k] = -c[4 * NS + k] + S.rqx0[k] + lam_s[2 * NS + k];
    S.zl1[k] = -c[5 * NS + k] + S.rqx1[k] + lam_s[3 * NS + k];
  }
}

// (Qx_s, qx_s) per soft row from the Schur elimination.
template <typename T, int NS>
__device__ __forceinline__ void soft_qx(const T (&ms)[NS],
                                        const SoftSchur<T, NS>& S,
                                        T (&Qx)[NS], T (&qx)[NS]) {
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const T rQx0 = S.lamt[k], rQx1 = S.lamt[NS + k];
    const T rqx0e = S.rqx0[k] - rQx0 * S.zl0[k] * S.Zl0[k];
    const T rqx1e = S.rqx1[k] - rQx1 * S.zl1[k] * S.Zl1[k];
    const T rQx0e = rQx0 - rQx0 * rQx0 * S.Zl0[k];
    const T rQx1e = rQx1 - rQx1 * rQx1 * S.Zl1[k];
    Qx[k] = (rQx0e + rQx1e) * ms[k];
    qx[k] = (rqx1e - rqx0e) * ms[k];
  }
}

// Soft (dt, dlam) of the gathered direction values zs against the zl pair
// (zl0x, zl1x) (affine: zl; corrector: zl + the dl2s fold), with the
// centering stream dl0 (0 in the affine pass).
template <typename T, int NS>
__device__ __forceinline__ void soft_dt_dls(
    const T (&lam_s)[4 * NS], const T (&t_s)[4 * NS],
    const SoftSchur<T, NS>& S, const T (&zs)[NS], const T (&dl0)[4 * NS],
    const T (&zl0x)[NS], const T (&zl1x)[NS], T (&dts)[4 * NS],
    T (&dls)[4 * NS]) {
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const T ds_lo = (zl0x[k] - S.lamt[k] * zs[k]) * S.Zl0[k];
    const T ds_up = (zl1x[k] + S.lamt[NS + k] * zs[k]) * S.Zl1[k];
    dts[k] = (ds_lo + zs[k] - S.dlbs[k] - t_s[k]) * S.ms4[k];
    dts[NS + k] = (ds_up - zs[k] + S.dubs[k] - t_s[NS + k]) * S.ms4[NS + k];
    dts[2 * NS + k] = (ds_lo - t_s[2 * NS + k]) * S.ms4[2 * NS + k];
    dts[3 * NS + k] = (ds_up - t_s[3 * NS + k]) * S.ms4[3 * NS + k];
  }
#pragma unroll
  for (int i = 0; i < 4 * NS; ++i)
    dls[i] = (dl0[i] - S.lamt[i] * dts[i] - lam_s[i]) * S.ms4[i];
}

// The soft prep of one stage: the box fold and the soft Schur fold,
// scattered onto dv (holding pdreg) and ge (holding the gradient base).
template <typename T, int NB, int NS, int NZ>
__device__ __forceinline__ void soft_fold(
    const T (&lam)[2 * NB], const T (&t)[2 * NB], const T (&mb)[2 * NB],
    const T (&A)[2 * NB], const T (&lam_s)[4 * NS], const T (&t_s)[4 * NS],
    const T (&ms)[NS], const T (&c)[6 * NS], const int* idxb,
    const int* idxs, T (&dv)[NZ], T (&ge)[NZ]) {
  T Qx[NB], qx[NB];
  qx_fold<T, NB>(lam, t, mb, A, Qx, qx);
  SoftSchur<T, NS> S;
  soft_schur<T, NS>(lam_s, t_s, ms, c, S);
  T Qs[NS], qs[NS];
  soft_qx<T, NS>(ms, S, Qs, qs);
  scatter_add_box<T, NB, NZ>(dv, idxb, Qx);
  scatter_add_box<T, NS, NZ>(dv, idxs, Qs);
  scatter_add_box<T, NB, NZ>(ge, idxb, qx);
  scatter_add_box<T, NS, NZ>(ge, idxs, qs);
}

// The soft corrector pass of one stage: the box centering correction cob
// and the soft one dl2s = t_inv (sigma mu - dl dt) ms4, and the corrected
// gradient folds scattered onto ge (holding the gradient base).  EXACT
// keeps the Schur-folded dl2s correction of the soft gradient; without it
// the soft fold is the affine one (the reference's dropped correction).
template <typename T, int NB, int NS, int NZ, bool EXACT>
__device__ __forceinline__ void soft_corr_fold(
    const T (&lam)[2 * NB], const T (&t)[2 * NB], const T (&mb)[2 * NB],
    const T (&A)[2 * NB], const T (&dtb)[2 * NB], const T (&dlb)[2 * NB],
    const T (&lam_s)[4 * NS], const T (&t_s)[4 * NS], const T (&ms)[NS],
    const T (&c)[6 * NS], const T (&dts)[4 * NS], const T (&dls)[4 * NS],
    T sm, const int* idxb, const int* idxs, T (&cob)[2 * NB],
    T (&dl2s)[4 * NS], T (&ge)[NZ]) {
  T qx[NB];
  corr_co_qx<T, NB>(lam, t, mb, A, dtb, dlb, sm, cob, qx);
  SoftSchur<T, NS> S;
  soft_schur<T, NS>(lam_s, t_s, ms, c, S);
#pragma unroll
  for (int i = 0; i < 4 * NS; ++i)
    dl2s[i] = S.t_inv[i] * (sm - dls[i] * dts[i]) * S.ms4[i];
  T Qs[NS], qs[NS];
  soft_qx<T, NS>(ms, S, Qs, qs);
  if (EXACT) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const T d0 = dl2s[k], d1 = dl2s[NS + k];
      const T d2 = dl2s[2 * NS + k], d3 = dl2s[3 * NS + k];
      const T rqx0c = d0 - S.lamt[k] * (d0 + d2) * S.Zl0[k];
      const T rqx1c = d1 - S.lamt[NS + k] * (d1 + d3) * S.Zl1[k];
      qs[k] = qs[k] + (rqx1c - rqx0c) * ms[k];
    }
  }
  scatter_add_box<T, NB, NZ>(ge, idxb, qx);
  scatter_add_box<T, NS, NZ>(ge, idxs, qs);
}

// The combined box + soft direction and alpha/sums pass of one stage
// (mega_kernel._soft_alpha_from_out) on its z: box (dt, dl) with the
// centering stream dl0b (zeros in the affine pass), soft (dt, dl) against
// zl, or in the corrector pass (CORR) against zl + the dl2s fold with dl2s
// as the centering stream; then the fraction-to-boundary minimum and the
// mu(alpha) partials over both families.
template <typename T, int NB, int NS, int NZ, bool CORR>
__device__ __forceinline__ void soft_alpha_pass(
    const T (&z)[NZ], const int* idxb, const int* idxs,
    const T (&lam)[2 * NB], const T (&t)[2 * NB], const T (&mb)[2 * NB],
    const T (&A)[2 * NB], const T (&dl0b)[2 * NB], const T (&lam_s)[4 * NS],
    const T (&t_s)[4 * NS], const T (&ms)[NS], const T (&c)[6 * NS],
    const T (&dl2s)[4 * NS], T (&dtb)[2 * NB], T (&dlb)[2 * NB],
    T (&dts)[4 * NS], T (&dls)[4 * NS], T& amin, T& s0, T& s1, T& s2) {
  T zb[NB];
  gather_box<T, NB, NZ>(z, idxb, zb);
  dt_dlam<T, NB>(lam, t, mb, A, zb, dl0b, dtb, dlb);
  SoftSchur<T, NS> S;
  soft_schur<T, NS>(lam_s, t_s, ms, c, S);
  T zs[NS], zl0x[NS], zl1x[NS], dl0s[4 * NS];
  gather_box<T, NS, NZ>(z, idxs, zs);
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    zs[k] = zs[k] * ms[k];
    zl0x[k] = CORR ? S.zl0[k] + dl2s[k] + dl2s[2 * NS + k] : S.zl0[k];
    zl1x[k] = CORR ? S.zl1[k] + dl2s[NS + k] + dl2s[3 * NS + k] : S.zl1[k];
  }
#pragma unroll
  for (int i = 0; i < 4 * NS; ++i) dl0s[i] = CORR ? dl2s[i] : T(0);
  soft_dt_dls<T, NS>(lam_s, t_s, S, zs, dl0s, zl0x, zl1x, dts, dls);
  amin = T(INFINITY);
  s0 = s1 = s2 = T(0);
  alpha_sums<T, 2 * NB>(lam, t, mb, dtb, dlb, amin, s0, s1, s2);
  alpha_sums<T, 4 * NS>(lam_s, t_s, S.ms4, dts, dls, amin, s0, s1, s2);
}

}  // namespace hp
