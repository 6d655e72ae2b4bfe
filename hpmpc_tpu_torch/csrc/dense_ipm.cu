// One instance's whole dense condensed-QP IPM in ONE launch of ONE thread
// block: the phase-1 Mehrotra predictor-corrector on
//   min 1/2 y' Hd y + gd' y,  lbz <= y <= ubz (boxed coords, mz > 0),
//                             dlg <= G y <= dug,
// to mu <= mu_tol or k_max iterations, from the warm start y0 (clamped
// inside the boxes, the d_init_var twin).  Outputs y, kk, mu and status (0
// converged, 1 k_max, 2 frozen).
//
// Replaces: hpmpc_tpu/ops/dense_kernel.py::dense_ipm_call -> _dense_call
// (the pallas_call at :396; body _dense_kernel :142, grid (k_max,), one
// grid step per iteration, state in VMEM scratch).  Plain version:
// hpmpc_tpu_torch/ops/dense_kernel.py::dense_ipm_plain.
//
// What bounds it on the H100: sequential depth, not bytes or flops.  One
// instance is one block on one of the 132 SMs.  Per iteration the fold
// Hbar = Hd + diag(Qxz) + G' diag(Qxg) G is ngd nz (nz+1)/2 multiply-adds
// (Hbar is symmetric: its lower triangle), the Cholesky nz^3/6, the four
// substitutions 2 nz^2, the G / G' products 4 ngd nz -- 1.35 Mflop at the
// flagship (nz = 90, ngd = 120), which one SM's share of the fp32 peak
// (67/132 TFLOP/s) does in ~2.7 us -- but the Cholesky is nz dependent
// column steps and the substitutions 4 nz dependent steps (450 at the
// flagship), each a block barrier or a warp shuffle.  The inputs (Hd, G, the vectors: ~100 KB in f64) read once are
// ~0.03 us of HBM time.
//
// Design: the TPU's sequential grid becomes a loop inside the block (512
// threads).  Hbar/L live in dynamic shared memory (nz x nz with an odd
// row stride, lower triangle), G too when both fit in the 227 KB a block
// may use (always in f32; in f64 up to nz*ngd ~ 12k entries -- the
// flagship fits), else G is read through L1 from global memory.  The fold
// is one thread per 2 x 4 tile of Hbar's lower triangle; the Cholesky is
// right-looking, one column per step and one barrier per column (each
// thread takes the pivot itself, the trailing update is spread over the
// warps, the column is scaled one step later); the substitutions run on
// one warp, each
// lane owning every 32nd entry, the pivot value broadcast by a shuffle;
// the iterate lives in shared memory, one thread per entry (z entries on
// warps 0-3, general rows on warps 8-11), and the step length and the
// duality measure are block reductions, so every thread holds the same
// scalars.  Numerics follow the TPU kernel: pivots 1/sqrt(max(d, 1e-30)),
// IEEE division and sqrt (never --use_fast_math); the fold and the
// products sum in another order and nvcc contracts multiply-adds, so the
// kernel agrees with the plain version to roundoff amplified by the
// barrier conditioning (chip_smoke.py states the tolerance).
//
// Specialisation: none; nz <= 128 and ngd <= 128 are runtime (the wrapper
// raises beyond), float32 and float64.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 512;
constexpr int MAXD = 128;         // the envelope: nz, ngd <= MAXD
constexpr int NWARPS = THREADS / 32;
constexpr int GOFF = 256;         // the general-row threads start here
constexpr int NVEC = 24;          // shared vectors of MAXD entries
constexpr size_t SMEM_LIMIT = 232448;

}  // namespace

// Mirrors _Args in hpmpc_tpu_torch/ops/dense_kernel.py field for field.
struct DenseIpmArgs {
  const void* Hd;      // (nz, nz) symmetric, row-major
  const void* G;       // (ngd, nz)
  const void* gd;      // (nz)
  const void* lbz;     // (nz)
  const void* ubz;     // (nz)
  const void* mz;      // (nz) 1 on boxed coordinates
  const void* dlg;     // (ngd)
  const void* dug;     // (ngd)
  const void* y0;      // (nz) warm start, zeros = cold
  void* y;             // (nz) out
  void* mu;            // () out
  void* kk;            // () int32 out
  void* status;        // () int32 out
  int64_t nz;
  int64_t ngd;
  int64_t k_max;
  double mu0;
  double mu_tol;
  double alpha_min;
  double mu_scal;
};

namespace {

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / min; every thread gets the result.  ``red`` holds
// NWARPS + 1 entries of shared memory.
template <typename T, bool MIN>
__device__ __forceinline__ T block_reduce(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MIN ? warp_min(v) : warp_sum(v);
  __syncthreads();                  // the previous result has been read
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T r = lane < NWARPS ? red[lane] : (MIN ? T(3.0e38) : T(0));
    r = MIN ? warp_min(r) : warp_sum(r);
    if (lane == 0) red[NWARPS] = r;
  }
  __syncthreads();
  return red[NWARPS];
}

// Fraction-to-boundary candidate of one family entry: -v/dv where dv < 0.
template <typename T>
__device__ __forceinline__ T ratio(T v, T dv) {
  return dv < T(0) ? -v / dv : T(3.0e38);
}

// (L L')^{-1} r on warp 0 by the column-oriented substitutions of the TPU
// kernel's _solve_chol: forward w_j = (r_j - acc_j) dinv_j, acc += w_j
// L[:, j]; backward x_j = (w_j - acc_j) dinv_j, acc += x_j L[j, :].  Lane
// l owns entries l, l+32, l+64, l+96.  L: lower triangle, row stride LD.
template <typename T>
__device__ __forceinline__ void chol_solve(const T* L, int LD, const T* dinv, const T* r,
                           T* w, T* x, int n) {
  const int lane = threadIdx.x & 31;
  T acc[MAXD / 32];
#pragma unroll
  for (int q = 0; q < MAXD / 32; ++q) acc[q] = T(0);
  for (int j = 0; j < n; ++j) {
    const int own = j & 31, slot = j >> 5;
    T aj = T(0);
#pragma unroll
    for (int q = 0; q < MAXD / 32; ++q)
      if (q == slot) aj = acc[q];
    T wj = T(0);
    if (lane == own) {
      wj = (r[j] - aj) * dinv[j];
      w[j] = wj;
    }
    wj = __shfl_sync(0xffffffffu, wj, own);
#pragma unroll
    for (int q = 0; q < MAXD / 32; ++q) {
      const int i = lane + 32 * q;
      if (i > j && i < n) acc[q] += wj * L[i * LD + j];
    }
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < MAXD / 32; ++q) acc[q] = T(0);
  for (int j = n - 1; j >= 0; --j) {
    const int own = j & 31, slot = j >> 5;
    T aj = T(0);
#pragma unroll
    for (int q = 0; q < MAXD / 32; ++q)
      if (q == slot) aj = acc[q];
    T xj = T(0);
    if (lane == own) {
      xj = (w[j] - aj) * dinv[j];
      x[j] = xj;
    }
    xj = __shfl_sync(0xffffffffu, xj, own);
#pragma unroll
    for (int q = 0; q < MAXD / 32; ++q) {
      const int i = lane + 32 * q;
      if (i < j) acc[q] += xj * L[j * LD + i];
    }
  }
}

// GS: G lives in shared memory (copied in at the start), else it is read
// from global memory.
template <typename T, bool GS>
__global__ void __launch_bounds__(THREADS) dense_ipm_kernel(DenseIpmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int nz = static_cast<int>(a.nz), ng = static_cast<int>(a.ngd);
  const int LD = nz | 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* const A = sm;                       // Hbar, then L (lower triangle)
  T* const V = A + nz * LD;              // NVEC vectors of MAXD
  T* const Gsm = V + NVEC * MAXD;        // G when it fits
  // z-space vectors
  T *y = V, *tlo = V + MAXD, *tup = V + 2 * MAXD, *llo = V + 3 * MAXD,
    *lup = V + 4 * MAXD, *lbz = V + 5 * MAXD, *ubz = V + 6 * MAXD,
    *mzv = V + 7 * MAXD, *gd = V + 8 * MAXD, *qxz = V + 9 * MAXD,
    *rhs = V + 10 * MAXD, *ys = V + 11 * MAXD, *wv = V + 12 * MAXD,
    *dinv = V + 13 * MAXD;
  // general-row vectors
  T *sglo = V + 14 * MAXD, *sgup = V + 15 * MAXD, *glo = V + 16 * MAXD,
    *gup = V + 17 * MAXD, *dlg = V + 18 * MAXD, *dug = V + 19 * MAXD,
    *Qxg = V + 20 * MAXD, *qxg = V + 21 * MAXD, *qxg2 = V + 22 * MAXD;
  T* const red = V + 23 * MAXD;          // reduction scratch
  const T* const Hd = static_cast<const T*>(a.Hd);
  const T* const G = GS ? Gsm : static_cast<const T*>(a.G);

  const T thr0 = T(0.1), big = T(3.0e38), zero = T(0);
  const T mu0 = T(a.mu0), mu_tol = T(a.mu_tol), alpha_min = T(a.alpha_min),
          mu_scal = T(a.mu_scal);

  if (GS) {
    const T* const Gg = static_cast<const T*>(a.G);
    for (int e = tid; e < ng * nz; e += THREADS) Gsm[e] = Gg[e];
  }
  const bool zt = tid < nz;                        // a z entry's thread
  const int r = tid - GOFF;
  const bool gt_ = r >= 0 && r < ng;               // a general row's thread
  const int i = tid;
  bool bz = false;
  if (zt) {
    lbz[i] = static_cast<const T*>(a.lbz)[i];
    ubz[i] = static_cast<const T*>(a.ubz)[i];
    mzv[i] = static_cast<const T*>(a.mz)[i];
    gd[i] = static_cast<const T*>(a.gd)[i];
    bz = mzv[i] > zero;
    // d_init_var twin on the warm start (unboxed coordinates keep it: the
    // TPU kernel zeroes them, see ops/dense_kernel.py)
    T yv = static_cast<const T*>(a.y0)[i];
    const T t_lo0 = bz ? yv - lbz[i] : zero, t_up0 = bz ? ubz[i] - yv : zero;
    const bool both = t_lo0 < thr0 && t_up0 < thr0 && bz;
    const bool lo_o = t_lo0 < thr0 && !both && bz;
    const bool up_o = t_up0 < thr0 && !both && bz;
    T t_lo = (both || lo_o) ? thr0 : t_lo0, t_up = (both || up_o) ? thr0 : t_up0;
    yv = both ? T(0.5) * (lbz[i] - ubz[i])
              : (lo_o ? lbz[i] + thr0 : (up_o ? ubz[i] - thr0 : yv));
    y[i] = yv;
    t_lo = bz ? t_lo : T(1);
    t_up = bz ? t_up : T(1);
    tlo[i] = t_lo;
    tup[i] = t_up;
    llo[i] = bz ? mu0 / t_lo : zero;
    lup[i] = bz ? mu0 / t_up : zero;
  }
  if (gt_) {
    dlg[r] = static_cast<const T*>(a.dlg)[r];
    dug[r] = static_cast<const T*>(a.dug)[r];
  }
  __syncthreads();
  if (gt_) {
    T cz = zero;
    for (int k = 0; k < nz; ++k) cz += G[r * nz + k] * y[k];
    const T s_lo = fmax(thr0, cz - dlg[r]), s_up = fmax(thr0, dug[r] - cz);
    sglo[r] = s_lo;
    sgup[r] = s_up;
    glo[r] = mu0 / s_lo;
    gup[r] = mu0 / s_up;
  }
  __syncthreads();

  T mu = mu0;
  int kk = 0;
  bool frz = false;
  for (int it = 0; it < static_cast<int>(a.k_max); ++it) {
    if (frz || !(mu > mu_tol)) break;      // uniform: every thread agrees

    // ---- barrier terms (each thread keeps its entry's in registers) ----
    T yi = zero, t_lo = zero, t_up = zero, l_lo = zero, l_up = zero,
      ti_lo = zero, ti_up = zero, lt_lo = zero, lt_up = zero, Qxz = zero;
    if (zt) {
      yi = y[i];
      t_lo = tlo[i];
      t_up = tup[i];
      l_lo = llo[i];
      l_up = lup[i];
      ti_lo = T(1) / t_lo;
      ti_up = T(1) / t_up;
      lt_lo = l_lo * ti_lo;
      lt_up = l_up * ti_up;
      Qxz = bz ? lt_lo + lt_up : zero;
      qxz[i] = bz ? (-l_lo - lt_lo * lbz[i]) + (l_up - lt_up * ubz[i]) : zero;
    }
    T s_lo = zero, s_up = zero, g_lo = zero, g_up = zero, si_lo = zero,
      si_up = zero, gt_lo = zero, gt_up = zero;
    if (gt_) {
      s_lo = sglo[r];
      s_up = sgup[r];
      g_lo = glo[r];
      g_up = gup[r];
      si_lo = T(1) / s_lo;
      si_up = T(1) / s_up;
      gt_lo = g_lo * si_lo;
      gt_up = g_up * si_up;
      Qxg[r] = gt_lo + gt_up;
      qxg[r] = (-g_lo - gt_lo * dlg[r]) + (g_up - gt_up * dug[r]);
    }
    if (zt) rhs[i] = Qxz;            // the diagonal, for the fold below
    __syncthreads();

    // ---- fold: Hbar (lower triangle) and g_eff; a thread per 2 x 4 tile
    // of Hbar (each G entry loaded once for several products), every
    // entry summed over the rows q in order ----
    {
      const int nI = (nz + 1) / 2, nK = (nz + 3) / 4;
      for (int t = tid; t < nI * nK; t += THREADS) {
        const int I = t / nK, i0 = 2 * I, k0 = 4 * (t - I * nK);
        if (k0 > i0 + 1) continue;                  // above the diagonal
        const int ib = min(i0 + 1, nz - 1);
        int kc[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) kc[c] = min(k0 + c, nz - 1);
        T p[2][4] = {};
        for (int q = 0; q < ng; ++q) {
          const T* Gq = G + q * nz;
          const T ga = Gq[i0], gb = Gq[ib], qq = Qxg[q];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const T gk = Gq[kc[c]] * qq;
            p[0][c] += ga * gk;
            p[1][c] += gb * gk;
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int ii = i0 + rr;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int k = k0 + c;
            if (ii < nz && k <= ii)
              A[ii * LD + k] =
                  (Hd[ii * nz + k] + (ii == k ? rhs[ii] : zero)) + p[rr][c];
          }
        }
      }
    }
    T geff_i = zero;
    if (zt) {
      T p = zero;
      for (int q = 0; q < ng; ++q) p += G[q * nz + i] * qxg[q];
      geff_i = (gd[i] + qxz[i]) + p;
    }
    __syncthreads();
    if (zt) rhs[i] = -geff_i;

    // ---- right-looking column Cholesky in place, one barrier a column:
    // every thread takes the pivot of column j (final since the last
    // barrier) itself and updates its share of the trailing block with
    // column j scaled on the fly; column j is scaled in place one step
    // later, when no thread reads it any more ----
    for (int j = 0; j < nz; ++j) {
      const T dj = T(1) / sqrt(fmax(A[j * LD + j], T(1e-30)));
      if (j > 0) {
        const T dp = dinv[j - 1];
        for (int ii = j - 1 + tid; ii < nz; ii += THREADS)
          A[ii * LD + j - 1] *= dp;
      }
      if (tid == 0) dinv[j] = dj;
      for (int ii = j + 1 + warp; ii < nz; ii += NWARPS) {
        const T lij = A[ii * LD + j] * dj;
        for (int kc = j + 1 + lane; kc <= ii; kc += 32)
          A[ii * LD + kc] -= lij * (A[kc * LD + j] * dj);
      }
      __syncthreads();
    }
    if (tid == 0) A[(nz - 1) * LD + nz - 1] *= dinv[nz - 1];
    __syncthreads();

    // ---- predictor: y1 = -(Hbar)^{-1} g_eff ----
    if (warp == 0) chol_solve(A, LD, dinv, rhs, wv, ys, nz);
    __syncthreads();

    // directions of a solve y_new with the centering terms dl0 / dg0
    T dt_lo = zero, dt_up = zero, dl_lo = zero, dl_up = zero;
    T ds_lo = zero, ds_up = zero, dg_lo = zero, dg_up = zero;
    auto dirs = [&](T dl0_lo, T dl0_up, T dg0_lo, T dg0_up) {
      if (zt) {
        const T yn = ys[i];
        dt_lo = bz ? (yn - lbz[i]) - t_lo : zero;
        dt_up = bz ? (ubz[i] - yn) - t_up : zero;
        dl_lo = bz ? (dl0_lo - lt_lo * dt_lo) - l_lo : zero;
        dl_up = bz ? (dl0_up - lt_up * dt_up) - l_up : zero;
      }
      if (gt_) {
        T czn = zero;
        for (int k = 0; k < nz; ++k) czn += G[r * nz + k] * ys[k];
        ds_lo = (czn - dlg[r]) - s_lo;
        ds_up = (dug[r] - czn) - s_up;
        dg_lo = (dg0_lo - gt_lo * ds_lo) - g_lo;
        dg_up = (dg0_up - gt_up * ds_up) - g_up;
      }
    };
    auto step_alpha = [&]() {
      T c = big;
      if (zt && bz)
        c = fmin(fmin(ratio(l_lo, dl_lo), ratio(l_up, dl_up)),
                 fmin(ratio(t_lo, dt_lo), ratio(t_up, dt_up)));
      if (gt_)
        c = fmin(fmin(ratio(g_lo, dg_lo), ratio(g_up, dg_up)),
                 fmin(ratio(s_lo, ds_lo), ratio(s_up, ds_up)));
      return fmin(T(1), block_reduce<T, true>(c, red));
    };
    auto mu_of = [&](T al) {
      T s = zero;
      if (zt && bz)
        s = (l_lo + al * dl_lo) * (t_lo + al * dt_lo) +
            (l_up + al * dl_up) * (t_up + al * dt_up);
      if (gt_)
        s = (g_lo + al * dg_lo) * (s_lo + al * ds_lo) +
            (g_up + al * dg_up) * (s_up + al * ds_up);
      return block_reduce<T, false>(s, red) * mu_scal;
    };

    dirs(zero, zero, zero, zero);
    const T a_aff = step_alpha() * T(0.995);
    const T mu_aff = mu_of(a_aff);
    const T ratio_mu = mu_aff / mu;
    const T smu = ratio_mu * ratio_mu * ratio_mu * mu;

    // ---- corrector ----
    T dl2_lo = zero, dl2_up = zero, dg2_lo = zero, dg2_up = zero;
    if (zt) {
      dl2_lo = bz ? ti_lo * (smu - dl_lo * dt_lo) : zero;
      dl2_up = bz ? ti_up * (smu - dl_up * dt_up) : zero;
    }
    if (gt_) {
      dg2_lo = si_lo * (smu - dg_lo * ds_lo);
      dg2_up = si_up * (smu - dg_up * ds_up);
      qxg2[r] = qxg[r] + (-dg2_lo + dg2_up);
    }
    __syncthreads();
    if (zt) {
      T p = zero;
      for (int q = 0; q < ng; ++q) p += G[q * nz + i] * qxg2[q];
      rhs[i] = -((gd[i] + (qxz[i] + (-dl2_lo + dl2_up))) + p);
    }
    __syncthreads();
    if (warp == 0) chol_solve(A, LD, dinv, rhs, wv, ys, nz);
    __syncthreads();
    dirs(dl2_lo, dl2_up, dg2_lo, dg2_up);
    const T a2 = step_alpha() * T(0.995);

    // ---- the step, kept only if the step_ok twin accepts it ----
    const T mu_n = mu_of(a2);
    const bool ok = (mu_n == mu_n) && fabs(mu_n) < big &&
                    !((mu_n > T(10) * mu) && (mu < T(1e-3)));
    if (ok) {
      if (zt) {
        y[i] = yi + a2 * (ys[i] - yi);
        tlo[i] = t_lo + a2 * dt_lo;
        tup[i] = t_up + a2 * dt_up;
        llo[i] = l_lo + a2 * dl_lo;
        lup[i] = l_up + a2 * dl_up;
      }
      if (gt_) {
        sglo[r] = s_lo + a2 * ds_lo;
        sgup[r] = s_up + a2 * ds_up;
        glo[r] = g_lo + a2 * dg_lo;
        gup[r] = g_up + a2 * dg_up;
      }
      mu = mu_n;
      ++kk;
    }
    frz = !ok || a2 < alpha_min;
    __syncthreads();
  }

  if (zt) static_cast<T*>(a.y)[i] = y[i];
  if (tid == 0) {
    *static_cast<T*>(a.mu) = mu;
    *static_cast<int32_t*>(a.kk) = kk;
    *static_cast<int32_t*>(a.status) = mu <= mu_tol ? 0 : (frz ? 2 : 1);
  }
}

template <typename T>
size_t smem_bytes(int64_t nz, int64_t ngd, bool with_g) {
  const int64_t LD = nz | 1;
  return static_cast<size_t>(nz * LD + NVEC * MAXD + (with_g ? ngd * nz : 0)) *
         sizeof(T);
}

template <typename T, bool GS>
int launch_as(const DenseIpmArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a.nz, a.ngd, GS);
  cudaError_t e = cudaFuncSetAttribute(
      dense_ipm_kernel<T, GS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dense_ipm_kernel<T, GS><<<1, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const DenseIpmArgs& a, cudaStream_t stream) {
  if (smem_bytes<T>(a.nz, a.ngd, true) <= SMEM_LIMIT)
    return launch_as<T, true>(a, stream);
  return launch_as<T, false>(a, stream);
}

}  // namespace

extern "C" int hp_dense_ipm(const DenseIpmArgs* a, int dtype_code,
                            cudaStream_t stream) {
  if (a->nz < 1 || a->nz > MAXD || a->ngd < 0 || a->ngd > MAXD ||
      a->k_max < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return launch<float>(*a, stream);
  if (dtype_code == 1) return launch<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
