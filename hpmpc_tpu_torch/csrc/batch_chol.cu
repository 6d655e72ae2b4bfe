// Batched dense Cholesky for the large-NZ band of the structured route: two
// kernels, one library for every size (n and p are runtime).
//
//   * hp_cholesky (Queue 2 row 24): L = chol(A) of a batch of symmetric
//     positive definite (n, n) matrices, blocked right-looking.  Replaces
//     hpmpc_tpu/ops/batch_chol.py::cholesky (the pallas_call at :243, body
//     _chol_body :54).  Plain version:
//     hpmpc_tpu_torch/ops/batch_chol.py::cholesky_ref.
//   * hp_panel_factor (Queue 2 row 25): the panel Cholesky L of a batch of
//     (p, p) blocks with its lower-triangular inverse Linv.  Replaces
//     batch_chol.py::_panel_factor (the pallas_call at :153, body
//     _panel_body :108).  Plain version: ops/batch_chol.py::panel_factor_ref.
//
// Numerics follow the TPU kernels: pivot d_j = 1/sqrt(max(a_jj, tiny)) with
// tiny 1e-20 in f32 and 1e-30 in f64 (NOT stage_math.cuh's 1e-20 in both
// types; a NaN pivot stays NaN, as jnp.maximum keeps it), IEEE sqrt and
// division (never --use_fast_math), and L_ik = a_ik d_k from the unscaled
// updated column (batch_chol.py:81-83).  nvcc contracts the update's
// multiply and subtract into an FMA, so the kernels agree with the plain
// versions to roundoff, not bit for bit.
//
// What bounds row 24 on the H100: neither bytes nor flops.  A (1024, 72, 72)
// f32 batch reads 10.6 MB (the lower triangles) and writes 21.2 MB: ~9.5 us
// of HBM time; its n^3/6 multiply-adds per matrix are 0.13 GFLOP, ~2 us of
// the f32 peak.  What a matrix costs is its chain of n dependent column
// steps and the instructions around them: a rank-1 update a column, as the
// TPU kernel runs it, would pay two block barriers a column (144 at n=72),
// an index product per entry and, a warp a row, lanes idle on the short
// rows near the diagonal.
//
// Design (row 24): one block a matrix, the packed lower triangle (row i at
// i(i+1)/2, a 32-bit base once a row) in dynamic shared memory, panels of
// PANEL = 8 columns.  The panel at k0:
//   a. Diagonal block, warp 0: lane r holds row k0+r's 8 panel entries in
//      registers; column j's diagonal entry goes to every lane by
//      __shfl_sync, each lane forms d_j itself, scales its entry (c = a d,
//      which is already L) and takes the block's c_q by __shfl_sync for
//      a_rq -= c c_q.  The pivots and the block's L go to shared memory.
//   b. The rows below the block, one a thread: the same 8 steps with d_j
//      and c_q read from shared memory (broadcasts); L goes back to the
//      triangle and to a transposed panel buffer (8 x n, contiguous in the
//      row).
//   c. Barrier; trailing update: the lower triangle of the trailing block
//      in 4 x 4 register tiles, one tile a thread in turn: 16 entries read,
//      the 8 columns' updates in column order from the panel buffer (two
//      16-byte loads a column for 16 FMAs), written back.  Warp 0 takes the
//      tiles of the next panel's diagonal block and then factors it (a. of
//      the next panel) while the other warps finish; a barrier.
// Two barriers a panel (18 at n=72), no index product per entry, and every
// lane of a step on a whole row or tile.  128 threads a block to n = 160,
// 256 past it; where 8 blocks fit an SM's shared memory (n <= 109 in f32,
// 74 in f64) at most 64 registers a thread, so that 8 fit by registers too
// (a batch of 1024 at n=72 is one wave).  The packed triangle fits a
// block's 227 KB to n = 332 in f32 and 232 in f64; past that the same code
// runs on the output itself in device memory (row-major, the panel values
// read from it), so no n is refused.  A is read in 16-byte chunks, one a
// thread in turn (independent loads), where the rows are 16-byte aligned
// (n a multiple of 4 in f32, 2 in f64), else an entry at a time; L is
// written row by row, coalesced, zeros above the diagonal.
//
// Bits: every entry gets one contracted a - c_i c_k per column, in column
// order, from the c = a d products and the pivot formula of the rank-1
// loop (and L_ik = c_i at step k is that loop's final a_ik d_k), so the
// kernel gives that loop's bits; tools/compare_builds.py holds it to
// another checkout's build bit for bit.  Only the lower triangle of A
// counts: on a symmetric input the TPU kernel's upper entries equal the
// lower ones bit for bit at every step (each update multiplies the same
// two numbers), so this is its arithmetic.  Entries
// above the diagonal and rows or columns past n (the last panel and tile
// padded) only ever feed each other and are never stored.
//
// Design (row 25): one warp per panel, four panels a block, p <= 32.  The
// panel sits in shared memory; lane k owns column k.  Column step j: lane
// k > j updates its whole column, a_ik -= (a_ij d_j)(a_jk d_j) for every
// row i, as _panel_body does (its update is not restricted to trailing
// rows).  Then L_ik = a_ik d_k below and on the diagonal, and the inverse by
// forward substitution, row i after row i-1: Linv_ik = (e_ik - sum_m L_im
// Linv_mk) d_i over m < i, lane k reading only its own column of Linv, so
// the rows need no barrier.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int PANEL = 8;     // row 24's panel width
constexpr int TILE = 4;      // row 24's trailing register tile, TILE x TILE
constexpr int SMALL_N = 160;  // row 24: 128 threads a block to here, 256 past
constexpr int PANEL_WARPS = 4;
constexpr int MAX_P = 32;
constexpr size_t SMEM_LIMIT = 232448;  // a block's shared memory
constexpr size_t SMEM_SM = 233472;     // an SM's, 1 KB a block reserved

template <typename T>
__device__ __forceinline__ T tiny();
template <>
__device__ __forceinline__ float tiny<float>() { return 1e-20f; }
template <>
__device__ __forceinline__ double tiny<double>() { return 1e-30; }

// 1/sqrt(max(a, tiny)); a NaN stays NaN.
template <typename T>
__device__ __forceinline__ T pivot(T a) {
  return T(1) / sqrt(a < tiny<T>() ? tiny<T>() : a);
}

// 16 bytes of T: the loads and stores of whole rows and of the panel buffer
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

}  // namespace

// Mirrors _CholArgs in hpmpc_tpu_torch/ops/batch_chol.py field for field.
struct CholArgs {
  const void* A;  // (B, n, n), lower triangle read
  void* L;        // (B, n, n) out, strictly upper part 0
  int64_t B;
  int64_t n;
};

// Mirrors _PanelArgs in hpmpc_tpu_torch/ops/batch_chol.py.
struct PanelArgs {
  const void* A;  // (B, p, p)
  void* L;        // (B, p, p) out
  void* Linv;     // (B, p, p) out
  int64_t B;
  int64_t p;
};

namespace {

// Where row 24 keeps the triangle (see the header).
enum Form { PACKED = 0, GLOBAL = 1 };

__host__ __device__ __forceinline__ int64_t round_up(int64_t x, int64_t m) {
  return (x + m - 1) / m * m;
}
// the panel buffer's row length: every trailing row, padded to the tile
__host__ __device__ __forceinline__ int64_t pbuf_len(int64_t n) {
  return round_up(n, TILE);
}

// One matrix per block: the blocked right-looking factorization of the
// header.  vec: 16-byte loads and stores of A's and L's rows.  MINB 4: at
// most 64 registers a thread (8 blocks of 128 threads an SM).
template <typename T, int FORM, int MINB>
__global__ void __launch_bounds__(256, MINB)
    cholesky_kernel(const T* __restrict__ A, T* __restrict__ L, int n,
                    bool vec) {
  using I = std::conditional_t<FORM == GLOBAL, int64_t, int>;
  using V = typename Vec16<T>::type;
  constexpr int VW = 16 / sizeof(T);
  constexpr int DT = PANEL / TILE;  // a diagonal block's tile rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T dsh[PANEL];             // the panel's pivots
  __shared__ T lsh[PANEL][PANEL + 1];  // its diagonal block's L
  T* pbuf = reinterpret_cast<T*>(smem_raw);  // PANEL x pbuf_len(n)
  const int plen = static_cast<int>(pbuf_len(n));
  const int64_t nn = static_cast<int64_t>(n) * n;
  const T* a = A + blockIdx.x * nn;
  T* out = L + blockIdx.x * nn;
  T* tri = FORM == GLOBAL ? out : pbuf + PANEL * plen;
  auto base = [&](int i) -> I {
    if constexpr (FORM == PACKED) return i * (i + 1) / 2;
    return static_cast<I>(i) * n;
  };
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // The diagonal block of the panel at k0, by warp 0 (lane r: row k0+r,
  // zeros past it): column j's pivot from lane j by __shfl_sync, c = a d
  // (L), the diagonal rows' c_q by __shfl_sync for a_rq -= c c_q.  Writes
  // L to the triangle and to lsh, the pivots to dsh.
  auto factor_diag = [&](int k0) {
    const int row = k0 + lane;
    const bool own = lane < PANEL && row < n;
    const I rb = own ? base(row) : I(0);
    T v[PANEL];
#pragma unroll
    for (int q = 0; q < PANEL; ++q)
      v[q] = own && q <= lane ? tri[rb + k0 + q] : T(0);
#pragma unroll
    for (int j = 0; j < PANEL; ++j) {
      const T d = pivot(__shfl_sync(0xffffffffu, v[j], j));
      const T c = v[j] * d;  // L[row][k0+j] (garbage above the diagonal)
      v[j] = c;
      if (lane == 0) dsh[j] = d;
#pragma unroll
      for (int q = j + 1; q < PANEL; ++q) {
        const T cq = __shfl_sync(0xffffffffu, c, q);
        v[q] = v[q] - c * cq;
      }
    }
    if (own) {
#pragma unroll
      for (int q = 0; q < PANEL; ++q) {
        if (q <= lane) tri[rb + k0 + q] = v[q];
        lsh[lane][q] = v[q];
      }
    }
  };

  // the lower triangle in (GLOBAL: A's lower triangle copied to L), one
  // 16-byte chunk (or one entry) a thread in turn, loads independent
  {
    const int w = vec ? VW : 1;
    const int cpr = n / w;  // chunks a row (vec: n is a multiple of VW)
    const int64_t chunks = static_cast<int64_t>(n) * cpr;
    const float inv = 1.0f / static_cast<float>(cpr);
#pragma unroll 4
    for (int64_t e = tid; e < chunks; e += blockDim.x) {
      // e / cpr: exact in float for the shared-memory form (e < 2^17)
      const int i = FORM == GLOBAL ? static_cast<int>(e / cpr)
                                   : static_cast<int>((e + 0.5f) * inv);
      const int c = static_cast<int>(e - static_cast<int64_t>(i) * cpr);
      if (c * w > i) continue;
      const T* src = a + static_cast<int64_t>(i) * n + c * w;
      T* dst = tri + base(i) + c * w;
      if (vec) {
        const V v = *reinterpret_cast<const V*>(src);
        const T* vv = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int q = 0; q < VW; ++q)
          if (c * VW + q <= i) dst[q] = vv[q];
      } else {
        dst[0] = src[0];
      }
    }
  }
  __syncthreads();
  if (warp == 0) factor_diag(0);
  __syncthreads();

  for (int k0 = 0;; k0 += PANEL) {
    const int t0 = k0 + PANEL;  // the trailing block's first row and column
    if (t0 >= n) break;         // the last panel: its diagonal block is done
    const int m = static_cast<int>(round_up(n - t0, TILE));

    // ---- 1. the panel's rows below its diagonal block, one a thread -----
    for (int r = tid; r < m; r += blockDim.x) {
      const int row = t0 + r;
      T v[PANEL];
      I rb = 0;
      if (row < n) rb = base(row);
#pragma unroll
      for (int q = 0; q < PANEL; ++q)
        v[q] = row < n ? tri[rb + k0 + q] : T(0);
#pragma unroll
      for (int j = 0; j < PANEL; ++j) {
        const T c = v[j] * dsh[j];  // L[row][k0+j]
        v[j] = c;
#pragma unroll
        for (int q = j + 1; q < PANEL; ++q) v[q] = v[q] - c * lsh[q][j];
      }
      if (row < n) {
#pragma unroll
        for (int q = 0; q < PANEL; ++q) tri[rb + k0 + q] = v[q];
      }
      if constexpr (FORM != GLOBAL) {
#pragma unroll
        for (int q = 0; q < PANEL; ++q)
          pbuf[q * plen + r] = row < n ? v[q] : T(0);
      }
    }
    __syncthreads();

    // ---- 2. trailing update: a_ik -= L_ij L_kj, j in the panel ---------
    // Warp 0 takes the tiles of the next panel's diagonal block (the first
    // DT(DT+1)/2 in this order) and then factors that block; the other
    // warps take the rest.  One barrier ends both.
    const int mt = m / TILE;
    const int tiles = mt * (mt + 1) / 2;
    const int nd = DT * (DT + 1) / 2;
    const int first = warp == 0 ? lane : nd + tid - 32;
    const int last = warp == 0 ? (nd < tiles ? nd : tiles) : tiles;
    const int step = warp == 0 ? 32 : blockDim.x - 32;
    for (int e = first; e < last; e += step) {
      int bi = static_cast<int>((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
      while (bi * (bi + 1) / 2 > e) --bi;
      while ((bi + 1) * (bi + 2) / 2 <= e) ++bi;
      const int bk = e - bi * (bi + 1) / 2;
      const int i0 = bi * TILE, c0 = bk * TILE;  // offsets from t0
      I rb[TILE];
      T acc[TILE][TILE];
#pragma unroll
      for (int x = 0; x < TILE; ++x) {
        const int i = t0 + i0 + x;
        rb[x] = i < n ? base(i) : I(0);
#pragma unroll
        for (int y = 0; y < TILE; ++y) {
          const int k = t0 + c0 + y;
          acc[x][y] = i < n && k <= i ? tri[rb[x] + k] : T(0);
        }
      }
#pragma unroll
      for (int j = 0; j < PANEL; ++j) {
        T ri[TILE], ck[TILE];
        if constexpr (FORM == GLOBAL) {
#pragma unroll
          for (int x = 0; x < TILE; ++x) {
            const int i = t0 + i0 + x, k = t0 + c0 + x;
            ri[x] = i < n ? tri[base(i) + k0 + j] : T(0);
            ck[x] = k < n ? tri[base(k) + k0 + j] : T(0);
          }
        } else {
          const V* pr = reinterpret_cast<const V*>(pbuf + j * plen + i0);
          const V* pc = reinterpret_cast<const V*>(pbuf + j * plen + c0);
#pragma unroll
          for (int h = 0; h < TILE / VW; ++h) {
            const V u = pr[h], w = pc[h];
#pragma unroll
            for (int q = 0; q < VW; ++q) {
              ri[h * VW + q] = reinterpret_cast<const T*>(&u)[q];
              ck[h * VW + q] = reinterpret_cast<const T*>(&w)[q];
            }
          }
        }
#pragma unroll
        for (int x = 0; x < TILE; ++x)
#pragma unroll
          for (int y = 0; y < TILE; ++y)
            acc[x][y] = acc[x][y] - ri[x] * ck[y];
      }
#pragma unroll
      for (int x = 0; x < TILE; ++x) {
        const int i = t0 + i0 + x;
#pragma unroll
        for (int y = 0; y < TILE; ++y) {
          const int k = t0 + c0 + y;
          if (i < n && k <= i) tri[rb[x] + k] = acc[x][y];
        }
      }
    }
    if (warp == 0) {
      __syncwarp();
      factor_diag(t0);
    }
    __syncthreads();
  }

  // L out, row by row, zeros above the diagonal (GLOBAL: only the zeros)
  const int nw = blockDim.x >> 5;
  for (int i = warp; i < n; i += nw) {
    T* dst = out + static_cast<int64_t>(i) * n;
    const T* row = tri + base(i);
    if constexpr (FORM == GLOBAL) {
      for (int k = i + 1 + lane; k < n; k += 32) dst[k] = T(0);
    } else if (vec) {
      for (int c = lane; c * VW < n; c += 32) {
        V v;
        T* vv = reinterpret_cast<T*>(&v);
#pragma unroll
        for (int q = 0; q < VW; ++q)
          vv[q] = c * VW + q <= i ? row[c * VW + q] : T(0);
        reinterpret_cast<V*>(dst)[c] = v;
      }
    } else {
      for (int k = lane; k < n; k += 32) dst[k] = k <= i ? row[k] : T(0);
    }
  }
}

// One panel per warp, PANEL_WARPS panels per block.
template <typename T>
__global__ void __launch_bounds__(PANEL_WARPS * 32)
    panel_kernel(const T* __restrict__ A, T* __restrict__ L,
                 T* __restrict__ Linv, int64_t B, int64_t p) {
  __shared__ T s_all[PANEL_WARPS][MAX_P][MAX_P + 1];
  __shared__ T d_all[PANEL_WARPS][MAX_P];
  const int w = threadIdx.x >> 5;
  const int k = threadIdx.x & 31;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * PANEL_WARPS + w;
  if (m >= B) return;  // whole warp: no warp-level sync below is skipped
  T(*s)[MAX_P + 1] = s_all[w];
  T* dv = d_all[w];
  const int64_t pp = p * p;
  const T* a = A + m * pp;
  const bool own = k < p;
  if (own)
    for (int64_t i = 0; i < p; ++i) s[i][k] = a[i * p + k];
  __syncwarp();

  for (int64_t j = 0; j < p; ++j) {
    const T d = pivot(s[j][j]);
    if (k == 0) dv[j] = d;
    if (own && k > j) {
      const T r = s[j][k] * d;
      for (int64_t i = 0; i < p; ++i) s[i][k] = s[i][k] - (s[i][j] * d) * r;
    }
    __syncwarp();
  }

  // L in place (column k scaled by its pivot, zero above the diagonal)
  if (own)
    for (int64_t i = 0; i < p; ++i) s[i][k] = i >= k ? s[i][k] * dv[k] : T(0);
  __syncwarp();
  if (own) {
    T* lo = L + m * pp;
    T* li = Linv + m * pp;
    for (int64_t i = 0; i < p; ++i) lo[i * p + k] = s[i][k];
    for (int64_t i = 0; i < p; ++i) {
      T acc = T(0);
      for (int64_t q = 0; q < i; ++q) acc = acc + s[i][q] * li[q * p + k];
      li[i * p + k] = ((i == k ? T(1) : T(0)) - acc) * dv[i];
    }
  }
}

// Row 24's shared memory: the panel buffer and the packed triangle
// (dynamic), its pivots and diagonal block (static).
template <typename T>
size_t chol_smem(int64_t n) {
  return static_cast<size_t>(PANEL * pbuf_len(n) + n * (n + 1) / 2) *
         sizeof(T);
}
template <typename T>
constexpr size_t chol_static() {
  return PANEL * (PANEL + 2) * sizeof(T);
}

template <typename T, int FORM, int MINB>
int launch_chol(const CholArgs& a, cudaStream_t stream) {
  const size_t smem = FORM == PACKED ? chol_smem<T>(a.n) : 0;
  cudaError_t e = cudaFuncSetAttribute(
      cholesky_kernel<T, FORM, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec = a.n * sizeof(T) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.L) % 16 == 0;
  const int threads = MINB == 4 || a.n <= SMALL_N ? 128 : 256;
  cholesky_kernel<T, FORM, MINB><<<static_cast<unsigned>(a.B), threads, smem,
                                   stream>>>(static_cast<const T*>(a.A),
                                             static_cast<T*>(a.L),
                                             static_cast<int>(a.n), vec);
  return static_cast<int>(cudaGetLastError());
}

// The packed triangle in shared memory while it fits a block (n <= 332 in
// f32, 232 in f64), else the device-memory form.  Where 8 blocks fit an
// SM's shared memory (n <= 109 in f32, 74 in f64), at most 64 registers a
// thread, so that 8 fit by registers too: at n=72 a batch of 1024 is one
// wave.
template <typename T>
int chol(const CholArgs& a, cudaStream_t stream) {
  const size_t smem = chol_smem<T>(a.n) + chol_static<T>();
  if (smem > SMEM_LIMIT) return launch_chol<T, GLOBAL, 1>(a, stream);
  if (8 * (smem + 1024) <= SMEM_SM) return launch_chol<T, PACKED, 4>(a, stream);
  return launch_chol<T, PACKED, 1>(a, stream);
}

template <typename T>
int panel(const PanelArgs& a, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((a.B + PANEL_WARPS - 1) / PANEL_WARPS);
  panel_kernel<T><<<blocks, PANEL_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(a.A), static_cast<T*>(a.L),
      static_cast<T*>(a.Linv), a.B, a.p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hp_cholesky(const CholArgs* a, int dtype_code,
                           cudaStream_t stream) {
  if (a->B < 1 || a->B > 0x7fffffff || a->n < 1 || a->n > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return chol<float>(*a, stream);
  if (dtype_code == 1) return chol<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int hp_panel_factor(const PanelArgs* a, int dtype_code,
                               cudaStream_t stream) {
  if (a->B < 1 || a->p < 1 || a->p > MAX_P ||
      (a->B + PANEL_WARPS - 1) / PANEL_WARPS > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return panel<float>(*a, stream);
  if (dtype_code == 1) return panel<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
