// Batched dense Cholesky for the large-NZ band of the structured route: two
// kernels, one library for every size (n and p are runtime).
//
//   * hp_cholesky (Queue 2 row 24): L = chol(A) of a batch of symmetric
//     positive definite (n, n) matrices, right-looking, one rank-1 update
//     per column.  Replaces hpmpc_tpu/ops/batch_chol.py::cholesky (the
//     pallas_call at :243, body _chol_body :54).  Plain version:
//     hpmpc_tpu_torch/ops/batch_chol.py::cholesky_ref.
//   * hp_panel_factor (Queue 2 row 25): the panel Cholesky L of a batch of
//     (p, p) blocks with its lower-triangular inverse Linv.  Replaces
//     batch_chol.py::_panel_factor (the pallas_call at :153, body
//     _panel_body :108).  Plain version: ops/batch_chol.py::panel_factor_ref.
//
// Numerics follow the TPU kernels: pivot d_j = 1/sqrt(max(a_jj, tiny)) with
// tiny 1e-20 in f32 and 1e-30 in f64 (NOT stage_math.cuh's 1e-20 in both
// types; a NaN pivot stays NaN, as jnp.maximum keeps it), IEEE sqrt and
// division (never --use_fast_math), and the factor recovered at the end as
// L = tril(A * d) from the unscaled updated columns (batch_chol.py:81-83).
// nvcc contracts the update's multiply and subtract into an FMA, so the
// kernels agree with the plain versions to roundoff, not bit for bit.
//
// What bounds row 24 on the H100: neither bytes nor flops.  A (1024, 72, 72)
// f32 batch reads 10.6 MB (the lower triangles) and writes 21.2 MB: ~9.5 us
// of HBM time; its n^3/6 multiply-adds per matrix are 0.13 GFLOP, ~2 us of
// the f32 peak.  The factorization is n dependent column steps, each a
// block barrier, so a matrix's time is n steps of barrier latency and a
// short shared-memory update; the card hides it by running several
// matrices' blocks on each SM.
//
// Design (row 24): one thread block of 256 threads per matrix.  The lower
// triangle lives in dynamic shared memory, packed row by row (entry (i, k),
// k <= i, at i(i+1)/2 + k), with two vectors of n: the scaled column c and
// the pivots.  Column step j: every thread forms d_j from a_jj itself (no
// broadcast), the threads write c_i = a_ij d_j for i > j, a barrier, then
// each warp takes rows i > j in turn and its lanes the columns k in (j, i]:
// a_ik -= c_i c_k (JAX's (A[:, j] d)(A[j, :] d) on a symmetric A), a
// barrier.  Column j itself stays unscaled; the epilogue writes L_ik =
// a_ik d_k for k <= i and 0 above the diagonal, row by row, coalesced.  A
// packed triangle fits the 227 KB a block may use up to n ~ 340 in f32 and
// n ~ 240 in f64; past that the same loop runs on the output itself in
// device memory (row-major, lower triangle), so no size is refused.  Only
// the lower triangle of A is read: on a symmetric input the TPU kernel's
// upper entries equal the lower ones bit for bit at every step (each update
// multiplies the same two numbers), so this is its arithmetic.
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

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int PANEL_WARPS = 4;
constexpr int MAX_P = 32;
constexpr size_t SMEM_LIMIT = 232448;

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

__device__ __forceinline__ int64_t packed(int64_t i, int64_t k) {
  return i * (i + 1) / 2 + k;
}

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

// One matrix per block.  PACKED: the triangle in shared memory; else in
// the output matrix itself (row-major, device memory).
template <typename T, bool PACKED>
__global__ void __launch_bounds__(THREADS)
    cholesky_kernel(const T* __restrict__ A, T* __restrict__ L, int64_t n) {
  extern __shared__ unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  const int64_t nn = n * n;
  const T* a = A + blockIdx.x * nn;
  T* out = L + blockIdx.x * nn;
  T* tri = PACKED ? sh : out;
  T* col = PACKED ? sh + n * (n + 1) / 2 : sh;  // c_i of the column step
  T* dv = col + n;                              // the pivots
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  auto at = [&](int64_t i, int64_t k) -> T& {
    return PACKED ? tri[packed(i, k)] : tri[i * n + k];
  };

  for (int64_t e = tid; e < nn; e += THREADS) {
    const int64_t i = e / n, k = e - (e / n) * n;
    if (k <= i) at(i, k) = a[e];
  }
  __syncthreads();

  for (int64_t j = 0; j < n; ++j) {
    const T d = pivot(at(j, j));
    if (tid == 0) dv[j] = d;
    for (int64_t i = j + 1 + tid; i < n; i += THREADS) col[i] = at(i, j) * d;
    __syncthreads();
    for (int64_t i = j + 1 + warp; i < n; i += NWARPS) {
      const T ci = col[i];
      for (int64_t k = j + 1 + lane; k <= i; k += 32)
        at(i, k) = at(i, k) - ci * col[k];
    }
    __syncthreads();
  }

  for (int64_t e = tid; e < nn; e += THREADS) {
    const int64_t i = e / n, k = e - (e / n) * n;
    out[e] = k <= i ? at(i, k) * dv[k] : T(0);
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

template <typename T>
size_t chol_smem(int64_t n, bool packed) {
  return static_cast<size_t>((packed ? n * (n + 1) / 2 : 0) + 2 * n) *
         sizeof(T);
}

template <typename T, bool PACKED>
int launch_chol(const CholArgs& a, cudaStream_t stream) {
  const size_t smem = chol_smem<T>(a.n, PACKED);
  cudaError_t e = cudaFuncSetAttribute(
      cholesky_kernel<T, PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cholesky_kernel<T, PACKED><<<static_cast<unsigned>(a.B), THREADS, smem,
                               stream>>>(static_cast<const T*>(a.A),
                                         static_cast<T*>(a.L), a.n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int chol(const CholArgs& a, cudaStream_t stream) {
  if (chol_smem<T>(a.n, true) <= SMEM_LIMIT)
    return launch_chol<T, true>(a, stream);
  return launch_chol<T, false>(a, stream);
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
  if (a->B < 1 || a->B > 0x7fffffff || a->n < 1)
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
