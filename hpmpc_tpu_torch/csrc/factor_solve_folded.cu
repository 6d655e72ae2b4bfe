// Riccati factorization + forward recovery of a batch of OCP KKT systems
// with the FULL factor, in ONE kernel.  Two forms of the stage's Hessian:
//
//   * folded (Queue 2 row 16): the effective Hessian H + diag(dvec) (+ the
//     packed C' diag(Qx_g) C term on the stages of the ng table) is
//     assembled from the constant packed H;
//   * whole (Queue 2 row 14): the effective Hessian is read whole, lower
//     triangle only.
//
// Replaces: hpmpc_tpu/ops/stage_kernel.py::factor_solve_folded (two TPU
// calls: _bwd_kernel_folded unsplit, :1069, then _fwd_kernel, :1092) and
// ::factor_solve_batched (_bwd_kernel, :764, then _fwd_kernel, :793), each
// followed there by an XLA tail for stage N's u and x, which this kernel
// computes itself.  Plain versions: hpmpc_tpu_torch/ops/stage_kernel.py::
// factor_solve_folded_ref, ::factor_solve_batched_ref.
//
// What bounds it on the H100: per instance and stage the backward sweep
// reads the packed H (or the whole Hessian), dvec, g, F and b and writes
// the full (NZ, NZ) factor, eu (NZ), px and Pb; the forward sweep reads the
// factor's Ll columns and Lxx block back with eu and px and writes z and pi
// -- at the flagship (N=30, NZ=11, NX=8, NU=3) ~360 scalars per stage, the
// 121-scalar factor the largest stream (61 MB of the ~180 MB a call moves
// in f32 at B=4096), against ~2.5k flops: ~1.3 flop/byte, memory bound in
// principle.  In practice the stage is a chain of small dependent steps 31
// stages deep: at one thread an instance (this kernel's first version, 128
// warps at B=4096, one an SM) each thread waited alone on every load, at
// ~20% of the byte bound.
//
// Design: row 9's team (csrc/folded_team.cuh, whose head comment gives
// it), a team of lanes an instance in the register form (f32, f64 to
// NZ=11) or the shared-memory form (f64 past it), struct Row9's rule; only
// the I/O differs from row 9 (FullIO below): the whole form reads the
// lower triangle of the effective Hessian in place of packed H + dvec +
// the ng term; the factor goes out whole with its strictly upper part
// zero (the TPU's _chol + _store_mat), each row stored by its owner; eu
// goes out padded to NZ with zeros, px and Pb (N rows: the terminal Pb is
// never stored) batch-last, and the forward sweep reads eu and px back
// from those outputs; pi always.  The pivot clamp is the TPU kernels'
// rsqrt(max(a, 1e-20)) in both types (the plain Riccati's tri.cholesky
// clamps at 1e-30 in f64).  Bit for bit the outputs of this kernel's
// one-thread first version (hp::folded_bwd_core and the forward helpers,
// the same expressions as row 9's).
//
// Specialisation: NU, NX compile-time (-D, one library per shape); the form
// and "has ng rows" template parameters; N and the ng table runtime.
#include "folded_team.cuh"

// Mirrors _FoldedArgs in hpmpc_tpu_torch/ops/stage_kernel.py field for
// field.
struct FactorSolveFoldedArgs {
  const void* H;         // folded: (N+1, NT, B) packed; whole: (N+1, NZ, NZ, B)
  const void* dvec;      // (N+1, NZ, B) barrier diagonal (folded form only)
  const void* ngl;       // (n_ng, NT, B) packed C' diag(Qx_g) C (folded)
  const void* ng_stage;  // (n_ng,) int32 stage of each ng slot, distinct
  const void* g;         // (N+1, NZ, B) effective gradient
  const void* F;         // (N, NZ, NX, B)
  const void* b;         // (N, NX, B)
  void* L;               // (N+1, NZ, NZ, B), strictly upper part 0
  void* eu;              // (N+1, NZ, B), 0 past NU
  void* px;              // (N+1, NX, B)
  void* Pb;              // (N, NX, B)
  void* z;               // (N+1, NZ, B)
  void* pi;              // (N, NX, B)
  int64_t B;
  int64_t N;
  int64_t n_ng;
};

namespace {

// Rows 16 and 14's I/O policy (csrc/folded_team.cuh): the full factor, eu
// (padded) and px as batch-last outputs, read back by the forward sweep.
template <typename T, bool WHOLE_>
struct FullIO {
  static constexpr bool WHOLE = WHOLE_;
  static constexpr int EU_ROWS = NZ;
  static constexpr bool STORE_PX = true;
  static constexpr bool LL_ROWS = true;
  const T* H;
  T* L;
  T* EU;
  T* PX;
  int64_t B;
  __device__ __forceinline__ FullIO(const FactorSolveFoldedArgs& a,
                                    int64_t bi)
      : H(static_cast<const T*>(a.H) + bi),
        L(static_cast<T*>(a.L) + bi),
        EU(static_cast<T*>(a.eu) + bi),
        PX(static_cast<T*>(a.px) + bi),
        B(a.B) {}
  __device__ __forceinline__ const T& h(int k, int e) const {
    if constexpr (WHOLE) {
      const int i = hp::tril_row<NZ>(e);
      return H[((static_cast<int64_t>(k) * NZ + i) * NZ + e - i * (i + 1) / 2) *
               B];
    } else {
      return H[(static_cast<int64_t>(k) * NT + e) * B];
    }
  }
  __device__ __forceinline__ T& ll(int s, int i, int j) const {
    return L[((static_cast<int64_t>(s) * NZ + i) * NZ + j) * B];
  }
  __device__ __forceinline__ T& lxx(int s, int i, int j) const {
    return ll(s, NU + i, NU + j);
  }
  template <typename G>
  __device__ __forceinline__ void row(int k, int i, const G& get) const {
#pragma unroll
    for (int j = 0; j < NZ; ++j) ll(k, i, j) = j <= i ? get(j < i ? j : i) : T(0);
  }
  __device__ __forceinline__ T& eu(int s, int j) const {
    return EU[(static_cast<int64_t>(s) * NZ + j) * B];
  }
  __device__ __forceinline__ T& px(int s, int i) const {
    return PX[(static_cast<int64_t>(s) * NX + i) * B];
  }
  __device__ __forceinline__ int64_t eu_stride() const { return B; }
  __device__ __forceinline__ int64_t px_stride() const { return B; }
};

}  // namespace

// The shared-memory form (folded_team.cuh smem_body), pi always.
template <typename T, bool WHOLE, bool HAS_NG>
__global__ void __launch_bounds__(THREADS)
    factor_solve_folded_smem_kernel(FactorSolveFoldedArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  smem_body<T, true, HAS_NG, FullIO<T, WHOLE>>(a, smem_raw);
}

// The register form (folded_team.cuh reg_body), pi always.
template <typename T, bool WHOLE, bool HAS_NG>
__global__ void __launch_bounds__(THREADS)
    factor_solve_folded_kernel(FactorSolveFoldedArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  reg_body<T, true, HAS_NG, FullIO<T, WHOLE>>(a, smem_raw);
}

template <typename T, bool WHOLE, bool HAS_NG>
static int launch(const FactorSolveFoldedArgs& a, cudaStream_t stream) {
  if constexpr (Row9<T>::REG)
    return start_team<T>(factor_solve_folded_kernel<T, WHOLE, HAS_NG>, a,
                         stream);
  else
    return start_team<T>(factor_solve_folded_smem_kernel<T, WHOLE, HAS_NG>,
                         a, stream);
}

template <typename T>
static int dispatch(const FactorSolveFoldedArgs& a, bool whole,
                    cudaStream_t stream) {
  if (whole) return launch<T, true, false>(a, stream);
  return a.n_ng > 0 ? launch<T, false, true>(a, stream)
                    : launch<T, false, false>(a, stream);
}

static int entry(const FactorSolveFoldedArgs* a, int dtype_code, bool whole,
                 cudaStream_t stream) {
  if (a->B <= 0 || a->N <= 0 || a->n_ng < 0 || (whole && a->n_ng != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return dispatch<float>(*a, whole, stream);
  if (dtype_code == 1) return dispatch<double>(*a, whole, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int hp_factor_solve_folded(const FactorSolveFoldedArgs* a,
                                      int dtype_code, cudaStream_t stream) {
  return entry(a, dtype_code, false, stream);
}

extern "C" int hp_factor_solve_batched(const FactorSolveFoldedArgs* a,
                                       int dtype_code, cudaStream_t stream) {
  return entry(a, dtype_code, true, stream);
}

// The launch layout of rows 16 and 14 in dtype_code (folded_team.cuh
// team_layout; no scratch: eu and px are outputs).  N is not used: the
// layout does not depend on the horizon.
extern "C" void hp_factor_solve_folded_layout(int64_t N, int dtype_code,
                                              int64_t* out) {
  (void)N;
  if (dtype_code == 1)
    team_layout<double>(0, out);
  else
    team_layout<float>(0, out);
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
