// The three box-stream step passes of the 6-kernel lanes loop, one CUDA
// thread per (stage, instance):
//
//   hp_prep_flat       barrier Hessian diagonal + effective gradient
//   hp_alpha_sums_flat box direction of a z direction, fraction-to-boundary
//                      minimum and mu(alpha) partials per stage
//   hp_corr_geff_flat  centering/corrector stream + second effective
//                      gradient
//
// Replaces: hpmpc_tpu/ops/step_kernel.py::prep_flat, ::alpha_sums_flat and
// ::corr_geff_flat (TPU bodies _prep_kernel, _alpha_kernel, _corr_kernel).
// Plain versions: hpmpc_tpu_torch/ops/step_kernel.py::*_ref.
//
// What bounds them on the H100: memory.  Per (stage, instance) each reads
// a handful of box streams (2NB = 14 slots each at the flagship) and one
// or two z-space streams and writes one or two: prep 5x14 + 2x11 read,
// 2x11 written; alpha 11 + 5x14 read, 2x14 + 4 written; corr 7x14 + 11 +
// 1 read, 11 + 14 written -- 70 to 110 scalars against 100 to 200 flops,
// ~0.5 flop/byte in f32, far below the card's ~20 flop/byte balance point.
//
// Design: the stages are independent of each other (no sweep), so the TPU
// grid (nb blocks of 1024 lanes, N+1 stage steps) becomes one flat grid of
// (N+1)*B threads, thread = stage * B + instance.  Streams are batch-last,
// so a warp (32 consecutive instances of one stage) reads 32 consecutive
// scalars per row: every load is coalesced and each byte is read once.
// The box gather/scatter through the (N+1, NB) index table is a select
// chain over the NZ slots (csrc/stage_math.cuh), which keeps the z-space
// rows in registers.  The phase (delta or residual box formulas) and, for
// the alpha pass, the presence of the phase-1 centering stream dl0 are
// template parameters, as in the mega kernels.
//
// Specialisation: NZ and NB are compile-time (-D, one library per shape);
// N is runtime.
#include "stage_math.cuh"

#if !defined(HP_NZ) || !defined(HP_NB)
#error "compile with -DHP_NZ=.. -DHP_NB=.."
#endif

namespace {

constexpr int NZ = HP_NZ;
constexpr int NB = HP_NB;
constexpr int NB2 = 2 * NB;
constexpr int BLOCK = 128;

}  // namespace

// Mirrors _PrepArgs in hpmpc_tpu_torch/ops/step_kernel.py field for field.
struct PrepArgs {
  const void* idx;    // (N+1, NB) int32
  const void* lam;    // (N+1, 2NB, B)
  const void* t;      // (N+1, 2NB, B)
  const void* A;      // (N+1, 2NB, B) d_cat (phase 1) / rd (phase 2)
  const void* M;      // (N+1, 2NB, B) rm (phase 2 only)
  const void* mb;     // (N+1, 2NB, B)
  const void* base;   // (N+1, NZ, B) gradient base (g or rq)
  const void* pdreg;  // (N+1, NZ, B) pad_diag + reg_eps
  void* dvec;         // (N+1, NZ, B)
  void* geff;         // (N+1, NZ, B)
  int64_t B;
  int64_t N;
  int64_t phase2;
};

// Mirrors _AlphaArgs.
struct AlphaArgs {
  const void* idx;  // (N+1, NB) int32
  const void* dz;   // (N+1, NZ, B) the z direction
  const void* lam;  // (N+1, 2NB, B)
  const void* t;    // (N+1, 2NB, B)
  const void* A;    // (N+1, 2NB, B)
  const void* M;    // (N+1, 2NB, B) rm / rm2 (phase 2 only)
  const void* dl0;  // (N+1, 2NB, B) centering stream (phase-1 corrector)
  const void* mb;   // (N+1, 2NB, B)
  void* dt;         // (N+1, 2NB, B)
  void* dl;         // (N+1, 2NB, B)
  void* amin;       // (N+1, B)
  void* s0;         // (N+1, B)
  void* s1;         // (N+1, B)
  void* s2;         // (N+1, B)
  int64_t B;
  int64_t N;
  int64_t phase2;
};

// Mirrors _CorrArgs.
struct CorrArgs {
  const void* idx;   // (N+1, NB) int32
  const void* lam;   // (N+1, 2NB, B)
  const void* t;     // (N+1, 2NB, B)
  const void* A;     // (N+1, 2NB, B)
  const void* M;     // (N+1, 2NB, B) rm (phase 2 only)
  const void* dtb;   // (N+1, 2NB, B) affine slack direction
  const void* dlb;   // (N+1, 2NB, B) affine dual direction
  const void* sm;    // (B,) sigma * mu
  const void* base;  // (N+1, NZ, B)
  const void* mb;    // (N+1, 2NB, B)
  void* geff;        // (N+1, NZ, B)
  void* co;          // (N+1, 2NB, B) dl2 (phase 1) / rm2 (phase 2)
  int64_t B;
  int64_t N;
  int64_t phase2;
};

namespace {

// This thread's (stage, instance), or false past the last one.
__device__ __forceinline__ bool stage_instance(int64_t B, int64_t N, int& n,
                                               int64_t& bi) {
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= (N + 1) * B) return false;
  n = static_cast<int>(tid / B);
  bi = tid - static_cast<int64_t>(n) * B;
  return true;
}

template <typename T>
__device__ __forceinline__ hp::Col<const T> col_in(const void* p,
                                                   int64_t bi, int64_t B) {
  return hp::Col<const T>{static_cast<const T*>(p) + bi, B};
}

template <typename T>
__device__ __forceinline__ hp::Col<T> col_out(void* p, int64_t bi,
                                              int64_t B) {
  return hp::Col<T>{static_cast<T*>(p) + bi, B};
}

}  // namespace

template <typename T, bool PHASE2>
__global__ void __launch_bounds__(BLOCK) prep_flat_kernel(PrepArgs a) {
  int n;
  int64_t bi;
  if (!stage_instance(a.B, a.N, n, bi)) return;
  const int64_t B = a.B;
  const int* idx = static_cast<const int*>(a.idx) + n * NB;
  const int64_t r = static_cast<int64_t>(n) * NB2;
  const int64_t rz = static_cast<int64_t>(n) * NZ;
  T lam[NB2], t[NB2], mb[NB2], A[NB2], M[NB2];
  hp::load(lam, col_in<T>(a.lam, bi, B), r);
  hp::load(t, col_in<T>(a.t, bi, B), r);
  hp::load(mb, col_in<T>(a.mb, bi, B), r);
  hp::load(A, col_in<T>(a.A, bi, B), r);
  T Qx[NB], qx[NB];
  if (PHASE2) {
    hp::load(M, col_in<T>(a.M, bi, B), r);
    hp::qx_fold_res<T, NB>(lam, t, mb, A, M, Qx, qx);
  } else {
    hp::qx_fold<T, NB>(lam, t, mb, A, Qx, qx);
  }
  T v[NZ];
  hp::load(v, col_in<T>(a.pdreg, bi, B), rz);
  hp::scatter_add_box<T, NB, NZ>(v, idx, Qx);
  hp::store(col_out<T>(a.dvec, bi, B), rz, v);
  hp::load(v, col_in<T>(a.base, bi, B), rz);
  hp::scatter_add_box<T, NB, NZ>(v, idx, qx);
  hp::store(col_out<T>(a.geff, bi, B), rz, v);
}

template <typename T, bool PHASE2, bool HAS_DL0>
__global__ void __launch_bounds__(BLOCK) alpha_sums_flat_kernel(AlphaArgs a) {
  int n;
  int64_t bi;
  if (!stage_instance(a.B, a.N, n, bi)) return;
  const int64_t B = a.B;
  const int* idx = static_cast<const int*>(a.idx) + n * NB;
  const int64_t r = static_cast<int64_t>(n) * NB2;
  T z[NZ], zb[NB];
  hp::load(z, col_in<T>(a.dz, bi, B), static_cast<int64_t>(n) * NZ);
  hp::gather_box<T, NB, NZ>(z, idx, zb);
  T lam[NB2], t[NB2], mb[NB2], A[NB2], dtb[NB2], dlb[NB2];
  hp::load(lam, col_in<T>(a.lam, bi, B), r);
  hp::load(t, col_in<T>(a.t, bi, B), r);
  hp::load(mb, col_in<T>(a.mb, bi, B), r);
  hp::load(A, col_in<T>(a.A, bi, B), r);
  if (PHASE2) {
    T M[NB2];
    hp::load(M, col_in<T>(a.M, bi, B), r);
    hp::dt_dlam_res<T, NB>(lam, t, mb, A, M, zb, dtb, dlb);
  } else {
    T dl0[NB2];
#pragma unroll
    for (int i = 0; i < NB2; ++i) dl0[i] = T(0);
    if (HAS_DL0) hp::load(dl0, col_in<T>(a.dl0, bi, B), r);
    hp::dt_dlam<T, NB>(lam, t, mb, A, zb, dl0, dtb, dlb);
  }
  hp::store(col_out<T>(a.dt, bi, B), r, dtb);
  hp::store(col_out<T>(a.dl, bi, B), r, dlb);
  T am = T(INFINITY), e0 = T(0), e1 = T(0), e2 = T(0);
  hp::alpha_sums<T, NB2>(lam, t, mb, dtb, dlb, am, e0, e1, e2);
  col_out<T>(a.amin, bi, B)(n) = am;
  col_out<T>(a.s0, bi, B)(n) = e0;
  col_out<T>(a.s1, bi, B)(n) = e1;
  col_out<T>(a.s2, bi, B)(n) = e2;
}

template <typename T, bool PHASE2>
__global__ void __launch_bounds__(BLOCK) corr_geff_flat_kernel(CorrArgs a) {
  int n;
  int64_t bi;
  if (!stage_instance(a.B, a.N, n, bi)) return;
  const int64_t B = a.B;
  const int* idx = static_cast<const int*>(a.idx) + n * NB;
  const int64_t r = static_cast<int64_t>(n) * NB2;
  const int64_t rz = static_cast<int64_t>(n) * NZ;
  T lam[NB2], t[NB2], mb[NB2], A[NB2], dtb[NB2], dlb[NB2], co[NB2];
  hp::load(lam, col_in<T>(a.lam, bi, B), r);
  hp::load(t, col_in<T>(a.t, bi, B), r);
  hp::load(mb, col_in<T>(a.mb, bi, B), r);
  hp::load(A, col_in<T>(a.A, bi, B), r);
  hp::load(dtb, col_in<T>(a.dtb, bi, B), r);
  hp::load(dlb, col_in<T>(a.dlb, bi, B), r);
  const T smv = col_in<T>(a.sm, bi, B)(0);
  T qx[NB];
  if (PHASE2) {
    T M[NB2];
    hp::load(M, col_in<T>(a.M, bi, B), r);
    hp::corr_co_qx_res<T, NB>(lam, t, mb, A, M, dtb, dlb, smv, co, qx);
  } else {
    hp::corr_co_qx<T, NB>(lam, t, mb, A, dtb, dlb, smv, co, qx);
  }
  hp::store(col_out<T>(a.co, bi, B), r, co);
  T g[NZ];
  hp::load(g, col_in<T>(a.base, bi, B), rz);
  hp::scatter_add_box<T, NB, NZ>(g, idx, qx);
  hp::store(col_out<T>(a.geff, bi, B), rz, g);
}

namespace {

template <typename Args>
unsigned n_blocks(const Args& a) {
  return static_cast<unsigned>(((a.N + 1) * a.B + BLOCK - 1) / BLOCK);
}

template <typename Args>
bool bad_args(const Args* a) {
  return a->B <= 0 || a->N <= 0;
}

template <typename T>
int prep(const PrepArgs& a, cudaStream_t s) {
  if (a.phase2)
    prep_flat_kernel<T, true><<<n_blocks(a), BLOCK, 0, s>>>(a);
  else
    prep_flat_kernel<T, false><<<n_blocks(a), BLOCK, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int alpha(const AlphaArgs& a, cudaStream_t s) {
  if (a.phase2)
    alpha_sums_flat_kernel<T, true, false><<<n_blocks(a), BLOCK, 0, s>>>(a);
  else if (a.dl0 != nullptr)
    alpha_sums_flat_kernel<T, false, true><<<n_blocks(a), BLOCK, 0, s>>>(a);
  else
    alpha_sums_flat_kernel<T, false, false><<<n_blocks(a), BLOCK, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int corr(const CorrArgs& a, cudaStream_t s) {
  if (a.phase2)
    corr_geff_flat_kernel<T, true><<<n_blocks(a), BLOCK, 0, s>>>(a);
  else
    corr_geff_flat_kernel<T, false><<<n_blocks(a), BLOCK, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hp_prep_flat(const PrepArgs* a, int dtype_code,
                            cudaStream_t stream) {
  if (bad_args(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return prep<float>(*a, stream);
  if (dtype_code == 1) return prep<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int hp_alpha_sums_flat(const AlphaArgs* a, int dtype_code,
                                  cudaStream_t stream) {
  if (bad_args(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return alpha<float>(*a, stream);
  if (dtype_code == 1) return alpha<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int hp_corr_geff_flat(const CorrArgs* a, int dtype_code,
                                 cudaStream_t stream) {
  if (bad_args(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return corr<float>(*a, stream);
  if (dtype_code == 1) return corr<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
