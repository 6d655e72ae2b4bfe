// The three soft step passes of the soft lanes engine's 6-kernel loop, one
// CUDA thread per (stage, instance):
//
//   hp_soft_prep_flat       box fold + soft slack Schur elimination, both
//                           scattered -> barrier Hessian diagonal and
//                           effective gradient
//   hp_soft_alpha_sums_flat box and soft directions of a z direction,
//                           fraction-to-boundary minimum and mu(alpha)
//                           partials per stage; affine or corrector
//   hp_soft_corr_flat       both families' centering corrections + the
//                           second effective gradient; exact or the
//                           reference's dropped correction
//
// Replaces: hpmpc_tpu/ops/step_kernel.py::soft_prep_flat,
// ::soft_alpha_sums_flat and ::soft_corr_flat (TPU bodies
// _soft_prep_kernel, _soft_alpha_kernel, _soft_corr_kernel).  Plain
// versions: hpmpc_tpu_torch/ops/step_kernel.py::soft_*_ref.
//
// What bounds them on the H100: memory.  Per (stage, instance) each reads
// the box streams (2NB slots), the soft ones (4NS + 4NS + 6NS + NS) and a
// z-space stream or two, and writes one to four: at the soft flagship
// (NZ=11, NB=3, NS=8) 160 to 250 scalars against ~300 to 500 flops, ~0.5
// flop/byte in f32, far below the card's ~20 flop/byte balance point.
//
// Design: as csrc/step_flat.cu -- no sweep, so one flat grid of (N+1)*B
// threads, thread = stage * B + instance, batch-last streams (coalesced).
// The stage math is the soft twins' __device__ functions of
// csrc/stage_math.cuh (hp::soft_fold, hp::soft_alpha_pass,
// hp::soft_corr_fold), which the soft mega kernels run too.  The alpha
// pass's corrector form and the corrector pass's EXACT are template
// parameters.
//
// Specialisation: NZ, NB and NS are compile-time (-D, one library per
// shape); N is runtime.
#include "stage_math.cuh"

#if !defined(HP_NZ) || !defined(HP_NB) || !defined(HP_NS)
#error "compile with -DHP_NZ=.. -DHP_NB=.. -DHP_NS=.."
#endif

namespace {

constexpr int NZ = HP_NZ;
constexpr int NB = HP_NB;
constexpr int NB2 = 2 * NB;
constexpr int NS = HP_NS;
constexpr int NS4 = 4 * NS;
constexpr int NS6 = 6 * NS;
constexpr int BLOCK = 128;

}  // namespace

// Mirrors _SoftPrepArgs in hpmpc_tpu_torch/ops/step_kernel.py field for
// field; flag is unused.
struct SoftPrepArgs {
  const void* idxb;    // (N+1, NB) int32
  const void* idxs;    // (N+1, NS) int32 (padded-z coordinates)
  const void* lam;     // (N+1, 2NB, B)
  const void* t;       // (N+1, 2NB, B)
  const void* A;       // (N+1, 2NB, B) d_cat
  const void* mb;      // (N+1, 2NB, B)
  const void* lam_s;   // (N+1, 4NS, B)
  const void* t_s;     // (N+1, 4NS, B)
  const void* soft_c;  // (N+1, 6NS, B)
  const void* ms;      // (N+1, NS, B)
  const void* base;    // (N+1, NZ, B) gradient base g
  const void* pdreg;   // (N+1, NZ, B) pad_diag + reg_eps
  void* dvec;          // (N+1, NZ, B)
  void* geff;          // (N+1, NZ, B)
  int64_t B;
  int64_t N;
  int64_t flag;
};

// Mirrors _SoftAlphaArgs; flag: the corrector pass.
struct SoftAlphaArgs {
  const void* idxb;    // (N+1, NB) int32
  const void* idxs;    // (N+1, NS) int32
  const void* dz;      // (N+1, NZ, B) the z direction
  const void* lam;     // (N+1, 2NB, B)
  const void* t;       // (N+1, 2NB, B)
  const void* A;       // (N+1, 2NB, B)
  const void* mb;      // (N+1, 2NB, B)
  const void* lam_s;   // (N+1, 4NS, B)
  const void* t_s;     // (N+1, 4NS, B)
  const void* soft_c;  // (N+1, 6NS, B)
  const void* ms;      // (N+1, NS, B)
  const void* dl0b;    // (N+1, 2NB, B) box centering stream (corrector)
  const void* dl2s;    // (N+1, 4NS, B) soft centering stream (corrector)
  void* dtb;           // (N+1, 2NB, B)
  void* dlb;           // (N+1, 2NB, B)
  void* dts;           // (N+1, 4NS, B)
  void* dls;           // (N+1, 4NS, B)
  void* amin;          // (N+1, B)
  void* s0;            // (N+1, B)
  void* s1;            // (N+1, B)
  void* s2;            // (N+1, B)
  int64_t B;
  int64_t N;
  int64_t flag;
};

// Mirrors _SoftCorrArgs; flag: exact_mehrotra_soft.
struct SoftCorrArgs {
  const void* idxb;    // (N+1, NB) int32
  const void* idxs;    // (N+1, NS) int32
  const void* lam;     // (N+1, 2NB, B)
  const void* t;       // (N+1, 2NB, B)
  const void* A;       // (N+1, 2NB, B)
  const void* mb;      // (N+1, 2NB, B)
  const void* lam_s;   // (N+1, 4NS, B)
  const void* t_s;     // (N+1, 4NS, B)
  const void* soft_c;  // (N+1, 6NS, B)
  const void* ms;      // (N+1, NS, B)
  const void* dtb;     // (N+1, 2NB, B) affine box slack direction
  const void* dlb;     // (N+1, 2NB, B) affine box dual direction
  const void* dts;     // (N+1, 4NS, B) affine soft slack direction
  const void* dls;     // (N+1, 4NS, B) affine soft dual direction
  const void* sm;      // (B,) sigma * mu
  const void* base;    // (N+1, NZ, B)
  void* geff;          // (N+1, NZ, B)
  void* dl2b;          // (N+1, 2NB, B) box centering correction
  void* dl2s;          // (N+1, 4NS, B) soft centering correction
  int64_t B;
  int64_t N;
  int64_t flag;
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

// The box and soft streams of stage n of this instance.
template <typename T, typename Args>
__device__ __forceinline__ void load_stage(const Args& a, int n, int64_t bi,
                                           T (&lam)[NB2], T (&t)[NB2],
                                           T (&mb)[NB2], T (&A)[NB2],
                                           T (&ls)[NS4], T (&ts)[NS4],
                                           T (&c)[NS6], T (&ms)[NS]) {
  const int64_t B = a.B;
  const int64_t r = static_cast<int64_t>(n) * NB2;
  hp::load(lam, col_in<T>(a.lam, bi, B), r);
  hp::load(t, col_in<T>(a.t, bi, B), r);
  hp::load(mb, col_in<T>(a.mb, bi, B), r);
  hp::load(A, col_in<T>(a.A, bi, B), r);
  hp::load(ls, col_in<T>(a.lam_s, bi, B), static_cast<int64_t>(n) * NS4);
  hp::load(ts, col_in<T>(a.t_s, bi, B), static_cast<int64_t>(n) * NS4);
  hp::load(c, col_in<T>(a.soft_c, bi, B), static_cast<int64_t>(n) * NS6);
  hp::load(ms, col_in<T>(a.ms, bi, B), static_cast<int64_t>(n) * NS);
}

}  // namespace

template <typename T>
__global__ void __launch_bounds__(BLOCK) soft_prep_flat_kernel(SoftPrepArgs a) {
  int n;
  int64_t bi;
  if (!stage_instance(a.B, a.N, n, bi)) return;
  const int64_t B = a.B;
  const int64_t rz = static_cast<int64_t>(n) * NZ;
  T lam[NB2], t[NB2], mb[NB2], A[NB2], ls[NS4], ts[NS4], c[NS6], ms[NS];
  load_stage<T>(a, n, bi, lam, t, mb, A, ls, ts, c, ms);
  T dv[NZ], ge[NZ];
  hp::load(dv, col_in<T>(a.pdreg, bi, B), rz);
  hp::load(ge, col_in<T>(a.base, bi, B), rz);
  hp::soft_fold<T, NB, NS, NZ>(lam, t, mb, A, ls, ts, ms, c,
                               static_cast<const int*>(a.idxb) + n * NB,
                               static_cast<const int*>(a.idxs) + n * NS, dv,
                               ge);
  hp::store(col_out<T>(a.dvec, bi, B), rz, dv);
  hp::store(col_out<T>(a.geff, bi, B), rz, ge);
}

template <typename T, bool CORR>
__global__ void __launch_bounds__(BLOCK)
    soft_alpha_sums_flat_kernel(SoftAlphaArgs a) {
  int n;
  int64_t bi;
  if (!stage_instance(a.B, a.N, n, bi)) return;
  const int64_t B = a.B;
  T lam[NB2], t[NB2], mb[NB2], A[NB2], ls[NS4], ts[NS4], c[NS6], ms[NS];
  load_stage<T>(a, n, bi, lam, t, mb, A, ls, ts, c, ms);
  T z[NZ], dl0b[NB2], dl2s[NS4];
  hp::load(z, col_in<T>(a.dz, bi, B), static_cast<int64_t>(n) * NZ);
#pragma unroll
  for (int i = 0; i < NB2; ++i) dl0b[i] = T(0);
#pragma unroll
  for (int i = 0; i < NS4; ++i) dl2s[i] = T(0);
  if (CORR) {
    hp::load(dl0b, col_in<T>(a.dl0b, bi, B), static_cast<int64_t>(n) * NB2);
    hp::load(dl2s, col_in<T>(a.dl2s, bi, B), static_cast<int64_t>(n) * NS4);
  }
  T dtb[NB2], dlb[NB2], dts[NS4], dls[NS4], am, e0, e1, e2;
  hp::soft_alpha_pass<T, NB, NS, NZ, CORR>(
      z, static_cast<const int*>(a.idxb) + n * NB,
      static_cast<const int*>(a.idxs) + n * NS, lam, t, mb, A, dl0b, ls, ts,
      ms, c, dl2s, dtb, dlb, dts, dls, am, e0, e1, e2);
  hp::store(col_out<T>(a.dtb, bi, B), static_cast<int64_t>(n) * NB2, dtb);
  hp::store(col_out<T>(a.dlb, bi, B), static_cast<int64_t>(n) * NB2, dlb);
  hp::store(col_out<T>(a.dts, bi, B), static_cast<int64_t>(n) * NS4, dts);
  hp::store(col_out<T>(a.dls, bi, B), static_cast<int64_t>(n) * NS4, dls);
  col_out<T>(a.amin, bi, B)(n) = am;
  col_out<T>(a.s0, bi, B)(n) = e0;
  col_out<T>(a.s1, bi, B)(n) = e1;
  col_out<T>(a.s2, bi, B)(n) = e2;
}

template <typename T, bool EXACT>
__global__ void __launch_bounds__(BLOCK) soft_corr_flat_kernel(SoftCorrArgs a) {
  int n;
  int64_t bi;
  if (!stage_instance(a.B, a.N, n, bi)) return;
  const int64_t B = a.B;
  const int64_t rb = static_cast<int64_t>(n) * NB2;
  const int64_t rs = static_cast<int64_t>(n) * NS4;
  const int64_t rz = static_cast<int64_t>(n) * NZ;
  T lam[NB2], t[NB2], mb[NB2], A[NB2], ls[NS4], ts[NS4], c[NS6], ms[NS];
  load_stage<T>(a, n, bi, lam, t, mb, A, ls, ts, c, ms);
  T dtb[NB2], dlb[NB2], dts[NS4], dls[NS4];
  hp::load(dtb, col_in<T>(a.dtb, bi, B), rb);
  hp::load(dlb, col_in<T>(a.dlb, bi, B), rb);
  hp::load(dts, col_in<T>(a.dts, bi, B), rs);
  hp::load(dls, col_in<T>(a.dls, bi, B), rs);
  const T smv = col_in<T>(a.sm, bi, B)(0);
  T ge[NZ], cob[NB2], dl2s[NS4];
  hp::load(ge, col_in<T>(a.base, bi, B), rz);
  hp::soft_corr_fold<T, NB, NS, NZ, EXACT>(
      lam, t, mb, A, dtb, dlb, ls, ts, ms, c, dts, dls, smv,
      static_cast<const int*>(a.idxb) + n * NB,
      static_cast<const int*>(a.idxs) + n * NS, cob, dl2s, ge);
  hp::store(col_out<T>(a.geff, bi, B), rz, ge);
  hp::store(col_out<T>(a.dl2b, bi, B), rb, cob);
  hp::store(col_out<T>(a.dl2s, bi, B), rs, dl2s);
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
int prep(const SoftPrepArgs& a, cudaStream_t s) {
  soft_prep_flat_kernel<T><<<n_blocks(a), BLOCK, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int alpha(const SoftAlphaArgs& a, cudaStream_t s) {
  if (a.flag)
    soft_alpha_sums_flat_kernel<T, true><<<n_blocks(a), BLOCK, 0, s>>>(a);
  else
    soft_alpha_sums_flat_kernel<T, false><<<n_blocks(a), BLOCK, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int corr(const SoftCorrArgs& a, cudaStream_t s) {
  if (a.flag)
    soft_corr_flat_kernel<T, true><<<n_blocks(a), BLOCK, 0, s>>>(a);
  else
    soft_corr_flat_kernel<T, false><<<n_blocks(a), BLOCK, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hp_soft_prep_flat(const SoftPrepArgs* a, int dtype_code,
                                 cudaStream_t stream) {
  if (bad_args(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return prep<float>(*a, stream);
  if (dtype_code == 1) return prep<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int hp_soft_alpha_sums_flat(const SoftAlphaArgs* a, int dtype_code,
                                       cudaStream_t stream) {
  if (bad_args(a) || (a->flag && (!a->dl0b || !a->dl2s)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return alpha<float>(*a, stream);
  if (dtype_code == 1) return alpha<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int hp_soft_corr_flat(const SoftCorrArgs* a, int dtype_code,
                                 cudaStream_t stream) {
  if (bad_args(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return corr<float>(*a, stream);
  if (dtype_code == 1) return corr<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
