// Retained-factor re-solve of a batch of OCP KKT systems on the FULL factor
// in ONE kernel: backward substitution with the cached Pb + forward
// recovery with pi.
//
// Replaces: hpmpc_tpu/ops/stage_kernel.py::solve_batched (Queue 2 row 15),
// two TPU calls: the backward substitution (_bwd_trs_kernel, :902) and the
// forward recovery (_fwd_kernel, :923), followed there by an XLA tail for
// stage N's u and x, which this kernel computes itself.  Plain version:
// hpmpc_tpu_torch/ops/stage_kernel.py::solve_batched_ref.
//
// What bounds it on the H100: per instance and stage it reads the Luu/Lxu
// columns of L and its Lxx block's lower triangle, g, F, Pb and b, and
// writes z and pi -- the factor is the largest input stream (at the
// flagship, N=30, NZ=11, B=4096 in f32, ~100 MB a call), against ~0.7k
// flops per stage: memory bound in principle.  In practice the backward
// substitution and the forward recovery are chains of small dependent
// steps 31 stages deep: at one thread an instance (this kernel's first
// version, 128 warps at B=4096) each warp waited alone on every load of
// its chain, at ~11% of the byte bound.
//
// Design: row 10's (csrc/solve_flat.cu, on hp::ReSolve in csrc/team.cuh,
// whose design csrc/refine_flat.cu's head comment gives) in its cached-Pb
// mode: a team of 4 lanes an instance (8 to NZ=24), 8 instances' teams a
// warp, 4 warps a block; warp 0 runs the serial chain with the stage's F
// and Ll and kept rows copied a step ahead into a shared-memory ring, the
// worker warps keep g, b, the cached Pb and the pivots of every stage in
// device memory ahead of it and then run the epilogue (pi, the stores).
// The one difference from row 10 is the view of the factor (ReSolve's
// FULL): Ll is read as the columns 0..NU-1 of each (NZ, NZ) stage block,
// Lxx as its (NU:, NU:) block, both at row stride NZ.  Bit for bit the
// outputs of this kernel's one-thread first version (hp::trs_stage and the
// forward helpers, the same expressions as row 10's; the chain adds the
// cached Pb_0 + px_0).  Pb has N rows, read for k < N only; F/b clip to N-1
// at the terminal stage.
//
// Specialisation: NU, NX compile-time (-D, one library per shape); N
// runtime.
#include "team.cuh"

#if !defined(HP_NU) || !defined(HP_NX)
#error "compile with -DHP_NU=.. -DHP_NX=.."
#endif

namespace {

constexpr int NU = HP_NU;
constexpr int NX = HP_NX;
// the team geometry and phases of row 10's cached-Pb form on the full
// factor: no general rows
using RF = hp::ReSolve<NU, NX, 0, false, true, true>;

}  // namespace

// Mirrors _TrsArgs in hpmpc_tpu_torch/ops/stage_kernel.py field for field.
struct SolveBatchedArgs {
  const void* L;   // (N+1, NZ, NZ, B), lower triangle read
  const void* g;   // (N+1, NZ, B)
  const void* F;   // (N, NZ, NX, B)
  const void* b;   // (N, NX, B)
  const void* Pb;  // (N, NX, B)
  void* z;         // (N+1, NZ, B)
  void* pi;        // (N, NX, B)
  void* work;      // the kept rows (hp_solve_batched_layout's size)
  int64_t B;
  int64_t N;
};

// hp::ReSolve::run_cached_pb on the full factor.
template <typename T>
__global__ void __launch_bounds__(RF::THREADS, sizeof(T) == 4 ? RF::MIN_BLOCKS_F32 : RF::MIN_BLOCKS_F64)
    solve_batched_kernel(SolveBatchedArgs a, RF::Geo geo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RF::run_cached_pb<T>(geo, smem_raw, a.B, static_cast<int>(a.N), a.work,
                       a.L, a.L, a.Pb, a.g, a.F, a.b, a.z, a.pi);
}

template <typename T>
static int launch(const SolveBatchedArgs& a, cudaStream_t stream) {
  if (a.work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return RF::start<T>(solve_batched_kernel<T>, a, a.B, a.N, stream);
}

extern "C" int hp_solve_batched(const SolveBatchedArgs* a, int dtype_code,
                                cudaStream_t stream) {
  if (a->B <= 0 || a->N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return launch<float>(*a, stream);
  if (dtype_code == 1) return launch<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Row 15's launch layout at horizon N in dtype_code (hp::ReSolve::layout).
// The wrapper sizes `work` from it.
extern "C" void hp_solve_batched_layout(int64_t N, int dtype_code,
                                        int64_t* out) {
  RF::layout(N, dtype_code, out);
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
