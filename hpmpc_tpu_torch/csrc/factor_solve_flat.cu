// Folded backward Riccati factorization + forward recovery of a batch of
// OCP KKT systems in ONE kernel.  Two forms:
//
//   * hp_factor_solve_folded_flat (factor_solve_flat_kernel or
//     factor_solve_flat_smem_kernel, Queue 2 row 9): a team of TEAM lanes
//     of one warp per instance, the eu/px slab in per-instance scratch in
//     device memory.  Replaces:
//     hpmpc_tpu/ops/stage_kernel.py::factor_solve_folded_flat, two TPU
//     calls: the backward sweep (_bwd_kernel_folded, split factor) and the
//     forward recovery (_forward_from_lanes -> _fwd_kernel_split).  Plain
//     version: hpmpc_tpu_torch/ops/stage_kernel.py::
//     factor_solve_folded_flat_ref.
//   * hp_factor_solve_folded_flat_fused (factor_solve_flat_fused_kernel,
//     Queue 2 row 18): its pi-less form, one thread an instance, with the
//     slab in shared memory.  Replaces:
//     hpmpc_tpu/ops/stage_kernel.py::factor_solve_folded_flat_fused
//     (_sv_fwd_fused_kernel, one two-phase-grid call that keeps Ll, eu, px
//     and the root Lxx in VMEM).  Plain version: factor_solve_folded_flat_ref
//     with want_pi=False (the same function).
//
// What bounds row 9 on the H100: latency.  Per instance and stage it reads
// the packed Hessian, dvec, g, F and b in the backward sweep and Ll, eu,
// F, b (and Lxx and px with pi) in the forward one, and writes the factor
// (Ll, Lxx, Pb), z and pi -- ~470 scalars at the flagship (N=30, NZ=11,
// NX=8, NU=3), ~1.9 KB in f32 -- against ~2.5k flops (W = F Lxx, W W', the
// 11x11 Cholesky, the solves): ~1.3 flop/byte, below the ~20 flop/byte f32
// balance point, so bound by its bytes in principle.  In practice the
// stage is a chain of small dependent steps 31 stages deep: at one thread
// an instance (this kernel's first version, 128 warps at B=4096, one an
// SM) every stage was a serial chain of ~2.5k flops in one thread that
// waited alone on every load, at ~15% of the byte bound.
//
// Design of row 9: a team of lanes an instance, in two forms (a register
// form and a shared-memory form, picked by struct Row9 from the dtype and
// the stage's size), on the bodies of csrc/folded_team.cuh, which rows 16
// and 14 (csrc/factor_solve_folded.cu) share; the design is in its head
// comment.  Row 9's I/O (SplitIO below): the packed H + diag(dvec) (+ the
// ng term) assembled, the factor split into Ll and Lxx, and eu and (with
// WANT_PI) px in per-instance, instance-major scratch (`work`,
// hp_factor_solve_flat_layout's rows an instance), read back by the
// forward sweep.
//
// Design of the fused form (one thread an instance, factor_solve_flat_
// sweeps): the TPU's two grids become two loops inside the thread: stages
// N..0 assemble H + diag(dvec) (+ ngl) in registers and factor it with the
// Riccati carry (Lxx, px) in registers; stages 0..N read back the factor
// and recover x and u.  The eu/px slab lies in the block's dynamic shared
// memory, [stage][k][thread] (a warp's accesses hit 32 consecutive words:
// no bank conflict), (N+1)(NU+NX) x 32 scalars a block, set at launch from
// N.  The root Lxx stays in the register carry; Ll is an output, read back
// from global memory in the forward loop (in shared memory too it would
// take NZ x NU more scalars a stage and a thread: at the flagship in f64,
// more than a block can have; PERF.md section 6).
//
// Specialisation: NU, NX compile-time (-D, one library per shape); WANT_PI
// (row 9) and "has ng rows" template parameters; N and the ng table
// runtime.
#include "folded_team.cuh"

namespace {

constexpr int BLOCK = 32;  // the fused form's threads a block

// rows of row 9's per-instance scratch: eu, then px, of every stage;
// instance-major
__host__ __device__ inline int64_t work_rows(int64_t N) {
  return (N + 1) * (NU + NX);
}

}  // namespace

// Mirrors _FactorArgs in hpmpc_tpu_torch/ops/stage_kernel.py field for
// field.
struct FactorSolveFlatArgs {
  const void* H;         // (N+1, NT, B) packed lower triangle
  const void* dvec;      // (N+1, NZ, B) barrier diagonal (+ pad + reg)
  const void* ngl;       // (n_ng, NT, B) packed C' diag(Qx_g) C
  const void* ng_stage;  // (n_ng,) int32 stage of each ng slot
  const void* g;         // (N+1, NZ, B) effective gradient
  const void* F;         // (N, NZ, NX, B)
  const void* b;         // (N, NX, B)
  void* Ll;              // (N+1, NZ, NU, B)
  void* Lxx;             // (N+1, NX, NX, B), upper triangle 0
  void* Pb;              // (N, NX, B)
  void* z;               // (N+1, NZ, B)
  void* pi;              // (N, NX, B), written with want_pi only
  void* work;            // (B, work_rows(N)) instance-major scratch: eu,
                         // px; NULL in the fused form
  int64_t B;
  int64_t N;
  int64_t n_ng;
  int64_t want_pi;
};

// The two sweeps of the fused form's instance bi; eus / pxs: its eu (N+1,
// NU) and px (N+1, NX) slab.
template <typename T, bool HAS_NG>
__device__ __forceinline__ void factor_solve_flat_sweeps(
    const FactorSolveFlatArgs& a, int64_t bi, const hp::Col<T>& eus,
    const hp::Col<T>& pxs) {
  using hp::Col;
  const int64_t B = a.B;
  const int N = static_cast<int>(a.N);
  const int n_ng = static_cast<int>(a.n_ng);
  const int* ng_stage = static_cast<const int*>(a.ng_stage);

  auto in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + bi, B};
  };
  auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + bi, B}; };
  const Col<const T> Hc = in(a.H), dvc = in(a.dvec), gc = in(a.g),
                     Fc = in(a.F), bc = in(a.b);
  const Col<T> Llo = out(a.Ll), Lxxo = out(a.Lxx), Pbo = out(a.Pb),
               zo = out(a.z);

  // ---- backward: assemble + folded factorization, k = N..0 --------------
  T Lxx_c[NX][NX], px_c[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    px_c[i] = T(0);
#pragma unroll
    for (int j = 0; j < NX; ++j) Lxx_c[i][j] = T(0);
  }
  for (int k = N; k >= 0; --k) {
    T M[NZ][NZ], ge[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j)
        M[i][j] = Hc(static_cast<int64_t>(k) * NT + hp::sym_idx(i, j));
#pragma unroll
    for (int i = 0; i < NZ; ++i)
      M[i][i] = M[i][i] + dvc(static_cast<int64_t>(k) * NZ + i);
    if (HAS_NG) {
      for (int jg = 0; jg < n_ng; ++jg) {
        if (ng_stage[jg] != k) continue;
        const Col<const T> nglc = in(a.ngl);
#pragma unroll
        for (int i = 0; i < NZ; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j)
            M[i][j] = M[i][j] +
                      nglc(static_cast<int64_t>(jg) * NT + hp::sym_idx(i, j));
      }
    }
    hp::load(ge, gc, static_cast<int64_t>(k) * NZ);
    const int ke = k < N - 1 ? k : N - 1;
    T F[NZ][NX], bb[NX];
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j)
        F[i][j] = Fc((static_cast<int64_t>(ke) * NZ + i) * NX + j);
    hp::load(bb, bc, static_cast<int64_t>(ke) * NX);
    T eu[NU], px[NX], Pb[NX];
    hp::folded_bwd_core<T, NU, NX>(M, ge, F, bb, Lxx_c, px_c, eu, px, Pb);
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j)
        Llo((static_cast<int64_t>(k) * NZ + i) * NU + j) =
            j <= i ? M[i][j] : T(0);
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j)
        Lxxo((static_cast<int64_t>(k) * NX + i) * NX + j) = Lxx_c[i][j];
    if (k < N) hp::store(Pbo, static_cast<int64_t>(k) * NX, Pb);
    hp::store(eus, static_cast<int64_t>(k) * NU, eu);
    hp::store(pxs, static_cast<int64_t>(k) * NX, px);
  }

  // ---- forward: x, u, z, s = 0..N -----------------------------------------
  T x[NX];
  {
    T px0[NX];
    hp::load(px0, pxs, 0);
    hp::root_x0<T, NX>(Lxx_c, px0, x);  // the carry holds stage 0's Lxx
  }
  for (int s = 0; s <= N; ++s) {
    T Ll[NZ][NU], eu[NU], Dinv_u[NU], u[NU], zt[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j)
        Ll[i][j] = Llo((static_cast<int64_t>(s) * NZ + i) * NU + j);
    hp::load(eu, eus, static_cast<int64_t>(s) * NU);
    hp::dinv_diag<T, NU>(Ll, Dinv_u);
    hp::u_of_x<T, NU, NX>(Ll, Dinv_u, eu, x, u);
#pragma unroll
    for (int i = 0; i < NU; ++i) zt[i] = u[i];
#pragma unroll
    for (int i = 0; i < NX; ++i) zt[NU + i] = x[i];
    hp::store(zo, static_cast<int64_t>(s) * NZ, zt);
    const int se = s < N - 1 ? s : N - 1;
    hp::x_next_of<T, NZ, NX>(Fc, static_cast<int64_t>(se) * NZ * NX, bc,
                             static_cast<int64_t>(se) * NX, zt, x);
  }
}

// Row 9's I/O policy (csrc/folded_team.cuh): packed H + diag(dvec) (+ the
// ng term), the split factor (Ll, Lxx), eu and px in the instance's
// instance-major scratch.
template <typename T, bool WANT_PI>
struct SplitIO {
  static constexpr bool WHOLE = false;
  static constexpr int EU_ROWS = NU;
  static constexpr bool STORE_PX = WANT_PI;
  static constexpr bool LL_ROWS = false;
  const T* H;
  T* Ll;
  T* Lxx;
  T* wk;
  int64_t B, N;
  __device__ __forceinline__ SplitIO(const FactorSolveFlatArgs& a, int64_t bi)
      : H(static_cast<const T*>(a.H) + bi),
        Ll(static_cast<T*>(a.Ll) + bi),
        Lxx(static_cast<T*>(a.Lxx) + bi),
        wk(static_cast<T*>(a.work) + bi * work_rows(a.N)),
        B(a.B),
        N(a.N) {}
  __device__ __forceinline__ const T& h(int k, int e) const {
    return H[(static_cast<int64_t>(k) * NT + e) * B];
  }
  __device__ __forceinline__ T& ll(int s, int i, int j) const {
    return Ll[((static_cast<int64_t>(s) * NZ + i) * NU + j) * B];
  }
  __device__ __forceinline__ T& lxx(int s, int i, int j) const {
    return Lxx[((static_cast<int64_t>(s) * NX + i) * NX + j) * B];
  }
  template <typename G>
  __device__ __forceinline__ void row(int k, int i, const G& get) const {
#pragma unroll
    for (int j = 0; j < NU; ++j)
      ll(k, i, j) = j <= i ? get(j < i ? j : i) : T(0);
    if (i >= NU) {
      const int xi = i - NU;
#pragma unroll
      for (int j = 0; j < NX; ++j)
        lxx(k, xi, j) = j <= xi ? get(NU + (j < xi ? j : xi)) : T(0);
    }
  }
  __device__ __forceinline__ T& eu(int s, int j) const {
    return wk[static_cast<int64_t>(s) * NU + j];
  }
  __device__ __forceinline__ T& px(int s, int i) const {
    return wk[(N + 1) * NU + static_cast<int64_t>(s) * NX + i];
  }
  __device__ __forceinline__ int64_t eu_stride() const { return 1; }
  __device__ __forceinline__ int64_t px_stride() const { return 1; }
};

// Row 9, the shared-memory form (folded_team.cuh smem_body).
template <typename T, bool WANT_PI, bool HAS_NG>
__global__ void __launch_bounds__(THREADS)
    factor_solve_flat_smem_kernel(FactorSolveFlatArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  smem_body<T, WANT_PI, HAS_NG, SplitIO<T, WANT_PI>>(a, smem_raw);
}

// Row 9, the register form (folded_team.cuh reg_body).
template <typename T, bool WANT_PI, bool HAS_NG>
__global__ void __launch_bounds__(THREADS)
    factor_solve_flat_kernel(FactorSolveFlatArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  reg_body<T, WANT_PI, HAS_NG, SplitIO<T, WANT_PI>>(a, smem_raw);
}

// eu/px in the block's dynamic shared memory, [stage][k][thread]; no pi
template <typename T, bool HAS_NG>
__global__ void __launch_bounds__(BLOCK)
    factor_solve_flat_fused_kernel(FactorSolveFlatArgs a) {
  extern __shared__ __align__(16) unsigned char slab_raw[];
  const int64_t bi = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (bi >= a.B) return;
  T* s = reinterpret_cast<T*>(slab_raw) + threadIdx.x;
  factor_solve_flat_sweeps<T, HAS_NG>(
      a, bi, hp::Col<T>{s, BLOCK},
      hp::Col<T>{s + (a.N + 1) * NU * BLOCK, BLOCK});
}

template <typename T, bool WANT_PI, bool HAS_NG>
static int launch(const FactorSolveFlatArgs& a, cudaStream_t stream) {
  if (a.work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (Row9<T>::REG)
    return start_team<T>(factor_solve_flat_kernel<T, WANT_PI, HAS_NG>, a,
                         stream);
  else
    return start_team<T>(factor_solve_flat_smem_kernel<T, WANT_PI, HAS_NG>,
                         a, stream);
}

template <typename T, bool HAS_NG>
static int launch_fused(const FactorSolveFlatArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + BLOCK - 1) / BLOCK;
  const int64_t smem = (a.N + 1) * NZ * BLOCK * static_cast<int64_t>(sizeof(T));
  const int rc = hp::allow_smem(factor_solve_flat_fused_kernel<T, HAS_NG>,
                                smem);
  if (rc != 0) return rc;
  factor_solve_flat_fused_kernel<T, HAS_NG>
      <<<static_cast<unsigned>(blocks), BLOCK, static_cast<size_t>(smem),
         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const FactorSolveFlatArgs& a, cudaStream_t stream) {
  const bool ng = a.n_ng > 0;
  if (a.want_pi)
    return ng ? launch<T, true, true>(a, stream)
              : launch<T, true, false>(a, stream);
  return ng ? launch<T, false, true>(a, stream)
            : launch<T, false, false>(a, stream);
}

template <typename T>
static int dispatch_fused(const FactorSolveFlatArgs& a, cudaStream_t stream) {
  return a.n_ng > 0 ? launch_fused<T, true>(a, stream)
                    : launch_fused<T, false>(a, stream);
}

static int check(const FactorSolveFlatArgs* a) {
  return a->B <= 0 || a->N <= 0 || a->n_ng < 0
             ? static_cast<int>(cudaErrorInvalidValue)
             : 0;
}

extern "C" int hp_factor_solve_folded_flat(const FactorSolveFlatArgs* a,
                                           int dtype_code,
                                           cudaStream_t stream) {
  if (const int rc = check(a)) return rc;
  if (dtype_code == 0) return dispatch<float>(*a, stream);
  if (dtype_code == 1) return dispatch<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int hp_factor_solve_folded_flat_fused(const FactorSolveFlatArgs* a,
                                                 int dtype_code,
                                                 cudaStream_t stream) {
  if (check(a) || a->want_pi) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return dispatch_fused<float>(*a, stream);
  if (dtype_code == 1) return dispatch_fused<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Row 9's launch layout at horizon N in dtype_code (folded_team.cuh
// team_layout; its scratch rows an instance: work_rows(N)).  The wrapper
// sizes `work` from it.
extern "C" void hp_factor_solve_flat_layout(int64_t N, int dtype_code,
                                            int64_t* out) {
  if (dtype_code == 1)
    team_layout<double>(work_rows(N), out);
  else
    team_layout<float>(work_rows(N), out);
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
