// Retained-factor re-solve of a batch of OCP KKT systems in ONE kernel:
// backward substitution + forward recovery with pi, one CUDA thread per
// instance.  Three forms:
//
//   * hp_solve_flat reads the cached Pb of the factorization.  Replaces:
//     hpmpc_tpu/ops/stage_kernel.py::solve_flat, two TPU calls: the
//     backward substitution (_bwd_trs_kernel_ll) and the forward recovery
//     (_forward_from_lanes -> _fwd_kernel_split).  Plain version:
//     hpmpc_tpu_torch/ops/stage_kernel.py::solve_flat_ref.
//   * hp_solve_flat_pb recomputes Pb_k = Lxx_{k+1} (Lxx_{k+1}' b_k) from
//     the retained factor for a new right-hand side b (the reference's
//     compute_Pb=1 path, d_back_ric_rec.c:564; the unfused iterative
//     refinement re-solves against its residual rb) and reads no Pb
//     stream.  Replaces: hpmpc_tpu/ops/stage_kernel.py::solve_flat_pb
//     (_bwd_trs_pb_kernel + _forward_from_lanes).  Plain version:
//     hpmpc_tpu_torch/ops/stage_kernel.py::solve_flat_pb_ref.
//   * hp_solve_flat_fused (solve_flat_fused_kernel) is hp_solve_flat with
//     the eu/px slab in shared memory instead of global scratch.
//     Replaces: hpmpc_tpu/ops/stage_kernel.py::solve_flat_fused
//     (_trs_fwd_fused_kernel, one two-phase-grid call that keeps eu and px
//     in VMEM slabs).  Plain version: solve_flat_ref (the same function).
//
// What bounds it on the H100: per instance and stage it reads Ll twice, g,
// F twice, Pb, b and Lxx, and writes z and pi -- ~330 scalars at the
// flagship (N=30, NZ=11, NX=8, NU=3), ~1.3 KB in f32 -- against ~0.7k
// flops (triangular solves and matrix-vector products): ~0.5 flop/byte,
// memory bound in principle, latency bound with one thread per instance
// (128 warps at B=4096).  The Pb form reads Lxx_{k+1} instead of Pb in
// the backward loop (the lower triangle, 36 scalars a stage instead of 8)
// and adds ~2 NX^2 flops a stage.  The global-scratch forms also write
// and read back the eu/px slab, (N+1)(NU+NX) scalars an instance; the
// fused form keeps it on the SM.
//
// Design: csrc/solve_mega.cu without the corrector prep and the alpha
// epilogue: stages N..0 run hp::trs_stage on the gradient with the Pb + px
// carry (px in registers) and put eu/px into the slab (the TPU's VMEM
// slabs); stages 0..N recover x from the root solve, pi_{s-1} = Lxx_s
// (Lxx_s' x_s) + px_s, u and z.  Pb has N rows and is read for k < N only;
// F/b clip to N-1 at the terminal stage.  The Pb form loads Lxx_{k+1} from
// the retained factor at stage k (the TPU kernel carries it in VMEM from
// the step before; here registers are the scarce resource), as
// csrc/refine_flat.cu does.  The slab is laid out [stage][k][instance]:
// per-instance global scratch in batch-last layout (coalesced), or the
// block's dynamic shared memory with the thread index last (a warp's
// accesses hit 32 consecutive words: no bank conflict), (N+1)(NU+NX) x 32
// scalars a block, set at launch from N; the three forms run the same
// sweep code (solve_flat_sweeps), so the fused form rounds as
// hp_solve_flat does.
//
// Specialisation: NU, NX compile-time (-D, one library per shape); N
// runtime.
#include "stage_math.cuh"

#if !defined(HP_NU) || !defined(HP_NX)
#error "compile with -DHP_NU=.. -DHP_NX=.."
#endif

namespace {

constexpr int NU = HP_NU;
constexpr int NX = HP_NX;
constexpr int NZ = NU + NX;
constexpr int BLOCK = 32;

}  // namespace

// Mirrors _SolveArgs in hpmpc_tpu_torch/ops/stage_kernel.py field for
// field.
struct SolveFlatArgs {
  const void* Ll;   // (N+1, NZ, NU, B)
  const void* Lxx;  // (N+1, NX, NX, B), upper triangle 0
  const void* Pb;   // (N, NX, B); NULL in the Pb form
  const void* g;    // (N+1, NZ, B)
  const void* F;    // (N, NZ, NX, B)
  const void* b;    // (N, NX, B)
  void* z;          // (N+1, NZ, B)
  void* pi;         // (N, NX, B)
  void* work;       // ((N+1)(NU+NX), B): eu, px; NULL in the fused form
  int64_t B;
  int64_t N;
};

// The two sweeps of instance bi; eus / pxs: its eu (N+1, NU) and px
// (N+1, NX) slab.
template <typename T, bool PB_FROM_LXX>
__device__ __forceinline__ void solve_flat_sweeps(const SolveFlatArgs& a,
                                                  int64_t bi,
                                                  const hp::Col<T>& eus,
                                                  const hp::Col<T>& pxs) {
  using hp::Col;
  const int64_t B = a.B;
  const int N = static_cast<int>(a.N);
  auto in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + bi, B};
  };
  auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + bi, B}; };
  const Col<const T> Llc = in(a.Ll), Lxxc = in(a.Lxx), Pbc = in(a.Pb),
                     gc = in(a.g), Fc = in(a.F), bc = in(a.b);
  const Col<T> zo = out(a.z), pio = out(a.pi);

  auto load_ll = [&](int n, T (&Ll)[NZ][NU]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j)
        Ll[i][j] = Llc((static_cast<int64_t>(n) * NZ + i) * NU + j);
  };
  auto load_lxx = [&](int n, T (&Lxx)[NX][NX]) {
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j)
        Lxx[i][j] = j <= i ? Lxxc((static_cast<int64_t>(n) * NX + i) * NX + j)
                           : T(0);
  };

  // ---- backward: retained-factor substitution, k = N..0 -----------------
  T px_c[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) px_c[i] = T(0);
  for (int k = N; k >= 0; --k) {
    T ge[NZ], Ll[NZ][NU], Dinv_u[NU], Pbpx[NX], eu[NU], px[NX];
    hp::load(ge, gc, static_cast<int64_t>(k) * NZ);
    load_ll(k, Ll);
    hp::dinv_diag<T, NU>(Ll, Dinv_u);
    const int ke = k < N - 1 ? k : N - 1;
    if (k == N) {
#pragma unroll
      for (int i = 0; i < NX; ++i) Pbpx[i] = T(0);
    } else if (PB_FROM_LXX) {
      T Lxx[NX][NX], bb[NX], Pb[NX];
      load_lxx(k + 1, Lxx);
      hp::load(bb, bc, static_cast<int64_t>(k) * NX);
      hp::pb_of<T, NX>(Lxx, bb, Pb);
#pragma unroll
      for (int i = 0; i < NX; ++i) Pbpx[i] = Pb[i] + px_c[i];
    } else {
#pragma unroll
      for (int i = 0; i < NX; ++i)
        Pbpx[i] = Pbc(static_cast<int64_t>(k) * NX + i) + px_c[i];
    }
    hp::trs_stage<T, NU, NX>(Ll, Dinv_u, ge, Fc,
                             static_cast<int64_t>(ke) * NZ * NX, Pbpx, k == N,
                             eu, px);
#pragma unroll
    for (int i = 0; i < NX; ++i) px_c[i] = px[i];
    hp::store(eus, static_cast<int64_t>(k) * NU, eu);
    hp::store(pxs, static_cast<int64_t>(k) * NX, px);
  }

  // ---- forward: x, pi, u, z, s = 0..N -------------------------------------
  T x[NX];
  {
    T Lxx[NX][NX], px0[NX];
    load_lxx(0, Lxx);
    hp::load(px0, pxs, 0);
    hp::root_x0<T, NX>(Lxx, px0, x);
  }
  for (int s = 0; s <= N; ++s) {
    T Ll[NZ][NU], eu[NU], Dinv_u[NU], u[NU], zt[NZ];
    load_ll(s, Ll);
    hp::load(eu, eus, static_cast<int64_t>(s) * NU);
    if (s >= 1) {
      T Lxx[NX][NX], pxv[NX], piv[NX];
      load_lxx(s, Lxx);
      hp::load(pxv, pxs, static_cast<int64_t>(s) * NX);
      hp::pi_of_x<T, NX>(Lxx, pxv, x, piv);
      hp::store(pio, static_cast<int64_t>(s - 1) * NX, piv);
    }
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

// eu/px in the per-instance global scratch a.work (batch-last)
template <typename T, bool PB_FROM_LXX>
__global__ void __launch_bounds__(BLOCK) solve_flat_kernel(SolveFlatArgs a) {
  const int64_t B = a.B;
  const int64_t bi = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (bi >= B) return;
  T* w = static_cast<T*>(a.work);
  solve_flat_sweeps<T, PB_FROM_LXX>(
      a, bi, hp::Col<T>{w + bi, B},
      hp::Col<T>{w + (a.N + 1) * NU * B + bi, B});
}

// eu/px in the block's dynamic shared memory, [stage][k][thread]
template <typename T>
__global__ void __launch_bounds__(BLOCK)
    solve_flat_fused_kernel(SolveFlatArgs a) {
  extern __shared__ __align__(16) unsigned char slab_raw[];
  const int64_t bi = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (bi >= a.B) return;
  T* s = reinterpret_cast<T*>(slab_raw) + threadIdx.x;
  solve_flat_sweeps<T, false>(
      a, bi, hp::Col<T>{s, BLOCK},
      hp::Col<T>{s + (a.N + 1) * NU * BLOCK, BLOCK});
}

template <typename T, bool PB_FROM_LXX>
static int launch(const SolveFlatArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + BLOCK - 1) / BLOCK;
  solve_flat_kernel<T, PB_FROM_LXX>
      <<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_fused(const SolveFlatArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + BLOCK - 1) / BLOCK;
  const int64_t smem = (a.N + 1) * NZ * BLOCK * static_cast<int64_t>(sizeof(T));
  const int rc = hp::allow_smem(solve_flat_fused_kernel<T>, smem);
  if (rc != 0) return rc;
  solve_flat_fused_kernel<T><<<static_cast<unsigned>(blocks), BLOCK,
                               static_cast<size_t>(smem), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

static int check(const SolveFlatArgs* a) {
  return a->B <= 0 || a->N <= 0 ? static_cast<int>(cudaErrorInvalidValue)
                                : 0;
}

template <bool PB_FROM_LXX>
static int dispatch(const SolveFlatArgs* a, int dtype_code,
                    cudaStream_t stream) {
  if (const int rc = check(a)) return rc;
  if (dtype_code == 0) return launch<float, PB_FROM_LXX>(*a, stream);
  if (dtype_code == 1) return launch<double, PB_FROM_LXX>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int hp_solve_flat(const SolveFlatArgs* a, int dtype_code,
                             cudaStream_t stream) {
  return dispatch<false>(a, dtype_code, stream);
}

extern "C" int hp_solve_flat_pb(const SolveFlatArgs* a, int dtype_code,
                                cudaStream_t stream) {
  return dispatch<true>(a, dtype_code, stream);
}

extern "C" int hp_solve_flat_fused(const SolveFlatArgs* a, int dtype_code,
                                   cudaStream_t stream) {
  if (const int rc = check(a)) return rc;
  if (dtype_code == 0) return launch_fused<float>(*a, stream);
  if (dtype_code == 1) return launch_fused<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
