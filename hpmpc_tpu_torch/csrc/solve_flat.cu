// Retained-factor re-solve of a batch of OCP KKT systems in ONE kernel:
// backward substitution + forward recovery with pi.  Three forms:
//
//   * hp_solve_flat (solve_flat_kernel, Queue 2 row 10) reads the cached Pb
//     of the factorization.  Replaces: hpmpc_tpu/ops/stage_kernel.py::
//     solve_flat, two TPU calls: the backward substitution
//     (_bwd_trs_kernel_ll) and the forward recovery (_forward_from_lanes ->
//     _fwd_kernel_split).  Plain version: hpmpc_tpu_torch/ops/
//     stage_kernel.py::solve_flat_ref.
//   * hp_solve_flat_pb (solve_flat_pb_kernel, Queue 2 row 11) recomputes
//     Pb_k = Lxx_{k+1} (Lxx_{k+1}' b_k) from the retained factor for a new
//     right-hand side b (the reference's compute_Pb=1 path,
//     d_back_ric_rec.c:564; the unfused iterative refinement re-solves
//     against its residual rb) and reads no Pb stream.  Replaces:
//     hpmpc_tpu/ops/stage_kernel.py::solve_flat_pb (_bwd_trs_pb_kernel +
//     _forward_from_lanes).  Plain version: hpmpc_tpu_torch/ops/
//     stage_kernel.py::solve_flat_pb_ref.
//   * hp_solve_flat_fused (solve_flat_fused_kernel, Queue 2 row 17) is
//     row 10 in one thread an instance with the eu/px slab in shared
//     memory.  Replaces: hpmpc_tpu/ops/stage_kernel.py::solve_flat_fused
//     (_trs_fwd_fused_kernel, one two-phase-grid call that keeps eu and px
//     in VMEM slabs).  Plain version: solve_flat_ref (the same function).
//
// What bounds rows 10 and 11 on the H100: per instance and stage they read
// Ll, g, F, Pb (row 11: Lxx twice and b), b and Lxx, and write z and pi
// -- ~330 scalars at the flagship (N=30, NZ=11, NX=8, NU=3), ~1.3 KB in
// f32 -- against ~0.7k flops (triangular solves and matrix-vector
// products): ~0.5 flop/byte, memory bound in principle.  In practice the
// backward substitution and the forward recovery are chains of small
// dependent steps 31 stages deep: at one thread an instance (the first
// version of both rows, 128 warps at B=4096, one an SM) each warp waited
// alone on every load of its chain (row 10 at ~11% of its bound).
//
// Design of rows 10 and 11: a team of lanes an instance with the
// carry-free stage work off the serial chain, the design of
// csrc/refine_flat.cu (row 13), on the shared phases of csrc/team.cuh
// (hp::ReSolve): warp 0 runs the chain, the worker warps keep the
// carry-free rows of every stage (rq = g, the forward's b, Pb and the
// pivots' reciprocals) in device memory ahead of it and then run the
// epilogue (pi, the stores).  The two differ in Pb alone: row 10's
// workers copy the cached Pb_k stream (ReSolve's CACHED_PB mode; the chain
// adds Pb_0 + px_0 as the one-thread kernel added it), row 11's form it
// from Lxx_{k+1} and b_k (pb_keep; Pb_0 kept as its two factors, whose
// product the one-thread kernel fused into the sum).  Both give the
// one-thread kernels' outputs bit for bit.  Pb has N rows, read for k < N
// only; F/b clip to N-1 at the terminal stage.
//
// Design of the fused form (one thread an instance): csrc/solve_mega.cu's
// first form without the corrector prep and the alpha epilogue: stages
// N..0 run hp::trs_stage on the gradient with the Pb + px carry (px in
// registers) and put eu/px into the block's dynamic shared memory (the
// TPU's VMEM slabs), laid out [stage][k][thread] (a warp's accesses hit 32
// consecutive words: no bank conflict), (N+1)(NU+NX) x 32 scalars a block,
// set at launch from N; stages 0..N recover x from the root solve,
// pi_{s-1} = Lxx_s (Lxx_s' x_s) + px_s, u and z (solve_flat_sweeps).
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
constexpr int NZ = NU + NX;
constexpr int BLOCK = 32;
// the team geometry and phases of the cached-Pb form (row 10) and the Pb
// form (row 11): no general rows
using RC = hp::ReSolve<NU, NX, 0, false, true>;
using RS = hp::ReSolve<NU, NX, 0, false>;

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
  void* work;       // rows 10 and 11: the kept rows (hp_solve_flat_layout's
                    // / hp_solve_flat_pb_layout's size); the fused form:
                    // NULL
  int64_t B;
  int64_t N;
};

// The two sweeps of the fused form's instance bi; eus / pxs: its eu (N+1,
// NU) and px (N+1, NX) slab.
template <typename T>
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

// The cached-Pb form (row 10): hp::ReSolve::run_cached_pb on the split
// factor.
template <typename T>
__global__ void __launch_bounds__(RC::THREADS, sizeof(T) == 4 ? RC::MIN_BLOCKS_F32 : RC::MIN_BLOCKS_F64)
    solve_flat_kernel(SolveFlatArgs a, RC::Geo geo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RC::run_cached_pb<T>(geo, smem_raw, a.B, static_cast<int>(a.N), a.work,
                       a.Ll, a.Lxx, a.Pb, a.g, a.F, a.b, a.z, a.pi);
}

// The Pb form (row 11): the workers keep rq = g_k, the forward's
// right-hand side b_k, Pb_k and the pivots of each stage, warp 0 runs the
// chain, the workers the epilogue (z and pi out): hp::ReSolve::run.
template <typename T>
__global__ void __launch_bounds__(RS::THREADS, sizeof(T) == 4 ? RS::MIN_BLOCKS_F32 : RS::MIN_BLOCKS_F64)
    solve_flat_pb_kernel(SolveFlatArgs a, RS::Geo geo) {
  using hp::Col;
  using TM = RS::TM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const auto ln = RS::lane_of<T>(geo, a.B, a.work, smem_raw);
  const int N = static_cast<int>(a.N), r = ln.r;
  auto in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + ln.bl, a.B};
  };
  auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + ln.bl, a.B}; };
  const Col<const T> Llc = in(a.Ll), Lxxc = in(a.Lxx), gc = in(a.g),
                     Fc = in(a.F), bc = in(a.b);
  T* const sh = ln.pe;
  auto prologue = [&](int k) {
    const hp::Rows<T> st = ln.kp.at(static_cast<int64_t>(k) * RS::KS);
    ln.tsync();  // the team's last stage is done with the slab
    RS::du_keep(ln, k, Llc);
    T gb[RS::chunks(NZ)], bb[RS::chunks(NX)];
    TM::fetch<NZ>(r, gb, [&](int e) {
      return gc(static_cast<int64_t>(k) * NZ + e);
    });
    if (k < N)
      TM::fetch<NX>(r, bb, [&](int e) {
        return bc(static_cast<int64_t>(k) * NX + e);
      });
#pragma unroll
    for (int c = 0; c < RS::chunks(NZ); ++c) {
      const int i = r + c * RS::TEAM;
      if (i < NZ) st[RS::K_Q + i] = gb[c];
    }
    if (k < N) {
#pragma unroll
      for (int c = 0; c < RS::chunks(NX); ++c) {
        const int q = r + c * RS::TEAM;
        if (q < NX) {
          st[RS::K_RB + q] = bb[c];
          sh[RS::P_B + q] = bb[c];
        }
      }
      RS::pb_keep(ln, k, Lxxc);
    }
  };
  const Col<T> zo = out(a.z), pio = out(a.pi);
  RS::run(ln, RS::progress<T>(geo, smem_raw), N, prologue, Llc, Fc, Lxxc, gc,
          Col<const T>{pio.p, a.B}, zo, pio);
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
  solve_flat_sweeps<T>(
      a, bi, hp::Col<T>{s, BLOCK},
      hp::Col<T>{s + (a.N + 1) * NU * BLOCK, BLOCK});
}

template <typename T>
static int launch(const SolveFlatArgs& a, cudaStream_t stream) {
  if (a.work == nullptr || a.Pb == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return RC::start<T>(solve_flat_kernel<T>, a, a.B, a.N, stream);
}

template <typename T>
static int launch_pb(const SolveFlatArgs& a, cudaStream_t stream) {
  if (a.work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return RS::start<T>(solve_flat_pb_kernel<T>, a, a.B, a.N, stream);
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

extern "C" int hp_solve_flat(const SolveFlatArgs* a, int dtype_code,
                             cudaStream_t stream) {
  if (const int rc = check(a)) return rc;
  if (dtype_code == 0) return launch<float>(*a, stream);
  if (dtype_code == 1) return launch<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int hp_solve_flat_pb(const SolveFlatArgs* a, int dtype_code,
                                cudaStream_t stream) {
  if (const int rc = check(a)) return rc;
  if (dtype_code == 0) return launch_pb<float>(*a, stream);
  if (dtype_code == 1) return launch_pb<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch layouts of row 10 (RC) and row 11 (RS): hp::ReSolve::layout.
extern "C" void hp_solve_flat_layout(int64_t N, int dtype_code,
                                     int64_t* out) {
  RC::layout(N, dtype_code, out);
}

extern "C" void hp_solve_flat_pb_layout(int64_t N, int dtype_code,
                                        int64_t* out) {
  RS::layout(N, dtype_code, out);
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
