// Folded backward Riccati factorization + forward recovery of a batch of
// OCP KKT systems in ONE kernel, one CUDA thread per instance.
//
// Replaces: hpmpc_tpu/ops/stage_kernel.py::factor_solve_folded_flat, two
// TPU calls: the backward sweep (_bwd_kernel_folded, split factor) and the
// forward recovery (_forward_from_lanes -> _fwd_kernel_split).  Plain
// version: hpmpc_tpu_torch/ops/stage_kernel.py::factor_solve_folded_flat_ref.
//
// What bounds it on the H100: per instance and stage it reads the packed
// Hessian, dvec, g, F and b in the backward sweep and Ll, eu, px, F, b
// (and Lxx with pi) in the forward one, and writes the factor (Ll, Lxx,
// Pb), z and pi -- ~470 scalars at the flagship (N=30, NZ=11, NX=8,
// NU=3), ~1.9 KB in f32 -- against ~2.5k flops (W = F Lxx, W W', the
// 11x11 Cholesky, the solves): ~1.3 flop/byte, below the ~20 flop/byte f32
// balance point, so memory bound in principle; with one thread per
// instance (128 warps at B=4096) it is latency bound in practice.
//
// Design: csrc/factor_solve_mega.cu without the box prep and the alpha
// epilogue.  The TPU's two grids become two loops inside the thread:
// stages N..0 assemble H + diag(dvec) (+ the packed C' diag(Qx_g) C term
// on the stages of the ng table) in registers and factor it with the
// Riccati carry (Lxx, px) in registers; stages 0..N read back the factor
// and recover x, u and, with WANT_PI, pi_{s-1} = Lxx_s (Lxx_s' x_s) + px_s.
// The TPU's eu/px slabs are per-instance global scratch in batch-last
// layout (coalesced).  Terminal stage: F/b clip to N-1 under a zero
// carry, which collapses the stage to M = H, Pb = 0, m = g, as on the TPU;
// Pb has N rows (the terminal Pb is never stored).
//
// Specialisation: NU, NX compile-time (-D, one library per shape); WANT_PI
// and "has ng rows" template parameters; N and the ng table runtime.
#include "stage_math.cuh"

#if !defined(HP_NU) || !defined(HP_NX)
#error "compile with -DHP_NU=.. -DHP_NX=.."
#endif

namespace {

constexpr int NU = HP_NU;
constexpr int NX = HP_NX;
constexpr int NZ = NU + NX;
constexpr int NT = NZ * (NZ + 1) / 2;
constexpr int BLOCK = 32;

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
  void* work;            // ((N+1)(NU+NX), B): eu, px
  int64_t B;
  int64_t N;
  int64_t n_ng;
  int64_t want_pi;
};

template <typename T, bool WANT_PI, bool HAS_NG>
__global__ void __launch_bounds__(BLOCK)
    factor_solve_flat_kernel(FactorSolveFlatArgs a) {
  using hp::Col;
  const int64_t B = a.B;
  const int64_t bi = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (bi >= B) return;
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
  T* w = static_cast<T*>(a.work);
  const Col<T> eus{w + bi, B};
  const Col<T> pxs{w + static_cast<int64_t>(N + 1) * NU * B + bi, B};

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

  // ---- forward: x, u, z (and pi), s = 0..N --------------------------------
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
    if (WANT_PI && s >= 1) {
      T Lxx[NX][NX], pxv[NX], piv[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j)
          Lxx[i][j] = Lxxo((static_cast<int64_t>(s) * NX + i) * NX + j);
      hp::load(pxv, pxs, static_cast<int64_t>(s) * NX);
      hp::pi_of_x<T, NX>(Lxx, pxv, x, piv);
      hp::store(out(a.pi), static_cast<int64_t>(s - 1) * NX, piv);
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

template <typename T, bool WANT_PI, bool HAS_NG>
static int launch(const FactorSolveFlatArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + BLOCK - 1) / BLOCK;
  factor_solve_flat_kernel<T, WANT_PI, HAS_NG>
      <<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(a);
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

extern "C" int hp_factor_solve_folded_flat(const FactorSolveFlatArgs* a,
                                           int dtype_code,
                                           cudaStream_t stream) {
  if (a->B <= 0 || a->N <= 0 || a->n_ng < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return dispatch<float>(*a, stream);
  if (dtype_code == 1) return dispatch<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
