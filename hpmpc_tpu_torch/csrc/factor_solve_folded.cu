// Riccati factorization + forward recovery of a batch of OCP KKT systems
// with the FULL factor, in ONE kernel, one CUDA thread per instance.  Two
// forms, one body:
//
//   * folded (Queue 2 row 16): the effective Hessian H + diag(dvec) (+ the
//     packed C' diag(Qx_g) C term on the stages of the ng table) is
//     assembled in registers from the constant packed H;
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
// factor back and writes z and pi -- at the flagship (N=30, NZ=11, NX=8,
// NU=3) ~360 scalars per stage, the 121-scalar factor the largest stream
// (61 MB of the ~180 MB a call moves in f32 at B=4096), against ~2.5k
// flops: ~1.3 flop/byte, memory bound in principle; with one thread per
// instance (128 warps at B=4096) latency bound in practice.
//
// Design: csrc/factor_solve_flat.cu (row 9) with the I/O of the structured
// route.  The TPU's two grids become two loops inside the thread: stages
// N..0 assemble the stage Hessian and run hp::folded_bwd_core with the
// Riccati carry (Lxx, px) in registers, starting from a zero carry (which
// collapses the terminal stage exactly to M = H, Pb = 0, m = g, as the TPU
// kernels' select does); the factor goes out whole with its strictly upper
// part zero (the TPU's _chol + _store_mat), eu padded to NZ with zeros, px
// and Pb (N rows: the terminal Pb is never stored).  Stages 0..N read the
// factor back (Luu, Lxu and the Lxx block of L_s) and recover x from the
// root solve, pi_{s-1} = Lxx_s (Lxx_s' x_s) + px_s, u and z, stage N
// included.  The pivot clamp is the TPU kernels' rsqrt(max(a, 1e-20)) in
// both types (the plain Riccati's tri.cholesky clamps at 1e-30 in f64).
//
// Specialisation: NU, NX compile-time (-D, one library per shape); the form
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

// Mirrors _FoldedArgs in hpmpc_tpu_torch/ops/stage_kernel.py field for
// field.
struct FactorSolveFoldedArgs {
  const void* H;         // folded: (N+1, NT, B) packed; whole: (N+1, NZ, NZ, B)
  const void* dvec;      // (N+1, NZ, B) barrier diagonal (folded form only)
  const void* ngl;       // (n_ng, NT, B) packed C' diag(Qx_g) C (folded)
  const void* ng_stage;  // (n_ng,) int32 stage of each ng slot
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

template <typename T, bool WHOLE, bool HAS_NG>
__global__ void __launch_bounds__(BLOCK)
    factor_solve_folded_kernel(FactorSolveFoldedArgs a) {
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
  const Col<const T> Hc = in(a.H), gc = in(a.g), Fc = in(a.F), bc = in(a.b);
  const Col<T> Lo = out(a.L), euo = out(a.eu), pxo = out(a.px),
               Pbo = out(a.Pb), zo = out(a.z), pio = out(a.pi);

  // ---- backward: assemble + factor, k = N..0 ------------------------------
  T Lxx_c[NX][NX], px_c[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    px_c[i] = T(0);
#pragma unroll
    for (int j = 0; j < NX; ++j) Lxx_c[i][j] = T(0);
  }
  for (int k = N; k >= 0; --k) {
    T M[NZ][NZ], ge[NZ];
    if (WHOLE) {
#pragma unroll
      for (int i = 0; i < NZ; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j)
          M[i][j] = Hc((static_cast<int64_t>(k) * NZ + i) * NZ + j);
    } else {
      const Col<const T> dvc = in(a.dvec);
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
              M[i][j] = M[i][j] + nglc(static_cast<int64_t>(jg) * NT +
                                       hp::sym_idx(i, j));
        }
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
      for (int j = 0; j < NZ; ++j)
        Lo((static_cast<int64_t>(k) * NZ + i) * NZ + j) =
            j <= i ? M[i][j] : T(0);
    if (k < N) hp::store(Pbo, static_cast<int64_t>(k) * NX, Pb);
#pragma unroll
    for (int i = 0; i < NZ; ++i)
      euo(static_cast<int64_t>(k) * NZ + i) = i < NU ? eu[i] : T(0);
    hp::store(pxo, static_cast<int64_t>(k) * NX, px);
  }

  // ---- forward: x, pi, u, z, s = 0..N -------------------------------------
  T x[NX];
  {
    T px0[NX];
    hp::load(px0, pxo, 0);
    hp::root_x0<T, NX>(Lxx_c, px0, x);  // the carry holds stage 0's Lxx
  }
  for (int s = 0; s <= N; ++s) {
    const int64_t l0 = static_cast<int64_t>(s) * NZ * NZ;
    T Ll[NZ][NU], eu[NU], Dinv_u[NU], u[NU], zt[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j) Ll[i][j] = Lo(l0 + i * NZ + j);
#pragma unroll
    for (int i = 0; i < NU; ++i) eu[i] = euo(static_cast<int64_t>(s) * NZ + i);
    if (s >= 1) {
      T Lxx[NX][NX], pxv[NX], piv[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j)
          Lxx[i][j] = Lo(l0 + (NU + i) * NZ + NU + j);
      hp::load(pxv, pxo, static_cast<int64_t>(s) * NX);
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

template <typename T, bool WHOLE, bool HAS_NG>
static int launch(const FactorSolveFoldedArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + BLOCK - 1) / BLOCK;
  factor_solve_folded_kernel<T, WHOLE, HAS_NG>
      <<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
