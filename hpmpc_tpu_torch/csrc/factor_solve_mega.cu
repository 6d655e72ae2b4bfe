// One affine IPM half-iteration of a batch of OCP QPs in ONE kernel: barrier
// prep + folded backward Riccati factorization + pi-less forward recovery
// + the affine fraction-to-boundary / mu(alpha) partials, one CUDA thread
// per instance.
//
// Replaces: hpmpc_tpu/ops/mega_kernel.py::factor_solve_mega (TPU body
// _sv_mega_kernel).  Plain version:
// hpmpc_tpu_torch/ops/mega_kernel.py::factor_solve_mega_ref.
//
// What bounds it on the H100: per instance and stage it reads the box
// streams twice (backward and forward), H, F and b twice, and writes the
// factor (Ll, Lxx, Pb), z, the box direction and 4 partials -- ~560
// scalars at the flagship (N=30, NZ=11, NX=8, NB=7), ~2.2 KB in f32 --
// against ~2.7k flops (W = F Lxx, W W', the 11x11 Cholesky, the solves):
// ~1.2 flop/byte, below the ~20 flop/byte f32 balance point, so memory
// bound in principle; with one thread per instance (128 warps at B=4096)
// it is latency bound in practice.
//
// Design: the TPU grid (block, 2(N+1) stage steps) becomes two loops inside
// the thread: stages N..0 (prep of stage k feeds its factorization in
// registers, so the effective Hessian and gradient never reach memory),
// then stages 0..N (the forward recovery reads back the factor it wrote and
// finishes each stage's alpha/mu partials on the z it just computed).  The
// TPU's VMEM slabs (eu, px) become per-instance global scratch in batch-
// last (rows, B) layout, so a warp's loads are coalesced; the Riccati
// carries (Lxx, px, x) live in registers.  Terminal stage: the F/b block
// index clips to N-1 and a zero carry collapses the stage to M = H, Pb = 0,
// m = g, as on the TPU.  Pb has N rows: the terminal Pb is never stored.
//
// Specialisation: NU, NX, NB are compile-time (-D, one library per shape);
// phase 2 and "has ng rows" are template parameters (all four forms are
// instantiated); N and the ng stage table (n_ng entries) are runtime.
#include "stage_math.cuh"

#if !defined(HP_NU) || !defined(HP_NX) || !defined(HP_NB)
#error "compile with -DHP_NU=.. -DHP_NX=.. -DHP_NB=.."
#endif

namespace {

constexpr int NU = HP_NU;
constexpr int NX = HP_NX;
constexpr int NZ = NU + NX;
constexpr int NB = HP_NB;
constexpr int NB2 = 2 * NB;
constexpr int NT = NZ * (NZ + 1) / 2;
constexpr int BLOCK = 32;

}  // namespace

// Mirrors _FactorArgs in hpmpc_tpu_torch/ops/mega_kernel.py field for field.
struct FactorSolveMegaArgs {
  const void* idx;       // (N+1, NB) int32 box index table
  const void* lam;       // (N+1, 2NB, B)
  const void* t;         // (N+1, 2NB, B)
  const void* A;         // (N+1, 2NB, B) d_cat (phase 1) / rd (phase 2)
  const void* M;         // (N+1, 2NB, B) rm (phase 2 only)
  const void* mb;        // (N+1, 2NB, B)
  const void* base;      // (N+1, NZ, B) gradient base (g or rq)
  const void* pdreg;     // (N+1, NZ, B) pad_diag + reg_eps
  const void* H;         // (N+1, NT, B) packed lower triangle
  const void* ngl;       // (n_ng, NT, B) packed C' diag(Qx_g) C
  const void* ngadd;     // (n_ng, NZ, B) C' qx_g
  const void* ng_stage;  // (n_ng,) int32 stage of each ng slot
  const void* F;         // (N, NZ, NX, B)
  const void* b;         // (N, NX, B)
  void* Ll;              // (N+1, NZ, NU, B)
  void* Lxx;             // (N+1, NX, NX, B), upper triangle 0
  void* Pb;              // (N, NX, B)
  void* z;               // (N+1, NZ, B)
  void* dt;              // (N+1, 2NB, B)
  void* dl;              // (N+1, 2NB, B)
  void* amin;            // (N+1, B)
  void* s0;              // (N+1, B)
  void* s1;              // (N+1, B)
  void* s2;              // (N+1, B)
  void* work;            // ((N+1)(NU+NX), B): eu, px
  int64_t B;
  int64_t N;
  int64_t n_ng;
  int64_t phase2;
};

template <typename T, bool PHASE2, bool HAS_NG>
__global__ void __launch_bounds__(BLOCK)
    factor_solve_mega_kernel(FactorSolveMegaArgs a) {
  using hp::Col;
  const int64_t B = a.B;
  const int64_t bi = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (bi >= B) return;
  const int N = static_cast<int>(a.N);
  const int n_ng = static_cast<int>(a.n_ng);
  const int* idx = static_cast<const int*>(a.idx);
  const int* ng_stage = static_cast<const int*>(a.ng_stage);

  auto in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + bi, B};
  };
  auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + bi, B}; };
  const Col<const T> lamc = in(a.lam), tc = in(a.t), Ac = in(a.A),
                     mbc = in(a.mb), basec = in(a.base), pdregc = in(a.pdreg),
                     Hc = in(a.H), Fc = in(a.F), bc = in(a.b);
  const Col<T> Llo = out(a.Ll), Lxxo = out(a.Lxx), Pbo = out(a.Pb),
               zo = out(a.z), dto = out(a.dt), dlo = out(a.dl),
               amino = out(a.amin), s0o = out(a.s0), s1o = out(a.s1),
               s2o = out(a.s2);
  T* w = static_cast<T*>(a.work);
  const Col<T> eus{w + bi, B};
  const Col<T> pxs{w + static_cast<int64_t>(N + 1) * NU * B + bi, B};

  auto ng_slot = [&](int n) {
    if (!HAS_NG) return -1;
    for (int j = 0; j < n_ng; ++j)
      if (ng_stage[j] == n) return j;
    return -1;
  };
  auto load_box = [&](int n, T (&lamk)[NB2], T (&tk)[NB2], T (&mbk)[NB2],
                      T (&Ak)[NB2], T (&Mk)[NB2]) {
    const int64_t r = static_cast<int64_t>(n) * NB2;
    hp::load(lamk, lamc, r);
    hp::load(tk, tc, r);
    hp::load(mbk, mbc, r);
    hp::load(Ak, Ac, r);
    if (PHASE2) hp::load(Mk, in(a.M), r);
  };

  // ---- backward: prep(stage k) + folded factorization, k = N..0 ----------
  T Lxx_c[NX][NX], px_c[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    px_c[i] = T(0);
#pragma unroll
    for (int j = 0; j < NX; ++j) Lxx_c[i][j] = T(0);
  }
  for (int k = N; k >= 0; --k) {
    T lamk[NB2], tk[NB2], mbk[NB2], Ak[NB2], Mk[NB2];
    load_box(k, lamk, tk, mbk, Ak, Mk);
    const int* ik = idx + k * NB;
    T Qx[NB], qx[NB];
    if (PHASE2)
      hp::qx_fold_res<T, NB>(lamk, tk, mbk, Ak, Mk, Qx, qx);
    else
      hp::qx_fold<T, NB>(lamk, tk, mbk, Ak, Qx, qx);
    T ge[NZ];
    hp::load(ge, pdregc, static_cast<int64_t>(k) * NZ);
    hp::scatter_add_box<T, NB, NZ>(ge, ik, Qx);
    T M[NZ][NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j)
        M[i][j] = Hc(static_cast<int64_t>(k) * NT + hp::sym_idx(i, j));
#pragma unroll
    for (int i = 0; i < NZ; ++i) M[i][i] = M[i][i] + ge[i];
    hp::load(ge, basec, static_cast<int64_t>(k) * NZ);
    hp::scatter_add_box<T, NB, NZ>(ge, ik, qx);
    const int jg = ng_slot(k);
    if (HAS_NG && jg >= 0) {
      // general-constraint rows of this stage: gradient, then Hessian
      const Col<const T> nglc = in(a.ngl), ngaddc = in(a.ngadd);
#pragma unroll
      for (int i = 0; i < NZ; ++i)
        ge[i] = ge[i] + ngaddc(static_cast<int64_t>(jg) * NZ + i);
#pragma unroll
      for (int i = 0; i < NZ; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j)
          M[i][j] = M[i][j] +
                    nglc(static_cast<int64_t>(jg) * NT + hp::sym_idx(i, j));
    }
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

  // ---- forward: z, affine box direction, alpha/mu partials, s = 0..N -----
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

    T zb[NB], lamk[NB2], tk[NB2], mbk[NB2], Ak[NB2], Mk[NB2];
    T dtb[NB2], dlb[NB2];
    hp::gather_box<T, NB, NZ>(zt, idx + s * NB, zb);
    load_box(s, lamk, tk, mbk, Ak, Mk);
    if (PHASE2) {
      hp::dt_dlam_res<T, NB>(lamk, tk, mbk, Ak, Mk, zb, dtb, dlb);
    } else {
      T zero[NB2];
#pragma unroll
      for (int i = 0; i < NB2; ++i) zero[i] = T(0);
      hp::dt_dlam<T, NB>(lamk, tk, mbk, Ak, zb, zero, dtb, dlb);
    }
    hp::store(dto, static_cast<int64_t>(s) * NB2, dtb);
    hp::store(dlo, static_cast<int64_t>(s) * NB2, dlb);
    T am = T(INFINITY), e0 = T(0), e1 = T(0), e2 = T(0);
    hp::alpha_sums<T, NB2>(lamk, tk, mbk, dtb, dlb, am, e0, e1, e2);
    amino(s) = am;
    s0o(s) = e0;
    s1o(s) = e1;
    s2o(s) = e2;
  }
}

template <typename T, bool PHASE2, bool HAS_NG>
static int launch(const FactorSolveMegaArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + BLOCK - 1) / BLOCK;
  factor_solve_mega_kernel<T, PHASE2, HAS_NG>
      <<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const FactorSolveMegaArgs& a, cudaStream_t stream) {
  const bool ng = a.n_ng > 0;
  if (a.phase2)
    return ng ? launch<T, true, true>(a, stream)
              : launch<T, true, false>(a, stream);
  return ng ? launch<T, false, true>(a, stream)
            : launch<T, false, false>(a, stream);
}

extern "C" int hp_factor_solve_mega(const FactorSolveMegaArgs* a,
                                    int dtype_code, cudaStream_t stream) {
  if (a->B <= 0 || a->N <= 0 || a->n_ng < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return dispatch<float>(*a, stream);
  if (dtype_code == 1) return dispatch<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
