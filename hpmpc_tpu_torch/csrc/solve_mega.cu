// One corrector IPM half-iteration of a batch of OCP QPs in ONE kernel:
// centering/corrector gradient + retained-factor backward substitution +
// forward recovery with pi + the corrector fraction-to-boundary / mu(alpha)
// partials, one CUDA thread per instance.
//
// Replaces: hpmpc_tpu/ops/mega_kernel.py::solve_mega (TPU body
// _trs_mega_kernel).  Plain version:
// hpmpc_tpu_torch/ops/mega_kernel.py::solve_mega_ref.
//
// What bounds it on the H100: per instance and stage it reads the box
// streams twice, the affine direction, Ll, Lxx, Pb, F twice and b, and
// writes z, pi, the box direction and 4 partials -- ~540 scalars at the
// flagship (N=30, NZ=11, NX=8, NB=7), ~2.2 KB in f32 -- against ~0.9k
// flops (triangular solves and matrix-vector products): ~0.4 flop/byte,
// memory bound in principle, latency bound with one thread per instance.
//
// Design: as csrc/factor_solve_mega.cu, two loops inside the thread.
// Backward, stages N..0: the corrector stream (co) goes to per-instance
// global scratch for the forward loop (the TPU's VMEM slab), the gradient
// is assembled in registers and fed straight to hp::trs_stage with the
// Pb + px carry.  Forward, stages 0..N: pi_{s-1} = Lxx_s (Lxx_s' x_s) +
// px_s (so pi has N rows and stage 0 writes none), u, z, x_next, then the
// corrector box direction: in phase 1 co enters as the dl0 correction, in
// phase 2 as the residual M (= rm2).
//
// Specialisation: NU, NX, NB are compile-time (-D, one library per shape);
// phase 2 and "has ng rows" are template parameters (all four forms are
// instantiated); N and the ng stage table are runtime.
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
constexpr int BLOCK = 32;

}  // namespace

// Mirrors _SolveArgs in hpmpc_tpu_torch/ops/mega_kernel.py field for field.
struct SolveMegaArgs {
  const void* idx;       // (N+1, NB) int32 box index table
  const void* lam;       // (N+1, 2NB, B)
  const void* t;         // (N+1, 2NB, B)
  const void* A;         // (N+1, 2NB, B) d_cat (phase 1) / rd (phase 2)
  const void* M;         // (N+1, 2NB, B) rm (phase 2 only)
  const void* mb;        // (N+1, 2NB, B)
  const void* dtb;       // (N+1, 2NB, B) affine slack direction
  const void* dlb;       // (N+1, 2NB, B) affine dual direction
  const void* sm;        // (B,) sigma * mu
  const void* base;      // (N+1, NZ, B) gradient base (g or rq)
  const void* ngadd;     // (n_ng, NZ, B) C' qx_g2
  const void* ng_stage;  // (n_ng,) int32 stage of each ng slot
  const void* Ll;        // (N+1, NZ, NU, B)
  const void* Lxx;       // (N+1, NX, NX, B), upper triangle 0
  const void* Pb;        // (N, NX, B)
  const void* F;         // (N, NZ, NX, B)
  const void* b;         // (N, NX, B)
  void* z;               // (N+1, NZ, B)
  void* pi;              // (N, NX, B)
  void* dt;              // (N+1, 2NB, B)
  void* dl;              // (N+1, 2NB, B)
  void* amin;            // (N+1, B)
  void* s0;              // (N+1, B)
  void* s1;              // (N+1, B)
  void* s2;              // (N+1, B)
  void* work;            // ((N+1)(NU+NX+2NB), B): eu, px, co
  int64_t B;
  int64_t N;
  int64_t n_ng;
  int64_t phase2;
};

template <typename T, bool PHASE2, bool HAS_NG>
__global__ void __launch_bounds__(BLOCK) solve_mega_kernel(SolveMegaArgs a) {
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
                     mbc = in(a.mb), dtbc = in(a.dtb), dlbc = in(a.dlb),
                     basec = in(a.base), Llc = in(a.Ll), Lxxc = in(a.Lxx),
                     Pbc = in(a.Pb), Fc = in(a.F), bc = in(a.b);
  const Col<T> zo = out(a.z), pio = out(a.pi), dto = out(a.dt),
               dlo = out(a.dl), amino = out(a.amin), s0o = out(a.s0),
               s1o = out(a.s1), s2o = out(a.s2);
  T* w = static_cast<T*>(a.work);
  const int64_t Np1 = N + 1;
  const Col<T> eus{w + bi, B};
  const Col<T> pxs{w + Np1 * NU * B + bi, B};
  const Col<T> cor{w + Np1 * (NU + NX) * B + bi, B};
  const T smv = in(a.sm)(0);

  auto ng_slot = [&](int n) {
    if (!HAS_NG) return -1;
    for (int j = 0; j < n_ng; ++j)
      if (ng_stage[j] == n) return j;
    return -1;
  };
  auto load_box = [&](int n, T (&lamk)[NB2], T (&tk)[NB2], T (&mbk)[NB2],
                      T (&Ak)[NB2]) {
    const int64_t r = static_cast<int64_t>(n) * NB2;
    hp::load(lamk, lamc, r);
    hp::load(tk, tc, r);
    hp::load(mbk, mbc, r);
    hp::load(Ak, Ac, r);
  };
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

  // ---- backward: corrector gradient + retained-factor solve, k = N..0 ----
  T px_c[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) px_c[i] = T(0);
  for (int k = N; k >= 0; --k) {
    T lamk[NB2], tk[NB2], mbk[NB2], Ak[NB2], dtk[NB2], dlk[NB2];
    load_box(k, lamk, tk, mbk, Ak);
    const int64_t r = static_cast<int64_t>(k) * NB2;
    hp::load(dtk, dtbc, r);
    hp::load(dlk, dlbc, r);
    T cok[NB2], qx[NB];
    if (PHASE2) {
      T Mk[NB2];
      hp::load(Mk, in(a.M), r);
      hp::corr_co_qx_res<T, NB>(lamk, tk, mbk, Ak, Mk, dtk, dlk, smv, cok,
                                qx);
    } else {
      hp::corr_co_qx<T, NB>(lamk, tk, mbk, Ak, dtk, dlk, smv, cok, qx);
    }
    hp::store(cor, r, cok);
    T ge[NZ];
    hp::load(ge, basec, static_cast<int64_t>(k) * NZ);
    hp::scatter_add_box<T, NB, NZ>(ge, idx + k * NB, qx);
    const int jg = ng_slot(k);
    if (HAS_NG && jg >= 0) {
      const Col<const T> ngaddc = in(a.ngadd);
#pragma unroll
      for (int i = 0; i < NZ; ++i)
        ge[i] = ge[i] + ngaddc(static_cast<int64_t>(jg) * NZ + i);
    }
    T Ll[NZ][NU], Dinv_u[NU], Pbpx[NX], eu[NU], px[NX];
    load_ll(k, Ll);
    hp::dinv_diag<T, NU>(Ll, Dinv_u);
    const int ke = k < N - 1 ? k : N - 1;
#pragma unroll
    for (int i = 0; i < NX; ++i)
      Pbpx[i] = k == N ? T(0)
                       : Pbc(static_cast<int64_t>(ke) * NX + i) + px_c[i];
    hp::trs_stage<T, NU, NX>(Ll, Dinv_u, ge, Fc,
                             static_cast<int64_t>(ke) * NZ * NX, Pbpx, k == N,
                             eu, px);
#pragma unroll
    for (int i = 0; i < NX; ++i) px_c[i] = px[i];
    hp::store(eus, static_cast<int64_t>(k) * NU, eu);
    hp::store(pxs, static_cast<int64_t>(k) * NX, px);
  }

  // ---- forward: pi, z, corrector box direction, partials, s = 0..N -------
  T x[NX];
  {
    T Lxx[NX][NX], px0[NX];
    load_lxx(0, Lxx);
    hp::load(px0, pxs, 0);
    hp::root_x0<T, NX>(Lxx, px0, x);
  }
  for (int s = 0; s <= N; ++s) {
    T Ll[NZ][NU], eu[NU], pxv[NX], Dinv_u[NU], u[NU], zt[NZ];
    load_ll(s, Ll);
    hp::load(eu, eus, static_cast<int64_t>(s) * NU);
    hp::load(pxv, pxs, static_cast<int64_t>(s) * NX);
    if (s >= 1) {
      T Lxx[NX][NX], piv[NX];
      load_lxx(s, Lxx);
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

    T zb[NB], lamk[NB2], tk[NB2], mbk[NB2], Ak[NB2], cok[NB2];
    T dtb[NB2], dlb[NB2];
    hp::gather_box<T, NB, NZ>(zt, idx + s * NB, zb);
    load_box(s, lamk, tk, mbk, Ak);
    hp::load(cok, cor, static_cast<int64_t>(s) * NB2);
    if (PHASE2)
      hp::dt_dlam_res<T, NB>(lamk, tk, mbk, Ak, cok, zb, dtb, dlb);
    else
      hp::dt_dlam<T, NB>(lamk, tk, mbk, Ak, zb, cok, dtb, dlb);
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
static int launch(const SolveMegaArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + BLOCK - 1) / BLOCK;
  solve_mega_kernel<T, PHASE2, HAS_NG>
      <<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const SolveMegaArgs& a, cudaStream_t stream) {
  const bool ng = a.n_ng > 0;
  if (a.phase2)
    return ng ? launch<T, true, true>(a, stream)
              : launch<T, true, false>(a, stream);
  return ng ? launch<T, false, true>(a, stream)
            : launch<T, false, false>(a, stream);
}

extern "C" int hp_solve_mega(const SolveMegaArgs* a, int dtype_code,
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
