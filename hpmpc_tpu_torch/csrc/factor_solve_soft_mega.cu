// One affine half-iteration of the batched SOFT IPM in ONE kernel: the
// soft barrier prep (box fold + 4-slack-family Schur elimination) +
// folded backward Riccati factorization + pi-less forward recovery + the
// affine box+soft fraction-to-boundary / mu(alpha) partials, one CUDA
// thread per instance.
//
// Replaces: hpmpc_tpu/ops/mega_kernel.py::factor_solve_soft_mega (TPU body
// _soft_sv_mega_kernel).  Plain version:
// hpmpc_tpu_torch/ops/mega_kernel.py::factor_solve_soft_mega_ref.
//
// What bounds it on the H100: csrc/factor_solve_mega.cu's traffic plus the
// soft streams, read twice (backward prep, forward alpha pass): lam_s,
// t_s (4NS each), the constants (6NS) and the mask (NS), and the soft
// direction written (2 x 4NS) -- at the soft flagship (N=30, NZ=11, NX=8,
// NB=3, NS=8) ~700 scalars per instance and stage, ~2.8 KB in f32, against
// ~3k flops: ~1 flop/byte, memory bound in principle, latency bound with
// one thread per instance (128 warps at B=4096).
//
// Design: csrc/factor_solve_mega.cu's two loops inside the thread (stages
// N..0: prep of stage k feeds its factorization in registers; stages
// 0..N: forward recovery + alpha pass on the z just computed), phase 1
// only (the soft IPM is single-loop, delta formulation).  The Schur
// quantities are recomputed in the forward loop from the streams rather
// than kept in scratch, as the TPU kernel does.  The factor state (Ll,
// Lxx, Pb) has the hard kernels' layout, so csrc/solve_soft_mega.cu and
// csrc/solve_flat.cu take it.  The soft index table holds padded-z
// coordinates; padded slots point at 0 under a zero mask and the scatters
// add, so a soft row on a box coordinate adds to its fold.
//
// Specialisation: NU, NX, NB, NS are compile-time (-D, one library per
// shape); "has ng rows" is a template parameter; N and the ng stage table
// are runtime.
#include "stage_math.cuh"

#if !defined(HP_NU) || !defined(HP_NX) || !defined(HP_NB) || !defined(HP_NS)
#error "compile with -DHP_NU=.. -DHP_NX=.. -DHP_NB=.. -DHP_NS=.."
#endif

namespace {

constexpr int NU = HP_NU;
constexpr int NX = HP_NX;
constexpr int NZ = NU + NX;
constexpr int NB = HP_NB;
constexpr int NB2 = 2 * NB;
constexpr int NS = HP_NS;
constexpr int NS4 = 4 * NS;
constexpr int NS6 = 6 * NS;
constexpr int NT = NZ * (NZ + 1) / 2;
constexpr int BLOCK = 32;

}  // namespace

// Mirrors _SoftFactorArgs in hpmpc_tpu_torch/ops/mega_kernel.py field for
// field.
struct FactorSolveSoftMegaArgs {
  const void* idxb;      // (N+1, NB) int32 box index table
  const void* idxs;      // (N+1, NS) int32 soft index table (padded z)
  const void* lam;       // (N+1, 2NB, B)
  const void* t;         // (N+1, 2NB, B)
  const void* A;         // (N+1, 2NB, B) d_cat
  const void* mb;        // (N+1, 2NB, B)
  const void* lam_s;     // (N+1, 4NS, B)
  const void* t_s;       // (N+1, 4NS, B)
  const void* soft_c;    // (N+1, 6NS, B)
  const void* ms;        // (N+1, NS, B)
  const void* base;      // (N+1, NZ, B) gradient base g
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
  void* dtb;             // (N+1, 2NB, B)
  void* dlb;             // (N+1, 2NB, B)
  void* dts;             // (N+1, 4NS, B)
  void* dls;             // (N+1, 4NS, B)
  void* amin;            // (N+1, B)
  void* s0;              // (N+1, B)
  void* s1;              // (N+1, B)
  void* s2;              // (N+1, B)
  void* work;            // ((N+1)(NU+NX), B): eu, px
  int64_t B;
  int64_t N;
  int64_t n_ng;
};

template <typename T, bool HAS_NG>
__global__ void __launch_bounds__(BLOCK)
    factor_solve_soft_mega_kernel(FactorSolveSoftMegaArgs a) {
  using hp::Col;
  const int64_t B = a.B;
  const int64_t bi = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (bi >= B) return;
  const int N = static_cast<int>(a.N);
  const int n_ng = static_cast<int>(a.n_ng);
  const int* idxb = static_cast<const int*>(a.idxb);
  const int* idxs = static_cast<const int*>(a.idxs);
  const int* ng_stage = static_cast<const int*>(a.ng_stage);

  auto in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + bi, B};
  };
  auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + bi, B}; };
  const Col<const T> lamc = in(a.lam), tc = in(a.t), Ac = in(a.A),
                     mbc = in(a.mb), lsc = in(a.lam_s), tsc = in(a.t_s),
                     scc = in(a.soft_c), msc = in(a.ms), basec = in(a.base),
                     pdregc = in(a.pdreg), Hc = in(a.H), Fc = in(a.F),
                     bc = in(a.b);
  const Col<T> Llo = out(a.Ll), Lxxo = out(a.Lxx), Pbo = out(a.Pb),
               zo = out(a.z), dtbo = out(a.dtb), dlbo = out(a.dlb),
               dtso = out(a.dts), dlso = out(a.dls), amino = out(a.amin),
               s0o = out(a.s0), s1o = out(a.s1), s2o = out(a.s2);
  T* w = static_cast<T*>(a.work);
  const Col<T> eus{w + bi, B};
  const Col<T> pxs{w + static_cast<int64_t>(N + 1) * NU * B + bi, B};

  auto ng_slot = [&](int n) {
    if (!HAS_NG) return -1;
    for (int j = 0; j < n_ng; ++j)
      if (ng_stage[j] == n) return j;
    return -1;
  };
  // the box and soft streams of stage n
  auto load_stage = [&](int n, T (&lamk)[NB2], T (&tk)[NB2], T (&mbk)[NB2],
                        T (&Ak)[NB2], T (&lsk)[NS4], T (&tsk)[NS4],
                        T (&ck)[NS6], T (&msk)[NS]) {
    const int64_t r = static_cast<int64_t>(n) * NB2;
    hp::load(lamk, lamc, r);
    hp::load(tk, tc, r);
    hp::load(mbk, mbc, r);
    hp::load(Ak, Ac, r);
    hp::load(lsk, lsc, static_cast<int64_t>(n) * NS4);
    hp::load(tsk, tsc, static_cast<int64_t>(n) * NS4);
    hp::load(ck, scc, static_cast<int64_t>(n) * NS6);
    hp::load(msk, msc, static_cast<int64_t>(n) * NS);
  };

  // ---- backward: soft prep(stage k) + folded factorization, k = N..0 -----
  T Lxx_c[NX][NX], px_c[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    px_c[i] = T(0);
#pragma unroll
    for (int j = 0; j < NX; ++j) Lxx_c[i][j] = T(0);
  }
  for (int k = N; k >= 0; --k) {
    T ge[NZ];
    T M[NZ][NZ];
    {
      T lamk[NB2], tk[NB2], mbk[NB2], Ak[NB2], lsk[NS4], tsk[NS4], ck[NS6],
          msk[NS], dv[NZ];
      load_stage(k, lamk, tk, mbk, Ak, lsk, tsk, ck, msk);
      hp::load(dv, pdregc, static_cast<int64_t>(k) * NZ);
      hp::load(ge, basec, static_cast<int64_t>(k) * NZ);
      hp::soft_fold<T, NB, NS, NZ>(lamk, tk, mbk, Ak, lsk, tsk, msk, ck,
                                   idxb + k * NB, idxs + k * NS, dv, ge);
#pragma unroll
      for (int i = 0; i < NZ; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j)
          M[i][j] = Hc(static_cast<int64_t>(k) * NT + hp::sym_idx(i, j));
#pragma unroll
      for (int i = 0; i < NZ; ++i) M[i][i] = M[i][i] + dv[i];
    }
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

  // ---- forward: z, affine box+soft directions, partials, s = 0..N -------
  T x[NX];
  {
    T px0[NX];
    hp::load(px0, pxs, 0);
    hp::root_x0<T, NX>(Lxx_c, px0, x);  // the carry holds stage 0's Lxx
  }
  T zero_b[NB2], zero_s[NS4];
#pragma unroll
  for (int i = 0; i < NB2; ++i) zero_b[i] = T(0);
#pragma unroll
  for (int i = 0; i < NS4; ++i) zero_s[i] = T(0);
  for (int s = 0; s <= N; ++s) {
    T zt[NZ];
    {
      T Ll[NZ][NU], eu[NU], Dinv_u[NU], u[NU];
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
    }
    hp::store(zo, static_cast<int64_t>(s) * NZ, zt);
    const int se = s < N - 1 ? s : N - 1;
    hp::x_next_of<T, NZ, NX>(Fc, static_cast<int64_t>(se) * NZ * NX, bc,
                             static_cast<int64_t>(se) * NX, zt, x);

    T lamk[NB2], tk[NB2], mbk[NB2], Ak[NB2], lsk[NS4], tsk[NS4], ck[NS6],
        msk[NS];
    load_stage(s, lamk, tk, mbk, Ak, lsk, tsk, ck, msk);
    T dtb[NB2], dlb[NB2], dts[NS4], dls[NS4], am, e0, e1, e2;
    hp::soft_alpha_pass<T, NB, NS, NZ, false>(
        zt, idxb + s * NB, idxs + s * NS, lamk, tk, mbk, Ak, zero_b, lsk, tsk,
        msk, ck, zero_s, dtb, dlb, dts, dls, am, e0, e1, e2);
    hp::store(dtbo, static_cast<int64_t>(s) * NB2, dtb);
    hp::store(dlbo, static_cast<int64_t>(s) * NB2, dlb);
    hp::store(dtso, static_cast<int64_t>(s) * NS4, dts);
    hp::store(dlso, static_cast<int64_t>(s) * NS4, dls);
    amino(s) = am;
    s0o(s) = e0;
    s1o(s) = e1;
    s2o(s) = e2;
  }
}

template <typename T, bool HAS_NG>
static int launch(const FactorSolveSoftMegaArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + BLOCK - 1) / BLOCK;
  factor_solve_soft_mega_kernel<T, HAS_NG>
      <<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const FactorSolveSoftMegaArgs& a, cudaStream_t stream) {
  return a.n_ng > 0 ? launch<T, true>(a, stream) : launch<T, false>(a, stream);
}

extern "C" int hp_factor_solve_soft_mega(const FactorSolveSoftMegaArgs* a,
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
