// One corrector half-iteration of the batched SOFT IPM in ONE kernel: the
// box + 4-slack-family centering corrections and corrector gradient +
// retained-factor backward substitution + forward recovery with pi + the
// corrector box+soft fraction-to-boundary / mu(alpha) partials, one CUDA
// thread per instance.
//
// Replaces: hpmpc_tpu/ops/mega_kernel.py::solve_soft_mega (TPU body
// _soft_trs_mega_kernel).  Plain version:
// hpmpc_tpu_torch/ops/mega_kernel.py::solve_soft_mega_ref.
//
// What bounds it on the H100: csrc/solve_mega.cu's traffic plus the soft
// streams read twice and the affine soft direction (2 x 4NS) read once,
// the corrector soft direction written -- ~720 scalars per instance and
// stage at the soft flagship (N=30, NZ=11, NX=8, NB=3, NS=8), ~2.9 KB in
// f32, against ~1.3k flops: memory bound in principle, latency bound with
// one thread per instance.
//
// Design: csrc/solve_mega.cu's two loops, phase 1 only.  Backward, stages
// N..0: the box centering stream (cob) and the soft one (dl2s) go to
// per-instance global scratch for the forward loop (the TPU kernel's VMEM
// slabs); the corrector gradient is assembled in registers and fed to
// hp::trs_stage.  Forward, stages 0..N: pi, u, z, x_next, then the
// corrector box+soft alpha pass with cob and dl2s as centering streams.
// EXACT (exact_mehrotra_soft) is a template parameter: without it the soft
// gradient keeps its affine fold, the reference's dropped correction
// (hpmpc_tpu/models/ipm_soft.py:113-120), while dl2s still enters the
// alpha pass.
//
// Specialisation: NU, NX, NB, NS are compile-time (-D, one library per
// shape); "has ng rows" and EXACT are template parameters (all four forms
// are instantiated); N and the ng stage table are runtime.
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
constexpr int BLOCK = 32;

}  // namespace

// Mirrors _SoftSolveArgs in hpmpc_tpu_torch/ops/mega_kernel.py field for
// field.
struct SolveSoftMegaArgs {
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
  const void* dtb;       // (N+1, 2NB, B) affine box slack direction
  const void* dlb;       // (N+1, 2NB, B) affine box dual direction
  const void* dts;       // (N+1, 4NS, B) affine soft slack direction
  const void* dls;       // (N+1, 4NS, B) affine soft dual direction
  const void* sm;        // (B,) sigma * mu
  const void* base;      // (N+1, NZ, B) gradient base g
  const void* ngadd;     // (n_ng, NZ, B) C' qx_g2
  const void* ng_stage;  // (n_ng,) int32 stage of each ng slot
  const void* Ll;        // (N+1, NZ, NU, B)
  const void* Lxx;       // (N+1, NX, NX, B), upper triangle 0
  const void* Pb;        // (N, NX, B)
  const void* F;         // (N, NZ, NX, B)
  const void* b;         // (N, NX, B)
  void* z;               // (N+1, NZ, B)
  void* pi;              // (N, NX, B)
  void* dt2b;            // (N+1, 2NB, B)
  void* dl2b;            // (N+1, 2NB, B)
  void* dt2s;            // (N+1, 4NS, B)
  void* dl2s;            // (N+1, 4NS, B)
  void* amin;            // (N+1, B)
  void* s0;              // (N+1, B)
  void* s1;              // (N+1, B)
  void* s2;              // (N+1, B)
  void* work;            // ((N+1)(NU+NX+2NB+4NS), B): eu, px, cob, dl2s
  int64_t B;
  int64_t N;
  int64_t n_ng;
  int64_t exact;
};

template <typename T, bool HAS_NG, bool EXACT>
__global__ void __launch_bounds__(BLOCK)
    solve_soft_mega_kernel(SolveSoftMegaArgs a) {
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
                     scc = in(a.soft_c), msc = in(a.ms), dtbc = in(a.dtb),
                     dlbc = in(a.dlb), dtsc = in(a.dts), dlsc = in(a.dls),
                     basec = in(a.base), Llc = in(a.Ll), Lxxc = in(a.Lxx),
                     Pbc = in(a.Pb), Fc = in(a.F), bc = in(a.b);
  const Col<T> zo = out(a.z), pio = out(a.pi), dtbo = out(a.dt2b),
               dlbo = out(a.dl2b), dtso = out(a.dt2s), dlso = out(a.dl2s),
               amino = out(a.amin), s0o = out(a.s0), s1o = out(a.s1),
               s2o = out(a.s2);
  T* w = static_cast<T*>(a.work);
  const int64_t Np1 = N + 1;
  const Col<T> eus{w + bi, B};
  const Col<T> pxs{w + Np1 * NU * B + bi, B};
  const Col<T> cobs{w + Np1 * (NU + NX) * B + bi, B};
  const Col<T> coss{w + Np1 * (NU + NX + NB2) * B + bi, B};
  const T smv = in(a.sm)(0);

  auto ng_slot = [&](int n) {
    if (!HAS_NG) return -1;
    for (int j = 0; j < n_ng; ++j)
      if (ng_stage[j] == n) return j;
    return -1;
  };
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

  // ---- backward: soft corrector gradient + retained-factor solve ---------
  T px_c[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) px_c[i] = T(0);
  for (int k = N; k >= 0; --k) {
    T ge[NZ];
    hp::load(ge, basec, static_cast<int64_t>(k) * NZ);
    {
      T lamk[NB2], tk[NB2], mbk[NB2], Ak[NB2], lsk[NS4], tsk[NS4], ck[NS6],
          msk[NS], dtk[NB2], dlk[NB2], dtsk[NS4], dlsk[NS4], cob[NB2],
          dl2s[NS4];
      load_stage(k, lamk, tk, mbk, Ak, lsk, tsk, ck, msk);
      hp::load(dtk, dtbc, static_cast<int64_t>(k) * NB2);
      hp::load(dlk, dlbc, static_cast<int64_t>(k) * NB2);
      hp::load(dtsk, dtsc, static_cast<int64_t>(k) * NS4);
      hp::load(dlsk, dlsc, static_cast<int64_t>(k) * NS4);
      hp::soft_corr_fold<T, NB, NS, NZ, EXACT>(
          lamk, tk, mbk, Ak, dtk, dlk, lsk, tsk, msk, ck, dtsk, dlsk, smv,
          idxb + k * NB, idxs + k * NS, cob, dl2s, ge);
      hp::store(cobs, static_cast<int64_t>(k) * NB2, cob);
      hp::store(coss, static_cast<int64_t>(k) * NS4, dl2s);
    }
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

  // ---- forward: pi, z, corrector box+soft directions, partials ----------
  T x[NX];
  {
    T Lxx[NX][NX], px0[NX];
    load_lxx(0, Lxx);
    hp::load(px0, pxs, 0);
    hp::root_x0<T, NX>(Lxx, px0, x);
  }
  for (int s = 0; s <= N; ++s) {
    T zt[NZ];
    {
      T Ll[NZ][NU], eu[NU], pxv[NX], Dinv_u[NU], u[NU];
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
    }
    hp::store(zo, static_cast<int64_t>(s) * NZ, zt);
    const int se = s < N - 1 ? s : N - 1;
    hp::x_next_of<T, NZ, NX>(Fc, static_cast<int64_t>(se) * NZ * NX, bc,
                             static_cast<int64_t>(se) * NX, zt, x);

    T lamk[NB2], tk[NB2], mbk[NB2], Ak[NB2], lsk[NS4], tsk[NS4], ck[NS6],
        msk[NS], cob[NB2], dl2s[NS4];
    load_stage(s, lamk, tk, mbk, Ak, lsk, tsk, ck, msk);
    hp::load(cob, cobs, static_cast<int64_t>(s) * NB2);
    hp::load(dl2s, coss, static_cast<int64_t>(s) * NS4);
    T dtb[NB2], dlb[NB2], dts[NS4], dls[NS4], am, e0, e1, e2;
    hp::soft_alpha_pass<T, NB, NS, NZ, true>(
        zt, idxb + s * NB, idxs + s * NS, lamk, tk, mbk, Ak, cob, lsk, tsk,
        msk, ck, dl2s, dtb, dlb, dts, dls, am, e0, e1, e2);
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

template <typename T, bool HAS_NG, bool EXACT>
static int launch(const SolveSoftMegaArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + BLOCK - 1) / BLOCK;
  solve_soft_mega_kernel<T, HAS_NG, EXACT>
      <<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const SolveSoftMegaArgs& a, cudaStream_t stream) {
  const bool ng = a.n_ng > 0;
  if (a.exact)
    return ng ? launch<T, true, true>(a, stream)
              : launch<T, false, true>(a, stream);
  return ng ? launch<T, true, false>(a, stream)
            : launch<T, false, false>(a, stream);
}

extern "C" int hp_solve_soft_mega(const SolveSoftMegaArgs* a, int dtype_code,
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
