// One corrector IPM half-iteration of a batch of OCP QPs in ONE kernel:
// centering/corrector gradient + retained-factor backward substitution +
// forward recovery with pi + the corrector fraction-to-boundary / mu(alpha)
// partials, a team of TEAM lanes of one warp per instance.
//
// Replaces: hpmpc_tpu/ops/mega_kernel.py::solve_mega (:601, TPU body
// _trs_mega_kernel).  Plain version:
// hpmpc_tpu_torch/ops/mega_kernel.py::solve_mega_ref.
//
// What bounds it on the H100: latency.  Per instance and stage it reads the
// box streams twice, the affine direction, Ll, Lxx, Pb, F twice and b, and
// writes z, pi, the box direction and 4 partials -- ~540 scalars at the
// flagship (N=30, NZ=11, NX=8, NB=7), ~2.2 KB in f32 -- against ~0.9k
// flops (triangular solves and matrix-vector products): ~0.4 flop a byte,
// bound by its bytes in principle; in practice by the latency of a chain
// of small dependent steps 31 stages deep, which one thread an instance
// (this kernel's first version: 128 warps at B=4096, ~7% of the byte
// bound) ran alone.
//
// Design (the team, as csrc/factor_solve_mega.cu and csrc/ipm_resident.cu;
// helpers in csrc/team.cuh): TEAM lanes (8 to NZ=12, 16 to 24) share one
// instance, 32 / TEAM instances a one-warp block; lane r owns the rows r,
// r + TEAM, ... of every NZ-row object of a stage and the box pairs with
// k % TEAM == r; the stage objects live in a per-team slab of dynamic
// shared memory, and each stage fetches all of its streams before it
// stores any into the slab.  Backward, stages N..0: the owned pairs'
// centering stream co (to scratch for the forward sweep) and corrected
// gradient fold, each row's gradient (scattered in the k order of
// hp::scatter_add_box, the ng term on its stages) and m = g + F (Pb + px),
// eu in every lane, the owners' px rows (the carry).  Forward, stages
// 0..N: pi_{s-1} = Lxx_s (Lxx_s' x_s) + px_s (so pi has N rows and stage 0
// writes none), u in every lane, the owners' z rows and x_next, the owned
// pairs' corrector box direction -- in phase 1 co enters as the dl0
// correction, in phase 2 as the residual M (= rm2) -- and lane 0 takes the
// minimum and the e0/e1/e2 sums in row order.  Every entry keeps the
// one-thread kernel's expression and order (the outputs are its outputs
// bit for bit; sums over a lane's runtime range written with explicit
// roundings); a box value that reaches the scatter as a product is shared
// as its two factors, one that ends in a sum as its value.  eu, px and co
// go to per-instance, instance-major scratch (`work`,
// hp_solve_mega_work_rows(N) rows an instance); the inputs and outputs
// keep their batch-last (rows, B) layout.
//
// Specialisation: NU, NX, NB are compile-time (-D, one library per shape);
// phase 2 and "has ng rows" are template parameters (all four forms are
// instantiated); N and the ng stage table are runtime.
#include "team.cuh"

#if !defined(HP_NU) || !defined(HP_NX) || !defined(HP_NB)
#error "compile with -DHP_NU=.. -DHP_NX=.. -DHP_NB=.."
#endif

namespace {

constexpr int NU = HP_NU;
constexpr int NX = HP_NX;
constexpr int NZ = NU + NX;
constexpr int NB = HP_NB;
constexpr int NB2 = 2 * NB;
constexpr int NTX = NX * (NX + 1) / 2;

// lanes an instance: about one M row a lane at NZ <= 12, two past it
constexpr int TEAM = NZ <= 6 ? 4 : NZ <= 12 ? 8 : NZ <= 24 ? 16 : 32;
constexpr int THREADS = 32;          // one warp a block
constexpr int IPB = THREADS / TEAM;  // instances a block
using TM = hp::Team<TEAM>;
__host__ __device__ constexpr int chunks(int n) { return TM::chunks(n); }

// the per-team slab of shared memory, in scalars
constexpr int O_F = 0;                // (NZ, NX) F
constexpr int O_LL = O_F + NZ * NX;   // (NZ, NU) Ll of a stage
constexpr int O_LX = O_LL + NZ * NU;  // NTX packed Lxx of a stage
constexpr int O_MV = O_LX + NTX;      // NZ m (first the gradient base)
constexpr int O_NA = O_MV + NZ;       // NZ ng gradient term
constexpr int O_ZT = O_NA + NZ;       // NZ direction [u; x]
constexpr int O_X = O_ZT + NZ;        // 2 NX x, double-buffered
constexpr int O_PXC = O_X + 2 * NX;   // NX px carry
constexpr int O_PB = O_PXC + NX;      // NX Pb + px carry
constexpr int O_T1 = O_PB + NX;       // NX Lxx' x
constexpr int O_PXV = O_T1 + NX;      // NX px of a stage
constexpr int O_BB = O_PXV + NX;      // NX b
constexpr int O_EU = O_BB + NX;       // NU eu
constexpr int O_LAM = O_EU + NU;      // NB2 box lam, t, mask, A, M
constexpr int O_T = O_LAM + NB2;
constexpr int O_MB = O_T + NB2;
constexpr int O_A = O_MB + NB2;
constexpr int O_MR = O_A + NB2;
constexpr int O_DT = O_MR + NB2;      // NB2 box dt, dl (affine: the inputs)
constexpr int O_DL = O_DT + NB2;
constexpr int O_CP = O_DL + NB2;      // NB2 candidates
constexpr int O_CO = O_CP + NB2;      // NB2 centering stream
constexpr int O_FQ = O_CO + NB2;      // NB gradient fold (value or factor)
constexpr int SLAB = O_FQ + NB;

// rows of per-instance scratch, in the order the kernel carves them: eu,
// px, co of every stage; instance-major
__host__ __device__ inline int64_t work_rows(int64_t N) {
  return (N + 1) * (NU + NX + NB2);
}

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
  void* work;            // (B, work_rows(N)) instance-major: eu, px, co
  int64_t B;
  int64_t N;
  int64_t n_ng;
  int64_t phase2;
};

template <typename T, bool PHASE2, bool HAS_NG>
__global__ void __launch_bounds__(THREADS) solve_mega_kernel(SolveMegaArgs a) {
  using hp::Col;
  using hp::sym_idx;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = static_cast<int>(threadIdx.x);
  const int tw = lane / TEAM, r = lane % TEAM;
  const unsigned mask =
      TEAM == 32 ? 0xffffffffu : ((1u << TEAM) - 1u) << (tw * TEAM);
  const int64_t B = a.B;
  const int64_t bi = static_cast<int64_t>(blockIdx.x) * IPB + tw;
  if (bi >= B) return;  // the whole team
  const int N = static_cast<int>(a.N);
  const int n_ng = static_cast<int>(a.n_ng);
  const int* idx = static_cast<const int*>(a.idx);
  const int* ng_stage = static_cast<const int*>(a.ng_stage);
  auto sync = [&] { __syncwarp(mask); };

  T* const sh = reinterpret_cast<T*>(smem_raw) + tw * SLAB;
  T* const sF = sh + O_F;
  T* const sLl = sh + O_LL;
  T* const sLx = sh + O_LX;
  T* const sMv = sh + O_MV;
  T* const sNa = sh + O_NA;
  T* const sZt = sh + O_ZT;
  T* const sPxc = sh + O_PXC;
  T* const sPb = sh + O_PB;
  T* const sT1 = sh + O_T1;
  T* const sPxv = sh + O_PXV;
  T* const sBb = sh + O_BB;
  T* const sEu = sh + O_EU;
  T* const sLam = sh + O_LAM;
  T* const sT = sh + O_T;
  T* const sMb = sh + O_MB;
  T* const sA = sh + O_A;
  T* const sMr = sh + O_MR;
  T* const sDt = sh + O_DT;
  T* const sDl = sh + O_DL;
  T* const sCp = sh + O_CP;
  T* const sCo = sh + O_CO;
  T* const sFq = sh + O_FQ;

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
  T* const w = static_cast<T*>(a.work) + bi * work_rows(N);
  const int64_t Np1 = N + 1;
  const Col<T> eus{w, 1};
  const Col<T> pxs{w + Np1 * NU, 1};
  const Col<T> cor{w + Np1 * (NU + NX), 1};
  const T smv = in(a.sm)(0);

  auto ng_slot = [&](int n) {
    if (!HAS_NG) return -1;
    for (int j = 0; j < n_ng; ++j)
      if (ng_stage[j] == n) return j;
    return -1;
  };
  auto rows_of = [&](const auto& col, int64_t r0) {
    return [=](int e) { return col(r0 + e); };
  };
  // a stage's box streams in registers (fetch), then in the slab (put)
  struct BoxB {
    T l[chunks(NB2)], t[chunks(NB2)], m[chunks(NB2)], a[chunks(NB2)],
        mr[chunks(NB2)];
  };
  auto box_fetch = [&](int n, BoxB& bx) {
    const int64_t r0 = static_cast<int64_t>(n) * NB2;
    TM::fetch<NB2>(r, bx.l, rows_of(lamc, r0));
    TM::fetch<NB2>(r, bx.t, rows_of(tc, r0));
    TM::fetch<NB2>(r, bx.m, rows_of(mbc, r0));
    TM::fetch<NB2>(r, bx.a, rows_of(Ac, r0));
  };
  auto box_put = [&](const BoxB& bx) {
    TM::put<NB2>(r, sLam, bx.l);
    TM::put<NB2>(r, sT, bx.t);
    TM::put<NB2>(r, sMb, bx.m);
    TM::put<NB2>(r, sA, bx.a);
  };
  // the packed lower triangle of stage n's Lxx (the upper one is 0)
  auto lx_of = [&](int n) {
    const int64_t r0 = static_cast<int64_t>(n) * NX * NX;
    return [=](int e) {
      int i = 0;
#pragma unroll
      for (int q = 1; q < NX; ++q) i += e >= q * (q + 1) / 2 ? 1 : 0;
      return Lxxc(r0 + i * NX + (e - i * (i + 1) / 2));
    };
  };

  // ---- backward: corrector gradient + retained-factor solve, k = N..0 ----
  for (int k = N; k >= 0; --k) {
    sync();  // the previous stage's slab reads are done
    const int ke = k < N - 1 ? k : N - 1;
    const int jg = ng_slot(k);
    const int64_t rb = static_cast<int64_t>(k) * NB2;
    {
      BoxB bx;
      T db[chunks(NB2)], lb[chunks(NB2)], llb[chunks(NZ * NU)],
          fb[chunks(NZ * NX)], pb[chunks(NX)], gs[chunks(NZ)],
          nb[chunks(NZ)];
      box_fetch(k, bx);
      TM::fetch<NZ>(r, gs, rows_of(basec, static_cast<int64_t>(k) * NZ));
      if (HAS_NG && jg >= 0)
        TM::fetch<NZ>(r, nb,
                      rows_of(in(a.ngadd), static_cast<int64_t>(jg) * NZ));
      if (PHASE2) TM::fetch<NB2>(r, bx.mr, rows_of(in(a.M), rb));
      TM::fetch<NB2>(r, db, rows_of(dtbc, rb));
      TM::fetch<NB2>(r, lb, rows_of(dlbc, rb));
      TM::fetch<NZ * NU>(r, llb,
                         rows_of(Llc, static_cast<int64_t>(k) * NZ * NU));
      TM::fetch<NZ * NX>(r, fb,
                         rows_of(Fc, static_cast<int64_t>(ke) * NZ * NX));
      if (k < N)
        TM::fetch<NX>(r, pb, rows_of(Pbc, static_cast<int64_t>(ke) * NX));
      box_put(bx);
      TM::put<NZ>(r, sMv, gs);
      if (HAS_NG && jg >= 0) TM::put<NZ>(r, sNa, nb);
      if (PHASE2) TM::put<NB2>(r, sMr, bx.mr);
      TM::put<NB2>(r, sDt, db);
      TM::put<NB2>(r, sDl, lb);
      TM::put<NZ * NU>(r, sLl, llb);
      TM::put<NZ * NX>(r, sF, fb);
      // Pb + px of stage k+1 (the terminal stage: unused)
      if (k < N) {
#pragma unroll
        for (int c = 0; c < chunks(NX); ++c) {
          const int e = r + c * TEAM;
          if (e < NX) sPb[e] = pb[c] + sPxc[e];
        }
      }
    }
    sync();
    // box centering stream and corrected gradient fold of pair i
    // (hp::corr_co_qx: qx ends in a sum, shared as its value;
    // hp::corr_co_qx_res: a product, shared as its factor beside mb)
    for (int i = r; i < NB; i += TEAM) {
      T ti_lo, lt_lo, ti_up, lt_up;
      hp::t_inv_lamt(sLam[i], sT[i], sMb[i], ti_lo, lt_lo);
      hp::t_inv_lamt(sLam[NB + i], sT[NB + i], sMb[NB + i], ti_up, lt_up);
      T co_lo, co_up;
      if (PHASE2) {
        co_lo = (sMr[i] + (sDt[i] * sDl[i] - smv)) * sMb[i];
        co_up = (sMr[NB + i] + (sDt[NB + i] * sDl[NB + i] - smv)) *
                sMb[NB + i];
        const T q_lo = ti_lo * co_lo - lt_lo * sA[i];
        const T q_up = -ti_up * co_up - lt_up * sA[NB + i];
        sFq[i] = q_lo + q_up;
      } else {
        co_lo = ti_lo * (smv - sDl[i] * sDt[i]) * sMb[i];
        co_up = ti_up * (smv - sDl[NB + i] * sDt[NB + i]) * sMb[NB + i];
        const T q_lo = -sLam[i] - lt_lo * sA[i];
        const T q_up = sLam[NB + i] - lt_up * sA[NB + i];
        const T qx0 = (q_lo + q_up) * sMb[i];
        sFq[i] = qx0 + (co_up - co_lo) * sMb[i];
      }
      cor(rb + i) = co_lo;
      cor(rb + NB + i) = co_up;
    }
    sync();
    // row c: the corrected gradient, then m = g + F (Pb + px)
    // (hp::trs_stage)
    const int* ik = idx + k * NB;
    int ib[NB];
#pragma unroll
    for (int q = 0; q < NB; ++q) ib[q] = ik[q];
    for (int c = r; c < NZ; c += TEAM) {
      T gec = sMv[c];
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        if (ib[q] == c) {
          if (PHASE2)
            gec = gec + sFq[q] * sMb[q];
          else
            gec = gec + sFq[q];
        }
      }
      if (HAS_NG && jg >= 0) gec = gec + sNa[c];
      T acc = gec;
      if (k < N) {
#pragma unroll
        for (int q = 0; q < NX; ++q) acc = acc + sF[c * NX + q] * sPb[q];
      }
      sMv[c] = acc;
    }
    sync();
    T Dinv_u[NU], eu[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i)
      Dinv_u[i] = T(1) / hp::nmax(sLl[i * NU + i], T(1e-30));
    hp::eu_of_m<T, NU>(sMv, sLl, NU, Dinv_u, eu);
    for (int i = r; i < NX; i += TEAM) {
      T acc = sMv[NU + i];
#pragma unroll
      for (int q = 0; q < NU; ++q) acc = acc - sLl[(NU + i) * NU + q] * eu[q];
      pxs(static_cast<int64_t>(k) * NX + i) = acc;
      sPxc[i] = acc;
    }
#pragma unroll
    for (int j = 0; j < NU; ++j)
      if (j % TEAM == r) eus(static_cast<int64_t>(k) * NU + j) = eu[j];
  }

  // ---- forward: pi, z, corrector box direction, partials, s = 0..N -------
  sync();
  TM::copy<NTX>(r, sLx, lx_of(0));
  sync();
  // the carry holds stage 0's px
  hp::root_x0<TEAM, T, NX>(
      r, [&](int i, int j) { return sLx[sym_idx(i, j)]; }, sPxc, sh + O_X);
  for (int s = 0; s <= N; ++s) {
    const T* x = sh + O_X + (s & 1) * NX;
    T* xn = sh + O_X + ((s & 1) ^ 1) * NX;
    sync();
    const int se = s < N - 1 ? s : N - 1;
    const int64_t r0 = static_cast<int64_t>(s) * NB2;
    {
      BoxB bx;
      T llb[chunks(NZ * NU)], eb[chunks(NU)], pxb[chunks(NX)],
          lxb[chunks(NTX)], cob[chunks(NB2)], fb[chunks(NZ * NX)],
          bb[chunks(NX)];
      TM::fetch<NZ * NU>(r, llb,
                         rows_of(Llc, static_cast<int64_t>(s) * NZ * NU));
      TM::fetch<NU>(r, eb, rows_of(eus, static_cast<int64_t>(s) * NU));
      TM::fetch<NX>(r, pxb, rows_of(pxs, static_cast<int64_t>(s) * NX));
      box_fetch(s, bx);
      TM::fetch<NB2>(r, cob, rows_of(cor, r0));
      TM::fetch<NZ * NX>(r, fb,
                         rows_of(Fc, static_cast<int64_t>(se) * NZ * NX));
      TM::fetch<NX>(r, bb, rows_of(bc, static_cast<int64_t>(se) * NX));
      if (s >= 1) TM::fetch<NTX>(r, lxb, lx_of(s));
      TM::put<NZ * NU>(r, sLl, llb);
      TM::put<NU>(r, sEu, eb);
      TM::put<NX>(r, sPxv, pxb);
      box_put(bx);
      TM::put<NB2>(r, sCo, cob);
      TM::put<NZ * NX>(r, sF, fb);
      TM::put<NX>(r, sBb, bb);
      if (s >= 1) TM::put<NTX>(r, sLx, lxb);
    }
    sync();
    T u[NU];
    hp::u_of_x<T, NU, NX>(sLl, sEu, x, u);
#pragma unroll
    for (int i = 0; i < NU; ++i)
      if (i % TEAM == r) sZt[i] = u[i];
    for (int i = r; i < NX; i += TEAM) sZt[NU + i] = x[i];
    // pi_{s-1} = Lxx_s (Lxx_s' x_s) + px_s (hp::pi_of_x), first half
    if (s >= 1) hp::pi_t1<TEAM, T, NX>(r, sLx, x, sT1);
    sync();
    for (int i = r; i < NZ; i += TEAM)
      zo(static_cast<int64_t>(s) * NZ + i) = sZt[i];
    if (s >= 1)
      hp::pi_rows<TEAM, T, NX>(r, sLx, sPxv, sT1, [&](int i, T v) {
        pio(static_cast<int64_t>(s - 1) * NX + i) = v;
      });
    hp::x_next<TEAM, T, NZ, NX>(r, sBb, sF, sZt, xn);
    const int* ik = idx + s * NB;
    for (int i = r; i < NB; i += TEAM) {
      const T zb = hp::gather<T, NZ>(sZt, ik[i]);
      if (PHASE2) {
        // hp::dt_dlam_res with M = co (rm2), lam dt + M one FMA as the
        // one-thread kernel rounded it
        const T dt_lo = (zb - sA[i]) * sMb[i];
        const T dt_up = (sA[NB + i] - zb) * sMb[NB + i];
        T ti_lo, lt_lo, ti_up, lt_up;
        hp::t_inv_lamt(sLam[i], sT[i], sMb[i], ti_lo, lt_lo);
        hp::t_inv_lamt(sLam[NB + i], sT[NB + i], sMb[NB + i], ti_up, lt_up);
        const T dl_lo = -ti_lo * hp::fma_rn(sLam[i], dt_lo, sCo[i]) * sMb[i];
        const T dl_up =
            -ti_up * hp::fma_rn(sLam[NB + i], dt_up, sCo[NB + i]) * sMb[NB + i];
        sDt[i] = dt_lo;
        sDt[NB + i] = dt_up;
        sDl[i] = dl_lo;
        sDl[NB + i] = dl_up;
        sCp[i] = hp::cand_pair(sLam[i], sT[i], sMb[i], dt_lo, dl_lo);
        sCp[NB + i] = hp::cand_pair(sLam[NB + i], sT[NB + i], sMb[NB + i],
                                    dt_up, dl_up);
      } else {
        hp::box_dir<T, NB>(i, zb, sCo[i], sCo[NB + i], sLam, sT, sMb, sA,
                           sDt, sDl, sCp);
      }
      dto(r0 + i) = sDt[i];
      dto(r0 + NB + i) = sDt[NB + i];
      dlo(r0 + i) = sDl[i];
      dlo(r0 + NB + i) = sDl[NB + i];
    }
    sync();
    if (r == 0) {
      T am = T(INFINITY), e0 = T(0), e1 = T(0), e2 = T(0);
      hp::alpha_chain<T, NB2, NB2, PHASE2>(sLam, sT, sMb, sDt, sDl, sCp, am,
                                           e0, e1, e2);
      amino(s) = am;
      s0o(s) = e0;
      s1o(s) = e1;
      s2o(s) = e2;
    }
  }
}

template <typename T, bool PHASE2, bool HAS_NG>
static int launch(const SolveMegaArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + IPB - 1) / IPB;
  const int64_t smem = static_cast<int64_t>(IPB) * SLAB * sizeof(T);
  const int rc = hp::allow_smem(solve_mega_kernel<T, PHASE2, HAS_NG>, smem);
  if (rc != 0) return rc;
  solve_mega_kernel<T, PHASE2, HAS_NG>
      <<<static_cast<unsigned>(blocks), THREADS, static_cast<size_t>(smem),
         stream>>>(a);
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

extern "C" int64_t hp_solve_mega_work_rows(int64_t N) { return work_rows(N); }

// The launch shape, for the measurement scripts: lanes an instance and
// threads a block.
extern "C" int hp_solve_mega_team() { return TEAM; }
extern "C" int hp_solve_mega_threads() { return THREADS; }

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
