// One affine IPM half-iteration of a batch of OCP QPs in ONE kernel: barrier
// prep + folded backward Riccati factorization + pi-less forward recovery
// + the affine fraction-to-boundary / mu(alpha) partials, a team of TEAM
// lanes of one warp per instance.
//
// Replaces: hpmpc_tpu/ops/mega_kernel.py::factor_solve_mega (:325, TPU
// body _sv_mega_kernel).  Plain version:
// hpmpc_tpu_torch/ops/mega_kernel.py::factor_solve_mega_ref.
//
// What bounds it on the H100: latency.  Per instance and stage it reads the
// box streams twice (backward and forward), H, F and b twice, and writes
// the factor (Ll, Lxx, Pb), z, the box direction and 4 partials -- ~560
// scalars at the flagship (N=30, NZ=11, NX=8, NB=7), ~2.2 KB in f32 --
// against ~2.7k flops (W = F Lxx ~350 FMAs, M += W W' ~530, the 11 x 11
// Cholesky ~220 FMAs + 11 sqrt/divides, the solves): ~1.2 flop a byte,
// below the ~20 of the f32 balance point, so bound by its bytes in
// principle.  In practice the stage algebra is a chain of small dependent
// steps 31 stages deep, and 4096 instances are few: at one thread an
// instance (this kernel's first version) they made 128 warps, one an SM,
// every stage a serial chain in one thread (255 registers, f64 spilling
// ~2 KB) that waited alone on every load, at ~9% of the byte bound.
//
// Design (the team, as csrc/ipm_resident.cu): TEAM lanes (8 to NZ=12, 16
// to 24) share one instance, 32 / TEAM instances a one-warp block, so a
// 4096 batch is 128 * TEAM warps (~8 an SM at TEAM=8).  Lane r owns the
// rows r, r + TEAM, ... of every NZ-row object of a stage (M, F / W, g, m,
// the Ll / Lxx rows, z), the x indices likewise, and the box pairs with
// k % TEAM == r (csrc/team.cuh).  The stage objects live in a per-team
// slab of dynamic shared memory.  Each stage first fetches all of its
// streams into registers, then stores them into the slab, so it waits on
// one memory latency.  Backward, stages N..0: the box fold of the owned
// pairs, each row's assembly (H, the barrier diagonal and gradient
// scattered in the k order of hp::scatter_add_box, the ng terms on their
// stages), then the shared folded stage (team.cuh folded_core: Pb, m, W,
// M += W W', the column Cholesky), and the owners write their rows of Ll,
// Lxx and Pb.  The Riccati carry (Lxx, px) stays in the slab; eu goes to
// per-instance, instance-major scratch (`work`, hp_factor_solve_mega_work_
// rows(N) rows an instance).  Forward, stages 0..N: u in every lane, the
// owners' z rows and x_next, the owned pairs' box direction and candidate
// pairs, then lane 0 takes the minimum and the e0/e1/e2 sums in row order.
// Every entry keeps the one-thread kernel's expression and order, so the
// outputs are its outputs bit for bit; sums over a lane's runtime range
// are written with explicit roundings (team.cuh).  A box value that
// reaches the scatter as a product is shared as its two factors (the
// scatter's add then contracts into the same FMA as in one thread).
// Inputs and outputs keep their batch-last (rows, B) layout: a row of a
// stream is 32 / TEAM consecutive instances of a warp's store.  Terminal
// stage: the F/b block index clips to N-1 and a zero carry collapses the
// stage to M = H, Pb = 0, m = g, as on the TPU.  Pb has N rows: the
// terminal Pb is never stored.
//
// Specialisation: NU, NX, NB are compile-time (-D, one library per shape);
// phase 2 and "has ng rows" are template parameters (all four forms are
// instantiated); N and the ng stage table (n_ng entries) are runtime.
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
constexpr int NT = NZ * (NZ + 1) / 2;

// lanes an instance: about one M row a lane at NZ <= 12, two past it
constexpr int TEAM = NZ <= 6 ? 4 : NZ <= 12 ? 8 : NZ <= 24 ? 16 : 32;
constexpr int THREADS = 32;          // one warp a block
constexpr int IPB = THREADS / TEAM;  // instances a block
using TM = hp::Team<TEAM>;
__host__ __device__ constexpr int chunks(int n) { return TM::chunks(n); }

// the per-team slab of shared memory, in scalars
constexpr int O_M = 0;                // (NZ, NZ) stage matrix M
constexpr int O_F = O_M + NZ * NZ;    // (NZ, NX) F, then W in place
constexpr int O_LC = O_F + NZ * NX;   // (NX, NX) Lxx carry
constexpr int O_H = O_LC + NX * NX;   // NT packed H of a stage
constexpr int O_NGL = O_H + NT;       // NT packed ng term of a stage
constexpr int O_LL = O_NGL + NT;      // (NZ, NU) Ll of a stage (forward)
constexpr int O_G = O_LL + NZ * NU;   // NZ gradient (first its base)
constexpr int O_PD = O_G + NZ;        // NZ pad_diag + reg_eps
constexpr int O_NA = O_PD + NZ;       // NZ ng gradient term
constexpr int O_MV = O_NA + NZ;       // NZ m
constexpr int O_ZT = O_MV + NZ;       // NZ direction [u; x]
constexpr int O_X = O_ZT + NZ;        // 2 NX x, double-buffered
constexpr int O_PXC = O_X + 2 * NX;   // NX px carry
constexpr int O_PB = O_PXC + NX;      // NX Pb + px carry
constexpr int O_T1 = O_PB + NX;       // NX Lxx' b
constexpr int O_BB = O_T1 + NX;       // NX b
constexpr int O_EU = O_BB + NX;       // NU eu
constexpr int O_DI = O_EU + NU;       // NZ Cholesky pivots
constexpr int O_LAM = O_DI + NZ;      // NB2 box lam, t, mask, A, M
constexpr int O_T = O_LAM + NB2;
constexpr int O_MB = O_T + NB2;
constexpr int O_A = O_MB + NB2;
constexpr int O_MR = O_A + NB2;
constexpr int O_DT = O_MR + NB2;      // NB2 box dt, dl, candidates
constexpr int O_DL = O_DT + NB2;
constexpr int O_CP = O_DL + NB2;
constexpr int O_FA = O_CP + NB2;      // NB scatter factors of Qx, qx
constexpr int O_FQ = O_FA + NB;
constexpr int SLAB = O_FQ + NB;

// rows of per-instance scratch: eu of every stage; instance-major
__host__ __device__ inline int64_t work_rows(int64_t N) {
  return (N + 1) * NU;
}

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
  void* work;            // (B, work_rows(N)) instance-major scratch: eu
  int64_t B;
  int64_t N;
  int64_t n_ng;
  int64_t phase2;
};

template <typename T, bool PHASE2, bool HAS_NG>
__global__ void __launch_bounds__(THREADS)
    factor_solve_mega_kernel(FactorSolveMegaArgs a) {
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
  T* const sM = sh + O_M;
  T* const sF = sh + O_F;
  T* const sLc = sh + O_LC;
  T* const sH = sh + O_H;
  T* const sNgl = sh + O_NGL;
  T* const sLl = sh + O_LL;
  T* const sG = sh + O_G;
  T* const sPd = sh + O_PD;
  T* const sNa = sh + O_NA;
  T* const sMv = sh + O_MV;
  T* const sZt = sh + O_ZT;
  T* const sPxc = sh + O_PXC;
  T* const sPb = sh + O_PB;
  T* const sT1 = sh + O_T1;
  T* const sBb = sh + O_BB;
  T* const sEu = sh + O_EU;
  T* const sDi = sh + O_DI;
  T* const sLam = sh + O_LAM;
  T* const sT = sh + O_T;
  T* const sMb = sh + O_MB;
  T* const sA = sh + O_A;
  T* const sMr = sh + O_MR;
  T* const sDt = sh + O_DT;
  T* const sDl = sh + O_DL;
  T* const sCp = sh + O_CP;
  T* const sFa = sh + O_FA;
  T* const sFq = sh + O_FQ;

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
  const Col<T> eus{static_cast<T*>(a.work) + bi * work_rows(N), 1};

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
    if (PHASE2) TM::fetch<NB2>(r, bx.mr, rows_of(in(a.M), r0));
  };
  auto box_put = [&](const BoxB& bx) {
    TM::put<NB2>(r, sLam, bx.l);
    TM::put<NB2>(r, sT, bx.t);
    TM::put<NB2>(r, sMb, bx.m);
    TM::put<NB2>(r, sA, bx.a);
    if (PHASE2) TM::put<NB2>(r, sMr, bx.mr);
  };

  // ---- backward: prep(stage k) + folded factorization, k = N..0 ----------
  for (int k = N; k >= 0; --k) {
    sync();  // the previous stage's slab reads are done
    const int ke = k < N - 1 ? k : N - 1;
    const int jg = ng_slot(k);
    {
      BoxB bx;
      T hb[chunks(NT)], gb[chunks(NT)], fb[chunks(NZ * NX)], bb[chunks(NX)];
      T pb[chunks(NZ)], gs[chunks(NZ)], nb[chunks(NZ)];
      const int64_t rz = static_cast<int64_t>(k) * NZ;
      box_fetch(k, bx);
      TM::fetch<NZ>(r, pb, rows_of(pdregc, rz));
      TM::fetch<NZ>(r, gs, rows_of(basec, rz));
      TM::fetch<NZ * NX>(r, fb,
                         rows_of(Fc, static_cast<int64_t>(ke) * NZ * NX));
      TM::fetch<NX>(r, bb, rows_of(bc, static_cast<int64_t>(ke) * NX));
      TM::fetch<NT>(r, hb, rows_of(Hc, static_cast<int64_t>(k) * NT));
      if (HAS_NG && jg >= 0) {
        TM::fetch<NT>(r, gb,
                      rows_of(in(a.ngl), static_cast<int64_t>(jg) * NT));
        TM::fetch<NZ>(r, nb,
                      rows_of(in(a.ngadd), static_cast<int64_t>(jg) * NZ));
      }
      box_put(bx);
      TM::put<NZ>(r, sPd, pb);
      TM::put<NZ>(r, sG, gs);
      TM::put<NZ * NX>(r, sF, fb);
      TM::put<NX>(r, sBb, bb);
      TM::put<NT>(r, sH, hb);
      if (HAS_NG && jg >= 0) {
        TM::put<NT>(r, sNgl, gb);
        TM::put<NZ>(r, sNa, nb);
      }
    }
    if (k == N) {
      // terminal stage: zero carry, so the interior formulas collapse
      // exactly to the terminal ones
      for (int e = r; e < NX * NX; e += TEAM) sLc[e] = T(0);
      for (int e = r; e < NX; e += TEAM) sPxc[e] = T(0);
    }
    sync();
    // the box fold of pair i (hp::qx_fold / qx_fold_res): Qx = sFa mb,
    // qx = sFq mb
    for (int i = r; i < NB; i += TEAM) {
      T ti_lo, lt_lo, ti_up, lt_up;
      hp::t_inv_lamt(sLam[i], sT[i], sMb[i], ti_lo, lt_lo);
      hp::t_inv_lamt(sLam[NB + i], sT[NB + i], sMb[NB + i], ti_up, lt_up);
      T q_lo, q_up;
      if (PHASE2) {
        q_lo = ti_lo * sMr[i] - lt_lo * sA[i];
        q_up = -ti_up * sMr[NB + i] - lt_up * sA[NB + i];
      } else {
        q_lo = -sLam[i] - lt_lo * sA[i];
        q_up = sLam[NB + i] - lt_up * sA[NB + i];
      }
      sFa[i] = lt_lo + lt_up;
      sFq[i] = q_lo + q_up;
    }
    sync();
    // row c: H, the barrier diagonal onto M, the gradient (scatters in the
    // order of hp::scatter_add_box), the ng terms on their stages
    const int* ik = idx + k * NB;
    int ib[NB];
#pragma unroll
    for (int q = 0; q < NB; ++q) ib[q] = ik[q];
    for (int c = r; c < NZ; c += TEAM) {
      {
        T hr[NZ];
#pragma unroll
        for (int j = 0; j < NZ; ++j)
          if (j <= c) hr[j] = sH[sym_idx(c, j)];
#pragma unroll
        for (int j = 0; j < NZ; ++j)
          if (j <= c) sM[c * NZ + j] = hr[j];
      }
      T dvc = sPd[c];
#pragma unroll
      for (int q = 0; q < NB; ++q)
        if (ib[q] == c) dvc = dvc + sFa[q] * sMb[q];
      sM[c * NZ + c] = sM[c * NZ + c] + dvc;
      T gec = sG[c];
#pragma unroll
      for (int q = 0; q < NB; ++q)
        if (ib[q] == c) gec = gec + sFq[q] * sMb[q];
      if (HAS_NG && jg >= 0) {
        gec = gec + sNa[c];
#pragma unroll
        for (int j = 0; j < NZ; ++j)
          if (j <= c)
            sM[c * NZ + j] = sM[c * NZ + j] + sNgl[sym_idx(c, j)];
      }
      sG[c] = gec;
    }
    TM::folded_core<T, NU, NX>(r, sync, sM, sF, sLc, sBb, sPxc, sG, sT1, sPb,
                               sMv, sDi, [&](int i, T v) {
                                 if (k < N)
                                   Pbo(static_cast<int64_t>(k) * NX + i) = v;
                               });
    T Dinv_u[NU], eu[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) Dinv_u[i] = sDi[i];
    hp::eu_of_m<T, NU>(sMv, sM, NZ, Dinv_u, eu);
    // px = m_x - Lxu eu; the carry (Lxx block, px); the factor rows
    for (int i = r; i < NX; i += TEAM) {
      T acc = sMv[NU + i];
#pragma unroll
      for (int q = 0; q < NU; ++q) acc = acc - sM[(NU + i) * NZ + q] * eu[q];
      sPxc[i] = acc;
    }
    for (int i = r; i < NZ; i += TEAM) {
#pragma unroll
      for (int j = 0; j < NU; ++j)
        Llo((static_cast<int64_t>(k) * NZ + i) * NU + j) =
            j <= i ? sM[i * NZ + j] : T(0);
      if (i >= NU) {
        const int xi = i - NU;
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          const T v = j <= xi ? sM[i * NZ + NU + j] : T(0);
          Lxxo((static_cast<int64_t>(k) * NX + xi) * NX + j) = v;
          sLc[xi * NX + j] = v;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NU; ++j)
      if (j % TEAM == r) eus(static_cast<int64_t>(k) * NU + j) = eu[j];
  }

  // ---- forward: z, affine box direction, alpha/mu partials, s = 0..N -----
  sync();  // the carry holds stage 0's Lxx and px
  hp::root_x0<TEAM, T, NX>(
      r, [&](int i, int j) { return sLc[i * NX + j]; }, sPxc, sh + O_X);
  for (int s = 0; s <= N; ++s) {
    const T* x = sh + O_X + (s & 1) * NX;
    T* xn = sh + O_X + ((s & 1) ^ 1) * NX;
    sync();
    const int se = s < N - 1 ? s : N - 1;
    {
      BoxB bx;
      T lb[chunks(NZ * NU)], eb[chunks(NU)], fb[chunks(NZ * NX)],
          bb[chunks(NX)];
      TM::fetch<NZ * NU>(r, lb,
                         rows_of(Llo, static_cast<int64_t>(s) * NZ * NU));
      TM::fetch<NU>(r, eb, rows_of(eus, static_cast<int64_t>(s) * NU));
      box_fetch(s, bx);
      TM::fetch<NZ * NX>(r, fb,
                         rows_of(Fc, static_cast<int64_t>(se) * NZ * NX));
      TM::fetch<NX>(r, bb, rows_of(bc, static_cast<int64_t>(se) * NX));
      TM::put<NZ * NU>(r, sLl, lb);
      TM::put<NU>(r, sEu, eb);
      box_put(bx);
      TM::put<NZ * NX>(r, sF, fb);
      TM::put<NX>(r, sBb, bb);
    }
    sync();
    T u[NU];
    hp::u_of_x<T, NU, NX>(sLl, sEu, x, u);
#pragma unroll
    for (int i = 0; i < NU; ++i)
      if (i % TEAM == r) sZt[i] = u[i];
    for (int i = r; i < NX; i += TEAM) sZt[NU + i] = x[i];
    sync();
    for (int i = r; i < NZ; i += TEAM)
      zo(static_cast<int64_t>(s) * NZ + i) = sZt[i];
    hp::x_next<TEAM, T, NZ, NX>(r, sBb, sF, sZt, xn);
    const int* ik = idx + s * NB;
    const int64_t r0 = static_cast<int64_t>(s) * NB2;
    for (int i = r; i < NB; i += TEAM) {
      const T zb = hp::gather<T, NZ>(sZt, ik[i]);
      if (PHASE2) {
        // hp::dt_dlam_res: the full slack step, dl = -t_inv (lam dt + M),
        // lam dt rounded as the one-thread kernel rounded it (it shares
        // the product with alpha_sums' e1 there)
        const T dt_lo = (zb - sA[i]) * sMb[i];
        const T dt_up = (sA[NB + i] - zb) * sMb[NB + i];
        T ti_lo, lt_lo, ti_up, lt_up;
        hp::t_inv_lamt(sLam[i], sT[i], sMb[i], ti_lo, lt_lo);
        hp::t_inv_lamt(sLam[NB + i], sT[NB + i], sMb[NB + i], ti_up, lt_up);
        const T dl_lo =
            -ti_lo * (hp::mul_rn(sLam[i], dt_lo) + sMr[i]) * sMb[i];
        const T dl_up = -ti_up *
                        (hp::mul_rn(sLam[NB + i], dt_up) + sMr[NB + i]) *
                        sMb[NB + i];
        sDt[i] = dt_lo;
        sDt[NB + i] = dt_up;
        sDl[i] = dl_lo;
        sDl[NB + i] = dl_up;
        sCp[i] = hp::cand_pair(sLam[i], sT[i], sMb[i], dt_lo, dl_lo);
        sCp[NB + i] = hp::cand_pair(sLam[NB + i], sT[NB + i], sMb[NB + i],
                                    dt_up, dl_up);
      } else {
        hp::box_dir<T, NB>(i, zb, T(0), T(0), sLam, sT, sMb, sA, sDt, sDl,
                           sCp);
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
static int launch(const FactorSolveMegaArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + IPB - 1) / IPB;
  const int64_t smem = static_cast<int64_t>(IPB) * SLAB * sizeof(T);
  const int rc =
      hp::allow_smem(factor_solve_mega_kernel<T, PHASE2, HAS_NG>, smem);
  if (rc != 0) return rc;
  factor_solve_mega_kernel<T, PHASE2, HAS_NG>
      <<<static_cast<unsigned>(blocks), THREADS, static_cast<size_t>(smem),
         stream>>>(a);
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

extern "C" int64_t hp_factor_solve_mega_work_rows(int64_t N) {
  return work_rows(N);
}

// The launch shape, for the measurement scripts: lanes an instance and
// threads a block.
extern "C" int hp_factor_solve_mega_team() { return TEAM; }
extern "C" int hp_factor_solve_mega_threads() { return THREADS; }

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
