// The whole phase-1 Mehrotra IPM of a batch of OCP QPs in ONE kernel:
// a team of TEAM lanes of one warp runs one instance's solve from init to
// exit.
//
// Replaces: hpmpc_tpu/ops/resident_kernel.py::ipm_resident (:1014, TPU
// body _resident_kernel), general-constraint rows included: the hard
// variant (HP_NS = 0, Queue 2 row 1) and the soft one (HP_NS > 0, row 1s,
// the single-loop soft IPM d_ip2_mpc_soft_tv).  Plain version:
// hpmpc_tpu_torch/ops/resident_kernel.py::ipm_resident_ref.
//
// Algorithm (the reference's legacy no-residual d_ip2_hard): per
// iteration four stage sweeps -- affine backward (pending update, barrier
// fold, folded Riccati factor), affine forward (direction, fraction-to-
// boundary minimum, mu(alpha) sums, sigma), corrector backward (centering
// gradient, retained-factor solve), corrector forward (direction, alpha,
// mu, breakdown guard, freeze).  The state update z += a2 (dz2 - z) is
// left pending and applied stage by stage in the next iteration's first
// sweep; a last pass applies the final one.
//
// What bounds it on the H100: latency, then instruction issue.  Per
// instance and iteration the work is ~31 stages x 4 sweeps of small
// dependent stage algebra (at the flagship NZ=11, NX=8: W = F Lxx ~350
// FMAs, M += W W' ~530, the stage Cholesky ~220 FMAs + 11 sqrt/divides,
// the triangular solves), ~2 flop a byte against the ~20 of the f32
// balance point, over ~5-8 iterations, and 4096 instances are few: at one
// thread an instance (this kernel's first version) they made 128 warps,
// one an SM, every stage a serial chain in one thread that spilled its
// stage arrays (255 registers) and waited alone on every load.  The TPU
// kernel keeps its state in VMEM and runs 1024 instances in the lanes of
// its vector unit; neither carries over.
//
// Design (the team): TEAM lanes (a power of two picked from NZ: 8 to
// NZ=12, 16 to 24, as measured at NZ=11 and 19) share one instance, 32 / TEAM instances a warp, one warp a block, so a
// 4096 batch is 128 * TEAM warps (~8 an SM at TEAM=8).  Lane r owns the
// rows r, r + TEAM, ... of every NZ-row object of a stage (M, F, W, g, m,
// the Ll / Lxx rows, z), the x indices likewise (x index i is z row
// NU + i), and the box pairs, ng rows and soft rows k with k % TEAM == r.
// The stage objects live in a per-team slab of shared memory (dynamic,
// SLAB scalars a team); registers hold a lane's row while it is worked
// on.  A sweep fetches all of a stage's streams into registers before it
// stores any into the slab, so a stage waits on one memory latency.
// Every entry keeps the first version's expression and order, so the
// outputs are its outputs bit for bit:
//   - the Cholesky runs column by column, one warp barrier a column
//     (csrc/team.cuh folded_core): every lane forms the pivot
//     1 / sqrt(max(a_jj, 1e-20)) from the slab, the row owners update
//     their rows in the column order of csrc/stage_math.cuh::chol, each
//     forming the scaled entries it reads as their owners form them;
//   - W, M += W W', m, Pb, px, x_next, u, pi, the triangular solves and
//     the ng products: one lane an output entry, its sequential chain;
//     where a lane's range is a runtime one (Pb, pi), the chain is written
//     with explicit roundings (dot_chain) as nvcc contracted the unrolled
//     one-thread chain;
//   - a box / soft / ng value scattered onto the gradient or the barrier
//     diagonal is shared as its two factors when it ends in a product
//     (the scatter's add then contracts into the same FMA as before), as
//     its value when it ends in a sum;
//   - the fraction-to-boundary candidates are formed by the row owners,
//     the minimum and the e0/e1/e2 partial sums by lane 0 in row order;
//   - the max |dual| of the breakdown guard is a team max (any order).
// The team's scalars (mu, sigma, alpha, the guard, frozen, kk) are
// uniform across its lanes.  Warp barriers and shuffles name the team's
// own lanes, so a team that has stopped (converged, frozen, or past B)
// never holds up a live team in its warp.  Scratch is per instance and
// instance-major (a team's consecutive rows are consecutive addresses);
// the inputs and outputs keep the batch-last (rows, B) layout.  The team
// helpers and the stage routines this kernel shares with rows 19 and 20
// (csrc/factor_solve_mega.cu, csrc/solve_mega.cu) are in csrc/team.cuh.
//
// Soft rows (HP_NS > 0): each stage's NS soft constraints carry four
// slack/multiplier families [lo; up; s_lo; s_up] (4NS values), eliminated
// per stage by the slack Schur complement (the per-row expressions of
// csrc/stage_math.cuh soft_schur, soft_qx, soft_dt_dls, soft_corr_fold).
// The affine backward sweep folds them into the barrier diagonal and
// gradient, both forward sweeps add their directions' fraction-to-boundary
// and duality terms, the corrector backward sweep their centering
// gradient (exact: with its Schur-folded correction; without it the
// reference's dropped correction; a uniform runtime branch).  Their
// multipliers and slacks live in the lams/ts outputs, five direction
// streams (5 x 4NS rows a stage) join the scratch, and the duality
// scaling is per instance (musc).
//
// Specialisation: NU, NX, NB, NG and NS (0 when absent: the hard kernel)
// are compile-time (-D, one library per shape); N, k_max and the stages
// that carry general constraints (the ng_stage table, n_ng entries) are
// runtime arguments.
#include "team.cuh"

#if !defined(HP_NU) || !defined(HP_NX) || !defined(HP_NB) || !defined(HP_NG)
#error "compile with -DHP_NU=.. -DHP_NX=.. -DHP_NB=.. -DHP_NG=.."
#endif
#ifndef HP_NS
#define HP_NS 0
#endif

namespace {

constexpr int NU = HP_NU;
constexpr int NX = HP_NX;
constexpr int NZ = NU + NX;
constexpr int NB = HP_NB;
constexpr int NB2 = 2 * NB;
constexpr int NG = HP_NG;
constexpr int NG2 = 2 * NG;
constexpr int NT = NZ * (NZ + 1) / 2;
constexpr int NTX = NX * (NX + 1) / 2;
constexpr int NS = HP_NS;
// the soft arrays' extent (1 in the hard kernel, where no soft code runs)
constexpr int NSA = NS > 0 ? NS : 1;
constexpr int NS4 = 4 * NSA;

// lanes an instance: about one M row a lane at NZ <= 12, two past it
constexpr int TEAM = NZ <= 6 ? 4 : NZ <= 12 ? 8 : NZ <= 24 ? 16 : 32;
static_assert(NT <= NZ * NU + NTX, "the packed H overlays Ll and Lxx");
constexpr int THREADS = 32;             // one warp a block
constexpr int IPB = THREADS / TEAM;     // instances a block

// the per-team slab of shared memory, in scalars
constexpr int O_M = 0;                        // (NZ, NZ) stage matrix M
constexpr int O_F = O_M + NZ * NZ;            // (NZ, NX) F, then W in place
constexpr int O_LC = O_F + NZ * NX;           // (NX, NX) Lxx carry / Lxx
constexpr int O_LL = O_LC + NX * NX;          // (NZ, NU) Ll of a stage
constexpr int O_LX = O_LL + NZ * NU;          // NTX packed Lxx of a stage
// NT packed H of a stage (the barrier fold only): over Ll and Lxx, which
// only the other sweeps use (NT <= NZ NU + NTX)
constexpr int O_H = O_LL;
constexpr int O_G = O_LX + NTX;               // NZ gradient
constexpr int O_MV = O_G + NZ;                // NZ m
constexpr int O_ZT = O_MV + NZ;               // NZ direction [u; x]
constexpr int O_X = O_ZT + NZ;                // 2 NX x, double-buffered
constexpr int O_PXC = O_X + 2 * NX;           // NX px carry
constexpr int O_PB = O_PXC + NX;              // NX Pb + px carry
constexpr int O_T1 = O_PB + NX;               // NX Lxx' b / Lxx' x
constexpr int O_PXV = O_T1 + NX;              // NX px of a stage
constexpr int O_BB = O_PXV + NX;              // NX b
constexpr int O_EU = O_BB + NX;               // NU eu
constexpr int O_DI = O_EU + NU;               // NZ Cholesky pivots
constexpr int O_LAM = O_DI + NZ;              // NB2 box lam, t, mask, d
constexpr int O_T = O_LAM + NB2;
constexpr int O_MB = O_T + NB2;
constexpr int O_A = O_MB + NB2;
constexpr int O_DT = O_A + NB2;               // NB2 box dt, dl, candidates,
constexpr int O_DL = O_DT + NB2;              //   centering stream
constexpr int O_CP = O_DL + NB2;
constexpr int O_CO = O_CP + NB2;
constexpr int O_FA = O_CO + NB2;              // NB scatter factors / values
constexpr int O_FQ = O_FA + NB;
constexpr int O_LG = O_FQ + NB;               // NG2 ng lam, t, mask, d
constexpr int O_TG = O_LG + NG2;
constexpr int O_MG = O_TG + NG2;
constexpr int O_DG = O_MG + NG2;
constexpr int O_DTG = O_DG + NG2;             // NG2 ng dt, dl, candidates,
constexpr int O_DLG = O_DTG + NG2;            //   centering stream
constexpr int O_CPG = O_DLG + NG2;
constexpr int O_COG = O_CPG + NG2;
constexpr int O_QG = O_COG + NG2;             // NG Qx, qx of the ng fold
constexpr int O_QXG = O_QG + NG;
constexpr int O_C = O_QXG + NG;               // (NG, NZ) ng rows
constexpr int O_LS = O_C + NG * NZ;           // NS4 soft lam, t
constexpr int O_TS = O_LS + NS4;
constexpr int O_MS = O_TS + NS4;              // NSA soft mask
constexpr int O_SC = O_MS + NSA;              // 6 NSA soft constants
constexpr int O_DTS = O_SC + 6 * NSA;         // NS4 soft dt, dl, candidates
constexpr int O_DLS = O_DTS + NS4;
constexpr int O_CPS = O_DLS + NS4;
constexpr int O_FS = O_CPS + NS4;             // NSA soft scatter factors
constexpr int O_QS = O_FS + NSA;
constexpr int O_RED = O_QS + NSA;             // 4 amin, s0, s1, s2
constexpr int SLAB = O_RED + 4;

// rows of per-instance scratch, in the order the kernel carves them:
// dz2, dpi2, dt2, dl2, dta, dla, co, ll, eu, px, lxx, pb, the five ng
// direction slabs, and the five soft ones (dta_s, dla_s, dl2c_s, dt2_s,
// dl2_s); instance-major: instance b's rows start at b * work_rows
__host__ __device__ inline int64_t work_rows(int64_t N, int64_t n_ng) {
  return (N + 1) * NZ + N * NX + 5 * (N + 1) * NB2 + (N + 1) * NZ * NU +
         (N + 1) * NU + (N + 1) * NX + (N + 1) * NTX + N * NX +
         5 * n_ng * NG2 + 5 * (N + 1) * 4 * NS;
}

using TM = hp::Team<TEAM>;
__host__ __device__ constexpr int chunks(int n) { return TM::chunks(n); }
using hp::fma_rn;
using hp::mul_rn;

// One soft row k's slack Schur elimination (csrc/stage_math.cuh
// soft_schur, the entries of row k: families f = 0..3 are the slots
// f NS + k), rounded as the one-thread kernel rounds each entry.  Its
// products lamt enter two sums as addends; nvcc contracted them there in
// none of the rows but one: in the barrier fold (FOLD) the last row's
// lamt of family 3 into Zl1's sum.  The sums are therefore written with
// explicit roundings, so that no heuristic of the compiler decides them.
template <typename T>
struct SoftRow {
  T m, t_inv[4], lamt[4];
  T rqx0, rqx1, Zl0, Zl1, zl0, zl1, dlbs, dubs;
};

template <bool FOLD, typename T>
__device__ __forceinline__ void soft_row(int k, const T* ls, const T* ts,
                                         const T* ms, const T* c,
                                         SoftRow<T>& S) {
  const T m = ms[k];
  S.m = m;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const T rec = T(1) / (m > T(0) ? ts[f * NS + k] : T(1));
    S.t_inv[f] = mul_rn(rec, m);
    S.lamt[f] = mul_rn(ls[f * NS + k], S.t_inv[f]);
  }
  const bool on = ms[k] > T(0);
  S.dlbs = c[k];
  S.dubs = c[NS + k];
  S.rqx0 = ls[k] + S.lamt[0] * S.dlbs;
  S.rqx1 = ls[NS + k] - S.lamt[1] * S.dubs;
  const T s1 = c[3 * NS + k] + S.lamt[1];
  const T z1 = FOLD && k == NS - 1 ? fma_rn(ls[3 * NS + k], S.t_inv[3], s1)
                                   : s1 + S.lamt[3];
  S.Zl0 = on ? T(1) / (c[2 * NS + k] + S.lamt[0] + S.lamt[2]) : T(0);
  S.Zl1 = on ? T(1) / z1 : T(0);
  S.zl0 = -c[4 * NS + k] + S.rqx0 + ls[2 * NS + k];
  S.zl1 = -c[5 * NS + k] + S.rqx1 + ls[3 * NS + k];
}

// soft_qx of row k: (Qx, qx) = (qa ms, qb ms); returns qa, qb
template <typename T>
__device__ __forceinline__ void soft_qx_row(const SoftRow<T>& S, T& qa,
                                            T& qb) {
  const T rQx0 = S.lamt[0], rQx1 = S.lamt[1];
  const T rqx0e = S.rqx0 - rQx0 * S.zl0 * S.Zl0;
  const T rqx1e = S.rqx1 - rQx1 * S.zl1 * S.Zl1;
  const T rQx0e = fma_rn(-mul_rn(rQx0, rQx0), S.Zl0, rQx0);
  const T rQx1e = fma_rn(-mul_rn(rQx1, rQx1), S.Zl1, rQx1);
  qa = rQx0e + rQx1e;
  qb = rqx1e - rqx0e;
}

// soft_dt_dls of row k (zs gathered and masked; dl0 the centering stream)
template <typename T>
__device__ __forceinline__ void soft_dt_dls_row(
    int k, const T* ls, const T* ts, const SoftRow<T>& S, T zs,
    const T (&dl0)[4], T zl0x, T zl1x, T (&dts)[4], T (&dls)[4]) {
  const T ds_lo = (zl0x - S.lamt[0] * zs) * S.Zl0;
  const T ds_up = (zl1x + S.lamt[1] * zs) * S.Zl1;
  dts[0] = (ds_lo + zs - S.dlbs - ts[k]) * S.m;
  dts[1] = (ds_up - zs + S.dubs - ts[NS + k]) * S.m;
  dts[2] = (ds_lo - ts[2 * NS + k]) * S.m;
  dts[3] = (ds_up - ts[3 * NS + k]) * S.m;
#pragma unroll
  for (int f = 0; f < 4; ++f)
    dls[f] = (dl0[f] - S.lamt[f] * dts[f] - ls[f * NS + k]) * S.m;
}

}  // namespace

// Mirrors _ResidentArgs in hpmpc_tpu_torch/ops/resident_kernel.py.
struct ResidentArgs {
  const void* idx;       // (N+1, NB) int32 box index table
  const void* lam0;      // (N+1, 2NB, B)
  const void* t0;        // (N+1, 2NB, B)
  const void* z0;        // (N+1, NZ, B)
  const void* pi0;       // (N, NX, B)
  const void* base;      // (N+1, NZ, B) gradient g * z_mask
  const void* pdreg;     // (N+1, NZ, B) pad_diag + reg_eps
  const void* H;         // (N+1, NT, B) packed lower triangle
  const void* F;         // (N, NZ, NX, B)
  const void* b;         // (N, NX, B)
  const void* dcat;      // (N+1, 2NB, B) [d_lb; d_ub]
  const void* mb;        // (N+1, 2NB, B) box mask, both halves
  const void* Cg;        // (n_ng, NG, NZ, B) general-constraint rows
  const void* dgg;       // (n_ng, 2NG, B) [d_lg; d_ug]
  const void* mgg;       // (n_ng, 2NG, B)
  const void* lamg0;     // (n_ng, 2NG, B)
  const void* tg0;       // (n_ng, 2NG, B)
  const void* ng_stage;  // (n_ng,) int32 stage of each ng slot
  const void* idxs;      // (N+1, NS) int32 soft coordinate table
  const void* lams0;     // (N+1, 4NS, B) [lo; up; s_lo; s_up]
  const void* ts0;       // (N+1, 4NS, B)
  const void* softc;     // (N+1, 6NS, B) [d_lbs; d_ubs; Z0; Z1; zl0; zl1]
  const void* msk;       // (N+1, NS, B) soft mask
  const void* musc;      // (B,) per-instance 1 / (2 nb + 2 ng + 4 ns)
  void* z;               // (N+1, NZ, B)
  void* pi;              // (N, NX, B)
  void* lam;             // (N+1, 2NB, B)
  void* t;               // (N+1, 2NB, B)
  void* mu;              // (B,)
  void* kk;              // (B,) int32
  void* frozen;          // (B,) int32
  void* stat;            // (K, 5, B)
  void* lamg;            // (n_ng, 2NG, B)
  void* tg;              // (n_ng, 2NG, B)
  void* lams;            // (N+1, 4NS, B)
  void* ts;              // (N+1, 4NS, B)
  void* work;            // (B, work_rows) instance-major scratch
  int64_t B;
  int64_t N;
  int64_t K;
  int64_t n_ng;
  double mu_scal;
  double mu_tol;
  double alpha_min;
  double mu0;
  int exact;             // soft: keep the corrector gradient's correction
};

template <typename T>
__global__ void __launch_bounds__(THREADS) ipm_resident_kernel(ResidentArgs a) {
  using hp::Col;
  using hp::nmax;
  using hp::nmin;
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
  const int K = static_cast<int>(a.K);
  const int n_ng = static_cast<int>(a.n_ng);
  const int* idx = static_cast<const int*>(a.idx);
  const int* ng_stage = static_cast<const int*>(a.ng_stage);
  const int* idxs = static_cast<const int*>(a.idxs);
  auto sync = [&] { __syncwarp(mask); };
  const int* idxs_k = idxs;  // a stage's row of the soft table

  T* const sh = reinterpret_cast<T*>(smem_raw) + tw * SLAB;
  T* const sM = sh + O_M;
  T* const sF = sh + O_F;
  T* const sLc = sh + O_LC;
  T* const sLl = sh + O_LL;
  T* const sG = sh + O_G;
  T* const sMv = sh + O_MV;
  T* const sZt = sh + O_ZT;
  T* const sPxc = sh + O_PXC;
  T* const sPb = sh + O_PB;
  T* const sT1 = sh + O_T1;
  T* const sPxv = sh + O_PXV;
  T* const sBb = sh + O_BB;
  T* const sEu = sh + O_EU;
  T* const sDi = sh + O_DI;
  T* const sH = sh + O_H;
  T* const sLx = sh + O_LX;
  T* const sLam = sh + O_LAM;
  T* const sT = sh + O_T;
  T* const sMb = sh + O_MB;
  T* const sA = sh + O_A;
  T* const sDt = sh + O_DT;
  T* const sDl = sh + O_DL;
  T* const sCp = sh + O_CP;
  T* const sCo = sh + O_CO;
  T* const sFa = sh + O_FA;
  T* const sFq = sh + O_FQ;
  T* const sLg = sh + O_LG;
  T* const sTg = sh + O_TG;
  T* const sMg = sh + O_MG;
  T* const sDg = sh + O_DG;
  T* const sDtg = sh + O_DTG;
  T* const sDlg = sh + O_DLG;
  T* const sCpg = sh + O_CPG;
  T* const sCog = sh + O_COG;
  T* const sQg = sh + O_QG;
  T* const sQxg = sh + O_QXG;
  T* const sC = sh + O_C;
  T* const sLs = sh + O_LS;
  T* const sTs = sh + O_TS;
  T* const sMs = sh + O_MS;
  T* const sSc = sh + O_SC;
  T* const sDts = sh + O_DTS;
  T* const sDls = sh + O_DLS;
  T* const sCps = sh + O_CPS;
  T* const sFs = sh + O_FS;
  T* const sQs = sh + O_QS;
  T* const sRed = sh + O_RED;

  auto in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + bi, B};
  };
  auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + bi, B}; };
  const Col<const T> lam0 = in(a.lam0), t0 = in(a.t0), z0 = in(a.z0),
                     pi0 = in(a.pi0), basec = in(a.base),
                     pdregc = in(a.pdreg), Hc = in(a.H), Fc = in(a.F),
                     bc = in(a.b), dcatc = in(a.dcat), mbc = in(a.mb),
                     Cgc = in(a.Cg), dggc = in(a.dgg), mggc = in(a.mgg),
                     lamg0 = in(a.lamg0), tg0 = in(a.tg0);
  const Col<T> z = out(a.z), pi = out(a.pi), lam = out(a.lam), t = out(a.t),
               stat = out(a.stat), lamg = out(a.lamg), tg = out(a.tg);
  const Col<const T> lams0 = in(a.lams0), ts0 = in(a.ts0),
                     softcc = in(a.softc), mskc = in(a.msk);
  const Col<T> lams = out(a.lams), ts = out(a.ts);

  T* w = static_cast<T*>(a.work) + bi * work_rows(N, n_ng);
  int64_t off = 0;
  auto take = [&](int64_t rows) {
    Col<T> c{w + off, 1};
    off += rows;
    return c;
  };
  const Col<T> dz2 = take((N + 1) * NZ), dpi2 = take(N * NX),
               dt2 = take((N + 1) * NB2), dl2 = take((N + 1) * NB2),
               dta = take((N + 1) * NB2), dla = take((N + 1) * NB2),
               cor = take((N + 1) * NB2), lls = take((N + 1) * NZ * NU),
               eus = take((N + 1) * NU), pxs = take((N + 1) * NX),
               lxxs = take((N + 1) * NTX), pbs = take(N * NX),
               dtag = take(n_ng * NG2), dlag = take(n_ng * NG2),
               cog = take(n_ng * NG2), dt2g = take(n_ng * NG2),
               dl2g = take(n_ng * NG2);
  const int64_t srows = (N + 1) * 4 * NS;
  const Col<T> dtas = take(srows), dlas = take(srows), dl2cs = take(srows),
               dt2s = take(srows), dl2s = take(srows);

  auto ng_slot = [&](int n) {
    for (int j = 0; j < n_ng; ++j)
      if (ng_stage[j] == n) return j;
    return -1;
  };
  // slab loads of a stage, split over the lanes (team_copy)
  auto rows_of = [&](const auto& col, int64_t r0) {
    return [=](int e) { return col(r0 + e); };
  };
  // a stage's box, Ll, F and soft streams in registers (fetch), then in
  // the slab (put)
  struct BoxB {
    T l[chunks(NB2)], t[chunks(NB2)], m[chunks(NB2)], a[chunks(NB2)];
  };
  struct LlB {
    T l[chunks(NZ * NU)], e[chunks(NU)];
  };
  struct FB {
    T f[chunks(NZ * NX)], b[chunks(NX)];
  };
  struct SoftB {
    T l[chunks(NS4)], t[chunks(NS4)], m[chunks(NSA)], c[chunks(6 * NSA)];
  };
  auto box_fetch = [&](int n, BoxB& b) {
    const int64_t r0 = static_cast<int64_t>(n) * NB2;
    TM::fetch<NB2>(r, b.l, rows_of(lam, r0));
    TM::fetch<NB2>(r, b.t, rows_of(t, r0));
    TM::fetch<NB2>(r, b.m, rows_of(mbc, r0));
    TM::fetch<NB2>(r, b.a, rows_of(dcatc, r0));
  };
  auto box_put = [&](const BoxB& b) {
    TM::put<NB2>(r, sLam, b.l);
    TM::put<NB2>(r, sT, b.t);
    TM::put<NB2>(r, sMb, b.m);
    TM::put<NB2>(r, sA, b.a);
  };
  auto ll_fetch = [&](int n, LlB& b) {
    TM::fetch<NZ * NU>(r, b.l, rows_of(lls, static_cast<int64_t>(n) * NZ * NU));
    TM::fetch<NU>(r, b.e, rows_of(eus, static_cast<int64_t>(n) * NU));
  };
  auto ll_put = [&](const LlB& b) {
    TM::put<NZ * NU>(r, sLl, b.l);
    TM::put<NU>(r, sEu, b.e);
  };
  auto f_fetch = [&](int n, FB& b) {
    TM::fetch<NZ * NX>(r, b.f, rows_of(Fc, static_cast<int64_t>(n) * NZ * NX));
    TM::fetch<NX>(r, b.b, rows_of(bc, static_cast<int64_t>(n) * NX));
  };
  auto f_put = [&](const FB& b) {
    TM::put<NZ * NX>(r, sF, b.f);
    TM::put<NX>(r, sBb, b.b);
  };
  auto soft_fetch = [&](int n, SoftB& b) {
    TM::fetch<NS4>(r, b.l, rows_of(lams, static_cast<int64_t>(n) * NS4));
    TM::fetch<NS4>(r, b.t, rows_of(ts, static_cast<int64_t>(n) * NS4));
    TM::fetch<NSA>(r, b.m, rows_of(mskc, static_cast<int64_t>(n) * NSA));
    TM::fetch<6 * NSA>(r, b.c,
                       rows_of(softcc, static_cast<int64_t>(n) * 6 * NSA));
  };
  auto soft_put = [&](const SoftB& b) {
    TM::put<NS4>(r, sLs, b.l);
    TM::put<NS4>(r, sTs, b.t);
    TM::put<NSA>(r, sMs, b.m);
    TM::put<6 * NSA>(r, sSc, b.c);
  };

  auto load_ng = [&](int j) {
    const int64_t r0 = static_cast<int64_t>(j) * NG2;
    TM::copy<NG2>(r, sLg, rows_of(lamg, r0));
    TM::copy<NG2>(r, sTg, rows_of(tg, r0));
    TM::copy<NG2>(r, sMg, rows_of(mggc, r0));
    TM::copy<NG2>(r, sDg, rows_of(dggc, r0));
    TM::copy<NG * NZ>(r, sC, rows_of(Cgc, static_cast<int64_t>(j) * NG * NZ));
  };
  auto load_lxx = [&](int n) {  // the packed lower triangle into sLx
    TM::copy<NTX>(r, sLx, rows_of(lxxs, static_cast<int64_t>(n) * NTX));
  };
  // x0 = -(Lxx Lxx')^{-1} px (hp::root_x0) on stage 0's slab rows, in
  // every lane; the result into the x buffer 0
  auto root_x0 = [&] {
    sync();
    load_lxx(0);
    TM::copy<NX>(r, sT1, rows_of(pxs, 0));
    sync();
    hp::root_x0<TEAM, T, NX>(
        r, [&](int i, int j) { return sLx[sym_idx(i, j)]; }, sT1, sh + O_X);
  };
  // the box direction of ng row g (hp::dt_dlam, as hp::box_dir) with its
  // constraint value cz
  auto ng_dir = [&](int g, T cz, T dl0_lo, T dl0_up) {
    const T dt_lo = ((cz - sDg[g]) - sTg[g]) * sMg[g];
    const T dt_up = ((sDg[NG + g] - cz) - sTg[NG + g]) * sMg[NG + g];
    T ti, lt_lo, lt_up;
    hp::t_inv_lamt(sLg[g], sTg[g], sMg[g], ti, lt_lo);
    hp::t_inv_lamt(sLg[NG + g], sTg[NG + g], sMg[NG + g], ti, lt_up);
    const T dl_lo = (dl0_lo - lt_lo * dt_lo - sLg[g]) * sMg[g];
    const T dl_up = (dl0_up - lt_up * dt_up - sLg[NG + g]) * sMg[NG + g];
    sDtg[g] = dt_lo;
    sDtg[NG + g] = dt_up;
    sDlg[g] = dl_lo;
    sDlg[NG + g] = dl_up;
    sCpg[g] = hp::cand_pair(sLg[g], sTg[g], sMg[g], dt_lo, dl_lo);
    sCpg[NG + g] = hp::cand_pair(sLg[NG + g], sTg[NG + g], sMg[NG + g],
                                 dt_up, dl_up);
  };
  // C z of ng row g (its sequential chain)
  auto cz_of = [&](int g) {
    T acc = sC[g * NZ] * sZt[0];
#pragma unroll
    for (int i = 1; i < NZ; ++i) acc = acc + sC[g * NZ + i] * sZt[i];
    return acc;
  };
  // the soft direction of row k into the slab with its candidate pairs;
  // dl0 / zl0x / zl1x as hp::soft_dt_dls takes them (CORR: the corrector's
  // dl2c stream, in dc)
  auto soft_dir = [&](int k, const T (&dc)[4], bool corr, T (&dts)[4],
                      T (&dls)[4]) {
    SoftRow<T> S;
    soft_row<false, T>(k, sLs, sTs, sMs, sSc, S);
    const T zs = hp::gather<T, NZ>(sZt, idxs_k[k]) * sMs[k];
    const T zero4[4] = {T(0), T(0), T(0), T(0)};
    if (corr) {
      const T zl0x = S.zl0 + dc[0] + dc[2];
      const T zl1x = S.zl1 + dc[1] + dc[3];
      soft_dt_dls_row<T>(k, sLs, sTs, S, zs, dc, zl0x, zl1x, dts, dls);
    } else {
      soft_dt_dls_row<T>(k, sLs, sTs, S, zs, zero4, S.zl0, S.zl1, dts, dls);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int i = f * NS + k;
      sDts[i] = dts[f];
      sDls[i] = dls[f];
      sCps[i] = hp::cand_pair(sLs[i], sTs[i], S.m, dts[f], dls[f]);
    }
  };

  // ---- one-time init -----------------------------------------------------
  for (int64_t e = r; e < (N + 1) * NZ; e += TEAM) {
    z(e) = z0(e);
    dz2(e) = T(0);
  }
  for (int64_t e = r; e < (N + 1) * NB2; e += TEAM) {
    lam(e) = lam0(e);
    t(e) = t0(e);
    dt2(e) = T(0);
    dl2(e) = T(0);
  }
  for (int64_t e = r; e < static_cast<int64_t>(N) * NX; e += TEAM) {
    pi(e) = pi0(e);
    dpi2(e) = T(0);
  }
  for (int64_t e = r; e < static_cast<int64_t>(n_ng) * NG2; e += TEAM) {
    lamg(e) = lamg0(e);
    tg(e) = tg0(e);
    dt2g(e) = T(0);
    dl2g(e) = T(0);
  }
  for (int64_t e = r; e < static_cast<int64_t>(K) * 5; e += TEAM)
    stat(e) = T(0);
  for (int64_t e = r; e < srows; e += TEAM) {
    lams(e) = lams0(e);
    ts(e) = ts0(e);
    dt2s(e) = T(0);
    dl2s(e) = T(0);
  }
  sync();

  const T BIG = T(3.0e38);
  const T mu_tol = T(a.mu_tol), alpha_min = T(a.alpha_min),
          mu_scal = NS > 0 ? in(a.musc)(0) : T(a.mu_scal);
  T a2p = T(0), mu = T(a.mu0), lamref = BIG;
  int frz = 0, kk = 0;

  for (int it = 0; it <= K; ++it) {
    const bool live = frz == 0 && mu > mu_tol;
    const bool work = live && it < K;

    // ---- phase 0: pending update (stage k), barrier fold + factor --------
    for (int s = 0; s <= N; ++s) {
      const int k = N - s;
      const int jg = ng_slot(k);
      const bool upd = a2p > T(0);
      const int64_t rz = static_cast<int64_t>(k) * NZ;
      const int64_t rb = static_cast<int64_t>(k) * NB2;
      const int64_t rs = static_cast<int64_t>(k) * NS4;
      const int64_t rg = static_cast<int64_t>(jg) * NG2;
      if (!work) {
        // the last pending update
        if (upd) {
          T* none = nullptr;
          TM::update<NZ, true>(r, a2p, z, dz2, rz, none);
          TM::update<NB2, false>(r, a2p, lam, dl2, rb, none);
          TM::update<NB2, false>(r, a2p, t, dt2, rb, none);
          if constexpr (NS > 0) {
            TM::update<NS4, false>(r, a2p, lams, dl2s, rs, none);
            TM::update<NS4, false>(r, a2p, ts, dt2s, rs, none);
          }
          if (k >= 1)
            TM::update<NX, true>(r, a2p, pi, dpi2,
                                  static_cast<int64_t>(k - 1) * NX, none);
          if (jg >= 0) {
            TM::update<NG2, false>(r, a2p, lamg, dl2g, rg, none);
            TM::update<NG2, false>(r, a2p, tg, dt2g, rg, none);
          }
        }
        continue;
      }

      sync();  // the previous stage's slab reads are done
      const int* ik = idx + k * NB;
      idxs_k = idxs + k * NS;
      const int ke = k < N - 1 ? k : N - 1;
      // stage k's streams and the pending update's rows, all fetched before
      // any store; then the update (the new multipliers and slacks are
      // also the slab's) and the slab's stores
      BoxB bx;
      SoftB sb;
      FB fb;
      T hb[chunks(NT)];
      T zv[chunks(NZ)], dzv[chunks(NZ)], pv[chunks(NX)], dpv[chunks(NX)];
      T dlv[chunks(NB2)], dtv[chunks(NB2)];
      T dlsv[chunks(NS4)], dtsv[chunks(NS4)];
      const int64_t rp = static_cast<int64_t>(k - 1) * NX;
      box_fetch(k, bx);
      if (upd) {
        TM::fetch<NZ>(r, zv, rows_of(z, rz));
        TM::fetch<NZ>(r, dzv, rows_of(dz2, rz));
        TM::fetch<NB2>(r, dlv, rows_of(dl2, rb));
        TM::fetch<NB2>(r, dtv, rows_of(dt2, rb));
        if (k >= 1) {
          TM::fetch<NX>(r, pv, rows_of(pi, rp));
          TM::fetch<NX>(r, dpv, rows_of(dpi2, rp));
        }
      }
      if constexpr (NS > 0) {
        soft_fetch(k, sb);
        if (upd) {
          TM::fetch<NS4>(r, dlsv, rows_of(dl2s, rs));
          TM::fetch<NS4>(r, dtsv, rows_of(dt2s, rs));
        }
      }
      f_fetch(ke, fb);
      TM::fetch<NT>(r, hb, rows_of(Hc, static_cast<int64_t>(k) * NT));
      if (upd) {
#pragma unroll
        for (int c = 0; c < chunks(NZ); ++c) {
          const int e = r + c * TEAM;
          if (e < NZ) z(rz + e) = zv[c] + a2p * (dzv[c] - zv[c]);
        }
#pragma unroll
        for (int c = 0; c < chunks(NB2); ++c) {
          const int e = r + c * TEAM;
          if (e < NB2) {
            bx.l[c] = bx.l[c] + a2p * dlv[c];
            bx.t[c] = bx.t[c] + a2p * dtv[c];
            lam(rb + e) = bx.l[c];
            t(rb + e) = bx.t[c];
          }
        }
        if (k >= 1) {
#pragma unroll
          for (int c = 0; c < chunks(NX); ++c) {
            const int e = r + c * TEAM;
            if (e < NX) pi(rp + e) = pv[c] + a2p * (dpv[c] - pv[c]);
          }
        }
      }
      box_put(bx);
      if constexpr (NS > 0) {
        if (upd) {
#pragma unroll
          for (int c = 0; c < chunks(NS4); ++c) {
            const int e = r + c * TEAM;
            if (e < NS4) {
              sb.l[c] = sb.l[c] + a2p * dlsv[c];
              sb.t[c] = sb.t[c] + a2p * dtsv[c];
              lams(rs + e) = sb.l[c];
              ts(rs + e) = sb.t[c];
            }
          }
        }
        soft_put(sb);
      }
      f_put(fb);
      TM::put<NT>(r, sH, hb);
      if (jg >= 0) {
        if (upd) {
          TM::update<NG2, false>(r, a2p, lamg, dl2g, rg, sLg);
          TM::update<NG2, false>(r, a2p, tg, dt2g, rg, sTg);
        } else {
          TM::copy<NG2>(r, sLg, rows_of(lamg, rg));
          TM::copy<NG2>(r, sTg, rows_of(tg, rg));
        }
        TM::copy<NG2>(r, sMg, rows_of(mggc, rg));
        TM::copy<NG2>(r, sDg, rows_of(dggc, rg));
        TM::copy<NG * NZ>(r, sC,
                           rows_of(Cgc, static_cast<int64_t>(jg) * NG * NZ));
      }
      if (s == 0) {
        // terminal stage: zero carry, so the interior formulas collapse
        // exactly to the terminal ones
        for (int e = r; e < NX * NX; e += TEAM) sLc[e] = T(0);
        for (int e = r; e < NX; e += TEAM) sPxc[e] = T(0);
      }
      sync();
      // the box fold of pair i (hp::qx_fold): Qx = sFa mb, qx = sFq mb
      for (int i = r; i < NB; i += TEAM) {
        T ti_lo, lt_lo, ti_up, lt_up;
        hp::t_inv_lamt(sLam[i], sT[i], sMb[i], ti_lo, lt_lo);
        hp::t_inv_lamt(sLam[NB + i], sT[NB + i], sMb[NB + i], ti_up, lt_up);
        const T q_lo = -sLam[i] - lt_lo * sA[i];
        const T q_up = sLam[NB + i] - lt_up * sA[NB + i];
        sFa[i] = lt_lo + lt_up;
        sFq[i] = q_lo + q_up;
      }
      if constexpr (NS > 0) {
        // the soft Schur fold of row q: Qs = sFs ms, qs = sQs ms
        for (int q = r; q < NS; q += TEAM) {
          SoftRow<T> S;
          soft_row<true, T>(q, sLs, sTs, sMs, sSc, S);
          soft_qx_row<T>(S, sFs[q], sQs[q]);
        }
      }
      if (jg >= 0) {
        // the ng fold (hp::qx_fold<NG>): products, read as multiplicands
        for (int g = r; g < NG; g += TEAM) {
          T ti_lo, lt_lo, ti_up, lt_up;
          hp::t_inv_lamt(sLg[g], sTg[g], sMg[g], ti_lo, lt_lo);
          hp::t_inv_lamt(sLg[NG + g], sTg[NG + g], sMg[NG + g], ti_up, lt_up);
          const T q_lo = -sLg[g] - lt_lo * sDg[g];
          const T q_up = sLg[NG + g] - lt_up * sDg[NG + g];
          sQg[g] = (lt_lo + lt_up) * sMg[g];
          sQxg[g] = (q_lo + q_up) * sMg[g];
        }
      }
      sync();
      // row c: the barrier diagonal onto M, the gradient (scatters in the
      // order of hp::scatter_add_box: box slots, then soft slots)
      int ib[NB], is[NSA];
#pragma unroll
      for (int q = 0; q < NB; ++q) ib[q] = ik[q];
#pragma unroll
      for (int q = 0; q < NSA; ++q) is[q] = NS > 0 ? idxs_k[q] : -1;
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
        T dvc = pdregc(static_cast<int64_t>(k) * NZ + c);
#pragma unroll
        for (int q = 0; q < NB; ++q)
          if (ib[q] == c) dvc = dvc + sFa[q] * sMb[q];
        if constexpr (NS > 0) {
#pragma unroll
          for (int q = 0; q < NS; ++q)
            if (is[q] == c) dvc = dvc + sFs[q] * sMs[q];
        }
        sM[c * NZ + c] = sM[c * NZ + c] + dvc;
        T gec = basec(static_cast<int64_t>(k) * NZ + c);
#pragma unroll
        for (int q = 0; q < NB; ++q)
          if (ib[q] == c) gec = gec + sFq[q] * sMb[q];
        if constexpr (NS > 0) {
#pragma unroll
          for (int q = 0; q < NS; ++q)
            if (is[q] == c) gec = gec + sQs[q] * sMs[q];
        }
        if (jg >= 0) {
          // general-constraint barrier: M += C' diag(Qxg) C, g += C' qxg
          for (int jj = 0; jj <= c; ++jj) {
            T acc = sC[c] * sQg[0] * sC[jj];
#pragma unroll
            for (int g = 1; g < NG; ++g)
              acc = acc + sC[g * NZ + c] * sQg[g] * sC[g * NZ + jj];
            sM[c * NZ + jj] = sM[c * NZ + jj] + acc;
          }
          T acc = sC[c] * sQxg[0];
#pragma unroll
          for (int g = 1; g < NG; ++g) acc = acc + sC[g * NZ + c] * sQxg[g];
          gec = gec + acc;
        }
        sG[c] = gec;
      }
      // folded backward Riccati stage (hp::folded_bwd_core, team.cuh);
      // Pb of stage k (< N) couples it to stage k+1: the terminal Pb is 0
      TM::folded_core<T, NU, NX>(
          r, sync, sM, sF, sLc, sBb, sPxc, sG, sT1, sPb, sMv, sDi,
          [&](int i, T v) {
            if (k < N) pbs(static_cast<int64_t>(k) * NX + i) = v;
          });
      T Dinv_u[NU], eu[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) Dinv_u[i] = sDi[i];
      hp::eu_of_m<T, NU>(sMv, sM, NZ, Dinv_u, eu);
      // px = m_x - Lxu eu; the carry (Lxx block, px); the factor streams
      for (int i = r; i < NX; i += TEAM) {
        T acc = sMv[NU + i];
#pragma unroll
        for (int q = 0; q < NU; ++q) acc = acc - sM[(NU + i) * NZ + q] * eu[q];
        pxs(static_cast<int64_t>(k) * NX + i) = acc;
        sPxc[i] = acc;
      }
      for (int i = r; i < NZ; i += TEAM) {
#pragma unroll
        for (int j = 0; j < NU; ++j)
          lls((static_cast<int64_t>(k) * NZ + i) * NU + j) =
              j <= i ? sM[i * NZ + j] : T(0);
        if (i >= NU) {
          const int xi = i - NU;
          for (int j = 0; j <= xi; ++j) {
            const T v = sM[i * NZ + NU + j];
            lxxs(static_cast<int64_t>(k) * NTX + sym_idx(xi, j)) = v;
            sLc[xi * NX + j] = v;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NU; ++j)
        if (j % TEAM == r) eus(static_cast<int64_t>(k) * NU + j) = eu[j];
    }
    a2p = T(0);
    if (!work) break;  // an instance that is not live never becomes live

    // ---- phase 1: affine forward + alpha / mu(alpha) partials -----------
    T amin = BIG, s0 = T(0), s1 = T(0), s2 = T(0);
    root_x0();
    for (int s = 0; s <= N; ++s) {
      const T* x = sh + O_X + (s & 1) * NX;
      T* xn = sh + O_X + ((s & 1) ^ 1) * NX;
      sync();
      const int* ik = idx + s * NB;
      idxs_k = idxs + s * NS;
      const int jg = ng_slot(s);
      {
        BoxB bx;
        LlB lb;
        FB fb;
        SoftB sb;
        ll_fetch(s, lb);
        box_fetch(s, bx);
        if constexpr (NS > 0) soft_fetch(s, sb);
        f_fetch(s < N - 1 ? s : N - 1, fb);
        ll_put(lb);
        box_put(bx);
        if constexpr (NS > 0) soft_put(sb);
        f_put(fb);
      }
      if (jg >= 0) load_ng(jg);
      sync();
      T u[NU];
      hp::u_of_x<T, NU, NX>(sLl, sEu, x, u);
#pragma unroll
      for (int i = 0; i < NU; ++i)
        if (i % TEAM == r) sZt[i] = u[i];
      for (int i = r; i < NX; i += TEAM) sZt[NU + i] = x[i];
      sync();
      hp::x_next<TEAM, T, NZ, NX>(r, sBb, sF, sZt, xn);
      for (int i = r; i < NB; i += TEAM) {
        hp::box_dir<T, NB>(i, hp::gather<T, NZ>(sZt, ik[i]), T(0), T(0),
                           sLam, sT, sMb, sA, sDt, sDl, sCp);
        const int64_t r0 = static_cast<int64_t>(s) * NB2;
        dta(r0 + i) = sDt[i];
        dta(r0 + NB + i) = sDt[NB + i];
        dla(r0 + i) = sDl[i];
        dla(r0 + NB + i) = sDl[NB + i];
      }
      if constexpr (NS > 0) {
        // the soft affine direction against zl, its alpha and mu terms
        for (int q = r; q < NS; q += TEAM) {
          const T none[4] = {T(0), T(0), T(0), T(0)};
          T dts[4], dls[4];
          soft_dir(q, none, false, dts, dls);
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int64_t rr = static_cast<int64_t>(s) * NS4 + f * NS + q;
            dtas(rr) = dts[f];
            dlas(rr) = dls[f];
          }
        }
      }
      if (jg >= 0) {
        for (int g = r; g < NG; g += TEAM) {
          ng_dir(g, cz_of(g), T(0), T(0));
          const int64_t r0 = static_cast<int64_t>(jg) * NG2;
          dtag(r0 + g) = sDtg[g];
          dtag(r0 + NG + g) = sDtg[NG + g];
          dlag(r0 + g) = sDlg[g];
          dlag(r0 + NG + g) = sDlg[NG + g];
        }
      }
      sync();
      if (r == 0) {
        hp::alpha_chain<T, NB2, NB2>(sLam, sT, sMb, sDt, sDl, sCp, amin, s0,
                                     s1, s2);
        if constexpr (NS > 0)
          hp::alpha_chain<T, NS4, NSA>(
              sLs, sTs, sMs, sDts, sDls, sCps, amin, s0, s1, s2);
        if (jg >= 0)
          hp::alpha_chain<T, NG2, NG2>(
              sLg, sTg, sMg, sDtg, sDlg, sCpg, amin, s0, s1, s2);
      }
    }
    if (r == 0) {
      sRed[0] = amin;
      sRed[1] = s0;
      sRed[2] = s1;
      sRed[3] = s2;
    }
    sync();
    amin = sRed[0];
    s0 = sRed[1];
    s1 = sRed[2];
    s2 = sRed[3];
    const T alpha_aff = nmin(T(1), amin);
    const T aa = T(0.995) * alpha_aff;
    const T mu_aff = (s0 + aa * s1 + aa * aa * s2) * mu_scal;
    const T ratio = mu_aff / (mu > T(0) ? mu : T(1));
    const T sigma = ratio * ratio * ratio;
    const T sm = sigma * mu;

    // ---- phase 2: corrector gradient + retained-factor solve ------------
    for (int s = 0; s <= N; ++s) {
      const int k = N - s;
      sync();
      const int* ik = idx + k * NB;
      idxs_k = idxs + k * NS;
      const int jg = ng_slot(k);
      const int ke = k < N - 1 ? k : N - 1;
      {
        BoxB bx;
        LlB lb;
        FB fb;
        SoftB sb;
        T dtb[chunks(NB2)], dlb[chunks(NB2)];
        T dtsb[chunks(NS4)], dlsb[chunks(NS4)];
        const int64_t rb = static_cast<int64_t>(k) * NB2;
        const int64_t rs = static_cast<int64_t>(k) * NS4;
        box_fetch(k, bx);
        ll_fetch(k, lb);
        TM::fetch<NB2>(r, dtb, rows_of(dta, rb));
        TM::fetch<NB2>(r, dlb, rows_of(dla, rb));
        if constexpr (NS > 0) {
          soft_fetch(k, sb);
          TM::fetch<NS4>(r, dtsb, rows_of(dtas, rs));
          TM::fetch<NS4>(r, dlsb, rows_of(dlas, rs));
        }
        f_fetch(ke, fb);
        box_put(bx);
        ll_put(lb);
        TM::put<NB2>(r, sDt, dtb);
        TM::put<NB2>(r, sDl, dlb);
        if constexpr (NS > 0) {
          soft_put(sb);
          TM::put<NS4>(r, sDts, dtsb);
          TM::put<NS4>(r, sDls, dlsb);
        }
        f_put(fb);
      }
      if (jg >= 0) {
        load_ng(jg);
        TM::copy<NG2>(r, sDtg, rows_of(dtag, static_cast<int64_t>(jg) * NG2));
        TM::copy<NG2>(r, sDlg, rows_of(dlag, static_cast<int64_t>(jg) * NG2));
      }
      sync();
      // box centering correction and corrected gradient fold of pair i
      // (hp::corr_co_qx): qx ends in a sum, shared as its value
      for (int i = r; i < NB; i += TEAM) {
        T ti_lo, lt_lo, ti_up, lt_up;
        hp::t_inv_lamt(sLam[i], sT[i], sMb[i], ti_lo, lt_lo);
        hp::t_inv_lamt(sLam[NB + i], sT[NB + i], sMb[NB + i], ti_up, lt_up);
        const T co_lo = ti_lo * (sm - sDl[i] * sDt[i]) * sMb[i];
        const T co_up = ti_up * (sm - sDl[NB + i] * sDt[NB + i]) * sMb[NB + i];
        const T q_lo = -sLam[i] - lt_lo * sA[i];
        const T q_up = sLam[NB + i] - lt_up * sA[NB + i];
        const T qx0 = (q_lo + q_up) * sMb[i];
        sFq[i] = qx0 + (co_up - co_lo) * sMb[i];
        const int64_t r0 = static_cast<int64_t>(k) * NB2;
        cor(r0 + i) = co_lo;
        cor(r0 + NB + i) = co_up;
      }
      if constexpr (NS > 0) {
        // the soft centering correction dl2c and the corrected soft fold
        // (hp::soft_corr_fold): exact, a sum (its value); dropped, a
        // product (its factors qb, ms)
        for (int q = r; q < NS; q += TEAM) {
          SoftRow<T> S;
          soft_row<false, T>(q, sLs, sTs, sMs, sSc, S);
          T d[4];
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int i = f * NS + q;
            d[f] = S.t_inv[f] * (sm - sDls[i] * sDts[i]) * S.m;
            dl2cs(static_cast<int64_t>(k) * NS4 + i) = d[f];
          }
          T qa, qb;
          soft_qx_row<T>(S, qa, qb);
          if (a.exact) {
            T qs = qb * S.m;
            const T rqx0c = d[0] - S.lamt[0] * (d[0] + d[2]) * S.Zl0;
            const T rqx1c = d[1] - S.lamt[1] * (d[1] + d[3]) * S.Zl1;
            qs = qs + (rqx1c - rqx0c) * S.m;
            sQs[q] = qs;
          } else {
            sQs[q] = qb;
          }
        }
      }
      if (jg >= 0) {
        for (int g = r; g < NG; g += TEAM) {
          T ti_lo, lt_lo, ti_up, lt_up;
          hp::t_inv_lamt(sLg[g], sTg[g], sMg[g], ti_lo, lt_lo);
          hp::t_inv_lamt(sLg[NG + g], sTg[NG + g], sMg[NG + g], ti_up, lt_up);
          const T co_lo = ti_lo * (sm - sDlg[g] * sDtg[g]) * sMg[g];
          const T co_up =
              ti_up * (sm - sDlg[NG + g] * sDtg[NG + g]) * sMg[NG + g];
          const T q_lo = -sLg[g] - lt_lo * sDg[g];
          const T q_up = sLg[NG + g] - lt_up * sDg[NG + g];
          const T qx0 = (q_lo + q_up) * sMg[g];
          sQxg[g] = qx0 + (co_up - co_lo) * sMg[g];
          const int64_t r0 = static_cast<int64_t>(jg) * NG2;
          cog(r0 + g) = co_lo;
          cog(r0 + NG + g) = co_up;
        }
      }
      // Pb + px of stage k+1 (the terminal stage: unused)
      for (int i = r; i < NX; i += TEAM)
        sPb[i] = s == 0 ? T(0)
                        : pbs(static_cast<int64_t>(ke) * NX + i) + sPxc[i];
      sync();
      // row c: the corrected gradient, then m = g + F (Pb + px)
      // (hp::trs_stage)
      int ib[NB], is[NSA];
#pragma unroll
      for (int q = 0; q < NB; ++q) ib[q] = ik[q];
#pragma unroll
      for (int q = 0; q < NSA; ++q) is[q] = NS > 0 ? idxs_k[q] : -1;
      for (int c = r; c < NZ; c += TEAM) {
        T gec = basec(static_cast<int64_t>(k) * NZ + c);
#pragma unroll
        for (int q = 0; q < NB; ++q)
          if (ib[q] == c) gec = gec + sFq[q];
        if constexpr (NS > 0) {
          if (a.exact) {
#pragma unroll
            for (int q = 0; q < NS; ++q)
              if (is[q] == c) gec = gec + sQs[q];
          } else {
#pragma unroll
            for (int q = 0; q < NS; ++q)
              if (is[q] == c) gec = gec + sQs[q] * sMs[q];
          }
        }
        if (jg >= 0) {
          T acc = sC[c] * sQxg[0];
#pragma unroll
          for (int g = 1; g < NG; ++g) acc = acc + sC[g * NZ + c] * sQxg[g];
          gec = gec + acc;
        }
        T acc = gec;
        if (s != 0) {
#pragma unroll
          for (int q = 0; q < NX; ++q) acc = acc + sF[c * NX + q] * sPb[q];
        }
        sMv[c] = acc;
      }
      sync();
      T Dinv_u[NU], eu[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i)
        Dinv_u[i] = T(1) / nmax(sLl[i * NU + i], T(1e-30));
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

    // ---- phase 3: corrector forward + alpha + step glue ------------------
    amin = BIG;
    s0 = s1 = s2 = T(0);
    root_x0();
    for (int s = 0; s <= N; ++s) {
      const T* x = sh + O_X + (s & 1) * NX;
      T* xn = sh + O_X + ((s & 1) ^ 1) * NX;
      sync();
      const int* ik = idx + s * NB;
      idxs_k = idxs + s * NS;
      const int jg = ng_slot(s);
      {
        BoxB bx;
        LlB lb;
        FB fb;
        SoftB sb;
        T pxb[chunks(NX)], lxb[chunks(NTX)], cob[chunks(NB2)];
        T dcb[chunks(NS4)];
        ll_fetch(s, lb);
        TM::fetch<NX>(r, pxb, rows_of(pxs, static_cast<int64_t>(s) * NX));
        box_fetch(s, bx);
        TM::fetch<NB2>(r, cob, rows_of(cor, static_cast<int64_t>(s) * NB2));
        if constexpr (NS > 0) {
          soft_fetch(s, sb);
          TM::fetch<NS4>(r, dcb,
                     rows_of(dl2cs, static_cast<int64_t>(s) * NS4));
        }
        f_fetch(s < N - 1 ? s : N - 1, fb);
        if (s >= 1)
          TM::fetch<NTX>(r, lxb,
                     rows_of(lxxs, static_cast<int64_t>(s) * NTX));
        ll_put(lb);
        TM::put<NX>(r, sPxv, pxb);
        box_put(bx);
        TM::put<NB2>(r, sCo, cob);
        if constexpr (NS > 0) {
          soft_put(sb);
          TM::put<NS4>(r, sDls, dcb);
        }
        f_put(fb);
        if (s >= 1) TM::put<NTX>(r, sLx, lxb);
      }
      if (jg >= 0) {
        load_ng(jg);
        TM::copy<NG2>(r, sCog, rows_of(cog, static_cast<int64_t>(jg) * NG2));
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
        dz2(static_cast<int64_t>(s) * NZ + i) = sZt[i];
      if (s >= 1)
        hp::pi_rows<TEAM, T, NX>(r, sLx, sPxv, sT1, [&](int i, T v) {
          dpi2(static_cast<int64_t>(s - 1) * NX + i) = v;
        });
      hp::x_next<TEAM, T, NZ, NX>(r, sBb, sF, sZt, xn);
      for (int i = r; i < NB; i += TEAM) {
        hp::box_dir<T, NB>(i, hp::gather<T, NZ>(sZt, ik[i]), sCo[i],
                           sCo[NB + i], sLam, sT, sMb, sA, sDt, sDl, sCp);
        const int64_t r0 = static_cast<int64_t>(s) * NB2;
        dt2(r0 + i) = sDt[i];
        dt2(r0 + NB + i) = sDt[NB + i];
        dl2(r0 + i) = sDl[i];
        dl2(r0 + NB + i) = sDl[NB + i];
      }
      if constexpr (NS > 0) {
        // the soft corrector direction against zl + the dl2c fold, with
        // dl2c as its centering stream
        for (int q = r; q < NS; q += TEAM) {
          const T dc[4] = {sDls[q], sDls[NS + q], sDls[2 * NS + q],
                           sDls[3 * NS + q]};
          T dts[4], dls[4];
          soft_dir(q, dc, true, dts, dls);
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int64_t rr = static_cast<int64_t>(s) * NS4 + f * NS + q;
            dt2s(rr) = dts[f];
            dl2s(rr) = dls[f];
          }
        }
      }
      if (jg >= 0) {
        for (int g = r; g < NG; g += TEAM) {
          ng_dir(g, cz_of(g), sCog[g], sCog[NG + g]);
          const int64_t r0 = static_cast<int64_t>(jg) * NG2;
          dt2g(r0 + g) = sDtg[g];
          dt2g(r0 + NG + g) = sDtg[NG + g];
          dl2g(r0 + g) = sDlg[g];
          dl2g(r0 + NG + g) = sDlg[NG + g];
        }
      }
      sync();
      if (r == 0) {
        hp::alpha_chain<T, NB2, NB2>(sLam, sT, sMb, sDt, sDl, sCp, amin, s0,
                                     s1, s2);
        if constexpr (NS > 0)
          hp::alpha_chain<T, NS4, NSA>(
              sLs, sTs, sMs, sDts, sDls, sCps, amin, s0, s1, s2);
        if (jg >= 0)
          hp::alpha_chain<T, NG2, NG2>(
              sLg, sTg, sMg, sDtg, sDlg, sCpg, amin, s0, s1, s2);
      }
    }
    if (r == 0) {
      sRed[0] = amin;
      sRed[1] = s0;
      sRed[2] = s1;
      sRed[3] = s2;
    }
    sync();
    amin = sRed[0];
    s0 = sRed[1];
    s1 = sRed[2];
    s2 = sRed[3];
    const T alpha2 = nmin(T(1), amin);
    const T a2 = T(0.995) * alpha2;
    const T mu_new = (s0 + a2 * s1 + a2 * a2 * s2) * mu_scal;
    // max |dual| before and after the would-be update (box + ng): a team
    // max, NaN-propagating in any order
    T lmx_old = T(0), lmx_new = T(0);
    for (int64_t e = r; e < (N + 1) * NB2; e += TEAM) {
      const T l = lam(e);
      lmx_old = nmax(lmx_old, fabs(l));
      lmx_new = nmax(lmx_new, fabs(l + a2 * dl2(e)));
    }
    for (int64_t e = r; e < static_cast<int64_t>(n_ng) * NG2; e += TEAM) {
      const T l = lamg(e);
      lmx_old = nmax(lmx_old, fabs(l));
      lmx_new = nmax(lmx_new, fabs(l + a2 * dl2g(e)));
    }
#pragma unroll
    for (int o = TEAM / 2; o >= 1; o /= 2) {
      lmx_old = nmax(lmx_old, __shfl_xor_sync(mask, lmx_old, o));
      lmx_new = nmax(lmx_new, __shfl_xor_sync(mask, lmx_new, o));
    }
    // breakdown guard (models/ipm.step_ok + anchor_lam_ref): finite mu;
    // below mu 1e-3 no 10x mu growth and no 30x dual growth, per step or
    // against the anchor taken when the instance first crossed 1e-3
    const bool floor_ = mu < T(1e-3);
    const bool anchored = lamref < BIG;
    const bool ok = mu_new == mu_new && fabs(mu_new) < BIG &&
                    !(mu_new > T(10) * mu && floor_) &&
                    !(lmx_new > T(30) * nmax(lmx_old, T(1)) && floor_) &&
                    !(anchored && lmx_new > T(30) * lamref);
    if (ok) {
      if (!anchored && mu_new < T(1e-3)) lamref = nmax(lmx_new, T(1));
      a2p = a2;
      // rows exist only for applied iterations (pre-zeroed otherwise)
      if (r == 0) {
        const int64_t rr = static_cast<int64_t>(it) * 5;
        stat(rr + 0) = sigma;
        stat(rr + 1) = alpha_aff;
        stat(rr + 2) = mu_aff;
        stat(rr + 3) = alpha2;
        stat(rr + 4) = mu_new;
      }
      mu = mu_new;
      kk += 1;
    }
    if (!ok || a2 < alpha_min) frz = 1;
    sync();  // the stat rows and the dual reads before the next updates
  }

  if (r == 0) {
    out(a.mu)(0) = mu;
    Col<int>{static_cast<int*>(a.kk) + bi, B}(0) = kk;
    Col<int>{static_cast<int*>(a.frozen) + bi, B}(0) = frz;
  }
}

template <typename T>
static int launch(const ResidentArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + IPB - 1) / IPB;
  const int64_t smem = static_cast<int64_t>(IPB) * SLAB * sizeof(T);
  const int rc = hp::allow_smem(ipm_resident_kernel<T>, smem);
  if (rc != 0) return rc;
  ipm_resident_kernel<T><<<static_cast<unsigned>(blocks), THREADS,
                           static_cast<size_t>(smem), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hp_ipm_resident(const ResidentArgs* a, int dtype_code,
                               cudaStream_t stream) {
  if (a->B <= 0 || a->N <= 0 || a->K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return launch<float>(*a, stream);
  if (dtype_code == 1) return launch<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int64_t hp_ipm_resident_work_rows(int64_t N, int64_t n_ng) {
  return work_rows(N, n_ng);
}

// The launch shape, for the measurement scripts: lanes an instance and
// threads a block.
extern "C" int hp_ipm_resident_team() { return TEAM; }
extern "C" int hp_ipm_resident_threads() { return THREADS; }

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
