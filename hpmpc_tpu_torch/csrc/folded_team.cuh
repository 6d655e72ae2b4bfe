// The team kernels of the folded backward Riccati factorization + forward
// recovery, shared by row 9 (csrc/factor_solve_flat.cu: the split factor
// of the 6-kernel loop) and rows 16 and 14 (csrc/factor_solve_folded.cu:
// the full factor of the structured route, and its whole-Hessian form).
// A .cu that includes this file defines HP_NU and HP_NX, its arguments
// struct, its I/O policy and thin __global__ kernels over the bodies here.
//
// Design: a team of TEAM lanes per instance (4 to NZ=12, 8 to 24), 32 /
// TEAM instances a one-warp block, lane r owning the rows r, r + TEAM, ...
// of every NZ-row object of a stage and the x indices likewise
// (csrc/team.cuh).  The team's barrier is the warp's (every team of a warp
// runs the same stages in the same order; a team past the batch works on
// its last instance and stores nothing).  Two forms, by dtype and size
// (struct Row9):
//   * the register form (reg_body; f32, and f64 to NZ=11).  Each step's
//     streams come into a two-slot ring in shared memory by cp.async a
//     step ahead, so a stage waits on no load.  Backward, stages N..0:
//     every lane forms Pb = Lc (Lc' b) from the carry (Lc, px) it keeps in
//     registers; the owners form their rows of m = g + F (Pb + px) and W =
//     F Lc into the slab (a barrier), then their rows of M = H (+
//     diag(dvec) + ngl) + W W', every entry of a row formed branch-free and
//     the lower ones kept (a barrier); every lane then reads M and m into
//     registers and runs the Cholesky, eu and px there, so the new carry
//     needs no exchange, and puts the factor, Pb, eu and px into the slab,
//     whose rows the owners store at the next step.  Forward, stages 0..N:
//     x_0 from the root solve of the carry, then per stage u and z in every
//     lane, the owners' rows of x_{s+1} = b + F' z through the slab (a
//     barrier) and, with WANT_PI, of pi_{s-1} = Lxx_s (Lxx_s' x_s) + px_s.
//     A team's lanes do the Cholesky redundantly: one stage's pivots are a
//     serial chain either way, and a column barrier a pivot (the
//     shared-memory form) cost more than the repeated work (PERF.md
//     section 6, PR 18).
//   * the shared-memory form (smem_body; f64 past NZ=11, where the
//     register form spills and is slower): row 19's team
//     (csrc/factor_solve_mega.cu) without its box prep and alpha epilogue.
//     Each stage first fetches all of its streams into registers, then
//     stores them into the per-team slab; the owners assemble their rows
//     of M, then the shared folded stage (team.cuh folded_core: Pb, m, W =
//     F Lc, M += W W', the column Cholesky, a barrier a column) runs, and
//     the owners write their rows of the factor and Pb; the carry stays in
//     the slab.  Forward as above, through the slab (team.cuh root_x0,
//     x_next, pi_t1 / pi_rows).
// eu and px go where the I/O policy puts them (row 9: per-instance,
// instance-major scratch; rows 16/14: their batch-last outputs) and the
// forward sweep reads them back there.  Every entry keeps the one-thread
// kernels' expression and order (hp::folded_bwd_core, root_x0, u_of_x,
// pi_of_x, x_next_of), so the outputs are theirs bit for bit; the sums
// nvcc contracted in one thread are written with explicit roundings
// (team.cuh dot_chain; the Cholesky's scaled column as mul_rn).  Inputs
// and outputs keep their batch-last (rows, B) layout: a row of a stream is
// 32 / TEAM consecutive instances of a warp's load.  Terminal stage: F/b
// clip to N-1 under a zero carry, which collapses the stage to M = H, Pb =
// 0, m = g, as on the TPU; Pb has N rows (the terminal Pb is never
// stored).  The stages of the ng table are distinct (one slot a stage), as
// every caller builds it from the stages with general rows.
//
// The I/O policy IO of a body (an object made per lane as IO(a, bi) from
// the arguments and the lane's instance):
//   IO::WHOLE        the stage's effective Hessian is read whole, its lower
//                    triangle (row 14): no dvec, no ng term; else packed H
//                    + diag(dvec) (+ the packed ng term on its stage);
//   IO::EU_ROWS      eu's rows a stage: NU, or NZ with zeros past NU;
//   IO::STORE_PX     px is stored in the backward sweep (else only with
//                    WANT_PI, which reads it back);
//   IO::LL_ROWS      Ll_s's rows lie apart (row 16: in the full factor),
//                    else Ll_s is one linear block of NZ NU rows (row 9);
//   io.h(k, e)       entry e of stage k's packed lower triangle of H (the
//                    folded form: a linear block, row e at &io.h(k, 0) +
//                    e B);
//   io.ll(s, i, j)   entry (i, j) of Ll_s, at &io.ll(s, i, 0) + j B;
//   io.lxx(s, i, j)  entry (i, j), j <= i, of Lxx_s (pi);
//   io.row(k, i, get)  stores row i of stage k's factor, get(j) giving its
//                    entry (i, j) for j <= i;
//   io.eu(s, j), io.px(s, i)  where eu and px of stage s go, entry j at
//                    &io.eu(s, 0) + j io.eu_stride() (px likewise).
#pragma once

#include "team.cuh"

#if !defined(HP_NU) || !defined(HP_NX)
#error "compile with -DHP_NU=.. -DHP_NX=.."
#endif

namespace {

constexpr int NU = HP_NU;
constexpr int NX = HP_NX;
constexpr int NZ = NU + NX;
constexpr int NT = NZ * (NZ + 1) / 2;
constexpr int NTX = NX * (NX + 1) / 2;

constexpr int THREADS = 32;  // one warp a block

// the shared-memory form's per-team slab, in scalars
constexpr int O_M = 0;                // (NZ, NZ) stage matrix M
constexpr int O_F = O_M + NZ * NZ;    // (NZ, NX) F, then W in place
constexpr int O_LC = O_F + NZ * NX;   // (NX, NX) Lxx carry
constexpr int O_H = O_LC + NX * NX;   // NT packed H (forward: NTX Lxx_s)
constexpr int O_NGL = O_H + NT;       // NT packed ng term of a stage
constexpr int O_LL = O_NGL + NT;      // (NZ, NU) Ll of a stage (forward)
constexpr int O_G = O_LL + NZ * NU;   // NZ gradient
constexpr int O_DV = O_G + NZ;        // NZ barrier diagonal
constexpr int O_MV = O_DV + NZ;       // NZ m
constexpr int O_ZT = O_MV + NZ;       // NZ direction [u; x]
constexpr int O_X = O_ZT + NZ;        // 2 NX x, double-buffered
constexpr int O_PXC = O_X + 2 * NX;   // NX px carry
constexpr int O_PB = O_PXC + NX;      // NX Pb + px carry
constexpr int O_T1 = O_PB + NX;       // NX Lxx' b (forward: Lxx_s' x_s)
constexpr int O_BB = O_T1 + NX;       // NX b
constexpr int O_PX = O_BB + NX;       // NX px_s (forward, pi)
constexpr int O_EU = O_PX + NX;       // NU eu
constexpr int O_DI = O_EU + NU;       // NZ Cholesky pivots
constexpr int SH_SLAB = O_DI + NZ;
static_assert(NTX <= NT, "Lxx_s's packed triangle sits in H's rows");

// the register form's per-team slab, in scalars: a ring of two stage slots
// (copied a step ahead by cp.async; F's rows at stride FS), W's rows, M's
// packed lower triangle and m, x_{s+1}
constexpr int FS = NX + 1;
constexpr int RB_H = 0;                // backward slot: packed H
constexpr int RB_DV = RB_H + NT;       // dvec
constexpr int RB_G = RB_DV + NZ;       // g
constexpr int RB_F = RB_G + NZ;        // F (NZ rows of stride FS)
constexpr int RB_B = RB_F + NZ * FS;   // b
constexpr int RB_NGL = RB_B + NX;      // packed ngl (on an ng stage)
constexpr int RB_END = RB_NGL + NT;
constexpr int RF_LL = 0;               // forward slot: Ll (NZ x NU)
constexpr int RF_EU = RF_LL + NZ * NU; // eu
constexpr int RF_F = RF_EU + NU;       // F (NZ rows of stride FS)
constexpr int RF_B = RF_F + NZ * FS;   // b
constexpr int RF_LX = RF_B + NX;       // packed Lxx_s (pi)
constexpr int RF_PX = RF_LX + NTX;     // px_s (pi)
constexpr int RF_END = RF_PX + NX;
constexpr int R_SLOT = RB_END > RF_END ? RB_END : RF_END;
constexpr int R_W = 2 * R_SLOT;        // W's rows, stride FS
constexpr int R_M = R_W + NZ * FS;     // packed M
constexpr int R_MV = R_M + NT;         // m
constexpr int R_XN = R_MV + NZ;        // x_{s+1}
constexpr int R_Z = R_XN + NX;         // the forward stage's z, 2 buffers
constexpr int R_L = R_Z + 2 * NZ;      // the stage's factor (packed), then:
constexpr int R_LPB = NT;              //   Pb,
constexpr int R_LPX = R_LPB + NX;      //   px,
constexpr int R_LEU = R_LPX + NX;      //   eu (from R_L)
constexpr int R_END = R_L + R_LEU + NU;

// The form by dtype, as measured on the H100 for row 9 (PERF.md section 6,
// `compare_builds --sections forms`): the register form in f32 at every NZ
// of the engine envelope (to 19) and in f64 to NZ=11; past that the f64
// register form spills and the shared-memory form is faster (8% at NZ=12,
// 2.4x at 19).  Lanes an instance: the re-solves' rule (hp::narrow_team),
// so a warp's redundant Cholesky serves 8 instances at the flagship.  A
// slab's stride is TEAM more than a multiple of 32 scalars, so the teams of
// a warp sit on distinct banks.
template <typename T>
struct Row9 {
  static constexpr bool REG = sizeof(T) == 4 || NZ <= 11;
  static constexpr int TEAM = hp::narrow_team(NZ);
  static constexpr int IPB = THREADS / TEAM;  // instances a block
  static constexpr int SLAB =
      REG ? (R_END - TEAM + 31) / 32 * 32 + TEAM : SH_SLAB;
};

// The team's place in its block: its lane r, its instance clamped into the
// batch for loads (bi), and whether it stores (valid).
struct TeamLane {
  int tw, r;
  bool valid;
  int64_t bi;
};

template <typename T>
__device__ __forceinline__ TeamLane team_lane(int64_t B) {
  constexpr int TEAM = Row9<T>::TEAM, IPB = Row9<T>::IPB;
  TeamLane t;
  const int lane = static_cast<int>(threadIdx.x);
  t.tw = lane / TEAM;
  t.r = lane % TEAM;
  // a team past the batch works on its last instance and stores nothing:
  // every team of the warp runs the same stages in the same order, so the
  // team barrier is the warp's (a barrier on one team's lanes alone splits
  // the warp)
  const int64_t bv = static_cast<int64_t>(blockIdx.x) * IPB + t.tw;
  t.valid = bv < B;
  t.bi = t.valid ? bv : B - 1;
  return t;
}

// The shared-memory form: one instance on a team of TEAM lanes (see the
// head comment).  A: the arguments (H, dvec, ngl, ng_stage, g, F, b, Pb,
// z, pi, B, N, n_ng), IO the I/O policy.
template <typename T, bool WANT_PI, bool HAS_NG, typename IO, typename A>
__device__ __forceinline__ void smem_body(const A& a,
                                          unsigned char* smem_raw) {
  using hp::Col;
  using hp::sym_idx;
  constexpr int TEAM = Row9<T>::TEAM;
  using TM = hp::Team<TEAM>;
  const TeamLane tl = team_lane<T>(a.B);
  const int r = tl.r;
  const bool valid = tl.valid;
  const int64_t B = a.B, bi = tl.bi;
  const IO io(a, bi);
  const int N = static_cast<int>(a.N);
  const int n_ng = static_cast<int>(a.n_ng);
  const int* ng_stage = static_cast<const int*>(a.ng_stage);
  auto sync = [] { __syncwarp(); };

  T* const sh = reinterpret_cast<T*>(smem_raw) + tl.tw * Row9<T>::SLAB;
  T* const sM = sh + O_M;
  T* const sF = sh + O_F;
  T* const sLc = sh + O_LC;
  T* const sH = sh + O_H;
  T* const sNgl = sh + O_NGL;
  T* const sLl = sh + O_LL;
  T* const sG = sh + O_G;
  T* const sDv = sh + O_DV;
  T* const sMv = sh + O_MV;
  T* const sZt = sh + O_ZT;
  T* const sPxc = sh + O_PXC;
  T* const sPb = sh + O_PB;
  T* const sT1 = sh + O_T1;
  T* const sBb = sh + O_BB;
  T* const sPx = sh + O_PX;
  T* const sEu = sh + O_EU;
  T* const sDi = sh + O_DI;
  T* const sLx = sH;  // forward: Lxx_s's packed triangle

  auto in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + bi, B};
  };
  auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + bi, B}; };
  const Col<const T> gc = in(a.g), Fc = in(a.F), bc = in(a.b);
  const Col<T> Pbo = out(a.Pb), zo = out(a.z), pio = out(a.pi);

  auto ng_slot = [&](int n) {
    if (!HAS_NG) return -1;
    for (int j = 0; j < n_ng; ++j)
      if (ng_stage[j] == n) return j;
    return -1;
  };
  auto rows_of = [&](const auto& col, int64_t r0) {
    return [=](int e) { return col(r0 + e); };
  };

  // ---- backward: assemble + folded factorization, k = N..0 --------------
  for (int k = N; k >= 0; --k) {
    sync();  // the previous stage's slab reads are done
    const int ke = k < N - 1 ? k : N - 1;
    const int jg = ng_slot(k);
    {
      T hb[TM::chunks(NT)], nb[TM::chunks(NT)], fb[TM::chunks(NZ * NX)];
      T bb[TM::chunks(NX)], db[TM::chunks(NZ)], gb[TM::chunks(NZ)];
      const int64_t rz = static_cast<int64_t>(k) * NZ;
      TM::template fetch<NT>(r, hb, [&](int e) { return io.h(k, e); });
      if (!IO::WHOLE) TM::template fetch<NZ>(r, db, rows_of(in(a.dvec), rz));
      TM::template fetch<NZ>(r, gb, rows_of(gc, rz));
      TM::template fetch<NZ * NX>(r, fb,
                         rows_of(Fc, static_cast<int64_t>(ke) * NZ * NX));
      TM::template fetch<NX>(r, bb, rows_of(bc, static_cast<int64_t>(ke) * NX));
      if (HAS_NG && jg >= 0)
        TM::template fetch<NT>(r, nb,
                      rows_of(in(a.ngl), static_cast<int64_t>(jg) * NT));
      TM::template put<NT>(r, sH, hb);
      if (!IO::WHOLE) TM::template put<NZ>(r, sDv, db);
      TM::template put<NZ>(r, sG, gb);
      TM::template put<NZ * NX>(r, sF, fb);
      TM::template put<NX>(r, sBb, bb);
      if (HAS_NG && jg >= 0) TM::template put<NT>(r, sNgl, nb);
    }
    if (k == N) {
      // terminal stage: zero carry, so the interior formulas collapse
      // exactly to the terminal ones
      for (int e = r; e < NX * NX; e += TEAM) sLc[e] = T(0);
      for (int e = r; e < NX; e += TEAM) sPxc[e] = T(0);
    }
    sync();
    // row c of M: H (whole, or packed + the barrier diagonal + the ng term
    // on its stage)
    for (int c = r; c < NZ; c += TEAM) {
      T mr[NZ];
#pragma unroll
      for (int j = 0; j < NZ; ++j)
        if (j <= c) mr[j] = sH[sym_idx(c, j)];
      if (!IO::WHOLE) mr[c] = mr[c] + sDv[c];
      if (HAS_NG && jg >= 0) {
#pragma unroll
        for (int j = 0; j < NZ; ++j)
          if (j <= c) mr[j] = mr[j] + sNgl[sym_idx(c, j)];
      }
#pragma unroll
      for (int j = 0; j < NZ; ++j)
        if (j <= c) sM[c * NZ + j] = mr[j];
    }
    TM::template folded_core<T, NU, NX>(
        r, sync, sM, sF, sLc, sBb, sPxc, sG, sT1, sPb, sMv, sDi,
        [&](int i, T v) {
          if (valid && k < N) Pbo(static_cast<int64_t>(k) * NX + i) = v;
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
      if ((IO::STORE_PX || WANT_PI) && valid) io.px(k, i) = acc;
    }
    for (int i = r; i < NZ; i += TEAM) {
      if (valid)
        io.row(k, i, [&](int j) { return sM[i * NZ + j]; });
      if (i >= NU) {
        const int xi = i - NU;
#pragma unroll
        for (int j = 0; j < NX; ++j)
          sLc[xi * NX + j] = j <= xi ? sM[i * NZ + NU + j] : T(0);
      }
    }
#pragma unroll
    for (int j = 0; j < IO::EU_ROWS; ++j) {
      if (valid && j % TEAM == r) {
        T v = T(0);
        if (j < NU) v = eu[j < NU ? j : 0];
        io.eu(k, j) = v;
      }
    }
  }

  // ---- forward: x, u, z (and pi), s = 0..N --------------------------------
  sync();  // the carry holds stage 0's Lxx and px
  hp::root_x0<TEAM, T, NX>(
      r, [&](int i, int j) { return sLc[i * NX + j]; }, sPxc, sh + O_X);
  for (int s = 0; s <= N; ++s) {
    const T* x = sh + O_X + (s & 1) * NX;
    T* xn = sh + O_X + ((s & 1) ^ 1) * NX;
    const bool pi_s = WANT_PI && s >= 1;
    sync();
    const int se = s < N - 1 ? s : N - 1;
    {
      T lb[TM::chunks(NZ * NU)], eb[TM::chunks(NU)], fb[TM::chunks(NZ * NX)],
          bb[TM::chunks(NX)], xb[TM::chunks(NTX)], pb[TM::chunks(NX)];
      TM::template fetch<NZ * NU>(r, lb, [&](int e) {
        if constexpr (IO::LL_ROWS)
          return io.ll(s, e / NU, e % NU);
        else
          return (&io.ll(s, 0, 0))[static_cast<int64_t>(e) * B];
      });
      TM::template fetch<NU>(r, eb, [&](int e) { return io.eu(s, e); });
      TM::template fetch<NZ * NX>(r, fb,
                         rows_of(Fc, static_cast<int64_t>(se) * NZ * NX));
      TM::template fetch<NX>(r, bb, rows_of(bc, static_cast<int64_t>(se) * NX));
      if (pi_s) {
        TM::template fetch<NTX>(r, xb, [&](int e) {
          const int i = hp::tril_row<NX>(e);
          return io.lxx(s, i, e - i * (i + 1) / 2);
        });
        TM::template fetch<NX>(r, pb, [&](int e) { return io.px(s, e); });
      }
      TM::template put<NZ * NU>(r, sLl, lb);
      TM::template put<NU>(r, sEu, eb);
      TM::template put<NZ * NX>(r, sF, fb);
      TM::template put<NX>(r, sBb, bb);
      if (pi_s) {
        TM::template put<NTX>(r, sLx, xb);
        TM::template put<NX>(r, sPx, pb);
      }
    }
    sync();
    T u[NU];
    hp::u_of_x<T, NU, NX>(sLl, sEu, x, u);
#pragma unroll
    for (int i = 0; i < NU; ++i)
      if (i % TEAM == r) sZt[i] = u[i];
    for (int i = r; i < NX; i += TEAM) sZt[NU + i] = x[i];
    if (pi_s) hp::pi_t1<TEAM, T, NX>(r, sLx, x, sT1);
    sync();
    if (valid)
      for (int i = r; i < NZ; i += TEAM)
        zo(static_cast<int64_t>(s) * NZ + i) = sZt[i];
    hp::x_next<TEAM, T, NZ, NX>(r, sBb, sF, sZt, xn);
    if (pi_s)
      hp::pi_rows<TEAM, T, NX>(r, sLx, sPx, sT1, [&](int i, T v) {
        if (valid) pio(static_cast<int64_t>(s - 1) * NX + i) = v;
      });
  }
}

// The register form: one instance on a team of TEAM lanes, the stage's
// Cholesky in every lane's registers (see the head comment).  Arguments as
// smem_body's.
template <typename T, bool WANT_PI, bool HAS_NG, typename IO, typename A>
__device__ __forceinline__ void reg_body(const A& a,
                                         unsigned char* smem_raw) {
  using hp::Col;
  using hp::mul_rn;
  using hp::sym_idx;
  constexpr int TEAM = Row9<T>::TEAM;
  using TM = hp::Team<TEAM>;
  const TeamLane tl = team_lane<T>(a.B);
  const int r = tl.r;
  const bool valid = tl.valid;
  const int64_t B = a.B, bi = tl.bi;
  const IO io(a, bi);
  const int N = static_cast<int>(a.N);
  const int n_ng = static_cast<int>(a.n_ng);
  const int* ng_stage = static_cast<const int*>(a.ng_stage);
  auto sync = [] { __syncwarp(); };

  T* const sh = reinterpret_cast<T*>(smem_raw) + tl.tw * Row9<T>::SLAB;
  T* const sW = sh + R_W;
  T* const sM = sh + R_M;
  T* const sMv = sh + R_MV;
  T* const sXn = sh + R_XN;
  T* const sL = sh + R_L;
  T* const sZ = sh + R_Z;
  auto in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + bi, B};
  };
  auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + bi, B}; };
  const Col<const T> gc = in(a.g), Fc = in(a.F), bc = in(a.b);
  const Col<T> Pbo = out(a.Pb), zo = out(a.z), pio = out(a.pi);

  auto ng_slot = [&](int n) {
    if (!HAS_NG) return -1;
    for (int j = 0; j < n_ng; ++j)
      if (ng_stage[j] == n) return j;
    return -1;
  };
  // this lane's share (rows r, r + TEAM, ...) of COUNT scalars of a stream
  // (row e at src[e * stride]) into the slot at dst (F: rows of NX at
  // stride FS)
  auto copy = [&](auto count_c, T* dst, const T* src, int64_t stride,
                  bool f_rows) {
    constexpr int COUNT = decltype(count_c)::value;
    const T* p = src + r * stride;
#pragma unroll
    for (int c = 0; c < TM::chunks(COUNT); ++c) {
      const int e = r + c * TEAM;
      if (e < COUNT) hp::cp_async(dst + (f_rows ? e + e / NX : e), p);
      p += TEAM * stride;
    }
  };
  // the same for a stream whose row e lies at src(e)
  auto copy_map = [&](auto count_c, T* dst, const auto& src) {
    constexpr int COUNT = decltype(count_c)::value;
#pragma unroll
    for (int c = 0; c < TM::chunks(COUNT); ++c) {
      const int e = r + c * TEAM;
      if (e < COUNT) hp::cp_async(dst + e, &src(e));
    }
  };
  auto slot = [&](int t) { return sh + (t & 1) * R_SLOT; };
  // the backward step of stage k into slot t
  auto issue_b = [&](int k, int t) {
    T* const d = slot(t);
    const int ke = k < N - 1 ? k : N - 1;
    const int jg = ng_slot(k);
    if constexpr (IO::WHOLE)
      copy_map(std::integral_constant<int, NT>{}, d + RB_H,
               [&](int e) -> const T& { return io.h(k, e); });
    else
      copy(std::integral_constant<int, NT>{}, d + RB_H, &io.h(k, 0), B,
           false);
    if (!IO::WHOLE)
      copy(std::integral_constant<int, NZ>{}, d + RB_DV,
           &in(a.dvec)(static_cast<int64_t>(k) * NZ), B, false);
    copy(std::integral_constant<int, NZ>{}, d + RB_G,
         &gc(static_cast<int64_t>(k) * NZ), B, false);
    copy(std::integral_constant<int, NZ * NX>{}, d + RB_F,
         &Fc(static_cast<int64_t>(ke) * NZ * NX), B, true);
    copy(std::integral_constant<int, NX>{}, d + RB_B,
         &bc(static_cast<int64_t>(ke) * NX), B, false);
    if (HAS_NG && jg >= 0)
      copy(std::integral_constant<int, NT>{}, d + RB_NGL,
           &in(a.ngl)(static_cast<int64_t>(jg) * NT), B, false);
  };
  // the forward step of stage s into slot t
  auto issue_f = [&](int s, int t) {
    T* const d = slot(t);
    const int se = s < N - 1 ? s : N - 1;
    if constexpr (IO::LL_ROWS) {
      // the rows r, r + TEAM, ... of Ll_s, NU entries each
#pragma unroll
      for (int c = 0; c < TM::chunks(NZ); ++c) {
        const int i = r + c * TEAM;
        if (i < NZ) {
          const T* p = &io.ll(s, i, 0);
#pragma unroll
          for (int j = 0; j < NU; ++j)
            hp::cp_async(d + RF_LL + i * NU + j, p + j * B);
        }
      }
    } else {
      copy(std::integral_constant<int, NZ * NU>{}, d + RF_LL,
           &io.ll(s, 0, 0), B, false);
    }
    copy(std::integral_constant<int, NU>{}, d + RF_EU, &io.eu(s, 0),
         io.eu_stride(), false);
    copy(std::integral_constant<int, NZ * NX>{}, d + RF_F,
         &Fc(static_cast<int64_t>(se) * NZ * NX), B, true);
    copy(std::integral_constant<int, NX>{}, d + RF_B,
         &bc(static_cast<int64_t>(se) * NX), B, false);
    if (WANT_PI && s >= 1) {
      copy_map(std::integral_constant<int, NTX>{}, d + RF_LX,
               [&](int e) -> const T& {
                 const int i = hp::tril_row<NX>(e);
                 return io.lxx(s, i, e - i * (i + 1) / 2);
               });
      copy(std::integral_constant<int, NX>{}, d + RF_PX, &io.px(s, 0),
           io.px_stride(), false);
    }
  };
  // the owners' rows of stage k's factor, Pb, eu and px, from the slab's
  // copy (sL: the packed factor, then Pb, eu, px)
  auto store_factor = [&](int k) {
    if (!valid) return;
#pragma unroll
    for (int c = 0; c < TM::chunks(NZ); ++c) {
      const int i = r + c * TEAM;
      if (i >= NZ) break;
      io.row(k, i, [&](int j) { return sL[sym_idx(i, j)]; });
      if (i >= NU) {
        const int xi = i - NU;
        if (k < N) Pbo(static_cast<int64_t>(k) * NX + xi) = sL[R_LPB + xi];
        if (IO::STORE_PX || WANT_PI) io.px(k, xi) = sL[R_LPX + xi];
      }
    }
#pragma unroll
    for (int c = 0; c < TM::chunks(IO::EU_ROWS); ++c) {
      const int j = r + c * TEAM;
      if (j < IO::EU_ROWS) {
        if constexpr (IO::EU_ROWS == NU)
          io.eu(k, j) = sL[R_LEU + j];
        else  // zeros past NU (the slab holds NU entries of eu)
          io.eu(k, j) = j < NU ? sL[R_LEU + (j < NU ? j : 0)] : T(0);
      }
    }
  };

  // ---- backward: the folded factorization, k = N..0 -----------------------
  T Lc[NX][NX], pxc[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    pxc[i] = T(0);
#pragma unroll
    for (int j = 0; j < NX; ++j) Lc[i][j] = T(0);
  }
  issue_b(N, 0);
  __pipeline_commit();
  for (int k = N; k >= 0; --k) {
    const int t = N - k;
    if (k > 0) issue_b(k - 1, t + 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    sync();  // the stage's slot has landed in every lane
    if (k < N) store_factor(k + 1);
    const T* const st = slot(t);
    const int jg = ng_slot(k);
    // Pb = Lc (Lc' b) (team.cuh folded_core's roundings), Pb + px_c
    T t1[NX], pb[NX], pbx[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i)
      t1[i] = hp::dot_chain<T, NX>(i, NX - 1, [&](int q, T& u, T& v) {
        u = Lc[q][i];
        v = st[RB_B + q];
      });
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      pb[i] = hp::dot_chain<T, NX>(0, i, [&](int q, T& u, T& v) {
        u = Lc[i][q];
        v = t1[q];
      });
      pbx[i] = pb[i] + pxc[i];
    }
    // the owned rows: m = g + F (Pb + px_c), W = F Lc; W's rows to the slab
    T wr[TM::chunks(NZ)][NX];
#pragma unroll
    for (int c = 0; c < TM::chunks(NZ); ++c) {
      const int i0 = r + c * TEAM, i = i0 < NZ ? i0 : NZ - 1;
      T f[NX];
#pragma unroll
      for (int q = 0; q < NX; ++q) f[q] = st[RB_F + i * FS + q];
      T acc = st[RB_G + i];
#pragma unroll
      for (int q = 0; q < NX; ++q) acc = acc + f[q] * pbx[q];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T wv = f[j] * Lc[j][j];
#pragma unroll
        for (int q = j + 1; q < NX; ++q) wv = wv + f[q] * Lc[q][j];
        wr[c][j] = wv;
      }
      if (i0 < NZ) {
        sMv[i] = acc;
#pragma unroll
        for (int j = 0; j < NX; ++j) sW[i * FS + j] = wr[c][j];
      }
    }
    sync();
    // the owned rows of M = H (+ diag(dvec) + ngl) + W W', every entry of
    // the row formed (branch-free), the lower ones kept
#pragma unroll
    for (int c = 0; c < TM::chunks(NZ); ++c) {
      const int i0 = r + c * TEAM, i = i0 < NZ ? i0 : NZ - 1;
      const T dv = IO::WHOLE ? T(0) : st[RB_DV + i];
      T mr[NZ];
#pragma unroll
      for (int j = 0; j < NZ; ++j) {
        const int e = sym_idx(i, 0) + j;  // past the row for j > i: unused
        T acc = st[RB_H + e];
        if (!IO::WHOLE) acc = j == i ? acc + dv : acc;
        if (HAS_NG && jg >= 0) acc = acc + st[RB_NGL + e];
#pragma unroll
        for (int q = 0; q < NX; ++q) acc = acc + wr[c][q] * sW[j * FS + q];
        mr[j] = acc;
      }
      if (i0 < NZ) {
#pragma unroll
        for (int j = 0; j < NZ; ++j)
          if (j <= i) sM[sym_idx(i, 0) + j] = mr[j];
      }
    }
    sync();
    // every lane: M and m into registers, M = chol(M) (team.cuh chol_col's
    // roundings), eu = Luu^{-1} m_u, px = m_x - Lxu eu, the new carry
    T M[NZ][NZ], mv[NZ], di[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      mv[i] = sMv[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) M[i][j] = sM[sym_idx(i, j)];
    }
#pragma unroll
    for (int J = 0; J < NZ; ++J) {
      const T d = T(1) / sqrt(hp::nmax(M[J][J], T(1e-20)));
      di[J] = d;
      T l[NZ];
#pragma unroll
      for (int i = J; i < NZ; ++i) l[i] = mul_rn(M[i][J], d);
#pragma unroll
      for (int i = J + 1; i < NZ; ++i)
#pragma unroll
        for (int jj = J + 1; jj <= i; ++jj) M[i][jj] = M[i][jj] - l[i] * l[jj];
#pragma unroll
      for (int i = J; i < NZ; ++i) M[i][J] = l[i];
    }
    T eu[NU];
    hp::folded_tail<T, NU, NX>(M, di, mv, eu, Lc, pxc);
    // the stage's factor, Pb, eu and px to the slab (every lane the same
    // values); the owners store them after the next barrier
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) sL[sym_idx(i, j)] = M[i][j];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      sL[R_LPB + i] = pb[i];
      sL[R_LPX + i] = pxc[i];
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) sL[R_LEU + j] = eu[j];
  }
  sync();
  store_factor(0);

  // ---- forward: x, u, z (and pi), s = 0..N --------------------------------
  sync();  // every lane's stores of stage 0 are done
  issue_f(0, 0);
  __pipeline_commit();
  T x[NX];
  hp::root_x0<T, NX>(Lc, pxc, x);  // the carry holds stage 0's Lxx and px
  for (int s = 0; s <= N; ++s) {
    if (s < N) issue_f(s + 1, s + 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    sync();  // the stage's slot has landed in every lane
    const T* const st = slot(s);
    if (s > 0 && valid) {
      // the owners' rows of the last stage's z
#pragma unroll
      for (int c = 0; c < TM::chunks(NZ); ++c) {
        const int i = r + c * TEAM;
        if (i < NZ)
          zo(static_cast<int64_t>(s - 1) * NZ + i) = sZ[((s - 1) & 1) * NZ + i];
      }
    }
    T Ll[NZ][NU], eu[NU], Du[NU], u[NU], zt[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j) Ll[i][j] = st[RF_LL + i * NU + j];
#pragma unroll
    for (int i = 0; i < NU; ++i) eu[i] = st[RF_EU + i];
    hp::dinv_diag<T, NU>(Ll, Du);
    hp::u_of_x<T, NU, NX>(Ll, Du, eu, x, u);
#pragma unroll
    for (int i = 0; i < NU; ++i) zt[i] = u[i];
#pragma unroll
    for (int i = 0; i < NX; ++i) zt[NU + i] = x[i];
    // x_{s+1} = b + F' z, the owned rows, through the slab
#pragma unroll
    for (int c = 0; c < TM::chunks(NX); ++c) {
      const int j0 = r + c * TEAM, j = j0 < NX ? j0 : NX - 1;
      T acc = st[RF_B + j];
#pragma unroll
      for (int i = 0; i < NZ; ++i) acc = acc + st[RF_F + i * FS + j] * zt[i];
      if (j0 < NX) sXn[j] = acc;
    }
#pragma unroll
    for (int i = 0; i < NZ; ++i) sZ[(s & 1) * NZ + i] = zt[i];
    if (WANT_PI && s >= 1) {
      // pi_{s-1} = Lxx_s (Lxx_s' x_s) + px_s (team.cuh pi_t1 / pi_rows),
      // the owned rows (branch-free)
      const T* const Lx = st + RF_LX;
      T t1[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i)
        t1[i] = hp::dot_chain<T, NX>(i, NX - 1, [&](int q, T& u_, T& v) {
          u_ = Lx[sym_idx(q, i)];
          v = x[q];
        });
#pragma unroll
      for (int c = 0; c < TM::chunks(NX); ++c) {
        const int i0 = r + c * TEAM, i = i0 < NX ? i0 : NX - 1;
        T acc = st[RF_PX + i];
#pragma unroll
        for (int q = 0; q < NX; ++q) {
          const T v = acc + Lx[sym_idx(i, 0) + q] * t1[q];
          acc = q <= i ? v : acc;
        }
        if (valid && i0 < NX) pio(static_cast<int64_t>(s - 1) * NX + i) = acc;
      }
    }
    sync();
#pragma unroll
    for (int j = 0; j < NX; ++j) x[j] = sXn[j];
  }
  if (valid) {
#pragma unroll
    for (int c = 0; c < TM::chunks(NZ); ++c) {
      const int i = r + c * TEAM;
      if (i < NZ) zo(static_cast<int64_t>(N) * NZ + i) = sZ[(N & 1) * NZ + i];
    }
  }
}

// Launch a team kernel of either form on a.B instances (one warp a block,
// Row9<T>::IPB instances a block, the per-team slabs in dynamic shared
// memory).
template <typename T, typename K, typename A>
int start_team(K kernel, const A& a, cudaStream_t stream) {
  using G = Row9<T>;
  const int64_t blocks = (a.B + G::IPB - 1) / G::IPB;
  const int64_t smem = static_cast<int64_t>(G::IPB) * G::SLAB * sizeof(T);
  const int rc = hp::allow_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<static_cast<unsigned>(blocks), THREADS, static_cast<size_t>(smem),
           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The launch layout in dtype_code with `scratch` rows of scratch an
// instance: out = {lanes a team, instances a block, threads a block,
// scratch rows an instance, shared memory a block (bytes), 1 for the
// register form (0: shared memory)}.
template <typename T>
void team_layout(int64_t scratch, int64_t* out) {
  using G = Row9<T>;
  out[0] = G::TEAM;
  out[1] = G::IPB;
  out[2] = THREADS;
  out[3] = scratch;
  out[4] = static_cast<int64_t>(G::IPB) * G::SLAB * sizeof(T);
  out[5] = G::REG ? 1 : 0;
}

}  // namespace
