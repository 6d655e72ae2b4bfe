// The whole phase-1 Mehrotra IPM of a batch of OCP QPs in ONE kernel:
// one CUDA thread runs one instance's solve from init to exit.
//
// Replaces: hpmpc_tpu/ops/resident_kernel.py::ipm_resident (TPU body
// _resident_kernel), general-constraint rows included: the hard variant
// (HP_NS = 0, Queue 2 row 1) and the soft one (HP_NS > 0, row 1s, the
// single-loop soft IPM d_ip2_mpc_soft_tv).  Plain version:
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
// What bounds it on the H100: per instance and iteration the four sweeps
// touch every stage's streams -- at the flagship (N=30, NZ=11, NX=8,
// NB=7, f32) about 31 * (66 H + 88 F + 77 factor + ~120 state/direction)
// scalars, ~45 KB read+written, against ~31 * 2.5k ~ 80k flops (the
// stage Cholesky, W W', and the triangular solves): ~2 flop/byte, below
// the ~20 flop/byte fp32 balance point, so DRAM/L2 traffic and latency
// bound it.  The TPU kernel keeps all of that in VMEM for the whole call.
//
// Design: the TPU's sequential grid (iteration, 4*(N+1) phase-stage
// steps) becomes two nested loops inside the thread; its VMEM slabs
// become per-instance global-memory scratch in batch-last (rows, B)
// layout, so the 32 threads of a warp read 32 consecutive addresses and
// every stream access is coalesced.  The 4096-instance flagship working
// set (~190 MB f32 with inputs) sits in HBM; the L2 (50 MB) catches the
// re-reads of recent stages.  The Riccati carries (Lxx, px, x) and the
// per-instance scalars (pending a2, mu, alpha minimum, mu sums, sigma,
// anchor, frozen, kk) live in registers; the stage matrices are
// fixed-size per-thread arrays that the compiler may spill to local
// memory.  Liveness is per instance: a converged or frozen instance
// leaves the loop after applying its last pending update, where the TPU
// kernel could only skip a whole 1024-lane block.  Small blocks (32
// threads) spread the few warps a 4096 batch gives over as many SMs as
// possible.  Making it fast (several threads per instance, shared-memory
// staging of the stage streams) is later work.
//
// Soft rows (HP_NS > 0): each stage's NS soft constraints carry four
// slack/multiplier families [lo; up; s_lo; s_up] (4NS values), eliminated
// per stage by the slack Schur complement of csrc/stage_math.cuh
// (soft_schur, soft_qx, soft_dt_dls, soft_corr_fold: the code of the soft
// 6-kernel loop, csrc/soft_step_flat.cu, so nvcc contracts the same
// expressions).  The affine backward sweep folds them into the barrier
// diagonal and gradient, both forward sweeps add their directions'
// fraction-to-boundary and duality terms, the corrector backward sweep
// their centering gradient (exact: with its Schur-folded correction;
// without it the reference's dropped correction; a uniform runtime branch,
// so one kernel a type carries both forms).  Their multipliers and
// slacks live in the lams/ts outputs, as z, lam and t do; five direction
// slabs (affine dt/dl, the centering correction, corrector dt/dl; 5 x 4NS
// rows a stage) join the scratch.  The duality scaling is per instance
// (musc).  Every soft array is a per-thread array too: the soft Schur
// adds ~10 NS values a stage to the hard kernel's live set.
//
// Specialisation: NU, NX, NB, NG and NS (0 when absent: the hard kernel,
// whose code the soft branches leave as it was) are compile-time (-D, one
// library per shape); N, k_max and the stages that carry general
// constraints (the ng_stage table, n_ng entries) are runtime arguments.
#include "stage_math.cuh"

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
constexpr int BLOCK = 32;

// rows of per-instance scratch, in the order the kernel carves them:
// dz2, dpi2, dt2, dl2, dta, dla, co, ll, eu, px, lxx, pb, the five ng
// direction slabs, and the five soft ones (dta_s, dla_s, dl2c_s, dt2_s,
// dl2_s)
__host__ __device__ inline int64_t work_rows(int64_t N, int64_t n_ng) {
  return (N + 1) * NZ + N * NX + 5 * (N + 1) * NB2 + (N + 1) * NZ * NU +
         (N + 1) * NU + (N + 1) * NX + (N + 1) * NTX + N * NX +
         5 * n_ng * NG2 + 5 * (N + 1) * 4 * NS;
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
  void* work;            // (work_rows, B)
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
__global__ void __launch_bounds__(BLOCK) ipm_resident_kernel(ResidentArgs a) {
  using hp::Col;
  using hp::nmax;
  using hp::nmin;
  const int64_t B = a.B;
  const int64_t bi = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (bi >= B) return;
  const int N = static_cast<int>(a.N);
  const int K = static_cast<int>(a.K);
  const int n_ng = static_cast<int>(a.n_ng);
  const int* idx = static_cast<const int*>(a.idx);
  const int* ng_stage = static_cast<const int*>(a.ng_stage);

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
  const int* idxs = static_cast<const int*>(a.idxs);
  const Col<const T> lams0 = in(a.lams0), ts0 = in(a.ts0),
                     softcc = in(a.softc), mskc = in(a.msk);
  const Col<T> lams = out(a.lams), ts = out(a.ts);

  T* w = static_cast<T*>(a.work);
  int64_t off = 0;
  auto take = [&](int64_t rows) {
    Col<T> c{w + off * B + bi, B};
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
  auto load_ll = [&](int n, T (&Ll)[NZ][NU]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j)
        Ll[i][j] = lls((static_cast<int64_t>(n) * NZ + i) * NU + j);
  };
  auto load_lxx = [&](int n, T (&Lxx)[NX][NX]) {
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j)
        Lxx[i][j] = j <= i ? lxxs(static_cast<int64_t>(n) * NTX +
                                  hp::sym_idx(i, j))
                           : T(0);
  };
  auto load_box = [&](int n, T (&lamk)[NB2], T (&tk)[NB2], T (&mbk)[NB2],
                      T (&Ak)[NB2]) {
    const int64_t r = static_cast<int64_t>(n) * NB2;
    hp::load(lamk, lam, r);
    hp::load(tk, t, r);
    hp::load(mbk, mbc, r);
    hp::load(Ak, dcatc, r);
  };
  auto load_ng = [&](int j, T (&lg)[NG2], T (&tgv)[NG2], T (&mg)[NG2],
                     T (&dg)[NG2]) {
    const int64_t r = static_cast<int64_t>(j) * NG2;
    hp::load(lg, lamg, r);
    hp::load(tgv, tg, r);
    hp::load(mg, mggc, r);
    hp::load(dg, dggc, r);
  };
  auto C = [&](int j, int g, int i) {
    return Cgc((static_cast<int64_t>(j) * NG + g) * NZ + i);
  };
  // a stage's soft multipliers, slacks, mask and constants
  auto load_soft = [&](int n, T (&ls)[NS4], T (&tsv)[NS4], T (&ms)[NSA],
                       T (&c)[6 * NSA]) {
    hp::load(ls, lams, static_cast<int64_t>(n) * NS4);
    hp::load(tsv, ts, static_cast<int64_t>(n) * NS4);
    hp::load(ms, mskc, static_cast<int64_t>(n) * NSA);
    hp::load(c, softcc, static_cast<int64_t>(n) * 6 * NSA);
  };

  // ---- one-time init -----------------------------------------------------
  for (int64_t r = 0; r < (N + 1) * NZ; ++r) {
    z(r) = z0(r);
    dz2(r) = T(0);
  }
  for (int64_t r = 0; r < (N + 1) * NB2; ++r) {
    lam(r) = lam0(r);
    t(r) = t0(r);
    dt2(r) = T(0);
    dl2(r) = T(0);
  }
  for (int64_t r = 0; r < static_cast<int64_t>(N) * NX; ++r) {
    pi(r) = pi0(r);
    dpi2(r) = T(0);
  }
  for (int64_t r = 0; r < static_cast<int64_t>(n_ng) * NG2; ++r) {
    lamg(r) = lamg0(r);
    tg(r) = tg0(r);
    dt2g(r) = T(0);
    dl2g(r) = T(0);
  }
  for (int64_t r = 0; r < static_cast<int64_t>(K) * 5; ++r) stat(r) = T(0);
  for (int64_t r = 0; r < srows; ++r) {
    lams(r) = lams0(r);
    ts(r) = ts0(r);
    dt2s(r) = T(0);
    dl2s(r) = T(0);
  }

  const T BIG = T(3.0e38);
  const T mu_tol = T(a.mu_tol), alpha_min = T(a.alpha_min),
          mu_scal = NS > 0 ? in(a.musc)(0) : T(a.mu_scal);
  T a2p = T(0), mu = T(a.mu0), lamref = BIG;
  int frz = 0, kk = 0;
  T Lxx_c[NX][NX], px_c[NX];

  for (int it = 0; it <= K; ++it) {
    const bool live = frz == 0 && mu > mu_tol;
    const bool work = live && it < K;

    // ---- phase 0: pending update (stage k), barrier fold + factor --------
    for (int s = 0; s <= N; ++s) {
      const int k = N - s;
      const int jg = ng_slot(k);
      if (a2p > T(0)) {
        // a select, never a multiply: frozen directions may hold NaN
        for (int i = 0; i < NZ; ++i) {
          const int64_t r = static_cast<int64_t>(k) * NZ + i;
          const T zo = z(r);
          z(r) = zo + a2p * (dz2(r) - zo);
        }
        for (int i = 0; i < NB2; ++i) {
          const int64_t r = static_cast<int64_t>(k) * NB2 + i;
          lam(r) = lam(r) + a2p * dl2(r);
          t(r) = t(r) + a2p * dt2(r);
        }
        if constexpr (NS > 0) {
          for (int i = 0; i < 4 * NS; ++i) {
            const int64_t r = static_cast<int64_t>(k) * 4 * NS + i;
            lams(r) = lams(r) + a2p * dl2s(r);
            ts(r) = ts(r) + a2p * dt2s(r);
          }
        }
        if (k >= 1) {
          for (int i = 0; i < NX; ++i) {
            const int64_t r = static_cast<int64_t>(k - 1) * NX + i;
            const T po = pi(r);
            pi(r) = po + a2p * (dpi2(r) - po);
          }
        }
        if (jg >= 0) {
          for (int i = 0; i < NG2; ++i) {
            const int64_t r = static_cast<int64_t>(jg) * NG2 + i;
            lamg(r) = lamg(r) + a2p * dl2g(r);
            tg(r) = tg(r) + a2p * dt2g(r);
          }
        }
      }
      if (!work) continue;

      T lamk[NB2], tk[NB2], mbk[NB2], Ak[NB2];
      load_box(k, lamk, tk, mbk, Ak);
      const int* ik = idx + k * NB;
      T ge[NZ];
      T M[NZ][NZ];
      if constexpr (NS > 0) {
        // the box and the soft Schur folds: the barrier diagonal dv onto
        // pdreg, the gradient onto the base
        T dv[NZ], ls[NS4], tsv[NS4], ms[NSA], c[6 * NSA];
        load_soft(k, ls, tsv, ms, c);
        hp::load(dv, pdregc, static_cast<int64_t>(k) * NZ);
        hp::load(ge, basec, static_cast<int64_t>(k) * NZ);
        hp::soft_fold<T, NB, NSA, NZ>(lamk, tk, mbk, Ak, ls, tsv, ms, c, ik,
                                      idxs + k * NS, dv, ge);
#pragma unroll
        for (int i = 0; i < NZ; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j)
            M[i][j] = Hc(static_cast<int64_t>(k) * NT + hp::sym_idx(i, j));
#pragma unroll
        for (int i = 0; i < NZ; ++i) M[i][i] = M[i][i] + dv[i];
      } else {
        T Qx[NB], qx[NB];
        hp::qx_fold<T, NB>(lamk, tk, mbk, Ak, Qx, qx);
        hp::load(ge, pdregc, static_cast<int64_t>(k) * NZ);
        hp::scatter_add_box<T, NB, NZ>(ge, ik, Qx);
#pragma unroll
        for (int i = 0; i < NZ; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j)
            M[i][j] = Hc(static_cast<int64_t>(k) * NT + hp::sym_idx(i, j));
#pragma unroll
        for (int i = 0; i < NZ; ++i) M[i][i] = M[i][i] + ge[i];
        hp::load(ge, basec, static_cast<int64_t>(k) * NZ);
        hp::scatter_add_box<T, NB, NZ>(ge, ik, qx);
      }
      if (jg >= 0) {
        // general-constraint barrier: M += C' diag(Qxg) C, ge += C' qxg
        T lg[NG2], tgv[NG2], mg[NG2], dg[NG2], Qxg[NG], qxg[NG];
        load_ng(jg, lg, tgv, mg, dg);
        hp::qx_fold<T, NG>(lg, tgv, mg, dg, Qxg, qxg);
#pragma unroll
        for (int i = 0; i < NZ; ++i) {
#pragma unroll
          for (int jj = 0; jj <= i; ++jj) {
            T acc = C(jg, 0, i) * Qxg[0] * C(jg, 0, jj);
#pragma unroll
            for (int g = 1; g < NG; ++g)
              acc = acc + C(jg, g, i) * Qxg[g] * C(jg, g, jj);
            M[i][jj] = M[i][jj] + acc;
          }
        }
#pragma unroll
        for (int i = 0; i < NZ; ++i) {
          T acc = C(jg, 0, i) * qxg[0];
#pragma unroll
          for (int g = 1; g < NG; ++g) acc = acc + C(jg, g, i) * qxg[g];
          ge[i] = ge[i] + acc;
        }
      }
      const int ke = k < N - 1 ? k : N - 1;
      T F[NZ][NX], bb[NX];
#pragma unroll
      for (int i = 0; i < NZ; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j)
          F[i][j] = Fc((static_cast<int64_t>(ke) * NZ + i) * NX + j);
      hp::load(bb, bc, static_cast<int64_t>(ke) * NX);
      if (s == 0) {
        // terminal stage: zero carry, so the interior formulas collapse
        // exactly to the terminal ones
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          px_c[i] = T(0);
#pragma unroll
          for (int j = 0; j < NX; ++j) Lxx_c[i][j] = T(0);
        }
      }
      T eu[NU], px[NX], Pb[NX];
      hp::folded_bwd_core<T, NU, NX>(M, ge, F, bb, Lxx_c, px_c, eu, px, Pb);
#pragma unroll
      for (int i = 0; i < NZ; ++i)
#pragma unroll
        for (int j = 0; j < NU; ++j)
          lls((static_cast<int64_t>(k) * NZ + i) * NU + j) =
              j <= i ? M[i][j] : T(0);
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j)
          lxxs(static_cast<int64_t>(k) * NTX + hp::sym_idx(i, j)) =
              M[NU + i][NU + j];
      hp::store(eus, static_cast<int64_t>(k) * NU, eu);
      hp::store(pxs, static_cast<int64_t>(k) * NX, px);
      // Pb of stage k (< N) couples it to stage k+1; the terminal Pb is 0
      if (k < N) hp::store(pbs, static_cast<int64_t>(k) * NX, Pb);
    }
    a2p = T(0);
    if (!work) break;  // an instance that is not live never becomes live

    T x[NX];
    // ---- phase 1: affine forward + alpha / mu(alpha) partials -----------
    T amin = BIG, s0 = T(0), s1 = T(0), s2 = T(0);
    {
      T Lxx[NX][NX], px0[NX];
      load_lxx(0, Lxx);
      hp::load(px0, pxs, 0);
      hp::root_x0<T, NX>(Lxx, px0, x);
    }
    for (int s = 0; s <= N; ++s) {
      T Ll[NZ][NU], eu[NU], Dinv_u[NU], u[NU], zt[NZ];
      load_ll(s, Ll);
      hp::load(eu, eus, static_cast<int64_t>(s) * NU);
      hp::dinv_diag<T, NU>(Ll, Dinv_u);
      hp::u_of_x<T, NU, NX>(Ll, Dinv_u, eu, x, u);
#pragma unroll
      for (int i = 0; i < NU; ++i) zt[i] = u[i];
#pragma unroll
      for (int i = 0; i < NX; ++i) zt[NU + i] = x[i];
      const int se = s < N - 1 ? s : N - 1;
      hp::x_next_of<T, NZ, NX>(Fc, static_cast<int64_t>(se) * NZ * NX, bc,
                               static_cast<int64_t>(se) * NX, zt, x);

      T zb[NB], lamk[NB2], tk[NB2], mbk[NB2], Ak[NB2], zero[NB2];
      hp::gather_box<T, NB, NZ>(zt, idx + s * NB, zb);
      load_box(s, lamk, tk, mbk, Ak);
#pragma unroll
      for (int i = 0; i < NB2; ++i) zero[i] = T(0);
      T dtb[NB2], dlb[NB2];
      hp::dt_dlam<T, NB>(lamk, tk, mbk, Ak, zb, zero, dtb, dlb);
      hp::store(dta, static_cast<int64_t>(s) * NB2, dtb);
      hp::store(dla, static_cast<int64_t>(s) * NB2, dlb);
      hp::alpha_sums<T, NB2>(lamk, tk, mbk, dtb, dlb, amin, s0, s1, s2);
      if constexpr (NS > 0) {
        // the soft affine direction against zl, its alpha and mu terms
        T ls[NS4], tsv[NS4], ms[NSA], c[6 * NSA], zs[NSA], zero4[NS4];
        T dts[NS4], dls[NS4];
        load_soft(s, ls, tsv, ms, c);
        hp::SoftSchur<T, NSA> S;
        hp::soft_schur<T, NSA>(ls, tsv, ms, c, S);
        hp::gather_box<T, NSA, NZ>(zt, idxs + s * NS, zs);
#pragma unroll
        for (int i = 0; i < NSA; ++i) zs[i] = zs[i] * ms[i];
#pragma unroll
        for (int i = 0; i < NS4; ++i) zero4[i] = T(0);
        hp::soft_dt_dls<T, NSA>(ls, tsv, S, zs, zero4, S.zl0, S.zl1, dts,
                                dls);
        hp::store(dtas, static_cast<int64_t>(s) * NS4, dts);
        hp::store(dlas, static_cast<int64_t>(s) * NS4, dls);
        hp::alpha_sums<T, NS4>(ls, tsv, S.ms4, dts, dls, amin, s0, s1, s2);
      }

      const int jg = ng_slot(s);
      if (jg >= 0) {
        T lg[NG2], tgv[NG2], mg[NG2], dg[NG2], cz[NG], zg[NG2];
        T dtg[NG2], dlg[NG2];
        load_ng(jg, lg, tgv, mg, dg);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          T acc = C(jg, g, 0) * zt[0];
#pragma unroll
          for (int i = 1; i < NZ; ++i) acc = acc + C(jg, g, i) * zt[i];
          cz[g] = acc;
        }
#pragma unroll
        for (int i = 0; i < NG2; ++i) zg[i] = T(0);
        hp::dt_dlam<T, NG>(lg, tgv, mg, dg, cz, zg, dtg, dlg);
        hp::store(dtag, static_cast<int64_t>(jg) * NG2, dtg);
        hp::store(dlag, static_cast<int64_t>(jg) * NG2, dlg);
        hp::alpha_sums<T, NG2>(lg, tgv, mg, dtg, dlg, amin, s0, s1, s2);
      }
    }
    const T alpha_aff = nmin(T(1), amin);
    const T aa = T(0.995) * alpha_aff;
    const T mu_aff = (s0 + aa * s1 + aa * aa * s2) * mu_scal;
    const T ratio = mu_aff / (mu > T(0) ? mu : T(1));
    const T sigma = ratio * ratio * ratio;
    const T sm = sigma * mu;

    // ---- phase 2: corrector gradient + retained-factor solve ------------
    for (int s = 0; s <= N; ++s) {
      const int k = N - s;
      T lamk[NB2], tk[NB2], mbk[NB2], Ak[NB2], dtak[NB2], dlak[NB2];
      load_box(k, lamk, tk, mbk, Ak);
      hp::load(dtak, dta, static_cast<int64_t>(k) * NB2);
      hp::load(dlak, dla, static_cast<int64_t>(k) * NB2);
      T cok[NB2], ge[NZ];
      hp::load(ge, basec, static_cast<int64_t>(k) * NZ);
      if constexpr (NS > 0) {
        // the box and the soft centering corrections and the corrected
        // gradient folds
        T ls[NS4], tsv[NS4], ms[NSA], c[6 * NSA], dts[NS4], dls[NS4];
        T dl2c[NS4];
        load_soft(k, ls, tsv, ms, c);
        hp::load(dts, dtas, static_cast<int64_t>(k) * NS4);
        hp::load(dls, dlas, static_cast<int64_t>(k) * NS4);
        if (a.exact)
          hp::soft_corr_fold<T, NB, NSA, NZ, true>(
              lamk, tk, mbk, Ak, dtak, dlak, ls, tsv, ms, c, dts, dls, sm,
              idx + k * NB, idxs + k * NS, cok, dl2c, ge);
        else
          hp::soft_corr_fold<T, NB, NSA, NZ, false>(
              lamk, tk, mbk, Ak, dtak, dlak, ls, tsv, ms, c, dts, dls, sm,
              idx + k * NB, idxs + k * NS, cok, dl2c, ge);
        hp::store(dl2cs, static_cast<int64_t>(k) * NS4, dl2c);
      } else {
        T qx[NB];
        hp::corr_co_qx<T, NB>(lamk, tk, mbk, Ak, dtak, dlak, sm, cok, qx);
        hp::scatter_add_box<T, NB, NZ>(ge, idx + k * NB, qx);
      }
      hp::store(cor, static_cast<int64_t>(k) * NB2, cok);
      const int jg = ng_slot(k);
      if (jg >= 0) {
        T lg[NG2], tgv[NG2], mg[NG2], dg[NG2], dtg[NG2], dlg[NG2];
        T cogv[NG2], qxg2[NG];
        load_ng(jg, lg, tgv, mg, dg);
        hp::load(dtg, dtag, static_cast<int64_t>(jg) * NG2);
        hp::load(dlg, dlag, static_cast<int64_t>(jg) * NG2);
        hp::corr_co_qx<T, NG>(lg, tgv, mg, dg, dtg, dlg, sm, cogv, qxg2);
        hp::store(cog, static_cast<int64_t>(jg) * NG2, cogv);
#pragma unroll
        for (int i = 0; i < NZ; ++i) {
          T acc = C(jg, 0, i) * qxg2[0];
#pragma unroll
          for (int g = 1; g < NG; ++g) acc = acc + C(jg, g, i) * qxg2[g];
          ge[i] = ge[i] + acc;
        }
      }
      T Ll[NZ][NU], Dinv_u[NU], Pbpx[NX], eu[NU], px[NX];
      load_ll(k, Ll);
      hp::dinv_diag<T, NU>(Ll, Dinv_u);
      const int ke = k < N - 1 ? k : N - 1;
#pragma unroll
      for (int i = 0; i < NX; ++i)
        Pbpx[i] = s == 0 ? T(0)
                         : pbs(static_cast<int64_t>(ke) * NX + i) + px_c[i];
      hp::trs_stage<T, NU, NX>(Ll, Dinv_u, ge, Fc,
                               static_cast<int64_t>(ke) * NZ * NX, Pbpx,
                               s == 0, eu, px);
#pragma unroll
      for (int i = 0; i < NX; ++i) px_c[i] = px[i];
      hp::store(eus, static_cast<int64_t>(k) * NU, eu);
      hp::store(pxs, static_cast<int64_t>(k) * NX, px);
    }

    // ---- phase 3: corrector forward + alpha + step glue ------------------
    amin = BIG;
    s0 = s1 = s2 = T(0);
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
      hp::dinv_diag<T, NU>(Ll, Dinv_u);
      hp::u_of_x<T, NU, NX>(Ll, Dinv_u, eu, x, u);
#pragma unroll
      for (int i = 0; i < NU; ++i) zt[i] = u[i];
#pragma unroll
      for (int i = 0; i < NX; ++i) zt[NU + i] = x[i];
      hp::store(dz2, static_cast<int64_t>(s) * NZ, zt);
      if (s >= 1) {
        // pi_{s-1} = Lxx_s (Lxx_s' x_s) + px_s
        T Lxx[NX][NX], pi2[NX];
        load_lxx(s, Lxx);
        hp::pi_of_x<T, NX>(Lxx, pxv, x, pi2);
        hp::store(dpi2, static_cast<int64_t>(s - 1) * NX, pi2);
      }
      const int se = s < N - 1 ? s : N - 1;
      hp::x_next_of<T, NZ, NX>(Fc, static_cast<int64_t>(se) * NZ * NX, bc,
                               static_cast<int64_t>(se) * NX, zt, x);

      T zb[NB], lamk[NB2], tk[NB2], mbk[NB2], Ak[NB2], cok[NB2];
      hp::gather_box<T, NB, NZ>(zt, idx + s * NB, zb);
      load_box(s, lamk, tk, mbk, Ak);
      hp::load(cok, cor, static_cast<int64_t>(s) * NB2);
      T dtb[NB2], dlb[NB2];
      hp::dt_dlam<T, NB>(lamk, tk, mbk, Ak, zb, cok, dtb, dlb);
      hp::store(dt2, static_cast<int64_t>(s) * NB2, dtb);
      hp::store(dl2, static_cast<int64_t>(s) * NB2, dlb);
      hp::alpha_sums<T, NB2>(lamk, tk, mbk, dtb, dlb, amin, s0, s1, s2);
      if constexpr (NS > 0) {
        // the soft corrector direction against zl + the dl2c fold, with
        // dl2c as its centering stream
        T ls[NS4], tsv[NS4], ms[NSA], c[6 * NSA], zs[NSA], dl2c[NS4];
        T zl0x[NSA], zl1x[NSA], dts[NS4], dls[NS4];
        load_soft(s, ls, tsv, ms, c);
        hp::load(dl2c, dl2cs, static_cast<int64_t>(s) * NS4);
        hp::SoftSchur<T, NSA> S;
        hp::soft_schur<T, NSA>(ls, tsv, ms, c, S);
        hp::gather_box<T, NSA, NZ>(zt, idxs + s * NS, zs);
#pragma unroll
        for (int i = 0; i < NSA; ++i) {
          zs[i] = zs[i] * ms[i];
          zl0x[i] = S.zl0[i] + dl2c[i] + dl2c[2 * NSA + i];
          zl1x[i] = S.zl1[i] + dl2c[NSA + i] + dl2c[3 * NSA + i];
        }
        hp::soft_dt_dls<T, NSA>(ls, tsv, S, zs, dl2c, zl0x, zl1x, dts, dls);
        hp::store(dt2s, static_cast<int64_t>(s) * NS4, dts);
        hp::store(dl2s, static_cast<int64_t>(s) * NS4, dls);
        hp::alpha_sums<T, NS4>(ls, tsv, S.ms4, dts, dls, amin, s0, s1, s2);
      }

      const int jg = ng_slot(s);
      if (jg >= 0) {
        T lg[NG2], tgv[NG2], mg[NG2], dg[NG2], cz[NG], cogv[NG2];
        T dtg[NG2], dlg[NG2];
        load_ng(jg, lg, tgv, mg, dg);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          T acc = C(jg, g, 0) * zt[0];
#pragma unroll
          for (int i = 1; i < NZ; ++i) acc = acc + C(jg, g, i) * zt[i];
          cz[g] = acc;
        }
        hp::load(cogv, cog, static_cast<int64_t>(jg) * NG2);
        hp::dt_dlam<T, NG>(lg, tgv, mg, dg, cz, cogv, dtg, dlg);
        hp::store(dt2g, static_cast<int64_t>(jg) * NG2, dtg);
        hp::store(dl2g, static_cast<int64_t>(jg) * NG2, dlg);
        hp::alpha_sums<T, NG2>(lg, tgv, mg, dtg, dlg, amin, s0, s1, s2);
      }
    }
    const T alpha2 = nmin(T(1), amin);
    const T a2 = T(0.995) * alpha2;
    const T mu_new = (s0 + a2 * s1 + a2 * a2 * s2) * mu_scal;
    // max |dual| before and after the would-be update (box + ng)
    T lmx_old = T(0), lmx_new = T(0);
    for (int64_t r = 0; r < (N + 1) * NB2; ++r) {
      const T l = lam(r);
      lmx_old = nmax(lmx_old, fabs(l));
      lmx_new = nmax(lmx_new, fabs(l + a2 * dl2(r)));
    }
    for (int64_t r = 0; r < static_cast<int64_t>(n_ng) * NG2; ++r) {
      const T l = lamg(r);
      lmx_old = nmax(lmx_old, fabs(l));
      lmx_new = nmax(lmx_new, fabs(l + a2 * dl2g(r)));
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
      const int64_t r = static_cast<int64_t>(it) * 5;
      stat(r + 0) = sigma;
      stat(r + 1) = alpha_aff;
      stat(r + 2) = mu_aff;
      stat(r + 3) = alpha2;
      stat(r + 4) = mu_new;
      mu = mu_new;
      kk += 1;
    }
    if (!ok || a2 < alpha_min) frz = 1;
  }

  out(a.mu)(0) = mu;
  Col<int>{static_cast<int*>(a.kk) + bi, B}(0) = kk;
  Col<int>{static_cast<int*>(a.frozen) + bi, B}(0) = frz;
}

template <typename T>
static int launch(const ResidentArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + BLOCK - 1) / BLOCK;
  ipm_resident_kernel<T>
      <<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(a);
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

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
