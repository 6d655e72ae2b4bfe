// One fused iterative-refinement pass (the reference's ITER_REF correction,
// d_ip2_res_hard.c:1093-1131) for a batch of OCP KKT systems in ONE kernel,
// a team of lanes per instance: the Newton residuals of the current
// iterate, the retained-factor re-solve with Pb recomputed for the new
// right-hand side, and the corrected iterate.
//
// Replaces: hpmpc_tpu/ops/stage_kernel.py::refine_flat_fused (TPU body
// _refine_fused_kernel, one call on a (block, 2(N+1)) grid).  Plain
// version: hpmpc_tpu_torch/ops/stage_kernel.py::refine_flat_fused_ref.
//
// Per stage k the residuals are
//   rq_k = g_k + (H_k + diag(dvec_k)) z_k + [k<N] F_k pi_k
//          - [k>=1] [0; pi_{k-1}] + [ng stage] C' (qxg * C z_k)
//   rb_k = b_k + F_k' z_k - x_{k+1}                              (k < N)
// and the correction (dz, dpi) solves the factored system for (rq, rb):
// backward, Pb = Lxx_{k+1} (Lxx_{k+1}' rb_k) and hp::trs_stage; forward,
// x_{s+1} = rb_s + F_s' dz_s.  Out: z + dz, pi + dpi.
//
// What bounds it on the H100: per instance and stage it must read H,
// dvec, g, z, pi, F, b, Ll and the lower triangle of Lxx once and write z
// and pi -- ~290 scalars at the flagship (N=30, NZ=11, NX=8, NU=3; 147.5 MB
// at B=4096 in f32) -- against ~1.3k flops: ~1 flop/byte, bound by its
// bytes.  The one-thread-an-instance form that came first (4096 threads =
// 128 warps at B=4096, about one an SM) walked stages N..0 and 0..N, each a
// run of dependent global loads, and wrote eu, px and rb to per-instance
// scratch for the forward loop: 13% of the byte bound.
//
// Design.  Most of a stage's work does not depend on the carry: rq_k, rb_k
// and Pb_k come from the inputs alone, and so, once x_s is known, do
// pi_{s-1} = Lxx_s (Lxx_s' x_s) + px_s and the update.  Only m = rq + F (Pb
// + px_c), eu = Luu^{-1} m_u and px = m_x - Lxu eu backward, and u_s and
// x_{s+1} forward, carry.  So one launch runs three overlapped phases (the
// shared pieces in csrc/team.cuh, hp::ReSolve, which row 11, the unfused
// pass's re-solve, runs too):
//   * warp 0 runs the serial chain: the backward substitution, stages
//     N..0, on the kept rows, then the forward recovery (x_0 from the root
//     solve, u_s, z_s + dz_s, x_{s+1});
//   * the block's other warps, the workers, first keep the carry-free rows
//     of every stage in descending order (rq_k, rb_k, Pb_k and the
//     reciprocal pivots of Ll_k), announcing each stage in a shared-memory
//     progress word, then run the epilogue of each stage (z + dz out, pi +
//     dpi) once the chain has announced its x_s.
// The chain waits only for a stage's announcement, so it starts as the
// first stages are kept and the epilogue trails it.  A chain step is one
// warp barrier: every lane forms Pb + px_c, m's u rows and eu itself, and
// the owners of the x rows form px (backward) or x_{s+1} (forward) into
// the other of two buffers; each step's F and Ll (and a forward stage's z)
// come through a ring of two shared-memory slots, copied asynchronously
// (cp.async) a step ahead.  A first form with the phases split by block
// barriers, four barriers and six IEEE divisions a chain step and a
// barrier a team lost ~1 us a chain step on the card (PERF.md section 6,
// PR 17).
// A team of TEAM lanes (4 to NZ=12, 8 to 24) runs an instance: lane r owns
// the rows r, r + TEAM, ... of every NZ-row object of a stage (rq, m, the
// F and H rows of its products, z) and the x indices likewise, as rows 19,
// 20 and 26 do; a warp holds one team of each of IPB = 32 / TEAM
// consecutive instances, so a team position's row load of a batch-last
// stream covers IPB neighbouring scalars (one 32-byte sector in f32 at
// TEAM 4), the layout that gave rows 26-27 most of their gain; a block is
// WARPS warps on the same IPB instances.  Every team of a warp runs the
// same stages, so a team's barrier is its warp's.
//
// The kept rows (rq_k then z_k, Pb_k then x_k, rb_k, the pivots, eu_k,
// px_k: 42 scalars a stage at the flagship, 5.2 KB an instance in f32)
// live in device memory (the wrapper's `work`, mostly in L2: 21 MB at
// B=4096), interleaved over the block's instances; the chain copies each
// step's rows into its ring slot with F and Ll.  Keeping them in shared
// memory measured slower on the card: at 59 KB a block in f32 three
// blocks fit an SM (the batch in two waves) and the carve-out leaves L1
// little for the prologue's loads.
//
// The bits: every entry keeps the one-thread form's expression and order,
// so the outputs are its outputs bit for bit: rq in the order g + dvec z,
// + H z term by term, + F pi as one dot product added last, - pi_{k-1},
// + the ng slots in slot order; rb = (b + F' z) - x_{k+1}; Pb + px_c with
// Pb rounded first (row 0, one product, fused into the sum); z + dz.
// nvcc contracted the one-thread form's unrolled sums -- a0 b0 + a1 b1 +
// ... as fma(a0, b0, a1 b1), each later product fused into the running sum
// -- in a way a lane's runtime range does not repeat, so those sums are
// written with explicit roundings (hp::dot_chain).
//
// Specialisation: NU, NX, NG compile-time (-D, one library per shape);
// "has ng rows" a template parameter; N and the ng table runtime.
#include "team.cuh"

#if !defined(HP_NU) || !defined(HP_NX) || !defined(HP_NG)
#error "compile with -DHP_NU=.. -DHP_NX=.. -DHP_NG=.."
#endif

namespace {

constexpr int NU = HP_NU;
constexpr int NX = HP_NX;
constexpr int NZ = NU + NX;
constexpr int NG = HP_NG;
constexpr int NT = NZ * (NZ + 1) / 2;
using RS = hp::ReSolve<NU, NX, NG, true>;
using TM = RS::TM;
constexpr int TEAM = RS::TEAM;

}  // namespace

// Mirrors _RefineArgs in hpmpc_tpu_torch/ops/stage_kernel.py field for
// field.
struct RefineArgs {
  const void* H;         // (N+1, NT, B) packed lower triangle
  const void* dvec;      // (N+1, NZ, B)
  const void* C;         // (n_ng, NG, NZ, B) general-constraint rows
  const void* qxg;       // (n_ng, NG, B) folded barrier diagonal Qx_g
  const void* ng_stage;  // (n_ng,) int32 stage of each ng slot
  const void* g;         // (N+1, NZ, B) effective gradient
  const void* F;         // (N, NZ, NX, B)
  const void* b;         // (N, NX, B) right-hand side
  const void* z;         // (N+1, NZ, B) current iterate
  const void* pi;        // (N, NX, B)
  const void* Ll;        // (N+1, NZ, NU, B) retained factor
  const void* Lxx;       // (N+1, NX, NX, B), upper triangle 0
  void* z_new;           // (N+1, NZ, B)
  void* pi_new;          // (N, NX, B)
  void* work;            // the kept rows, hp_refine_flat_layout's size
  int64_t B;
  int64_t N;
  int64_t n_ng;
};

template <typename T, bool HAS_NG>
__global__ void __launch_bounds__(RS::THREADS, sizeof(T) == 4 ? RS::MIN_BLOCKS_F32 : RS::MIN_BLOCKS_F64)
    refine_flat_kernel(RefineArgs a, RS::Geo geo) {
  using hp::Col;
  using hp::dot_chain;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const auto ln = RS::lane_of<T>(geo, a.B, a.work, smem_raw);
  const int N = static_cast<int>(a.N), r = ln.r;
  const int n_ng = static_cast<int>(a.n_ng);
  const int* ng_stage = static_cast<const int*>(a.ng_stage);
  auto in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + ln.bl, a.B};
  };
  auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + ln.bl, a.B}; };
  const Col<const T> Hc = in(a.H), dvc = in(a.dvec), gc = in(a.g),
                     Fc = in(a.F), bc = in(a.b), zc = in(a.z),
                     pic = in(a.pi), Llc = in(a.Ll), Lxxc = in(a.Lxx);
  T* const sh = ln.pe;

  // ---- prologue: rq_k, rb_k and Pb_k of the warp's stages ---------------
  auto prologue = [&](int k) {
    const hp::Rows<T> st = ln.kp.at(static_cast<int64_t>(k) * RS::KS);
    const int64_t rz = static_cast<int64_t>(k) * NZ;
    const int64_t f0 = static_cast<int64_t>(k) * NZ * NX;
    ln.tsync();  // the team's last stage is done with the slab
    RS::du_keep(ln, k, Llc);
    {
      T zb[RS::chunks(NZ)], pb[RS::chunks(NX)];
      TM::fetch<NZ>(r, zb, [&](int e) { return zc(rz + e); });
      if (k < N)
        TM::fetch<NX>(r, pb, [&](int e) {
          return pic(static_cast<int64_t>(k) * NX + e);
        });
      TM::put<NZ>(r, sh + RS::P_Z, zb);
      if (k < N) TM::put<NX>(r, sh + RS::P_PI, pb);
    }
    ln.tsync();
    const T* const z = sh + RS::P_Z;
    // branch-free row chunks (hp::Team::sym_mv_acc's rule): a chunk past
    // the last row works on the last and stores nothing
    T y[RS::chunks(NZ)];
#pragma unroll
    for (int c = 0; c < RS::chunks(NZ); ++c) {
      const int i0 = r + c * TEAM, i = i0 < NZ ? i0 : NZ - 1;
      y[c] = gc(rz + i) + dvc(rz + i) * z[i];
    }
    TM::sym_mv_acc<T, NZ>(
        r, [&](int e) { return Hc(static_cast<int64_t>(k) * NT + e); }, z, y);
    if (k < N)
      TM::f_mv_acc<T, NZ, NX>(
          r, [&](int e) { return Fc(f0 + e); }, sh + RS::P_PI, y);
    if (k >= 1) {
#pragma unroll
      for (int c = 0; c < RS::chunks(NZ); ++c) {
        const int i0 = r + c * TEAM, i = i0 < NZ ? i0 : NZ - 1;
        const T pv = pic(static_cast<int64_t>(k - 1) * NX +
                         (i >= NU ? i - NU : 0));
        if (i0 >= NU && i0 < NZ) y[c] = y[c] - pv;
      }
    }
    if (HAS_NG) {
      // the slots on stage k in slot order: qcz = qxg * C z, then rq += C'
      // qcz, each sum as the one-thread loop rounded it
      const Col<const T> Cc = in(a.C), qc = in(a.qxg);
      for (int jg = 0; jg < n_ng; ++jg) {
        if (ng_stage[jg] != k) continue;
        for (int gg = r; gg < NG; gg += TEAM) {
          const int64_t c0 = (static_cast<int64_t>(jg) * NG + gg) * NZ;
          const T cz = dot_chain<T>(0, NZ - 1, [&](int i, T& u, T& v) {
            u = Cc(c0 + i);
            v = z[i];
          });
          sh[RS::P_QCZ + gg] = qc(static_cast<int64_t>(jg) * NG + gg) * cz;
        }
        ln.tsync();
#pragma unroll
        for (int c = 0; c < RS::chunks(NZ); ++c) {
          const int i0 = r + c * TEAM, i = i0 < NZ ? i0 : NZ - 1;
          const int64_t c0 = static_cast<int64_t>(jg) * NG * NZ + i;
          T acc;
          if constexpr (NG == 1) {
            acc = hp::fma_rn(Cc(c0), sh[RS::P_QCZ], y[c]);
          } else {
            acc = y[c] + dot_chain<T>(0, NG - 1, [&](int gg, T& u, T& v) {
                    u = Cc(c0 + gg * NZ);
                    v = sh[RS::P_QCZ + gg];
                  });
          }
          y[c] = i0 < NZ ? acc : y[c];
        }
        ln.tsync();  // the qcz rows' reads before the next slot's
      }
    }
#pragma unroll
    for (int c = 0; c < RS::chunks(NZ); ++c) {
      const int i = r + c * TEAM;
      if (i < NZ) st[RS::K_Q + i] = y[c];
    }
    if (k < N) {
      T rb[RS::chunks(NX)];
      TM::fetch<NX>(r, rb, [&](int e) {
        return bc(static_cast<int64_t>(k) * NX + e);
      });
      TM::ft_mv_acc<T, NZ, NX>(r, [&](int e) { return Fc(f0 + e); }, z, rb);
#pragma unroll
      for (int c = 0; c < RS::chunks(NX); ++c) {
        const int q0 = r + c * TEAM, q = q0 < NX ? q0 : NX - 1;
        const T zn = zc(static_cast<int64_t>(k + 1) * NZ + NU + q);
        if (q0 < NX) {
          rb[c] = rb[c] - zn;
          st[RS::K_RB + q] = rb[c];
          sh[RS::P_B + q] = rb[c];
        }
      }
      ln.tsync();  // the z rows' last reads: Lxx_{k+1} goes over them
      RS::pb_keep(ln, k, Lxxc);
    }
  };
  RS::run(ln, RS::progress<T>(geo, smem_raw), N, prologue, Llc, Fc, Lxxc, zc,
          pic, out(a.z_new), out(a.pi_new));
}

template <typename T, bool HAS_NG>
static int launch(const RefineArgs& a, cudaStream_t stream) {
  if (a.work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return RS::start<T>(refine_flat_kernel<T, HAS_NG>, a, a.B, a.N, stream);
}

template <typename T>
static int dispatch(const RefineArgs& a, cudaStream_t stream) {
  return a.n_ng > 0 ? launch<T, true>(a, stream) : launch<T, false>(a, stream);
}

extern "C" int hp_refine_flat_fused(const RefineArgs* a, int dtype_code,
                                    cudaStream_t stream) {
  if (a->B <= 0 || a->N <= 0 || a->n_ng < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return dispatch<float>(*a, stream);
  if (dtype_code == 1) return dispatch<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch layout at horizon N in dtype_code (hp::ReSolve::layout).
extern "C" void hp_refine_flat_layout(int64_t N, int dtype_code,
                                      int64_t* out) {
  RS::layout(N, dtype_code, out);
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
