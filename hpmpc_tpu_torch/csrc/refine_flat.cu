// One fused iterative-refinement pass (the reference's ITER_REF correction,
// d_ip2_res_hard.c:1093-1131) for a batch of OCP KKT systems in ONE kernel,
// one CUDA thread per instance: the Newton residuals of the current
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
// What bounds it on the H100: per instance and stage it reads H, dvec, g,
// z twice (stage and successor), pi twice, F three times, b, Ll twice,
// Lxx twice, z and pi once more for the update, and writes z and pi --
// ~620 scalars at the flagship (N=30, NZ=11, NX=8, NU=3), ~2.5 KB in f32
// (F's repeated reads come from L1/L2) -- against ~1.3k flops: ~0.5
// flop/byte, memory bound in principle, latency bound with one thread per
// instance (128 warps at B=4096).
//
// Design: the TPU grid's 2(N+1) steps become two loops inside the thread.
// The stage products H z, F pi and F' z are hp::sym_mv_acc, hp::f_mv_acc
// and hp::ft_mv_acc, shared with csrc/resid_terms_flat.cu (the unfused
// pass).
// Backward, stages N..0: rq and rb are assembled in registers, never
// stored (the TPU keeps them in VMEM too); rb goes to per-instance global
// scratch for the forward loop (the TPU's rb slab), as do eu and px; the
// px carry stays in registers and Lxx_{k+1} is read back from the
// retained factor.  Forward, stages 0..N: root solve for x_0, then pi_{s-1}
// from stage s, u, the update, and x_{s+1}.  The index rules of the TPU
// kernel hold: F pi_k only for k < N, the pi coupling row only for k >= 1,
// rb at k = N never formed, pi_new[s-1] written from stage s.
//
// Specialisation: NU, NX, NG compile-time (-D, one library per shape);
// "has ng rows" a template parameter; N and the ng table runtime.
#include "stage_math.cuh"

#if !defined(HP_NU) || !defined(HP_NX) || !defined(HP_NG)
#error "compile with -DHP_NU=.. -DHP_NX=.. -DHP_NG=.."
#endif

namespace {

constexpr int NU = HP_NU;
constexpr int NX = HP_NX;
constexpr int NZ = NU + NX;
constexpr int NG = HP_NG;
constexpr int NT = NZ * (NZ + 1) / 2;
constexpr int BLOCK = 32;

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
  void* work;            // ((N+1)(NU+2NX), B): eu, px, rb
  int64_t B;
  int64_t N;
  int64_t n_ng;
};

template <typename T, bool HAS_NG>
__global__ void __launch_bounds__(BLOCK) refine_flat_kernel(RefineArgs a) {
  using hp::Col;
  const int64_t B = a.B;
  const int64_t bi = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (bi >= B) return;
  const int N = static_cast<int>(a.N);
  const int n_ng = static_cast<int>(a.n_ng);
  const int* ng_stage = static_cast<const int*>(a.ng_stage);
  auto in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + bi, B};
  };
  auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + bi, B}; };
  const Col<const T> Hc = in(a.H), dvc = in(a.dvec), gc = in(a.g),
                     Fc = in(a.F), bc = in(a.b), zc = in(a.z),
                     pic = in(a.pi), Llc = in(a.Ll), Lxxc = in(a.Lxx);
  const Col<T> zo = out(a.z_new), pio = out(a.pi_new);
  T* w = static_cast<T*>(a.work);
  const int64_t Np1 = N + 1;
  const Col<T> eus{w + bi, B};
  const Col<T> pxs{w + Np1 * NU * B + bi, B};
  const Col<T> rbs{w + Np1 * (NU + NX) * B + bi, B};
  const Col<const T> rbc{rbs.p, B};

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

  // ---- backward: residuals of stage k + substitution, k = N..0 ----------
  T px_c[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) px_c[i] = T(0);
  for (int k = N; k >= 0; --k) {
    const int64_t rz = static_cast<int64_t>(k) * NZ;
    const int64_t f0 = static_cast<int64_t>(k < N ? k : N - 1) * NZ * NX;
    T z[NZ], rq[NZ];
    hp::load(z, zc, rz);
#pragma unroll
    for (int i = 0; i < NZ; ++i) rq[i] = gc(rz + i) + dvc(rz + i) * z[i];
    hp::sym_mv_acc<T, NZ>(Hc, static_cast<int64_t>(k) * NT, z, rq);
    T Pbpx[NX];
    if (k < N) {
      T piv[NX], rb[NX], Lxx[NX][NX], Pb[NX];
      hp::load(piv, pic, static_cast<int64_t>(k) * NX);
      hp::f_mv_acc<T, NZ, NX>(Fc, f0, piv, rq);
      hp::load(rb, bc, static_cast<int64_t>(k) * NX);
      hp::ft_mv_acc<T, NZ, NX>(Fc, f0, z, rb);
#pragma unroll
      for (int q = 0; q < NX; ++q)
        rb[q] = rb[q] - zc(static_cast<int64_t>(k + 1) * NZ + NU + q);
      hp::store(rbs, static_cast<int64_t>(k) * NX, rb);
      load_lxx(k + 1, Lxx);
      hp::pb_of<T, NX>(Lxx, rb, Pb);
#pragma unroll
      for (int q = 0; q < NX; ++q) Pbpx[q] = Pb[q] + px_c[q];
    } else {
#pragma unroll
      for (int q = 0; q < NX; ++q) Pbpx[q] = T(0);
    }
    if (k >= 1) {
#pragma unroll
      for (int q = 0; q < NX; ++q)
        rq[NU + q] = rq[NU + q] - pic(static_cast<int64_t>(k - 1) * NX + q);
    }
    if (HAS_NG) {
      for (int jg = 0; jg < n_ng; ++jg) {
        if (ng_stage[jg] != k) continue;
        const Col<const T> Cc = in(a.C), qc = in(a.qxg);
        T qcz[NG];
#pragma unroll
        for (int gg = 0; gg < NG; ++gg) {
          const int64_t c0 = (static_cast<int64_t>(jg) * NG + gg) * NZ;
          T cz = Cc(c0) * z[0];
#pragma unroll
          for (int i = 1; i < NZ; ++i) cz = cz + Cc(c0 + i) * z[i];
          qcz[gg] = qc(static_cast<int64_t>(jg) * NG + gg) * cz;
        }
#pragma unroll
        for (int i = 0; i < NZ; ++i) {
          const int64_t c0 = static_cast<int64_t>(jg) * NG * NZ + i;
          T acc = Cc(c0) * qcz[0];
#pragma unroll
          for (int gg = 1; gg < NG; ++gg) acc = acc + Cc(c0 + gg * NZ) * qcz[gg];
          rq[i] = rq[i] + acc;
        }
      }
    }
    T Ll[NZ][NU], Dinv_u[NU], eu[NU], px[NX];
    load_ll(k, Ll);
    hp::dinv_diag<T, NU>(Ll, Dinv_u);
    hp::trs_stage<T, NU, NX>(Ll, Dinv_u, rq, Fc, f0, Pbpx, k == N, eu, px);
#pragma unroll
    for (int q = 0; q < NX; ++q) px_c[q] = px[q];
    hp::store(eus, static_cast<int64_t>(k) * NU, eu);
    hp::store(pxs, static_cast<int64_t>(k) * NX, px);
  }

  // ---- forward: correction, update, s = 0..N -----------------------------
  T x[NX];
  {
    T Lxx[NX][NX], px0[NX];
    load_lxx(0, Lxx);
    hp::load(px0, pxs, 0);
    hp::root_x0<T, NX>(Lxx, px0, x);
  }
  for (int s = 0; s <= N; ++s) {
    T Ll[NZ][NU], eu[NU], Dinv_u[NU], u[NU], dz[NZ], zn[NZ];
    load_ll(s, Ll);
    hp::load(eu, eus, static_cast<int64_t>(s) * NU);
    if (s >= 1) {
      T Lxx[NX][NX], pxv[NX], dpi[NX];
      load_lxx(s, Lxx);
      hp::load(pxv, pxs, static_cast<int64_t>(s) * NX);
      hp::pi_of_x<T, NX>(Lxx, pxv, x, dpi);
#pragma unroll
      for (int q = 0; q < NX; ++q) {
        const int64_t r = static_cast<int64_t>(s - 1) * NX + q;
        pio(r) = pic(r) + dpi[q];
      }
    }
    hp::dinv_diag<T, NU>(Ll, Dinv_u);
    hp::u_of_x<T, NU, NX>(Ll, Dinv_u, eu, x, u);
#pragma unroll
    for (int i = 0; i < NU; ++i) dz[i] = u[i];
#pragma unroll
    for (int i = 0; i < NX; ++i) dz[NU + i] = x[i];
    hp::load(zn, zc, static_cast<int64_t>(s) * NZ);
#pragma unroll
    for (int i = 0; i < NZ; ++i) zn[i] = zn[i] + dz[i];
    hp::store(zo, static_cast<int64_t>(s) * NZ, zn);
    const int se = s < N - 1 ? s : N - 1;
    hp::x_next_of<T, NZ, NX>(Fc, static_cast<int64_t>(se) * NZ * NX, rbc,
                             static_cast<int64_t>(se) * NX, dz, x);
  }
}

template <typename T, bool HAS_NG>
static int launch(const RefineArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + BLOCK - 1) / BLOCK;
  refine_flat_kernel<T, HAS_NG>
      <<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
