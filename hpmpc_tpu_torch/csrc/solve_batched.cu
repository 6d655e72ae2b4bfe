// Retained-factor re-solve of a batch of OCP KKT systems on the FULL factor
// in ONE kernel: backward substitution with the cached Pb + forward
// recovery with pi, one CUDA thread per instance.
//
// Replaces: hpmpc_tpu/ops/stage_kernel.py::solve_batched (Queue 2 row 15),
// two TPU calls: the backward substitution (_bwd_trs_kernel, :902) and the
// forward recovery (_fwd_kernel, :923), followed there by an XLA tail for
// stage N's u and x, which this kernel computes itself.  Plain version:
// hpmpc_tpu_torch/ops/stage_kernel.py::solve_batched_ref.
//
// What bounds it on the H100: per instance and stage it reads the Luu/Lxu
// columns of L twice and its Lxx block once, g, F twice, Pb and b, and
// writes z and pi -- the whole (NZ, NZ) factor is the input stream the
// byte count charges (61 MB of the ~100-130 MB a call moves in f32 at the
// flagship, N=30, NZ=11, B=4096), against ~0.7k flops per stage: memory
// bound in principle, latency bound with one thread per instance (128
// warps at B=4096).
//
// Design: csrc/solve_flat.cu (row 10) reading the full factor: stages N..0
// run hp::trs_stage on the gradient with the Pb + px carry (px in
// registers; Pb read for k < N only), eu/px go to per-instance global
// scratch in batch-last layout (the TPU's VMEM slabs); stages 0..N recover
// x from the root solve on L_0's Lxx block, pi_{s-1} = Lxx_s (Lxx_s' x_s) +
// px_s, u and z, stage N included.  F/b clip to N-1 at the terminal stage.
//
// Specialisation: NU, NX compile-time (-D, one library per shape); N
// runtime.
#include "stage_math.cuh"

#if !defined(HP_NU) || !defined(HP_NX)
#error "compile with -DHP_NU=.. -DHP_NX=.."
#endif

namespace {

constexpr int NU = HP_NU;
constexpr int NX = HP_NX;
constexpr int NZ = NU + NX;
constexpr int BLOCK = 32;

}  // namespace

// Mirrors _TrsArgs in hpmpc_tpu_torch/ops/stage_kernel.py field for field.
struct SolveBatchedArgs {
  const void* L;   // (N+1, NZ, NZ, B), lower triangle read
  const void* g;   // (N+1, NZ, B)
  const void* F;   // (N, NZ, NX, B)
  const void* b;   // (N, NX, B)
  const void* Pb;  // (N, NX, B)
  void* z;         // (N+1, NZ, B)
  void* pi;        // (N, NX, B)
  void* work;      // ((N+1)(NU+NX), B): eu, px
  int64_t B;
  int64_t N;
};

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    solve_batched_kernel(SolveBatchedArgs a) {
  using hp::Col;
  const int64_t B = a.B;
  const int64_t bi = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (bi >= B) return;
  const int N = static_cast<int>(a.N);
  auto in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + bi, B};
  };
  auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + bi, B}; };
  const Col<const T> Lc = in(a.L), gc = in(a.g), Fc = in(a.F), bc = in(a.b),
                     Pbc = in(a.Pb);
  const Col<T> zo = out(a.z), pio = out(a.pi);
  T* w = static_cast<T*>(a.work);
  const Col<T> eus{w + bi, B};
  const Col<T> pxs{w + static_cast<int64_t>(N + 1) * NU * B + bi, B};

  // the Luu/Lxu columns and the Lxx block of the factor of stage n
  auto load_ll = [&](int n, T (&Ll)[NZ][NU]) {
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j)
        Ll[i][j] = j <= i ? Lc((static_cast<int64_t>(n) * NZ + i) * NZ + j)
                          : T(0);
  };
  auto load_lxx = [&](int n, T (&Lxx)[NX][NX]) {
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j)
        Lxx[i][j] = j <= i ? Lc((static_cast<int64_t>(n) * NZ + NU + i) * NZ +
                                NU + j)
                           : T(0);
  };

  // ---- backward: retained-factor substitution, k = N..0 -----------------
  T px_c[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) px_c[i] = T(0);
  for (int k = N; k >= 0; --k) {
    T ge[NZ], Ll[NZ][NU], Dinv_u[NU], Pbpx[NX], eu[NU], px[NX];
    hp::load(ge, gc, static_cast<int64_t>(k) * NZ);
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

  // ---- forward: x, pi, u, z, s = 0..N -------------------------------------
  T x[NX];
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
    if (s >= 1) {
      T Lxx[NX][NX], pxv[NX], piv[NX];
      load_lxx(s, Lxx);
      hp::load(pxv, pxs, static_cast<int64_t>(s) * NX);
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
  }
}

template <typename T>
static int launch(const SolveBatchedArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + BLOCK - 1) / BLOCK;
  solve_batched_kernel<T>
      <<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hp_solve_batched(const SolveBatchedArgs* a, int dtype_code,
                                cudaStream_t stream) {
  if (a->B <= 0 || a->N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return launch<float>(*a, stream);
  if (dtype_code == 1) return launch<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
