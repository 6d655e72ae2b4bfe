// The three stage products of the KKT residual for a batch of OCP
// iterates, one CUDA thread per (stage, instance):
//   hz_n = H_n z_n (packed symmetric H),  fz_n = F_n' z_n,  fpi_n = F_n pi_n.
// The unfused iterative-refinement pass assembles its Newton residuals from
// them (models/ipm_lanes.py).
//
// Replaces: hpmpc_tpu/ops/stage_kernel.py::resid_terms_flat (TPU body
// _resid_kernel, one call on a (block, N+1) grid).  Plain version:
// hpmpc_tpu_torch/ops/stage_kernel.py::resid_terms_flat_ref.
//
// The stage-N slices of fz and fpi (no F_N, no pi_N) are written as zero;
// the TPU kernel leaves them unspecified and its callers read stages < N.
//
// What bounds it on the H100: memory.  Per (stage, instance) it reads the
// packed Hessian (NT), F (NZ*NX), z and pi -- 66+88+11+8 = 173 scalars at
// the flagship (NZ=11, NX=8) -- and writes 11+8+11 = 30, against 2 NZ^2 +
// 4 NZ NX ~ 600 flops: ~0.7 flop/byte in f32, far below the card's ~20
// flop/byte fp32 balance point.
//
// Design: the TPU grid (nb blocks of 1024 lanes, N+1 stage steps) becomes
// one flat grid of (N+1)*B threads, as csrc/resid_full.cu.  Streams are
// batch-last, so the threads of a warp (consecutive instances, same stage)
// read consecutive addresses: every load is coalesced and each byte is
// read once.  The products are hp::sym_mv_acc, hp::ft_mv_acc and
// hp::f_mv_acc from zero, shared with the fused pass
// (csrc/refine_flat.cu).
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
constexpr int NT = NZ * (NZ + 1) / 2;
constexpr int BLOCK = 128;

}  // namespace

// Mirrors _ResidTermsArgs in hpmpc_tpu_torch/ops/stage_kernel.py field for
// field.
struct ResidTermsArgs {
  const void* H;   // (N+1, NT, B) packed lower triangle
  const void* F;   // (N, NZ, NX, B)
  const void* z;   // (N+1, NZ, B)
  const void* pi;  // (N, NX, B)
  void* hz;        // (N+1, NZ, B)
  void* fz;        // (N+1, NX, B)
  void* fpi;       // (N+1, NZ, B)
  int64_t B;
  int64_t N;
};

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    resid_terms_flat_kernel(ResidTermsArgs a) {
  using hp::Col;
  const int64_t B = a.B;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= (a.N + 1) * B) return;
  const int64_t k = t / B, bi = t - k * B;
  const int64_t N = a.N;
  auto in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + bi, B};
  };
  auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + bi, B}; };
  const Col<const T> Hc = in(a.H), Fc = in(a.F), zc = in(a.z),
                     pic = in(a.pi);

  T z[NZ], hz[NZ] = {}, fz[NX] = {}, fpi[NZ] = {};
  hp::load(z, zc, k * NZ);
  hp::sym_mv_acc<T, NZ>(Hc, k * NT, z, hz);
  if (k < N) {
    T piv[NX];
    hp::load(piv, pic, k * NX);
    hp::ft_mv_acc<T, NZ, NX>(Fc, k * NZ * NX, z, fz);
    hp::f_mv_acc<T, NZ, NX>(Fc, k * NZ * NX, piv, fpi);
  }
  hp::store(out(a.hz), k * NZ, hz);
  hp::store(out(a.fz), k * NX, fz);
  hp::store(out(a.fpi), k * NZ, fpi);
}

template <typename T>
static int launch(const ResidTermsArgs& a, cudaStream_t stream) {
  const int64_t blocks = ((a.N + 1) * a.B + BLOCK - 1) / BLOCK;
  resid_terms_flat_kernel<T>
      <<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hp_resid_terms_flat(const ResidTermsArgs* a, int dtype_code,
                                   cudaStream_t stream) {
  if (a->B <= 0 || a->N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return launch<float>(*a, stream);
  if (dtype_code == 1) return launch<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
