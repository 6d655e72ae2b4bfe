// Exact KKT residuals of a batched IPM iterate, one CUDA thread per
// (stage, instance).
//
// Replaces: hpmpc_tpu/ops/step_kernel.py::resid_full_flat (TPU body
// _resid_kernel), the twin of the reference's d_res_res_mpc_hard_tv.
// Plain version: hpmpc_tpu_torch/ops/step_kernel.py::resid_full_ref.
//
// What bounds it on the H100: memory.  Per (stage, instance) it reads the
// packed Hessian (NT), F (NZ*NX), z twice, pi twice, g, b, the four box
// streams and the masks -- about 66+88+2*11+2*8+11+8+4*14+11+8 = 286
// scalars at the flagship (NZ=11, NX=8, NB=7) -- and writes 11+8+2*14+1 =
// 48, for roughly 2*NZ^2 + 2*NZ*NX ~ 600 flops: ~0.5 flop/byte in f32,
// far below the card's ~20 flop/byte fp32 balance point.
//
// Design: the TPU grid (nb blocks of 1024 lanes, N+1 stage steps) becomes
// one flat grid of (N+1)*B threads.  Streams are batch-last, so the
// threads of a warp (consecutive instances, same stage) read consecutive
// addresses: every load is coalesced and each byte is read once.  The box
// gather/scatter through the (N+1, NB) index table is a select chain over
// the NZ slots, which keeps z and rq in registers.
#include "stage_math.cuh"

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
constexpr int BLOCK = 128;

}  // namespace

// Mirrors _ResidArgs in hpmpc_tpu_torch/ops/step_kernel.py field for field.
struct ResidArgs {
  const void* idx;    // (N+1, NB) int32
  const void* H;      // (N+1, NT, B) packed lower triangle
  const void* F;      // (N, NZ, NX, B)
  const void* z;      // (N+1, NZ, B)
  const void* pi;     // (N, NX, B)
  const void* g;      // (N+1, NZ, B)
  const void* b;      // (N, NX, B)
  const void* lam;    // (N+1, 2NB, B)
  const void* t;      // (N+1, 2NB, B)
  const void* dcat;   // (N+1, 2NB, B)
  const void* mb;     // (N+1, 2NB, B)
  const void* zmask;  // (N+1, NZ, B)
  const void* xmask;  // (N, NX, B)
  void* rq;           // (N+1, NZ, B)
  void* rb;           // (N+1, NX, B), stage N garbage
  void* rd;           // (N+1, 2NB, B)
  void* rm;           // (N+1, 2NB, B)
  void* musum;        // (N+1, B)
  int64_t B;
  int64_t N;
};

template <typename T>
__global__ void __launch_bounds__(BLOCK) resid_full_kernel(ResidArgs a) {
  using hp::Col;
  const int64_t B = a.B;
  const int N = static_cast<int>(a.N);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (tid >= (N + 1) * B) return;
  const int n = static_cast<int>(tid / B);
  const int64_t bi = tid - n * B;
  auto in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + bi, B};
  };
  auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + bi, B}; };
  const Col<const T> H = in(a.H), F = in(a.F), zc = in(a.z), pic = in(a.pi),
                     gc = in(a.g), bc = in(a.b), lamc = in(a.lam),
                     tc = in(a.t), dcc = in(a.dcat), mbc = in(a.mb),
                     zmc = in(a.zmask), xmc = in(a.xmask);
  const int* idx = static_cast<const int*>(a.idx) + n * NB;

  const int ne = n < N - 1 ? n : N - 1;              // clip(n, 0, N-1)
  const int np = n - 1 < 0 ? 0 : (n - 1 > N - 1 ? N - 1 : n - 1);
  const int nn = n + 1 < N ? n + 1 : N;              // clip(n+1, 0, N)
  const T interior = n < N ? T(1) : T(0);
  const T not_first = n > 0 ? T(1) : T(0);

  T z[NZ], piv[NX], pip[NX];
  hp::load(z, zc, static_cast<int64_t>(n) * NZ);
  hp::load(piv, pic, static_cast<int64_t>(ne) * NX);
  hp::load(pip, pic, static_cast<int64_t>(np) * NX);
  const int64_t h0 = static_cast<int64_t>(n) * NT;
  const int64_t f0 = static_cast<int64_t>(ne) * NZ * NX;

  T rq[NZ];
#pragma unroll
  for (int i = 0; i < NZ; ++i) {
    T acc = gc(static_cast<int64_t>(n) * NZ + i);
#pragma unroll
    for (int j = 0; j < NZ; ++j) {
      const int p = i >= j ? hp::sym_idx(i, j) : hp::sym_idx(j, i);
      acc = acc + H(h0 + p) * z[j];
    }
    T fpi = F(f0 + i * NX) * piv[0];
#pragma unroll
    for (int x = 1; x < NX; ++x) fpi = fpi + F(f0 + i * NX + x) * piv[x];
    acc = acc + interior * fpi;
    if (i >= NU) acc = acc - not_first * pip[i - NU];
    rq[i] = acc;
  }

  T lam[NB2], t[NB2], dcat[NB2], mb[NB2];
  const int64_t k0 = static_cast<int64_t>(n) * NB2;
  hp::load(lam, lamc, k0);
  hp::load(t, tc, k0);
  hp::load(dcat, dcc, k0);
  hp::load(mb, mbc, k0);
  T lam_f[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) lam_f[k] = (lam[NB + k] - lam[k]) * mb[k];
  hp::scatter_add_box<T, NB, NZ>(rq, idx, lam_f);
  const Col<T> rqo = out(a.rq);
#pragma unroll
  for (int i = 0; i < NZ; ++i)
    rqo(static_cast<int64_t>(n) * NZ + i) =
        rq[i] * zmc(static_cast<int64_t>(n) * NZ + i);

  // rb_n = (b_n + F_n' z_n - x_{n+1}) * x_mask (garbage at stage N)
  const Col<T> rbo = out(a.rb);
#pragma unroll
  for (int x = 0; x < NX; ++x) {
    T acc = F(f0 + x) * z[0];
#pragma unroll
    for (int j = 1; j < NZ; ++j) acc = acc + F(f0 + j * NX + x) * z[j];
    const T xn = zc(static_cast<int64_t>(nn) * NZ + NU + x);
    rbo(static_cast<int64_t>(n) * NX + x) =
        (bc(static_cast<int64_t>(ne) * NX + x) + acc - xn) *
        xmc(static_cast<int64_t>(ne) * NX + x);
  }

  // box slack / complementarity residuals + the mu partial sum
  T zb[NB];
  hp::gather_box<T, NB, NZ>(z, idx, zb);
  const Col<T> rdo = out(a.rd), rmo = out(a.rm);
  T musum = T(0);
#pragma unroll
  for (int k = 0; k < NB2; ++k) {
    const T zk = zb[k < NB ? k : k - NB];
    const T sg = k < NB ? T(1) : T(-1);
    rdo(k0 + k) = (dcat[k] - zk + sg * t[k]) * mb[k];
    const T rm = lam[k] * t[k] * mb[k];
    rmo(k0 + k) = rm;
    musum = musum + rm;
  }
  out(a.musum)(n) = musum;
}

template <typename T>
static int launch(const ResidArgs& a, cudaStream_t stream) {
  const int64_t threads = (a.N + 1) * a.B;
  const int64_t blocks = (threads + BLOCK - 1) / BLOCK;
  resid_full_kernel<T><<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hp_resid_full(const ResidArgs* a, int dtype_code,
                             cudaStream_t stream) {
  if (a->B <= 0 || a->N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return launch<float>(*a, stream);
  if (dtype_code == 1) return launch<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
