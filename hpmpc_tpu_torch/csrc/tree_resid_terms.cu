// The node and edge products of the scenario-tree KKT residual for a batch
// of tree iterates, one CUDA thread per (node, instance):
//   hz_k = H_k z_k (packed symmetric H)                on every node k,
//   fz_e = F_e' z_dad(k),  fpi_e = F_e pi_e            on the edge e = k-1
//                                                      into node k > 0.
// fpi is edge-major: the caller adds fpi_e onto the rows of node dad(e+1)
// (models/tree.py; JAX does it with a 0/1 selection matmul outside its
// kernel, tree.py:393-400).
//
// Replaces: hpmpc_tpu/ops/tree_kernel.py::tree_resid_terms_flat (Queue 2
// row 28; TPU body _tree_resid_kernel, one call on a (block, n) grid that
// keeps every node's z in a VMEM slab for the children's F' z_dad).  Plain
// version: hpmpc_tpu_torch/ops/tree_kernel.py::tree_resid_terms_flat_ref.
//
// What bounds it on the H100: memory.  Per (node, instance) it reads the
// packed Hessian (NT), z, and on an edge F (NZ*NX), the parent's z and pi
// -- 21+6+24+6+4 = 61 scalars at tools/bench_tree.py's tree (NZ=6, NX=4)
// -- and writes 6+4+6 = 16, against 2 NZ^2 + 4 NZ NX ~ 170 flops: ~0.6
// flop/byte in f32, far below the card's ~20 flop/byte fp32 balance point.
// The parent's z is a second read of a z column the parent's own thread
// reads too; the bound (chip_smoke.py) counts z once.
//
// Design: csrc/resid_terms_flat.cu with the parent table: the TPU grid (nb
// blocks of 1024 lanes, n node steps) becomes one flat grid of n*B
// threads.  Streams are batch-last, so the threads of a warp (consecutive
// instances, same node) read consecutive addresses, the parent's z
// included: every load is coalesced.  The products are hp::sym_mv_acc,
// hp::ft_mv_acc and hp::f_mv_acc from zero.
//
// Specialisation: NU, NX compile-time (-D, one library per shape); n and
// dad runtime.
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

// Mirrors _TreeResidArgs in hpmpc_tpu_torch/ops/tree_kernel.py field for
// field.
struct TreeResidArgs {
  const void* dad;  // (n,) int32 parent of each node, dad[0] = 0
  const void* H;    // (n, NT, B) packed lower triangle
  const void* F;    // (n-1, NZ, NX, B)
  const void* z;    // (n, NZ, B)
  const void* pi;   // (n-1, NX, B)
  void* hz;         // (n, NZ, B)
  void* fz;         // (n-1, NX, B)
  void* fpi;        // (n-1, NZ, B)
  int64_t B;
  int64_t n;
};

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    tree_resid_terms_flat_kernel(TreeResidArgs a) {
  using hp::Col;
  const int64_t B = a.B;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= a.n * B) return;
  const int64_t k = t / B, bi = t - k * B;
  auto in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + bi, B};
  };
  auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + bi, B}; };
  const Col<const T> Hc = in(a.H), Fc = in(a.F), zc = in(a.z),
                     pic = in(a.pi);

  T z[NZ], hz[NZ] = {};
  hp::load(z, zc, k * NZ);
  hp::sym_mv_acc<T, NZ>(Hc, k * NT, z, hz);
  hp::store(out(a.hz), k * NZ, hz);
  if (k == 0) return;  // the root has no incoming edge
  const int64_t e = k - 1;
  const int64_t p = static_cast<const int*>(a.dad)[k];
  T zd[NZ], piv[NX], fz[NX] = {}, fpi[NZ] = {};
  hp::load(zd, zc, p * NZ);
  hp::load(piv, pic, e * NX);
  hp::ft_mv_acc<T, NZ, NX>(Fc, e * NZ * NX, zd, fz);
  hp::f_mv_acc<T, NZ, NX>(Fc, e * NZ * NX, piv, fpi);
  hp::store(out(a.fz), e * NX, fz);
  hp::store(out(a.fpi), e * NZ, fpi);
}

template <typename T>
static int launch(const TreeResidArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.n * a.B + BLOCK - 1) / BLOCK;
  tree_resid_terms_flat_kernel<T>
      <<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hp_tree_resid_terms_flat(const TreeResidArgs* a,
                                        int dtype_code, cudaStream_t stream) {
  if (a->B <= 0 || a->n < 2) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return launch<float>(*a, stream);
  if (dtype_code == 1) return launch<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
