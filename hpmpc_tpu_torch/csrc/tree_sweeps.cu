// Scenario-tree Riccati sweeps of a batch of tree KKT systems, one CUDA
// thread per instance, each in ONE kernel:
//
//   * hp_tree_factor_solve_flat (Queue 2 row 26): the folded backward
//     factorization over nodes n-1..0, then the forward recovery over nodes
//     0..n-1.  Replaces: hpmpc_tpu/ops/tree_kernel.py::tree_factor_solve_flat,
//     two TPU calls: the backward sweep (_tree_bwd_kernel) and the forward
//     recovery (_tree_forward_from_lanes -> _tree_fwd_kernel).  Plain
//     version: hpmpc_tpu_torch/ops/tree_kernel.py::tree_factor_solve_flat_ref.
//   * hp_tree_solve_flat (Queue 2 row 27): the retained-factor backward
//     substitution with the cached Pb, then the forward recovery with pi.
//     Replaces: hpmpc_tpu/ops/tree_kernel.py::tree_solve_flat
//     (_tree_trs_kernel + _tree_fwd_kernel).  Plain version:
//     hpmpc_tpu_torch/ops/tree_kernel.py::tree_solve_flat_ref.
//
// Topology: nodes are breadth-first (dad[k] < k), so reverse id order puts
// every child before its parent.  Node k > 0 owns edge e = k-1 (F_e, b_e,
// Pb_e, pi_e).  A node's children are not at a fixed offset, so the
// parent-child coupling goes through a per-node accumulator indexed by the
// int32 table dad: the backward loop adds, at node k, the packed W W' (W =
// F_e Lxx_k) and F_e (Pb_e + px_k) into the accumulator of dad[k]
// (d_tree_back_ric_rec_libstr.c:120 walks tree[ii].dad the same way); node
// k reads its own accumulator before it factors.  The forward loop reads
// the parent's z back from the thread's own column of the z output.
//
// The TPU keeps the accumulator as a VMEM slab (or streams it through HBM
// with DMAs, tree_kernel.py:122-145, :242-254).  Here it is per-instance
// global scratch, batch-last (n, NT+NZ, B) -- (n, NZ, B) in the re-solve --
// so neighbouring threads touch neighbouring addresses (coalesced).  Each
// thread owns its own column: no atomics, no ordering between threads or
// blocks.  The thread zeroes its column before the sweep (leaves read
// zero).  The children of a node add in reverse id order, as on the TPU.
//
// What bounds them on the H100.  Row 26, per instance at tools/bench_tree.py's
// 71-node tree (nx=4 nu=2: NZ=6, NX=4, NT=21): inputs read once -- H, dvec,
// g per node (33 scalars), F, b per edge (28) -- ~4.3k scalars; outputs
// written once -- Ll, Lxx, z per node (34), Pb per edge (4) -- ~2.7k: ~28 KB
// in f32, 115 MB at B=4096, 0.034 ms at 3.35 TB/s, against ~0.8 kflop a
// node (the 6x6 Cholesky, W, W W', the solves): ~2 flop/byte, memory bound
// in principle.  The accumulator adds ~5.8k scalars of traffic an instance
// (zeroing, the node's read, the parent's read-modify-write: 3 x 27 x n),
// ~94 MB at B=4096, and the forward loop re-reads the factor; the bound
// (chip_smoke.py) charges neither: it counts the function's inputs and
// outputs, each once.  Row 27 reads Ll, Lxx (root), Pb, g, F, b and writes
// z and pi; its accumulator is NZ wide.  With one thread per instance
// (4096 threads = 128 warps, about one warp per SM) each thread walks 2n
// dependent node steps of dependent global loads: latency bound, as rows 9
// and 16 are.
//
// Specialisation: NU, NX compile-time (-D, one library per shape); WANT_PI
// and "has ng rows" template parameters; n, dad and the ng node table
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
constexpr int BLOCK = 32;

}  // namespace

// Mirrors _TreeFactorArgs in hpmpc_tpu_torch/ops/tree_kernel.py field for
// field.
struct TreeFactorArgs {
  const void* dad;      // (n,) int32 parent of each node, dad[0] = 0
  const void* H;        // (n, NT, B) packed lower triangle
  const void* dvec;     // (n, NZ, B) barrier diagonal (+ pad + reg)
  const void* ngl;      // (n_ng, NT, B) packed C' diag(Qx_g) C
  const void* ng_node;  // (n_ng,) int32 node of each ng slot
  const void* g;        // (n, NZ, B) effective gradient
  const void* F;        // (n-1, NZ, NX, B)
  const void* b;        // (n-1, NX, B)
  void* Ll;             // (n, NZ, NU, B)
  void* Lxx;            // (n, NX, NX, B), upper triangle 0
  void* Pb;             // (n-1, NX, B)
  void* z;              // (n, NZ, B)
  void* pi;             // (n-1, NX, B), written with want_pi only
  void* acc;            // (n (NT+NZ), B) scratch: the children's terms
  void* work;           // (n (NU+NX), B) scratch: eu, px
  int64_t B;
  int64_t n;
  int64_t n_ng;
  int64_t want_pi;
};

// Mirrors _TreeSolveArgs in hpmpc_tpu_torch/ops/tree_kernel.py.
struct TreeSolveArgs {
  const void* dad;  // (n,) int32, dad[0] = 0
  const void* Ll;   // (n, NZ, NU, B)
  const void* Lxx;  // (n, NX, NX, B), upper triangle 0
  const void* Pb;   // (n-1, NX, B)
  const void* g;    // (n, NZ, B)
  const void* F;    // (n-1, NZ, NX, B)
  const void* b;    // (n-1, NX, B)
  void* z;          // (n, NZ, B)
  void* pi;         // (n-1, NX, B)
  void* acc;        // (n NZ, B) scratch: the children's gradient terms
  void* work;       // (n (NU+NX), B) scratch: eu, px
  int64_t B;
  int64_t n;
};

// The forward recovery (_tree_fwd_kernel), nodes 0..n-1: the root's free
// initial state x0 = -(Lxx0 Lxx0')^{-1} px0 from the root's factor Lxx0,
// then x_k = b_e + F_e' z_dad(k) on the edge e = k-1 into node k, with
// WANT_PI pi_e = Lxx_k (Lxx_k' x_k) + px_k, u_k = -Luu^{-T} (eu_k + Lxu'
// x_k) and z_k = [u_k; x_k].  The parent's z is read back from the z
// output: the same thread wrote it earlier (dad[k] < k).  Without WANT_PI
// the pi column is never touched.
template <typename T, bool WANT_PI, typename CL>
__device__ __forceinline__ void tree_forward(
    int n, const int* dad, const T (&Lxx0)[NX][NX], const CL& Llc,
    const hp::Col<const T>& Lxxc, const hp::Col<T>& eus,
    const hp::Col<T>& pxs, const hp::Col<const T>& Fc,
    const hp::Col<const T>& bc, const hp::Col<T>& zo, const hp::Col<T>& pio) {
  for (int k = 0; k < n; ++k) {
    T x[NX];
    if (k == 0) {
      T px0[NX];
      hp::load(px0, pxs, 0);
      hp::root_x0<T, NX>(Lxx0, px0, x);
    } else {
      T zd[NZ];
      hp::load(zd, zo, static_cast<int64_t>(dad[k]) * NZ);
      hp::x_next_of<T, NZ, NX>(Fc, static_cast<int64_t>(k - 1) * NZ * NX,
                               bc, static_cast<int64_t>(k - 1) * NX, zd, x);
      if (WANT_PI) {
        T Lxx[NX][NX], pxv[NX], piv[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j)
            Lxx[i][j] = Lxxc((static_cast<int64_t>(k) * NX + i) * NX + j);
        hp::load(pxv, pxs, static_cast<int64_t>(k) * NX);
        hp::pi_of_x<T, NX>(Lxx, pxv, x, piv);
        hp::store(pio, static_cast<int64_t>(k - 1) * NX, piv);
      }
    }
    T Ll[NZ][NU], eu[NU], Dinv_u[NU], u[NU], zt[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j)
        Ll[i][j] = Llc((static_cast<int64_t>(k) * NZ + i) * NU + j);
    hp::load(eu, eus, static_cast<int64_t>(k) * NU);
    hp::dinv_diag<T, NU>(Ll, Dinv_u);
    hp::u_of_x<T, NU, NX>(Ll, Dinv_u, eu, x, u);
#pragma unroll
    for (int i = 0; i < NU; ++i) zt[i] = u[i];
#pragma unroll
    for (int i = 0; i < NX; ++i) zt[NU + i] = x[i];
    hp::store(zo, static_cast<int64_t>(k) * NZ, zt);
  }
}

template <typename T, bool WANT_PI, bool HAS_NG>
__global__ void __launch_bounds__(BLOCK)
    tree_factor_solve_flat_kernel(TreeFactorArgs a) {
  using hp::Col;
  constexpr int NTOT = NT + NZ;
  const int64_t B = a.B;
  const int64_t bi = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (bi >= B) return;
  const int n = static_cast<int>(a.n);
  const int n_ng = static_cast<int>(a.n_ng);
  const int* dad = static_cast<const int*>(a.dad);
  const int* ng_node = static_cast<const int*>(a.ng_node);

  auto in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + bi, B};
  };
  auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + bi, B}; };
  const Col<const T> Hc = in(a.H), dvc = in(a.dvec), gc = in(a.g),
                     Fc = in(a.F), bc = in(a.b);
  const Col<T> Llo = out(a.Ll), Lxxo = out(a.Lxx), Pbo = out(a.Pb),
               zo = out(a.z), acc = out(a.acc);
  T* w = static_cast<T*>(a.work);
  const Col<T> eus{w + bi, B};
  const Col<T> pxs{w + static_cast<int64_t>(n) * NU * B + bi, B};

  for (int64_t r = 0; r < static_cast<int64_t>(n) * NTOT; ++r) acc(r) = T(0);

  // ---- backward: assemble + factor, k = n-1..0 ---------------------------
  T Lxx0[NX][NX];  // the root's Lxx, the last one factored
  for (int k = n - 1; k >= 0; --k) {
    const int64_t a0 = static_cast<int64_t>(k) * NTOT;
    T M[NZ][NZ], m[NZ];
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j)
        M[i][j] = Hc(static_cast<int64_t>(k) * NT + hp::sym_idx(i, j));
#pragma unroll
    for (int i = 0; i < NZ; ++i)
      M[i][i] = M[i][i] + dvc(static_cast<int64_t>(k) * NZ + i);
    if (HAS_NG) {
      for (int jg = 0; jg < n_ng; ++jg) {
        if (ng_node[jg] != k) continue;
        const Col<const T> nglc = in(a.ngl);
#pragma unroll
        for (int i = 0; i < NZ; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j)
            M[i][j] = M[i][j] +
                      nglc(static_cast<int64_t>(jg) * NT + hp::sym_idx(i, j));
      }
    }
    // the children's terms (zero at a leaf)
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j)
        M[i][j] = M[i][j] + acc(a0 + hp::sym_idx(i, j));
#pragma unroll
    for (int i = 0; i < NZ; ++i)
      m[i] = gc(static_cast<int64_t>(k) * NZ + i) + acc(a0 + NT + i);

    T Dinv[NZ];
    hp::chol<T, NZ>(M, Dinv);
    T Dinv_u[NU], m_u[NU], eu[NU], px[NX];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      Dinv_u[i] = Dinv[i];
      m_u[i] = m[i];
    }
    hp::tril_solve<T, NU>(M, Dinv_u, m_u, eu);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T s = m[NU + i];
#pragma unroll
      for (int q = 0; q < NU; ++q) s = s - M[NU + i][q] * eu[q];
      px[i] = s;
    }
    T Lxx[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) Lxx[i][j] = j <= i ? M[NU + i][NU + j] : T(0);
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j)
        Llo((static_cast<int64_t>(k) * NZ + i) * NU + j) =
            j <= i ? M[i][j] : T(0);
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j)
        Lxxo((static_cast<int64_t>(k) * NX + i) * NX + j) = Lxx[i][j];
    hp::store(eus, static_cast<int64_t>(k) * NU, eu);
    hp::store(pxs, static_cast<int64_t>(k) * NX, px);

    if (k == 0) {  // the root has no incoming edge: no contribution, no Pb
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) Lxx0[i][j] = Lxx[i][j];
      break;
    }
    // contribution through the edge e = k-1 into the parent's accumulator
    const int64_t e = k - 1;
    T F[NZ][NX], bb[NX], Pb[NX], W[NZ][NX];
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) F[i][j] = Fc((e * NZ + i) * NX + j);
    hp::load(bb, bc, e * NX);
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T s = F[i][j] * Lxx[j][j];
#pragma unroll
        for (int q = j + 1; q < NX; ++q) s = s + F[i][q] * Lxx[q][j];
        W[i][j] = s;
      }
    }
    hp::pb_of<T, NX>(Lxx, bb, Pb);
    hp::store(Pbo, e * NX, Pb);
    const int64_t d0 = static_cast<int64_t>(dad[k]) * NTOT;
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T s = W[i][0] * W[j][0];
#pragma unroll
        for (int q = 1; q < NX; ++q) s = s + W[i][q] * W[j][q];
        acc(d0 + hp::sym_idx(i, j)) = acc(d0 + hp::sym_idx(i, j)) + s;
      }
    }
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      T s = F[i][0] * (Pb[0] + px[0]);
#pragma unroll
      for (int q = 1; q < NX; ++q) s = s + F[i][q] * (Pb[q] + px[q]);
      acc(d0 + NT + i) = acc(d0 + NT + i) + s;
    }
  }

  // ---- forward: z (and pi), k = 0..n-1 ------------------------------------
  tree_forward<T, WANT_PI>(n, dad, Lxx0, Llo, in(a.Lxx), eus, pxs, Fc, bc,
                           zo, WANT_PI ? out(a.pi) : zo);  // zo: unused
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    tree_solve_flat_kernel(TreeSolveArgs a) {
  using hp::Col;
  const int64_t B = a.B;
  const int64_t bi = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (bi >= B) return;
  const int n = static_cast<int>(a.n);
  const int* dad = static_cast<const int*>(a.dad);
  auto in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + bi, B};
  };
  auto out = [&](void* p) { return Col<T>{static_cast<T*>(p) + bi, B}; };
  const Col<const T> Llc = in(a.Ll), Lxxc = in(a.Lxx), Pbc = in(a.Pb),
                     gc = in(a.g), Fc = in(a.F), bc = in(a.b);
  const Col<T> acc = out(a.acc);
  T* w = static_cast<T*>(a.work);
  const Col<T> eus{w + bi, B};
  const Col<T> pxs{w + static_cast<int64_t>(n) * NU * B + bi, B};

  for (int64_t r = 0; r < static_cast<int64_t>(n) * NZ; ++r) acc(r) = T(0);

  // ---- backward substitution on the retained factor, k = n-1..0 ----------
  for (int k = n - 1; k >= 0; --k) {
    T Ll[NZ][NU], Dinv_u[NU], m[NZ], m_u[NU], eu[NU], px[NX];
#pragma unroll
    for (int i = 0; i < NZ; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j)
        Ll[i][j] = Llc((static_cast<int64_t>(k) * NZ + i) * NU + j);
    hp::dinv_diag<T, NU>(Ll, Dinv_u);
#pragma unroll
    for (int i = 0; i < NZ; ++i)
      m[i] = gc(static_cast<int64_t>(k) * NZ + i) +
             acc(static_cast<int64_t>(k) * NZ + i);
#pragma unroll
    for (int i = 0; i < NU; ++i) m_u[i] = m[i];
    hp::tril_solve<T, NU>(Ll, Dinv_u, m_u, eu);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T s = m[NU + i];
#pragma unroll
      for (int q = 0; q < NU; ++q) s = s - Ll[NU + i][q] * eu[q];
      px[i] = s;
    }
    hp::store(eus, static_cast<int64_t>(k) * NU, eu);
    hp::store(pxs, static_cast<int64_t>(k) * NX, px);
    if (k == 0) break;
    const int64_t e = k - 1;
    const int64_t d0 = static_cast<int64_t>(dad[k]) * NZ;
    T Pb[NX];
    hp::load(Pb, Pbc, e * NX);
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      T s = Fc((e * NZ + i) * NX) * (Pb[0] + px[0]);
#pragma unroll
      for (int q = 1; q < NX; ++q)
        s = s + Fc((e * NZ + i) * NX + q) * (Pb[q] + px[q]);
      acc(d0 + i) = acc(d0 + i) + s;
    }
  }

  // ---- forward with pi ----------------------------------------------------
  T Lxx0[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) Lxx0[i][j] = Lxxc(i * NX + j);
  tree_forward<T, true>(n, dad, Lxx0, Llc, Lxxc, eus, pxs, Fc, bc, out(a.z),
                        out(a.pi));
}

template <typename T, bool WANT_PI, bool HAS_NG>
static int launch_factor(const TreeFactorArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + BLOCK - 1) / BLOCK;
  tree_factor_solve_flat_kernel<T, WANT_PI, HAS_NG>
      <<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch_factor(const TreeFactorArgs& a, cudaStream_t stream) {
  const bool ng = a.n_ng > 0;
  if (a.want_pi)
    return ng ? launch_factor<T, true, true>(a, stream)
              : launch_factor<T, true, false>(a, stream);
  return ng ? launch_factor<T, false, true>(a, stream)
            : launch_factor<T, false, false>(a, stream);
}

template <typename T>
static int launch_solve(const TreeSolveArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.B + BLOCK - 1) / BLOCK;
  tree_solve_flat_kernel<T>
      <<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hp_tree_factor_solve_flat(const TreeFactorArgs* a,
                                         int dtype_code,
                                         cudaStream_t stream) {
  if (a->B <= 0 || a->n < 2 || a->n_ng < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return dispatch_factor<float>(*a, stream);
  if (dtype_code == 1) return dispatch_factor<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int hp_tree_solve_flat(const TreeSolveArgs* a, int dtype_code,
                                  cudaStream_t stream) {
  if (a->B <= 0 || a->n < 2) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return launch_solve<float>(*a, stream);
  if (dtype_code == 1) return launch_solve<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
