// Scenario-tree Riccati sweeps of a batch of tree KKT systems, each in ONE
// kernel, the nodes of one depth level at once, a team of TEAM lanes a
// node:
//
//   * hp_tree_factor_solve_flat (Queue 2 row 26): the folded backward
//     factorization, deepest level first, then the forward recovery, root
//     level first.  Replaces: hpmpc_tpu/ops/tree_kernel.py::
//     tree_factor_solve_flat, two TPU calls: the backward sweep
//     (_tree_bwd_kernel) and the forward recovery (_tree_forward_from_lanes
//     -> _tree_fwd_kernel).  Plain version: hpmpc_tpu_torch/ops/
//     tree_kernel.py::tree_factor_solve_flat_ref.
//   * hp_tree_solve_flat (Queue 2 row 27): the retained-factor backward
//     substitution with the cached Pb, then the forward recovery with pi.
//     Replaces: hpmpc_tpu/ops/tree_kernel.py::tree_solve_flat
//     (_tree_trs_kernel + _tree_fwd_kernel).  Plain version:
//     hpmpc_tpu_torch/ops/tree_kernel.py::tree_solve_flat_ref.
//
// Topology: node k > 0 owns edge e = k-1 (F_e, b_e, Pb_e, pi_e) into it from
// its parent dad[k] < k.  In the backward sweep a node needs only its
// children's terms (d_tree_back_ric_rec_libstr.c:120), in the forward sweep
// only its parent's z, so the nodes of one depth are independent.  The host
// hands the kernel a schedule (ops/tree_kernel.py::level_schedule, one int32
// table a tree): the levels' node ids, each node's place in its level, its
// parent, and its children in descending id.
//
// What bounds them on the H100.  Row 26, per instance at tools/bench_tree.
// py's 71-node tree (nx=4 nu=2: NZ=6, NX=4, NT=21): inputs read once -- H,
// dvec, g per node (33 scalars), F, b per edge (28) -- ~4.3k scalars;
// outputs written once -- Ll, Lxx, z per node (34), Pb per edge (4) --
// ~2.7k: ~28 KB in f32, 115 MB at B=4096, 0.034 ms at 3.35 TB/s, against
// ~0.8 kflop a node: ~2 flop/byte, bound by its bytes in principle.  Row 27
// reads Ll, Lxx (its lower triangle), Pb, g, F, b and writes z and pi.  The
// one-thread-an-instance form that came first (4096 threads = 128 warps at
// B=4096, about one an SM) walked 2n dependent node steps in a thread, each
// a chain of dependent global loads, with a per-instance accumulator of the
// children's terms in device memory (~94 MB a call at 71 nodes): 4-5% of
// the byte bound, latency bound.
//
// Design.  An instance runs on G teams of TEAM lanes, one team a warp (TEAM
// from NZ as csrc/team.cuh's other kernels: 4 to NZ=6, 8 to 12, 16 to 24;
// G the widest level's node count, at most MAX_G warps a block).  A warp
// holds the same team of IPB = 32 / TEAM instances, consecutive in the
// batch, so a team's row loads of the batch-last streams are IPB
// neighbouring scalars: one sector in f32 at TEAM 4, where lanes of one
// instance would each touch a sector of their own.  A level's nodes go to
// the teams, which loop over them where the level is wider than G; the
// instances of a block run the same schedule, and one block barrier closes
// a level.  A team's lane r owns the rows r, r + TEAM, ... of a node's
// NZ-row objects (M's rows in the Cholesky, F / W, m, z) and the packed
// entries r, r + TEAM, ... of its triangles (the assembly, W W'); the
// objects live in a per-team slab of shared memory, each node's streams
// fetched into registers before any is stored.  Backward, node k: M = H +
// dvec (+ the ng slots on k, in slot order) + its children's terms, m = g
// + theirs; the column Cholesky of csrc/team.cuh (one team barrier a
// column); eu in every lane, the owners' px; the factor's Ll and Lxx; then
// for k > 0: Pb = Lxx (Lxx' b), W = F Lxx, and the node's terms to its slot
// -- the packed W W' and F (Pb + px) (row 27: F (Pb + px) only).  A parent
// sums its children's slots in descending id starting from 0, exactly as
// the one-thread form's accumulator took them (signed zeros included).
// Only two levels' slots are live at once (the level being summed and the
// one being written), one buffer each, indexed by the node's place in its
// level; eu and px of every node are kept too.  Forward, root level first:
// x0 = -(Lxx0 Lxx0')^-1 px0 at the root, x = b + F' z_dad elsewhere with
// z_dad from the previous level's z buffer (the slot buffers, free by
// then), pi (row 26 with want_pi, row 27), u, z.  Lanes of instances past
// the batch run along on the last instance's inputs and store nothing.
//
// The size rule: a block's kept rows -- eu and px of every node and the two
// slot buffers, n (NU + NX) + 2 wmax SLOT scalars an instance, interleaved
// across the block's instances (row e of instance s at e IPB + s) -- live
// in shared memory while they take at most KEEP_MAX bytes, else in device
// memory (the wrapper's `work`, its size from hp_tree_sweeps_layout), in
// the same kernel and code.  At 31 and 71 nodes both rows keep them on chip
// in f32 and f64; at 255 nodes (levels to 128 wide) in device memory.
//
// The bits: every entry keeps the one-thread form's expression and order,
// so the outputs are its outputs bit for bit.  nvcc contracted that form's
// unrolled sums -- a0 b0 + a1 b1 + ... as fma(a0, b0, a1 b1), each later
// product fused into the running sum -- in a way a lane's runtime range
// does not repeat, so those sums are written with explicit roundings
// (hp::dot_chain); at NX = 1 a term is one product, which the one-thread
// form fused into the accumulator, so the slot holds its factors there.
//
// Specialisation: NU, NX compile-time (-D, one library per shape); WANT_PI
// and "has ng rows" template parameters; n, the schedule and the ng node
// table runtime.
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

// lanes a node: the width rule of csrc/team.cuh's other kernels (about one
// or two M rows a lane)
constexpr int TEAM = NZ <= 6 ? 4 : NZ <= 12 ? 8 : NZ <= 24 ? 16 : 32;
constexpr int IPB = 32 / TEAM;  // instances a block: one team each a warp
constexpr int MAX_G = 8;        // warps a block: teams an instance
using TM = hp::Team<TEAM>;
__host__ __device__ constexpr int chunks(int n) { return TM::chunks(n); }

// a child's terms in its slot: row 26 the packed W W' then F (Pb + px),
// row 27 F (Pb + px); at NX = 1 the factors: W, F, Pb + px (row 27: F,
// Pb + px)
constexpr int SLOT_F = NX > 1 ? NT + NZ : 2 * NZ + 1;
constexpr int SLOT_S = NX > 1 ? NZ : NZ + 1;

// the per-team slab of shared memory, in scalars.  Backward (row 26):
constexpr int O_M = 0;                // (NZ, NZ) M, then its factor
constexpr int O_F = O_M + NZ * NZ;    // (NZ, NX) F, then W in place
constexpr int O_MV = O_F + NZ * NX;   // NZ m
constexpr int O_DI = O_MV + NZ;       // NZ Cholesky pivots
constexpr int O_B = O_DI + NZ;        // NX b
constexpr int O_T1 = O_B + NX;        // NX Lxx' b
constexpr int O_PBX = O_T1 + NX;      // NX Pb + px
constexpr int SLAB_B = O_PBX + NX;
// backward (row 27): Ll, F, m and Pb + px at O_M, O_F, O_MV, O_PBX
// forward (both rows):
constexpr int P_LL = 0;               // (NZ, NU) Ll of a node
constexpr int P_LX = P_LL + NZ * NU;  // NTX packed Lxx of a node
constexpr int P_F = P_LX + NTX;       // (NZ, NX) F
constexpr int P_B = P_F + NZ * NX;    // NX b
constexpr int P_ZD = P_B + NX;        // NZ the parent's z
constexpr int P_X = P_ZD + NZ;        // NX x
constexpr int P_ZT = P_X + NX;        // NZ z = [u; x]
constexpr int P_T1 = P_ZT + NZ;       // NX Lxx' x
constexpr int P_EU = P_T1 + NX;       // NU eu
constexpr int P_PX = P_EU + NU;       // NX px
constexpr int SLAB_F = P_PX + NX;
constexpr int SLAB0 = SLAB_B > SLAB_F ? SLAB_B : SLAB_F;
// a slab's stride: TEAM more than a multiple of 32 scalars, so that the
// IPB teams of a warp sit on distinct shared-memory banks
constexpr int SLAB =
    TEAM == 32 ? SLAB0 : (SLAB0 - TEAM + 31) / 32 * 32 + TEAM;

// the size rule (see the head comment): a block's kept rows, in bytes
constexpr int64_t KEEP_MAX = 64 * 1024;

// The launch geometry of a tree: teams (warps) an instance, whether the
// kept rows are on chip, an instance's kept rows, and the block's shared
// memory in scalars.
struct Geo {
  int G, onchip;
  int64_t rows, smem;
};

template <typename T>
Geo geo_of(int64_t n, int64_t wmax, int slotw) {
  Geo g;
  g.G = static_cast<int>(wmax < MAX_G ? wmax : MAX_G);
  g.rows = n * (NU + NX) + 2 * wmax * slotw;
  g.onchip = IPB * g.rows * static_cast<int64_t>(sizeof(T)) <= KEEP_MAX;
  g.smem = static_cast<int64_t>(g.G) * IPB * SLAB + (g.onchip ? IPB * g.rows
                                                              : 0);
  return g;
}

// row i and column j of the packed lower-triangle entry e (i >= j)
__device__ __forceinline__ void unpack(int e, int& i, int& j) {
  i = 0;
#pragma unroll
  for (int q = 1; q < NZ; ++q) i += e >= q * (q + 1) / 2 ? 1 : 0;
  j = e - i * (i + 1) / 2;
}

// The schedule table of ops/tree_kernel.py::schedule_table: the level
// offsets (L + 1) into the node ids by level (n, root level first), each
// node's place in its level (n), its parent (n, dad[0] = 0), the offsets
// (n + 1) into the children lists (n - 1, each in descending id).
struct Sched {
  const int* lev_off;
  const int* nodes;
  const int* pos;
  const int* dad;
  const int* ch_off;
  const int* ch;
};

__device__ __forceinline__ Sched sched_of(const void* tab, int n, int L) {
  Sched s;
  s.lev_off = static_cast<const int*>(tab);
  s.nodes = s.lev_off + L + 1;
  s.pos = s.nodes + n;
  s.dad = s.pos + n;
  s.ch_off = s.dad + n;
  s.ch = s.ch_off + n + 1;
  return s;
}

// An instance's kept rows, interleaved with its block's other instances
// (row e at p[e IPB]): eu, px, then the two slot buffers.
template <typename T>
struct Kept {
  T* p;
  __device__ __forceinline__ T& operator[](int64_t e) const {
    return p[e * IPB];
  }
};

// Where a lane sits and what its instance shares: its index in the batch,
// clamped there for loads (bl; valid: not past the batch, the only lanes
// that store), its team t (the warp) and lane r in the team, the team's
// warp barrier, the team's slab and the kept rows.
template <typename T>
struct Inst {
  int64_t bl;
  bool valid;
  int t, r;
  unsigned tmask;
  T* sh;
  Kept<T> eus, pxs, slots;
  __device__ __forceinline__ void tsync() const { __syncwarp(tmask); }
};

template <typename T>
__device__ __forceinline__ Inst<T> inst_of(const Geo& geo, int64_t B, int n,
                                           void* work, unsigned char* smem) {
  Inst<T> in;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31, s = lane / TEAM;
  in.t = tid >> 5;
  in.r = lane % TEAM;
  const int64_t bi = static_cast<int64_t>(blockIdx.x) * IPB + s;
  in.valid = bi < B;
  in.bl = in.valid ? bi : B - 1;
  in.tmask = TEAM == 32 ? 0xffffffffu : ((1u << TEAM) - 1u) << (s * TEAM);
  T* const sm = reinterpret_cast<T*>(smem);
  in.sh = sm + static_cast<int64_t>(in.t * IPB + s) * SLAB;
  T* const keep =
      (geo.onchip ? sm + static_cast<int64_t>(geo.G) * IPB * SLAB
                  : static_cast<T*>(work) +
                        static_cast<int64_t>(blockIdx.x) * IPB * geo.rows) +
      s;
  in.eus = Kept<T>{keep};
  in.pxs = Kept<T>{keep + static_cast<int64_t>(n) * NU * IPB};
  in.slots = Kept<T>{keep + static_cast<int64_t>(n) * (NU + NX) * IPB};
  return in;
}

// The packed lower triangle of node k's Lxx (the upper one is 0), entry e.
template <typename T>
__device__ __forceinline__ T lx_entry(const hp::Col<const T>& Lxxc, int k,
                                      int e) {
  int i = 0;
#pragma unroll
  for (int q = 1; q < NX; ++q) i += e >= q * (q + 1) / 2 ? 1 : 0;
  return Lxxc((static_cast<int64_t>(k) * NX + i) * NX +
              (e - i * (i + 1) / 2));
}

// The forward recovery of node k (_tree_fwd_kernel) by its team: the
// root's free initial state x0 = -(Lxx0 Lxx0')^{-1} px0, elsewhere x_k =
// b_e + F_e' z_dad(k) on the edge e = k-1 with z_dad(k) from the parent
// level's z buffer (slot buffer zin); with WANT_PI pi_e = Lxx_k (Lxx_k'
// x_k) + px_k; u_k = -Luu^{-T} (eu_k + Lxu' x_k) and z_k = [u_k; x_k] to
// the output and to this level's z buffer zout.
template <typename T, bool WANT_PI>
__device__ __forceinline__ void forward_node(
    const Inst<T>& in, const Sched& S, int k, const hp::Col<const T>& Llc,
    const hp::Col<const T>& Lxxc, const hp::Col<const T>& Fc,
    const hp::Col<const T>& bc, const hp::Col<T>& zo, const hp::Col<T>& pio,
    int64_t zin, int64_t zout) {
  using hp::sym_idx;
  const int r = in.r;
  T* const sh = in.sh;
  const int64_t e = k - 1;
  in.tsync();  // the team's last node is done with the slab
  {
    T llb[chunks(NZ * NU)], eb[chunks(NU)], pb[chunks(NX)],
        fb[chunks(NZ * NX)], bb[chunks(NX)], lb[chunks(NTX)],
        zb[chunks(NZ)];
    TM::fetch<NZ * NU>(r, llb, [&](int q) {
      return Llc(static_cast<int64_t>(k) * NZ * NU + q);
    });
    TM::fetch<NU>(
        r, eb, [&](int q) { return in.eus[static_cast<int64_t>(k) * NU + q]; });
    TM::fetch<NX>(
        r, pb, [&](int q) { return in.pxs[static_cast<int64_t>(k) * NX + q]; });
    if (k > 0) {
      const int64_t zd = zin + static_cast<int64_t>(S.pos[S.dad[k]]) * NZ;
      TM::fetch<NZ>(r, zb, [&](int q) { return in.slots[zd + q]; });
      TM::fetch<NZ * NX>(r, fb, [&](int q) { return Fc(e * NZ * NX + q); });
      TM::fetch<NX>(r, bb, [&](int q) { return bc(e * NX + q); });
    }
    if (k == 0 || WANT_PI)
      TM::fetch<NTX>(r, lb, [&](int q) { return lx_entry<T>(Lxxc, k, q); });
    TM::put<NZ * NU>(r, sh + P_LL, llb);
    TM::put<NU>(r, sh + P_EU, eb);
    TM::put<NX>(r, sh + P_PX, pb);
    if (k > 0) {
      TM::put<NZ>(r, sh + P_ZD, zb);
      TM::put<NZ * NX>(r, sh + P_F, fb);
      TM::put<NX>(r, sh + P_B, bb);
    }
    if (k == 0 || WANT_PI) TM::put<NTX>(r, sh + P_LX, lb);
  }
  in.tsync();
  if (k == 0)
    hp::root_x0<TEAM, T, NX>(
        r, [&](int i, int j) { return sh[P_LX + sym_idx(i, j)]; },
        sh + P_PX, sh + P_X);
  else
    hp::x_next<TEAM, T, NZ, NX>(r, sh + P_B, sh + P_F, sh + P_ZD, sh + P_X);
  in.tsync();
  T u[NU];
  hp::u_of_x<T, NU, NX>(sh + P_LL, sh + P_EU, sh + P_X, u);
#pragma unroll
  for (int i = 0; i < NU; ++i)
    if (i % TEAM == r) sh[P_ZT + i] = u[i];
  for (int i = r; i < NX; i += TEAM) sh[P_ZT + NU + i] = sh[P_X + i];
  if (WANT_PI && k > 0)
    hp::pi_t1<TEAM, T, NX>(r, sh + P_LX, sh + P_X, sh + P_T1);
  in.tsync();
  const int64_t zk = zout + static_cast<int64_t>(S.pos[k]) * NZ;
  for (int i = r; i < NZ; i += TEAM) {
    if (in.valid) zo(static_cast<int64_t>(k) * NZ + i) = sh[P_ZT + i];
    in.slots[zk + i] = sh[P_ZT + i];
  }
  if (WANT_PI && k > 0)
    hp::pi_rows<TEAM, T, NX>(r, sh + P_LX, sh + P_PX, sh + P_T1,
                             [&](int i, T v) {
                               if (in.valid) pio(e * NX + i) = v;
                             });
}

// The forward sweep, root level first, the z buffers in the slot buffers
// (row offsets into in.slots).
template <typename T, bool WANT_PI>
__device__ __forceinline__ void forward_sweep(
    const Inst<T>& in, const Sched& S, int L, int G, int64_t wmax,
    const hp::Col<const T>& Llc, const hp::Col<const T>& Lxxc,
    const hp::Col<const T>& Fc, const hp::Col<const T>& bc,
    const hp::Col<T>& zo, const hp::Col<T>& pio) {
  for (int l = 0; l < L; ++l) {
    const int w0 = S.lev_off[l], width = S.lev_off[l + 1] - w0;
    const int64_t zin = ((l + 1) & 1) * wmax * NZ, zout = (l & 1) * wmax * NZ;
    for (int q = in.t; q < width; q += G)
      forward_node<T, WANT_PI>(in, S, S.nodes[w0 + q], Llc, Lxxc, Fc, bc, zo,
                               pio, zin, zout);
    __syncthreads();  // the level's z before its children read it
  }
}

}  // namespace

// Mirrors _TreeFactorArgs in hpmpc_tpu_torch/ops/tree_kernel.py field for
// field.
struct TreeFactorArgs {
  const void* sched;    // int32 schedule table (see Sched)
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
  void* work;           // (B, work rows) kept rows past the size rule
  int64_t B;
  int64_t n;
  int64_t n_levels;
  int64_t wmax;         // the widest level's node count
  int64_t n_ng;
  int64_t want_pi;
};

// Mirrors _TreeSolveArgs in hpmpc_tpu_torch/ops/tree_kernel.py.
struct TreeSolveArgs {
  const void* sched;  // int32 schedule table
  const void* Ll;     // (n, NZ, NU, B)
  const void* Lxx;    // (n, NX, NX, B), upper triangle 0
  const void* Pb;     // (n-1, NX, B)
  const void* g;      // (n, NZ, B)
  const void* F;      // (n-1, NZ, NX, B)
  const void* b;      // (n-1, NX, B)
  void* z;            // (n, NZ, B)
  void* pi;           // (n-1, NX, B)
  void* work;         // (B, work rows) kept rows past the size rule
  int64_t B;
  int64_t n;
  int64_t n_levels;
  int64_t wmax;
};

template <typename T, bool WANT_PI, bool HAS_NG>
__global__ void __launch_bounds__(MAX_G * 32, 2)
    tree_factor_solve_flat_kernel(TreeFactorArgs a, Geo geo) {
  using hp::Col;
  using hp::dot_chain;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = static_cast<int>(a.n), L = static_cast<int>(a.n_levels);
  const int n_ng = static_cast<int>(a.n_ng);
  const Inst<T> in = inst_of<T>(geo, a.B, n, a.work, smem_raw);
  const int64_t B = a.B, wmax = a.wmax;
  const int r = in.r;
  T* const sh = in.sh;
  const Sched S = sched_of(a.sched, n, L);
  const int* ng_node = static_cast<const int*>(a.ng_node);
  auto col_in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + in.bl, B};
  };
  auto col_out = [&](void* p) {
    return Col<T>{static_cast<T*>(p) + in.bl, B};
  };
  const Col<const T> Hc = col_in(a.H), dvc = col_in(a.dvec),
                     gc = col_in(a.g), Fc = col_in(a.F), bc = col_in(a.b);
  const Col<T> Llo = col_out(a.Ll), Lxxo = col_out(a.Lxx),
               Pbo = col_out(a.Pb);

  // ---- backward: assemble + factor, deepest level first -----------------
  for (int l = L - 1; l >= 0; --l) {
    const int w0 = S.lev_off[l], width = S.lev_off[l + 1] - w0;
    const int64_t kids = ((l + 1) & 1) * wmax * SLOT_F;  // row offsets
    const int64_t mine = (l & 1) * wmax * SLOT_F;
    for (int q = in.t; q < width; q += geo.G) {
      const int k = S.nodes[w0 + q];
      const int c0 = S.ch_off[k], c1 = S.ch_off[k + 1];
      const int64_t e = k - 1;
      in.tsync();  // the team's last node is done with the slab
      {
        T hb[chunks(NT)], gb[chunks(NZ)], fb[chunks(NZ * NX)],
            bb[chunks(NX)];
        // H and, on the diagonal, dvec (M[i][i] + dvec_i)
#pragma unroll
        for (int c = 0; c < chunks(NT); ++c) {
          const int x = r + c * TEAM;
          if (x < NT) {
            int i, j;
            unpack(x, i, j);
            const T h = Hc(static_cast<int64_t>(k) * NT + x);
            hb[c] = i == j ? h + dvc(static_cast<int64_t>(k) * NZ + i) : h;
          }
        }
        TM::fetch<NZ>(r, gb, [&](int x) {
          return gc(static_cast<int64_t>(k) * NZ + x);
        });
        if (k > 0) {
          TM::fetch<NZ * NX>(r, fb,
                             [&](int x) { return Fc(e * NZ * NX + x); });
          TM::fetch<NX>(r, bb, [&](int x) { return bc(e * NX + x); });
        }
        // the children's terms, summed from 0 in descending id
        T sM[chunks(NT)], sm[chunks(NZ)];
#pragma unroll
        for (int c = 0; c < chunks(NT); ++c) sM[c] = T(0);
#pragma unroll
        for (int c = 0; c < chunks(NZ); ++c) sm[c] = T(0);
        for (int cc = c0; cc < c1; ++cc) {
          const int64_t p = kids + S.pos[S.ch[cc]] * SLOT_F;
#pragma unroll
          for (int c = 0; c < chunks(NT); ++c) {
            const int x = r + c * TEAM;
            if (x < NT) {
              if constexpr (NX > 1) {
                sM[c] = sM[c] + in.slots[p + x];
              } else {
                int i, j;
                unpack(x, i, j);
                sM[c] = hp::fma_rn(in.slots[p + i], in.slots[p + j], sM[c]);
              }
            }
          }
#pragma unroll
          for (int c = 0; c < chunks(NZ); ++c) {
            const int i = r + c * TEAM;
            if (i < NZ) {
              if constexpr (NX > 1)
                sm[c] = sm[c] + in.slots[p + NT + i];
              else
                sm[c] = hp::fma_rn(in.slots[p + NZ + i],
                                   in.slots[p + 2 * NZ], sm[c]);
            }
          }
        }
        // M = H + dvec (+ the ng slots on k, in slot order) + those terms
#pragma unroll
        for (int c = 0; c < chunks(NT); ++c) {
          const int x = r + c * TEAM;
          if (x < NT) {
            int i, j;
            unpack(x, i, j);
            T v = hb[c];
            if (HAS_NG) {
              for (int jg = 0; jg < n_ng; ++jg)
                if (ng_node[jg] == k)
                  v = v + col_in(a.ngl)(static_cast<int64_t>(jg) * NT + x);
            }
            sh[O_M + i * NZ + j] = v + sM[c];
          }
        }
#pragma unroll
        for (int c = 0; c < chunks(NZ); ++c) {
          const int i = r + c * TEAM;
          if (i < NZ) sh[O_MV + i] = gb[c] + sm[c];
        }
        if (k > 0) {
          TM::put<NZ * NX>(r, sh + O_F, fb);
          TM::put<NX>(r, sh + O_B, bb);
        }
      }
      // the column Cholesky (hp::chol), one team barrier a column
      T pend[chunks(NZ)];
      TM::chol_cols<T, NZ>(r, [&] { in.tsync(); }, sh + O_M, sh + O_DI, pend,
                           std::make_integer_sequence<int, NZ>{});
      in.tsync();
#pragma unroll
      for (int c = 0; c < chunks(NZ); ++c)
        if (r + c * TEAM == NZ - 1) sh[O_M + (NZ - 1) * NZ + NZ - 1] = pend[c];
      in.tsync();
      // eu = Luu^{-1} m_u in every lane, px = m_x - Lxu eu in the owners
      T Dinv_u[NU], eu[NU], pxr[chunks(NX)];
#pragma unroll
      for (int i = 0; i < NU; ++i) Dinv_u[i] = sh[O_DI + i];
      hp::eu_of_m<T, NU>(sh + O_MV, sh + O_M, NZ, Dinv_u, eu);
#pragma unroll
      for (int c = 0; c < chunks(NX); ++c) {
        const int i = r + c * TEAM;
        if (i < NX) {
          T acc = sh[O_MV + NU + i];
#pragma unroll
          for (int j = 0; j < NU; ++j)
            acc = acc - sh[O_M + (NU + i) * NZ + j] * eu[j];
          pxr[c] = acc;
          in.pxs[static_cast<int64_t>(k) * NX + i] = acc;
        }
      }
#pragma unroll
      for (int j = 0; j < NU; ++j)
        if (j % TEAM == r) in.eus[static_cast<int64_t>(k) * NU + j] = eu[j];
      // the factor's Ll and Lxx (upper triangles 0)
      if (in.valid) {
#pragma unroll
        for (int c = 0; c < chunks(NZ * NU); ++c) {
          const int x = r + c * TEAM;
          if (x < NZ * NU) {
            const int i = x / NU, j = x % NU;
            Llo(static_cast<int64_t>(k) * NZ * NU + x) =
                j <= i ? sh[O_M + i * NZ + j] : T(0);
          }
        }
#pragma unroll
        for (int c = 0; c < chunks(NX * NX); ++c) {
          const int x = r + c * TEAM;
          if (x < NX * NX) {
            const int i = x / NX, j = x % NX;
            Lxxo(static_cast<int64_t>(k) * NX * NX + x) =
                j <= i ? sh[O_M + (NU + i) * NZ + NU + j] : T(0);
          }
        }
      }
      if (k == 0) continue;  // the root has no incoming edge
      // the terms through the edge e into the slot of k: Pb = Lxx (Lxx' b)
      // (hp::pb_of), m's F (Pb + px), W = F Lxx, the packed W W'
      const T* Lx = sh + O_M + NU * NZ + NU;  // Lxx(i, j) = Lx[i NZ + j]
      for (int i = r; i < NX; i += TEAM)
        sh[O_T1 + i] = dot_chain<T>(i, NX - 1, [&](int q, T& u, T& v) {
          u = Lx[q * NZ + i];
          v = sh[O_B + q];
        });
      in.tsync();
#pragma unroll
      for (int c = 0; c < chunks(NX); ++c) {
        const int i = r + c * TEAM;
        if (i < NX) {
          const T pb = dot_chain<T>(0, i, [&](int q, T& u, T& v) {
            u = Lx[i * NZ + q];
            v = sh[O_T1 + q];
          });
          if (in.valid) Pbo(e * NX + i) = pb;
          sh[O_PBX + i] = pb + pxr[c];
        }
      }
      in.tsync();
      const int64_t slot = mine + S.pos[k] * SLOT_F;
      for (int i = r; i < NZ; i += TEAM) {
        T f[NX];
#pragma unroll
        for (int q = 0; q < NX; ++q) f[q] = sh[O_F + i * NX + q];
        if constexpr (NX > 1)
          in.slots[slot + NT + i] =
              dot_chain<T>(0, NX - 1, [&](int q, T& u, T& v) {
                u = f[q];
                v = sh[O_PBX + q];
              });
        else
          in.slots[slot + NZ + i] = f[0];
#pragma unroll
        for (int j = 0; j < NX; ++j)
          sh[O_F + i * NX + j] =
              dot_chain<T>(j, NX - 1, [&](int q, T& u, T& v) {
                u = f[q];
                v = Lx[q * NZ + j];
              });
      }
      if constexpr (NX > 1) {
        in.tsync();
#pragma unroll
        for (int c = 0; c < chunks(NT); ++c) {
          const int x = r + c * TEAM;
          if (x < NT) {
            int i, j;
            unpack(x, i, j);
            in.slots[slot + x] =
                dot_chain<T>(0, NX - 1, [&](int q, T& u, T& v) {
                  u = sh[O_F + i * NX + q];
                  v = sh[O_F + j * NX + q];
                });
          }
        }
      } else {
        for (int i = r; i < NZ; i += TEAM) in.slots[slot + i] = sh[O_F + i];
        if (r == 0) in.slots[slot + 2 * NZ] = sh[O_PBX];
      }
    }
    __syncthreads();  // the level's slots before its parents read them
  }

  // ---- forward: z (and pi), root level first -------------------------------
  forward_sweep<T, WANT_PI>(in, S, L, geo.G, wmax, col_in(a.Ll),
                            col_in(a.Lxx), Fc, bc, col_out(a.z),
                            WANT_PI ? col_out(a.pi) : col_out(a.z));
}

// row 27 in f32 at 64 registers (4 blocks an SM): 0.08 against 0.11 ms at
// 71 nodes, 0.28 against 0.38 at 255 (H100); f64 and row 26 spill there
template <typename T>
__global__ void __launch_bounds__(MAX_G * 32, sizeof(T) == 4 ? 4 : 2)
    tree_solve_flat_kernel(TreeSolveArgs a, Geo geo) {
  using hp::Col;
  using hp::dot_chain;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = static_cast<int>(a.n), L = static_cast<int>(a.n_levels);
  const Inst<T> in = inst_of<T>(geo, a.B, n, a.work, smem_raw);
  const int64_t B = a.B, wmax = a.wmax;
  const int r = in.r;
  T* const sh = in.sh;
  const Sched S = sched_of(a.sched, n, L);
  auto col_in = [&](const void* p) {
    return Col<const T>{static_cast<const T*>(p) + in.bl, B};
  };
  auto col_out = [&](void* p) {
    return Col<T>{static_cast<T*>(p) + in.bl, B};
  };
  const Col<const T> Llc = col_in(a.Ll), Pbc = col_in(a.Pb),
                     gc = col_in(a.g), Fc = col_in(a.F), bc = col_in(a.b);

  // ---- backward substitution on the retained factor, deepest first ------
  for (int l = L - 1; l >= 0; --l) {
    const int w0 = S.lev_off[l], width = S.lev_off[l + 1] - w0;
    const int64_t kids = ((l + 1) & 1) * wmax * SLOT_S;
    const int64_t mine = (l & 1) * wmax * SLOT_S;
    for (int q = in.t; q < width; q += geo.G) {
      const int k = S.nodes[w0 + q];
      const int c0 = S.ch_off[k], c1 = S.ch_off[k + 1];
      const int64_t e = k - 1;
      in.tsync();
      T pbr[chunks(NX)];
      {
        T llb[chunks(NZ * NU)], gb[chunks(NZ)], fb[chunks(NZ * NX)];
        TM::fetch<NZ * NU>(r, llb, [&](int x) {
          return Llc(static_cast<int64_t>(k) * NZ * NU + x);
        });
        TM::fetch<NZ>(r, gb, [&](int x) {
          return gc(static_cast<int64_t>(k) * NZ + x);
        });
        if (k > 0) {
          TM::fetch<NZ * NX>(r, fb,
                             [&](int x) { return Fc(e * NZ * NX + x); });
          TM::fetch<NX>(r, pbr, [&](int x) { return Pbc(e * NX + x); });
        }
        TM::put<NZ * NU>(r, sh + O_M, llb);
        // m = g + the children's terms, summed from 0 in descending id
        T sm[chunks(NZ)];
#pragma unroll
        for (int c = 0; c < chunks(NZ); ++c) sm[c] = T(0);
        for (int cc = c0; cc < c1; ++cc) {
          const int64_t p = kids + S.pos[S.ch[cc]] * SLOT_S;
#pragma unroll
          for (int c = 0; c < chunks(NZ); ++c) {
            const int i = r + c * TEAM;
            if (i < NZ) {
              if constexpr (NX > 1)
                sm[c] = sm[c] + in.slots[p + i];
              else
                sm[c] = hp::fma_rn(in.slots[p + i], in.slots[p + NZ], sm[c]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < chunks(NZ); ++c) {
          const int i = r + c * TEAM;
          if (i < NZ) sh[O_MV + i] = gb[c] + sm[c];
        }
        if (k > 0) TM::put<NZ * NX>(r, sh + O_F, fb);
      }
      in.tsync();
      // eu = Luu^{-1} m_u (pivots 1/max(L_ii, 1e-30)) in every lane, px =
      // m_x - Lxu eu in the owners
      const T* Ll = sh + O_M;
      T Dinv_u[NU], eu[NU], pxr[chunks(NX)];
#pragma unroll
      for (int i = 0; i < NU; ++i)
        Dinv_u[i] = T(1) / hp::nmax(Ll[i * NU + i], T(1e-30));
      hp::eu_of_m<T, NU>(sh + O_MV, Ll, NU, Dinv_u, eu);
#pragma unroll
      for (int c = 0; c < chunks(NX); ++c) {
        const int i = r + c * TEAM;
        if (i < NX) {
          T acc = sh[O_MV + NU + i];
#pragma unroll
          for (int j = 0; j < NU; ++j)
            acc = acc - Ll[(NU + i) * NU + j] * eu[j];
          pxr[c] = acc;
          in.pxs[static_cast<int64_t>(k) * NX + i] = acc;
        }
      }
#pragma unroll
      for (int j = 0; j < NU; ++j)
        if (j % TEAM == r) in.eus[static_cast<int64_t>(k) * NU + j] = eu[j];
      if (k == 0) continue;
#pragma unroll
      for (int c = 0; c < chunks(NX); ++c) {
        const int i = r + c * TEAM;
        if (i < NX) sh[O_PBX + i] = pbr[c] + pxr[c];
      }
      in.tsync();
      // F (Pb + px) into the slot of k
      const int64_t slot = mine + S.pos[k] * SLOT_S;
      for (int i = r; i < NZ; i += TEAM) {
        if constexpr (NX > 1)
          in.slots[slot + i] = dot_chain<T>(0, NX - 1, [&](int q, T& u, T& v) {
            u = sh[O_F + i * NX + q];
            v = sh[O_PBX + q];
          });
        else
          in.slots[slot + i] = sh[O_F + i];
      }
      if constexpr (NX == 1)
        if (r == 0) in.slots[slot + NZ] = sh[O_PBX];
    }
    __syncthreads();
  }

  // ---- forward with pi ------------------------------------------------------
  forward_sweep<T, true>(in, S, L, geo.G, wmax, Llc, col_in(a.Lxx), Fc, bc,
                         col_out(a.z), col_out(a.pi));
}

template <typename T, typename K, typename A>
static int launch(K kernel, const A& a, const Geo& g, cudaStream_t stream) {
  const int64_t blocks = (a.B + IPB - 1) / IPB;
  const int64_t smem = g.smem * static_cast<int64_t>(sizeof(T));
  const int rc = hp::allow_smem(kernel, smem);
  if (rc != 0) return rc;
  const int threads = g.G * 32;
  kernel<<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem),
           stream>>>(a, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch_factor(const TreeFactorArgs& a, cudaStream_t stream) {
  const Geo g = geo_of<T>(a.n, a.wmax, SLOT_F);
  const bool ng = a.n_ng > 0;
  if (a.want_pi)
    return ng ? launch<T>(tree_factor_solve_flat_kernel<T, true, true>, a, g,
                          stream)
              : launch<T>(tree_factor_solve_flat_kernel<T, true, false>, a,
                          g, stream);
  return ng ? launch<T>(tree_factor_solve_flat_kernel<T, false, true>, a, g,
                        stream)
            : launch<T>(tree_factor_solve_flat_kernel<T, false, false>, a, g,
                        stream);
}

static bool bad_tree(int64_t B, int64_t n, int64_t L, int64_t wmax) {
  return B <= 0 || n < 2 || L < 2 || wmax < 1 || wmax > n;
}

extern "C" int hp_tree_factor_solve_flat(const TreeFactorArgs* a,
                                         int dtype_code,
                                         cudaStream_t stream) {
  if (bad_tree(a->B, a->n, a->n_levels, a->wmax) || a->n_ng < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0) return dispatch_factor<float>(*a, stream);
  if (dtype_code == 1) return dispatch_factor<double>(*a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int hp_tree_solve_flat(const TreeSolveArgs* a, int dtype_code,
                                  cudaStream_t stream) {
  if (bad_tree(a->B, a->n, a->n_levels, a->wmax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype_code == 0)
    return launch<float>(tree_solve_flat_kernel<float>, *a,
                         geo_of<float>(a->n, a->wmax, SLOT_S), stream);
  if (dtype_code == 1)
    return launch<double>(tree_solve_flat_kernel<double>, *a,
                          geo_of<double>(a->n, a->wmax, SLOT_S), stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch layout of a tree of n nodes whose widest level holds wmax, for
// row 26 (solve = 0) or row 27 (solve = 1) in dtype_code: out = {lanes a
// team, teams (warps) an instance, instances a block, threads a block, kept
// rows on chip (1) or in device memory (0), device memory a block then, in
// scalars}.  The wrapper sizes `work` from the last.
extern "C" void hp_tree_sweeps_layout(int64_t n, int64_t wmax, int64_t solve,
                                      int dtype_code, int64_t* out) {
  const int slotw = solve ? SLOT_S : SLOT_F;
  const Geo g = dtype_code == 1 ? geo_of<double>(n, wmax, slotw)
                                : geo_of<float>(n, wmax, slotw);
  out[0] = TEAM;
  out[1] = g.G;
  out[2] = IPB;
  out[3] = g.G * 32;
  out[4] = g.onchip;
  out[5] = g.onchip ? 0 : IPB * g.rows;
}

extern "C" const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
