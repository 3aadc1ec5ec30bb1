// Multitangent band kernel K2 for Hopper (sm_90a): one Fourier moment of the
// adding-doubling solve over all layers, plus the forward-mode tangent of its
// composite along P parameters, for K = 1 (solar) or K = 2 (solar + thermal)
// source columns.
//
// Replaces two TPU kernels:
//   * vsmartmom_tpu/ops/fused_lin.py::fused_moment_multitangent -> _mt_kernel
//     (K = 1), whose tangent algebra comes from jax.linearize of the forward
//     body at trace time;
//   * K1' (K = 2): the tangent kernel that Pallas's automatic JVP rule builds
//     from vsmartmom_tpu/ops/fused_band.py::fused_moment -> _moment_kernel,
//     which the JAX package's thermal Jacobian runs one parameter per
//     dispatch (core/linearization.py). One launch here does all P.
// The second source column is the isothermal Planck source: it doubles with
// ek = 1 (tangent 0), so the ladder's source jobs and the E_EK epilogue loop
// over the K columns of every (N, K) source vector. K is a template argument:
// the K = 1 instance is the solar kernel's code, with no index arithmetic
// over a run-time K.
//
// The tangent algebra is written out:
// every product A B of the forward kernel (csrc/fused_band.cu) gets the
// tangent product dA B + A dB, and
//   * the elemental assembly is differentiated through its row tables, the
//     phase matrices and expm1(dtau A);
//   * each doubling step is differentiated AS IT IS RUN: every Newton-Schulz
//     iteration m <- m (2I - m + S m) of the probed schedule carries
//     dm <- dm c + m (-dm + dS m + S dm); a seed-only step (I + S) gives
//     d = dS. This is the jvp of the plain version, not the exact inverse's
//     -X dS X;
//   * the adding step's push-through form is differentiated the same way.
//
// What bounds it: FP32 operations. The least work is the primal once and
// two products per tangent product, (1 + 2P) primal moments per point; its
// operands and outputs are a few MB. At N = 52 one point's product is
// 52^3 FMA, too little for a block alone, and one point's moment is a chain
// of ~90 dependent phases per layer, so the kernel is bound by how fully
// each phase keeps an SM's FP32 pipes fed.
//
// Design: one thread-block cluster per (spectral point, tangent group).
// The plan splits P tangents into G = ceil(P / VSM_CLUSTER) groups of
// c = ceil(P / G) blocks; block rank r of group g owns tangent g c + r (a
// rank past P repeats tangent P - 1 and writes nothing of it). The launch
// takes the host's plan (ops/fused_lin.py, mt_plan): it refuses a cluster
// size, group count or shared-memory size other than make_plan's, and runs
// the host's primal slabs (each rank's tiles, source elements and output
// rows) once it has checked that they cut every output into consecutive
// slabs, one a rank. VSM_CLUSTER is fixed at build time (at most 8, the
// portable limit); on an H100 clusters of 2, 4 and 8 read within 2% of
// each other (PERF.md, tools/variants.py mt).
// Every block keeps a full copy of the primal chain and its own tangent
// chain in shared memory for the whole moment: twenty N x N f32 operators
// (216 KB at N = 52, one block per SM) and fourteen (N, K) source vectors
// (222,768 B in all at N = 52, K = 2, inside the 232,448 B a block may opt
// in to).
//   * The primal PRODUCTS are computed once per cluster: rank r computes a
//     fixed slab of every primal product's output tiles (the host plan's
//     tiles [r T / c, (r + 1) T / c) of the T tiles) and of every primal
//     source product's elements, and stores each result into the primal copy of every block
//     of the cluster through distributed shared memory (map_shared_rank).
//     So each primal element is computed by one block and copied, and the
//     copies agree bit for bit.
//   * The elementwise parts (elemental assembly, Newton-Schulz seeds, the
//     unstar, the D t D sign flips, the source attenuation) are computed in
//     every block from inputs that all blocks hold identically: no traffic.
//   * Each product phase ends in a cluster barrier (barrier.cluster
//     arrive.release / wait.acquire), so no block writes a later phase's
//     outputs into a peer that still reads this phase's inputs. An
//     elementwise pass between two phases touches no buffer that the next
//     phase stores remotely, so a block barrier closes it. One cluster
//     barrier precedes the first remote store (every peer has started) and
//     the last precedes the global writes (no shared memory is torn down
//     under a peer's store).
//   Work per point: G + 2P primal moments (18 at P = 8 in two groups of 4;
//   17 in one of 8) against the grid of (point, tangent) blocks' 3P (24).
//
// Products: PR 7's FP32 register tile (csrc/probe_dots.cu), with A read
// row-major. A "job" is one output panel C = epi(A0 B0 [+ A1 B1]); a phase
// runs several jobs that share no output with any input of the phase. A
// matrix job's output is cut into 4 x 8 tiles (rows i0..i0+3, columns
// j0..j0+3 and j0+h..j0+h+3, h half the padded width, so a warp's B loads
// are contiguous). Each tile is a lane PAIR in one warp (lanes l and l+16):
// a tangent tile's two products dA B and A dB go one to each lane, a primal
// tile's depth is split in two; each lane runs a 4 x 8 FMA tile over its
// product, A as one float4 of depth per row (four rows), B as two float4
// per depth step: 12 shared loads per 128 FMA. The pair adds its partial
// tiles by one exchange of two rows (16 shuffles) and each lane writes two
// rows. Source-vector jobs give one lane per (row, column) output, A rows
// read a float4 of depth at a time (bank-conflict-free at the LD = 52
// stride). Tiles fill the block's warps primal first, in warps of their
// own (their remote stores go out while the tangent tiles still run), then
// the vector outputs. Thread 0 posts each phase's jobs to a table in
// shared memory that every thread reads.
// The seed jp update of a doubling step (jp' = jp ek + tt_gp vc, which the
// tangent of the same step reads before it) rides in the next phase that
// touches neither jp nor its operands: the next step's S = r r, or the first
// adding phase.
//
// Wide operators (53 <= N <= 128). Twenty operators no longer fit a block,
// so the plan changes: one cluster per (spectral point, tangent), each of
// c = 2, 4 or 8 blocks (the smallest whose row bands fit), runs
// cluster_band::cluster_kernel<K, true> (csrc/cluster_band.cuh): the
// primal chain and that one tangent chain, both cut by rows across the
// cluster, the same algebra as below on K1's banded phases. The primal is
// recomputed once per tangent: 3P primal moments of work a point, against
// G + 2P here. make_plan gives that plan for N > VSM_MAX_N, and the launch
// runs it as it stands (ops/fused_lin.py, mt_plan, computes the same on
// the host).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_band.cuh"

namespace cg = cooperative_groups;

#define VSM_MAX_N 52
#define VSM_MAX_K 2
#define VSM_MAX_DOUBL 32
#define VSM_NMAT 20
#define VSM_NVEC 14
#define VSM_THREADS 384
// Blocks of a cluster at most (KERNEL_CLUSTER of ops/fused_lin.py).
#define VSM_CLUSTER 4
static_assert(VSM_CLUSTER >= 1 && VSM_CLUSTER <= 8,
              "clusters take 1 to 8 blocks portably");

namespace {

struct Args {
  const float* Zpp;   // (C, N, N) phase matrices of this moment
  const float* Zmp;
  const float* geom;  // (4, N, N): RG, A, TO, TS geometry tables
  const float* dvec;  // (N,) D-matrix diagonal (+-1)
  const float* w;     // (nz, C, s) scattering weight over tau per component
  const float* Em1;   // (nz, s, N) expm1(-dtau/mu_i)
  const float* dt;    // (nz, s) elemental optical depth
  const float* jp;    // (nz, s, N, K) elemental sources j0+
  const float* jms;   // (nz, s, N, K) starred elemental sources D j0-
  const float* ek;    // (nz, s, K) per-source attenuation per doubling
  // Tangents of the operands above, each with a leading P axis.
  const float* dZpp;  // (P, C, N, N)
  const float* dZmp;
  const float* dw;    // (P, nz, C, s)
  const float* dEm1;  // (P, nz, s, N)
  const float* ddt;   // (P, nz, s)
  const float* djp;   // (P, nz, s, N, K)
  const float* djms;
  const float* dek;   // (P, nz, s, K)
  float* Rmp;         // (s, N, N) primal composite
  float* Rpm;
  float* Tpp;
  float* Tmm;
  float* Jp;          // (s, N, K)
  float* Jm;
  float* tRmp;        // (P, s, N, N) tangent composites
  float* tRpm;
  float* tTpp;
  float* tTmm;
  float* tJp;         // (P, s, N, K)
  float* tJm;
  int s, N, C, nz, P, ndoubl, ns_inter;
  int cluster, groups;
  int sched[VSM_MAX_DOUBL];
  // Rank r's primal slabs: tiles tslab[r]..tslab[r + 1] of every product,
  // elements vslab[r].. of every source product, output rows rslab[r]..
  int tslab[VSM_CLUSTER + 1], vslab[VSM_CLUSTER + 1], rslab[VSM_CLUSTER + 1];
};

// The launch plan of (N, K, P); ops/fused_lin.py::mt_plan computes the same.
struct Plan {
  int cluster;   // blocks per cluster (tangents per group)
  int groups;    // clusters per spectral point
  int threads;
  int tiles;     // 4 x 8 tiles of one N x N product
  size_t smem;   // dynamic shared memory of a block (bytes)
  bool wide;     // the cluster_band kernel: one cluster a tangent
  int band;      // rows of a rank's band (wide)
};

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Column groups of 4 in a row, 8-column tiles per row of tiles.
__host__ __device__ constexpr int col_tiles(int N) {
  return ceil_div(ceil_div(N, 4), 2);
}

size_t smem_floats(int N, int K) {
  const int LD = (N + 3) & ~3;
  const int VS = (N * K + 3) & ~3;
  return static_cast<size_t>(VSM_NMAT) * N * LD +
         static_cast<size_t>(VSM_NVEC) * VS + 3 * static_cast<size_t>(LD);
}

// The plan of (N, K, P).
bool make_plan(int N, int K, int P, Plan* p) {
  if (N < 1 || N > VSM_CB_MAX_N || K < 1 || K > VSM_MAX_K || P < 1)
    return false;
  p->tiles = ceil_div(N, 4) * col_tiles(N);
  if (N > VSM_MAX_N) {
    p->cluster = cluster_band::cluster_size(N, K, true, 1);
    if (p->cluster == 0) return false;
    p->groups = P;
    p->threads = VSM_CB_THREADS;
    p->smem = cluster_band::smem_bytes(N, K, p->cluster, true);
    p->wide = true;
    p->band = cluster_band::band_rows(N, p->cluster);
    return true;
  }
  p->groups = ceil_div(P, VSM_CLUSTER);
  p->cluster = ceil_div(P, p->groups);
  p->threads = VSM_THREADS;
  p->smem = smem_floats(N, K) * sizeof(float);
  p->wide = false;
  p->band = N;
  return true;
}

// Epilogues: C = f(acc) with E the job's extra operand, d the D diagonal,
// ek / dek the output's source column's factor of this doubling step and its
// tangent (vector jobs only).
enum { E_ST = 0, E_ACC, E_NS, E_NEG, E_ADD, E_SGN, E_EK, E_EKT };

// Each source column's attenuation per doubling of this step and its
// tangent, passed by value so that they stay in registers.
struct Beam {
  float ek[VSM_MAX_K];
  float dek[VSM_MAX_K];
};

// Column c < K of a Beam field, without a run-time index into it.
__device__ __forceinline__ float column(const float (&v)[VSM_MAX_K], int c) {
  return c == 0 ? v[0] : v[1];
}

struct Job {
  const float* A0;
  const float* B0;
  const float* A1;    // nullptr: one product (a primal job)
  const float* B1;
  float* C;
  const float* E;
  int epi;
};

__device__ __forceinline__ Job job(const float* A0, const float* B0, float* C,
                                   int epi = E_ST, const float* E = nullptr,
                                   const float* A1 = nullptr,
                                   const float* B1 = nullptr) {
  Job o;
  o.A0 = A0;
  o.B0 = B0;
  o.A1 = A1;
  o.B1 = B1;
  o.C = C;
  o.E = E;
  o.epi = epi;
  return o;
}

// Tangent job: C = epi(dA B + A dB).
__device__ __forceinline__ Job tjob(const float* dA, const float* B,
                                    const float* A, const float* dB, float* C,
                                    int epi = E_ST, const float* E = nullptr) {
  return job(dA, B, C, epi, E, A, dB);
}

// The next phase's jobs, one table a block: matrix jobs from g_jobs[0],
// source-vector jobs from g_jobs[VSM_VEC0]. Thread 0 writes them (post)
// before the phase, which makes them visible. A per-thread array would
// live in local memory, which at ~220 KB of shared memory spills to L2.
#define VSM_VEC0 6
__shared__ Job g_jobs[VSM_VEC0 + 4];

__device__ __forceinline__ void post(int q, const Job& o) {
  if (threadIdx.x == 0) g_jobs[q] = o;
}

// What a block's phases need: the width and its tile geometry, the
// cluster, this rank's primal slabs and the D diagonal.
struct Ctx {
  int n, LD, CT, h, tiles, kmid, nk;
  int rank, csize;
  int tlo, thi;   // this rank's tiles of every primal product
  int vlo, vhi;   // and elements of every primal source product
  const float* d;
};

// The block's Ctx, one shared copy (not one per thread in local memory).
__shared__ Ctx g_ctx;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void fma8(float (&acc)[4][8], const float (&a)[4],
                                     float4 b0, float4 b1) {
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(a[r], bv[j], acc[r][j]);
}

// acc += A[i0..i0+3, k0:k1] B[k0:k1, {j0..j0+3, jh..jh+3}]; A and B
// row-major with stride LD, k0 a multiple of 4. Rows past n repeat row
// n - 1 (their results are not stored).
__device__ __forceinline__ void mac(const float* __restrict__ A,
                                    const float* __restrict__ B, int i0,
                                    int j0, int jh, int k0, int k1, int n,
                                    int LD, float (&acc)[4][8]) {
  const float* a0 = A + min(i0, n - 1) * LD;
  const float* a1 = A + min(i0 + 1, n - 1) * LD;
  const float* a2 = A + min(i0 + 2, n - 1) * LD;
  const float* a3 = A + min(i0 + 3, n - 1) * LD;
  const int k4 = k0 + ((k1 - k0) & ~3);
  int k = k0;
#pragma unroll 2
  for (; k < k4; k += 4) {
    const float4 v0 = ld4(a0 + k), v1 = ld4(a1 + k), v2 = ld4(a2 + k),
                 v3 = ld4(a3 + k);
    const float av[4][4] = {{v0.x, v1.x, v2.x, v3.x},
                            {v0.y, v1.y, v2.y, v3.y},
                            {v0.z, v1.z, v2.z, v3.z},
                            {v0.w, v1.w, v2.w, v3.w}};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* b = B + (k + kk) * LD;
      fma8(acc, av[kk], ld4(b + j0), ld4(b + jh));
    }
  }
  for (; k < k1; ++k) {
    const float av[4] = {a0[k], a1[k], a2[k], a3[k]};
    const float* b = B + k * LD;
    fma8(acc, av, ld4(b + j0), ld4(b + jh));
  }
}

// Four outputs C[i, j..j+3] = epi(acc) of a matrix job (idx = i LD + j).
__device__ __forceinline__ float4 epi4(const Job& o, float4 v, int idx, int i,
                                       int j, const float* d) {
  if (o.epi == E_ST) return v;
  if (o.epi == E_ACC) {
    const float4 c = ld4(o.C + idx);
    return make_float4(c.x + v.x, c.y + v.y, c.z + v.z, c.w + v.w);
  }
  const float4 e = ld4(o.E + idx);
  switch (o.epi) {
    case E_NS:
      return make_float4((i == j ? 2.0f : 0.0f) - e.x + v.x,
                         (i == j + 1 ? 2.0f : 0.0f) - e.y + v.y,
                         (i == j + 2 ? 2.0f : 0.0f) - e.z + v.z,
                         (i == j + 3 ? 2.0f : 0.0f) - e.w + v.w);
    case E_NEG:
      return make_float4(v.x - e.x, v.y - e.y, v.z - e.z, v.w - e.w);
    case E_ADD:
      return make_float4(e.x + v.x, e.y + v.y, e.z + v.z, e.w + v.w);
    default: {  // E_SGN
      const float di = d[i];
      return make_float4(di * d[j] * e.x + v.x, di * d[j + 1] * e.y + v.y,
                         di * d[j + 2] * e.z + v.z,
                         di * d[j + 3] * e.w + v.w);
    }
  }
}

// The address of this block's shared word p in block `rank` of the
// cluster (mapa), for st.shared::cluster.
__device__ __forceinline__ unsigned peer(const float* p, int rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// A primal result into every block's copy; a tangent result into this
// block's own. No thread reads a peer's copy before the phase's cluster
// barrier (release / acquire), which orders the remote stores, so they
// carry no compiler memory clobber (it would force every shared value to
// be reread after each store).
__device__ __forceinline__ void put4(float* p, float4 v, bool shared,
                                     const Ctx& x) {
  st4(p, v);
  if (!shared) return;
  for (int r = 0; r < x.csize; ++r)
    if (r != x.rank)
      asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
                   ::"r"(peer(p, r)), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w));
}

__device__ __forceinline__ void put1(float* p, float v, bool shared,
                                     const Ctx& x) {
  *p = v;
  if (!shared) return;
  for (int r = 0; r < x.csize; ++r)
    if (r != x.rank)
      asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(peer(p, r)),
                   "f"(v));
}

// Job q and the item's index inside it, from an item index over jobs with
// `count[q]` items each.
__device__ __forceinline__ int find_job(const int* count, int n, int& t) {
  int q = 0;
  while (q < n - 1 && t >= count[q]) {
    t -= count[q];
    ++q;
  }
  return q;
}

// One matrix tile, run by the lane pair (l, l + 16) of a warp: half h of a
// tangent tile is product h, half h of a primal tile is depth half h. Every
// lane of the warp calls this (the pair exchange is warp-wide).
__device__ __forceinline__ void tile_item(const Job* jm, const int* count,
                                          int nm, int p, bool live,
                                          const Ctx& x) {
  const int h = (threadIdx.x >> 4) & 1;
  int t = live ? p : 0;
  const Job o = jm[find_job(count, nm, t)];
  const bool tan = o.A1 != nullptr;
  const int tile = tan ? t : x.tlo + t;
  const int ti = tile / x.CT;
  const int i0 = ti << 2;
  const int j0 = (tile - ti * x.CT) << 2;
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
  if (live) {
    const float* A = (tan && h) ? o.A1 : o.A0;
    const float* B = (tan && h) ? o.B1 : o.B0;
    const int k0 = (!tan && h) ? x.kmid : 0;
    const int k1 = (!tan && !h) ? x.kmid : x.n;
    mac(A, B, i0, j0, min(j0 + x.h, x.LD - 4), k0, k1, x.n, x.LD, acc);
  }
  // Lane h keeps rows 2h, 2h + 1 and takes the partner's half of them.
  float keep[2][8];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float mine = h ? acc[r + 2][j] : acc[r][j];
      const float send = h ? acc[r][j] : acc[r + 2][j];
      keep[r][j] = mine + __shfl_xor_sync(0xffffffffu, send, 16);
    }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 2 * h + r;
    if (i >= x.n) break;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int j = j0 + g * x.h;
      if (j >= x.n) continue;
      const int idx = i * x.LD + j;
      const float4 v = make_float4(keep[r][4 * g], keep[r][4 * g + 1],
                                   keep[r][4 * g + 2], keep[r][4 * g + 3]);
      put4(o.C + idx, epi4(o, v, idx, i, j, x.d), !tan, x);
    }
  }
}

// acc += a[0:n] . column c of the (n, K) vector b; a row-major, a float4
// of depth at a time.
template <int K>
__device__ __forceinline__ float dot_row(const float* __restrict__ a,
                                         const float* __restrict__ b, int c,
                                         int n, float acc) {
  const int n4 = n & ~3;
  int k = 0;
  for (; k < n4; k += 4) {
    const float4 av = ld4(a + k);
    float bv[4];
    if (K == 1) {
      const float4 v = ld4(b + k);
      bv[0] = v.x; bv[1] = v.y; bv[2] = v.z; bv[3] = v.w;
    } else {
      const float4 u = ld4(b + 2 * k), v = ld4(b + 2 * k + 4);
      bv[0] = c ? u.y : u.x; bv[1] = c ? u.w : u.z;
      bv[2] = c ? v.y : v.x; bv[3] = c ? v.w : v.z;
    }
    acc = fmaf(av.x, bv[0], acc);
    acc = fmaf(av.y, bv[1], acc);
    acc = fmaf(av.z, bv[2], acc);
    acc = fmaf(av.w, bv[3], acc);
  }
  for (; k < n; ++k) acc = fmaf(a[k], b[k * K + c], acc);
  return acc;
}

// One (row, column) output of a source-vector job.
template <int K>
__device__ __forceinline__ void vec_item(const Job* jv, const int* count,
                                         int nv, int t, const Ctx& x,
                                         const Beam& b) {
  const Job o = jv[find_job(count, nv, t)];
  const bool tan = o.A1 != nullptr;
  const int e = tan ? t : x.vlo + t;   // (i, c) of the (N, K) output
  const int i = e / K;
  const int c = e - i * K;
  float acc = dot_row<K>(o.A0 + i * x.LD, o.B0, c, x.n, 0.0f);
  if (tan) acc = dot_row<K>(o.A1 + i * x.LD, o.B1, c, x.n, acc);
  float v;
  switch (o.epi) {
    case E_ACC: v = o.C[e] + acc; break;
    case E_ADD: v = o.E[e] + acc; break;
    case E_EK: v = o.C[e] * column(b.ek, c) + acc; break;
    case E_EKT:
      v = o.C[e] * column(b.ek, c) + o.E[e] * column(b.dek, c) + acc;
      break;
    default: v = acc;
  }
  put1(o.C + e, v, !tan, x);
}

// One phase: the nm matrix and nv source-vector jobs posted in g_jobs
// (primal jobs before tangent jobs; b holds each source column's
// factors), then the cluster barrier. Tangent jobs are whole on every
// block; a primal job is this rank's slab. Tiles fill warps 16 lane pairs
// at a time, primal tiles first, then vector outputs 32 a warp.
// One copy per K instance (not inlined at its ~12 call sites).
template <int K>
__device__ __noinline__ void phase(int nm, int nv, const Ctx& shared_ctx,
                                   Beam b) {
  __syncthreads();                       // the posted jobs
  const Ctx x = shared_ctx;              // in registers from here on
  const Job* jm = g_jobs;
  const Job* jv = g_jobs + VSM_VEC0;
  int cm[6], cv[4];
  int primal = 0, pairs = 0, elems = 0;
  for (int q = 0; q < nm; ++q) {
    cm[q] = jm[q].A1 != nullptr ? x.tiles : x.thi - x.tlo;
    pairs += cm[q];
    if (jm[q].A1 == nullptr) primal += cm[q];
  }
  // Primal jobs are posted first; their tiles fill warps of their own
  // (the tangent tiles start at the next warp), so they finish early and
  // their remote stores overlap the tangent tiles' products.
  const int gap = ((primal + 15) & ~15) - primal;
  for (int q = 0; q < nv; ++q) {
    cv[q] = jv[q].A1 != nullptr ? x.nk : x.vhi - x.vlo;
    elems += cv[q];
  }
  const int mw = (pairs + gap + 15) >> 4;
  const int vw = (elems + 31) >> 5;
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < mw + vw; w += blockDim.x >> 5) {
    if (w < mw) {
      int p = (w << 4) + (lane & 15);
      const bool live = p < primal || (p >= primal + gap && p < pairs + gap);
      if (p >= primal + gap) p -= gap;
      tile_item(jm, cm, nm, p, live, x);
    } else {
      const int t = ((w - mw) << 5) + lane;
      if (t < elems) vec_item<K>(jv, cv, nv, t, x, b);
    }
  }
  __syncwarp();
  cg::this_cluster().sync();
}

// (I - S)^-1 by Newton-Schulz from the seed I + S, with its tangent (the
// seed's elementwise pass is closed by the next phase's entry barrier):
//   m <- m c, c = 2I - m + S m;   dm <- dm c + m dc, dc = -dm + dS m + S dm.
// T[0] / U[0] hold S / dS on entry and the inverse / its tangent on return;
// T[1..3], U[1..3] are scratch. 0 iterations = the seed alone (d = dS).
template <int K>
__device__ __forceinline__ void ns_inverse(float* T[4], float* U[4],
                                           int iters, const Ctx& x) {
  const int n = x.n, LD = x.LD;
  float* S = T[0];
  float* dS = U[0];
  if (iters == 0) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) S[i * LD + i] += 1.0f;
    return;                              // the next phase's barrier follows
  }
  float* m = T[1];
  float* c = T[2];
  float* nm = T[3];
  float* dm = U[1];
  float* dc = U[2];
  float* dnm = U[3];
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n;
    const int idx = i * LD + e - i * n;
    m[idx] = S[idx] + ((e - i * n) == i ? 1.0f : 0.0f);
    dm[idx] = dS[idx];
  }
  for (int it = 0; it < iters; ++it) {
    post(0, job(S, m, c, E_NS, m));
    post(1, tjob(dS, m, S, dm, dc, E_NEG, dm));
    phase<K>(2, 0, x, Beam{});
    post(0, job(m, c, nm));
    post(1, tjob(dm, c, m, dc, dnm));
    phase<K>(2, 0, x, Beam{});
    float* tmp = m;
    m = nm;
    nm = tmp;
    tmp = dm;
    dm = dnm;
    dnm = tmp;
  }
  T[0] = m;
  T[1] = S;
  T[2] = c;
  T[3] = nm;
  U[0] = dm;
  U[1] = dS;
  U[2] = dc;
  U[3] = dnm;
}

template <int K>
__global__ void __launch_bounds__(VSM_THREADS, 1) mt_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int N = a.N, C = a.C, s = a.s;
  const int LD = (N + 3) & ~3;           // float4-aligned rows
  const int MS = N * LD;
  const int NN = N * N;
  const int NK = N * K;
  const int VS = (NK + 3) & ~3;          // stride of an (N, K) vector
  const int cs = a.cluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / cs;       // (point, group) of this cluster
  const int pt = cid / a.groups;
  const int q = (cid - pt * a.groups) * cs + rank;
  const bool own_tangent = q < a.P;      // past P: a copy of tangent P - 1
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  Ctx x;
  x.n = N;
  x.LD = LD;
  x.CT = col_tiles(N);
  x.h = 4 * x.CT;
  x.tiles = ceil_div(N, 4) * x.CT;
  x.kmid = 4 * ((N + 4) / 8);
  x.nk = NK;
  x.rank = rank;
  x.csize = cs;
  x.tlo = a.tslab[rank];
  x.thi = a.tslab[rank + 1];
  x.vlo = a.vslab[rank];
  x.vhi = a.vslab[rank + 1];

  float* Rmp = smem;
  float* Rpm = smem + MS;
  float* Tpp = smem + 2 * MS;
  float* Tmm = smem + 3 * MS;
  float* r = smem + 4 * MS;
  float* t = smem + 5 * MS;
  float* T[4] = {smem + 6 * MS, smem + 7 * MS, smem + 8 * MS, smem + 9 * MS};
  float* dRmp = smem + 10 * MS;
  float* dRpm = smem + 11 * MS;
  float* dTpp = smem + 12 * MS;
  float* dTmm = smem + 13 * MS;
  float* dr = smem + 14 * MS;
  float* dt = smem + 15 * MS;
  float* U[4] = {smem + 16 * MS, smem + 17 * MS, smem + 18 * MS,
                 smem + 19 * MS};
  float* V = smem + VSM_NMAT * MS;
  float* Jp = V;
  float* Jm = V + VS;
  float* jp = V + 2 * VS;
  float* jm = V + 3 * VS;
  float* va = V + 4 * VS;
  float* vb = V + 5 * VS;
  float* vc = V + 6 * VS;
  float* dJp = V + 7 * VS;
  float* dJm = V + 8 * VS;
  float* djp = V + 9 * VS;
  float* djm = V + 10 * VS;
  float* dva = V + 11 * VS;
  float* dvb = V + 12 * VS;
  float* dvc = V + 13 * VS;
  float* sE = V + VSM_NVEC * VS;         // Em1 row of the layer
  float* dE = sE + LD;                   // its tangent
  float* sd = dE + LD;                   // D diagonal
  x.d = sd;
  if (tid == 0) g_ctx = x;

  // This block's tangent operands.
  const size_t qn = static_cast<size_t>(min(q, a.P - 1));
  const float* dZpp = a.dZpp + qn * C * NN;
  const float* dZmp = a.dZmp + qn * C * NN;
  const float* dw = a.dw + qn * a.nz * C * s;
  const float* dEm1 = a.dEm1 + qn * a.nz * s * N;
  const float* ddt = a.ddt + qn * a.nz * s;
  const float* djpq = a.djp + qn * a.nz * s * NK;
  const float* djmq = a.djms + qn * a.nz * s * NK;
  const float* dekq = a.dek + qn * a.nz * s * K;

  // Vacuum composite (R = 0, T = I, J = 0); its tangent is zero.
  for (int e = tid; e < NN; e += nt) {
    const int i = e / N;
    const int j = e - i * N;
    const int idx = i * LD + j;
    Rmp[idx] = 0.0f;
    Rpm[idx] = 0.0f;
    Tpp[idx] = (i == j) ? 1.0f : 0.0f;
    Tmm[idx] = (i == j) ? 1.0f : 0.0f;
    dRmp[idx] = 0.0f;
    dRpm[idx] = 0.0f;
    dTpp[idx] = 0.0f;
    dTmm[idx] = 0.0f;
  }
  for (int e = tid; e < NK; e += nt) {
    Jp[e] = 0.0f;
    Jm[e] = 0.0f;
    dJp[e] = 0.0f;
    dJm[e] = 0.0f;
  }
  for (int i = tid; i < N; i += nt) sd[i] = a.dvec[i];
  // Every peer has started: its shared memory takes remote stores.
  cluster.sync();

  const float* RG = a.geom;
  const float* GA = a.geom + NN;
  const float* TO = a.geom + 2 * NN;
  const float* TS = a.geom + 3 * NN;

  for (int z = 0; z < a.nz; ++z) {
    const size_t zs = static_cast<size_t>(z) * s + pt;
    for (int i = tid; i < N; i += nt) {
      sE[i] = a.Em1[zs * N + i];
      dE[i] = dEm1[zs * N + i];
    }
    for (int e = tid; e < NK; e += nt) {
      jp[e] = a.jp[zs * NK + e];
      jm[e] = a.jms[zs * NK + e];
      djp[e] = djpq[zs * NK + e];
      djm[e] = djmq[zs * NK + e];
    }
    const float dtz = a.dt[zs];
    const float ddtz = ddt[zs];
    Beam bm{};
#pragma unroll
    for (int c = 0; c < K; ++c) {
      bm.ek[c] = a.ek[zs * K + c];
      bm.dek[c] = dekq[zs * K + c];
    }
    __syncthreads();

    // ---- elemental assembly and its tangent: r* = D r-+, t++ ----
    for (int e = tid; e < NN; e += nt) {
      const int i = e / N;
      const int j = e - i * N;
      const int idx = i * LD + j;
      float wpp = 0.0f, wmp = 0.0f, dwpp = 0.0f, dwmp = 0.0f;
      for (int c = 0; c < C; ++c) {
        const size_t wi = (static_cast<size_t>(z) * C + c) * s + pt;
        const float wc = a.w[wi], dwc = dw[wi];
        const float zpp = a.Zpp[c * NN + e], zmp = a.Zmp[c * NN + e];
        wpp = fmaf(wc, zpp, wpp);
        wmp = fmaf(wc, zmp, wmp);
        dwpp = fmaf(dwc, zpp, fmaf(wc, dZpp[c * NN + e], dwpp));
        dwmp = fmaf(dwc, zmp, fmaf(wc, dZmp[c * NN + e], dwmp));
      }
      const float em_i = sE[i], em_j = sE[j];
      const float dem_i = dE[i], dem_j = dE[j];
      const float Ei = 1.0f + em_i, Ej = 1.0f + em_j;
      const float one_m_EE = -(em_i + em_j + em_i * em_j);
      const float d_one_m_EE = -(dem_i + dem_j + dem_i * em_j + em_i * dem_j);
      const float rg = sd[i] * RG[e];
      r[idx] = sd[i] * wmp * RG[e] * one_m_EE;
      dr[idx] = rg * (dwmp * one_m_EE + wmp * d_one_m_EE);
      // Ej expm1(xg) and its tangent; above |xg| = 0.3 the identity
      // Ej expm1(xg) = Em1_i - Em1_j (K1's split: no overflow in thick
      // layers).
      const float xg = dtz * GA[e];
      const float ex = expm1f(xg);
      const float to = TO[e], ts = TS[e];
      const bool small = fabsf(xg) < 0.3f;
      const float g = (small ? ex * Ej : em_i - em_j) * to + (dtz * ts) * Ej;
      const float dg =
          (small ? (1.0f + ex) * GA[e] * ddtz * Ej * to + ex * dem_j * to
                 : (dem_i - dem_j) * to) +
          ddtz * ts * Ej + dtz * ts * dem_j;
      t[idx] = wpp * g + (i == j ? Ei : 0.0f);
      dt[idx] = dwpp * g + wpp * dg + (i == j ? dem_i : 0.0f);
    }
    __syncthreads();

    // ---- doubling ladder on starred operators, primal and tangent ----
    // `prev` is the last step's beam: its jp update rides in the next
    // phase that leaves jp, tt_gp and vc alone.
    Beam prev{};
    int pending = 0;
    for (int step = 0; step < a.ndoubl; ++step) {
      // S = r r and its tangent; jm_e = jm ek and its tangent; the last
      // step's jp' = jp ek + tt_gp vc.
      for (int e = tid; e < NK; e += nt) {
        const float ek = column(bm.ek, e % K);
        va[e] = jm[e] * ek;
        dva[e] = djm[e] * ek + jm[e] * column(bm.dek, e % K);
      }
      post(0, job(r, r, T[0]));
      post(1, tjob(dr, r, r, dr, U[0]));
      post(VSM_VEC0, job(T[1], vc, jp, E_EK));
      phase<K>(2, pending, g_ctx, prev);
      ns_inverse<K>(T, U, a.sched[step], g_ctx);   // T[0] = gp, U[0] = dgp
      // tt_gp = t gp -> T1; rt = r t -> T2; vb = jm_e + r jp; vc = jp + r jm_e
      post(0, job(t, T[0], T[1]));
      post(1, job(r, t, T[2]));
      post(2, tjob(dt, T[0], t, U[0], U[1]));
      post(3, tjob(dr, t, r, dt, U[2]));
      post(VSM_VEC0, job(r, jp, vb, E_ADD, va));
      post(VSM_VEC0 + 1, job(r, va, vc, E_ADD, jp));
      post(VSM_VEC0 + 2, tjob(dr, jp, r, djp, dvb, E_ADD, dva));
      post(VSM_VEC0 + 3, tjob(dr, va, r, dva, dvc, E_ADD, djp));
      phase<K>(4, 4, g_ctx, bm);
      // t' = tt_gp t -> T3; r += tt_gp rt; jm += tt_gp vb; and tangents.
      // The tangent of jp' = jp ek + tt_gp vc reads the old jp, so the
      // primal jp is updated in the next phase.
      post(0, job(T[1], t, T[3]));
      post(1, job(T[1], T[2], r, E_ACC));
      post(2, tjob(U[1], t, T[1], dt, U[3]));
      post(3, tjob(U[1], T[2], T[1], U[2], dr, E_ACC));
      post(VSM_VEC0, job(T[1], vb, jm, E_ACC));
      post(VSM_VEC0 + 1, tjob(U[1], vb, T[1], dvb, djm, E_ACC));
      post(VSM_VEC0 + 2, tjob(U[1], vc, T[1], dvc, djp, E_EKT, jp));
      phase<K>(4, 3, g_ctx, bm);
      prev = bm;
      pending = 1;
      float* tmp = t;
      t = T[3];
      T[3] = tmp;
      tmp = dt;
      dt = U[3];
      U[3] = tmp;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        bm.dek[c] = 2.0f * bm.ek[c] * bm.dek[c];
        bm.ek[c] *= bm.ek[c];
      }
    }

    // ---- unstar: r-+ = D r*, j0- = D j-* ----
    for (int e = tid; e < NN; e += nt) {
      const int i = e / N;
      const int idx = i * LD + e - i * N;
      r[idx] *= sd[i];
      dr[idx] *= sd[i];
    }
    for (int e = tid; e < NK; e += nt) {
      jm[e] *= sd[e / K];
      djm[e] *= sd[e / K];
    }

    // ---- adding onto the composite, primal and tangent ----
    // r-+ R+- (and the ladder's last jp update)
    post(0, job(r, Rpm, T[0]));
    post(1, tjob(dr, Rpm, r, dRpm, U[0]));
    post(VSM_VEC0, job(T[1], vc, jp, E_EK));
    phase<K>(2, pending, g_ctx, prev);
    ns_inverse<K>(T, U, a.ns_inter, g_ctx);                   // T[0] = inv1
    // T01_inv = T-- inv1 -> T1; rT = r T++ -> T2; u = inv1 r -> T3;
    // va = j0- + r J+
    post(0, job(Tmm, T[0], T[1]));
    post(1, job(r, Tpp, T[2]));
    post(2, job(T[0], r, T[3]));
    post(3, tjob(dTmm, T[0], Tmm, U[0], U[1]));
    post(4, tjob(dr, Tpp, r, dTpp, U[2]));
    post(5, tjob(U[0], r, T[0], dr, U[3]));
    post(VSM_VEC0, job(r, Jp, va, E_ADD, jm));
    post(VSM_VEC0 + 1, tjob(dr, Jp, r, dJp, dva, E_ADD, djm));
    for (int e = tid; e < NN; e += nt) {                  // t-- = D t D
      const int i = e / N;
      const int j = e - i * N;
      const float sg = sd[i] * sd[j];
      t[i * LD + j] *= sg;
      dt[i * LD + j] *= sg;
    }
    phase<K>(6, 2, g_ctx, Beam{});                  // reads no t
    // T-- = T01_inv t--; R-+ += T01_inv rT; J- += T01_inv va
    post(0, job(T[1], t, Tmm));
    post(1, job(T[1], T[2], Rmp, E_ACC));
    post(2, tjob(U[1], t, T[1], dt, dTmm));
    post(3, tjob(U[1], T[2], T[1], U[2], dRmp, E_ACC));
    post(VSM_VEC0, job(T[1], va, Jm, E_ACC));
    post(VSM_VEC0 + 1, tjob(U[1], va, T[1], dva, dJm, E_ACC));
    phase<K>(4, 2, g_ctx, Beam{});
    // Ru = R+- u -> T0; Rt = R+- t-- -> T1; vb = J+ + R+- j0-
    post(0, job(Rpm, T[3], T[0]));
    post(1, job(Rpm, t, T[1]));
    post(2, tjob(dRpm, T[3], Rpm, U[3], U[0]));
    post(3, tjob(dRpm, t, Rpm, dt, U[1]));
    post(VSM_VEC0, job(Rpm, jm, vb, E_ADD, Jp));
    post(VSM_VEC0 + 1, tjob(dRpm, jm, Rpm, djm, dvb, E_ADD, dJp));
    phase<K>(4, 2, g_ctx, Beam{});
    for (int e = tid; e < NN; e += nt) {                  // back to t++
      const int i = e / N;
      const int j = e - i * N;
      const float sg = sd[i] * sd[j];
      t[i * LD + j] *= sg;
      dt[i * LD + j] *= sg;
    }
    // T21_inv = t++ + t++ Ru -> T2
    post(0, job(t, T[0], T[2], E_ADD, t));
    post(1, tjob(dt, T[0], t, U[0], U[2], E_ADD, dt));
    phase<K>(2, 0, g_ctx, Beam{});
    // T++ = T21_inv T++ -> T3; R+- = D r-+ D + T21_inv Rt; J+ = j0+ + T21 vb
    post(0, job(T[2], Tpp, T[3]));
    post(1, job(T[2], T[1], Rpm, E_SGN, r));
    post(2, tjob(U[2], Tpp, T[2], dTpp, U[3]));
    post(3, tjob(U[2], T[1], T[2], U[1], dRpm, E_SGN, dr));
    post(VSM_VEC0, job(T[2], vb, Jp, E_ADD, jp));
    post(VSM_VEC0 + 1, tjob(U[2], vb, T[2], dvb, dJp, E_ADD, djp));
    phase<K>(4, 2, g_ctx, Beam{});
    float* tmp = Tpp;
    Tpp = T[3];
    T[3] = tmp;
    tmp = dTpp;
    dTpp = U[3];
    U[3] = tmp;
  }
  // The last phase's barrier: no peer writes into this block any more, and
  // every copy is final.
  cluster.sync();

  // Tangent outputs from every block that owns one; the primal from group
  // 0, each rank its slab of rows.
  if (own_tangent) {
    const size_t mo = (static_cast<size_t>(q) * s + pt) * NN;
    const size_t vo = (static_cast<size_t>(q) * s + pt) * NK;
    for (int e = tid; e < NN; e += nt) {
      const int i = e / N;
      const int idx = i * LD + e - i * N;
      a.tRmp[mo + e] = dRmp[idx];
      a.tRpm[mo + e] = dRpm[idx];
      a.tTpp[mo + e] = dTpp[idx];
      a.tTmm[mo + e] = dTmm[idx];
    }
    for (int e = tid; e < NK; e += nt) {
      a.tJp[vo + e] = dJp[e];
      a.tJm[vo + e] = dJm[e];
    }
  }
  if (cid - pt * a.groups == 0) {
    const int r0 = a.rslab[rank], r1 = a.rslab[rank + 1];
    const size_t po = static_cast<size_t>(pt) * NN;
    for (int e = r0 * N + tid; e < r1 * N; e += nt) {
      const int i = e / N;
      const int idx = i * LD + e - i * N;
      a.Rmp[po + e] = Rmp[idx];
      a.Rpm[po + e] = Rpm[idx];
      a.Tpp[po + e] = Tpp[idx];
      a.Tmm[po + e] = Tmm[idx];
    }
    const size_t vo = static_cast<size_t>(pt) * NK;
    for (int e = r0 * K + tid; e < r1 * K; e += nt) {
      a.Jp[vo + e] = Jp[e];
      a.Jm[vo + e] = Jm[e];
    }
  }
}

typedef void (*Kernel)(const Args);

Kernel kernel_of(int K) { return K == 1 ? mt_kernel<1> : mt_kernel<2>; }

cudaLaunchConfig_t launch_config(const Plan& p, int s, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(s) * p.cluster * p.groups);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

size_t vsm_fused_moment_mt_smem_bytes(int N, int K) {
  return smem_floats(N, K) * sizeof(float);
}

const char* vsm_error_string(int code) {
  return cluster_band::error_string(code);
}

// The launch plan of (N, K, P): info = {cluster, groups, threads, dynamic
// shared bytes, tiles per product, clusters that can be resident at once
// (cudaOccupancyMaxActiveClusters)}. Returns a CUDA error code.
int vsm_fused_moment_mt_info(int N, int K, int P, int* info) {
  Plan p;
  if (!make_plan(N, K, P, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  info[0] = p.cluster;
  info[1] = p.groups;
  info[2] = p.threads;
  info[3] = static_cast<int>(p.smem);
  info[4] = p.tiles;
  if (p.wide) {
    cluster_band::Args a = {};
    a.s = 1;
    a.P = 1;
    a.N = N;
    a.cluster = p.cluster;
    a.band = p.band;
    return K == 1 ? cluster_band::max_clusters<1, true>(a, p.smem, &info[5])
                  : cluster_band::max_clusters<2, true>(a, p.smem, &info[5]);
  }
  const Kernel kernel = kernel_of(K);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(p, 1, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  info[5] = clusters;
  return static_cast<int>(err);
}

// Launches K2 on `stream` and returns cudaGetLastError() (0 on success),
// or for a wide plan cluster_band::launch's code. All pointers are device
// pointers except `sched` (host, ndoubl entries) and `plan` (host, read
// only for a narrow plan: the caller's {cluster c, groups, dynamic shared
// bytes}, which must be make_plan's, then its c + 1 tile, c + 1
// source-element and c + 1 row bounds of the ranks' primal slabs, each
// running from 0 up to the tiles of a product, N K and N, never down; a
// wide plan runs make_plan's own, and `plan` may be null).
int vsm_fused_moment_mt_f32(
    const float* Zpp, const float* Zmp, const float* geom, const float* dvec,
    const float* w, const float* Em1, const float* dt, const float* jp,
    const float* jms, const float* ek, const float* dZpp, const float* dZmp,
    const float* dw, const float* dEm1, const float* ddt, const float* djp,
    const float* djms, const float* dek, float* Rmp, float* Rpm, float* Tpp,
    float* Tmm, float* Jp, float* Jm, float* tRmp, float* tRpm, float* tTpp,
    float* tTmm, float* tJp, float* tJm, int s, int N, int C, int K, int nz,
    int P, int ndoubl, const int* sched, int ns_inter, const int* plan,
    void* stream) {
  Plan p;
  if (!make_plan(N, K, P, &p) || C < 1 || s < 0 || nz < 0 || ndoubl < 0 ||
      ndoubl > VSM_MAX_DOUBL || ns_inter < 0 ||
      static_cast<long long>(s) * p.cluster * p.groups > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.wide) {
    const int c = p.cluster;
    cluster_band::Args b = {};
    b.Zpp = Zpp;
    b.Zmp = Zmp;
    b.geom = geom;
    b.dvec = dvec;
    b.w = w;
    b.Em1 = Em1;
    b.dt = dt;
    b.jp = jp;
    b.jms = jms;
    b.ek = ek;
    b.dZpp = dZpp;
    b.dZmp = dZmp;
    b.dw = dw;
    b.dEm1 = dEm1;
    b.ddt = ddt;
    b.djp = djp;
    b.djms = djms;
    b.dek = dek;
    b.Rmp = Rmp;
    b.Rpm = Rpm;
    b.Tpp = Tpp;
    b.Tmm = Tmm;
    b.Jp = Jp;
    b.Jm = Jm;
    b.tRmp = tRmp;
    b.tRpm = tRpm;
    b.tTpp = tTpp;
    b.tTmm = tTmm;
    b.tJp = tJp;
    b.tJm = tJm;
    b.s = s;
    b.N = N;
    b.C = C;
    b.nz = nz;
    b.P = P;
    b.ndoubl = ndoubl;
    b.ns_inter = ns_inter;
    b.cluster = c;
    b.band = p.band;
    for (int i = 0; i < VSM_MAX_DOUBL; ++i)
      b.sched[i] = i < ndoubl ? sched[i] : 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return K == 1 ? cluster_band::launch<1, true>(b, p.smem, st)
                  : cluster_band::launch<2, true>(b, p.smem, st);
  }
  if (plan[0] != p.cluster || plan[1] != p.groups ||
      plan[2] != static_cast<int>(p.smem))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  const int c = p.cluster;
  const int totals[3] = {p.tiles, N * K, N};
  int* slabs[3] = {a.tslab, a.vslab, a.rslab};
  for (int k = 0; k < 3; ++k) {
    const int* b = plan + 3 + k * (c + 1);
    if (b[0] != 0 || b[c] != totals[k])
      return static_cast<int>(cudaErrorInvalidValue);
    for (int r = 0; r <= c; ++r) {
      if (r < c && b[r + 1] < b[r])
        return static_cast<int>(cudaErrorInvalidValue);
      slabs[k][r] = b[r];
    }
  }
  a.Zpp = Zpp;
  a.Zmp = Zmp;
  a.geom = geom;
  a.dvec = dvec;
  a.w = w;
  a.Em1 = Em1;
  a.dt = dt;
  a.jp = jp;
  a.jms = jms;
  a.ek = ek;
  a.dZpp = dZpp;
  a.dZmp = dZmp;
  a.dw = dw;
  a.dEm1 = dEm1;
  a.ddt = ddt;
  a.djp = djp;
  a.djms = djms;
  a.dek = dek;
  a.Rmp = Rmp;
  a.Rpm = Rpm;
  a.Tpp = Tpp;
  a.Tmm = Tmm;
  a.Jp = Jp;
  a.Jm = Jm;
  a.tRmp = tRmp;
  a.tRpm = tRpm;
  a.tTpp = tTpp;
  a.tTmm = tTmm;
  a.tJp = tJp;
  a.tJm = tJm;
  a.s = s;
  a.N = N;
  a.C = C;
  a.nz = nz;
  a.P = P;
  a.ndoubl = ndoubl;
  a.ns_inter = ns_inter;
  a.cluster = p.cluster;
  a.groups = p.groups;
  for (int i = 0; i < VSM_MAX_DOUBL; ++i) a.sched[i] = i < ndoubl ? sched[i] : 0;
  const Kernel kernel = kernel_of(K);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s > 0) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        launch_config(p, s, static_cast<cudaStream_t>(stream), attr);
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
