// Cluster-split band phases for wide operators (N up to 128): one Fourier
// moment of the adding-doubling solve over all layers, its operators cut by
// rows across the blocks of one thread-block cluster. The wide instance of
// the band kernel K1 (csrc/fused_band.cu, the primal chain alone) and of
// the multitangent kernel K2 / K1' (csrc/fused_lin.cu, the primal chain and
// one tangent chain) both run on it.
//
// Why. K1 keeps ten N x N f32 operators of a chain in one block's shared
// memory, K2 twenty: past N ~ 74 (K1) and N = 52 (K2) they outgrow the
// 232,448 B a block may opt in to. Here a cluster of c blocks (c in 2, 4, 8,
// the smallest that fits; cluster_plan) holds one chain: block rank r owns
// the band of rows [r hb, (r + 1) hb) of every operator, hb = 4 ceil(N/4c)
// (a multiple of 4, so a band's rows start float4-aligned; the last band
// may be short or empty). Every block lays its shared memory out alike, so
// a peer's band of operator X sits at X's own offset in the peer
// (cluster.map_shared_rank). The (N, K) source vectors, the Em1 row and the
// D diagonal are small: every block keeps them whole.
//
// Products. C = A B: a block computes its band of C from its band of A (its
// own rows, every column) and all of B, whose band r it reads from rank r
// through distributed shared memory. One lane runs a 4 x 8 FMA tile of the
// band (4 rows; columns j0..j0+3 and j0+h..j0+h+3, h half the padded
// width) over the whole depth, band by band of B; a tangent job's tile
// runs its two products dA B + A dB into one accumulator. Each tile reads
// its B columns once, so a product moves its B across the cluster once per
// 4 rows of the band. A source-vector job's
// outputs are the band's rows, one lane each; the block stores each into
// its own copy and into every peer's. The epilogues (the Newton-Schulz
// factor's delta_ij at the band's global row, the D signs, the beam
// attenuation) stay band-local.
//
// Barriers. A phase runs up to six matrix and four vector jobs that share
// no output with any input of the phase, posted by thread 0 to a table in
// shared memory, and ends in a cluster barrier (release / acquire), so no
// block writes a later phase's outputs while a peer still reads this
// phase's inputs, and every remote store has landed before the next phase.
// An elementwise pass between two phases touches only the block's band and
// its own vectors; where the next phase reads the pass's output as a B
// operand (a peer's read), a cluster barrier closes the pass (the
// elemental assembly, the Newton-Schulz seeds).
//
// The chain's algebra is K2's (csrc/fused_lin.cu): the elemental assembly,
// the doubling ladder on starred operators with a Newton-Schulz inverse on
// the probed schedule, the unstar, and the adding step in push-through
// form; with TAN, every product A B also gets its tangent dA B + A dB and
// every Newton-Schulz iteration its jvp, as the plain version's
// torch.func.jvp runs it.
//
// What bounds it: FP32 operations, as K1 and K2 at narrower widths; the
// band product's B reads cross the cluster. A simple design: the reads are
// not staged, and the tiles are not tensor-core tiles.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

// Widest N and most source columns the cluster phases take.
#define VSM_CB_MAX_N 128
#define VSM_CB_MAX_K 2
#define VSM_CB_MAX_DOUBL 32
// Threads of a block (one block an SM: its shared memory).
#define VSM_CB_THREADS 256
// Dynamic shared memory a plan may give a block: the 232,448 B a block may
// opt in to on an H100, less 1 KB for the kernels' static shared tables.
#define VSM_CB_SMEM_BUDGET (232448 - 1024)
// Code returned when no cluster of the plan can be resident
// (cudaOccupancyMaxActiveClusters gave 0).
#define VSM_CB_NO_CLUSTER 100001

namespace cluster_band {

namespace cg = cooperative_groups;

// A lane's tile: kTileR rows x 8 columns.
constexpr int kTileR = 4;

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
  // Tangents of the operands above, each with a leading P axis (TAN only).
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
  float* tRmp;        // (P, s, N, N) tangent composites (TAN only)
  float* tRpm;
  float* tTpp;
  float* tTmm;
  float* tJp;         // (P, s, N, K)
  float* tJm;
  int s, N, C, nz, P, ndoubl, ns_inter;
  int cluster, band;  // blocks of a cluster, rows of a band
  int sched[VSM_CB_MAX_DOUBL];
};

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Rows of a band: a multiple of 4 (float4-aligned rows, whole row tiles).
__host__ __device__ constexpr int band_rows(int N, int c) {
  return 4 * ceil_div(N, 4 * c);
}

// Operators, vectors and rows (Em1, its tangent, D) a block keeps.
__host__ __device__ constexpr int n_mat(bool tan) { return tan ? 20 : 10; }
__host__ __device__ constexpr int n_vec(bool tan) { return tan ? 14 : 7; }
__host__ __device__ constexpr int n_row(bool tan) { return tan ? 3 : 2; }

// Dynamic shared bytes of a block of a c-block cluster.
inline size_t smem_bytes(int N, int K, int c, bool tan) {
  const int LD = (N + 3) & ~3;
  const int VS = (N * K + 3) & ~3;
  return sizeof(float) *
         (static_cast<size_t>(n_mat(tan)) * band_rows(N, c) * LD +
          static_cast<size_t>(n_vec(tan)) * VS +
          static_cast<size_t>(n_row(tan)) * LD);
}

// The smallest cluster in {first, .., 8} (powers of 2) whose block fits
// VSM_CB_SMEM_BUDGET, or 0 (N or K out of range, or none fits).
inline int cluster_size(int N, int K, bool tan, int first) {
  if (N < 1 || N > VSM_CB_MAX_N || K < 1 || K > VSM_CB_MAX_K) return 0;
  for (int c = first; c <= 8; c *= 2)
    if (smem_bytes(N, K, c, tan) <= VSM_CB_SMEM_BUDGET) return c;
  return 0;
}


// Epilogues: C = f(acc) with E the job's extra operand, d the D diagonal,
// ek / dek the output's source column's factor of this doubling step and
// its tangent (vector jobs only).
enum { E_ST = 0, E_ACC, E_NS, E_NEG, E_ADD, E_SGN, E_EK, E_EKT };

// Each source column's attenuation per doubling of this step and its
// tangent, passed by value so that they stay in registers.
struct Beam {
  float ek[VSM_CB_MAX_K];
  float dek[VSM_CB_MAX_K];
};

__device__ __forceinline__ float column(const float (&v)[VSM_CB_MAX_K],
                                        int c) {
  return c == 0 ? v[0] : v[1];
}

// A job: C = epi(A0 B0 [+ A1 B1]); A1 null for one product.
struct Job {
  const float* A0;
  const float* B0;
  const float* A1;
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

// The next phase's jobs: matrix jobs from g_cb_jobs[0], source-vector jobs
// from g_cb_jobs[VSM_CB_VEC0]. Thread 0 writes them; the phase's entry
// barrier publishes them.
#define VSM_CB_VEC0 6
__shared__ Job g_cb_jobs[VSM_CB_VEC0 + 4];

// Jobs posted for the next phase, counted.
struct Post {
  int nm = 0, nv = 0;
  __device__ __forceinline__ void m(const Job& o) {
    if (threadIdx.x == 0) g_cb_jobs[nm] = o;
    ++nm;
  }
  __device__ __forceinline__ void v(const Job& o) {
    if (threadIdx.x == 0) g_cb_jobs[VSM_CB_VEC0 + nv] = o;
    ++nv;
  }
};

// What a block's phases need: the width, its band and tile geometry.
struct Ctx {
  int n, LD, hb;     // width, row stride, rows of a band slot
  int rows, row0;    // this block's rows: row0 .. row0 + rows - 1
  int rank, csize;
  int CT, h;         // tiles per row of tiles, second group's offset
  int tiles;         // tiles of this block's band of a product
  const float* d;    // D diagonal (whole)
};

__shared__ Ctx g_cb_ctx;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

// acc[r][j] += a[r] b[j] for a tile of kTileR rows and 8 columns.
__device__ __forceinline__ void fma_row(float (&acc)[kTileR][8],
                                        const float (&a)[kTileR], float4 b0,
                                        float4 b1) {
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int r = 0; r < kTileR; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(a[r], bv[j], acc[r][j]);
}

// acc += A[i0..i0+kTileR-1, :] B[:, {j0..j0+3, jh..jh+3}]: A this block's
// band (local rows i0.., rows past the band repeat its last row and are
// not stored), B's rows k read band by band, band r from rank r. Each B
// row read serves kTileR rows of the tile: the remote traffic of a
// product is its B once per kTileR rows of the band.
__device__ __forceinline__ void mac(const float* __restrict__ A,
                                    const float* B, int i0, int j0, int jh,
                                    const Ctx& x, float (&acc)[kTileR][8]) {
  const int LD = x.LD;
  int ar[kTileR];
#pragma unroll
  for (int r = 0; r < kTileR; ++r) ar[r] = min(i0 + r, x.rows - 1) * LD;
  cg::cluster_group cl = cg::this_cluster();
  for (int q = 0; q < x.csize; ++q) {
    const int k0 = q * x.hb;
    const int k1 = min(k0 + x.hb, x.n);
    if (k0 >= k1) break;
    const float* Br =
        q == x.rank ? B : cl.map_shared_rank(const_cast<float*>(B), q);
    const int k4 = k0 + ((k1 - k0) & ~3);
    int k = k0;
#pragma unroll 2
    for (; k < k4; k += 4) {
      float av[4][kTileR];
#pragma unroll
      for (int r = 0; r < kTileR; ++r) {
        const float4 v = ld4(A + ar[r] + k);
        av[0][r] = v.x;
        av[1][r] = v.y;
        av[2][r] = v.z;
        av[3][r] = v.w;
      }
      const float* b = Br + (k - k0) * LD;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        fma_row(acc, av[kk], ld4(b + kk * LD + j0), ld4(b + kk * LD + jh));
    }
    for (; k < k1; ++k) {
      float av[kTileR];
#pragma unroll
      for (int r = 0; r < kTileR; ++r) av[r] = A[ar[r] + k];
      const float* b = Br + (k - k0) * LD;
      fma_row(acc, av, ld4(b + j0), ld4(b + jh));
    }
  }
}

// Four outputs C[i, j..j+3] = epi(acc) of a matrix job: idx the local
// offset, i the global row.
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

// One tile `t` (kTileR x 8) of this block's band of matrix job o.
__device__ __forceinline__ void tile_item(const Job& o, int t, const Ctx& x) {
  const int ti = t / x.CT;
  const int i0 = ti * kTileR;
  const int j0 = (t - ti * x.CT) << 2;
  const int jh = j0 + x.h;
  float acc[kTileR][8];
#pragma unroll
  for (int r = 0; r < kTileR; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
  const int jl = min(jh, x.LD - 4);
  mac(o.A0, o.B0, i0, j0, jl, x, acc);
  if (o.A1 != nullptr) mac(o.A1, o.B1, i0, j0, jl, x, acc);
#pragma unroll
  for (int r = 0; r < kTileR; ++r) {
    const int i = i0 + r;
    if (i >= x.rows) break;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int j = g ? jh : j0;
      if (j >= x.n) continue;
      const int idx = i * x.LD + j;
      const float4 v = make_float4(acc[r][4 * g], acc[r][4 * g + 1],
                                   acc[r][4 * g + 2], acc[r][4 * g + 3]);
      st4(o.C + idx, epi4(o, v, idx, x.row0 + i, j, x.d));
    }
  }
}

// acc + a[0:n] . column c of the (n, K) vector b; a row-major, a float4 of
// depth at a time.
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

// Output t of this block's band of source-vector job o (row row0 + t / K,
// column t % K), into this block's copy and every peer's.
template <int K>
__device__ __forceinline__ void vec_item(const Job& o, int t, const Ctx& x,
                                         const Beam& b) {
  const int e = x.row0 * K + t;
  const int li = t / K;
  const int c = t - li * K;
  float acc = dot_row<K>(o.A0 + li * x.LD, o.B0, c, x.n, 0.0f);
  if (o.A1 != nullptr) acc = dot_row<K>(o.A1 + li * x.LD, o.B1, c, x.n, acc);
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
  o.C[e] = v;
  cg::cluster_group cl = cg::this_cluster();
  for (int r = 0; r < x.csize; ++r)
    if (r != x.rank) *cl.map_shared_rank(o.C + e, r) = v;
}

// One phase: the nm matrix and nv source-vector jobs posted, then the
// cluster barrier. Items (tiles, then vector outputs) one a thread, in
// turn. One copy per K instance (not inlined at its call sites).
template <int K>
__device__ __noinline__ void phase(int nm, int nv, Beam b) {
  __syncthreads();                       // the posted jobs
  const Ctx x = g_cb_ctx;
  const int mt = nm * x.tiles;
  const int per_vec = x.rows * K;
  const int total = mt + nv * per_vec;
  for (int it = threadIdx.x; it < total; it += blockDim.x) {
    if (it < mt) {
      const int q = it / x.tiles;
      tile_item(g_cb_jobs[q], it - q * x.tiles, x);
    } else {
      const int t = it - mt;
      const int q = t / per_vec;
      vec_item<K>(g_cb_jobs[VSM_CB_VEC0 + q], t - q * per_vec, x, b);
    }
  }
  __syncwarp();
  cluster_sync();
}

template <int K>
__device__ __forceinline__ void run(Post& p, Beam b = Beam{}) {
  phase<K>(p.nm, p.nv, b);
  p = Post{};
}

// (I - S)^-1 by Newton-Schulz from the seed I + S, with its tangent:
//   m <- m c, c = 2I - m + S m;   dm <- dm c + m dc, dc = -dm + dS m + S dm.
// T[0] / U[0] hold S / dS on entry and the inverse / its tangent on return;
// T[1..3], U[1..3] are scratch. 0 iterations = the seed alone (d = dS).
template <int K, bool TAN>
__device__ __forceinline__ void ns_inverse(float* T[4], float* U[4],
                                           int iters, const Ctx& x) {
  const int LD = x.LD;
  float* S = T[0];
  if (iters == 0) {
    for (int i = threadIdx.x; i < x.rows; i += blockDim.x)
      S[i * LD + x.row0 + i] += 1.0f;
    cluster_sync();                      // peers read S as B next
    return;
  }
  float* m = T[1];
  float* c = T[2];
  float* nm = T[3];
  float* dS = U[0];
  float* dm = U[1];
  float* dc = U[2];
  float* dnm = U[3];
  for (int e = threadIdx.x; e < x.rows * x.n; e += blockDim.x) {
    const int i = e / x.n;
    const int j = e - i * x.n;
    const int idx = i * LD + j;
    m[idx] = S[idx] + (x.row0 + i == j ? 1.0f : 0.0f);
    if (TAN) dm[idx] = dS[idx];
  }
  cluster_sync();                        // peers read m as B next
  Post p;
  for (int it = 0; it < iters; ++it) {
    p.m(job(S, m, c, E_NS, m));
    if (TAN) p.m(tjob(dS, m, S, dm, dc, E_NEG, dm));
    run<K>(p);
    p.m(job(m, c, nm));
    if (TAN) p.m(tjob(dm, c, m, dc, dnm));
    run<K>(p);
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

// The kernel: one cluster per spectral point (K1) or per (spectral point,
// tangent) (TAN: cluster id = point P + tangent). Every cluster computes
// the primal chain; with TAN also its tangent's. Outputs: each rank its
// band's rows; the primal from the clusters of tangent 0.
template <int K, bool TAN>
__global__ void __launch_bounds__(VSM_CB_THREADS, 1)
    cluster_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int N = a.N, C = a.C, s = a.s;
  const int LD = (N + 3) & ~3;
  const int MS = a.band * LD;            // a band slot
  const int NN = N * N;
  const int NK = N * K;
  const int VS = (NK + 3) & ~3;
  const int cs = a.cluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / cs;
  const int pt = TAN ? cid / a.P : cid;
  const int q = TAN ? cid - pt * a.P : 0;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int row0 = rank * a.band;
  const int rows = max(0, min(a.band, N - row0));

  Ctx x;
  x.n = N;
  x.LD = LD;
  x.hb = a.band;
  x.rows = rows;
  x.row0 = row0;
  x.rank = rank;
  x.csize = cs;
  x.CT = ceil_div(ceil_div(N, 4), 2);
  x.h = 4 * x.CT;
  x.tiles = ceil_div(rows, kTileR) * x.CT;

  float* Rmp = smem;
  float* Rpm = smem + MS;
  float* Tpp = smem + 2 * MS;
  float* Tmm = smem + 3 * MS;
  float* r = smem + 4 * MS;
  float* t = smem + 5 * MS;
  float* T[4] = {smem + 6 * MS, smem + 7 * MS, smem + 8 * MS, smem + 9 * MS};
  // Tangent slots (TAN); without TAN they alias the primal ones, unused.
  const int tm = TAN ? 10 : 0;
  float* dRmp = smem + tm * MS;
  float* dRpm = smem + (tm + 1) * MS;
  float* dTpp = smem + (tm + 2) * MS;
  float* dTmm = smem + (tm + 3) * MS;
  float* dr = smem + (tm + 4) * MS;
  float* dt = smem + (tm + 5) * MS;
  float* U[4] = {smem + (tm + 6) * MS, smem + (tm + 7) * MS,
                 smem + (tm + 8) * MS, smem + (tm + 9) * MS};
  float* V = smem + n_mat(TAN) * MS;
  float* Jp = V;
  float* Jm = V + VS;
  float* jp = V + 2 * VS;
  float* jm = V + 3 * VS;
  float* va = V + 4 * VS;
  float* vb = V + 5 * VS;
  float* vc = V + 6 * VS;
  const int tv = TAN ? 7 : 0;
  float* dJp = V + tv * VS;
  float* dJm = V + (tv + 1) * VS;
  float* djp = V + (tv + 2) * VS;
  float* djm = V + (tv + 3) * VS;
  float* dva = V + (tv + 4) * VS;
  float* dvb = V + (tv + 5) * VS;
  float* dvc = V + (tv + 6) * VS;
  float* sE = V + n_vec(TAN) * VS;       // Em1 row of the layer
  float* dE = TAN ? sE + LD : sE;        // its tangent
  float* sd = sE + (n_row(TAN) - 1) * LD;  // D diagonal
  x.d = sd;
  if (tid == 0) g_cb_ctx = x;

  // This cluster's tangent operands.
  const size_t qn = static_cast<size_t>(q);
  const float* dZpp = TAN ? a.dZpp + qn * C * NN : nullptr;
  const float* dZmp = TAN ? a.dZmp + qn * C * NN : nullptr;
  const float* dw = TAN ? a.dw + qn * a.nz * C * s : nullptr;
  const float* dEm1 = TAN ? a.dEm1 + qn * a.nz * s * N : nullptr;
  const float* ddt = TAN ? a.ddt + qn * a.nz * s : nullptr;
  const float* djpq = TAN ? a.djp + qn * a.nz * s * NK : nullptr;
  const float* djmq = TAN ? a.djms + qn * a.nz * s * NK : nullptr;
  const float* dekq = TAN ? a.dek + qn * a.nz * s * K : nullptr;

  // Vacuum composite (R = 0, T = I, J = 0) on the band; its tangent zero.
  for (int e = tid; e < rows * N; e += nt) {
    const int i = e / N;
    const int j = e - i * N;
    const int idx = i * LD + j;
    const float one = (row0 + i == j) ? 1.0f : 0.0f;
    Rmp[idx] = 0.0f;
    Rpm[idx] = 0.0f;
    Tpp[idx] = one;
    Tmm[idx] = one;
    if (TAN) {
      dRmp[idx] = 0.0f;
      dRpm[idx] = 0.0f;
      dTpp[idx] = 0.0f;
      dTmm[idx] = 0.0f;
    }
  }
  for (int e = tid; e < NK; e += nt) {
    Jp[e] = 0.0f;
    Jm[e] = 0.0f;
    if (TAN) {
      dJp[e] = 0.0f;
      dJm[e] = 0.0f;
    }
  }
  for (int i = tid; i < N; i += nt) sd[i] = a.dvec[i];
  // Every peer has started: its shared memory serves remote reads and
  // takes remote stores.
  cluster.sync();

  const float* RG = a.geom;
  const float* GA = a.geom + NN;
  const float* TO = a.geom + 2 * NN;
  const float* TS = a.geom + 3 * NN;
  Post p;

  for (int z = 0; z < a.nz; ++z) {
    const size_t zs = static_cast<size_t>(z) * s + pt;
    for (int i = tid; i < N; i += nt) {
      sE[i] = a.Em1[zs * N + i];
      if (TAN) dE[i] = dEm1[zs * N + i];
    }
    for (int e = tid; e < NK; e += nt) {
      jp[e] = a.jp[zs * NK + e];
      jm[e] = a.jms[zs * NK + e];
      if (TAN) {
        djp[e] = djpq[zs * NK + e];
        djm[e] = djmq[zs * NK + e];
      }
    }
    const float dtz = a.dt[zs];
    const float ddtz = TAN ? ddt[zs] : 0.0f;
    Beam bm{};
#pragma unroll
    for (int c = 0; c < K; ++c) {
      bm.ek[c] = a.ek[zs * K + c];
      bm.dek[c] = TAN ? dekq[zs * K + c] : 0.0f;
    }
    __syncthreads();

    // ---- elemental assembly on the band (and its tangent):
    // r* = D r-+, t++ ----
    for (int e = tid; e < rows * N; e += nt) {
      const int li = e / N;
      const int j = e - li * N;
      const int i = row0 + li;
      const int idx = li * LD + j;
      const int ge = i * N + j;
      float wpp = 0.0f, wmp = 0.0f, dwpp = 0.0f, dwmp = 0.0f;
      for (int c = 0; c < C; ++c) {
        const size_t wi = (static_cast<size_t>(z) * C + c) * s + pt;
        const float wc = a.w[wi];
        const float zpp = a.Zpp[c * NN + ge], zmp = a.Zmp[c * NN + ge];
        wpp = fmaf(wc, zpp, wpp);
        wmp = fmaf(wc, zmp, wmp);
        if (TAN) {
          const float dwc = dw[wi];
          dwpp = fmaf(dwc, zpp, fmaf(wc, dZpp[c * NN + ge], dwpp));
          dwmp = fmaf(dwc, zmp, fmaf(wc, dZmp[c * NN + ge], dwmp));
        }
      }
      const float em_i = sE[i], em_j = sE[j];
      const float Ei = 1.0f + em_i, Ej = 1.0f + em_j;
      const float one_m_EE = -(em_i + em_j + em_i * em_j);
      r[idx] = sd[i] * wmp * RG[ge] * one_m_EE;
      // Ej expm1(xg), above |xg| = 0.3 as Em1_i - Em1_j (K1's split: no
      // overflow in thick layers), and its tangent.
      const float xg = dtz * GA[ge];
      const float ex = expm1f(xg);
      const float to = TO[ge], ts = TS[ge];
      const bool small = fabsf(xg) < 0.3f;
      const float g = (small ? ex * Ej : em_i - em_j) * to + (dtz * ts) * Ej;
      t[idx] = wpp * g + (i == j ? Ei : 0.0f);
      if (TAN) {
        const float dem_i = dE[i], dem_j = dE[j];
        const float d_one_m_EE =
            -(dem_i + dem_j + dem_i * em_j + em_i * dem_j);
        dr[idx] = sd[i] * RG[ge] * (dwmp * one_m_EE + wmp * d_one_m_EE);
        const float dg =
            (small ? (1.0f + ex) * GA[ge] * ddtz * Ej * to + ex * dem_j * to
                   : (dem_i - dem_j) * to) +
            ddtz * ts * Ej + dtz * ts * dem_j;
        dt[idx] = dwpp * g + wpp * dg + (i == j ? dem_i : 0.0f);
      }
    }
    cluster.sync();                      // the ladder reads r from peers

    // ---- doubling ladder on starred operators ----
    // `prev` is the last step's beam: its jp update rides in the next
    // phase that leaves jp, tt_gp and vc alone.
    Beam prev{};
    bool pending = false;
    for (int step = 0; step < a.ndoubl; ++step) {
      // S = r r; jm_e = jm ek; the last step's jp' = jp ek + tt_gp vc.
      for (int e = tid; e < NK; e += nt) {
        const float ek = column(bm.ek, e % K);
        va[e] = jm[e] * ek;
        if (TAN) dva[e] = djm[e] * ek + jm[e] * column(bm.dek, e % K);
      }
      p.m(job(r, r, T[0]));
      if (TAN) p.m(tjob(dr, r, r, dr, U[0]));
      if (pending) p.v(job(T[1], vc, jp, E_EK));
      run<K>(p, prev);
      ns_inverse<K, TAN>(T, U, a.sched[step], g_cb_ctx);  // T[0] = gp
      // tt_gp = t gp -> T1; rt = r t -> T2; vb = jm_e + r jp;
      // vc = jp + r jm_e
      p.m(job(t, T[0], T[1]));
      p.m(job(r, t, T[2]));
      p.v(job(r, jp, vb, E_ADD, va));
      p.v(job(r, va, vc, E_ADD, jp));
      if (TAN) {
        p.m(tjob(dt, T[0], t, U[0], U[1]));
        p.m(tjob(dr, t, r, dt, U[2]));
        p.v(tjob(dr, jp, r, djp, dvb, E_ADD, dva));
        p.v(tjob(dr, va, r, dva, dvc, E_ADD, djp));
      }
      run<K>(p, bm);
      // t' = tt_gp t -> T3; r += tt_gp rt; jm += tt_gp vb; and tangents.
      // The tangent of jp' = jp ek + tt_gp vc reads the old jp, so the
      // primal jp is updated in the next phase.
      p.m(job(T[1], t, T[3]));
      p.m(job(T[1], T[2], r, E_ACC));
      p.v(job(T[1], vb, jm, E_ACC));
      if (TAN) {
        p.m(tjob(U[1], t, T[1], dt, U[3]));
        p.m(tjob(U[1], T[2], T[1], U[2], dr, E_ACC));
        p.v(tjob(U[1], vb, T[1], dvb, djm, E_ACC));
        p.v(tjob(U[1], vc, T[1], dvc, djp, E_EKT, jp));
      }
      run<K>(p, bm);
      prev = bm;
      pending = true;
      float* tmp = t;
      t = T[3];
      T[3] = tmp;
      if (TAN) {
        tmp = dt;
        dt = U[3];
        U[3] = tmp;
      }
#pragma unroll
      for (int c = 0; c < K; ++c) {
        bm.dek[c] = 2.0f * bm.ek[c] * bm.dek[c];
        bm.ek[c] *= bm.ek[c];
      }
    }

    // ---- unstar: r-+ = D r*, j0- = D j-* ----
    for (int e = tid; e < rows * N; e += nt) {
      const int li = e / N;
      const int idx = li * LD + e - li * N;
      r[idx] *= sd[row0 + li];
      if (TAN) dr[idx] *= sd[row0 + li];
    }
    for (int e = tid; e < NK; e += nt) {
      jm[e] *= sd[e / K];
      if (TAN) djm[e] *= sd[e / K];
    }

    // ---- adding onto the composite ----
    // r-+ R+- (and the ladder's last jp update)
    p.m(job(r, Rpm, T[0]));
    if (TAN) p.m(tjob(dr, Rpm, r, dRpm, U[0]));
    if (pending) p.v(job(T[1], vc, jp, E_EK));
    run<K>(p, prev);
    ns_inverse<K, TAN>(T, U, a.ns_inter, g_cb_ctx);        // T[0] = inv1
    // T01_inv = T-- inv1 -> T1; rT = r T++ -> T2; u = inv1 r -> T3;
    // va = j0- + r J+
    p.m(job(Tmm, T[0], T[1]));
    p.m(job(r, Tpp, T[2]));
    p.m(job(T[0], r, T[3]));
    p.v(job(r, Jp, va, E_ADD, jm));
    if (TAN) {
      p.m(tjob(dTmm, T[0], Tmm, U[0], U[1]));
      p.m(tjob(dr, Tpp, r, dTpp, U[2]));
      p.m(tjob(U[0], r, T[0], dr, U[3]));
      p.v(tjob(dr, Jp, r, dJp, dva, E_ADD, djm));
    }
    for (int e = tid; e < rows * N; e += nt) {             // t-- = D t D
      const int li = e / N;
      const int j = e - li * N;
      const float sg = sd[row0 + li] * sd[j];
      t[li * LD + j] *= sg;
      if (TAN) dt[li * LD + j] *= sg;
    }
    run<K>(p);                                             // reads no t
    // T-- = T01_inv t--; R-+ += T01_inv rT; J- += T01_inv va
    p.m(job(T[1], t, Tmm));
    p.m(job(T[1], T[2], Rmp, E_ACC));
    p.v(job(T[1], va, Jm, E_ACC));
    if (TAN) {
      p.m(tjob(U[1], t, T[1], dt, dTmm));
      p.m(tjob(U[1], T[2], T[1], U[2], dRmp, E_ACC));
      p.v(tjob(U[1], va, T[1], dva, dJm, E_ACC));
    }
    run<K>(p);
    // Ru = R+- u -> T0; Rt = R+- t-- -> T1; vb = J+ + R+- j0-
    p.m(job(Rpm, T[3], T[0]));
    p.m(job(Rpm, t, T[1]));
    p.v(job(Rpm, jm, vb, E_ADD, Jp));
    if (TAN) {
      p.m(tjob(dRpm, T[3], Rpm, U[3], U[0]));
      p.m(tjob(dRpm, t, Rpm, dt, U[1]));
      p.v(tjob(dRpm, jm, Rpm, djm, dvb, E_ADD, dJp));
    }
    run<K>(p);
    for (int e = tid; e < rows * N; e += nt) {             // back to t++
      const int li = e / N;
      const int j = e - li * N;
      const float sg = sd[row0 + li] * sd[j];
      t[li * LD + j] *= sg;
      if (TAN) dt[li * LD + j] *= sg;
    }
    // T21_inv = t++ + t++ Ru -> T2 (t is A and E here: band-local)
    p.m(job(t, T[0], T[2], E_ADD, t));
    if (TAN) p.m(tjob(dt, T[0], t, U[0], U[2], E_ADD, dt));
    run<K>(p);
    // T++ = T21_inv T++ -> T3; R+- = D r-+ D + T21_inv Rt; J+ = j0+ + T21 vb
    p.m(job(T[2], Tpp, T[3]));
    p.m(job(T[2], T[1], Rpm, E_SGN, r));
    p.v(job(T[2], vb, Jp, E_ADD, jp));
    if (TAN) {
      p.m(tjob(U[2], Tpp, T[2], dTpp, U[3]));
      p.m(tjob(U[2], T[1], T[2], U[1], dRpm, E_SGN, dr));
      p.v(tjob(U[2], vb, T[2], dvb, dJp, E_ADD, djp));
    }
    run<K>(p);
    float* tmp = Tpp;
    Tpp = T[3];
    T[3] = tmp;
    if (TAN) {
      tmp = dTpp;
      dTpp = U[3];
      U[3] = tmp;
    }
  }
  cluster.sync();

  // Each rank its band's rows: the primal from tangent 0's clusters, the
  // tangent from every cluster.
  if (q == 0) {
    const size_t po = static_cast<size_t>(pt) * NN;
    for (int e = tid; e < rows * N; e += nt) {
      const int li = e / N;
      const int idx = li * LD + e - li * N;
      a.Rmp[po + row0 * N + e] = Rmp[idx];
      a.Rpm[po + row0 * N + e] = Rpm[idx];
      a.Tpp[po + row0 * N + e] = Tpp[idx];
      a.Tmm[po + row0 * N + e] = Tmm[idx];
    }
    const size_t vo = static_cast<size_t>(pt) * NK;
    for (int e = row0 * K + tid; e < (row0 + rows) * K; e += nt) {
      a.Jp[vo + e] = Jp[e];
      a.Jm[vo + e] = Jm[e];
    }
  }
  if (TAN) {
    const size_t mo = (qn * s + pt) * NN;
    const size_t vo = (qn * s + pt) * NK;
    for (int e = tid; e < rows * N; e += nt) {
      const int li = e / N;
      const int idx = li * LD + e - li * N;
      a.tRmp[mo + row0 * N + e] = dRmp[idx];
      a.tRpm[mo + row0 * N + e] = dRpm[idx];
      a.tTpp[mo + row0 * N + e] = dTpp[idx];
      a.tTmm[mo + row0 * N + e] = dTmm[idx];
    }
    for (int e = row0 * K + tid; e < (row0 + rows) * K; e += nt) {
      a.tJp[vo + e] = dJp[e];
      a.tJm[vo + e] = dJm[e];
    }
  }
}

// The cluster launch of cluster_kernel<K, TAN>: s (TAN: s P) clusters of
// c blocks, `smem` dynamic bytes a block.
template <int K, bool TAN>
cudaLaunchConfig_t launch_config(const Args& a, size_t smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  const long long clusters =
      static_cast<long long>(a.s) * (TAN ? a.P : 1);
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * a.cluster));
  cfg.blockDim = dim3(VSM_CB_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of the plan resident at once on the card
// (cudaOccupancyMaxActiveClusters), after the shared-memory opt-in;
// returns a CUDA error code.
template <int K, bool TAN>
int max_clusters(const Args& a, size_t smem, int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      cluster_kernel<K, TAN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  Args one = a;
  one.s = 1;
  one.P = 1;
  const cudaLaunchConfig_t cfg =
      launch_config<K, TAN>(one, smem, nullptr, attr);
  *clusters = 0;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, cluster_kernel<K, TAN>, &cfg));
}

// Launches cluster_kernel<K, TAN> on `stream`: 0, a CUDA error code, or
// VSM_CB_NO_CLUSTER when no cluster of the plan fits the card.
template <int K, bool TAN>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  int clusters = 0;
  int err = max_clusters<K, TAN>(a, smem, &clusters);
  if (err != 0) return err;
  if (clusters < 1) return VSM_CB_NO_CLUSTER;
  if (a.s < 1) return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config<K, TAN>(a, smem, stream, attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_kernel<K, TAN>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// A CUDA error code's text, or the cluster plan's own refusal.
inline const char* error_string(int code) {
  if (code == VSM_CB_NO_CLUSTER)
    return "no cluster of the plan fits the card "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace cluster_band
