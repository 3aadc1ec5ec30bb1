// The FP32 register-tiled product phases of the band kernel K1
// (csrc/fused_band.cu), the per-layer kernels K5 and K4 (csrc/fused_rt.cu),
// both launches of the RRS kernel K3 (csrc/fused_rrs.cu: its pair launch
// through the (2,1)-block phases phase21) and the band-stage probe
// (csrc/band_stages.cu), the doubling ladder K1, K4, K5 and the probe run
// on them and the adding step K1, K4 and the probe run. K2
// (csrc/fused_lin.cu) keeps its own product code.
//
// A block keeps its operands in shared memory: N x N matrices at row
// stride LD (N rounded up to a multiple of 4, so rows are float4-aligned),
// one every MS = N LD floats from a matrix base, and (N, K) source vectors,
// one every VS floats from a vector base. A "job" names its operands by
// slot, so a phase's job list is a few integers in registers:
//   matrix job  C = epi(A @ B)  (A, B, C, E matrix slots),
//   vector job  y = epi(A @ x)  (A a matrix slot; x, y, E vector slots).
// A phase runs up to three matrix and two vector jobs that share no output
// with any input of the phase, then a block barrier. Elementwise passes
// that touch none of a phase's operands ride in front of it, under the
// same barrier.
//
// Products: the FP32 register tile of dot_chain (csrc/probe_dots.cu, also
// K2's), one lane a tile over the whole depth, A read as one float4 of
// depth per row (four rows) and B as one or two float4 per depth step. A
// phase of two or three products cuts each output into 4 x 8 tiles (rows
// i0..i0+3, columns j0..j0+3 and j0+h..j0+h+3, h half the padded width, so
// a warp's B loads are contiguous): 12 shared loads per 128 FMA. A
// one-product phase cuts it into 4 x 4 tiles, twice as many lanes (8
// shared loads per 64 FMA), so it keeps as many warps busy as a
// two-product one; every lane of a warp reads the same B row, at one
// depth step per load. (Splitting a 4 x 8 tile's depth over
// lanes instead read slower on an H100 (PERF.md): its lanes read B rows
// far apart and add partial tiles by shuffles.) The epilogue
// is chosen once a tile. Vector outputs take one lane each after the tile
// warps, A rows read a float4 of depth at a time into four partial sums.

#pragma once

#include <cuda_runtime.h>

namespace fp32_tile {

// Epilogues: C = f(acc) at output (i, j), E the job's extra operand, d the
// D diagonal (+-1), ek the per-row attenuation (N x K, vector jobs only).
enum {
  E_ST = 0,  // acc
  E_ACC,     // C + acc
  E_NS,      // 2 delta_ij - E + acc (the Newton-Schulz factor)
  E_ADD,     // E + acc
  E_SGN,     // d_i d_j E + acc
  E_EK,      // C ek + acc (vectors)
  E_SEED,    // acc, and E = acc + delta_ij (the Newton-Schulz seed I + S)
  E_ACCD,    // d_i (C + acc): the last doubling step, unstarred
  E_ROWD,    // d_i acc
  E_SGND     // d_i (d_j E + acc)
};

// A job: its slots and epilogue packed in one int.
__host__ __device__ constexpr int job(int A, int B, int C, int epi = E_ST,
                                      int E = 0) {
  return A | (B << 5) | (C << 10) | (E << 15) | (epi << 20);
}

__device__ __forceinline__ int slot(int code, int field) {
  return (code >> (5 * field)) & 31;
}

// The block's dynamic shared memory (every extern __shared__ array of a
// kernel starts at the same address). Operands are named by their offset
// in it, so every access compiles to a shared-memory load or store.
extern __shared__ __align__(16) float fp32_tile_smem[];

// What a block's phases need, one shared copy. Offsets are in floats from
// the start of the dynamic shared memory.
struct Ctx {
  int mat;           // matrix slot s at mat + s MS
  int vec;           // vector slot s at vec + s VS
  int d;             // D diagonal (+-1), LD floats
  int ek;            // per-row attenuation (N x K) for E_EK
  int n, LD, MS, VS;
  int CT;            // 4 x 8 tiles per row of tiles
  int CG;            // 4 x 4 tiles per row of tiles
  int ct_inv;        // ceil(2^16 / CT): tile / CT = (tile ct_inv) >> 16
  int cg_inv;        // ceil(2^16 / CG)
  int h;             // column offset of a 4 x 8 tile's second float4 group
  int tiles;         // 4 x 8 tiles of one N x N product
  int tiles4;        // 4 x 4 tiles of one N x N product
};

__shared__ Ctx g_tile_ctx;

// The block's Ctx from the base pointers of its buffers (thread 0 writes
// it; the caller's next barrier publishes it). d may be any buffer where
// no job takes a D epilogue.
__device__ __forceinline__ void set_ctx(const float* mat, const float* vec,
                                        const float* d, const float* ek,
                                        int n, int K) {
  if (threadIdx.x != 0) return;
  Ctx x;
  x.mat = static_cast<int>(mat - fp32_tile_smem);
  x.vec = static_cast<int>(vec - fp32_tile_smem);
  x.d = static_cast<int>(d - fp32_tile_smem);
  x.ek = static_cast<int>(ek - fp32_tile_smem);
  x.n = n;
  x.LD = (n + 3) & ~3;
  x.MS = n * x.LD;
  x.VS = (n * K + 3) & ~3;
  x.CG = (n + 3) / 4;
  x.CT = (x.CG + 1) / 2;
  x.ct_inv = (65536 + x.CT - 1) / x.CT;
  x.cg_inv = (65536 + x.CG - 1) / x.CG;
  x.h = 4 * x.CT;
  x.tiles = x.CG * x.CT;
  x.tiles4 = x.CG * x.CG;
  g_tile_ctx = x;
}

__device__ __forceinline__ float* mat_slot(const Ctx& x, int s) {
  return fp32_tile_smem + x.mat + s * x.MS;
}

__device__ __forceinline__ float* vec_slot(const Ctx& x, int s) {
  return fp32_tile_smem + x.vec + s * x.VS;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// acc[r][j] += a[r] b[j] for a tile of 4 rows and W = 4 or 8 columns.
template <int W>
__device__ __forceinline__ void fma_row(float (&acc)[4][W],
                                        const float (&a)[4], float4 b0,
                                        float4 b1) {
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < W; ++j) acc[r][j] = fmaf(a[r], bv[j], acc[r][j]);
}

// acc += A[i0..i0+3, 0:n] B[0:n, {j0..j0+3, jh..jh+3}] (the second group
// for W = 8 only); A and B row-major with stride LD. Rows past n repeat
// row n - 1 (their results are not stored).
template <int W>
__device__ __forceinline__ void mac(const float* __restrict__ A,
                                    const float* __restrict__ B, int i0,
                                    int j0, int jh, int n, int LD,
                                    float (&acc)[4][W]) {
  const float* a0 = A + min(i0, n - 1) * LD;
  const float* a1 = A + min(i0 + 1, n - 1) * LD;
  const float* a2 = A + min(i0 + 2, n - 1) * LD;
  const float* a3 = A + min(i0 + 3, n - 1) * LD;
  const int n4 = n & ~3;
  int k = 0;
#pragma unroll 2
  for (; k < n4; k += 4) {
    const float4 v0 = ld4(a0 + k), v1 = ld4(a1 + k), v2 = ld4(a2 + k),
                 v3 = ld4(a3 + k);
    const float av[4][4] = {{v0.x, v1.x, v2.x, v3.x},
                            {v0.y, v1.y, v2.y, v3.y},
                            {v0.z, v1.z, v2.z, v3.z},
                            {v0.w, v1.w, v2.w, v3.w}};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* b = B + (k + kk) * LD;
      fma_row<W>(acc, av[kk], ld4(b + j0),
                 W == 8 ? ld4(b + jh) : make_float4(0, 0, 0, 0));
    }
  }
  for (; k < n; ++k) {
    const float av[4] = {a0[k], a1[k], a2[k], a3[k]};
    const float* b = B + k * LD;
    fma_row<W>(acc, av, ld4(b + j0),
               W == 8 ? ld4(b + jh) : make_float4(0, 0, 0, 0));
  }
}

// Four outputs C[i, j..j+3] = epi(v) of a matrix job (idx = i LD + j).
// OFF: an off-diagonal block (K3's (2,1) blocks), whose identity terms
// (delta_ij in E_NS and E_SEED) are zero.
template <bool OFF = false>
__device__ __forceinline__ float4 epi4(int epi, const float* C, float* E,
                                       float4 v, int idx, int i, int j,
                                       const float* d) {
  const int ii = OFF ? -8 : i;  // row index of the identity terms
  switch (epi) {
    case E_ST:
      return v;
    case E_ACC: {
      const float4 c = ld4(C + idx);
      return make_float4(c.x + v.x, c.y + v.y, c.z + v.z, c.w + v.w);
    }
    case E_NS: {
      const float4 e = ld4(E + idx);
      return make_float4((ii == j ? 2.0f : 0.0f) - e.x + v.x,
                         (ii == j + 1 ? 2.0f : 0.0f) - e.y + v.y,
                         (ii == j + 2 ? 2.0f : 0.0f) - e.z + v.z,
                         (ii == j + 3 ? 2.0f : 0.0f) - e.w + v.w);
    }
    case E_ADD: {
      const float4 e = ld4(E + idx);
      return make_float4(e.x + v.x, e.y + v.y, e.z + v.z, e.w + v.w);
    }
    case E_SGN: {
      const float4 e = ld4(E + idx);
      const float di = d[i];
      return make_float4(di * d[j] * e.x + v.x, di * d[j + 1] * e.y + v.y,
                         di * d[j + 2] * e.z + v.z,
                         di * d[j + 3] * e.w + v.w);
    }
    case E_SEED:
      st4(E + idx, make_float4(v.x + (ii == j ? 1.0f : 0.0f),
                               v.y + (ii == j + 1 ? 1.0f : 0.0f),
                               v.z + (ii == j + 2 ? 1.0f : 0.0f),
                               v.w + (ii == j + 3 ? 1.0f : 0.0f)));
      return v;
    case E_ACCD: {
      const float4 c = ld4(C + idx);
      const float di = d[i];
      return make_float4(di * (c.x + v.x), di * (c.y + v.y),
                         di * (c.z + v.z), di * (c.w + v.w));
    }
    case E_ROWD: {
      const float di = d[i];
      return make_float4(di * v.x, di * v.y, di * v.z, di * v.w);
    }
    default: {  // E_SGND
      const float4 e = ld4(E + idx);
      const float di = d[i];
      return make_float4(di * (d[j] * e.x + v.x), di * (d[j + 1] * e.y + v.y),
                         di * (d[j + 2] * e.z + v.z),
                         di * (d[j + 3] * e.w + v.w));
    }
  }
}

// Stores a tile's rows i0..i0+3 (< n), columns j0..j0+3 and, for W = 8,
// jh..jh+3 (each group < n), through epilogue EPI.
template <int EPI, int W, bool OFF = false>
__device__ __forceinline__ void store_tile(const Ctx& x, float* C, float* E,
                                           const float (&acc)[4][W], int i0,
                                           int j0, int jh) {
  const float* d = fp32_tile_smem + x.d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + r;
    if (i >= x.n) break;
#pragma unroll
    for (int g = 0; g < W / 4; ++g) {
      const int j = g ? jh : j0;
      if (j >= x.n) continue;
      const int idx = i * x.LD + j;
      const float4 v = make_float4(acc[r][4 * g], acc[r][4 * g + 1],
                                   acc[r][4 * g + 2], acc[r][4 * g + 3]);
      st4(C + idx, epi4<OFF>(EPI, C, E, v, idx, i, j, d));
    }
  }
}

// One tile of matrix job `code`: 4 rows and W columns, over the whole
// depth. W = 8: columns j0..j0+3 and j0+h..j0+h+3 of tile (ti, tj) of
// CT a row; W = 4: columns j0..j0+3 of CG a row. No integer division:
// tile / CT by a multiply (exact for tile < 2^10).
template <int W>
__device__ __forceinline__ void tile_item(const Ctx& x, int code, int tile) {
  const int ti = (tile * (W == 8 ? x.ct_inv : x.cg_inv)) >> 16;
  const int i0 = ti << 2;
  const int j0 = (tile - ti * (W == 8 ? x.CT : x.CG)) << 2;
  const int jh = j0 + x.h;
  float acc[4][W];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < W; ++j) acc[r][j] = 0.0f;
  mac<W>(mat_slot(x, slot(code, 0)), mat_slot(x, slot(code, 1)), i0, j0,
         min(jh, x.LD - 4), x.n, x.LD, acc);
  float* C = mat_slot(x, slot(code, 2));
  float* E = mat_slot(x, slot(code, 3));
  switch (code >> 20) {  // one epilogue a job: the switch is per tile
    case E_ST: store_tile<E_ST, W>(x, C, E, acc, i0, j0, jh); break;
    case E_ACC: store_tile<E_ACC, W>(x, C, E, acc, i0, j0, jh); break;
    case E_NS: store_tile<E_NS, W>(x, C, E, acc, i0, j0, jh); break;
    case E_ADD: store_tile<E_ADD, W>(x, C, E, acc, i0, j0, jh); break;
    case E_SGN: store_tile<E_SGN, W>(x, C, E, acc, i0, j0, jh); break;
    case E_SEED: store_tile<E_SEED, W>(x, C, E, acc, i0, j0, jh); break;
    case E_ACCD: store_tile<E_ACCD, W>(x, C, E, acc, i0, j0, jh); break;
    case E_ROWD: store_tile<E_ROWD, W>(x, C, E, acc, i0, j0, jh); break;
    default: store_tile<E_SGND, W>(x, C, E, acc, i0, j0, jh);
  }
}

// a[0:n] . column c of the (n, K) vector b; a row-major, a float4 of
// depth at a time into four partial sums (a chain a quarter as long).
template <int K>
__device__ __forceinline__ float dot_row(const float* __restrict__ a,
                                         const float* __restrict__ b, int c,
                                         int n) {
  const int n4 = n & ~3;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  int k = 0;
#pragma unroll 4
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
    s0 = fmaf(av.x, bv[0], s0);
    s1 = fmaf(av.y, bv[1], s1);
    s2 = fmaf(av.z, bv[2], s2);
    s3 = fmaf(av.w, bv[3], s3);
  }
  for (; k < n; ++k) s0 = fmaf(a[k], b[k * K + c], s0);
  return (s0 + s1) + (s2 + s3);
}

// Output e (row i) of the (N, K) result of vector job `code`, through its
// epilogue, from the product acc.
__device__ __forceinline__ void vec_out(const Ctx& x, int code, int e, int i,
                                        float acc) {
  float* C = vec_slot(x, slot(code, 2));
  const float* E = vec_slot(x, slot(code, 3));
  float v;
  switch (code >> 20) {
    case E_ACC: v = C[e] + acc; break;
    case E_ADD: v = E[e] + acc; break;
    case E_EK: v = C[e] * fp32_tile_smem[x.ek + e] + acc; break;
    case E_ACCD: v = fp32_tile_smem[x.d + i] * (C[e] + acc); break;
    default: v = acc;
  }
  C[e] = v;
}

// Output e = (i, c) of the (N, K) result of vector job `code`.
template <int K>
__device__ __forceinline__ void vec_item(const Ctx& x, int code, int e) {
  const int i = e / K;
  const int c = e - i * K;
  vec_out(x, code, e, i, dot_row<K>(mat_slot(x, slot(code, 0)) + i * x.LD,
                                    vec_slot(x, slot(code, 1)), c, x.n));
}

// One phase: nm <= 3 matrix jobs m0..m2 and nv <= 2 vector jobs v0, v1,
// then a block barrier. Tiles fill the block's warps first, 32 a warp,
// then vector outputs 32 a warp. One copy per K instance (not
// inlined at its call sites, which keeps the build short).
template <int K>
__device__ __noinline__ void phase(int nm, int m0, int m1, int m2, int nv,
                                   int v0, int v1) {
  const Ctx x = g_tile_ctx;
  const int lanes = blockDim.x;
  // A one-product phase in 4 x 4 tiles where they fit the block's lanes
  // (twice the lanes of 4 x 8 tiles), every other phase in 4 x 8 tiles.
  const bool narrow = nm == 1 && x.tiles4 <= lanes;
  const int per_job = narrow ? x.tiles4 : x.tiles;
  const int nt = nm * per_job;
  const int mw = (nt + 31) >> 5;
  const int nvo = x.n * K;
  const int vw = (nv * nvo + 31) >> 5;
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < mw + vw; w += lanes >> 5) {
    if (w < mw) {
      const int p = (w << 5) + lane;
      if (p < nt) {
        const int q = (p >= per_job) + (p >= 2 * per_job);   // job
        const int code = q == 0 ? m0 : (q == 1 ? m1 : m2);
        if (narrow)
          tile_item<4>(x, code, p);
        else
          tile_item<8>(x, code, p - q * per_job);
      }
    } else {
      const int t = ((w - mw) << 5) + lane;
      if (t < nv * nvo)
        vec_item<K>(x, t < nvo ? v0 : v1, t < nvo ? t : t - nvo);
    }
  }
  __syncthreads();
}

template <int K>
__device__ __forceinline__ void phase1(int m0) {
  phase<K>(1, m0, m0, m0, 0, 0, 0);
}

// K3's (2,1) blocks (csrc/fused_rrs.cu, pair kernel). Every operator of a
// (shift, point) pair is block-lower-triangular, so a product's (2,1)
// block is C21 = A21 B11 + A22 B21. A (2,1) job names the resident (2,1)
// blocks A21, B21, C21 and E21 in `code` as a job does, and in `code2` the
// slots of the staged diagonal factors (field 0 A22, the target point's;
// field 1 B11, the source point's). A tile runs both depth-N products into
// one accumulator, one product of depth 2N, and stores through the
// epilogue without identity terms. A vector job y2 = epi(A21 x1 + A22 x2)
// takes A22 from code2's field 0 and the vector x1 from its field 1.
template <int W>
__device__ __forceinline__ void tile_item21(const Ctx& x, int code,
                                            int code2, int tile) {
  const int ti = (tile * (W == 8 ? x.ct_inv : x.cg_inv)) >> 16;
  const int i0 = ti << 2;
  const int j0 = (tile - ti * (W == 8 ? x.CT : x.CG)) << 2;
  const int jh = j0 + x.h;
  float acc[4][W];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < W; ++j) acc[r][j] = 0.0f;
  mac<W>(mat_slot(x, slot(code, 0)), mat_slot(x, slot(code2, 1)), i0, j0,
         min(jh, x.LD - 4), x.n, x.LD, acc);
  mac<W>(mat_slot(x, slot(code2, 0)), mat_slot(x, slot(code, 1)), i0, j0,
         min(jh, x.LD - 4), x.n, x.LD, acc);
  float* C = mat_slot(x, slot(code, 2));
  float* E = mat_slot(x, slot(code, 3));
  switch (code >> 20) {
    case E_ST: store_tile<E_ST, W, true>(x, C, E, acc, i0, j0, jh); break;
    case E_ACC: store_tile<E_ACC, W, true>(x, C, E, acc, i0, j0, jh); break;
    case E_NS: store_tile<E_NS, W, true>(x, C, E, acc, i0, j0, jh); break;
    case E_ADD: store_tile<E_ADD, W, true>(x, C, E, acc, i0, j0, jh); break;
    case E_SGN: store_tile<E_SGN, W, true>(x, C, E, acc, i0, j0, jh); break;
    case E_SEED:
      store_tile<E_SEED, W, true>(x, C, E, acc, i0, j0, jh);
      break;
    case E_ACCD:
      store_tile<E_ACCD, W, true>(x, C, E, acc, i0, j0, jh);
      break;
    case E_ROWD:
      store_tile<E_ROWD, W, true>(x, C, E, acc, i0, j0, jh);
      break;
    default: store_tile<E_SGND, W, true>(x, C, E, acc, i0, j0, jh);
  }
}

template <int K>
__device__ __forceinline__ void vec_item21(const Ctx& x, int code,
                                           int code2, int e) {
  const int i = e / K;
  const int c = e - i * K;
  vec_out(x, code, e, i,
          dot_row<K>(mat_slot(x, slot(code, 0)) + i * x.LD,
                     vec_slot(x, slot(code2, 1)), c, x.n) +
              dot_row<K>(mat_slot(x, slot(code2, 0)) + i * x.LD,
                         vec_slot(x, slot(code, 1)), c, x.n));
}

// One phase of (2,1) jobs: nm <= 3 matrix jobs (codes m0..m2, second codes
// n0..n2) and nv <= 2 vector jobs (v0, v1; w0, w1), spread over the
// block's warps as in phase. No barrier at the end: the caller first waits
// for the staging copies it started beside the phase.
template <int K>
__device__ __noinline__ void phase21(int nm, int m0, int m1, int m2, int n0,
                                     int n1, int n2, int nv, int v0, int v1,
                                     int w0, int w1) {
  const Ctx x = g_tile_ctx;
  const int lanes = blockDim.x;
  const bool narrow = x.tiles4 <= lanes && nm == 1;
  const int per_job = narrow ? x.tiles4 : x.tiles;
  const int nt = nm * per_job;
  const int mw = (nt + 31) >> 5;
  const int nvo = x.n * K;
  const int vw = (nv * nvo + 31) >> 5;
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < mw + vw; w += lanes >> 5) {
    if (w < mw) {
      const int p = (w << 5) + lane;
      if (p < nt) {
        const int q = (p >= per_job) + (p >= 2 * per_job);
        const int code = q == 0 ? m0 : (q == 1 ? m1 : m2);
        const int code2 = q == 0 ? n0 : (q == 1 ? n1 : n2);
        if (narrow)
          tile_item21<4>(x, code, code2, p);
        else
          tile_item21<8>(x, code, code2, p - q * per_job);
      }
    } else {
      const int t = ((w - mw) << 5) + lane;
      if (t < nv * nvo)
        vec_item21<K>(x, t < nvo ? v0 : v1, t < nvo ? w0 : w1,
                      t < nvo ? t : t - nvo);
    }
  }
}

// (I - S)^-1 by Newton-Schulz, m <- m (2I - m + S m), from the seed
// m = I + S that the phase forming S wrote (E_SEED). On entry S, m, c, nm
// are the slots of S, the seed and two scratch matrices; on return m holds
// the inverse and the other three are free. 0 iterations: the seed alone.
template <int K>
__device__ __forceinline__ void ns_inverse(int S, int& m, int& c, int& nm,
                                           int iters) {
  for (int it = 0; it < iters; ++it) {
    phase1<K>(job(S, m, c, E_NS, m));   // c = 2I - m + S m
    phase1<K>(job(m, c, nm));           // nm = m c
    const int tmp = m;
    m = nm;
    nm = tmp;
  }
}

// Slots of the doubling ladder: r (starred), t, four matrix temporaries,
// the sources jp, jm (starred) and three vector temporaries.
struct Ladder {
  int r, t, T[4];
  int jp, jm, va, vb, vc;
};

// The doubling ladder on starred operators (_doubling_math of
// vsmartmom_tpu/ops/fused_rt.py), ndoubl steps on the NS schedule sched:
//   S = r r (seed I + S), gp = (I - S)^-1, tt_gp = t gp,
//   X = r [t | jp | jm ek], Y = tt_gp [t | rt | jm ek + r jp | jp + r jm ek],
//   t' = Y0, r' = r + Y1, jm' = jm + Y2, jp' = jp ek + Y3, ek' = ek^2,
// with ek the block's per-row attenuation (N x K, squared in place). With
// `unstar` the last step writes r-+ = D r and D jm (so ndoubl >= 1). On
// return L.t names the buffer of the last t, L.T the four free ones.
template <int K>
__device__ void ladder(Ladder& L, int ndoubl, const int* sched, bool unstar) {
  const Ctx x = g_tile_ctx;
  const int NK = x.n * K;
  float* ek = fp32_tile_smem + x.ek;
  for (int step = 0; step < ndoubl; ++step) {
    // Rides S = r r: ek squared (after the first step), jm_e = jm ek.
    const float* jm = vec_slot(x, L.jm);
    float* va = vec_slot(x, L.va);
    for (int e = threadIdx.x; e < NK; e += blockDim.x) {
      float f = ek[e];
      if (step > 0) {
        f *= f;
        ek[e] = f;
      }
      va[e] = jm[e] * f;
    }
    int S = L.T[0], m = L.T[1], c = L.T[2], nm = L.T[3];
    phase1<K>(job(L.r, L.r, S, E_SEED, m));
    ns_inverse<K>(S, m, c, nm, sched[step]);
    // m = gp; S, c, nm free.
    const bool last = unstar && step == ndoubl - 1;
    phase<K>(2, job(L.t, m, S), job(L.r, L.t, c), m, 2,
             job(L.r, L.jp, L.vb, E_ADD, L.va),      // c3 = jm_e + r jp
             job(L.r, L.va, L.vc, E_ADD, L.jp));     // c4 = jp + r jm_e
    phase<K>(2, job(S, L.t, nm), job(S, c, L.r, last ? E_ACCD : E_ACC), nm,
             2, job(S, L.vb, L.jm, last ? E_ACCD : E_ACC),
             job(S, L.vc, L.jp, E_EK));
    L.T[0] = L.t;
    L.t = nm;
    L.T[1] = m;
    L.T[2] = S;
    L.T[3] = c;
  }
}

// Slots of the composite of the adding step (T++ moves between slots).
struct Comp {
  int Rmp, Rpm, Tpp, Tmm, Jp, Jm;
};

// The adding step onto the composite c (_interaction_math of
// vsmartmom_tpu/ops/fused_rt.py: Sanghavi 2014 Eqs. 23-28 with one NS
// inverse of ns_inter iterations, the push-through identity for the second
// geometric factor) with the unstarred layer in L: r-+ in L.r, t++ in L.t,
// j0+ in L.jp, j0- in L.jm; r+- = D r-+ D and t-- = D t++ D by parity.
// One phase before the NS inverse and four after: t-- = D t D rides in
// front of the first, and t++ is not formed again (T21 = t++ + t++ Ru is
// D (D t-- D + t-- (D Ru)), the same products up to sign). On return c
// holds the new composite (its T++ in a slot of L.T, which takes the old
// T++ slot), L.t holds t-- and L.T four free slots.
template <int K>
__device__ void adding(Comp& c, Ladder& L, int ns_inter) {
  const Ctx x = g_tile_ctx;
  const float* d = fp32_tile_smem + x.d;
  float* t = mat_slot(x, L.t);
  for (int e = threadIdx.x; e < x.n * x.n; e += blockDim.x) {
    const int i = e / x.n;
    const int j = e - i * x.n;
    t[i * x.LD + j] *= d[i] * d[j];
  }
  int S = L.T[0], m = L.T[1], cc = L.T[2], nm = L.T[3];
  phase1<K>(job(L.r, c.Rpm, S, E_SEED, m));        // r-+ R+-, seed
  ns_inverse<K>(S, m, cc, nm, ns_inter);           // m = inv1
  // T01 = T-- inv1, rT = r-+ T++, u = inv1 r-+; rJ + j0- = j0- + r-+ J+
  phase<K>(3, job(c.Tmm, m, S), job(L.r, c.Tpp, cc), job(m, L.r, nm), 1,
           job(L.r, c.Jp, L.va, E_ADD, L.jm), 0);
  // T-- = T01 t--, R-+ += T01 rT, D Ru = D R+- u; J- += T01 (rJ + j0-),
  // J+ + Rj = J+ + R+- j0-
  phase<K>(3, job(S, L.t, c.Tmm), job(S, cc, c.Rmp, E_ACC),
           job(c.Rpm, nm, m, E_ROWD), 2, job(S, L.va, c.Jm, E_ACC),
           job(c.Rpm, L.jm, L.vb, E_ADD, c.Jp));
  // Rt = R+- t--; T21 = t++ + t++ Ru = D (D t-- D + t-- (D Ru))
  phase<K>(2, job(c.Rpm, L.t, nm), job(L.t, m, cc, E_SGND, L.t), 0, 0, 0,
           0);
  // T++ = T21 T++, R+- = r+- + T21 Rt (r+- = D r-+ D); J+ = j0+ +
  // T21 (J+ + Rj)
  phase<K>(2, job(cc, c.Tpp, S), job(cc, nm, c.Rpm, E_SGN, L.r), 0, 1,
           job(cc, L.vb, c.Jp, E_ADD, L.jp), 0);
  L.T[0] = c.Tpp;
  L.T[1] = m;
  L.T[2] = cc;
  L.T[3] = nm;
  c.Tpp = S;
}

}  // namespace fp32_tile
