// Small batched products for the dot-precision probes, on Hopper (sm_90a).
//
//   dot_chain       a chain of products on row-major (batch, n, n) /
//       (batch, n, c) operands, in one of four forms:
//         right   x <- scale (x @ y), `chain` times;
//         left    acc <- x @ acc from acc = y, `chain` times;
//         sum     acc = sum_{k < ndot} (x + k) @ y;
//         single  x @ y times scale once, any c.
//       Replaces the Pallas kernels of scripts/probe_batched_dot.py:67
//       (P1, the closure in pallas_batched), probe_dot_prec_speed.py:36 (P2),
//       probe_dot_prec_speed2.py:33 (P3), probe_mosaic_dot_prec.py:36 (P6)
//       and probe_dotperf.py:55 (P8, mxu_kernel).
//   lane_dot_chain  the (n, n, s) layout with the spectral axis last:
//       C[i,j,s] = sum_k x[i,k,s] a[k,j,s], x <- scale C, `chain` times.
//       Replaces probe_vpu_dot.py:59 (P4, the closure in vpu_batched) and
//       probe_dotperf.py:82 (P9, vpu_kernel).
//
// Bound. Per product 2 n^2 c useful operations against (2 n^2 + n c) words
// read once, so every form is bound by operations: FP32 at 67 TFLOP/s, TF32
// at 495 (3xtf32 at 495 / 3), counted on the unpadded work.
//
// Design: the output is cut across blocks wherever the form lets each
// block keep its whole chain on chip. Rows are independent through a right
// chain, so a block owns a row slab of x and holds all of y; columns are
// independent through a left chain, so a block owns a column slab of acc
// and holds all of x; sum and single cut (row slab, column slab) tiles.
// The launch plan (rows and columns per block) is picked on the host
// (ops/probe_dots.py, dot_chain_plan) so that a small batch still fills the
// card (P6's (8, 104, 104) single launches 112 blocks) and at n = 104 at
// least two slabs are in flight per SM; this file checks it and derives the
// grid, threads and shared memory from it (vsm_dot_chain_info). Operands
// reach shared memory by cp.async (16 bytes where the rows allow, else 4,
// a transposed operand by 4-byte copies straight to its places), all in
// flight together, whose zero fill writes the pads; only fp32's B pad
// columns are cleared by stores. A chain's every
// step runs the same code on the same plan as a one-step launch, so a chain
// equals its own steps bit for bit.
//
// Dot modes, from the TPU's precisions:
//   fp32 ("highest", "float32"): exact FP32 FMA on the CUDA cores, the
//       product loop of K1, K4 and K5 in isolation. A is stored k-major (a
//       thread's four rows are one float4) and B row-major; each thread
//       keeps a 4 x 8 register tile (columns j0..j0+3 and h+j0..h+j0+3, h
//       half the slab, so a warp's B loads are contiguous), 3 shared loads
//       per 32 FMA. The operand a chain rewrites (A^T for right, B for
//       left) is double-buffered: one barrier a step.
//   tf32 ("default", None) and 3xtf32 ("high"): wgmma.mma_async m64nNk8
//       from csrc/hopper_mma.cuh, one warpgroup per 64 rows (two when they
//       share y or x at n > 64). The depth is n padded to the next of 16,
//       32, 56, 64, 104, 128 (n = 52 -> 56, n = 104 -> 104), a template
//       argument, so each step's wgmmas unroll and stay asynchronous; the
//       column slab N is 16 (small batches) or the whole depth. Both
//       operands K-major in shared memory, so B (y, or acc for left) is
//       stored transposed, its 4-byte cp.async copies going straight to
//       their places. Operands are rounded with cvt.rna as they are stored
//       (3xtf32: head and tail copies of both, split once per step), and
//       each step's accumulators are written back in the layout the next
//       step reads.
//
// lane_dot_chain stages a group of P neighbouring spectral points on chip
// (P = 2 at n = 52: 66.5 KB, three blocks per SM; P = 4 where four fit two
// blocks per SM), loads its (n, n, P) slabs of x and a once by 4-byte
// cp.async straight into per-point layouts (x transposed k-major, a
// row-major), runs all `chain` steps there with dot_chain's fp32 product
// loop and register tiles, and writes the result once. The point-interleaved
// (i, k, p) layout is not kept on chip: a float4 of four points' values
// would need four accumulator sets per (i, j) and give 6 shared loads per
// 32 FMA against the per-point tile's 3. So the spectral-axis-last layout
// costs only the strided global loads and stores (8 of every 32-byte sector
// used at P = 2: ~176 MB of sectors at (52, 52, 2048), ~53 us at HBM rate,
// once per launch), and the chain runs at dot_chain's fp32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

enum { F_RIGHT = 0, F_LEFT = 1, F_SUM = 2, F_SINGLE = 3 };
enum { M_FP32 = 0, M_TF32 = 1, M_3XTF32 = 2 };

constexpr int kMaxN = 128;
constexpr int kLaneMaxN = 64;
constexpr int kSimtMaxThreads = 256;
constexpr int kLaneMaxThreads = 512;
constexpr int kSmemLimit = 232448;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

struct DotArgs {
  const float* x;  // (batch, n, n)
  const float* y;  // (batch, n, c)
  float* out;      // (batch, n, c)
  int n, c, form, chain, ndot;
  float scale;
  int rows, cols;  // the plan: output rows and columns per block
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// dst[i ldd + k] = src[i lds + k] for i < rows, k < cols by cp.async, 16
// bytes a copy where every row allows it. The caller waits.
__device__ void load_rows(float* dst, int ldd, const float* src, int lds,
                          int rows, int cols) {
  const int T = blockDim.x;
  if (((cols | lds | ldd) & 3) == 0 && aligned16(src)) {
    const int c4 = cols >> 2;
    for (int e = threadIdx.x; e < rows * c4; e += T) {
      const int i = e / c4;
      const int k = (e - i * c4) << 2;
      cp_async16(dst + i * ldd + k, src + static_cast<size_t>(i) * lds + k,
                 true);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += T) {
      const int i = e / cols;
      const int k = e - i * cols;
      cp_async4(dst + i * ldd + k, src + static_cast<size_t>(i) * lds + k,
                true);
    }
  }
}

// ---------------------------------------------------------------- fp32 ----

// acc += A^T[:, 4 rows]^T B[:, 8 columns] over k < n: At points at the
// thread's four rows of a k-major A (stride lda), B at its first column of
// a row-major B (stride ldb); its other four columns start h later.
__device__ __forceinline__ void simt_product(const float* __restrict__ At,
                                             int lda,
                                             const float* __restrict__ B,
                                             int ldb, int n, int h,
                                             float (&acc)[4][8]) {
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(At + k * lda);
    const float4 b0 = *reinterpret_cast<const float4*>(B + k * ldb);
    const float4 b1 = *reinterpret_cast<const float4*>(B + k * ldb + h);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av[r], bv[j], acc[r][j]);
  }
}

// A thread's 4 x 8 tile of an (ms, cs) slab: rows i0..i0+3, columns
// j0 + (j & 3) + (j >> 2) h.
struct SimtTile {
  int i0, j0, h;
  bool live;
  __device__ SimtTile(int t, int ms, int cs) {
    const int ct = cs >> 3;
    const int ti = t / ct;
    live = t < (ms >> 2) * ct;
    i0 = ti << 2;
    j0 = (t - ti * ct) << 2;
    h = cs >> 1;
  }
  __device__ int col(int j) const { return j0 + (j & 3) + (j >> 2) * h; }
};

__device__ __forceinline__ void zero(float (&acc)[4][8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
}

// The next step's k-major A from a right step's tile: At[j][i0..i0+3] =
// scale acc[.][j] for the tile's columns j < n.
__device__ __forceinline__ void put_at(float* At, int lda, const SimtTile& t,
                                       const float (&acc)[4][8], float scale,
                                       int n) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = t.col(j);
    if (col < n)
      *reinterpret_cast<float4*>(At + col * lda + t.i0) =
          make_float4(acc[0][j] * scale, acc[1][j] * scale,
                      acc[2][j] * scale, acc[3][j] * scale);
  }
}

// At[k ms + i] = src[i n + k] for i < rv, k < n: the k-major copy of a
// row slab, by 4-byte cp.async straight to its places (k fastest, so a warp
// reads one contiguous run); the zero fill writes the pad columns
// rv <= i < ms. The caller waits.
__device__ void load_transposed(float* At, int ms, const float* src, int rv,
                                int n) {
  for (int e = threadIdx.x; e < ms * n; e += blockDim.x) {
    const int i = e / n;
    const bool ok = i < rv;
    cp_async4(At + (e - i * n) * ms + i, ok ? src + e : src, ok);
  }
}

// At = R + shift on the slab's rows i < rv, 0 on its pad columns.
__device__ void shift_slab(float* At, const float* R, int ms, int rv, int n,
                           float shift) {
  const int m4 = ms >> 2;
  for (int e = threadIdx.x; e < n * m4; e += blockDim.x) {
    const int i = (e - (e / m4) * m4) << 2;
    const float4 v = reinterpret_cast<const float4*>(R)[e];
    reinterpret_cast<float4*>(At)[e] = make_float4(
        i < rv ? v.x + shift : 0.0f, i + 1 < rv ? v.y + shift : 0.0f,
        i + 2 < rv ? v.z + shift : 0.0f, i + 3 < rv ? v.w + shift : 0.0f);
  }
}

// The fp32 dot_chain: block (b, row slab, column slab) of (rows, cols).
// Shared memory (floats, ns = n rounded to 4), every A k-major:
//   right, single  B (n x cols) | At0, At1 (ns x rows)
//   left           At (ns x rows) | B0, B1 (n x cols)
//   sum            R (ns x rows, the x slab) | At (ns x rows, R + k) | B
__global__ void __launch_bounds__(kSimtMaxThreads)
    simt_chain_kernel(const DotArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, c = a.c, ms = a.rows, cs = a.cols;
  const int ns = round_up(n, 4);
  const int r0 = blockIdx.y * ms;
  const int c0 = blockIdx.z * cs;
  const int rv = min(ms, n - r0);
  const int cw = min(cs, c - c0);
  const float* xs = a.x + static_cast<size_t>(blockIdx.x) * n * n + r0 * n;
  const float* ys = a.y + static_cast<size_t>(blockIdx.x) * n * c + c0;
  float* out = a.out + static_cast<size_t>(blockIdx.x) * n * c;
  float *R = nullptr, *At0, *At1 = nullptr, *B0, *B1 = nullptr;
  if (a.form == F_LEFT) {
    At0 = smem;
    B0 = At0 + ns * ms;
    B1 = B0 + n * cs;
  } else if (a.form == F_SUM) {
    R = smem;
    At0 = R + ns * ms;
    B0 = At0 + ns * ms;
  } else {
    B0 = smem;
    At0 = B0 + n * cs;
    At1 = At0 + ns * ms;
  }
  // Both operands in flight together; the B pads (columns cw..cs) are the
  // only cells the copies leave unset.
  load_transposed(a.form == F_SUM ? R : At0, ms, xs, rv, n);
  load_rows(B0, cs, ys, c, n, cw);
  for (int e = threadIdx.x; e < n * (cs - cw); e += blockDim.x) {
    const int k = e / (cs - cw);
    B0[k * cs + cw + e - k * (cs - cw)] = 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();

  // A single product whose tiles fit one warp (a small batch's plan) has
  // no chain to keep in step: the block's warps split the depth into
  // `parts` and add their partial tiles in a fixed order. Everything else:
  // one thread a tile over the whole depth.
  const int tiles = (ms >> 2) * (cs >> 3);
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  int parts = 1;
  if (a.form == F_SINGLE && tiles <= 32)
    parts = min(min(warps, n),
                1 + (n * cs + 2 * ns * ms) / (32 * tiles));  // partials fit
  const int part = parts > 1 ? threadIdx.x >> 5 : 0;
  const SimtTile t(parts > 1 ? lane : threadIdx.x, ms, cs);
  float acc[4][8];
  float scale = 1.0f;
  if (a.form == F_SINGLE) {
    scale = a.scale;
    const int kq = (n + parts - 1) / parts;
    const int k0 = min(n, part * kq), k1 = min(n, k0 + kq);
    zero(acc);
    if (t.live && part < parts && k1 > k0)
      simt_product(At0 + k0 * ms + t.i0, ms, B0 + k0 * cs + t.j0, cs,
                   k1 - k0, t.h, acc);
    if (parts > 1) {
      __syncthreads();  // the operands' space takes the partials
      float* P = smem + lane;
      if (t.live && part > 0 && part < parts)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            P[((part - 1) * 32 + r * 8 + j) * tiles] = acc[r][j];
      __syncthreads();
      if (part > 0) return;
      for (int q = 1; q < parts && t.live; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[r][j] += P[((q - 1) * 32 + r * 8 + j) * tiles];
    }
  } else if (a.form == F_RIGHT) {
    scale = a.scale;
    float* cur = At0;
    float* nxt = At1;
    for (int s = 0;; ++s) {
      zero(acc);
      if (t.live) simt_product(cur + t.i0, ms, B0 + t.j0, cs, n, t.h, acc);
      if (s + 1 == a.chain) break;
      if (t.live) put_at(nxt, ms, t, acc, scale, n);
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  } else if (a.form == F_LEFT) {
    float* cur = B0;
    float* nxt = B1;
    for (int s = 0;; ++s) {
      zero(acc);
      if (t.live) simt_product(At0 + t.i0, ms, cur + t.j0, cs, n, t.h, acc);
      if (s + 1 == a.chain) break;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (!t.live || t.i0 + r >= n) continue;
        float* row = nxt + (t.i0 + r) * cs + t.j0;
        *reinterpret_cast<float4*>(row) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        *reinterpret_cast<float4*>(row + t.h) =
            make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  } else {
    zero(acc);
    for (int k = 0; k < a.ndot; ++k) {
      if (k > 0) __syncthreads();
      shift_slab(At0, R, ms, rv, n, static_cast<float>(k));
      __syncthreads();
      if (t.live) simt_product(At0 + t.i0, ms, B0 + t.j0, cs, n, t.h, acc);
    }
  }
  if (!t.live) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (t.i0 + r >= rv) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = t.col(j);
      if (col < cw) out[(r0 + t.i0 + r) * c + c0 + col] = acc[r][j] * scale;
    }
  }
}

// --------------------------------------------------------- tf32, 3xtf32 ----

// The TF32 dot_chain: block (b, row slab, column slab) of (64 WG, NT), one
// warpgroup per 64 rows, all of them sharing B, depth KP (n padded up to
// the menu, ``depth_of``). Shared memory (floats, copies of A and B
// K-major, hopper_mma.cuh):
//   [R (sum: the raw x slab)] | A head | [A tail] | B head | [B tail]
// Two tf32 blocks of two warpgroups stay resident (128 registers a thread).
template <int MODE, int NT, int KP, int WG>
__global__ void __launch_bounds__(128 * WG, MODE == M_TF32 && WG == 2 ? 2 : 1)
    wg_chain_kernel(const DotArgs a) {
  extern __shared__ __align__(128) float smem[];
  constexpr int kMode = MODE == M_3XTF32 ? hmma::X3TF32 : hmma::TF32;
  constexpr int kCopies = MODE == M_3XTF32 ? 2 : 1;
  constexpr int kRows = 64 * WG;
  constexpr int kp = KP;
  const int n = a.n, c = a.c;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int r0 = blockIdx.y * kRows;
  const int c0 = blockIdx.z * NT;
  const int rv = min(kRows, n - r0);
  const int cw = min(NT, c - c0);
  const float* xs = a.x + static_cast<size_t>(blockIdx.x) * n * n + r0 * n;
  const float* ys = a.y + static_cast<size_t>(blockIdx.x) * n * c + c0;
  float* out = a.out + static_cast<size_t>(blockIdx.x) * n * c;
  float* R = smem;
  float* Ah = smem + (a.form == F_SUM ? kRows * kp : 0);
  float* Al = Ah + kRows * kp;
  float* Bh = Ah + kCopies * kRows * kp;
  float* Bl = Bh + NT * kp;

  // y[:, c0:c0 + cw] into B, transposed by 4-byte copies straight to the
  // K-major places, and the x slab into A (sum: into R), K-major, 16 bytes
  // a copy where the rows allow; the zero fill writes every pad. Copies go
  // in shared-memory order (no bank conflicts; a warp reads 4 or 8 runs of
  // a row) and are all in flight together. Then both operands are rounded
  // in place, a float4 a thread.
  for (int e = tid; e < NT * kp; e += blockDim.x) {
    const int j = hmma::kmajor_row(e, kp), k = hmma::kmajor_depth(e, kp);
    const bool ok = j < cw && k < n;
    cp_async4(Bh + e, ok ? ys + k * c + j : ys, ok);
  }
  float* Ax = a.form == F_SUM ? R : Ah;
  if ((n & 3) == 0 && aligned16(xs)) {
    for (int e = tid; e < kRows * kp / 4; e += blockDim.x) {
      const int i = hmma::kmajor_row(4 * e, kp);
      const int k = hmma::kmajor_depth(4 * e, kp);
      const bool ok = i < rv && k < n;
      cp_async16(Ax + 4 * e, ok ? xs + i * n + k : xs, ok);
    }
  } else {
    for (int e = tid; e < kRows * kp; e += blockDim.x) {
      const int i = hmma::kmajor_row(e, kp), k = hmma::kmajor_depth(e, kp);
      const bool ok = i < rv && k < n;
      cp_async4(Ax + e, ok ? xs + i * n + k : xs, ok);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  for (int e = tid; e < NT * kp / 4; e += blockDim.x)
    hmma::split4<kMode>(reinterpret_cast<float4*>(Bh)[e],
                        reinterpret_cast<float4*>(Bh),
                        reinterpret_cast<float4*>(Bl), e);
  for (int e = tid; a.form != F_SUM && e < kRows * kp / 4; e += blockDim.x)
    hmma::split4<kMode>(reinterpret_cast<float4*>(Ah)[e],
                        reinterpret_cast<float4*>(Ah),
                        reinterpret_cast<float4*>(Al), e);
  hmma::fence_async();
  __syncthreads();

  float* Awh = Ah + wg * 64 * kp;  // this warpgroup's rows
  float* Awl = Al + wg * 64 * kp;
  const uint64_t dah = hmma::desc(Awh, kp), dal = hmma::desc(Awl, kp);
  const uint64_t dbh = hmma::desc(Bh, kp), dbl = hmma::desc(Bl, kp);
  const int steps = a.form == F_SUM ? a.ndot
                    : a.form == F_SINGLE ? 1 : a.chain;
  const float scale =
      a.form == F_RIGHT || a.form == F_SINGLE ? a.scale : 1.0f;
  const int bar = 1 + wg;  // this warpgroup's named barrier
  float d[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) d[i] = 0.0f;
  for (int s = 0;; ++s) {
    if (a.form == F_SUM) {
      // A = x + s over the slab's useful cells, from R, in shared-memory
      // order (four depths of one row a float4).
      const float4* Rw = reinterpret_cast<const float4*>(R + wg * 64 * kp);
      const float fs = static_cast<float>(s);
      for (int e = wt; e < 16 * kp; e += 128) {
        const int i = 64 * wg + hmma::kmajor_row(4 * e, kp);
        const int k = hmma::kmajor_depth(4 * e, kp);
        float4 v = Rw[e];
        v.x = i < rv && k < n ? v.x + fs : 0.0f;
        v.y = i < rv && k + 1 < n ? v.y + fs : 0.0f;
        v.z = i < rv && k + 2 < n ? v.z + fs : 0.0f;
        v.w = i < rv && k + 3 < n ? v.w + fs : 0.0f;
        hmma::split4<kMode>(v, reinterpret_cast<float4*>(Awh),
                            reinterpret_cast<float4*>(Awl), e);
      }
      hmma::fence_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
    } else {
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) d[i] = 0.0f;
    }
    hmma::tile<kMode, NT, KP / 8>(d, dah, dal, dbh, dbl);
    if (s + 1 == steps) break;
    if (a.form == F_LEFT) {
      // acc -> B (transposed): every warpgroup reads all of B.
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 64 * wg + hmma::acc_row(wt, e);
          if (i >= kp) continue;
          float hi, lo;
          hmma::split<kMode>(d[4 * j + e], hi, lo);
          const int o = hmma::kmajor(hmma::acc_col(wt, j, e), i, kp);
          Bh[o] = hi;
          if (MODE == M_3XTF32) Bl[o] = lo;
        }
      hmma::fence_async();
      __syncthreads();
    } else {
      // right: scale acc -> this warpgroup's A rows; sum: A is rewritten
      // at the top of the next step. Both after every warp's reads.
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
      if (a.form == F_RIGHT) {
#pragma unroll
        for (int j = 0; j < NT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int col = hmma::acc_col(wt, j, e);
            if (col >= kp) continue;
            float2 hi, lo;
            hmma::split<kMode>(d[4 * j + e] * scale, hi.x, lo.x);
            hmma::split<kMode>(d[4 * j + e + 1] * scale, hi.y, lo.y);
            const int o = hmma::kmajor(hmma::acc_row(wt, e), col, kp);
            *reinterpret_cast<float2*>(Awh + o) = hi;
            if (MODE == M_3XTF32) *reinterpret_cast<float2*>(Awl + o) = lo;
          }
        hmma::fence_async();
        asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 64 * wg + hmma::acc_row(wt, e);
      const int col = hmma::acc_col(wt, j, e);
      if (i < rv && col < cw)
        out[(r0 + i) * c + c0 + col] = d[4 * j + e] * scale;
    }
}

// ---------------------------------------------------------------- lanes ----

struct LaneArgs {
  const float* x;  // (n, n, s)
  const float* a;  // (n, n, s)
  float* out;      // (n, n, s)
  int n, s, chain, points;
  float scale;
};

__host__ __device__ constexpr int lane_group(int n) {
  return round_up((round_up(n, 4) >> 2) * (round_up(n, 8) >> 3), 32);
}

__host__ __device__ constexpr int lane_point_floats(int n) {
  return n * round_up(n, 8) + 2 * round_up(n, 4) * round_up(n, 4);
}

// P = points neighbouring spectral points per block; per point (floats,
// ms = n rounded to 4, cs = n rounded to 8): B (n x cs, a row-major) | At0,
// At1 (ms x ms, x k-major, double-buffered). One group of threads per point
// runs dot_chain's fp32 right chain on it.
__global__ void __launch_bounds__(kLaneMaxThreads)
    lane_chain_kernel(const LaneArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, P = p.points;
  const int ms = round_up(n, 4), cs = round_up(n, 8);
  const int per = lane_point_floats(n);
  const int s0 = blockIdx.x * P;
  const size_t S = p.s;
  for (int e = threadIdx.x; e < P * n * n; e += blockDim.x) {
    const int pt = e % P;
    const int ik = e / P;  // (i, k) of x, (k, j) of a
    const int r = ik / n;
    const int q = ik - r * n;
    const bool ok = s0 + pt < p.s;
    const size_t off = static_cast<size_t>(ik) * S + s0 + pt;
    float* base = smem + pt * per;
    cp_async4(base + n * cs + q * ms + r, ok ? p.x + off : p.x, ok);
    cp_async4(base + r * cs + q, ok ? p.a + off : p.a, ok);
  }
  // The pads: At0's columns n..ms and B's columns n..cs, for k < n.
  for (int e = threadIdx.x; e < P * n; e += blockDim.x) {
    float* base = smem + (e / n) * per;
    const int k = e % n;
    for (int i = n; i < ms; ++i) base[n * cs + k * ms + i] = 0.0f;
    for (int j = n; j < cs; ++j) base[k * cs + j] = 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();

  const int G = lane_group(n);
  const int pt = threadIdx.x / G;
  const SimtTile t(threadIdx.x - pt * G, ms, cs);
  const bool live = t.live && pt < P;
  const float* B = smem + pt * per;
  float* cur = smem + pt * per + n * cs;
  float* nxt = cur + ms * ms;
  float acc[4][8];
  for (int step = 0;; ++step) {
    zero(acc);
    if (live) simt_product(cur + t.i0, ms, B + t.j0, cs, n, t.h, acc);
    if (step + 1 == p.chain) break;
    if (live) put_at(nxt, ms, t, acc, p.scale, n);
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (!live || s0 + pt >= p.s) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (t.i0 + r >= n) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = t.col(j);
      if (col < n)
        p.out[(static_cast<size_t>(t.i0 + r) * n + col) * S + s0 + pt] =
            acc[r][j] * p.scale;
    }
  }
}

// ------------------------------------------------------------ the plans ----

struct Launch {
  dim3 grid;
  int threads;
  size_t smem;
};

// The TF32 kernels' depth: n padded to the next of 16, 32, 56, 64, 104,
// 128 (n = 52 -> 56, n = 104 -> 104); a tile's step count is a template
// argument (hopper_mma.cuh, tile).
int depth_of(int n) {
  const int menu[] = {16, 32, 56, 64, 104, 128};
  for (int d : menu)
    if (n <= d) return d;
  return 0;
}

// The launch of dot_chain's plan (rows, cols per block), or false if the
// plan does not fit the operands, the kernels or shared memory.
bool dot_launch(int batch, int n, int c, int form, int mode, int rows,
                int cols, Launch* L) {
  if (rows < 1 || cols < 1) return false;
  const int rslabs = (n + rows - 1) / rows;
  const int cslabs = (c + cols - 1) / cols;
  if ((form == F_RIGHT && cslabs != 1) || (form == F_LEFT && rslabs != 1))
    return false;
  L->grid = dim3(batch, rslabs, cslabs);
  size_t floats;
  if (mode == M_FP32) {
    const int ns = round_up(n, 4);
    if (rows % 4 || cols % 8) return false;
    // One thread a 4 x 8 tile, at least four warps to load; a single
    // product whose tiles fit one warp: eight warps, which split the depth.
    const int tiles = (rows / 4) * (cols / 8);
    L->threads = form == F_SINGLE && tiles <= 32
                     ? kSimtMaxThreads
                     : max(round_up(tiles, 32), 128);
    if (L->threads > kSimtMaxThreads) return false;
    if (form == F_LEFT) {
      floats = static_cast<size_t>(ns) * rows + 2 * n * cols;
    } else if (form == F_SUM) {
      floats = 2 * static_cast<size_t>(rows) * ns + n * cols;
    } else {
      floats = static_cast<size_t>(n) * cols + 2 * ns * rows;
    }
  } else {
    // Column slabs of 16 or of the whole depth; two warpgroups at depth
    // 104 and 128 only: the instances built.
    const int kp = depth_of(n);
    const int copies = mode == M_3XTF32 ? 2 : 1;
    const int a_copies = copies + (form == F_SUM ? 1 : 0);
    if ((rows != 64 && (rows != 128 || kp < 104)) ||
        (cols != 16 && cols != kp))
      return false;
    if (form == F_RIGHT && cols != kp) return false;
    L->threads = 2 * rows;
    floats = static_cast<size_t>(kp) * (a_copies * rows + copies * cols);
  }
  L->smem = floats * sizeof(float);
  return L->smem <= kSmemLimit;
}

template <int MODE, int NT, int KP, int WG>
int wg_run(const DotArgs* a, const Launch& L, cudaStream_t st,
           int* blocks) {
  auto kernel = wg_chain_kernel<MODE, NT, KP, WG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, L.threads, L.smem));
  if (L.grid.x > 0) kernel<<<L.grid, L.threads, L.smem, st>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// The instance of (width, warpgroups) at depth KP: width 16 or KP, two
// warpgroups at KP >= 104 only (dot_launch's rule).
template <int MODE, int KP>
int wg_by_shape(int nt, const DotArgs* a, const Launch& L, cudaStream_t st,
                int* blocks) {
  if constexpr (KP >= 104) {
    if (L.threads == 256)
      return nt == 16 ? wg_run<MODE, 16, KP, 2>(a, L, st, blocks)
                      : wg_run<MODE, KP, KP, 2>(a, L, st, blocks);
  }
  return nt == 16 ? wg_run<MODE, 16, KP, 1>(a, L, st, blocks)
                  : wg_run<MODE, KP, KP, 1>(a, L, st, blocks);
}

template <int MODE>
int wg_by_depth(int kp, int nt, const DotArgs* a, const Launch& L,
                cudaStream_t st, int* blocks) {
  switch (kp) {
    case 16: return wg_by_shape<MODE, 16>(nt, a, L, st, blocks);
    case 32: return wg_by_shape<MODE, 32>(nt, a, L, st, blocks);
    case 56: return wg_by_shape<MODE, 56>(nt, a, L, st, blocks);
    case 64: return wg_by_shape<MODE, 64>(nt, a, L, st, blocks);
    case 104: return wg_by_shape<MODE, 104>(nt, a, L, st, blocks);
    default: return wg_by_shape<MODE, 128>(nt, a, L, st, blocks);
  }
}

// Launches dot_chain (a non-null) or reports its resident blocks per SM.
int dot_run(const DotArgs* a, int n, int mode, int cols, const Launch& L,
            cudaStream_t st, int* blocks) {
  const int kp = depth_of(n);
  if (mode == M_TF32)
    return wg_by_depth<M_TF32>(kp, cols, a, L, st, blocks);
  if (mode == M_3XTF32)
    return wg_by_depth<M_3XTF32>(kp, cols, a, L, st, blocks);
  cudaError_t err = cudaFuncSetAttribute(
      simt_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, simt_chain_kernel, L.threads, L.smem));
  if (L.grid.x > 0) simt_chain_kernel<<<L.grid, L.threads, L.smem, st>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

bool lane_launch(int n, int s, int points, Launch* L) {
  if (n < 1 || n > kLaneMaxN || s < 0 || points < 1) return false;
  L->grid = dim3((s + points - 1) / points);
  L->threads = points * lane_group(n);
  L->smem = static_cast<size_t>(points) * lane_point_floats(n) * sizeof(float);
  return L->threads <= kLaneMaxThreads && L->smem <= kSmemLimit;
}

int lane_run(const LaneArgs* p, const Launch& L, cudaStream_t st,
             int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      lane_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, lane_chain_kernel, L.threads, L.smem));
  if (L.grid.x > 0) lane_chain_kernel<<<L.grid, L.threads, L.smem, st>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

void fill_info(const Launch& L, int blocks, int* info) {
  info[0] = static_cast<int>(L.grid.x);
  info[1] = static_cast<int>(L.grid.y);
  info[2] = static_cast<int>(L.grid.z);
  info[3] = L.threads;
  info[4] = static_cast<int>(L.smem);
  info[5] = blocks;
}

bool dot_args_ok(int batch, int n, int c, int form, int mode, int chain,
                 int ndot) {
  return batch >= 0 && n >= 1 && n <= kMaxN && c >= 1 && form >= F_RIGHT &&
         form <= F_SINGLE && mode >= M_FP32 && mode <= M_3XTF32 &&
         chain >= 1 && ndot >= 1 && !(form == F_SINGLE && chain != 1) &&
         !((form == F_RIGHT || form == F_LEFT) && c != n);
}

}  // namespace

extern "C" {

const char* vsm_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dot_chain on `stream` for `batch` entries with the plan (rows, cols):
// output rows and columns per block (ops/probe_dots.py, dot_chain_plan).
// form: 0 right, 1 left, 2 sum, 3 single; mode: 0 fp32, 1 tf32, 2 3xtf32.
// x (batch, n, n), y and out (batch, n, c), all device pointers; right and
// left need c == n, single chain == 1. Returns cudaGetLastError() (0 on
// success), cudaErrorInvalidValue for operands or a plan it does not take.
int vsm_dot_chain_f32(const float* x, const float* y, float* out, int batch,
                      int n, int c, int form, int mode, int chain, int ndot,
                      float scale, int rows, int cols, void* stream) {
  Launch L;
  if (!dot_args_ok(batch, n, c, form, mode, chain, ndot) ||
      !dot_launch(batch, n, c, form, mode, rows, cols, &L))
    return static_cast<int>(cudaErrorInvalidValue);
  DotArgs a{x, y, out, n, c, form, chain, ndot, scale, rows, cols};
  return dot_run(&a, n, mode, cols, L, static_cast<cudaStream_t>(stream),
                 nullptr);
}

// The launch of that plan: info = {grid x, y, z, threads, dynamic shared
// bytes, resident blocks per SM by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor}.
int vsm_dot_chain_info(int batch, int n, int c, int form, int mode, int rows,
                       int cols, int* info) {
  Launch L;
  if (!dot_args_ok(batch, n, c, form, mode, 1, 1) ||
      !dot_launch(batch, n, c, form, mode, rows, cols, &L))
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const int rc = dot_run(nullptr, n, mode, cols, L, nullptr, &blocks);
  fill_info(L, blocks, info);
  return rc;
}

// lane_dot_chain on `stream`: x, a and out are (n, n, s) device pointers,
// `points` neighbouring spectral points per block (n <= 64); returns
// cudaGetLastError().
int vsm_lane_dot_chain_f32(const float* x, const float* a, float* out, int n,
                           int s, int chain, float scale, int points,
                           void* stream) {
  Launch L;
  if (chain < 1 || !lane_launch(n, s, points, &L))
    return static_cast<int>(cudaErrorInvalidValue);
  LaneArgs p{x, a, out, n, s, chain, points, scale};
  return lane_run(&p, L, static_cast<cudaStream_t>(stream), nullptr);
}

// The lane launch's info, as vsm_dot_chain_info's.
int vsm_lane_dot_chain_info(int n, int s, int points, int* info) {
  Launch L;
  if (!lane_launch(n, s, points, &L))
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const int rc = lane_run(nullptr, L, nullptr, &blocks);
  fill_info(L, blocks, info);
  return rc;
}

}  // extern "C"
