// Small batched products for the dot-precision probes, on Hopper (sm_90a).
//
//   dot_chain       one thread block per (batch entry, column tile) runs a
//       chain of products on row-major (batch, n, n) / (batch, n, c) operands
//       held in shared memory, in one of three forms:
//         right  x <- scale (x @ a), `chain` times (also `single`: chain 1,
//                scale 1, any c);
//         left   acc <- x @ acc, `chain` times;
//         sum    acc = sum_{k < ndot} (x + k) @ y.
//       Replaces the Pallas kernels of scripts/probe_batched_dot.py:67
//       (P1, the closure in pallas_batched), probe_dot_prec_speed.py:36 (P2),
//       probe_dot_prec_speed2.py:33 (P3), probe_mosaic_dot_prec.py:36 (P6)
//       and probe_dotperf.py:55 (P8, mxu_kernel).
//   lane_dot_chain  the (n, n, s) layout with the spectral axis last:
//       C[i,j,s] = sum_k x[i,k,s] a[k,j,s], x <- scale C, `chain` times.
//       Replaces probe_vpu_dot.py:59 (P4, the closure in vpu_batched) and
//       probe_dotperf.py:82 (P9, vpu_kernel).
//
// Dot modes, from the TPU's precisions: fp32 ("highest", "float32") is SIMT
// FP32 FMA with a 4 x 4 register tile per thread, the product loop of K1, K4
// and K5 (csrc/rt_device.cuh, `product`) in isolation; tf32 ("default",
// None) is one mma.sync.m16n8k8 TF32 pass on operands rounded by
// cvt.rna.tf32.f32; 3xtf32 ("high") splits each operand into a TF32 head
// and a TF32 tail of the remainder and sums lo.hi + hi.lo + hi.hi in FP32.
//
// Bound. Per product 2 n^2 c useful operations against (2 n^2 + n c) words
// per block, with the whole chain in shared memory: every form is bound by
// operations, FP32 at 67 TFLOP/s or TF32 at 495 (3xtf32 at 495 / 3), counted
// on the unpadded work. Design: the mma fragments need rows padded to 16 and
// the depth and columns to 8 (n = 52 -> 64 x 56, n = 104 -> 112 x 104), so
// the three operands live zero-padded in shared memory; row strides are 4
// (A) and 8 (B) words past a multiple of 32 so the fragment loads hit 32
// distinct banks. P3's c = 312 (y, x and acc would take 303 KB) is cut into
// column tiles of <= 128, one block each; n = 104 needs more than 48 KB, so
// each launch sets the dynamic shared-memory limit. No wgmma, TMA or
// occupancy work yet.
//
// lane_dot_chain streams both operands from L2 (x and a are 22 MB each at
// n = 52, s = 2048): sixteen neighbouring points per block take neighbouring
// addresses, so every load of a warp is two 64-byte runs, and each thread
// holds a 4 x 4 output tile of one point in registers. An n x n operand per
// point does not fit a thread's registers, and sixteen points' operands
// (346 KB at n = 52) do not fit shared memory. The chain ping-pongs through
// a global scratch buffer; __syncthreads orders a step's writes before the
// next step's reads within the block, which owns its points for the whole
// chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { F_RIGHT = 0, F_LEFT = 1, F_SUM = 2 };
enum { M_FP32 = 0, M_TF32 = 1, M_3XTF32 = 2 };
enum { EPI_SCALE = 0, EPI_ADD = 1 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 128;
constexpr int kMaxTile = 128;
constexpr int kSmemLimit = 232448;

struct DotArgs {
  const float* x;  // (batch, n, n)
  const float* y;  // (batch, n, c)
  float* out;      // (batch, n, c)
  int n, c, ct;    // rows and depth n, output columns c, column tile ct
  int form, chain, ndot;
  float scale;
  int Mp;          // rows padded to 16 (every buffer has Mp rows)
  int Kp;          // depth padded to 8
  int lda, ldb, ldo;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// D += A B for one m16n8k8 TF32 tile (A row-major, B column-major fragments).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void put(float* O, int idx, float acc, int epi,
                                    float scale) {
  O[idx] = epi == EPI_ADD ? O[idx] + acc : acc * scale;
}

// O[:n, :cw] = epi(A[:n, :n] @ B[:n, :cw]) for the whole block; the caller
// synchronises before and after. fp32: 4 x 4 register tiles of the useful
// region. TF32 modes: warp tiles of 16 rows x 32 columns over the padded
// operands (their pads are zero), stored on the useful region only.
template <int MODE>
__device__ void block_product(const float* A, int lda, const float* B,
                              int ldb, float* O, int ldo, int n, int cw,
                              int Kp, int Mp, int epi, float scale) {
  if (MODE == M_FP32) {
    const int tr = (n + 3) >> 2;
    const int tc = (cw + 3) >> 2;
    for (int t = threadIdx.x; t < tr * tc; t += blockDim.x) {
      const int ti = t / tc;
      const int i0 = ti << 2;
      const int j0 = (t - ti * tc) << 2;
      const float* a0 = A + i0 * lda;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(B + k * ldb + j0);
        const float av[4] = {a0[k], a0[lda + k], a0[2 * lda + k],
                             a0[3 * lda + k]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][0] = fmaf(av[r], b.x, acc[r][0]);
          acc[r][1] = fmaf(av[r], b.y, acc[r][1]);
          acc[r][2] = fmaf(av[r], b.z, acc[r][2]);
          acc[r][3] = fmaf(av[r], b.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        if (i >= n) break;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + c;
          if (j < cw) put(O, i * ldo + j, acc[r][c], epi, scale);
        }
      }
    }
    return;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // groupID
  const int q = lane & 3;    // threadID_in_group
  const int cp = (cw + 7) & ~7;
  const int mtiles = Mp >> 4;
  const int strips = (cp + 31) >> 5;
  for (int task = warp; task < mtiles * strips; task += kWarps) {
    const int m0 = (task / strips) << 4;
    const int n0 = (task - (task / strips) * strips) << 5;
    float acc[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
    for (int k0 = 0; k0 < Kp; k0 += 8) {
      const float* ar = A + (m0 + g) * lda + k0 + q;
      const float av[4] = {ar[0], ar[8 * lda], ar[4], ar[8 * lda + 4]};
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (MODE == M_TF32)
          ahi[e] = to_tf32(av[e]);
        else
          split_tf32(av[e], ahi[e], alo[e]);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = n0 + (t << 3);
        if (col >= cp) break;
        const float* br = B + (k0 + q) * ldb + col + g;
        const float bv[2] = {br[0], br[4 * ldb]};
        uint32_t bhi[2], blo[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (MODE == M_TF32)
            bhi[e] = to_tf32(bv[e]);
          else
            split_tf32(bv[e], bhi[e], blo[e]);
        }
        if (MODE == M_3XTF32) {
          mma_tf32(acc[t], alo, bhi);
          mma_tf32(acc[t], ahi, blo);
        }
        mma_tf32(acc[t], ahi, bhi);
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int col = n0 + (t << 3) + 2 * q;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = m0 + g + ((e >> 1) << 3);
        const int j = col + (e & 1);
        if (i < n && j < cw) put(O, i * ldo + j, acc[t][e], epi, scale);
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) dot_chain_kernel(const DotArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n = a.n;
  const int c0 = blockIdx.y * a.ct;
  const int cw = min(a.ct, a.c - c0);
  float* A = smem;
  float* B = A + a.Mp * a.lda;
  float* O = B + a.Mp * a.ldb;
  int lda = a.lda, ldb = a.ldb, ldo = a.ldo;
  const int total = a.Mp * (lda + ldb + ldo);
  for (int e = threadIdx.x; e < total; e += blockDim.x) smem[e] = 0.0f;
  __syncthreads();
  const float* x = a.x + static_cast<size_t>(blockIdx.x) * n * n;
  const float* y = a.y + static_cast<size_t>(blockIdx.x) * n * a.c;
  float* out = a.out + static_cast<size_t>(blockIdx.x) * n * a.c;
  if (a.form != F_SUM)
    for (int e = threadIdx.x; e < n * n; e += blockDim.x)
      A[(e / n) * lda + e % n] = x[e];
  for (int e = threadIdx.x; e < n * cw; e += blockDim.x) {
    const int i = e / cw;
    const int j = e - i * cw;
    B[i * ldb + j] = y[i * a.c + c0 + j];
  }
  __syncthreads();

  const float* R = O;  // the result's buffer and stride
  int ldr = ldo;
  if (a.form == F_RIGHT) {
    for (int s = 0; s < a.chain; ++s) {
      block_product<MODE>(A, lda, B, ldb, O, ldo, n, cw, a.Kp, a.Mp,
                          EPI_SCALE, a.scale);
      __syncthreads();
      float* tmp = A;
      A = O;
      O = tmp;
    }
    R = A;
    ldr = lda;
  } else if (a.form == F_LEFT) {
    for (int s = 0; s < a.chain; ++s) {
      block_product<MODE>(A, lda, B, ldb, O, ldo, n, cw, a.Kp, a.Mp,
                          EPI_SCALE, 1.0f);
      __syncthreads();
      float* tmp = B;
      B = O;
      O = tmp;
    }
    R = B;
    ldr = ldb;
  } else {
    for (int k = 0; k < a.ndot; ++k) {
      const float fk = static_cast<float>(k);
      for (int e = threadIdx.x; e < n * n; e += blockDim.x)
        A[(e / n) * lda + e % n] = x[e] + fk;
      __syncthreads();
      block_product<MODE>(A, lda, B, ldb, O, ldo, n, cw, a.Kp, a.Mp,
                          EPI_ADD, 1.0f);
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < n * cw; e += blockDim.x) {
    const int i = e / cw;
    const int j = e - i * cw;
    out[i * a.c + c0 + j] = R[i * ldr + j];
  }
}

struct LaneArgs {
  const float* x;  // (n, n, s)
  const float* a;  // (n, n, s)
  float* out;      // (n, n, s)
  float* work;     // (n, n, s) scratch for the chain's odd steps
  int n, s, chain;
  float scale;
};

constexpr int kLanes = 16;   // points per block, neighbouring in s
constexpr int kGroups = 16;  // tile groups per block

__global__ void __launch_bounds__(kLanes * kGroups)
    lane_chain_kernel(const LaneArgs p) {
  const int n = p.n;
  const size_t S = p.s;
  const int s = blockIdx.x * kLanes + threadIdx.x;
  const bool live = s < p.s;
  const int tg = (n + 3) >> 2;
  const float* __restrict__ a = p.a;
  for (int step = 0; step < p.chain; ++step) {
    const float* src =
        step == 0 ? p.x : ((p.chain - step) % 2 == 0 ? p.out : p.work);
    float* dst = (p.chain - 1 - step) % 2 == 0 ? p.out : p.work;
    for (int t = threadIdx.y; live && t < tg * tg; t += kGroups) {
      const int i0 = (t / tg) << 2;
      const int j0 = (t % tg) << 2;
      int ri[4], cj[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ri[r] = min(i0 + r, n - 1);
        cj[r] = min(j0 + r, n - 1);
      }
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
      for (int k = 0; k < n; ++k) {
        float xv[4], av[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          xv[r] = src[(static_cast<size_t>(ri[r]) * n + k) * S + s];
          av[r] = __ldg(a + (static_cast<size_t>(k) * n + cj[r]) * S + s);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(xv[r], av[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (i0 + r < n && j0 + c < n)
            dst[(static_cast<size_t>(i0 + r) * n + j0 + c) * S + s] =
                acc[r][c] * p.scale;
    }
    __syncthreads();
  }
}

int ld_for(int width, int rem) {
  int ld = (width - rem + 31) / 32 * 32 + rem;
  return ld < width ? ld + 32 : ld;
}

template <int MODE>
int launch_dot(const DotArgs& a, int batch, int tiles, size_t smem,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dot_chain_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch > 0)
    dot_chain_kernel<MODE><<<dim3(batch, tiles), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* vsm_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dot_chain on `stream` for `batch` entries; returns cudaGetLastError() (0 on
// success). form: 0 right, 1 left, 2 sum; mode: 0 fp32, 1 tf32, 2 3xtf32.
// x (batch, n, n), y and out (batch, n, c), all device pointers; the chain
// forms need c == n.
int vsm_dot_chain_f32(const float* x, const float* y, float* out, int batch,
                      int n, int c, int form, int mode, int chain, int ndot,
                      float scale, void* stream) {
  if (batch < 0 || n < 1 || n > kMaxN || c < 1 || form < F_RIGHT ||
      form > F_SUM || mode < M_FP32 || mode > M_3XTF32 || chain < 1 ||
      ndot < 1 || (form != F_SUM && chain > 1 && c != n) ||
      (form == F_LEFT && c != n))
    return static_cast<int>(cudaErrorInvalidValue);
  DotArgs a;
  a.x = x;
  a.y = y;
  a.out = out;
  a.n = n;
  a.c = c;
  const int tiles = (c + kMaxTile - 1) / kMaxTile;
  a.ct = ((c + tiles - 1) / tiles + 7) & ~7;
  a.form = form;
  a.chain = chain;
  a.ndot = ndot;
  a.scale = scale;
  a.Mp = (n + 15) & ~15;
  a.Kp = (n + 7) & ~7;
  a.lda = ld_for(a.Kp, 4);
  a.ldb = ld_for(a.ct > a.Kp ? a.ct : a.Kp, 8);
  a.ldo = form == F_RIGHT ? a.lda : a.ldb;
  if (form == F_RIGHT && a.ldo < a.ct) a.ldo = a.lda = ld_for(a.ct, 4);
  const size_t smem =
      static_cast<size_t>(a.Mp) * (a.lda + a.ldb + a.ldo) * sizeof(float);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case M_TF32: return launch_dot<M_TF32>(a, batch, tiles, smem, st);
    case M_3XTF32: return launch_dot<M_3XTF32>(a, batch, tiles, smem, st);
    default: return launch_dot<M_FP32>(a, batch, tiles, smem, st);
  }
}

// lane_dot_chain on `stream`: x, a, out and work are (n, n, s) device
// pointers; returns cudaGetLastError().
int vsm_lane_dot_chain_f32(const float* x, const float* a, float* out,
                           float* work, int n, int s, int chain, float scale,
                           void* stream) {
  if (n < 1 || s < 0 || chain < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  LaneArgs p;
  p.x = x;
  p.a = a;
  p.out = out;
  p.work = work;
  p.n = n;
  p.s = s;
  p.chain = chain;
  p.scale = scale;
  if (s > 0)
    lane_chain_kernel<<<(s + kLanes - 1) / kLanes, dim3(kLanes, kGroups), 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
