// The warpgroup TF32 / 3xtf32 matrix tile on Hopper (wgmma.mma_async,
// sm_90a), shared by the kernels that take a TF32 dot mode.
//
// What the tile computes. One warpgroup (128 threads, four warps) adds
//   D[64 x N] += A[64 x K] B[K x N]
// into FP32 accumulators held in its registers, A and B read from shared
// memory by the tensor cores, one wgmma.m64nNk8 per 8 of depth, N one of
// 16, 32, 56, 64, 104, 128 (``Wgmma<N>``; wgmma takes any multiple of 8
// up to 256, one more specialization each). Two modes:
//   TF32    one pass, D += A B. The operands must be TF32 values when they
//           are stored (``to_tf32``, cvt.rna: nearest, ties away from zero):
//           the tensor cores read an f32 word and drop its low 13 bits, they
//           do not round.
//   X3TF32  each operand as a TF32 head and the TF32 rounding of its
//           remainder (``split``), D += lo.hi + hi.lo + hi.hi issued into the
//           one accumulator, from two shared-memory copies of each operand;
//           the lo.lo term is dropped.
//
// Operand layout. TF32 wgmma takes both operands K-major only: A as its 64
// rows, B as its N columns, each row holding the depth. Both are stored in
// 8 x 4 core matrices (8 rows of 16 bytes of depth, 128 contiguous bytes),
// without swizzle: element (r, k) of an operand of depth kp (a multiple of
// 8) lies at float offset kmajor(r, k, kp) = (r/8) 8kp + (k/4) 32 + (r%8) 4
// + k%4. The descriptor's leading byte offset (the two core matrices of one
// k8 step) is 128 B, its stride byte offset (8-row groups) 32 kp B, and each
// k8 step starts 256 B after the last. So a row-major matrix reaches A by
// 16-byte copies of four depth values; B is the transpose of a row-major
// right operand. Pads: rows past the matrix and depth from n up to kp must
// hold zeros.
//
// Accumulators. Thread t of the warpgroup (warp w = t / 32, g = (t % 32) / 4,
// q = t % 4) holds d[4j + e] = D[16w + g + 8(e / 2)][8j + 2q + e % 2],
// j < N / 8 (``acc_row``, ``acc_col``).
//
// Shared memory per copy: A 256 kp B, B 4 N kp B. At n = 52 (kp = N = 56):
// A 14,336 B and B 12,544 B, so one tile takes 26,880 B in TF32 and 53,760 B
// in X3TF32; at n = 104 (kp = N = 104): A 26,624 B and B 43,264 B, 69,888 B
// in TF32 and 139,776 B in X3TF32. A second warpgroup that shares B adds its
// A only (probe_dots.cu's blocks: PERF.md section 6).
//
// Error. One (104, 104) product of standard normals against its f64 product
// (max|d| / max|f64|, probe P6, NVIDIA H100 80GB HBM3, chip_smoke.py): TF32
// 3.29e-4, X3TF32 9.14e-7 (FP32 FMA on the CUDA cores: 3.66e-7). TF32 keeps
// about three decimal digits; X3TF32 keeps f32's class.
//
// Synchronisation the caller owns. Stores to A or B by threads are
// generic-proxy writes: the writers issue fence_async() and a barrier
// follows before the wgmma that reads them. tile() returns after
// wgmma.wait_group 0; the operands may be overwritten once every warp of
// the warpgroup has passed a barrier after it.

#pragma once

#include <stdint.h>

#include <utility>

namespace hmma {

enum { TF32 = 1, X3TF32 = 2 };

__host__ __device__ constexpr int kmajor(int r, int k, int kp) {
  return (r >> 3) * (kp << 3) + ((k >> 2) << 5) + ((r & 7) << 2) + (k & 3);
}

// The (row, depth) of float offset e of that layout: walking e in order
// walks shared memory without bank conflicts.
__host__ __device__ constexpr int kmajor_row(int e, int kp) {
  return (e / (kp << 3)) * 8 + ((e & 31) >> 2);
}

__host__ __device__ constexpr int kmajor_depth(int e, int kp) {
  return ((e % (kp << 3)) >> 5) * 4 + (e & 3);
}

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// hi = TF32(v), lo = TF32(v - hi); lo is 0 in mode TF32.
template <int MODE>
__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  hi = to_tf32(v);
  lo = MODE == X3TF32 ? to_tf32(v - hi) : 0.0f;
}

// split() of four values at once, head and tail stored as float4 at hi[e4]
// and lo[e4] (lo unused in TF32).
template <int MODE>
__device__ __forceinline__ void split4(float4 v, float4* hi, float4* lo,
                                       int e4) {
  float4 h, l;
  split<MODE>(v.x, h.x, l.x);
  split<MODE>(v.y, h.y, l.y);
  split<MODE>(v.z, h.z, l.z);
  split<MODE>(v.w, h.w, l.w);
  hi[e4] = h;
  if (MODE == X3TF32) lo[e4] = l;
}

// The shared-memory descriptor of an operand of depth kp at p (16-byte
// aligned), no swizzle.
__device__ __forceinline__ uint64_t desc(const float* p, int kp) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((32 * kp) >> 4) << 32);
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ int acc_row(int tid, int e) {
  return ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2) + ((e >> 1) << 3);
}

__device__ __forceinline__ int acc_col(int tid, int j, int e) {
  return (j << 3) + ((tid & 3) << 1) + (e & 1);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  template <int OFF>
  static __device__ __forceinline__ void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 ra, rb;\nsetp.ne.b32 p, %10, 0;\n"
        "add.s64 ra, %8, %11;\nadd.s64 rb, %9, %11;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, ra, rb, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1), "n"(OFF));
  }
};

template <>
struct Wgmma<32> {
  template <int OFF>
  static __device__ __forceinline__ void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 ra, rb;\nsetp.ne.b32 p, %18, 0;\n"
        "add.s64 ra, %16, %19;\nadd.s64 rb, %17, %19;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, ra, rb, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(1), "n"(OFF));
  }
};

template <>
struct Wgmma<56> {
  template <int OFF>
  static __device__ __forceinline__ void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 ra, rb;\nsetp.ne.b32 p, %30, 0;\n"
        "add.s64 ra, %28, %31;\nadd.s64 rb, %29, %31;\n"
        "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27}, ra, rb, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "l"(da), "l"(db), "r"(1), "n"(OFF));
  }
};

template <>
struct Wgmma<64> {
  template <int OFF>
  static __device__ __forceinline__ void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 ra, rb;\nsetp.ne.b32 p, %34, 0;\n"
        "add.s64 ra, %32, %35;\nadd.s64 rb, %33, %35;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, ra, rb, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(OFF));
  }
};

template <>
struct Wgmma<104> {
  template <int OFF>
  static __device__ __forceinline__ void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 ra, rb;\nsetp.ne.b32 p, %54, 0;\n"
        "add.s64 ra, %52, %55;\nadd.s64 rb, %53, %55;\n"
        "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51}, ra, rb, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51])
        : "l"(da), "l"(db), "r"(1), "n"(OFF));
  }
};

template <>
struct Wgmma<128> {
  template <int OFF>
  static __device__ __forceinline__ void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 ra, rb;\nsetp.ne.b32 p, %66, 0;\n"
        "add.s64 ra, %64, %67;\nadd.s64 rb, %65, %67;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, ra, rb, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1), "n"(OFF));
  }
};

// Pins the accumulators at this point of the program: the compiler sees
// the asynchronous wgmma's registers written only at its issue, so without
// this a read after the wait could be moved above it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One step of depth 8 at k: its descriptors are the bases plus 256 k bytes,
// added inside the instruction's asm, so the compiler keeps only the bases
// live and not one descriptor per step.
template <int MODE, int N, int OFF>
__device__ __forceinline__ void step(float (&d)[N / 2], uint64_t a_hi,
                                     uint64_t a_lo, uint64_t b_hi,
                                     uint64_t b_lo) {
  if (MODE == X3TF32) {
    Wgmma<N>::template mma<OFF>(d, a_lo, b_hi);
    Wgmma<N>::template mma<OFF>(d, a_hi, b_lo);
  }
  Wgmma<N>::template mma<OFF>(d, a_hi, b_hi);
}

template <int MODE, int N, int... K>
__device__ __forceinline__ void steps(float (&d)[N / 2], uint64_t a_hi,
                                      uint64_t a_lo, uint64_t b_hi,
                                      uint64_t b_lo,
                                      std::integer_sequence<int, K...>) {
  (step<MODE, N, 16 * K>(d, a_hi, a_lo, b_hi, b_lo), ...);
}

// d += A B over KSTEPS steps of depth 8, A and B given by their
// descriptors (head and tail copies; the tails are unused in TF32). All
// four warps of the warpgroup call it together. The step count is a
// template argument and the steps are unrolled: with a run-time loop, or
// an unrolled one guarded by a run-time count, ptxas serializes the wgmmas
// (C7515: copies of the loop-carried accumulators count as writes between
// them; C7520: arrives it inserts on the guarded paths), measured on
// sm_90a with CUDA 12.8.
template <int MODE, int N, int KSTEPS>
__device__ __forceinline__ void tile(float (&d)[N / 2], uint64_t a_hi,
                                     uint64_t a_lo, uint64_t b_hi,
                                     uint64_t b_lo) {
  fence_regs<N>(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  steps<MODE, N>(d, a_hi, a_lo, b_hi, b_lo,
                 std::make_integer_sequence<int, KSTEPS>());
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs<N>(d);
}

}  // namespace hmma
