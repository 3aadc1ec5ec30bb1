// Per-layer adding-doubling kernels for Hopper (sm_90a), one thread block per
// (layer, spectral point):
//
//   K5  doubling_kernel  the doubling ladder on starred operators. Replaces
//       the TPU kernel vsmartmom_tpu/ops/fused_rt.py::fused_doubling ->
//       _doubling_kernel (_doubling_math in its exact-f32 "highest" mode).
//   K4  layer_kernel     the same ladder, the unstar and parity step, and the
//       adding step onto a composite read from global memory. Replaces
//       fused_rt.py::fused_layer_step -> _layer_kernel (_doubling_math, the
//       D-matrix step, _interaction_math).
//
// The algebra is the band kernel's (csrc/fused_band.cu): Newton-Schulz for
// (I - S)^-1 on the scene-probed per-step schedule (0 = the Neumann seed
// I + S alone), the source products folded into the matrix products, and
// the push-through identity for the adding step's second geometric factor.
// What differs from K1: the layer's starred r*, t++, j0+ and D j0- arrive
// from global memory instead of being assembled from row tables, and the
// beam attenuation expk is per row (s, N, K), squared every step.
//
// Product code. Both run on csrc/fp32_tile.cuh, K1's: one lane a 4 x 8
// FMA tile over the whole depth in two- and three-product phases (12
// shared loads per 128 FMA), a 4 x 4 tile in one-product phases, 6 warps a
// block, two blocks an SM. K5 runs the header's ladder; K4 the same ladder
// (its last step unstars r and jm in its epilogue) and then the header's
// adding step, K1's, on a composite read from global memory. K4's matrix
// outputs round as its plain version's matmuls do; its source vectors sum
// a float4 of depth at a time into four partial sums.
//
// Design. K5 keeps r, t, the two source stacks, three vector temporaries,
// the per-row attenuation and four N x N NS/product temporaries in shared
// memory for the whole ladder: six N x N f32 matrices, 67 KB at N = 52,
// K = 1. K4 adds the composite's four matrices (ten in all, 110 KB at
// N = 52, K1's layout); its composite comes from and goes back to global
// memory once per layer, the HBM trip per layer that K1 avoids by looping
// over layers inside the block.
//
// K5's two paths, chosen per block on the device after the load by one
// block-wide vote: where r is all zeros and t is diagonal (a purely
// absorbing layer: every moment above m_scat, 13 of the flagship's 16
// multisensor launches), S = r r = 0, so the NS inverse is I whatever the
// schedule, tt_gp = t and X = 0, and each step reduces to O(N) per point:
//   t_ii <- t_ii t_ii, jm_i <- jm_i + t_ii (jm_i ek_i),
//   jp_i <- jp_i ek_i + t_ii jp_i, ek_i <- ek_i^2, r stays 0,
// each product rounded before the add as the plain matmul rounds it beside
// its exact zeros, so the path gives the plain version's values bit for
// bit. Every other block runs the dense ladder.
//
// Bound. A dense ladder step with k NS iterations is (2k + 5) N^3 + 4 K N^2
// FMAs per point, the adding step (2 ns_inter + 11) N^3 + 4 K N^2, against
// O(N^2) bytes per point in and out: both kernels are bound by FP32
// operations there. K5's diagonal path does O(N K) work per step against
// the same O(N^2) bytes: it is bound by bytes.

#include <cuda_runtime.h>

#include <stdint.h>

#include "fp32_tile.cuh"

#define VSM_MAX_N 64
#define VSM_MAX_K 2
#define VSM_MAX_DOUBL 32
// K5's and K4's threads a block: 6 warps, two blocks an SM (<= 168
// registers).
#define VSM_K5_THREADS 192

namespace {

__device__ __forceinline__ void load_mat(float* dst, const float* src, int N,
                                         int LD, const float* rowd) {
  for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
    const int i = e / N;
    dst[i * LD + e - i * N] = rowd ? rowd[i] * src[e] : src[e];
  }
}

__device__ __forceinline__ void store_mat(float* dst, const float* src,
                                          int N, int LD) {
  for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
    const int i = e / N;
    dst[e] = src[i * LD + e - i * N];
  }
}

__device__ __forceinline__ void copy_vec(float* dst, const float* src,
                                         int NK) {
  for (int e = threadIdx.x; e < NK; e += blockDim.x) dst[e] = src[e];
}

// Dynamic shared memory of nmat N x N matrices at row stride LD, nvec
// (N, K) vectors and the D diagonal.
size_t smem_bytes(int nmat, int nvec, int N, int K) {
  const int LD = (N + 3) & ~3;
  const int VS = (N * K + 3) & ~3;
  return (static_cast<size_t>(nmat) * N * LD +
          static_cast<size_t>(nvec) * VS + LD) * sizeof(float);
}

struct DArgs {
  const float* r;    // (s, N, N) starred reflection
  const float* t;    // (s, N, N)
  const float* jp;   // (s, N, K)
  const float* jm;   // (s, N, K) starred
  const float* ek;   // (s, N, K) per-row attenuation
  float* ro;
  float* to;
  float* jpo;
  float* jmo;
  int N, ndoubl;
  int vec4;          // N N % 4 == 0 and every matrix 16-byte aligned
  int sched[VSM_MAX_DOUBL];
};

// The O(N) ladder of a block whose r is zero and t diagonal: row i of t,
// jp, jm and ek, each product rounded on its own (no contraction), in the
// order of the plain version's products; r stays zero. t's diagonal goes
// through `diag` (N floats of shared memory) to the writes of r and t.
template <int K>
__device__ void diagonal_ladder(const DArgs& a, const float* t,
                                const float* jp, const float* jm,
                                const float* ek, float* diag, int LD,
                                size_t mo, size_t vo) {
  const int N = a.N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float tii = t[i * LD + i];
    float p[K], m[K], f[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      p[c] = jp[i * K + c];
      m[c] = jm[i * K + c];
      f[c] = ek[i * K + c];
    }
    for (int step = 0; step < a.ndoubl; ++step) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        m[c] = __fadd_rn(m[c], __fmul_rn(tii, __fmul_rn(m[c], f[c])));
        p[c] = __fadd_rn(__fmul_rn(p[c], f[c]), __fmul_rn(tii, p[c]));
        f[c] = __fmul_rn(f[c], f[c]);
      }
      tii = __fmul_rn(tii, tii);
    }
    diag[i] = tii;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      a.jpo[vo + i * K + c] = p[c];
      a.jmo[vo + i * K + c] = m[c];
    }
  }
  __syncthreads();
  const int NN = N * N;
  if (a.vec4) {
    float4* ro = reinterpret_cast<float4*>(a.ro + mo);
    float4* to = reinterpret_cast<float4*>(a.to + mo);
#pragma unroll 4
    for (int q = threadIdx.x; q < NN / 4; q += blockDim.x) {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = 4 * q + c;
        const int i = e / N;
        v[c] = e - i * N == i ? diag[i] : 0.0f;
      }
      ro[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      to[q] = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int e = threadIdx.x; e < NN; e += blockDim.x) {
      const int i = e / N;
      a.ro[mo + e] = 0.0f;
      a.to[mo + e] = e - i * N == i ? diag[i] : 0.0f;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(VSM_K5_THREADS, 2)
    doubling_kernel(const DArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N;
  const int LD = (N + 3) & ~3;           // float4-aligned rows
  const int MS = N * LD;
  const int NN = N * N;
  const int NK = N * K;
  const int VS = (NK + 3) & ~3;
  const size_t mo = static_cast<size_t>(blockIdx.x) * NN;
  const size_t vo = static_cast<size_t>(blockIdx.x) * NK;
  // Matrix slots r 0, t 1, temporaries 2-5; vector slots jp 0, jm 1,
  // temporaries 2-4, the per-row attenuation 5.
  float* V = smem + 6 * MS;
  fp32_tile::set_ctx(smem, V, V, V + 5 * VS, N, K);
  // r and t into shared memory (float4 reads where the layout allows),
  // and the vote: is r zero and t diagonal?
  bool diag = true;
  if (a.vec4) {
    const float4* r4 = reinterpret_cast<const float4*>(a.r + mo);
    const float4* t4 = reinterpret_cast<const float4*>(a.t + mo);
#pragma unroll 4
    for (int q = threadIdx.x; q < NN / 4; q += blockDim.x) {
      const float4 rq = r4[q], tq = t4[q];
      const float rv[4] = {rq.x, rq.y, rq.z, rq.w};
      const float tv[4] = {tq.x, tq.y, tq.z, tq.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = 4 * q + c;
        const int i = e / N;
        const int j = e - i * N;
        smem[i * LD + j] = rv[c];
        smem[MS + i * LD + j] = tv[c];
        diag = diag && rv[c] == 0.0f && (i == j || tv[c] == 0.0f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < NN; e += blockDim.x) {
      const int i = e / N;
      const int j = e - i * N;
      const float rv = a.r[mo + e], tv = a.t[mo + e];
      smem[i * LD + j] = rv;
      smem[MS + i * LD + j] = tv;
      diag = diag && rv == 0.0f && (i == j || tv == 0.0f);
    }
  }
  for (int e = threadIdx.x; e < NK; e += blockDim.x) {
    V[e] = a.jp[vo + e];
    V[VS + e] = a.jm[vo + e];
    V[5 * VS + e] = a.ek[vo + e];
  }
  if (__syncthreads_and(diag)) {
    diagonal_ladder<K>(a, smem + MS, V, V + VS, V + 5 * VS, V + 2 * VS, LD,
                       mo, vo);
    return;
  }
  fp32_tile::Ladder L;
  L.r = 0;
  L.t = 1;
  L.T[0] = 2;
  L.T[1] = 3;
  L.T[2] = 4;
  L.T[3] = 5;
  L.jp = 0;
  L.jm = 1;
  L.va = 2;
  L.vb = 3;
  L.vc = 4;
  fp32_tile::ladder<K>(L, a.ndoubl, a.sched, false);
  store_mat(a.ro + mo, smem, N, LD);
  store_mat(a.to + mo, smem + L.t * MS, N, LD);
  copy_vec(a.jpo + vo, V, NK);
  copy_vec(a.jmo + vo, V + VS, NK);
}

struct LArgs {
  const float* Rmp;  // (s, N, N) composite in
  const float* Rpm;
  const float* Tpp;
  const float* Tmm;
  const float* r;    // (s, N, N) starred elemental reflection
  const float* t;    // (s, N, N) elemental t++
  const float* Jp;   // (s, N, K) composite sources in
  const float* Jm;
  const float* jp;   // (s, N, K) elemental j0+
  const float* jm;   // (s, N, K) starred elemental D j0-
  const float* ek;   // (s, N, K) per-row attenuation
  const float* dvec; // (N,) D-matrix diagonal (+-1)
  float* Rmpo;       // (s, N, N) composite out
  float* Rpmo;
  float* Tppo;
  float* Tmmo;
  float* Jpo;        // (s, N, K)
  float* Jmo;
  int N, ndoubl, ns_inter;
  int sched[VSM_MAX_DOUBL];
};

// Matrix slots of the composite and vector slots (K1's layout).
enum { RMP = 0, RPM = 1, TPP0 = 2, TMM = 3 };
enum { VJP = 0, VJM = 1, Vjp = 2, Vjm = 3, Va = 4, Vb = 5, Vc = 6, Vek = 7 };

template <int K>
__global__ void __launch_bounds__(VSM_K5_THREADS, 2)
    layer_kernel(const LArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N;
  const int LD = (N + 3) & ~3;
  const int MS = N * LD;
  const int NK = N * K;
  const int VS = (NK + 3) & ~3;
  const size_t mo = static_cast<size_t>(blockIdx.x) * N * N;
  const size_t vo = static_cast<size_t>(blockIdx.x) * NK;
  float* V = smem + 10 * MS;
  float* sd = V + 8 * VS;                // D diagonal
  fp32_tile::set_ctx(smem, V, sd, V + Vek * VS, N, K);
  for (int i = threadIdx.x; i < N; i += blockDim.x) sd[i] = a.dvec[i];
  __syncthreads();
  // Without doubling steps the layer is unstarred here (with them, the
  // ladder's last step unstars r and jm in its epilogue).
  const float* rowd = a.ndoubl > 0 ? nullptr : sd;
  load_mat(smem + RMP * MS, a.Rmp + mo, N, LD, nullptr);
  load_mat(smem + RPM * MS, a.Rpm + mo, N, LD, nullptr);
  load_mat(smem + TPP0 * MS, a.Tpp + mo, N, LD, nullptr);
  load_mat(smem + TMM * MS, a.Tmm + mo, N, LD, nullptr);
  load_mat(smem + 4 * MS, a.r + mo, N, LD, rowd);
  load_mat(smem + 5 * MS, a.t + mo, N, LD, nullptr);
  for (int e = threadIdx.x; e < NK; e += blockDim.x) {
    V[VJP * VS + e] = a.Jp[vo + e];
    V[VJM * VS + e] = a.Jm[vo + e];
    V[Vjp * VS + e] = a.jp[vo + e];
    V[Vjm * VS + e] = rowd ? rowd[e / K] * a.jm[vo + e] : a.jm[vo + e];
    V[Vek * VS + e] = a.ek[vo + e];
  }
  __syncthreads();
  fp32_tile::Ladder L;
  L.r = 4;
  L.t = 5;
  L.T[0] = 6;
  L.T[1] = 7;
  L.T[2] = 8;
  L.T[3] = 9;
  L.jp = Vjp;
  L.jm = Vjm;
  L.va = Va;
  L.vb = Vb;
  L.vc = Vc;
  fp32_tile::ladder<K>(L, a.ndoubl, a.sched, true);
  fp32_tile::Comp c;
  c.Rmp = RMP;
  c.Rpm = RPM;
  c.Tpp = TPP0;
  c.Tmm = TMM;
  c.Jp = VJP;
  c.Jm = VJM;
  fp32_tile::adding<K>(c, L, a.ns_inter);
  store_mat(a.Rmpo + mo, smem + RMP * MS, N, LD);
  store_mat(a.Rpmo + mo, smem + RPM * MS, N, LD);
  store_mat(a.Tppo + mo, smem + c.Tpp * MS, N, LD);
  store_mat(a.Tmmo + mo, smem + TMM * MS, N, LD);
  copy_vec(a.Jpo + vo, V + VJP * VS, NK);
  copy_vec(a.Jmo + vo, V + VJM * VS, NK);
}

bool bad_shape(int s, int N, int K, int ndoubl) {
  return N < 1 || N > VSM_MAX_N || K < 1 || K > VSM_MAX_K || s < 0 ||
         ndoubl < 0 || ndoubl > VSM_MAX_DOUBL;
}

template <typename KernelArgs>
int launch(void (*kernel)(KernelArgs), const KernelArgs& a, int s,
           int threads, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s > 0)
    kernel<<<s, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of `kernel` at `threads` and `smem` dynamic shared bytes that one
// SM holds at once (registers and shared memory), or minus a CUDA error
// code.
template <typename KernelArgs>
int resident(void (*kernel)(KernelArgs), int threads, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* vsm_rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K5's blocks at (N, K) resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a CUDA error
// code.
int vsm_fused_doubling_blocks_per_sm(int N, int K) {
  if (bad_shape(0, N, K, 0)) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(6, 6, N, K);
  return K == 1 ? resident(doubling_kernel<1>, VSM_K5_THREADS, smem)
                : resident(doubling_kernel<2>, VSM_K5_THREADS, smem);
}

// K4's blocks at (N, K) resident on one SM, as above.
int vsm_fused_layer_step_blocks_per_sm(int N, int K) {
  if (bad_shape(0, N, K, 0)) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(10, 8, N, K);
  return K == 1 ? resident(layer_kernel<1>, VSM_K5_THREADS, smem)
                : resident(layer_kernel<2>, VSM_K5_THREADS, smem);
}

// K5: launches the doubling ladder on `stream` for s points and returns
// cudaGetLastError() (0 on success). All pointers are device pointers except
// `sched` (host, ndoubl entries).
int vsm_fused_doubling_f32(const float* r, const float* t, const float* jp,
                           const float* jm, const float* ek, float* ro,
                           float* to, float* jpo, float* jmo, int s, int N,
                           int K, int ndoubl, const int* sched,
                           void* stream) {
  if (bad_shape(s, N, K, ndoubl))
    return static_cast<int>(cudaErrorInvalidValue);
  DArgs a;
  a.r = r;
  a.t = t;
  a.jp = jp;
  a.jm = jm;
  a.ek = ek;
  a.ro = ro;
  a.to = to;
  a.jpo = jpo;
  a.jmo = jmo;
  a.N = N;
  a.ndoubl = ndoubl;
  a.vec4 = (N * N) % 4 == 0 &&
           ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(t) |
             reinterpret_cast<uintptr_t>(ro) |
             reinterpret_cast<uintptr_t>(to)) & 15) == 0;
  for (int i = 0; i < VSM_MAX_DOUBL; ++i)
    a.sched[i] = i < ndoubl ? sched[i] : 0;
  const size_t smem = smem_bytes(6, 6, N, K);
  return K == 1 ? launch(doubling_kernel<1>, a, s, VSM_K5_THREADS, smem,
                         stream)
                : launch(doubling_kernel<2>, a, s, VSM_K5_THREADS, smem,
                         stream);
}

// K4: launches the layer step on `stream` for s points; as above, with the
// interaction's NS iteration count `ns_inter`.
int vsm_fused_layer_step_f32(const float* Rmp, const float* Rpm,
                             const float* Tpp, const float* Tmm,
                             const float* r, const float* t, const float* Jp,
                             const float* Jm, const float* jp,
                             const float* jm, const float* ek,
                             const float* dvec, float* Rmpo, float* Rpmo,
                             float* Tppo, float* Tmmo, float* Jpo,
                             float* Jmo, int s, int N, int K, int ndoubl,
                             const int* sched, int ns_inter, void* stream) {
  if (bad_shape(s, N, K, ndoubl) || ns_inter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  LArgs a;
  a.Rmp = Rmp;
  a.Rpm = Rpm;
  a.Tpp = Tpp;
  a.Tmm = Tmm;
  a.r = r;
  a.t = t;
  a.Jp = Jp;
  a.Jm = Jm;
  a.jp = jp;
  a.jm = jm;
  a.ek = ek;
  a.dvec = dvec;
  a.Rmpo = Rmpo;
  a.Rpmo = Rpmo;
  a.Tppo = Tppo;
  a.Tmmo = Tmmo;
  a.Jpo = Jpo;
  a.Jmo = Jmo;
  a.N = N;
  a.ndoubl = ndoubl;
  a.ns_inter = ns_inter;
  for (int i = 0; i < VSM_MAX_DOUBL; ++i)
    a.sched[i] = i < ndoubl ? sched[i] : 0;
  const size_t smem = smem_bytes(10, 8, N, K);
  return K == 1 ? launch(layer_kernel<1>, a, s, VSM_K5_THREADS, smem, stream)
                : launch(layer_kernel<2>, a, s, VSM_K5_THREADS, smem,
                         stream);
}

}  // extern "C"
