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
// The algebra is the whole-moment band kernel's (csrc/fused_band.cu), copied
// into csrc/rt_device.cuh (shared with csrc/band_stages.cu) so that K1's build
// and its outputs stay as they are: Newton-Schulz for
// (I - S)^-1 on the scene-probed per-step schedule (0 = the Neumann seed
// I + S alone), the source products folded into the matrix products, and the
// push-through identity for the adding step's second geometric factor. What
// differs from K1: the layer's starred r*, t++, j0+ and D j0- arrive from
// global memory instead of being assembled from row tables, and the beam
// attenuation expk is per row (s, N, K), squared every step.
//
// Design. K5 keeps r, t, the two source stacks, three vector temporaries and
// four N x N NS/product temporaries in shared memory for the whole ladder:
// six N x N f32 matrices, 67 KB at N = 52, K = 1. K4 adds the composite's
// four matrices (ten in all, 110 KB at N = 52, as K1); its composite comes
// from and goes back to global memory once per layer, the HBM trip per layer
// that K1 avoids by looping over layers inside the block.
//
// Bound. A ladder step with k NS iterations is (2k + 5) N^3 + 4 K N^2 FMAs
// per point, the adding step (2 ns_inter + 11) N^3 + 4 K N^2, against
// O(N^2) bytes per point in and out: both kernels are bound by FP32
// operations. The products are K1's register-tiled FP32 FMA loops (a 4 x 4
// output tile per thread, B rows read as float4).

#include <cuda_runtime.h>

#include "rt_device.cuh"

#define VSM_MAX_N 64
#define VSM_MAX_K 2
#define VSM_MAX_DOUBL 32

namespace {

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
  int N, K, ndoubl;
  int sched[VSM_MAX_DOUBL];
};

__global__ void __launch_bounds__(256) doubling_kernel(const DArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, K = a.K;
  const int LD = (N + 3) & ~3;           // float4-aligned rows
  const int MS = N * LD;
  const int VS = (N * K + 3) & ~3;
  const size_t mo = static_cast<size_t>(blockIdx.x) * N * N;
  const size_t vo = static_cast<size_t>(blockIdx.x) * N * K;
  Work w = carve(smem, 0, MS, VS);
  load_mat(w.r, a.r + mo, N, LD);
  load_mat(w.t, a.t + mo, N, LD);
  copy_vec(w.jp, a.jp + vo, N * K);
  copy_vec(w.jm, a.jm + vo, N * K);
  copy_vec(w.ek, a.ek + vo, N * K);
  __syncthreads();
  ladder(w, a.ndoubl, a.sched, nullptr, N, LD, K);
  store_mat(a.ro + mo, w.r, N, LD);
  store_mat(a.to + mo, w.t, N, LD);
  copy_vec(a.jpo + vo, w.jp, N * K);
  copy_vec(a.jmo + vo, w.jm, N * K);
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
  int N, K, ndoubl, ns_inter;
  int sched[VSM_MAX_DOUBL];
};

__global__ void __launch_bounds__(256) layer_kernel(const LArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, K = a.K;
  const int LD = (N + 3) & ~3;
  const int MS = N * LD;
  const int VS = (N * K + 3) & ~3;
  const int NN = N * N;
  const int NK = N * K;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t mo = static_cast<size_t>(blockIdx.x) * NN;
  const size_t vo = static_cast<size_t>(blockIdx.x) * NK;

  Comp c;
  c.Rmp = smem;
  c.Rpm = smem + MS;
  c.Tpp = smem + 2 * MS;
  c.Tmm = smem + 3 * MS;
  Work w = carve(smem, 4, MS, VS);
  c.Jp = w.ek + VS;
  c.Jm = c.Jp + VS;
  float* sd = c.Jm + VS;                 // D diagonal

  load_mat(c.Rmp, a.Rmp + mo, N, LD);
  load_mat(c.Rpm, a.Rpm + mo, N, LD);
  load_mat(c.Tpp, a.Tpp + mo, N, LD);
  load_mat(c.Tmm, a.Tmm + mo, N, LD);
  load_mat(w.r, a.r + mo, N, LD);
  load_mat(w.t, a.t + mo, N, LD);
  copy_vec(c.Jp, a.Jp + vo, NK);
  copy_vec(c.Jm, a.Jm + vo, NK);
  copy_vec(w.jp, a.jp + vo, NK);
  copy_vec(w.jm, a.jm + vo, NK);
  copy_vec(w.ek, a.ek + vo, NK);
  for (int i = tid; i < N; i += nt) sd[i] = a.dvec[i];
  __syncthreads();

  ladder(w, a.ndoubl, a.sched, sd, N, LD, K);

  // ---- unstar: r-+ = D r*, j0- = D j-* ----
  for (int e = tid; e < NN; e += nt) {
    const int i = e / N;
    w.r[i * LD + e - i * N] *= sd[i];
  }
  for (int e = tid; e < NK; e += nt) w.jm[e] *= sd[e / K];
  __syncthreads();

  adding(c, w, sd, a.ns_inter, N, LD, K);

  store_mat(a.Rmpo + mo, c.Rmp, N, LD);
  store_mat(a.Rpmo + mo, c.Rpm, N, LD);
  store_mat(a.Tppo + mo, c.Tpp, N, LD);
  store_mat(a.Tmmo + mo, c.Tmm, N, LD);
  copy_vec(a.Jpo + vo, c.Jp, NK);
  copy_vec(a.Jmo + vo, c.Jm, NK);
}

bool bad_shape(int s, int N, int K, int ndoubl) {
  return N < 1 || N > VSM_MAX_N || K < 1 || K > VSM_MAX_K || s < 0 ||
         ndoubl < 0 || ndoubl > VSM_MAX_DOUBL;
}

template <typename KernelArgs>
int launch(void (*kernel)(KernelArgs), const KernelArgs& a, int s, int N,
           size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s > 0)
    kernel<<<s, threads_for(N), smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* vsm_rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
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
  a.K = K;
  a.ndoubl = ndoubl;
  for (int i = 0; i < VSM_MAX_DOUBL; ++i)
    a.sched[i] = i < ndoubl ? sched[i] : 0;
  return launch(doubling_kernel, a, s, N, smem_bytes(6, 6, N, K), stream);
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
  a.K = K;
  a.ndoubl = ndoubl;
  a.ns_inter = ns_inter;
  for (int i = 0; i < VSM_MAX_DOUBL; ++i)
    a.sched[i] = i < ndoubl ? sched[i] : 0;
  return launch(layer_kernel, a, s, N, smem_bytes(10, 8, N, K), stream);
}

}  // extern "C"
