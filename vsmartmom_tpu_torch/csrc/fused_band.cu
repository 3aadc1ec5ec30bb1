// Whole-moment band kernel K1 for Hopper (sm_90a): one Fourier moment of the
// adding-doubling solve over all layers, one thread block per spectral point.
//
// Replaces the TPU kernel vsmartmom_tpu/ops/fused_band.py::fused_moment ->
// _moment_kernel (body _moment_body + _assemble_elemental, ladder and adding
// from ops/fused_rt.py::_doubling_math / _interaction_math), in its
// exact-f32 ("highest") mode. Per layer it
//   1. assembles the elemental r/t from the layer's O(N K) row tables and the
//      (C, N, N) phase matrices (cancellation-free forms; the f64-accurate
//      transcendental precursors Em1, ek, sources arrive precomputed),
//   2. runs the doubling ladder with a Newton-Schulz inverse on the
//      scene-probed per-step schedule (0 = the Neumann seed I + S alone),
//   3. adds the layer onto the composite with one NS inverse (push-through
//      identity for the second geometric factor).
//
// Design. The TPU kernel's sequential "arbitrary" layer grid axis becomes a
// loop over layers inside the block; the composite (R-+, R+-, T++, T--, J+,
// J-) and every ladder temporary stay in shared memory for the whole moment:
// ten N x N f32 matrices (10.8 KB each at N = 52) plus eight N x K vectors
// and the D diagonal, 110,032 B at N = 52, K = 1 (111,696 B at K = 2;
// dynamic shared memory, opted in per launch), so two blocks of 6 warps
// share an SM. Global memory sees the per-layer row tables in and the
// composite out once. K (1 solar, 2 solar + thermal source columns) is a
// template argument.
//
// Bound. Per point and layer the ladder and adding are ~(2k + 5) N x N x N
// products per doubling step, so the kernel is bound by FP32 operations, not
// bytes (a few KB of row tables per ~20 MFLOP). Every product runs on the
// FP32 register tiles of csrc/fp32_tile.cuh (shared with K3, K4 and K5,
// the ladder with K4 and K5, the adding with K4): one lane a
// 4 x 8 tile over the whole depth in phases of two or three products (12
// shared loads per 128 FMA), a 4 x 4 tile in one-product phases, so every
// phase keeps 5-6 of the block's warps busy (the adding's two
// three-product phases take two rounds). The ladder and the adding (one
// phase before its NS inverse and four after) are the header's. The
// elementwise passes ride in the phases: the unstar in the epilogue of the
// last doubling step (D r, D jm), the flip to t-- = D t D in front of the
// adding's first phase, and t++ is never formed again (T21 = t++ + t++ Ru
// is computed as D (D t-- D + t-- (D Ru)), the same products up to sign).
// Tensor cores (3xTF32, after a solver-level parity run), wgmma and TMA
// are later work.
//
// Wide operators. The single block holds the chain while its shared memory
// fits the opt-in (N <= 74 at K = 2, N <= 75 at K = 1); a wider scene (up
// to N = 128) runs cluster_band::cluster_kernel<K, false>
// (csrc/cluster_band.cuh): the chain's operators cut by rows across a
// thread-block cluster of 2, 4 or 8 blocks, one cluster a spectral point.
// vsm_band_cluster_plan gives the plan (cluster, rows of a band, threads,
// shared bytes); ops/fused_band.py::band_cluster_plan computes the same on
// the host, and the card tests hold the two against each other.

#include <cuda_runtime.h>

#include "cluster_band.cuh"
#include "fp32_tile.cuh"

#define VSM_MAX_N VSM_CB_MAX_N
#define VSM_MAX_K 2
#define VSM_MAX_DOUBL 32
#define VSM_NMAT 10
#define VSM_NVEC 8
// Threads of a block: 6 warps, two blocks an SM at N <= 52 (<= 168
// registers a thread).
#define VSM_THREADS 192

namespace {

using namespace fp32_tile;

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
  const float* ek;    // (nz, s, K) per-source beam attenuation per doubling
  float* Rmp;         // (s, N, N) composite outputs
  float* Rpm;
  float* Tpp;
  float* Tmm;
  float* Jp;          // (s, N, K)
  float* Jm;
  int s, N, C, nz, ndoubl, ns_inter;
  int sched[VSM_MAX_DOUBL];
};

// Matrix slots of the composite (T++ moves between slots) and vector slots.
enum { RMP = 0, RPM = 1, TPP0 = 2, TMM = 3 };
enum { VJP = 0, VJM = 1, Vjp = 2, Vjm = 3, Va = 4, Vb = 5, Vc = 6, Vek = 7 };

template <int K>
__global__ void __launch_bounds__(VSM_THREADS, 2) moment_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, C = a.C;
  const int LD = (N + 3) & ~3;           // float4-aligned rows
  const int MS = N * LD;
  const int NK = N * K;
  const int VS = (NK + 3) & ~3;
  const int NN = N * N;
  const int pt = blockIdx.x;             // spectral point of this block
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  float* V = smem + VSM_NMAT * MS;
  float* sd = V + VSM_NVEC * VS;         // D diagonal
  set_ctx(smem, V, sd, V + Vek * VS, N, K);

  // Vacuum composite: R = 0, T = I, J = 0.
  for (int e = tid; e < NN; e += nt) {
    const int i = e / N;
    const int j = e - i * N;
    const int idx = i * LD + j;
    smem[RMP * MS + idx] = 0.0f;
    smem[RPM * MS + idx] = 0.0f;
    smem[TPP0 * MS + idx] = (i == j) ? 1.0f : 0.0f;
    smem[TMM * MS + idx] = (i == j) ? 1.0f : 0.0f;
  }
  for (int e = tid; e < NK; e += nt) {
    V[VJP * VS + e] = 0.0f;
    V[VJM * VS + e] = 0.0f;
  }
  for (int i = tid; i < N; i += nt) sd[i] = a.dvec[i];

  const float* RG = a.geom;
  const float* GA = a.geom + NN;
  const float* TO = a.geom + 2 * NN;
  const float* TS = a.geom + 3 * NN;
  const bool starred = a.ndoubl > 0;     // else the layer is used as built
  Comp comp;
  comp.Rmp = RMP;
  comp.Rpm = RPM;
  comp.Tpp = TPP0;
  comp.Tmm = TMM;
  comp.Jp = VJP;
  comp.Jm = VJM;
  Ladder L;
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

  for (int z = 0; z < a.nz; ++z) {
    const size_t zs = static_cast<size_t>(z) * a.s + pt;
    __syncthreads();                     // sd, the vacuum / last composite
    // ---- row tables and the elemental assembly: r* = D r-+ (r-+ when
    // there is no doubling), t++, j0+, D j0- (j0-), ek per row ----
    for (int e = tid; e < NK; e += nt) {
      const float d = starred ? 1.0f : sd[e / K];
      V[Vjp * VS + e] = a.jp[zs * NK + e];
      V[Vjm * VS + e] = d * a.jms[zs * NK + e];
      V[Vek * VS + e] = a.ek[zs * K + e % K];
    }
    const float dt = a.dt[zs];
    const float* Em1 = a.Em1 + zs * N;
    float* r = smem + L.r * MS;
    float* t = smem + L.t * MS;
    for (int e = tid; e < NN; e += nt) {
      const int i = e / N;
      const int j = e - i * N;
      float wpp = 0.0f, wmp = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float wc = a.w[(static_cast<size_t>(z) * C + c) * a.s + pt];
        wpp = fmaf(wc, a.Zpp[c * NN + e], wpp);
        wmp = fmaf(wc, a.Zmp[c * NN + e], wmp);
      }
      const float em_i = Em1[i], em_j = Em1[j];
      const float Ei = 1.0f + em_i, Ej = 1.0f + em_j;
      const float one_m_EE = -(em_i + em_j + em_i * em_j);
      const int idx = i * LD + j;
      r[idx] = (starred ? sd[i] : 1.0f) * wmp * RG[e] * one_m_EE;
      // t_off ratio expm1(dt (mu_i - mu_j)/(mu_i mu_j)) with the 1/delta,
      // weight and same-mu masks folded into TO/TS. Ej expm1(x) is
      // Em1_i - Em1_j above |x| = 0.3 (no overflow in thick layers).
      const float x = dt * GA[e];
      const float num = fabsf(x) < 0.3f ? expm1f(x) * Ej : em_i - em_j;
      t[idx] = wpp * (num * TO[e] + (dt * TS[e]) * Ej) +
               (i == j ? Ei : 0.0f);
    }
    __syncthreads();

    // ---- doubling ladder on starred operators; its last step unstars:
    // r-+ = D r*, j0- = D j-* ----
    ladder<K>(L, a.ndoubl, a.sched, true);

    // ---- adding onto the composite (fp32_tile::adding) ----
    adding<K>(comp, L, a.ns_inter);
  }

  const size_t mo = static_cast<size_t>(pt) * NN;
  for (int e = tid; e < NN; e += nt) {
    const int i = e / N;
    const int idx = i * LD + e - i * N;
    a.Rmp[mo + e] = smem[RMP * MS + idx];
    a.Rpm[mo + e] = smem[RPM * MS + idx];
    a.Tpp[mo + e] = smem[comp.Tpp * MS + idx];
    a.Tmm[mo + e] = smem[TMM * MS + idx];
  }
  const size_t vo = static_cast<size_t>(pt) * NK;
  for (int e = tid; e < NK; e += nt) {
    a.Jp[vo + e] = V[VJP * VS + e];
    a.Jm[vo + e] = V[VJM * VS + e];
  }
}

size_t smem_floats(int N, int K) {
  const int LD = (N + 3) & ~3;
  const int VS = (N * K + 3) & ~3;
  return static_cast<size_t>(VSM_NMAT) * N * LD +
         static_cast<size_t>(VSM_NVEC) * VS + LD;
}

// The launch plan of (N, K): one block a point (cluster 1) while its
// shared memory fits, else the smallest cluster of 2, 4 or 8 blocks whose
// row bands fit. False for N or K out of range.
struct BandPlan {
  int cluster, band, threads;
  size_t smem;
};

bool band_plan(int N, int K, BandPlan* p) {
  if (N < 1 || N > VSM_MAX_N || K < 1 || K > VSM_MAX_K) return false;
  const size_t one = smem_floats(N, K) * sizeof(float);
  if (one <= VSM_CB_SMEM_BUDGET) {
    *p = BandPlan{1, N, VSM_THREADS, one};
    return true;
  }
  const int c = cluster_band::cluster_size(N, K, false, 2);
  if (c == 0) return false;
  *p = BandPlan{c, cluster_band::band_rows(N, c), VSM_CB_THREADS,
                cluster_band::smem_bytes(N, K, c, false)};
  return true;
}

bool single_block(int N, int K) {
  BandPlan p;
  return band_plan(N, K, &p) && p.cluster == 1;
}

template <int K>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      moment_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.s > 0) moment_kernel<K><<<a.s, VSM_THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of moment_kernel<K> with `smem` dynamic shared bytes that one SM
// holds at once (registers and shared memory), or minus a CUDA error code.
template <int K>
int resident(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      moment_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, moment_kernel<K>, VSM_THREADS, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

extern "C" {

size_t vsm_fused_moment_smem_bytes(int N, int K) {
  return smem_floats(N, K) * sizeof(float);
}

// Threads of a block of the single-block launch (the same at every N, K).
int vsm_fused_moment_threads() { return VSM_THREADS; }

// Blocks of the single-block launch at (N, K) resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a CUDA error
// code (cudaErrorInvalidValue where (N, K) takes a cluster).
int vsm_fused_moment_blocks_per_sm(int N, int K) {
  if (!single_block(N, K)) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = vsm_fused_moment_smem_bytes(N, K);
  return K == 1 ? resident<1>(smem) : resident<2>(smem);
}

const char* vsm_error_string(int code) {
  return cluster_band::error_string(code);
}

// The plan of (N, K): info = {cluster, rows of a band, threads, dynamic
// shared bytes, and what is resident at once: blocks an SM for the single
// block, clusters on the card (cudaOccupancyMaxActiveClusters) for a
// cluster}. Returns a CUDA error code.
int vsm_band_cluster_plan(int N, int K, int* info) {
  BandPlan p;
  if (!band_plan(N, K, &p)) return static_cast<int>(cudaErrorInvalidValue);
  info[0] = p.cluster;
  info[1] = p.band;
  info[2] = p.threads;
  info[3] = static_cast<int>(p.smem);
  if (p.cluster == 1) {
    info[4] = vsm_fused_moment_blocks_per_sm(N, K);
    return info[4] < 0 ? -info[4] : 0;
  }
  cluster_band::Args a = {};
  a.s = 1;
  a.P = 1;
  a.N = N;
  a.cluster = p.cluster;
  a.band = p.band;
  return K == 1
             ? cluster_band::max_clusters<1, false>(a, p.smem, &info[4])
             : cluster_band::max_clusters<2, false>(a, p.smem, &info[4]);
}

// Launches the single-block band kernel on `stream` and returns
// cudaGetLastError() (0 on success); refuses an (N, K) whose plan is a
// cluster. All pointers are device pointers except `sched` (host, ndoubl
// entries).
int vsm_fused_moment_f32(const float* Zpp, const float* Zmp, const float* geom,
                         const float* dvec, const float* w, const float* Em1,
                         const float* dt, const float* jp, const float* jms,
                         const float* ek, float* Rmp, float* Rpm, float* Tpp,
                         float* Tmm, float* Jp, float* Jm, int s, int N,
                         int C, int K, int nz, int ndoubl, const int* sched,
                         int ns_inter, void* stream) {
  if (!single_block(N, K) || C < 1 || s < 0 || nz < 0 || ndoubl < 0 ||
      ndoubl > VSM_MAX_DOUBL || ns_inter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
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
  a.Rmp = Rmp;
  a.Rpm = Rpm;
  a.Tpp = Tpp;
  a.Tmm = Tmm;
  a.Jp = Jp;
  a.Jm = Jm;
  a.s = s;
  a.N = N;
  a.C = C;
  a.nz = nz;
  a.ndoubl = ndoubl;
  a.ns_inter = ns_inter;
  for (int i = 0; i < VSM_MAX_DOUBL; ++i) a.sched[i] = i < ndoubl ? sched[i] : 0;
  const size_t smem = vsm_fused_moment_smem_bytes(N, K);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return K == 1 ? launch<1>(a, smem, st) : launch<2>(a, smem, st);
}

// Launches the cluster band kernel (cluster_band::cluster_kernel<K, false>)
// on `stream` on band_plan's plan for (N, K), which must be a cluster of 2
// or more: 0, a CUDA error code, or VSM_CB_NO_CLUSTER.
int vsm_fused_moment_cluster_f32(
    const float* Zpp, const float* Zmp, const float* geom, const float* dvec,
    const float* w, const float* Em1, const float* dt, const float* jp,
    const float* jms, const float* ek, float* Rmp, float* Rpm, float* Tpp,
    float* Tmm, float* Jp, float* Jm, int s, int N, int C, int K, int nz,
    int ndoubl, const int* sched, int ns_inter, void* stream) {
  BandPlan p;
  if (!band_plan(N, K, &p) || p.cluster < 2 || C < 1 || s < 0 || nz < 0 ||
      ndoubl < 0 || ndoubl > VSM_MAX_DOUBL || ns_inter < 0 ||
      static_cast<long long>(s) * p.cluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cluster_band::Args a = {};
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
  a.Rmp = Rmp;
  a.Rpm = Rpm;
  a.Tpp = Tpp;
  a.Tmm = Tmm;
  a.Jp = Jp;
  a.Jm = Jm;
  a.s = s;
  a.N = N;
  a.C = C;
  a.nz = nz;
  a.P = 1;
  a.ndoubl = ndoubl;
  a.ns_inter = ns_inter;
  a.cluster = p.cluster;
  a.band = p.band;
  for (int i = 0; i < VSM_MAX_DOUBL; ++i) a.sched[i] = i < ndoubl ? sched[i] : 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return K == 1 ? cluster_band::launch<1, false>(a, p.smem, st)
                : cluster_band::launch<2, false>(a, p.smem, st);
}

}  // extern "C"
