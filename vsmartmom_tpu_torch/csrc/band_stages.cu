// The band-body probe's six stages on Hopper (sm_90a). Replaces the Pallas
// kernel of scripts/probe_band_bisect.py:113 (`kernel` :30), which bisected
// the whole-moment band kernel's body over a sequential z grid with a
// scratch carry:
//
//   acc   the carry alone: sum of tau broadcast over (b, N, N);
//   elem  the elemental stand-in r-+ (and t++): sum of r-+;
//   src   + the source rows (j0 = r-+'s first column, ek = tau): sum of r-+;
//   pack  the 2-point block-diagonal operators (Np = 2N): carry = r packed;
//   dbl   + the doubling ladder on them (_doubling_math, the given NS
//         schedule, (1, 1, 2, 2) in the probe): carry = r;
//   full  + the adding step onto the carry (_interaction_math, ns_inter 3 in
//         the probe) with the probe's own composite: R-+ = R+- = the carry,
//         T++ = T-- = carry * 0 + 1, J0+ = J0- = the carry's first column,
//         and the layer (r, r, t, t, jp, jm): carry = the new R-+.
//
// The z grid becomes a loop inside the block over the nz layers, with the
// carry in shared memory. The stages that sum (acc, elem, src) run in one
// block, since their carry is one number over all points (carry * 0 + sum,
// as the probe writes it); the packed stages run one block per packed pair
// of points, whose carry is its own (Np, Np) block. The ladder and the adding
// step are K5's and K4's device code (csrc/rt_device.cuh), the adding step
// with D = I (the probe passes r for both reflections and t for both
// transmissions).
//
// Bound. At the probe's shapes (nz = 4, S = 32, N = 12) a launch does at
// most ~3 MFLOP and moves ~40 KB, far below what the card can do in a
// launch's time; it is latency-bound instead: the summing stages run in one
// block, and the ladder and the adding step run their small products one
// after another, with barriers between, in 16 blocks. The packed stages take
// Np <= 64, as K5 does.

#include <cuda_runtime.h>

#include "rt_device.cuh"

namespace {

enum { S_ACC = 0, S_ELEM, S_SRC, S_PACK, S_DBL, S_FULL, S_COUNT };
constexpr int kPack = 2;
constexpr int kMaxNp = 64;
constexpr int kMaxDoubl = 32;

struct BArgs {
  const float* tau;  // (nz, 1, S)
  const float* Em1;  // (nz, S, N)
  const float* aux;  // (8, N): row 0 the nodes mu, row 1 the weights wct
  float* out;        // (S / 2, 2N, 2N)
  int nz, S, N, stage, ndoubl, ns_inter;
  int sched[kMaxDoubl];
};

// The probe's elemental stand-ins for one point (em = its Em1 row).
__device__ __forceinline__ float r_elem(const float* mu, const float* wct,
                                        const float* em, int i, int j) {
  const float r_geom = (mu[j] / (mu[i] + mu[j])) * wct[j];
  const float one_m_EE = -(em[i] + em[j] + em[i] * em[j]);
  return r_geom * one_m_EE;
}

__device__ __forceinline__ float t_elem(const float* mu, const float* wct,
                                        const float* em, float tau, int i,
                                        int j) {
  const float mi = mu[i];
  const float mj = mu[j];
  const bool same = fabsf(mi - mj) <= 1e-9f * fmaxf(mi, mj);
  const float delta = same ? 1.0f : mi - mj;
  const float series = tau / 16.0f * (delta / (mi * mj));
  const float ratio = (expf(series) - 1.0f) / delta;
  const float t_off = mj * wct[j] * (1.0f + em[j]) * ratio;
  const float beer = (1.0f + em[i]) * (i == j ? 1.0f : 0.0f);
  return same ? t_off + beer : t_off;
}

// Sum over the block, the same value in every thread.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) t += red[w];
  __syncthreads();
  return t;
}

// acc, elem, src: one block; out = the last layer's sum everywhere.
__global__ void __launch_bounds__(256) sum_stage_kernel(const BArgs a) {
  __shared__ float red[32];
  __shared__ float mw[2 * kMaxNp];
  const int N = a.N, S = a.S, NN = N * N;
  for (int i = threadIdx.x; i < 2 * N; i += blockDim.x) mw[i] = a.aux[i];
  __syncthreads();
  const float* mu = mw;
  const float* wct = mw + N;
  float carry = 0.0f;
  for (int z = 0; z < a.nz; ++z) {
    float part = 0.0f;
    for (int e = threadIdx.x; e < S * NN; e += blockDim.x) {
      const int b = e / NN;
      const int i = (e / N) % N;
      const float* em = a.Em1 + (static_cast<size_t>(z) * S + b) * N;
      part += a.stage == S_ACC ? a.tau[z * S + b] + 0.0f * em[i]
                               : r_elem(mu, wct, em, i, e % N);
    }
    carry = carry * 0.0f + block_sum(part, red);
  }
  const int total = (S / kPack) * (kPack * N) * (kPack * N);
  for (int e = threadIdx.x; e < total; e += blockDim.x) a.out[e] = carry;
}

// pack, dbl, full: one block per packed pair of points.
__global__ void __launch_bounds__(256) packed_stage_kernel(const BArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, S = a.S;
  const int Np = kPack * N;
  const int LD = (Np + 3) & ~3;
  const int MS = Np * LD;
  const int VS = (Np + 3) & ~3;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int p = blockIdx.x;

  Comp c;
  c.Rmp = smem;                          // the carry
  c.Rpm = smem + MS;
  c.Tpp = smem + 2 * MS;
  c.Tmm = smem + 3 * MS;
  Work w = carve(smem, 4, MS, VS);
  c.Jp = w.ek + VS;
  c.Jm = c.Jp + VS;
  float* sd = c.Jm + VS;                 // D = I
  float* mu = sd + LD;
  float* wct = mu + N;

  for (int e = tid; e < MS; e += nt) c.Rmp[e] = 0.0f;
  for (int i = tid; i < Np; i += nt) sd[i] = 1.0f;
  for (int i = tid; i < N; i += nt) {
    mu[i] = a.aux[i];
    wct[i] = a.aux[N + i];
  }
  __syncthreads();

  for (int z = 0; z < a.nz; ++z) {
    for (int e = tid; e < Np * Np; e += nt) {
      const int I = e / Np;
      const int J = e - I * Np;
      float r = 0.0f, t = 0.0f;
      if (I / N == J / N) {
        const int b = kPack * p + I / N;
        const float* em = a.Em1 + (static_cast<size_t>(z) * S + b) * N;
        r = r_elem(mu, wct, em, I % N, J % N);
        t = t_elem(mu, wct, em, a.tau[z * S + b], I % N, J % N);
      }
      w.r[I * LD + J] = r;
      w.t[I * LD + J] = t;
    }
    for (int I = tid; I < Np; I += nt) {
      const int b = kPack * p + I / N;
      const float* em = a.Em1 + (static_cast<size_t>(z) * S + b) * N;
      const float j0 = r_elem(mu, wct, em, I % N, 0);
      w.jp[I] = j0;
      w.jm[I] = j0;
      w.ek[I] = a.tau[z * S + b];
    }
    __syncthreads();
    if (a.stage != S_PACK) ladder(w, a.ndoubl, a.sched, sd, Np, LD, 1);
    if (a.stage == S_FULL) {
      for (int e = tid; e < Np * Np; e += nt) {
        const int idx = (e / Np) * LD + e % Np;
        const float carry = c.Rmp[idx];
        c.Rpm[idx] = carry;
        c.Tpp[idx] = carry * 0.0f + 1.0f;
        c.Tmm[idx] = carry * 0.0f + 1.0f;
      }
      for (int I = tid; I < Np; I += nt) {
        c.Jp[I] = c.Rmp[I * LD];
        c.Jm[I] = c.Rmp[I * LD];
      }
      __syncthreads();
      adding(c, w, sd, a.ns_inter, Np, LD, 1);
    } else {
      for (int e = tid; e < Np * Np; e += nt) {
        const int idx = (e / Np) * LD + e % Np;
        c.Rmp[idx] = w.r[idx];
      }
      __syncthreads();
    }
  }
  store_mat(a.out + static_cast<size_t>(p) * Np * Np, c.Rmp, Np, LD);
}

}  // namespace

extern "C" {

const char* vsm_band_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One stage (0 acc, 1 elem, 2 src, 3 pack, 4 dbl, 5 full) on `stream`: tau
// (nz, 1, S), Em1 (nz, S, N), aux (8, N) and out (S / 2, 2N, 2N) device
// pointers, `sched` a host array of ndoubl NS counts; returns
// cudaGetLastError() (0 on success).
int vsm_band_stage_f32(const float* tau, const float* Em1, const float* aux,
                       float* out, int nz, int S, int N, int stage,
                       int ndoubl, const int* sched, int ns_inter,
                       void* stream) {
  if (nz < 1 || S < kPack || S % kPack != 0 || N < 1 ||
      kPack * N > kMaxNp || stage < 0 || stage >= S_COUNT || ndoubl < 0 ||
      ndoubl > kMaxDoubl || ns_inter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BArgs a;
  a.tau = tau;
  a.Em1 = Em1;
  a.aux = aux;
  a.out = out;
  a.nz = nz;
  a.S = S;
  a.N = N;
  a.stage = stage;
  a.ndoubl = ndoubl;
  a.ns_inter = ns_inter;
  for (int i = 0; i < kMaxDoubl; ++i) a.sched[i] = i < ndoubl ? sched[i] : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stage < S_PACK) {
    sum_stage_kernel<<<1, 256, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int Np = kPack * N;
  const size_t smem = smem_bytes(10, 8, Np, 1) + 2 * N * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      packed_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_stage_kernel<<<S / kPack, threads_for(Np), smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
