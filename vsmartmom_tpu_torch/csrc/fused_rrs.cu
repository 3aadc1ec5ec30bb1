// Block-bichromatic rotational-Raman (RRS) kernel K3 for Hopper (sm_90a):
// one Fourier moment of the coupled two-wavelength adding-doubling solve
// over all layers, for every (Raman shift, spectral point) pair, in two
// launches.
//
// Replaces the TPU kernel vsmartmom_tpu/ops/fused_rrs.py::fused_moment_rrs
// -> _rrs_kernel (elastic assembly from ops/fused_band.py::
// _assemble_elemental, ladder and adding from ops/fused_rt.py::
// _doubling_math / _interaction_math), in its exact-f32 ("highest") mode.
// Each pair is a (2N, 2N) block-lower-triangular problem
//     [[X(l0), 0], [ieX, X(l1)]]     (l0 source, l1 target wavelength)
// whose every operator keeps that form, so a product's (2,1) block is
//     C21 = A21 B11 + A22 B21
// and its diagonal blocks are those of the elastic problem of one grid
// point: X11 of the source point i + shift, X22 of the target point i, the
// same for every shift that uses the point. Only the (2,1) blocks of the
// composite are written out.
//
// Design. Both launches run one program of phases, K1's layer loop (per
// layer the assembly, the doubling ladder on the scene's Newton-Schulz
// schedule and the adding step), built on the host by
// ops/rrs_program.py::build_plan and read from global memory as records:
//   diag_kernel  one block per grid point runs the program as K1 does, on
//                csrc/fp32_tile.cuh's phases, for the point's elastic
//                problem (assembled from the unrolled l1 row tables and the
//                point's own solar sources), and saves to a global store
//                every diagonal value a (2,1) product reads (each once, at
//                its first use: 33 N x LD matrices a layer on the RRS+SIF
//                scene's coarse ie ladder, 171 KB at N = 36);
//   pair_kernel  one block per on-grid pair (off-grid pairs' (2,1) blocks
//                are exactly zero; the wrapper zero-fills them) runs the
//                program on the (2,1) blocks alone: ten N x LD matrices and
//                eight vectors resident, each product one depth-2N job
//                (fp32_tile::phase21) whose diagonal factors A22 (the
//                target's) and B11 (the source's) are copied from the
//                store into a pool of shared-memory slots by cp.async, the
//                next phase's while the current one computes (the plan puts
//                them in slots the current phase does not read; where they
//                do not fit, after it). At N = 36 three blocks of 128
//                threads an SM, 74,448 B each with a 4-slot pool (the
//                phases split to fit it; on an H100 that read faster than
//                two blocks of 192 threads with an 11-slot pool, every
//                phase's copies overlapping the one before); at N = 64 one
//                block of 384 threads, 216,320 B with a 3-slot pool.
// Blocks are laid out target-major, the shifts inner (ops/rrs_program.py::
// pair_plan), so the ~400 blocks in flight share ~7 target points and a
// window of ~65 source points: a layer's store entries of those points,
// ~12 MB at N = 36, stay in the 50 MB L2.
//
// Bound. A pair's (2,1) products are 2 N^3 FMAs each and a point's diagonal
// ones N^3, against a few hundred bytes of row tables per pair and layer:
// FP32 operations bound both launches. The pair kernel also reads its
// staged factors from L2 (2 N x LD floats a product, ~250 KB a pair and
// layer at N = 36).

#include <cuda_runtime.h>

#include <stdint.h>

#include "fp32_tile.cuh"

#define VSM_RRS_MAX_N 64
// The diagonal launch's threads (6 warps, two blocks an SM). The pair
// launch comes in two shapes (pair_kernel<THREADS, BLOCKS>), chosen by
// the host from N: 128 threads three blocks an SM where three blocks' shared
// memory fits an SM with a pool of at least 4 slots (N <= 36), else 384
// threads one block an SM; both <= 168 registers a thread.
#define VSM_RRS_THREADS 192
#define VSM_RRS_NMAT 10
#define VSM_RRS_NVEC 8
#define VSM_RRS_VPOOL 4
#define VSM_RRS_MAX_POOL 22

namespace {

using namespace fp32_tile;

// The record layout of ops/rrs_program.py.
enum {
  F_OP = 0, F_ARG = 1, F_NEXT = 2, F_PREFETCH = 3, F_S0 = 4, F_S1 = 5,
  F_S2 = 6, F_NM = 7, F_M = 8, F_M2 = 11, F_NV = 14, F_V = 15, F_V2 = 17,
  F_NSAVE = 19, F_SAVE = 20, F_NSTAGE = 28, F_STAGE = 29, REC = 40
};
enum { OP_PHASE = 0, OP_ASSEMBLE = 1 };
enum { RIDE_EK = 1, RIDE_VA = 2, RIDE_FLIP = 4 };
enum { RMP = 0, RPM = 1, TPP0 = 2, TMM = 3 };
enum { VJP = 0, VJM = 1, Vjp = 2, Vjm = 3, Va = 4, Vb = 5, Vc = 6, Vek = 7 };

struct DArgs {
  const float* Zpp;    // (C, N, N) elastic phase matrices
  const float* Zmp;
  const float* geom;   // (4, N, N): RG, A, TO, TS
  const float* dvec;   // (N,) D-matrix diagonal (+-1)
  const float* w;      // (nz, C, P, 2) scattering weight / tau at l0, l1
  const float* Em1;    // (nz, P, 2N) [l0; l1] expm1(-dtau/mu_i)
  const float* dt;     // (nz, P, 2) elemental optical depth d0, d1
  const float* src_jp; // (nz, s, N) each grid point's j_sol+
  const float* src_jm; // (nz, s, N) D j_sol-
  const float* src_ek; // (nz, s) beam attenuation per doubling
  const int* table;    // (nrec, REC) the program
  float* mstore;       // (s, n_me, N LD) saved diagonal matrices
  float* vstore;       // (s, n_ve, LD) saved diagonal vectors
  int s, P, N, C, nrec, n_me, n_ve;
};

struct PArgs {
  const float* Zrpp;   // (N, N) Raman phase x wct_j: the (2,1) block
  const float* Zrmp;
  const float* gie;    // (4, N, N): mu_i, mu_j, 1/mu_i, 1/mu_j
  const float* dvec;
  const float* Em1;    // (nz, P, 2N)
  const float* dt;     // (nz, P, 2)
  const float* pref;   // (nz, P) w_shift * fscatt(l0)
  const float* jp;     // (nz, P, 2N) [j_sol+(l0); iej+]
  const float* jms;    // (nz, P, 2N) D [j_sol-(l0); iej-]
  const float* ek;     // (nz, P) beam attenuation per doubling at l0
  const int* table;
  const int* plan;     // (n_on, 3): pair, target point, source point
  const float* mstore;
  const float* vstore;
  float* Rmp;          // (P, N, N) (2,1) blocks of the composite
  float* Rpm;
  float* Tpp;
  float* Tmm;
  float* Jp;           // (P, N)
  float* Jm;
  int n_on, P, N, nrec, n_me, n_ve, pool, outs;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The elementwise passes in front of a phase's jobs (they touch none of the
// phase's operands): ek <- ek^2, va <- jm ek, t <- D t D.
__device__ __forceinline__ void rides(const int* R, const Ctx& x) {
  const int flags = R[F_ARG];
  if (flags & (RIDE_EK | RIDE_VA)) {
    float* ek = fp32_tile_smem + x.ek;
    float* va = vec_slot(x, R[F_S1]);
    const float* jm = vec_slot(x, R[F_S2]);
    for (int e = threadIdx.x; e < x.n; e += blockDim.x) {
      float f = ek[e];
      if (flags & RIDE_EK) {
        f *= f;
        ek[e] = f;
      }
      if (flags & RIDE_VA) va[e] = jm[e] * f;
    }
  }
  if (flags & RIDE_FLIP) {
    const float* d = fp32_tile_smem + x.d;
    float* t = mat_slot(x, R[F_S0]);
    for (int e = threadIdx.x; e < x.n * x.n; e += blockDim.x) {
      const int i = e / x.n;
      const int j = e - i * x.n;
      t[i * x.LD + j] *= d[i] * d[j];
    }
  }
}

// A block's shared memory: matrix slots (resident, then the pool), vector
// slots (resident, then the pool), the D diagonal.
__device__ __forceinline__ void setup(int N, int pool, int vpool,
                                      const float* dvec) {
  const int LD = (N + 3) & ~3;
  float* V = fp32_tile_smem + (VSM_RRS_NMAT + pool) * N * LD;
  float* sd = V + (VSM_RRS_NVEC + vpool) * LD;
  set_ctx(fp32_tile_smem, V, sd, V + Vek * LD, N, 1);
  for (int i = threadIdx.x; i < N; i += blockDim.x) sd[i] = dvec[i];
}

// expm1(x)/x as a 6-term Horner chain (rel. error < 1e-7 for |x| < 0.3).
__device__ __forceinline__ float expm1_ratio_series(float x) {
  return 1.0f + x * (0.5f + x * (1.0f / 6.0f + x * (1.0f / 24.0f + x * (
      1.0f / 120.0f + x * (1.0f / 720.0f)))));
}

__global__ void __launch_bounds__(VSM_RRS_THREADS, 2)
    diag_kernel(const DArgs a) {
  const int N = a.N, C = a.C, P = a.P;
  const int NN = N * N;
  const int pt = blockIdx.x;             // grid point of this block
  setup(N, 0, 0, a.dvec);
  __syncthreads();
  const Ctx x = g_tile_ctx;
  const int LD = x.LD, MS = x.MS;
  const float* sd = fp32_tile_smem + x.d;
  // Vacuum composite: R = 0, T = I, J = 0.
  for (int e = threadIdx.x; e < NN; e += blockDim.x) {
    const int i = e / N;
    const int j = e - i * N;
    const int idx = i * LD + j;
    mat_slot(x, RMP)[idx] = 0.0f;
    mat_slot(x, RPM)[idx] = 0.0f;
    mat_slot(x, TPP0)[idx] = i == j ? 1.0f : 0.0f;
    mat_slot(x, TMM)[idx] = i == j ? 1.0f : 0.0f;
  }
  for (int e = threadIdx.x; e < N; e += blockDim.x) {
    vec_slot(x, VJP)[e] = 0.0f;
    vec_slot(x, VJM)[e] = 0.0f;
  }
  const float* RG = a.geom;
  const float* GA = a.geom + NN;
  const float* TO = a.geom + 2 * NN;
  const float* TS = a.geom + 3 * NN;
  float* ms = a.mstore + static_cast<size_t>(pt) * a.n_me * MS;
  float* vs = a.vstore + static_cast<size_t>(pt) * a.n_ve * LD;

  for (int p = 0; p < a.nrec; ++p) {
    const int* R = a.table + p * REC;
    if (R[F_OP] == OP_ASSEMBLE) {
      // The point's elastic elemental from its l1 row tables (pair pt of
      // shift row 0 carries them): r* = D r-+ (r-+ without doubling), t++,
      // j0+, D j0- (j0-), ek; K1's assembly.
      const int z = R[F_ARG];
      const bool starred = R[F_S2] != 0;
      const size_t zp = static_cast<size_t>(z) * P + pt;
      const size_t zs = static_cast<size_t>(z) * a.s + pt;
      __syncthreads();
      const float* Em1 = a.Em1 + zp * 2 * N + N;
      const float dt = a.dt[zp * 2 + 1];
      float* r = mat_slot(x, R[F_S0]);
      float* t = mat_slot(x, R[F_S1]);
      for (int e = threadIdx.x; e < NN; e += blockDim.x) {
        const int i = e / N;
        const int j = e - i * N;
        float wpp = 0.0f, wmp = 0.0f;
        for (int c = 0; c < C; ++c) {
          const float wc = a.w[((static_cast<size_t>(z) * C + c) * P + pt) *
                               2 + 1];
          wpp = fmaf(wc, a.Zpp[c * NN + e], wpp);
          wmp = fmaf(wc, a.Zmp[c * NN + e], wmp);
        }
        const float em_i = Em1[i], em_j = Em1[j];
        const float Ei = 1.0f + em_i, Ej = 1.0f + em_j;
        const float one_m_EE = -(em_i + em_j + em_i * em_j);
        const int idx = i * LD + j;
        r[idx] = (starred ? sd[i] : 1.0f) * wmp * RG[e] * one_m_EE;
        // Ej expm1(gx) is Em1_i - Em1_j above |gx| = 0.3 (K1's split).
        const float gx = dt * GA[e];
        const float num = fabsf(gx) < 0.3f ? expm1f(gx) * Ej : em_i - em_j;
        t[idx] = wpp * (num * TO[e] + (dt * TS[e]) * Ej) +
                 (i == j ? Ei : 0.0f);
      }
      const float ek = a.src_ek[zs];
      for (int e = threadIdx.x; e < N; e += blockDim.x) {
        vec_slot(x, Vjp)[e] = a.src_jp[zs * N + e];
        vec_slot(x, Vjm)[e] =
            (starred ? 1.0f : sd[e]) * a.src_jm[zs * N + e];
        vec_slot(x, Vek)[e] = ek;
      }
      __syncthreads();
      continue;
    }
    rides(R, x);
    // The values this phase reads first, to the store (their slots are
    // operands of the phase, which no job or ride of it writes).
    for (int q = 0; q < R[F_NSAVE]; ++q) {
      const int code = R[F_SAVE + q];
      const int slot = (code >> 20) & 31;
      const int e = code & 0xFFFFF;
      const bool vec = (code >> 30) & 1;
      const float4* src = reinterpret_cast<const float4*>(
          vec ? vec_slot(x, slot) : mat_slot(x, slot));
      float4* dst = reinterpret_cast<float4*>(
          vec ? vs + static_cast<size_t>(e) * LD
              : ms + static_cast<size_t>(e) * MS);
      const int n4 = (vec ? LD : MS) >> 2;
      for (int c = threadIdx.x; c < n4; c += blockDim.x) dst[c] = src[c];
    }
    phase<1>(R[F_NM], R[F_M], R[F_M + 1], R[F_M + 2], R[F_NV], R[F_V],
             R[F_V + 1]);
  }
}

// Starts the copies of record R's staged operands into their pool slots:
// role A (field bit 29 clear) from the target point's store, role B from
// the source's, 16 bytes a copy, all threads.
__device__ __forceinline__ void stage(const int* R, const Ctx& x,
                                      const float* ms_tgt,
                                      const float* ms_src,
                                      const float* vs_tgt,
                                      const float* vs_src) {
  for (int q = 0; q < R[F_NSTAGE]; ++q) {
    const int code = R[F_STAGE + q];
    const int slot = (code >> 20) & 31;
    const size_t e = code & 0xFFFFF;
    const bool src = (code >> 29) & 1;
    float* dst;
    const float* from;
    int n4;
    if ((code >> 30) & 1) {
      dst = vec_slot(x, slot);
      from = (src ? vs_src : vs_tgt) + e * x.LD;
      n4 = x.LD >> 2;
    } else {
      dst = mat_slot(x, slot);
      from = (src ? ms_src : ms_tgt) + e * x.MS;
      n4 = x.MS >> 2;
    }
    for (int c = threadIdx.x; c < n4; c += blockDim.x)
      cp_async16(dst + 4 * c, from + 4 * c);
  }
}

template <int THREADS, int BLOCKS>
__global__ void __launch_bounds__(THREADS, BLOCKS)
    pair_kernel(const PArgs a) {
  const int N = a.N, P = a.P;
  const int NN = N * N;
  const int pair = a.plan[3 * blockIdx.x];
  const int tgt = a.plan[3 * blockIdx.x + 1];
  const int src = a.plan[3 * blockIdx.x + 2];
  setup(N, a.pool, VSM_RRS_VPOOL, a.dvec);
  __syncthreads();
  const Ctx x = g_tile_ctx;
  const int LD = x.LD, MS = x.MS;
  const float* sd = fp32_tile_smem + x.d;
  // Vacuum composite: every (2,1) block is zero.
  for (int e = threadIdx.x; e < 4 * MS; e += blockDim.x)
    fp32_tile_smem[x.mat + e] = 0.0f;
  for (int e = threadIdx.x; e < 2 * LD; e += blockDim.x)
    fp32_tile_smem[x.vec + e] = 0.0f;
  const float* ms_t = a.mstore + static_cast<size_t>(tgt) * a.n_me * MS;
  const float* ms_s = a.mstore + static_cast<size_t>(src) * a.n_me * MS;
  const float* vs_t = a.vstore + static_cast<size_t>(tgt) * a.n_ve * LD;
  const float* vs_s = a.vstore + static_cast<size_t>(src) * a.n_ve * LD;
  const float* MUI = a.gie;
  const float* MUJ = a.gie + NN;
  const float* IMI = a.gie + 2 * NN;
  const float* IMJ = a.gie + 3 * NN;

  // The first phase's operands.
  int first = 0;
  while (first < a.nrec && a.table[first * REC + F_OP] != OP_PHASE) ++first;
  if (first < a.nrec) stage(a.table + first * REC, x, ms_t, ms_s, vs_t, vs_s);
  cp_async_wait_all();
  __syncthreads();

  for (int p = 0; p < a.nrec; ++p) {
    const int* R = a.table + p * REC;
    if (R[F_OP] == OP_ASSEMBLE) {
      // The ie (2,1) elemental (rows l1, columns l0): r* = D r-+ (r-+
      // without doubling), t++, the ie sources, ek(l0).
      const int z = R[F_ARG];
      const bool starred = R[F_S2] != 0;
      const size_t zp = static_cast<size_t>(z) * P + pair;
      const float* E0 = a.Em1 + zp * 2 * N;
      const float* E1 = E0 + N;
      const float dt0 = a.dt[zp * 2];
      const float dt1 = a.dt[zp * 2 + 1];
      const float pref = a.pref[zp];
      float* r = mat_slot(x, R[F_S0]);
      float* t = mat_slot(x, R[F_S1]);
      for (int e = threadIdx.x; e < NN; e += blockDim.x) {
        const int i = e / N;
        const int j = e - i * N;
        const float e1i = E1[i], e0j = E0[j];
        const float one_m_EE = -(e1i + e0j + e1i * e0j);
        // 1/(mu_i/mu_j + d1/d0) = mu_j d0 / (mu_i d0 + mu_j d1)
        const float denom = MUI[e] * dt0 + MUJ[e] * dt1;
        const float fac_r = (MUJ[e] * dt0) / (denom > 0.0f ? denom : 1.0f);
        r[i * LD + j] = (starred ? sd[i] : 1.0f) * a.Zrmp[e] *
                        (pref * fac_r * one_m_EE);
        // (d0/mu_i) E0_j expm1(x)/x with x = d0/mu_j - d1/mu_i; above
        // |x| = 0.3, E0_j expm1(x) = Em1_1_i - Em1_0_j.
        const float gx = dt0 * IMJ[e] - dt1 * IMI[e];
        const float ratio = fabsf(gx) < 0.3f
                                ? (1.0f + e0j) * expm1_ratio_series(gx)
                                : (e1i - e0j) / gx;
        t[i * LD + j] = a.Zrpp[e] * (pref * (dt0 * IMI[e]) * ratio);
      }
      const float ek = a.ek[zp];
      for (int e = threadIdx.x; e < N; e += blockDim.x) {
        vec_slot(x, Vjp)[e] = a.jp[zp * 2 * N + N + e];
        vec_slot(x, Vjm)[e] =
            (starred ? 1.0f : sd[e]) * a.jms[zp * 2 * N + N + e];
        vec_slot(x, Vek)[e] = ek;
      }
      __syncthreads();
      continue;
    }
    rides(R, x);
    const int next = R[F_NEXT];
    const int* Rn = next >= 0 ? a.table + next * REC : nullptr;
    const bool prefetch = Rn != nullptr && Rn[F_PREFETCH] != 0;
    if (prefetch) stage(Rn, x, ms_t, ms_s, vs_t, vs_s);
    phase21<1>(R[F_NM], R[F_M], R[F_M + 1], R[F_M + 2], R[F_M2],
               R[F_M2 + 1], R[F_M2 + 2], R[F_NV], R[F_V], R[F_V + 1],
               R[F_V2], R[F_V2 + 1]);
    cp_async_wait_all();
    __syncthreads();
    if (Rn != nullptr && !prefetch) {
      stage(Rn, x, ms_t, ms_s, vs_t, vs_s);
      cp_async_wait_all();
      __syncthreads();
    }
  }

  // ---- the (2,1) blocks out ----
  const size_t mo = static_cast<size_t>(pair) * NN;
  float* outs[4] = {a.Rmp, a.Rpm, a.Tpp, a.Tmm};
  for (int k = 0; k < 4; ++k) {
    const float* m = mat_slot(x, (a.outs >> (5 * k)) & 31);
    for (int e = threadIdx.x; e < NN; e += blockDim.x) {
      const int i = e / N;
      outs[k][mo + e] = m[i * LD + e - i * N];
    }
  }
  const float* jp = vec_slot(x, (a.outs >> 20) & 31);
  const float* jm = vec_slot(x, (a.outs >> 25) & 31);
  const size_t vo = static_cast<size_t>(pair) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    a.Jp[vo + i] = jp[i];
    a.Jm[vo + i] = jm[i];
  }
}

size_t smem_bytes(int which, int N, int pool) {
  const int LD = (N + 3) & ~3;
  const size_t mats = VSM_RRS_NMAT + (which ? pool : 0);
  const size_t vecs = VSM_RRS_NVEC + (which ? VSM_RRS_VPOOL : 0);
  return (mats * N * LD + vecs * LD + LD) * sizeof(float);
}

template <typename KernelArgs>
cudaError_t opt_in(void (*kernel)(KernelArgs), size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename KernelArgs>
int resident(void (*kernel)(KernelArgs), int threads, size_t smem) {
  cudaError_t err = opt_in(kernel, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

bool bad_shape(int N, int pool) {
  return N < 1 || N > VSM_RRS_MAX_N || pool < 2 || pool > VSM_RRS_MAX_POOL;
}

// The pair kernel of `threads` threads (128 or 384), else null.
void (*pair_kernel_of(int threads))(PArgs) {
  return threads == 128 ? pair_kernel<128, 3>
                        : (threads == 384 ? pair_kernel<384, 1> : nullptr);
}

}  // namespace

extern "C" {

// Threads of a block of the diagonal launch.
int vsm_rrs_threads() { return VSM_RRS_THREADS; }

// Dynamic shared memory of the diagonal (which = 0) or the pair (1) launch.
size_t vsm_rrs_smem_bytes(int which, int N, int pool) {
  return smem_bytes(which, N, pool);
}

// Blocks of the diagonal kernel (which = 0) or of the pair kernel of
// `threads` threads (1) resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a CUDA error
// code.
int vsm_rrs_blocks_per_sm(int which, int N, int pool, int threads) {
  if (bad_shape(N, pool) || (which && !pair_kernel_of(threads)))
    return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(which, N, pool);
  return which ? resident(pair_kernel_of(threads), threads, smem)
               : resident(diag_kernel, VSM_RRS_THREADS, smem);
}

const char* vsm_rrs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The diagonal launch on `stream`, one block per grid point; returns
// cudaGetLastError() (0 on success). All pointers are device pointers.
int vsm_rrs_diag_f32(const float* Zpp, const float* Zmp, const float* geom,
                     const float* dvec, const float* w, const float* Em1,
                     const float* dt, const float* src_jp,
                     const float* src_jm, const float* src_ek,
                     const int* table, float* mstore, float* vstore, int s,
                     int P, int N, int C, int nrec, int n_me, int n_ve,
                     void* stream) {
  if (bad_shape(N, 2) || C < 1 || s < 0 || P < s || nrec < 0 || n_me < 0 ||
      n_ve < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DArgs a;
  a.Zpp = Zpp;
  a.Zmp = Zmp;
  a.geom = geom;
  a.dvec = dvec;
  a.w = w;
  a.Em1 = Em1;
  a.dt = dt;
  a.src_jp = src_jp;
  a.src_jm = src_jm;
  a.src_ek = src_ek;
  a.table = table;
  a.mstore = mstore;
  a.vstore = vstore;
  a.s = s;
  a.P = P;
  a.N = N;
  a.C = C;
  a.nrec = nrec;
  a.n_me = n_me;
  a.n_ve = n_ve;
  const size_t smem = smem_bytes(0, N, 0);
  cudaError_t err = opt_in(diag_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s > 0)
    diag_kernel<<<s, VSM_RRS_THREADS, smem,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The pair launch on `stream`, one block of `threads` (128 or 384) per row
// of `plan` (n_on on-grid pairs); `outs` packs the final slots of R-+,
// R+-, T++, T-- (matrices) and J+, J- (vectors), 5 bits each. Returns
// cudaGetLastError().
int vsm_rrs_pair_f32(const float* Zrpp, const float* Zrmp, const float* gie,
                     const float* dvec, const float* Em1, const float* dt,
                     const float* pref, const float* jp, const float* jms,
                     const float* ek, const int* table, const int* plan,
                     const float* mstore, const float* vstore, float* Rmp,
                     float* Rpm, float* Tpp, float* Tmm, float* Jp,
                     float* Jm, int n_on, int P, int N, int nrec, int n_me,
                     int n_ve, int pool, int outs, int threads,
                     void* stream) {
  void (*kernel)(PArgs) = pair_kernel_of(threads);
  if (bad_shape(N, pool) || !kernel || n_on < 0 || P < n_on || nrec < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PArgs a;
  a.Zrpp = Zrpp;
  a.Zrmp = Zrmp;
  a.gie = gie;
  a.dvec = dvec;
  a.Em1 = Em1;
  a.dt = dt;
  a.pref = pref;
  a.jp = jp;
  a.jms = jms;
  a.ek = ek;
  a.table = table;
  a.plan = plan;
  a.mstore = mstore;
  a.vstore = vstore;
  a.Rmp = Rmp;
  a.Rpm = Rpm;
  a.Tpp = Tpp;
  a.Tmm = Tmm;
  a.Jp = Jp;
  a.Jm = Jm;
  a.n_on = n_on;
  a.P = P;
  a.N = N;
  a.nrec = nrec;
  a.n_me = n_me;
  a.n_ve = n_ve;
  a.pool = pool;
  a.outs = outs;
  const size_t smem = smem_bytes(1, N, pool);
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_on > 0)
    kernel<<<n_on, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
