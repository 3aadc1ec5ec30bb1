// The band-body probe's six stages on Hopper (sm_90a). Replaces the Pallas
// kernel of scripts/probe_band_bisect.py:113 (`kernel` :26), which bisected
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
// Bound. At the probe's shapes (nz = 4, S = 32, N = 12) the FP32 operations
// of the ladder and the adding step bound a full call at 0.0013 ms on the
// card (67 TFLOP/s), 0.0003 ms at one layer, and its ~50 KB of bytes at
// less: it is latency-bound. A layer's ladder is 5 + 5 + 7 + 7 = 24
// dependent product phases at schedule (1, 1, 2, 2) (1 + 2k + 2 a step of k
// NS iterations), each closed by a block barrier; full's adding step is
// 1 + 2 ns_inter + 4 = 11 more a layer and links layer z to layer z - 1
// through the carry. So a call's chain is 24 phases (dbl), or 24 and then
// 11 nz (full); a summing stage's is one pass over the layers.
//
// Design. Only full's adding step reads the carry: each layer's elemental
// operators, sources and ladder depend on that layer's inputs alone, and a
// summing stage's carry * 0 + sum only passes a non-finite sum on.
//   * layer_kernel (pack, dbl, full): one block per (packed pair, layer),
//     S / 2 x nz blocks at once. A block stages the pair's Em1 rows, taus,
//     mu and wct in shared memory, computes each of the pair's N x N
//     elemental entries once (each product and sum rounded on its own, as
//     the plain version's elementwise ops round: pack is the plain
//     version's bits), places them in the (Np, Np) packed operators, zero
//     off the point's block, and runs the doubling ladder
//     (fp32_tile::ladder<1>, D = I: csrc/fp32_tile.cuh's ladder and
//     product tiles, K1's, K4's and K5's). Every layer's body runs, as on
//     the TPU's grid: the last layer's r goes to the output (pack, dbl),
//     every earlier one to the scratch; full stores each layer's r, t, jp
//     and jm there.
//   * chain_kernel (full only, a second CUDA launch, vsm_band_chain_f32):
//     one block per pair walks the nz adding steps (fp32_tile::adding<1>,
//     D = I, on the layer (r, r, t, t, jp, jm) the probe passes), the
//     composite set from the carry in Comp's Rmp and Rpm slots; layer
//     z + 1's record comes in by cp.async while layer z's adding runs.
//   * sum_kernel (acc, elem, src): one block of 1024 threads per output
//     pair. Every block stages the Em1 rows and taus of up to 32 layers at
//     once, sums every layer's entries with no barrier between layers (f64
//     partials, one warp shuffle tree a layer, warps added in order: no
//     atomics, the same bits in every block and run), folds carry * 0 + sum
//     layer after layer, so an earlier non-finite sum reaches the output,
//     and writes its own (Np, Np) slice.
// The tiles are K1's (4 x 8, 4 x 4 in one-product phases): at Np = 24 a
// three-product phase fills 54 lanes. Tiles of 1 or 2 rows picked at run
// time in the shared phase took 21-25% off P7 but cost K1 1-2.5% where
// they were not taken (PERF.md), so the probe runs K1's.
// The packed width stays 2N: the plain version's products meet the exact
// zeros off a point's block, and an inf there makes NaN, which the kernel
// must give where the plain version gives it. Np <= 64 (32 nodes a point).

#include <cuda_runtime.h>

#include "fp32_tile.cuh"

#define VSM_BAND_MAX_NP 64
#define VSM_BAND_MAX_DOUBL 32
// The layer and chain kernels' threads at most.
#define VSM_BAND_MAX_THREADS 256
// The sum kernel: threads, floats of staged Em1 and tau a pass, layers a
// pass at most.
#define VSM_SUM_THREADS 1024
#define VSM_SUM_STAGE 8192
#define VSM_SUM_LAYERS 32

namespace {

enum { S_ACC = 0, S_ELEM, S_SRC, S_PACK, S_DBL, S_FULL, S_COUNT };
constexpr int kPack = 2;

struct BArgs {
  const float* tau;  // (nz, 1, S)
  const float* Em1;  // (nz, S, N)
  const float* aux;  // (8, N): row 0 the nodes mu, row 1 the weights wct
  float* out;        // (S / 2, 2N, 2N)
  float* scratch;    // (nz, S / 2) records of r, t (Np x LD), jp, jm (VS)
  int nz, S, N, stage, ndoubl, ns_inter;
  int sched[VSM_BAND_MAX_DOUBL];
};

// Padded row stride, matrix and vector slot sizes at packed width Np.
__host__ __device__ __forceinline__ int ld_of(int Np) { return (Np + 3) & ~3; }

__host__ __device__ __forceinline__ int record_floats(int Np) {
  return 2 * Np * ld_of(Np) + 2 * ld_of(Np);
}

// The probe's elemental stand-ins for node pair (i, j) of one point (em its
// Em1 row), every operation rounded on its own as the plain version's.
__device__ __forceinline__ float r_elem(const float* mu, const float* wct,
                                        const float* em, int i, int j) {
  const float r_geom =
      __fmul_rn(__fdiv_rn(mu[j], __fadd_rn(mu[i], mu[j])), wct[j]);
  const float ee = __fadd_rn(__fadd_rn(em[i], em[j]), __fmul_rn(em[i], em[j]));
  return __fmul_rn(r_geom, -ee);
}

__device__ __forceinline__ float t_elem(const float* mu, const float* wct,
                                        const float* em, float tau, int i,
                                        int j) {
  const float mi = mu[i];
  const float mj = mu[j];
  const bool same = fabsf(__fsub_rn(mi, mj)) <= __fmul_rn(1e-9f, fmaxf(mi, mj));
  const float delta = same ? 1.0f : __fsub_rn(mi, mj);
  const float series =
      __fmul_rn(__fdiv_rn(tau, 16.0f), __fdiv_rn(delta, __fmul_rn(mi, mj)));
  const float ratio = __fdiv_rn(__fsub_rn(expf(series), 1.0f), delta);
  const float t_off = __fmul_rn(
      __fmul_rn(__fmul_rn(mj, wct[j]), __fadd_rn(1.0f, em[j])), ratio);
  const float beer = __fmul_rn(__fadd_rn(1.0f, em[i]), i == j ? 1.0f : 0.0f);
  return same ? __fadd_rn(t_off, beer) : t_off;
}

__device__ __forceinline__ void copy4(float* dst, const float* src, int n) {
  for (int e = 4 * threadIdx.x; e < n; e += 4 * blockDim.x)
    fp32_tile::st4(dst + e, fp32_tile::ld4(src + e));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// An (Np, Np) slot (row stride LD) to an unpadded (Np, Np) output.
__device__ __forceinline__ void store_mat(float* dst, const float* src,
                                          int Np, int LD) {
  for (int e = threadIdx.x; e < Np * Np; e += blockDim.x) {
    const int i = e / Np;
    dst[e] = src[i * LD + e - i * Np];
  }
}

// Shared memory of the layer kernel (floats): six matrix slots (r, t, four
// temporaries), six vector slots (jp, jm, three temporaries, ek), the D
// diagonal, the pair's Em1 rows (2N), taus (4) and mu, wct (2N).
__host__ __device__ __forceinline__ int layer_smem_floats(int Np) {
  const int LD = ld_of(Np);
  return 6 * Np * LD + 6 * LD + LD + 2 * Np + 4;
}

// Shared memory of the chain kernel (floats): twelve matrix slots (the
// composite's four, two layers' r and t, four temporaries), nine vector
// slots (J+, J-, two layers' jp and jm, three temporaries), the D diagonal.
__host__ __device__ __forceinline__ int chain_smem_floats(int Np) {
  const int LD = ld_of(Np);
  return 12 * Np * LD + 9 * LD + LD;
}

// Threads of the layer and chain kernels: every lane of the widest phase
// (three products in fp32_tile's 4 x 8 tiles and two vector products) at
// once, in whole warps, at most VSM_BAND_MAX_THREADS.
__host__ __device__ __forceinline__ int tile_threads(int Np) {
  const int cg = (Np + 3) / 4;
  const int lanes = 3 * cg * ((cg + 1) / 2) + 2 * Np;
  const int threads = 32 * ((lanes + 31) / 32);
  return threads < VSM_BAND_MAX_THREADS ? threads : VSM_BAND_MAX_THREADS;
}

// pack, dbl, full: block (p, z) builds layer z's packed operators of pair
// p and, but for pack, runs the ladder on them.
__global__ void __launch_bounds__(VSM_BAND_MAX_THREADS)
    layer_kernel(const BArgs a) {
  float* smem = fp32_tile::fp32_tile_smem;
  const int N = a.N, S = a.S;
  const int Np = kPack * N;
  const int LD = ld_of(Np);
  const int MS = Np * LD;
  const int p = blockIdx.x;
  const int z = blockIdx.y;
  // Matrix slots r 0, t 1, temporaries 2-5; vector slots jp 0, jm 1,
  // temporaries 2-4, ek 5.
  float* V = smem + 6 * MS;
  float* ek = V + 5 * LD;
  float* d = ek + LD;
  float* em = d + LD;       // (2, N): the pair's Em1 rows
  float* tp = em + Np;      // the pair's taus
  float* mu = tp + 4;
  float* wct = mu + N;
  fp32_tile::set_ctx(smem, V, d, ek, Np, 1);
  const size_t row = static_cast<size_t>(z) * S + kPack * p;
  for (int i = threadIdx.x; i < Np; i += blockDim.x)
    em[i] = a.Em1[row * N + i];
  for (int i = threadIdx.x; i < LD; i += blockDim.x) d[i] = 1.0f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    mu[i] = a.aux[i];
    wct[i] = a.aux[N + i];
  }
  if (threadIdx.x < kPack) tp[threadIdx.x] = a.tau[row + threadIdx.x];
  __syncthreads();
  float* r = smem;
  float* t = smem + MS;
  for (int e = threadIdx.x; e < Np * Np; e += blockDim.x) {
    const int I = e / Np;
    const int J = e - I * Np;
    const int q = I / N;
    float rv = 0.0f, tv = 0.0f;
    if (q == J / N) {
      rv = r_elem(mu, wct, em + q * N, I - q * N, J - q * N);
      tv = t_elem(mu, wct, em + q * N, tp[q], I - q * N, J - q * N);
    }
    r[I * LD + J] = rv;
    t[I * LD + J] = tv;
  }
  __syncthreads();
  // j0 = the point's r-+ column 0, ek = its tau; jp = jm = j0.
  for (int I = threadIdx.x; I < Np; I += blockDim.x) {
    const float j0 = r[I * LD + (I / N) * N];
    V[I] = j0;
    V[LD + I] = j0;
    ek[I] = tp[I / N];
  }
  __syncthreads();
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
  if (a.stage != S_PACK)
    fp32_tile::ladder<1>(L, a.ndoubl, a.sched, false);
  const int bp = S / kPack;
  float* rec = a.scratch +
               (static_cast<size_t>(z) * bp + p) * record_floats(Np);
  if (a.stage == S_FULL) {
    copy4(rec, r, MS);
    copy4(rec + MS, smem + L.t * MS, MS);
    copy4(rec + 2 * MS, V + L.jp * LD, LD);
    copy4(rec + 2 * MS + LD, V + L.jm * LD, LD);
  } else if (z == a.nz - 1) {
    store_mat(a.out + static_cast<size_t>(p) * Np * Np, r, Np, LD);
  } else {
    copy4(rec, r, MS);
  }
}

// full: block p walks pair p's nz adding steps from the scratch records.
__global__ void __launch_bounds__(VSM_BAND_MAX_THREADS)
    chain_kernel(const BArgs a) {
  float* smem = fp32_tile::fp32_tile_smem;
  const int Np = kPack * a.N;
  const int LD = ld_of(Np);
  const int MS = Np * LD;
  const int bp = a.S / kPack;
  const int rec = record_floats(Np);
  const int p = blockIdx.x;
  // Matrix slots: composite R-+ 0, R+- 1, T++ 2, T-- 3; layer buffers
  // (r, t) 4-5 and 6-7; temporaries 8-11. Vector slots: J+ 0, J- 1; layer
  // buffers (jp, jm) 2-3 and 4-5; temporaries 6-8.
  enum { RMP = 0, RPM, TPP, TMM, LAYER = 4, TMP = 8 };
  enum { VJP = 0, VJM, VLAYER, VA = 6, VB, VC };
  float* V = smem + 12 * MS;
  float* d = V + 9 * LD;
  fp32_tile::set_ctx(smem, V, d, d, Np, 1);
  float* Rmp = smem + RMP * MS;
  for (int e = threadIdx.x; e < MS; e += blockDim.x) Rmp[e] = 0.0f;
  for (int i = threadIdx.x; i < LD; i += blockDim.x) d[i] = 1.0f;
  auto fetch = [&](int z, int b) {
    const float* src =
        a.scratch + (static_cast<size_t>(z) * bp + p) * rec;
    float* m = smem + (LAYER + 2 * b) * MS;
    float* v = V + (VLAYER + 2 * b) * LD;
    for (int e = 4 * threadIdx.x; e < 2 * MS; e += 4 * blockDim.x)
      cp_async16(m + e, src + e);
    for (int e = 4 * threadIdx.x; e < 2 * LD; e += 4 * blockDim.x)
      cp_async16(v + e, src + 2 * MS + e);
  };
  fetch(0, 0);
  for (int z = 0; z < a.nz; ++z) {
    const int b = z & 1;
    cp_async_wait_all();
    __syncthreads();
    if (z + 1 < a.nz) fetch(z + 1, b ^ 1);
    // The probe's composite from the carry.
    float* Rpm = smem + RPM * MS;
    float* Tpp = smem + TPP * MS;
    float* Tmm = smem + TMM * MS;
    for (int e = threadIdx.x; e < Np * Np; e += blockDim.x) {
      const int idx = (e / Np) * LD + e % Np;
      const float carry = Rmp[idx];
      const float one = carry * 0.0f + 1.0f;
      Rpm[idx] = carry;
      Tpp[idx] = one;
      Tmm[idx] = one;
    }
    for (int I = threadIdx.x; I < Np; I += blockDim.x) {
      V[VJP * LD + I] = Rmp[I * LD];
      V[VJM * LD + I] = Rmp[I * LD];
    }
    __syncthreads();
    fp32_tile::Comp c;
    c.Rmp = RMP;
    c.Rpm = RPM;
    c.Tpp = TPP;
    c.Tmm = TMM;
    c.Jp = VJP;
    c.Jm = VJM;
    fp32_tile::Ladder L;
    L.r = LAYER + 2 * b;
    L.t = LAYER + 2 * b + 1;
    L.T[0] = TMP;
    L.T[1] = TMP + 1;
    L.T[2] = TMP + 2;
    L.T[3] = TMP + 3;
    L.jp = VLAYER + 2 * b;
    L.jm = VLAYER + 2 * b + 1;
    L.va = VA;
    L.vb = VB;
    L.vc = VC;
    fp32_tile::adding<1>(c, L, a.ns_inter);
  }
  store_mat(a.out + static_cast<size_t>(p) * Np * Np, Rmp, Np, LD);
}

// acc, elem, src: every block computes every layer's sum and writes its
// own (Np, Np) slice of carry * 0 + sum after the last layer.
__global__ void __launch_bounds__(VSM_SUM_THREADS) sum_kernel(const BArgs a) {
  constexpr int kWarps = VSM_SUM_THREADS / 32;
  constexpr int kMaxN = VSM_BAND_MAX_NP / kPack;
  __shared__ __align__(16) float st[VSM_SUM_STAGE];
  __shared__ double part[VSM_SUM_LAYERS][kWarps];
  __shared__ float geo[kMaxN * kMaxN];
  const int N = a.N, S = a.S, NN = N * N;
  const int nt = blockDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // r-+'s geometry (mu_j / (mu_i + mu_j)) wct_j, rounded as r_elem's.
  for (int e = threadIdx.x; e < NN; e += nt) {
    const int i = e / N;
    const int j = e - i * N;
    geo[e] = __fmul_rn(__fdiv_rn(a.aux[j], __fadd_rn(a.aux[i], a.aux[j])),
                       a.aux[N + j]);
  }
  // A thread's entries (b, i, j) of a chunk are tid, tid + nt, ...: the
  // step nt in that mixed radix.
  const int dj = nt % N;
  const int di = (nt / N) % N;
  const int db = nt / NN;
  // Points a pass stages of each layer, and layers a pass.
  const int pc = min(S, VSM_SUM_STAGE / (N + 1));
  const int gl = pc < S ? 1
                        : max(1, min(VSM_SUM_LAYERS,
                                     VSM_SUM_STAGE / (S * (N + 1))));
  float carry = 0.0f;
  for (int z0 = 0; z0 < a.nz; z0 += gl) {
    const int g = min(gl, a.nz - z0);
    for (int b0 = 0; b0 < S; b0 += pc) {
      const int nb = min(pc, S - b0);
      float* em = st;               // (g, nb, N)
      float* ts = st + g * nb * N;  // (g, nb)
      for (int e = threadIdx.x; e < g * nb * N; e += nt) {
        const int l = e / (nb * N);
        const int rest = e - l * nb * N;
        em[e] = a.Em1[(static_cast<size_t>(z0 + l) * S + b0) * N + rest];
      }
      for (int e = threadIdx.x; e < g * nb; e += nt) {
        const int l = e / nb;
        ts[e] = a.tau[static_cast<size_t>(z0 + l) * S + b0 + e - l * nb];
      }
      __syncthreads();
      for (int l = 0; l < g; ++l) {
        double s = 0.0;
        int b = threadIdx.x / NN;
        int i = (threadIdx.x / N) % N;
        int j = threadIdx.x % N;
        while (b < nb) {
          const float* row = em + (l * nb + b) * N;
          float v;
          if (a.stage == S_ACC) {
            v = __fadd_rn(ts[l * nb + b], __fmul_rn(0.0f, row[i]));
          } else {
            const float ee =
                __fadd_rn(__fadd_rn(row[i], row[j]), __fmul_rn(row[i], row[j]));
            v = __fmul_rn(geo[i * N + j], -ee);
          }
          s += static_cast<double>(v);
          j += dj;
          const int cj = j >= N;
          j -= cj * N;
          i += di + cj;
          const int ci = i >= N;
          i -= ci * N;
          b += db + ci;
        }
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) part[l][warp] = b0 == 0 ? s : part[l][warp] + s;
      }
      __syncthreads();
    }
    for (int l = 0; l < g; ++l) {
      double s = 0.0;
      for (int w = 0; w < kWarps; ++w) s += part[l][w];
      carry = carry * 0.0f + static_cast<float>(s);
    }
    __syncthreads();
  }
  const int Np = kPack * N;
  float4* out = reinterpret_cast<float4*>(a.out) +
                static_cast<size_t>(blockIdx.x) * (Np * Np / 4);
  for (int e = threadIdx.x; e < Np * Np / 4; e += nt)
    out[e] = make_float4(carry, carry, carry, carry);
}

bool bad_shape(int stage, int nz, int S, int N) {
  return nz < 1 || S < kPack || S % kPack != 0 || N < 1 ||
         kPack * N > VSM_BAND_MAX_NP || stage < 0 || stage >= S_COUNT;
}

// The launches of one stage: [launches, blocks, threads, shared bytes of
// the first; grid y of the first; blocks, threads, shared bytes of the
// second (full); scratch floats].
void plan(int stage, int nz, int S, int N, int* info) {
  const int Np = kPack * N;
  for (int i = 0; i < 9; ++i) info[i] = 0;
  info[1] = S / kPack;
  info[4] = 1;
  if (stage < S_PACK) {
    info[0] = 1;
    info[2] = VSM_SUM_THREADS;
    info[3] = static_cast<int>(
        VSM_SUM_STAGE * sizeof(float) +
        VSM_SUM_LAYERS * (VSM_SUM_THREADS / 32) * sizeof(double) +
        (VSM_BAND_MAX_NP / kPack) * (VSM_BAND_MAX_NP / kPack) * sizeof(float));
    return;
  }
  info[0] = stage == S_FULL ? 2 : 1;
  info[2] = tile_threads(Np);
  info[3] = layer_smem_floats(Np) * static_cast<int>(sizeof(float));
  info[4] = nz;
  if (stage == S_FULL) {
    info[5] = S / kPack;
    info[6] = tile_threads(Np);
    info[7] = chain_smem_floats(Np) * static_cast<int>(sizeof(float));
  }
  info[8] = nz * (S / kPack) * record_floats(Np);
}

}  // namespace

extern "C" {

const char* vsm_band_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The launch plan of one stage (9 ints, see plan()); 0 or a CUDA error.
int vsm_band_plan(int stage, int nz, int S, int N, int* info) {
  if (bad_shape(stage, nz, S, N))
    return static_cast<int>(cudaErrorInvalidValue);
  plan(stage, nz, S, N, info);
  return 0;
}

// One stage (0 acc, 1 elem, 2 src, 3 pack, 4 dbl, 5 full) on `stream`: tau
// (nz, 1, S), Em1 (nz, S, N), aux (8, N), out (S / 2, 2N, 2N) and scratch
// (the plan's scratch floats; unused by the summing stages) device
// pointers, `sched` a host array of ndoubl NS counts. One launch: sum_kernel
// or layer_kernel (full's chain follows by vsm_band_chain_f32); returns
// cudaGetLastError() (0 on success).
int vsm_band_stage_f32(const float* tau, const float* Em1, const float* aux,
                       float* out, float* scratch, int nz, int S, int N,
                       int stage, int ndoubl, const int* sched, int ns_inter,
                       void* stream) {
  if (bad_shape(stage, nz, S, N) || ndoubl < 0 ||
      ndoubl > VSM_BAND_MAX_DOUBL || ns_inter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BArgs a;
  a.tau = tau;
  a.Em1 = Em1;
  a.aux = aux;
  a.out = out;
  a.scratch = scratch;
  a.nz = nz;
  a.S = S;
  a.N = N;
  a.stage = stage;
  a.ndoubl = ndoubl;
  a.ns_inter = ns_inter;
  for (int i = 0; i < VSM_BAND_MAX_DOUBL; ++i)
    a.sched[i] = i < ndoubl ? sched[i] : 0;
  int info[9];
  plan(stage, nz, S, N, info);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stage < S_PACK) {
    sum_kernel<<<info[1], info[2], 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err = cudaFuncSetAttribute(
      layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, info[3]);
  if (err != cudaSuccess) return static_cast<int>(err);
  layer_kernel<<<dim3(info[1], info[4]), info[2], info[3], st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// full's second launch on `stream`, after its vsm_band_stage_f32: the nz
// adding steps of every pair from the scratch the layer launch wrote, the
// last carry to out. Returns cudaGetLastError() (0 on success).
int vsm_band_chain_f32(float* out, float* scratch, int nz, int S, int N,
                       int ns_inter, void* stream) {
  if (bad_shape(S_FULL, nz, S, N) || ns_inter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BArgs a = {};
  a.out = out;
  a.scratch = scratch;
  a.nz = nz;
  a.S = S;
  a.N = N;
  a.stage = S_FULL;
  a.ns_inter = ns_inter;
  int info[9];
  plan(S_FULL, nz, S, N, info);
  const cudaError_t err = cudaFuncSetAttribute(
      chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, info[7]);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  chain_kernel<<<info[5], info[6], info[7], st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
