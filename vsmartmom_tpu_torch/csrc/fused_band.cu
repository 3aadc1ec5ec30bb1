// Whole-moment band kernel for Hopper (sm_90a): one Fourier moment of the
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
// ten N x N f32 matrices (10.8 KB each at N = 52) plus a few N x K vectors,
// ~111 KB at N = 52, K = 1 (dynamic shared memory, opted in per launch).
// Global memory sees the per-layer row tables in and the composite out once.
//
// Bound. Per point and layer the ladder and adding are ~(2k + 5) N x N x N
// products per doubling step, so the kernel is bound by FP32 operations, not
// bytes (a few KB of row tables per ~20 MFLOP). The products are plain FP32
// FMA loops over shared memory: each thread owns a 4 x 4 output tile, reads
// B rows as float4 and A as scalars, so a k-step issues 5 shared loads for
// 16 FMAs. Tensor cores (3xTF32 / bf16x3 with the Beer-diagonal
// compensation), wgmma and TMA are later work.

#include <cuda_runtime.h>

#define VSM_MAX_N 64
#define VSM_MAX_K 2
#define VSM_MAX_DOUBL 32
#define VSM_NMAT 10
#define VSM_NVEC 7

namespace {

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
  int s, N, C, K, nz, ndoubl, ns_inter;
  int sched[VSM_MAX_DOUBL];
};

enum { E_ST = 0, E_ACC, E_NS, E_ADD, E_SGN, E_EK };

// One output panel of a product phase: C = epi(A @ B) (matrices) or
// y = epi(A @ x) (N x K vectors). E is the epilogue's extra operand.
struct Out {
  const float* B;
  float* C;
  const float* E;
  int epi;
};

__device__ __forceinline__ Out mk(const float* B, float* C, int epi,
                                  const float* E = nullptr) {
  Out o;
  o.B = B;
  o.C = C;
  o.E = E;
  o.epi = epi;
  return o;
}

__device__ __forceinline__ float epilogue(int epi, float acc, float* C,
                                          const float* E, int idx, int i,
                                          int j, const float* d,
                                          const float* ek) {
  switch (epi) {
    case E_ACC: return C[idx] + acc;
    case E_NS: return (i == j ? 2.0f : 0.0f) - E[idx] + acc;
    case E_ADD: return E[idx] + acc;
    case E_SGN: return d[i] * d[j] * E[idx] + acc;
    case E_EK: return C[idx] * ek[j] + acc;
    default: return acc;
  }
}

// Block-wide product phase with one left operand A (n x n, leading dim LD):
// up to two matrix panels (4 x 4 register tiles per thread) and up to two
// vector panels (one output per thread). Outputs never alias A or a B.
// The caller synchronises afterwards.
__device__ void product(const float* __restrict__ A, Out m0, Out m1, int nm,
                        Out v0, Out v1, int nv, const float* d,
                        const float* ek, int n, int LD, int K) {
  const int tg = (n + 3) >> 2;
  const int tiles = tg * tg;
  for (int t = threadIdx.x; t < nm * tiles; t += blockDim.x) {
    const bool second = t >= tiles;
    const Out o = second ? m1 : m0;
    const int tt = second ? t - tiles : t;
    const int ti = tt / tg;
    const int i0 = ti << 2;
    const int j0 = (tt - ti * tg) << 2;
    const float* a0 = A + min(i0, n - 1) * LD;
    const float* a1 = A + min(i0 + 1, n - 1) * LD;
    const float* a2 = A + min(i0 + 2, n - 1) * LD;
    const float* a3 = A + min(i0 + 3, n - 1) * LD;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(o.B + k * LD + j0);
      const float av[4] = {a0[k], a1[k], a2[k], a3[k]};
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
        if (j < n) {
          const int idx = i * LD + j;
          o.C[idx] = epilogue(o.epi, acc[r][c], o.C, o.E, idx, i, j, d, ek);
        }
      }
    }
  }
  const int nk = n * K;
  for (int t = threadIdx.x; t < nv * nk; t += blockDim.x) {
    const bool second = t >= nk;
    const Out o = second ? v1 : v0;
    const int tt = second ? t - nk : t;
    const int i = tt / K;
    const int s = tt - i * K;
    const float* a = A + i * LD;
    float acc = 0.0f;
    for (int k = 0; k < n; ++k) acc = fmaf(a[k], o.B[k * K + s], acc);
    o.C[tt] = epilogue(o.epi, acc, o.C, o.E, tt, i, s, d, ek);
  }
}

__device__ __forceinline__ void product1(const float* A, Out m0,
                                         const float* d, int n, int LD,
                                         int K) {
  product(A, m0, m0, 1, m0, m0, 0, d, nullptr, n, LD, K);
}

// (I - S)^-1 by Newton-Schulz from the seed I + S: m <- m (2I - m + S m).
// T[0] holds S on entry; on return T[0] holds the inverse and T[1..3] are
// free. 0 iterations = the seed alone, formed in place.
__device__ void ns_inverse(float* T[4], int iters, const float* d, int n,
                           int LD, int K) {
  float* S = T[0];
  if (iters == 0) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) S[i * LD + i] += 1.0f;
    __syncthreads();
    return;
  }
  float* m = T[1];
  float* c = T[2];
  float* nm = T[3];
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n;
    const int j = e - i * n;
    m[i * LD + j] = S[i * LD + j] + (i == j ? 1.0f : 0.0f);
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    product1(S, mk(m, c, E_NS, m), d, n, LD, K);   // c = 2I - m + S m
    __syncthreads();
    product1(m, mk(c, nm, E_ST), d, n, LD, K);     // nm = m c
    __syncthreads();
    float* tmp = m;
    m = nm;
    nm = tmp;
  }
  T[0] = m;
  T[1] = S;
  T[2] = c;
  T[3] = nm;
}

__global__ void __launch_bounds__(256)
    moment_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, K = a.K, C = a.C;
  const int LD = (N + 3) & ~3;           // float4-aligned rows
  const int MS = N * LD;
  const int VS = (N * K + 3) & ~3;
  const int NN = N * N;
  const int NK = N * K;
  const int pt = blockIdx.x;             // spectral point of this block
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  float* Rmp = smem;
  float* Rpm = smem + MS;
  float* Tpp = smem + 2 * MS;
  float* Tmm = smem + 3 * MS;
  float* r = smem + 4 * MS;
  float* t = smem + 5 * MS;
  float* T[4] = {smem + 6 * MS, smem + 7 * MS, smem + 8 * MS, smem + 9 * MS};
  float* V = smem + VSM_NMAT * MS;
  float* Jp = V;
  float* Jm = V + VS;
  float* jp = V + 2 * VS;
  float* jm = V + 3 * VS;
  float* va = V + 4 * VS;
  float* vb = V + 5 * VS;
  float* vc = V + 6 * VS;
  float* sE = V + VSM_NVEC * VS;         // Em1 row of the layer
  float* sd = sE + LD;                   // D diagonal

  // Vacuum composite: R = 0, T = I, J = 0.
  for (int e = tid; e < NN; e += nt) {
    const int i = e / N;
    const int j = e - i * N;
    const int idx = i * LD + j;
    Rmp[idx] = 0.0f;
    Rpm[idx] = 0.0f;
    Tpp[idx] = (i == j) ? 1.0f : 0.0f;
    Tmm[idx] = (i == j) ? 1.0f : 0.0f;
  }
  for (int e = tid; e < NK; e += nt) {
    Jp[e] = 0.0f;
    Jm[e] = 0.0f;
  }
  for (int i = tid; i < N; i += nt) sd[i] = a.dvec[i];

  const float* RG = a.geom;
  const float* GA = a.geom + NN;
  const float* TO = a.geom + 2 * NN;
  const float* TS = a.geom + 3 * NN;

  for (int z = 0; z < a.nz; ++z) {
    const size_t zs = static_cast<size_t>(z) * a.s + pt;
    __syncthreads();
    for (int i = tid; i < N; i += nt) sE[i] = a.Em1[zs * N + i];
    for (int e = tid; e < NK; e += nt) {
      jp[e] = a.jp[zs * NK + e];
      jm[e] = a.jms[zs * NK + e];
    }
    const float dt = a.dt[zs];
    float ek[VSM_MAX_K];
    for (int s = 0; s < K; ++s) ek[s] = a.ek[zs * K + s];
    __syncthreads();

    // ---- elemental assembly: starred r* = D r-+, and t++ ----
    for (int e = tid; e < NN; e += nt) {
      const int i = e / N;
      const int j = e - i * N;
      float wpp = 0.0f, wmp = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float wc = a.w[(static_cast<size_t>(z) * C + c) * a.s + pt];
        wpp = fmaf(wc, a.Zpp[c * NN + e], wpp);
        wmp = fmaf(wc, a.Zmp[c * NN + e], wmp);
      }
      const float em_i = sE[i], em_j = sE[j];
      const float Ei = 1.0f + em_i, Ej = 1.0f + em_j;
      const float one_m_EE = -(em_i + em_j + em_i * em_j);
      r[i * LD + j] = sd[i] * wmp * RG[e] * one_m_EE;
      // t_off ratio expm1(dt (mu_i - mu_j)/(mu_i mu_j)) with the 1/delta,
      // weight and same-mu masks folded into TO/TS.
      const float x = dt * GA[e];
      t[i * LD + j] = wpp * (expm1f(x) * Ej * TO[e] + (dt * TS[e]) * Ej) +
                      (i == j ? Ei : 0.0f);
    }
    __syncthreads();

    // ---- doubling ladder on starred operators ----
    for (int step = 0; step < a.ndoubl; ++step) {
      // S = r r; jm_e = jm * ek
      product1(r, mk(r, T[0], E_ST), sd, N, LD, K);
      for (int e = tid; e < NK; e += nt) va[e] = jm[e] * ek[e % K];
      __syncthreads();
      ns_inverse(T, a.sched[step], sd, N, LD, K);            // T[0] = gp
      // tt_gp = t gp; X = r [t | jp | jm_e] folded into rt, c3, c4
      product1(t, mk(T[0], T[1], E_ST), sd, N, LD, K);
      product(r, mk(t, T[2], E_ST), mk(t, T[2], E_ST), 1,
              mk(jp, vb, E_ADD, va), mk(va, vc, E_ADD, jp), 2, sd, ek, N, LD,
              K);
      __syncthreads();
      // Y = tt_gp [t | rt | c3 | c4]
      product(T[1], mk(t, T[3], E_ST), mk(T[2], r, E_ACC), 2,
              mk(vb, jm, E_ACC), mk(vc, jp, E_EK), 2, sd, ek, N, LD, K);
      __syncthreads();
      float* tmp = t;
      t = T[3];
      T[3] = tmp;
      for (int s = 0; s < K; ++s) ek[s] *= ek[s];
    }

    // ---- unstar: r-+ = D r*, j0- = D j-* ----
    for (int e = tid; e < NN; e += nt) {
      const int i = e / N;
      r[i * LD + e - i * N] *= sd[i];
    }
    for (int e = tid; e < NK; e += nt) jm[e] *= sd[e / K];
    __syncthreads();

    // ---- adding onto the composite ----
    product1(r, mk(Rpm, T[0], E_ST), sd, N, LD, K);           // r-+ R+-
    __syncthreads();
    ns_inverse(T, a.ns_inter, sd, N, LD, K);                  // T[0] = inv1
    product1(Tmm, mk(T[0], T[1], E_ST), sd, N, LD, K);        // T01_inv
    product(r, mk(Tpp, T[2], E_ST), mk(Tpp, T[2], E_ST), 1,   // rT,
            mk(Jp, va, E_ADD, jm), mk(Jp, va, E_ADD, jm), 1,  // rJ + j0-
            sd, ek, N, LD, K);
    product1(T[0], mk(r, T[3], E_ST), sd, N, LD, K);          // u = inv1 r
    for (int e = tid; e < NN; e += nt) {                      // t-- = D t D
      const int i = e / N;
      const int j = e - i * N;
      t[i * LD + j] *= sd[i] * sd[j];
    }
    __syncthreads();
    product(T[1], mk(t, Tmm, E_ST), mk(T[2], Rmp, E_ACC), 2,  // T--, R-+,
            mk(va, Jm, E_ACC), mk(va, Jm, E_ACC), 1,          // J-
            sd, ek, N, LD, K);
    product(Rpm, mk(T[3], T[0], E_ST), mk(T[3], T[0], E_ST), 1,  // Ru,
            mk(jm, vb, E_ADD, Jp), mk(jm, vb, E_ADD, Jp), 1,     // J+ + Rj
            sd, ek, N, LD, K);
    __syncthreads();
    product1(Rpm, mk(t, T[1], E_ST), sd, N, LD, K);           // Rt
    __syncthreads();
    for (int e = tid; e < NN; e += nt) {                      // back to t++
      const int i = e / N;
      const int j = e - i * N;
      t[i * LD + j] *= sd[i] * sd[j];
    }
    __syncthreads();
    product1(t, mk(T[0], T[2], E_ADD, t), sd, N, LD, K);      // T21_inv
    __syncthreads();
    product(T[2], mk(Tpp, T[3], E_ST), mk(T[1], Rpm, E_SGN, r), 2,  // T++, R+-,
            mk(vb, Jp, E_ADD, jp), mk(vb, Jp, E_ADD, jp), 1,         // J+
            sd, ek, N, LD, K);
    __syncthreads();
    float* tmp = Tpp;
    Tpp = T[3];
    T[3] = tmp;
  }
  __syncthreads();

  const size_t mo = static_cast<size_t>(pt) * NN;
  for (int e = tid; e < NN; e += nt) {
    const int i = e / N;
    const int idx = i * LD + e - i * N;
    a.Rmp[mo + e] = Rmp[idx];
    a.Rpm[mo + e] = Rpm[idx];
    a.Tpp[mo + e] = Tpp[idx];
    a.Tmm[mo + e] = Tmm[idx];
  }
  const size_t vo = static_cast<size_t>(pt) * NK;
  for (int e = tid; e < NK; e += nt) {
    a.Jp[vo + e] = Jp[e];
    a.Jm[vo + e] = Jm[e];
  }
}

size_t smem_floats(int N, int K) {
  const int LD = (N + 3) & ~3;
  const int VS = (N * K + 3) & ~3;
  return static_cast<size_t>(VSM_NMAT) * N * LD +
         static_cast<size_t>(VSM_NVEC) * VS + 2 * LD;
}

}  // namespace

extern "C" {

size_t vsm_fused_moment_smem_bytes(int N, int K) {
  return smem_floats(N, K) * sizeof(float);
}

int vsm_fused_moment_threads(int N) {
  const int tg = (N + 3) / 4;
  const int th = ((tg * tg + 31) / 32) * 32;
  return th < 64 ? 64 : (th > 256 ? 256 : th);
}

const char* vsm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the band kernel on `stream` and returns cudaGetLastError() (0 on
// success). All pointers are device pointers except `sched` (host, ndoubl
// entries).
int vsm_fused_moment_f32(const float* Zpp, const float* Zmp, const float* geom,
                         const float* dvec, const float* w, const float* Em1,
                         const float* dt, const float* jp, const float* jms,
                         const float* ek, float* Rmp, float* Rpm, float* Tpp,
                         float* Tmm, float* Jp, float* Jm, int s, int N,
                         int C, int K, int nz, int ndoubl, const int* sched,
                         int ns_inter, void* stream) {
  if (N < 1 || N > VSM_MAX_N || K < 1 || K > VSM_MAX_K || C < 1 || s < 0 ||
      nz < 0 || ndoubl < 0 || ndoubl > VSM_MAX_DOUBL || ns_inter < 0)
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
  a.K = K;
  a.nz = nz;
  a.ndoubl = ndoubl;
  a.ns_inter = ns_inter;
  for (int i = 0; i < VSM_MAX_DOUBL; ++i) a.sched[i] = i < ndoubl ? sched[i] : 0;
  const size_t smem = vsm_fused_moment_smem_bytes(N, K);
  cudaError_t err = cudaFuncSetAttribute(
      moment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s > 0)
    moment_kernel<<<s, vsm_fused_moment_threads(N), smem,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
