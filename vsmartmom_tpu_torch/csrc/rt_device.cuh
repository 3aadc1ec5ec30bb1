// Device code of the band-stage probe (csrc/band_stages.cu, its one user):
// register-tiled FP32 product phases (a 4 x 4 output tile per thread, B
// rows read as float4 and A as scalars: 5 shared loads per 16 FMA), the
// Newton-Schulz inverse, the doubling ladder on starred operators
// (_doubling_math of vsmartmom_tpu/ops/fused_rt.py) and the adding step
// (_interaction_math), each a device function working on one block's shared
// memory. The production kernels (K1, K3, K4 and K5) run the same algebra
// on csrc/fp32_tile.cuh instead. The build hashes every csrc/*.cuh into
// each library's name (ops/cuda_build.py), so an edit here rebuilds every
// source.

#pragma once

#include <cuda_runtime.h>

namespace {

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

// ek is the per-row attenuation (N x K, row-major like the vectors): E_EK
// is only used on vector panels, where idx = i K + source.
__device__ __forceinline__ float epilogue(int epi, float acc, float* C,
                                          const float* E, int idx, int i,
                                          int j, const float* d,
                                          const float* ek) {
  switch (epi) {
    case E_ACC: return C[idx] + acc;
    case E_NS: return (i == j ? 2.0f : 0.0f) - E[idx] + acc;
    case E_ADD: return E[idx] + acc;
    case E_SGN: return d[i] * d[j] * E[idx] + acc;
    case E_EK: return C[idx] * ek[idx] + acc;
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

// Shared-memory workspace of one block: matrices of N rows at stride LD,
// vectors of N x K padded to VS floats.
struct Work {
  float* r;      // starred reflection r* = D r-+
  float* t;      // t++
  float* T[4];   // NS / product temporaries
  float* jp;     // j0+
  float* jm;     // starred D j0-
  float* va;
  float* vb;
  float* vc;
  float* ek;     // per-row attenuation, N x K
};

// The doubling ladder on starred operators (_doubling_math):
//   gp = (I - r r)^-1 (NS), tt_gp = t gp, X = r [t | jp | jm ek],
//   Y = tt_gp [t | rt | jm ek + r jp | jp + r jm ek],
//   t' = Y0, r' = r + Y1, jm' = jm + Y2, jp' = jp ek + Y3, ek' = ek^2.
// w.t ends up in whichever buffer holds the last product.
__device__ void ladder(Work& w, int ndoubl, const int* sched, const float* d,
                       int N, int LD, int K) {
  const int NK = N * K;
  for (int step = 0; step < ndoubl; ++step) {
    product1(w.r, mk(w.r, w.T[0], E_ST), d, N, LD, K);       // S = r r
    for (int e = threadIdx.x; e < NK; e += blockDim.x)
      w.va[e] = w.jm[e] * w.ek[e];                           // jm_e
    __syncthreads();
    ns_inverse(w.T, sched[step], d, N, LD, K);               // T[0] = gp
    product1(w.t, mk(w.T[0], w.T[1], E_ST), d, N, LD, K);    // tt_gp
    product(w.r, mk(w.t, w.T[2], E_ST), mk(w.t, w.T[2], E_ST), 1,  // rt,
            mk(w.jp, w.vb, E_ADD, w.va),                     // c3,
            mk(w.va, w.vc, E_ADD, w.jp), 2, d, w.ek, N, LD, K);  // c4
    __syncthreads();
    product(w.T[1], mk(w.t, w.T[3], E_ST), mk(w.T[2], w.r, E_ACC), 2,
            mk(w.vb, w.jm, E_ACC), mk(w.vc, w.jp, E_EK), 2, d, w.ek, N, LD,
            K);
    __syncthreads();
    float* tmp = w.t;
    w.t = w.T[3];
    w.T[3] = tmp;
    for (int e = threadIdx.x; e < NK; e += blockDim.x) w.ek[e] *= w.ek[e];
    __syncthreads();
  }
}

__device__ __forceinline__ void store_mat(float* dst, const float* src,
                                          int N, int LD) {
  for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
    const int i = e / N;
    dst[e] = src[i * LD + e - i * N];
  }
}

// Work buffers carved from shared memory after `nmat_before` matrices.
__device__ Work carve(float* smem, int nmat_before, int MS, int VS) {
  Work w;
  float* m = smem + nmat_before * MS;
  w.r = m;
  w.t = m + MS;
  w.T[0] = m + 2 * MS;
  w.T[1] = m + 3 * MS;
  w.T[2] = m + 4 * MS;
  w.T[3] = m + 5 * MS;
  float* v = m + 6 * MS;
  w.jp = v;
  w.jm = v + VS;
  w.va = v + 2 * VS;
  w.vb = v + 3 * VS;
  w.vc = v + 4 * VS;
  w.ek = v + 5 * VS;
  return w;
}

// The composite of the adding step in shared memory: matrices of N rows at
// stride LD, source stacks of N x K.
struct Comp {
  float* Rmp;
  float* Rpm;
  float* Tpp;
  float* Tmm;
  float* Jp;
  float* Jm;
};

// The adding step onto the composite c (_interaction_math: Sanghavi 2014
// Eqs. 23-28 with one NS inverse, the second factor by the push-through
// identity) with the unstarred layer in w: w.r = r-+, w.t = t++, w.jp = j0+,
// w.jm = j0-; r+- = D r-+ D and t-- = D t++ D come from the D diagonal sd
// (+-1), ns_inter NS iterations. On return c holds the new composite (its
// T++ in the buffer that was w.T[3], which takes the old T++ buffer), w.t
// holds t++ again and the other buffers of w are spent.
__device__ void adding(Comp& c, Work& w, const float* sd, int ns_inter, int N,
                       int LD, int K) {
  const int NN = N * N;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* Rmp = c.Rmp;
  float* Rpm = c.Rpm;
  float* Tpp = c.Tpp;
  float* Tmm = c.Tmm;
  float* Jp = c.Jp;
  float* Jm = c.Jm;
  float* r = w.r;
  float* t = w.t;
  float** T = w.T;
  float* jp = w.jp;
  float* jm = w.jm;
  float* va = w.va;
  float* vb = w.vb;
  const float* ek = w.ek;

  product1(r, mk(Rpm, T[0], E_ST), sd, N, LD, K);           // r-+ R+-
  __syncthreads();
  ns_inverse(T, ns_inter, sd, N, LD, K);                    // T[0] = inv1
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
  c.Tpp = T[3];
  T[3] = Tpp;
}

int threads_for(int N) {
  const int tg = (N + 3) / 4;
  const int th = ((tg * tg + 31) / 32) * 32;
  return th < 64 ? 64 : (th > 256 ? 256 : th);
}

size_t smem_bytes(int nmat, int nvec, int N, int K) {
  const int LD = (N + 3) & ~3;
  const int VS = (N * K + 3) & ~3;
  return (static_cast<size_t>(nmat) * N * LD +
          static_cast<size_t>(nvec) * VS + LD) * sizeof(float);
}

}  // namespace
