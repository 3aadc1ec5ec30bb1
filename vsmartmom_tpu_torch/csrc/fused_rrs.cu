// Block-bichromatic rotational-Raman (RRS) band kernel for Hopper (sm_90a):
// one Fourier moment of the coupled two-wavelength adding-doubling solve
// over all layers, one thread block per (Raman shift, spectral point) pair.
//
// Replaces the TPU kernel vsmartmom_tpu/ops/fused_rrs.py::fused_moment_rrs
// -> _rrs_kernel (elastic assembly from ops/fused_band.py::
// _assemble_elemental, ladder and adding from ops/fused_rt.py::
// _doubling_math / _interaction_math), in its exact-f32 ("highest") mode.
// Each pair is a (2N, 2N) block-lower-triangular problem
//     [[X(l0), 0], [ieX, X(l1)]]     (l0 source, l1 target wavelength).
// Per layer the kernel
//   1. assembles the elastic elementals at l0 and l1 from the pair's row
//      tables and the ie (2,1)-block elemental (mixed optical depths
//      d0 / d1, _rrs_kernel:110-133),
//   2. runs the doubling ladder with a Newton-Schulz inverse on the given
//      per-step schedule (0 = the Neumann seed I + S alone),
//   3. adds the layer onto the composite with one NS inverse
//      (push-through identity for the second geometric factor),
// exactly as csrc/fused_band.cu does for one wavelength. Only the (2,1)
// blocks of the composite are written out.
//
// Design. Every operation keeps the block-lower-triangular form, so the
// (1,2) block of every operator is exactly zero. Operators are stored dense
// in shared memory as (2 NP) x (2 NP) with NP = N rounded up to 4 (each
// half padded to whole 4 x 4 tiles; padding and the (1,2) block are zeroed
// once and never written). Products skip the zero block: an output tile of
// the (1,1) block sums over the l0 half of k, one of the (2,2) block over
// the l1 half, one of the (2,1) block over both, so a product costs 4 N^3
// FMAs instead of the dense 8 N^3. Ten operators (composite, r, t and four
// temporaries) stay resident for the whole moment: 221 KB at N = 36 with
// the padded row stride, one block per SM.
//
// Bound. Per pair and layer the ladder and adding are ~(2k + 5) block
// products per doubling step: FP32 operations bound it, not bytes (a few
// hundred bytes of row tables per ~20 MFLOP). Products are 4 x 4
// register-tiled FP32 FMA loops over shared memory, as in fused_band.cu.

#include <cuda_runtime.h>

#define VSM_RRS_MAX_N 36
#define VSM_RRS_MAX_DOUBL 32
#define VSM_RRS_NMAT 10
#define VSM_RRS_NVEC 7

namespace {

struct Args {
  const float* Zpp;    // (C, N, N) elastic phase matrices, both wavelengths
  const float* Zmp;
  const float* Zrpp;   // (N, N) Raman phase x wct_j, the (2,1) block
  const float* Zrmp;
  const float* geom;   // (4, N, N): RG, A, TO, TS
  const float* gie;    // (4, N, N): mu_i, mu_j, 1/mu_i, 1/mu_j
  const float* dvec;   // (N,) D-matrix diagonal (+-1)
  const float* w;      // (nz, C, P, 2) scattering weight / tau at l0, l1
  const float* Em1;    // (nz, P, 2N) [l0; l1] expm1(-dtau/mu_i)
  const float* dt;     // (nz, P, 2) elemental optical depth d0, d1
  const float* pref;   // (nz, P) w_shift * fscatt(l0), 0 off the grid
  const float* jp;     // (nz, P, 2N) [j_sol+(l0); iej+]
  const float* jms;    // (nz, P, 2N) D [j_sol-(l0); iej-]
  const float* ek;     // (nz, P) beam attenuation per doubling at l0
  float* Rmp;          // (P, N, N) (2,1) blocks of the composite
  float* Rpm;
  float* Tpp;
  float* Tmm;
  float* Jp;           // (P, N)
  float* Jm;
  int P, N, C, nz, ndoubl, ns_inter;
  int sched[VSM_RRS_MAX_DOUBL];
};

// Shape of the shared-memory operators: half size NP (N rounded up to 4),
// dense size M = 2 NP, row stride LD = M + 4 (spreads the four A rows a
// thread reads over two banks).
struct Shape {
  int N, NP, M, LD;
};

__device__ __forceinline__ Shape shape_of(int N) {
  Shape s;
  s.N = N;
  s.NP = (N + 3) & ~3;
  s.M = 2 * s.NP;
  s.LD = s.M + 4;
  return s;
}

// Entry e of the 3 N^2 real entries of the stored blocks (1,1), (2,1),
// (2,2) -> its row and column in the padded dense layout, and its (i, j)
// inside the block.
__device__ __forceinline__ int block_entry(int e, const Shape& s, int* i,
                                           int* j, int* pi, int* pj) {
  const int NN = s.N * s.N;
  const int b = e / NN;
  const int r = e - b * NN;
  *i = r / s.N;
  *j = r - *i * s.N;
  *pi = (b > 0 ? s.NP : 0) + *i;
  *pj = (b == 2 ? s.NP : 0) + *j;
  return b;
}

enum { E_ST = 0, E_ACC, E_NS, E_ADD, E_SGN, E_EK };

// One output panel of a product phase: C = epi(A @ B) (matrices) or
// y = epi(A @ x) (vectors). E is the epilogue's extra operand.
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
                                          int j, const float* d, float ek) {
  switch (epi) {
    case E_ACC: return C[idx] + acc;
    case E_NS: return (i == j ? 2.0f : 0.0f) - E[idx] + acc;
    case E_ADD: return E[idx] + acc;
    case E_SGN: return d[i] * d[j] * E[idx] + acc;
    case E_EK: return C[idx] * ek + acc;
    default: return acc;
  }
}

// Block-wide product phase with one left operand A: up to two matrix
// panels (4 x 4 register tiles per thread over the three stored blocks)
// and up to two vector panels (one row per thread). k runs only where the
// block-lower-triangular factors can be non-zero. Outputs never alias A or
// a B; only real entries are written. The caller synchronises afterwards.
__device__ void product(const float* __restrict__ A, Out m0, Out m1, int nm,
                        Out v0, Out v1, int nv, const float* d, float ek,
                        const Shape& s) {
  const int TG = s.NP >> 2;
  const int bt = TG * TG;
  const int tiles = 3 * bt;
  const int LD = s.LD;
  for (int t = threadIdx.x; t < nm * tiles; t += blockDim.x) {
    const bool second = t >= tiles;
    const Out o = second ? m1 : m0;
    const int tt = second ? t - tiles : t;
    const int b = tt / bt;                 // 0: (1,1), 1: (2,1), 2: (2,2)
    const int rem = tt - b * bt;
    const int ti = rem / TG;
    const int tj = rem - ti * TG;
    const int i0 = (b > 0 ? s.NP : 0) + (ti << 2);
    const int j0 = (b == 2 ? s.NP : 0) + (tj << 2);
    const int k_lo = b == 2 ? s.NP : 0;
    const int k_hi = b == 0 ? s.NP : s.M;
    const float* a0 = A + i0 * LD;
    const float* a1 = a0 + LD;
    const float* a2 = a1 + LD;
    const float* a3 = a2 + LD;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
    for (int k = k_lo; k < k_hi; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(o.B + k * LD + j0);
      const float av[4] = {a0[k], a1[k], a2[k], a3[k]};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(av[r], bv.x, acc[r][0]);
        acc[r][1] = fmaf(av[r], bv.y, acc[r][1]);
        acc[r][2] = fmaf(av[r], bv.z, acc[r][2]);
        acc[r][3] = fmaf(av[r], bv.w, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if ((ti << 2) + r >= s.N) break;
      const int i = i0 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if ((tj << 2) + c < s.N) {
          const int j = j0 + c;
          const int idx = i * LD + j;
          o.C[idx] = epilogue(o.epi, acc[r][c], o.C, o.E, idx, i, j, d, ek);
        }
      }
    }
  }
  for (int t = threadIdx.x; t < nv * s.M; t += blockDim.x) {
    const bool second = t >= s.M;
    const Out o = second ? v1 : v0;
    const int i = second ? t - s.M : t;
    const int li = i < s.NP ? i : i - s.NP;
    if (li >= s.N) continue;
    const int k_hi = i < s.NP ? s.NP : s.M;
    const float* a = A + i * LD;
    float acc = 0.0f;
    for (int k = 0; k < k_hi; ++k) acc = fmaf(a[k], o.B[k], acc);
    o.C[i] = epilogue(o.epi, acc, o.C, o.E, i, i, 0, d, ek);
  }
}

__device__ __forceinline__ void product1(const float* A, Out m0,
                                         const float* d, const Shape& s) {
  product(A, m0, m0, 1, m0, m0, 0, d, 0.0f, s);
}

// (I - S)^-1 by Newton-Schulz from the seed I + S: m <- m (2I - m + S m).
// T[0] holds S on entry; on return T[0] holds the inverse and T[1..3] are
// free. 0 iterations = the seed alone, formed in place.
__device__ void ns_inverse(float* T[4], int iters, const float* d,
                           const Shape& s) {
  float* S = T[0];
  const int LD = s.LD;
  if (iters == 0) {
    for (int p = threadIdx.x; p < s.M; p += blockDim.x)
      if ((p < s.NP ? p : p - s.NP) < s.N) S[p * LD + p] += 1.0f;
    __syncthreads();
    return;
  }
  float* m = T[1];
  float* c = T[2];
  float* nm = T[3];
  for (int e = threadIdx.x; e < 3 * s.N * s.N; e += blockDim.x) {
    int i, j, pi, pj;
    block_entry(e, s, &i, &j, &pi, &pj);
    m[pi * LD + pj] = S[pi * LD + pj] + (pi == pj ? 1.0f : 0.0f);
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    product1(S, mk(m, c, E_NS, m), d, s);     // c = 2I - m + S m
    __syncthreads();
    product1(m, mk(c, nm, E_ST), d, s);       // nm = m c
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

// X <- diag(d) X diag(d) on the real entries (t++ <-> t-- parity flip).
__device__ __forceinline__ void sign_flip(float* X, const float* d,
                                          const Shape& s) {
  for (int e = threadIdx.x; e < 3 * s.N * s.N; e += blockDim.x) {
    int i, j, pi, pj;
    block_entry(e, s, &i, &j, &pi, &pj);
    X[pi * s.LD + pj] *= d[pi] * d[pj];
  }
}

// expm1(x)/x as a 6-term Horner chain (rel. error < 1e-7 for |x| < 0.3).
__device__ __forceinline__ float expm1_ratio_series(float x) {
  return 1.0f + x * (0.5f + x * (1.0f / 6.0f + x * (1.0f / 24.0f + x * (
      1.0f / 120.0f + x * (1.0f / 720.0f)))));
}

__global__ void __launch_bounds__(256, 1)
    rrs_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const Shape sh = shape_of(a.N);
  const int N = a.N, C = a.C, P = a.P;
  const int NN = N * N;
  const int LD = sh.LD, M = sh.M, NP = sh.NP;
  const int MS = M * LD;
  const int pr = blockIdx.x;             // (shift, point) pair of this block
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  // Zero everything once: the padding and the (1,2) block stay zero.
  const int total = VSM_RRS_NMAT * MS + (VSM_RRS_NVEC + 2) * M;
  for (int e = tid; e < total; e += nt) smem[e] = 0.0f;

  float* Rmp = smem;
  float* Rpm = smem + MS;
  float* Tpp = smem + 2 * MS;
  float* Tmm = smem + 3 * MS;
  float* r = smem + 4 * MS;
  float* t = smem + 5 * MS;
  float* T[4] = {smem + 6 * MS, smem + 7 * MS, smem + 8 * MS, smem + 9 * MS};
  float* V = smem + VSM_RRS_NMAT * MS;
  float* Jp = V;
  float* Jm = V + M;
  float* jp = V + 2 * M;
  float* jm = V + 3 * M;
  float* va = V + 4 * M;
  float* vb = V + 5 * M;
  float* vc = V + 6 * M;
  float* sE = V + VSM_RRS_NVEC * M;      // Em1 rows of the layer, [l0; l1]
  float* sd = sE + M;                    // D diagonal, both halves
  __syncthreads();

  // Vacuum composite: R = 0, T = I, J = 0.
  for (int p = tid; p < M; p += nt) {
    const int lp = p < NP ? p : p - NP;
    if (lp < N) {
      Tpp[p * LD + p] = 1.0f;
      Tmm[p * LD + p] = 1.0f;
      sd[p] = a.dvec[lp];
    }
  }

  const float* RG = a.geom;
  const float* GA = a.geom + NN;
  const float* TO = a.geom + 2 * NN;
  const float* TS = a.geom + 3 * NN;
  const float* MUI = a.gie;
  const float* MUJ = a.gie + NN;
  const float* IMI = a.gie + 2 * NN;
  const float* IMJ = a.gie + 3 * NN;

  for (int z = 0; z < a.nz; ++z) {
    const size_t zp = static_cast<size_t>(z) * P + pr;
    __syncthreads();
    for (int q = tid; q < 2 * N; q += nt) {
      const int p = q < N ? q : q - N + NP;
      sE[p] = a.Em1[zp * 2 * N + q];
      jp[p] = a.jp[zp * 2 * N + q];
      jm[p] = a.jms[zp * 2 * N + q];
    }
    const float dt0 = a.dt[zp * 2];
    const float dt1 = a.dt[zp * 2 + 1];
    const float pref = a.pref[zp];
    float ek = a.ek[zp];
    __syncthreads();

    // ---- elemental assembly: starred r* = D r-+, and t++ ----
    for (int e = tid; e < 3 * NN; e += nt) {
      int i, j, pi, pj;
      const int b = block_entry(e, sh, &i, &j, &pi, &pj);
      const int ij = i * N + j;
      if (b != 1) {                       // elastic block at l0 or l1
        const int h = b == 2 ? 1 : 0;
        const float dt = h ? dt1 : dt0;
        float wpp = 0.0f, wmp = 0.0f;
        for (int c = 0; c < C; ++c) {
          const float wc =
              a.w[((static_cast<size_t>(z) * C + c) * P + pr) * 2 + h];
          wpp = fmaf(wc, a.Zpp[c * NN + ij], wpp);
          wmp = fmaf(wc, a.Zmp[c * NN + ij], wmp);
        }
        const float em_i = sE[pi], em_j = sE[pj];
        const float Ei = 1.0f + em_i, Ej = 1.0f + em_j;
        const float one_m_EE = -(em_i + em_j + em_i * em_j);
        r[pi * LD + pj] = sd[pi] * wmp * RG[ij] * one_m_EE;
        const float x = dt * GA[ij];
        t[pi * LD + pj] = wpp * (expm1f(x) * Ej * TO[ij] + (dt * TS[ij]) * Ej) +
                          (i == j ? Ei : 0.0f);
      } else {                            // ie block: rows l1, columns l0
        const float e1i = sE[pi], e0j = sE[pj];
        const float one_m_EE = -(e1i + e0j + e1i * e0j);
        // 1/(mu_i/mu_j + d1/d0) = mu_j d0 / (mu_i d0 + mu_j d1)
        const float denom = MUI[ij] * dt0 + MUJ[ij] * dt1;
        const float fac_r = (MUJ[ij] * dt0) / (denom > 0.0f ? denom : 1.0f);
        r[pi * LD + pj] = sd[pi] * a.Zrmp[ij] * (pref * fac_r * one_m_EE);
        // (d0/mu_i) E0_j expm1(x)/x with x = d0/mu_j - d1/mu_i; above
        // |x| = 0.3, E0_j expm1(x) = Em1_1_i - Em1_0_j.
        const float x = dt0 * IMJ[ij] - dt1 * IMI[ij];
        const float ratio = fabsf(x) < 0.3f
                                ? (1.0f + e0j) * expm1_ratio_series(x)
                                : (e1i - e0j) / x;
        t[pi * LD + pj] = a.Zrpp[ij] * (pref * (dt0 * IMI[ij]) * ratio);
      }
    }
    __syncthreads();

    // ---- doubling ladder on starred operators ----
    for (int step = 0; step < a.ndoubl; ++step) {
      // S = r r; jm_e = jm * ek
      product1(r, mk(r, T[0], E_ST), sd, sh);
      for (int p = tid; p < M; p += nt) va[p] = jm[p] * ek;
      __syncthreads();
      ns_inverse(T, a.sched[step], sd, sh);                  // T[0] = gp
      // tt_gp = t gp; X = r [t | jp | jm_e] folded into rt, c3, c4
      product1(t, mk(T[0], T[1], E_ST), sd, sh);
      product(r, mk(t, T[2], E_ST), mk(t, T[2], E_ST), 1,
              mk(jp, vb, E_ADD, va), mk(va, vc, E_ADD, jp), 2, sd, ek, sh);
      __syncthreads();
      // Y = tt_gp [t | rt | c3 | c4]
      product(T[1], mk(t, T[3], E_ST), mk(T[2], r, E_ACC), 2,
              mk(vb, jm, E_ACC), mk(vc, jp, E_EK), 2, sd, ek, sh);
      __syncthreads();
      float* tmp = t;
      t = T[3];
      T[3] = tmp;
      ek *= ek;
    }

    // ---- unstar: r-+ = D r*, j0- = D j-* ----
    for (int e = tid; e < 3 * NN; e += nt) {
      int i, j, pi, pj;
      block_entry(e, sh, &i, &j, &pi, &pj);
      r[pi * LD + pj] *= sd[pi];
    }
    for (int p = tid; p < M; p += nt) jm[p] *= sd[p];
    __syncthreads();

    // ---- adding onto the composite ----
    product1(r, mk(Rpm, T[0], E_ST), sd, sh);                 // r-+ R+-
    __syncthreads();
    ns_inverse(T, a.ns_inter, sd, sh);                        // T[0] = inv1
    product1(Tmm, mk(T[0], T[1], E_ST), sd, sh);              // T01_inv
    product(r, mk(Tpp, T[2], E_ST), mk(Tpp, T[2], E_ST), 1,   // rT,
            mk(Jp, va, E_ADD, jm), mk(Jp, va, E_ADD, jm), 1,  // rJ + j0-
            sd, ek, sh);
    product1(T[0], mk(r, T[3], E_ST), sd, sh);                // u = inv1 r
    sign_flip(t, sd, sh);                                     // t-- = D t D
    __syncthreads();
    product(T[1], mk(t, Tmm, E_ST), mk(T[2], Rmp, E_ACC), 2,  // T--, R-+,
            mk(va, Jm, E_ACC), mk(va, Jm, E_ACC), 1,          // J-
            sd, ek, sh);
    product(Rpm, mk(T[3], T[0], E_ST), mk(T[3], T[0], E_ST), 1,  // Ru,
            mk(jm, vb, E_ADD, Jp), mk(jm, vb, E_ADD, Jp), 1,     // J+ + Rj
            sd, ek, sh);
    __syncthreads();
    product1(Rpm, mk(t, T[1], E_ST), sd, sh);                 // Rt
    __syncthreads();
    sign_flip(t, sd, sh);                                     // back to t++
    __syncthreads();
    product1(t, mk(T[0], T[2], E_ADD, t), sd, sh);            // T21_inv
    __syncthreads();
    product(T[2], mk(Tpp, T[3], E_ST), mk(T[1], Rpm, E_SGN, r), 2,  // T++, R+-,
            mk(vb, Jp, E_ADD, jp), mk(vb, Jp, E_ADD, jp), 1,         // J+
            sd, ek, sh);
    __syncthreads();
    float* tmp = Tpp;
    Tpp = T[3];
    T[3] = tmp;
  }
  __syncthreads();

  // ---- the (2,1) blocks out ----
  const size_t mo = static_cast<size_t>(pr) * NN;
  for (int e = tid; e < NN; e += nt) {
    const int i = e / N;
    const int idx = (NP + i) * LD + e - i * N;
    a.Rmp[mo + e] = Rmp[idx];
    a.Rpm[mo + e] = Rpm[idx];
    a.Tpp[mo + e] = Tpp[idx];
    a.Tmm[mo + e] = Tmm[idx];
  }
  const size_t vo = static_cast<size_t>(pr) * N;
  for (int i = tid; i < N; i += nt) {
    a.Jp[vo + i] = Jp[NP + i];
    a.Jm[vo + i] = Jm[NP + i];
  }
}

}  // namespace

extern "C" {

size_t vsm_fused_moment_rrs_smem_bytes(int N) {
  const int NP = (N + 3) & ~3;
  const int M = 2 * NP;
  const int LD = M + 4;
  return (static_cast<size_t>(VSM_RRS_NMAT) * M * LD +
          static_cast<size_t>(VSM_RRS_NVEC + 2) * M) * sizeof(float);
}

const char* vsm_rrs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the RRS kernel on `stream` and returns cudaGetLastError() (0 on
// success). All pointers are device pointers except `sched` (host, ndoubl
// entries).
int vsm_fused_moment_rrs_f32(
    const float* Zpp, const float* Zmp, const float* Zrpp, const float* Zrmp,
    const float* geom, const float* gie, const float* dvec, const float* w,
    const float* Em1, const float* dt, const float* pref, const float* jp,
    const float* jms, const float* ek, float* Rmp, float* Rpm, float* Tpp,
    float* Tmm, float* Jp, float* Jm, int P, int N, int C, int nz,
    int ndoubl, const int* sched, int ns_inter, void* stream) {
  if (N < 1 || N > VSM_RRS_MAX_N || C < 1 || P < 0 || nz < 0 ||
      ndoubl < 0 || ndoubl > VSM_RRS_MAX_DOUBL || ns_inter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.Zpp = Zpp;
  a.Zmp = Zmp;
  a.Zrpp = Zrpp;
  a.Zrmp = Zrmp;
  a.geom = geom;
  a.gie = gie;
  a.dvec = dvec;
  a.w = w;
  a.Em1 = Em1;
  a.dt = dt;
  a.pref = pref;
  a.jp = jp;
  a.jms = jms;
  a.ek = ek;
  a.Rmp = Rmp;
  a.Rpm = Rpm;
  a.Tpp = Tpp;
  a.Tmm = Tmm;
  a.Jp = Jp;
  a.Jm = Jm;
  a.P = P;
  a.N = N;
  a.C = C;
  a.nz = nz;
  a.ndoubl = ndoubl;
  a.ns_inter = ns_inter;
  for (int i = 0; i < VSM_RRS_MAX_DOUBL; ++i)
    a.sched[i] = i < ndoubl ? sched[i] : 0;
  const size_t smem = vsm_fused_moment_rrs_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      rrs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P > 0)
    rrs_kernel<<<P, 256, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
