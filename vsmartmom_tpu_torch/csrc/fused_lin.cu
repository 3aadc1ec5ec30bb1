// Multitangent band kernel K2 for Hopper (sm_90a): one Fourier moment of the
// adding-doubling solve over all layers, plus the forward-mode tangent of its
// composite along P parameters, for K = 1 (solar) or K = 2 (solar + thermal)
// source columns.
//
// Replaces two TPU kernels:
//   * vsmartmom_tpu/ops/fused_lin.py::fused_moment_multitangent -> _mt_kernel
//     (K = 1), whose tangent algebra comes from jax.linearize of the forward
//     body at trace time;
//   * K1' (K = 2): the tangent kernel that Pallas's automatic JVP rule builds
//     from vsmartmom_tpu/ops/fused_band.py::fused_moment -> _moment_kernel,
//     which the JAX package's thermal Jacobian runs one parameter per
//     dispatch (core/linearization.py). One launch here does all P.
// The second source column is the isothermal Planck source: it doubles with
// ek = 1 (tangent 0), so the ladder's source jobs and the E_EK epilogue loop
// over the K columns of every (N, K) source vector. K is a template argument:
// the K = 1 instance is the solar kernel's code, with no index arithmetic
// over a run-time K.
//
// The tangent algebra is written out:
// every product A B of the forward kernel (csrc/fused_band.cu) gets the
// tangent product dA B + A dB, and
//   * the elemental assembly is differentiated through its row tables, the
//     phase matrices and expm1(dtau A);
//   * each doubling step is differentiated AS IT IS RUN: every Newton-Schulz
//     iteration m <- m (2I - m + S m) of the probed schedule carries
//     dm <- dm c + m (-dm + dS m + S dm); a seed-only step (I + S) gives
//     d = dS. This is the jvp of the plain version, not the exact inverse's
//     -X dS X;
//   * the adding step's push-through form is differentiated the same way.
//
// Design (a): a grid over (spectral point, tangent). Each block runs the
// primal and ONE tangent chain in lockstep, keeping both composites and both
// ladders in shared memory for the whole moment: twenty N x N f32 operators
// (216 KB at N = 52, one block per SM) and fourteen (N, K) source vectors
// (222,768 B in all at N = 52, K = 2, inside the 232,448 B a block may opt
// in to). The primal is
// so recomputed once per tangent: P (1 + 2) primal-units of work against the
// least 1 + 2P (24 against 17 at P = 8). Block (pt, 0) writes the primal.
//
// Products reuse K1's machinery: 4 x 4 register tiles per thread, B rows
// read as float4, A as scalars, a fused epilogue. A "job" is one output
// panel C = epi(A0 B0 [+ A1 B1]); one phase runs several jobs that share no
// output with any input of the phase, then the block synchronises. The
// tangent jobs carry two products, so a phase with the primal and the tangent
// of one product is three products' work.

#include <cuda_runtime.h>

#define VSM_MAX_N 52
#define VSM_MAX_K 2
#define VSM_MAX_DOUBL 32
#define VSM_NMAT 20
#define VSM_NVEC 14
#define VSM_THREADS 384

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
  const float* ek;    // (nz, s, K) per-source attenuation per doubling
  // Tangents of the operands above, each with a leading P axis.
  const float* dZpp;  // (P, C, N, N)
  const float* dZmp;
  const float* dw;    // (P, nz, C, s)
  const float* dEm1;  // (P, nz, s, N)
  const float* ddt;   // (P, nz, s)
  const float* djp;   // (P, nz, s, N, K)
  const float* djms;
  const float* dek;   // (P, nz, s, K)
  float* Rmp;         // (s, N, N) primal composite
  float* Rpm;
  float* Tpp;
  float* Tmm;
  float* Jp;          // (s, N, K)
  float* Jm;
  float* tRmp;        // (P, s, N, N) tangent composites
  float* tRpm;
  float* tTpp;
  float* tTmm;
  float* tJp;         // (P, s, N, K)
  float* tJm;
  int s, N, C, nz, P, ndoubl, ns_inter;
  int sched[VSM_MAX_DOUBL];
};

// Epilogues: C = f(acc) with E the job's extra operand, d the D diagonal,
// ek / dek the output's source column's factor of this doubling step and its
// tangent (vector jobs only).
enum { E_ST = 0, E_ACC, E_NS, E_NEG, E_ADD, E_SGN, E_EK, E_EKT };

// Each source column's attenuation per doubling of this step and its
// tangent, passed by value so that they stay in registers.
struct Beam {
  float ek[VSM_MAX_K];
  float dek[VSM_MAX_K];
};

// Column c < K of a Beam field, without a run-time index into it.
__device__ __forceinline__ float column(const float (&v)[VSM_MAX_K], int c) {
  return c == 0 ? v[0] : v[1];
}

struct Job {
  const float* A0;
  const float* B0;
  const float* A1;    // nullptr: one product
  const float* B1;
  float* C;
  const float* E;
  int epi;
};

__device__ __forceinline__ Job job(const float* A0, const float* B0, float* C,
                                   int epi = E_ST, const float* E = nullptr,
                                   const float* A1 = nullptr,
                                   const float* B1 = nullptr) {
  Job o;
  o.A0 = A0;
  o.B0 = B0;
  o.A1 = A1;
  o.B1 = B1;
  o.C = C;
  o.E = E;
  o.epi = epi;
  return o;
}

// Tangent job: C = epi(dA B + A dB).
__device__ __forceinline__ Job tjob(const float* dA, const float* B,
                                    const float* A, const float* dB, float* C,
                                    int epi = E_ST, const float* E = nullptr) {
  return job(dA, B, C, epi, E, A, dB);
}

__device__ __forceinline__ float epilogue(int epi, float acc, const float* C,
                                          const float* E, int idx, int i,
                                          int j, const float* d, float ek,
                                          float dek) {
  switch (epi) {
    case E_ACC: return C[idx] + acc;
    case E_NS: return (i == j ? 2.0f : 0.0f) - E[idx] + acc;
    case E_NEG: return acc - E[idx];
    case E_ADD: return E[idx] + acc;
    case E_SGN: return d[i] * d[j] * E[idx] + acc;
    case E_EK: return C[idx] * ek + acc;
    case E_EKT: return C[idx] * ek + E[idx] * dek + acc;
    default: return acc;
  }
}

__device__ __forceinline__ void mac_tile(const float* __restrict__ A,
                                         const float* __restrict__ B,
                                         float acc[4][4], int i0, int j0,
                                         int n, int LD) {
  const float* a0 = A + min(i0, n - 1) * LD;
  const float* a1 = A + min(i0 + 1, n - 1) * LD;
  const float* a2 = A + min(i0 + 2, n - 1) * LD;
  const float* a3 = A + min(i0 + 3, n - 1) * LD;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float4 b = *reinterpret_cast<const float4*>(B + k * LD + j0);
    const float av[4] = {a0[k], a1[k], a2[k], a3[k]};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[r][0] = fmaf(av[r], b.x, acc[r][0]);
      acc[r][1] = fmaf(av[r], b.y, acc[r][1]);
      acc[r][2] = fmaf(av[r], b.z, acc[r][2]);
      acc[r][3] = fmaf(av[r], b.w, acc[r][3]);
    }
  }
}

// One phase: nm matrix jobs (n x n outputs, 4 x 4 tiles per thread) and nv
// vector jobs (n x K outputs of an (N, K) vector, one per thread; b holds
// each column's factors). The caller synchronises after.
template <int K>
__device__ void product(const Job* jm, int nm, const Job* jv, int nv,
                        const float* d, Beam b, int n, int LD) {
  const int tg = (n + 3) >> 2;
  const int tiles = tg * tg;
  for (int t = threadIdx.x; t < nm * tiles; t += blockDim.x) {
    const int q = t / tiles;
    const Job o = jm[q];
    const int tt = t - q * tiles;
    const int ti = tt / tg;
    const int i0 = ti << 2;
    const int j0 = (tt - ti * tg) << 2;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    mac_tile(o.A0, o.B0, acc, i0, j0, n, LD);
    if (o.A1 != nullptr) mac_tile(o.A1, o.B1, acc, i0, j0, n, LD);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r;
      if (i >= n) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + c;
        if (j < n) {
          const int idx = i * LD + j;
          o.C[idx] = epilogue(o.epi, acc[r][c], o.C, o.E, idx, i, j, d, 0.0f,
                              0.0f);
        }
      }
    }
  }
  const int nk = n * K;
  for (int t = threadIdx.x; t < nv * nk; t += blockDim.x) {
    const int q = t / nk;
    const Job o = jv[q];
    const int e = t - q * nk;            // (i, c) of the (N, K) output
    const int i = e / K;
    const int c = e - i * K;
    const float* a = o.A0 + i * LD;
    float acc = 0.0f;
    for (int k = 0; k < n; ++k) acc = fmaf(a[k], o.B0[k * K + c], acc);
    if (o.A1 != nullptr) {
      const float* a1 = o.A1 + i * LD;
      for (int k = 0; k < n; ++k) acc = fmaf(a1[k], o.B1[k * K + c], acc);
    }
    o.C[e] = epilogue(o.epi, acc, o.C, o.E, e, i, c, d, column(b.ek, c),
                      column(b.dek, c));
  }
}

template <int K>
__device__ __forceinline__ void phase(const Job* jm, int nm, const Job* jv,
                                      int nv, const float* d, Beam b, int n,
                                      int LD) {
  product<K>(jm, nm, jv, nv, d, b, n, LD);
  __syncthreads();
}

// (I - S)^-1 by Newton-Schulz from the seed I + S, with its tangent:
//   m <- m c, c = 2I - m + S m;   dm <- dm c + m dc, dc = -dm + dS m + S dm.
// T[0] / U[0] hold S / dS on entry and the inverse / its tangent on return;
// T[1..3], U[1..3] are scratch. 0 iterations = the seed alone (d = dS).
__device__ void ns_inverse(float* T[4], float* U[4], int iters,
                           const float* d, int n, int LD) {
  float* S = T[0];
  float* dS = U[0];
  if (iters == 0) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) S[i * LD + i] += 1.0f;
    __syncthreads();
    return;
  }
  float* m = T[1];
  float* c = T[2];
  float* nm = T[3];
  float* dm = U[1];
  float* dc = U[2];
  float* dnm = U[3];
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n;
    const int idx = i * LD + e - i * n;
    m[idx] = S[idx] + ((e - i * n) == i ? 1.0f : 0.0f);
    dm[idx] = dS[idx];
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const Job a[2] = {job(S, m, c, E_NS, m), tjob(dS, m, S, dm, dc, E_NEG, dm)};
    phase<1>(a, 2, nullptr, 0, d, Beam{}, n, LD);
    const Job b[2] = {job(m, c, nm), tjob(dm, c, m, dc, dnm)};
    phase<1>(b, 2, nullptr, 0, d, Beam{}, n, LD);
    float* tmp = m;
    m = nm;
    nm = tmp;
    tmp = dm;
    dm = dnm;
    dnm = tmp;
  }
  T[0] = m;
  T[1] = S;
  T[2] = c;
  T[3] = nm;
  U[0] = dm;
  U[1] = dS;
  U[2] = dc;
  U[3] = dnm;
}

template <int K>
__global__ void __launch_bounds__(VSM_THREADS, 1) mt_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, C = a.C, s = a.s;
  const int LD = (N + 3) & ~3;           // float4-aligned rows
  const int MS = N * LD;
  const int NN = N * N;
  const int NK = N * K;
  const int VS = (NK + 3) & ~3;          // stride of an (N, K) vector
  const int pt = blockIdx.x;             // spectral point of this block
  const int q = blockIdx.y;              // tangent of this block
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  float* Rmp = smem;
  float* Rpm = smem + MS;
  float* Tpp = smem + 2 * MS;
  float* Tmm = smem + 3 * MS;
  float* r = smem + 4 * MS;
  float* t = smem + 5 * MS;
  float* T[4] = {smem + 6 * MS, smem + 7 * MS, smem + 8 * MS, smem + 9 * MS};
  float* dRmp = smem + 10 * MS;
  float* dRpm = smem + 11 * MS;
  float* dTpp = smem + 12 * MS;
  float* dTmm = smem + 13 * MS;
  float* dr = smem + 14 * MS;
  float* dt = smem + 15 * MS;
  float* U[4] = {smem + 16 * MS, smem + 17 * MS, smem + 18 * MS,
                 smem + 19 * MS};
  float* V = smem + VSM_NMAT * MS;
  float* Jp = V;
  float* Jm = V + VS;
  float* jp = V + 2 * VS;
  float* jm = V + 3 * VS;
  float* va = V + 4 * VS;
  float* vb = V + 5 * VS;
  float* vc = V + 6 * VS;
  float* dJp = V + 7 * VS;
  float* dJm = V + 8 * VS;
  float* djp = V + 9 * VS;
  float* djm = V + 10 * VS;
  float* dva = V + 11 * VS;
  float* dvb = V + 12 * VS;
  float* dvc = V + 13 * VS;
  float* sE = V + VSM_NVEC * VS;         // Em1 row of the layer
  float* dE = sE + LD;                   // its tangent
  float* sd = dE + LD;                   // D diagonal

  // This block's tangent operands.
  const size_t qn = static_cast<size_t>(q);
  const float* dZpp = a.dZpp + qn * C * NN;
  const float* dZmp = a.dZmp + qn * C * NN;
  const float* dw = a.dw + qn * a.nz * C * s;
  const float* dEm1 = a.dEm1 + qn * a.nz * s * N;
  const float* ddt = a.ddt + qn * a.nz * s;
  const float* djpq = a.djp + qn * a.nz * s * NK;
  const float* djmq = a.djms + qn * a.nz * s * NK;
  const float* dekq = a.dek + qn * a.nz * s * K;

  // Vacuum composite (R = 0, T = I, J = 0); its tangent is zero.
  for (int e = tid; e < NN; e += nt) {
    const int i = e / N;
    const int j = e - i * N;
    const int idx = i * LD + j;
    Rmp[idx] = 0.0f;
    Rpm[idx] = 0.0f;
    Tpp[idx] = (i == j) ? 1.0f : 0.0f;
    Tmm[idx] = (i == j) ? 1.0f : 0.0f;
    dRmp[idx] = 0.0f;
    dRpm[idx] = 0.0f;
    dTpp[idx] = 0.0f;
    dTmm[idx] = 0.0f;
  }
  for (int e = tid; e < NK; e += nt) {
    Jp[e] = 0.0f;
    Jm[e] = 0.0f;
    dJp[e] = 0.0f;
    dJm[e] = 0.0f;
  }
  for (int i = tid; i < N; i += nt) sd[i] = a.dvec[i];

  const float* RG = a.geom;
  const float* GA = a.geom + NN;
  const float* TO = a.geom + 2 * NN;
  const float* TS = a.geom + 3 * NN;

  for (int z = 0; z < a.nz; ++z) {
    const size_t zs = static_cast<size_t>(z) * s + pt;
    __syncthreads();
    for (int i = tid; i < N; i += nt) {
      sE[i] = a.Em1[zs * N + i];
      dE[i] = dEm1[zs * N + i];
    }
    for (int e = tid; e < NK; e += nt) {
      jp[e] = a.jp[zs * NK + e];
      jm[e] = a.jms[zs * NK + e];
      djp[e] = djpq[zs * NK + e];
      djm[e] = djmq[zs * NK + e];
    }
    const float dtz = a.dt[zs];
    const float ddtz = ddt[zs];
    Beam bm{};
#pragma unroll
    for (int c = 0; c < K; ++c) {
      bm.ek[c] = a.ek[zs * K + c];
      bm.dek[c] = dekq[zs * K + c];
    }
    __syncthreads();

    // ---- elemental assembly and its tangent: r* = D r-+, t++ ----
    for (int e = tid; e < NN; e += nt) {
      const int i = e / N;
      const int j = e - i * N;
      const int idx = i * LD + j;
      float wpp = 0.0f, wmp = 0.0f, dwpp = 0.0f, dwmp = 0.0f;
      for (int c = 0; c < C; ++c) {
        const size_t wi = (static_cast<size_t>(z) * C + c) * s + pt;
        const float wc = a.w[wi], dwc = dw[wi];
        const float zpp = a.Zpp[c * NN + e], zmp = a.Zmp[c * NN + e];
        wpp = fmaf(wc, zpp, wpp);
        wmp = fmaf(wc, zmp, wmp);
        dwpp = fmaf(dwc, zpp, fmaf(wc, dZpp[c * NN + e], dwpp));
        dwmp = fmaf(dwc, zmp, fmaf(wc, dZmp[c * NN + e], dwmp));
      }
      const float em_i = sE[i], em_j = sE[j];
      const float dem_i = dE[i], dem_j = dE[j];
      const float Ei = 1.0f + em_i, Ej = 1.0f + em_j;
      const float one_m_EE = -(em_i + em_j + em_i * em_j);
      const float d_one_m_EE = -(dem_i + dem_j + dem_i * em_j + em_i * dem_j);
      const float rg = sd[i] * RG[e];
      r[idx] = sd[i] * wmp * RG[e] * one_m_EE;
      dr[idx] = rg * (dwmp * one_m_EE + wmp * d_one_m_EE);
      const float x = dtz * GA[e];
      const float ex = expm1f(x);
      const float to = TO[e], ts = TS[e];
      const float g = ex * Ej * to + (dtz * ts) * Ej;
      const float dg = (1.0f + ex) * GA[e] * ddtz * Ej * to + ex * dem_j * to +
                       ddtz * ts * Ej + dtz * ts * dem_j;
      t[idx] = wpp * g + (i == j ? Ei : 0.0f);
      dt[idx] = dwpp * g + wpp * dg + (i == j ? dem_i : 0.0f);
    }
    __syncthreads();

    // ---- doubling ladder on starred operators, primal and tangent ----
    for (int step = 0; step < a.ndoubl; ++step) {
      // S = r r and its tangent; jm_e = jm ek and its tangent.
      for (int e = tid; e < NK; e += nt) {
        const float ek = column(bm.ek, e % K);
        va[e] = jm[e] * ek;
        dva[e] = djm[e] * ek + jm[e] * column(bm.dek, e % K);
      }
      const Job p1[2] = {job(r, r, T[0]), tjob(dr, r, r, dr, U[0])};
      phase<K>(p1, 2, nullptr, 0, sd, bm, N, LD);
      ns_inverse(T, U, a.sched[step], sd, N, LD);   // T[0] = gp, U[0] = dgp
      // tt_gp = t gp -> T1; rt = r t -> T2; vb = jm_e + r jp; vc = jp + r jm_e
      const Job p2m[4] = {job(t, T[0], T[1]), tjob(dt, T[0], t, U[0], U[1]),
                          job(r, t, T[2]), tjob(dr, t, r, dt, U[2])};
      const Job p2v[4] = {job(r, jp, vb, E_ADD, va), job(r, va, vc, E_ADD, jp),
                          tjob(dr, jp, r, djp, dvb, E_ADD, dva),
                          tjob(dr, va, r, dva, dvc, E_ADD, djp)};
      phase<K>(p2m, 4, p2v, 4, sd, bm, N, LD);
      // t' = tt_gp t -> T3; r += tt_gp rt; jm += tt_gp vb; and tangents.
      // The tangent of jp' = jp ek + tt_gp vc reads the old jp, so the
      // primal jp is updated in a phase of its own afterwards.
      const Job p3m[4] = {job(T[1], t, T[3]), job(T[1], T[2], r, E_ACC),
                          tjob(U[1], t, T[1], dt, U[3]),
                          tjob(U[1], T[2], T[1], U[2], dr, E_ACC)};
      const Job p3v[3] = {job(T[1], vb, jm, E_ACC),
                          tjob(U[1], vb, T[1], dvb, djm, E_ACC),
                          tjob(U[1], vc, T[1], dvc, djp, E_EKT, jp)};
      phase<K>(p3m, 4, p3v, 3, sd, bm, N, LD);
      const Job p4v[1] = {job(T[1], vc, jp, E_EK)};
      phase<K>(nullptr, 0, p4v, 1, sd, bm, N, LD);
      float* tmp = t;
      t = T[3];
      T[3] = tmp;
      tmp = dt;
      dt = U[3];
      U[3] = tmp;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        bm.dek[c] = 2.0f * bm.ek[c] * bm.dek[c];
        bm.ek[c] *= bm.ek[c];
      }
    }

    // ---- unstar: r-+ = D r*, j0- = D j-* ----
    for (int e = tid; e < NN; e += nt) {
      const int i = e / N;
      const int idx = i * LD + e - i * N;
      r[idx] *= sd[i];
      dr[idx] *= sd[i];
    }
    for (int e = tid; e < NK; e += nt) {
      jm[e] *= sd[e / K];
      djm[e] *= sd[e / K];
    }
    __syncthreads();

    // ---- adding onto the composite, primal and tangent ----
    const Job i1[2] = {job(r, Rpm, T[0]), tjob(dr, Rpm, r, dRpm, U[0])};
    phase<K>(i1, 2, nullptr, 0, sd, Beam{}, N, LD);      // r-+ R+-
    ns_inverse(T, U, a.ns_inter, sd, N, LD);              // T[0] = inv1
    // T01_inv = T-- inv1 -> T1; rT = r T++ -> T2; u = inv1 r -> T3;
    // va = j0- + r J+
    const Job i2m[6] = {job(Tmm, T[0], T[1]),
                        tjob(dTmm, T[0], Tmm, U[0], U[1]),
                        job(r, Tpp, T[2]), tjob(dr, Tpp, r, dTpp, U[2]),
                        job(T[0], r, T[3]), tjob(U[0], r, T[0], dr, U[3])};
    const Job i2v[2] = {job(r, Jp, va, E_ADD, jm),
                        tjob(dr, Jp, r, dJp, dva, E_ADD, djm)};
    product<K>(i2m, 6, i2v, 2, sd, Beam{}, N, LD);
    for (int e = tid; e < NN; e += nt) {                  // t-- = D t D
      const int i = e / N;
      const int j = e - i * N;
      const float sg = sd[i] * sd[j];
      t[i * LD + j] *= sg;
      dt[i * LD + j] *= sg;
    }
    __syncthreads();
    // T-- = T01_inv t--; R-+ += T01_inv rT; J- += T01_inv va
    const Job i3m[4] = {job(T[1], t, Tmm), tjob(U[1], t, T[1], dt, dTmm),
                        job(T[1], T[2], Rmp, E_ACC),
                        tjob(U[1], T[2], T[1], U[2], dRmp, E_ACC)};
    const Job i3v[2] = {job(T[1], va, Jm, E_ACC),
                        tjob(U[1], va, T[1], dva, dJm, E_ACC)};
    phase<K>(i3m, 4, i3v, 2, sd, Beam{}, N, LD);
    // Ru = R+- u -> T0; Rt = R+- t-- -> T1; vb = J+ + R+- j0-
    const Job i4m[4] = {job(Rpm, T[3], T[0]),
                        tjob(dRpm, T[3], Rpm, U[3], U[0]),
                        job(Rpm, t, T[1]), tjob(dRpm, t, Rpm, dt, U[1])};
    const Job i4v[2] = {job(Rpm, jm, vb, E_ADD, Jp),
                        tjob(dRpm, jm, Rpm, djm, dvb, E_ADD, dJp)};
    phase<K>(i4m, 4, i4v, 2, sd, Beam{}, N, LD);
    for (int e = tid; e < NN; e += nt) {                  // back to t++
      const int i = e / N;
      const int j = e - i * N;
      const float sg = sd[i] * sd[j];
      t[i * LD + j] *= sg;
      dt[i * LD + j] *= sg;
    }
    __syncthreads();
    // T21_inv = t++ + t++ Ru -> T2
    const Job i5m[2] = {job(t, T[0], T[2], E_ADD, t),
                        tjob(dt, T[0], t, U[0], U[2], E_ADD, dt)};
    phase<K>(i5m, 2, nullptr, 0, sd, Beam{}, N, LD);
    // T++ = T21_inv T++ -> T3; R+- = D r-+ D + T21_inv Rt; J+ = j0+ + T21 vb
    const Job i6m[4] = {job(T[2], Tpp, T[3]),
                        tjob(U[2], Tpp, T[2], dTpp, U[3]),
                        job(T[2], T[1], Rpm, E_SGN, r),
                        tjob(U[2], T[1], T[2], U[1], dRpm, E_SGN, dr)};
    const Job i6v[2] = {job(T[2], vb, Jp, E_ADD, jp),
                        tjob(U[2], vb, T[2], dvb, dJp, E_ADD, djp)};
    phase<K>(i6m, 4, i6v, 2, sd, Beam{}, N, LD);
    float* tmp = Tpp;
    Tpp = T[3];
    T[3] = tmp;
    tmp = dTpp;
    dTpp = U[3];
    U[3] = tmp;
  }
  __syncthreads();

  const size_t mo = (qn * s + pt) * NN;
  const size_t vo = (qn * s + pt) * NK;
  for (int e = tid; e < NN; e += nt) {
    const int i = e / N;
    const int idx = i * LD + e - i * N;
    a.tRmp[mo + e] = dRmp[idx];
    a.tRpm[mo + e] = dRpm[idx];
    a.tTpp[mo + e] = dTpp[idx];
    a.tTmm[mo + e] = dTmm[idx];
    if (q == 0) {
      const size_t po = static_cast<size_t>(pt) * NN + e;
      a.Rmp[po] = Rmp[idx];
      a.Rpm[po] = Rpm[idx];
      a.Tpp[po] = Tpp[idx];
      a.Tmm[po] = Tmm[idx];
    }
  }
  for (int e = tid; e < NK; e += nt) {
    a.tJp[vo + e] = dJp[e];
    a.tJm[vo + e] = dJm[e];
    if (q == 0) {
      a.Jp[static_cast<size_t>(pt) * NK + e] = Jp[e];
      a.Jm[static_cast<size_t>(pt) * NK + e] = Jm[e];
    }
  }
}

size_t smem_floats(int N, int K) {
  const int LD = (N + 3) & ~3;
  const int VS = (N * K + 3) & ~3;
  return static_cast<size_t>(VSM_NMAT) * N * LD +
         static_cast<size_t>(VSM_NVEC) * VS + 3 * static_cast<size_t>(LD);
}

}  // namespace

extern "C" {

size_t vsm_fused_moment_mt_smem_bytes(int N, int K) {
  return smem_floats(N, K) * sizeof(float);
}

const char* vsm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches K2 on `stream` and returns cudaGetLastError() (0 on success).
// All pointers are device pointers except `sched` (host, ndoubl entries).
int vsm_fused_moment_mt_f32(
    const float* Zpp, const float* Zmp, const float* geom, const float* dvec,
    const float* w, const float* Em1, const float* dt, const float* jp,
    const float* jms, const float* ek, const float* dZpp, const float* dZmp,
    const float* dw, const float* dEm1, const float* ddt, const float* djp,
    const float* djms, const float* dek, float* Rmp, float* Rpm, float* Tpp,
    float* Tmm, float* Jp, float* Jm, float* tRmp, float* tRpm, float* tTpp,
    float* tTmm, float* tJp, float* tJm, int s, int N, int C, int K, int nz,
    int P, int ndoubl, const int* sched, int ns_inter, void* stream) {
  if (N < 1 || N > VSM_MAX_N || K < 1 || K > VSM_MAX_K || C < 1 || s < 0 ||
      nz < 0 || P < 1 || P > 65535 || ndoubl < 0 || ndoubl > VSM_MAX_DOUBL ||
      ns_inter < 0)
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
  a.dZpp = dZpp;
  a.dZmp = dZmp;
  a.dw = dw;
  a.dEm1 = dEm1;
  a.ddt = ddt;
  a.djp = djp;
  a.djms = djms;
  a.dek = dek;
  a.Rmp = Rmp;
  a.Rpm = Rpm;
  a.Tpp = Tpp;
  a.Tmm = Tmm;
  a.Jp = Jp;
  a.Jm = Jm;
  a.tRmp = tRmp;
  a.tRpm = tRpm;
  a.tTpp = tTpp;
  a.tTmm = tTmm;
  a.tJp = tJp;
  a.tJm = tJm;
  a.s = s;
  a.N = N;
  a.C = C;
  a.nz = nz;
  a.P = P;
  a.ndoubl = ndoubl;
  a.ns_inter = ns_inter;
  for (int i = 0; i < VSM_MAX_DOUBL; ++i) a.sched[i] = i < ndoubl ? sched[i] : 0;
  const size_t smem = vsm_fused_moment_mt_smem_bytes(N, K);
  void (*kernel)(const Args) = K == 1 ? mt_kernel<1> : mt_kernel<2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s > 0)
    kernel<<<dim3(s, P), VSM_THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
