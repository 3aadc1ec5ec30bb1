"""Domke-PCW Greek decomposition of Mie scattering matrices.

Counterpart of the JAX package's ``scattering/pcw.py`` (the same NumPy
f64 host code). Behavioral reference: vSmartMOM.jl
src/Scattering/compute_PCW.jl (Sanghavi 2014, "Revisiting the Fourier
expansion of Mie scattering matrices in generalized spherical functions",
JQSRT 136, Eqs. 22-24).

Instead of projecting the angle-space scattering matrix onto generalized
spherical functions (the NAI-2 route, mie.py), PCW evaluates the Greek
coefficients *directly* from size-distribution-averaged Mie coefficient
cross-products <a_n* a_m> etc. and precomputed Wigner 3j tables — an exact
algebraic identity, so NAI2 == PCW is a strong cross-check of both.

Redesign notes: the reference memoizes full 3-D (m, n, l) Wigner tables
(O(4 N^3) memory — gigabytes at coastal-aerosol sizes); here the l loop
streams 2-D per-l tables (wigner.wigner_AB_for_l) and evaluates all five
S_l^{nu1 nu2} sums as masked array contractions. Host f64 setup work.

As in the JAX package, no model build reads ``ScatteringParams.
decomp_type``: the builds take the NAI-2 route (``mie.py``), and PCW is a
library function.
"""

import numpy as np

from .greek import GreekCoefs
from .mie import (Aerosol, AerosolOptics, compute_mie_ab, gauleg_log,
                  get_n_max)
from .wigner import wigner_AB_for_l


def _avg_anbn_products(an, bn, wx):
    """Size-distribution-averaged cross products, full (N, N) matrices:
    M_aa[n, m] = sum_i w_i conj(a_n) a_m (etc.) — the reference's
    lower-triangular mat_anam (compute_avg_anbns!, mie_helper_functions.jl:273)
    extended to both triangles."""
    aw = wx[:, None] * an
    bw = wx[:, None] * bn
    M_aa = an.conj().T @ aw
    M_ab = an.conj().T @ bw
    M_ba = bn.conj().T @ aw
    M_bb = bn.conj().T @ bw
    return M_aa, M_ab, M_ba, M_bb


def compute_greek_coefs_pcw(an, bn, wx, k_wav, avg_C_scatt,
                            l_max: int = None) -> GreekCoefs:
    """Greek coefficients from Mie coefficients via the PCW identity.

    an/bn: (n_radii, N_max) Mie coefficients; wx: normalized size weights.
    Returns GreekCoefs with l = 0..l_max-1 (default 2 N_max - 1 entries,
    the reference's ls = 1:(2 N_max - 1), compute_PCW.jl:59).
    """
    N_max = an.shape[1]
    if l_max is None:
        l_max = 2 * N_max - 1

    M_aa, M_ab, M_ba, M_bb = _avg_anbn_products(an, bn, wx)
    an_m_bn = (np.abs(an - bn) ** 2 * wx[:, None]).sum(axis=0)   # (N,)
    an_p_bn = (np.abs(an + bn) ** 2 * wx[:, None]).sum(axis=0)

    ns = np.arange(1, N_max + 1, dtype=np.float64)
    two_n1 = 2.0 * ns + 1.0
    # pair coefficient 2 (2n+1)(2m+1) over (n, m)
    pair_coef = 2.0 * two_n1[:, None] * two_n1[None, :]
    # sum combinations used by the S terms, indexed [n, m]
    sum_pp = (M_aa + M_ab + M_ba + M_bb).real          # (a+b)*(a+b)
    sum_mm = (M_aa - M_ab - M_ba + M_bb).real          # (a-b)*(a-b)
    cross = M_aa + M_ba - M_ab - M_bb                  # (a+b)* (a-b), complex
    cross_swap = np.conj(M_aa - M_ba + M_ab - M_bb)    # conj[(a-b)* (a+b)]

    greek = np.zeros((6, l_max))
    n_idx = np.arange(1, N_max + 1)
    diag = np.arange(N_max)

    for l_idx in range(1, l_max + 1):
        ll = l_idx - 1
        A_l, B_l = wigner_AB_for_l(ll, N_max)
        # tables at (m, n) with m, n in 1..N_max -> [n, m] orientation
        A = A_l[1:N_max + 1, 1:].T                     # [n, m]
        B = B_l[1:N_max + 1, 1:].T

        # pair mask: m in [max(ll-n, n+1), min(ll+n, N_max)]
        m_lo = np.maximum(ll - n_idx, n_idx + 1)
        mask = (n_idx[None, :] >= m_lo[:, None]) \
            & (n_idx[None, :] <= ll + n_idx[:, None])  # [n, m]
        parity = np.where((ll + n_idx[:, None] + n_idx[None, :]) % 2 == 0,
                          1.0, -1.0)
        sgn_l = 1.0 if ll % 2 == 0 else -1.0

        A2 = A * A
        B2 = B * B
        AB = A * B
        pcA2 = pair_coef * A2
        pcB2 = pair_coef * B2

        A2_d = A2[diag, diag]
        B2_d = B2[diag, diag]
        AB_d = AB[diag, diag]

        S00 = (sum_pp * pcA2)[mask].sum() \
            + (an_p_bn * two_n1 ** 2 * A2_d).sum()
        S0m0 = (sum_mm * parity * pcA2)[mask].sum() \
            + sgn_l * (an_m_bn * two_n1 ** 2 * A2_d).sum()
        S22 = (sum_pp * pcB2)[mask].sum() \
            + (an_p_bn * two_n1 ** 2 * B2_d).sum()
        S2m2 = (sum_mm * parity * pcB2)[mask].sum() \
            + sgn_l * (an_m_bn * two_n1 ** 2 * B2_d).sum()
        avg02 = parity * cross + cross_swap
        S02 = (avg02 * pair_coef * AB)[mask].sum() \
            + ((M_aa - M_ab + M_ba - M_bb)[diag, diag]
               * 2.0 * two_n1 ** 2 * AB_d).sum()

        coef = (2.0 * ll + 1.0) * np.pi / (k_wav ** 2 * avg_C_scatt)
        greek[0, ll] = coef * (S00 + S0m0).real        # beta
        greek[1, ll] = coef * (S00 - S0m0).real        # delta
        greek[2, ll] = coef * (S22 + S2m2).real        # alpha
        greek[3, ll] = coef * (S22 - S2m2).real        # zeta
        greek[4, ll] = coef * S02.real                 # gamma
        greek[5, ll] = coef * S02.imag                 # epsilon

    return GreekCoefs(alpha=greek[2], beta=greek[0], gamma=greek[4],
                      delta=greek[1], epsilon=greek[5], zeta=greek[3])


def compute_aerosol_optical_properties_pcw(
        aerosol: Aerosol, lam: float, r_max: float,
        nquad_radius: int, l_max: int = None) -> AerosolOptics:
    """PCW bulk aerosol optics (reference compute_PCW.jl:29-117): same size
    quadrature / Mie coefficients as the NAI-2 path, Greek coefficients via
    the Wigner identity."""
    dist = aerosol.size_distribution
    r_min = max(dist.quantile(1e-8), 1e-6 * r_max)
    r, wr = gauleg_log(nquad_radius, r_min, r_max)
    k_wav = 2 * np.pi / lam
    x = k_wav * r
    n_max = get_n_max(np.max(x))

    m_ref = aerosol.n_r - 1j * aerosol.n_i
    an, bn = compute_mie_ab(x, m_ref, n_max)

    wx = dist.pdf(r) * wr
    wx /= wx.sum()

    ns = np.arange(1, n_max + 1)
    two_n1 = 2.0 * ns + 1.0
    C_sca = 2 * np.pi / k_wav ** 2 * ((np.abs(an) ** 2 + np.abs(bn) ** 2)
                                      @ two_n1)
    C_ext = 2 * np.pi / k_wav ** 2 * (np.real(an + bn) @ two_n1)
    bulk_C_sca = float(np.sum(wx * C_sca))
    bulk_C_ext = float(np.sum(wx * C_ext))

    greek = compute_greek_coefs_pcw(an, bn, wx, k_wav, bulk_C_sca,
                                    l_max=l_max)
    return AerosolOptics(greek_coefs=greek, ssa=bulk_C_sca / bulk_C_ext,
                         k=bulk_C_ext, f_trunc=1.0)
