"""Mie aerosol optical properties — Siewert NAI-2 formulation.

Counterpart of ``vsmartmom_tpu/scattering/mie.py`` (the same NumPy f64
host code). Behavioral reference: vSmartMOM.jl src/Scattering/
{compute_NAI2.jl, mie_helper_functions.jl, truncate_phase.jl,
analytic_phase_functions.jl}.

For a log-normal (or arbitrary scipy) size distribution this computes:
  1. bulk extinction/scattering cross-sections and single-scattering albedo,
  2. the Greek expansion (alpha..zeta) of the polarized scattering matrix in
     the Hovenier basis via Gauss-angle projection (Sanghavi 2014, Eq. 17),
  3. the delta-BGE forward-peak truncation factor f_t (Sanghavi & Stephens
     2015) when requested.

All host-side float64 NumPy; the reference's per-radius scalar loops are
vectorized over the radius quadrature (recursions run over the Mie order,
broadcast across radii), and S1/S2 assembly is a matrix product.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .greek import GreekCoefs
from .legendre import compute_legendre_poly, compute_mie_pi_tau


@dataclass
class SizeDistribution:
    """Log-normal size distribution LogNormal(mu_log, sigma_log) in radius
    (Julia Distributions.jl convention: mu/sigma are the log-space params)."""
    mu_log: float
    sigma_log: float

    def __post_init__(self):
        if not self.sigma_log > 0:
            raise ValueError(
                "log-normal sigma_log must be > 0 (a geometric sigma of "
                "exactly 1 is a zero-width distribution)")

    # scipy.stats is imported where it is used: it takes seconds to load,
    # which every process that imports the port (a spawned rank) would pay.
    def pdf(self, r):
        from scipy import stats
        return stats.lognorm.pdf(r, s=self.sigma_log, scale=np.exp(self.mu_log))

    def quantile(self, q):
        from scipy import stats
        return stats.lognorm.ppf(q, s=self.sigma_log, scale=np.exp(self.mu_log))


@dataclass
class Aerosol:
    """Size distribution + complex refractive index (convention n_i >= 0)."""
    size_distribution: SizeDistribution
    n_r: float
    n_i: float


@dataclass
class AerosolOptics:
    """Reference Scattering/types.jl:418-429."""
    greek_coefs: GreekCoefs
    ssa: float                  # omega-tilde = C_sca / C_ext
    k: float                    # bulk extinction cross-section
    f_trunc: float              # delta-M truncation factor (0 = untruncated)


def get_n_max(x: float) -> int:
    """Wiscombe/de Rooij-Stap series bound (mie_helper_functions.jl:22)."""
    if x > 8.0:
        return round(x + 4.05 * x ** (1 / 3) + 10)
    return round(x + 4.0 * x ** (1 / 3) + 1)


def gauleg_log(n: int, r_min: float, r_max: float):
    """Gauss-Legendre nodes equidistant in ln(r), Jacobian-weighted
    (mie_helper_functions.jl:369-379)."""
    xi, w = np.polynomial.legendre.leggauss(n)
    ln_lo, ln_hi = np.log(r_min), np.log(r_max)
    r = np.exp(0.5 * (ln_hi - ln_lo) * xi + 0.5 * (ln_hi + ln_lo))
    return r, w * r * (ln_hi - ln_lo) / 2.0


def compute_mie_ab(x, m_ref: complex, n_max: int):
    """Mie coefficients a_n, b_n for size parameters ``x`` (vector) at complex
    refractive index ``m_ref`` (BH eq. 4.88; downward log-derivative
    recursion per de Rooij & Stap 1984 eq. A9 — mie_helper_functions.jl:42-88).

    Vectorized over radii: the order recursions run serially over n with all
    radii advanced per step. Entries with n > n_max(x_i) are zeroed (the
    upward Riccati-Bessel recursion is unstable past the series bound).

    Returns (an, bn) with shape (len(x), n_max), complex128.
    """
    x = np.asarray(x, dtype=np.float64)
    nr = len(x)
    y = x * m_ref

    n_max_i = np.array([get_n_max(xi) for xi in x])
    nmx = int(max(n_max, np.max(np.abs(y))) + 51)

    # Downward recursion for the logarithmic derivative D_n(y).
    Dn = np.zeros((nr, n_max + 1), dtype=np.complex128)
    D_prev = np.zeros(nr, dtype=np.complex128)
    for n in range(nmx - 1, 0, -1):
        ratio = (n + 1) / y
        D_prev = ratio - 1.0 / (D_prev + ratio)
        if n <= n_max:
            Dn[:, n] = D_prev

    an = np.zeros((nr, n_max), dtype=np.complex128)
    bn = np.zeros((nr, n_max), dtype=np.complex128)

    psi0, psi1 = np.cos(x), np.sin(x)
    chi0, chi1 = -np.sin(x), np.cos(x)
    xi1 = psi1 + 1j * chi1
    # Clamp the (exponentially growing past n ~ x) chi recursion so it never
    # overflows; clamped entries correspond to n > n_max(x_i) and are masked.
    CLAMP = 1e250
    for n in range(1, n_max + 1):
        psi = (2 * n - 1) * psi1 / x - psi0
        chi = (2 * n - 1) * chi1 / x - chi0
        psi = np.clip(psi, -CLAMP, CLAMP)
        chi = np.clip(chi, -CLAMP, CLAMP)
        xi = psi + 1j * chi
        t_a = Dn[:, n] / m_ref + n / x
        t_b = Dn[:, n] * m_ref + n / x
        valid = n <= n_max_i
        with np.errstate(invalid="ignore", over="ignore"):
            an[:, n - 1] = np.where(valid, (t_a * psi - psi1) / (t_a * xi - xi1), 0)
            bn[:, n - 1] = np.where(valid, (t_b * psi - psi1) / (t_b * xi - xi1), 0)
        psi0, psi1 = psi1, psi
        chi0, chi1 = chi1, chi
        xi1 = psi1 + 1j * chi1
    return an, bn


def greek_from_scattering_matrix(mu, w, f11, f12, f33, f34,
                                 l_max: Optional[int] = None) -> GreekCoefs:
    """Project angle-space scattering-matrix elements onto Greek coefficients
    (Sanghavi 2014 Eq. 17; compute_NAI2.jl:179-202 — spherical particles,
    so f22 = f11, f44 = f33)."""
    mu = np.asarray(mu)
    if l_max is None:
        l_max = len(mu)
    P, P2, R2, T2 = compute_legendre_poly(mu, l_max)
    ls = np.arange(l_max)
    half = (2 * ls + 1) / 2.0
    with np.errstate(divide="ignore"):
        fac = np.where(ls >= 2,
                       half / np.sqrt(np.maximum(1.0, (ls - 1.0) * ls * (ls + 1.0) * (ls + 2.0))),
                       0.0)
    wf = w
    beta = half * ((wf * f11) @ P)
    delta = half * ((wf * f33) @ P)
    gamma = fac * ((wf * f12) @ P2)
    eps = fac * ((wf * f34) @ P2)
    zeta = fac * ((wf * f33) @ R2 + (wf * f11) @ T2)
    alpha = fac * ((wf * f11) @ R2 + (wf * f33) @ T2)
    return GreekCoefs(alpha, beta, gamma, delta, eps, zeta)


def compute_aerosol_optical_properties(aerosol: Aerosol, lam: float,
                                       r_max: float, nquad_radius: int) -> AerosolOptics:
    """NAI-2 bulk optics + Greek coefficients (compute_NAI2.jl:63-217).

    ``lam`` and radii in the same length unit (micron). Returns untruncated
    optics with the reference's f_trunc = 1 'not yet truncated' sentinel —
    pass through truncate_phase before use.
    """
    dist = aerosol.size_distribution
    r_min = max(dist.quantile(1e-8), 1e-6 * r_max)
    r, wr = gauleg_log(nquad_radius, r_min, r_max)
    k_wav = 2 * np.pi / lam
    x = k_wav * r
    n_max = get_n_max(np.max(x))
    n_mu = 2 * n_max - 1
    mu, w_mu = np.polynomial.legendre.leggauss(n_mu)
    leg_pi, leg_tau = compute_mie_pi_tau(mu, n_max)

    m_ref = aerosol.n_r - 1j * aerosol.n_i
    an, bn = compute_mie_ab(x, m_ref, n_max)          # (nr, n_max)

    ns = np.arange(1, n_max + 1)
    two_n1 = 2.0 * ns + 1.0
    C_sca = 2 * np.pi / k_wav ** 2 * ((np.abs(an) ** 2 + np.abs(bn) ** 2) @ two_n1)
    C_ext = 2 * np.pi / k_wav ** 2 * (np.real(an + bn) @ two_n1)

    # S1/S2 amplitudes: (n_mu, nr) via matrix products
    cn = two_n1 / (ns * (ns + 1.0))
    S1 = (leg_tau * cn) @ an.T + (leg_pi * cn) @ bn.T
    S2 = (leg_pi * cn) @ an.T + (leg_tau * cn) @ bn.T

    inv_x2 = 0.5 / x ** 2                              # (nr,)
    f11 = inv_x2 * (np.abs(S1) ** 2 + np.abs(S2) ** 2)
    f33 = inv_x2 * (2.0 * np.real(S1 * np.conj(S2)))
    f12 = -inv_x2 * (np.abs(S1) ** 2 - np.abs(S2) ** 2)
    f34 = -inv_x2 * np.imag(S1 * np.conj(S2) - S2 * np.conj(S1))

    # Size-distribution weights and bulk averages
    wx = dist.pdf(r) * wr
    wx /= wx.sum()
    bulk_C_sca = np.sum(wx * C_sca)
    bulk_C_ext = np.sum(wx * C_ext)
    wr_phase = 4 * np.pi * r ** 2 * wx
    bulk_f11 = f11 @ wr_phase / bulk_C_sca
    bulk_f33 = f33 @ wr_phase / bulk_C_sca
    bulk_f12 = f12 @ wr_phase / bulk_C_sca
    bulk_f34 = f34 @ wr_phase / bulk_C_sca

    greek = greek_from_scattering_matrix(mu, w_mu, bulk_f11, bulk_f12,
                                         bulk_f33, bulk_f34)
    return AerosolOptics(greek_coefs=greek, ssa=bulk_C_sca / bulk_C_ext,
                         k=bulk_C_ext, f_trunc=1.0)


def compute_ref_aerosol_extinction(aerosol: Aerosol, lam: float, r_max: float,
                                   nquad_radius: int) -> float:
    """Bulk extinction only (compute_NAI2.jl:235+), for k_ref scaling."""
    dist = aerosol.size_distribution
    r_min = max(dist.quantile(1e-8), 1e-6 * r_max)
    r, wr = gauleg_log(nquad_radius, r_min, r_max)
    k_wav = 2 * np.pi / lam
    x = k_wav * r
    n_max = get_n_max(np.max(x))
    an, bn = compute_mie_ab(x, aerosol.n_r - 1j * aerosol.n_i, n_max)
    two_n1 = 2.0 * np.arange(1, n_max + 1) + 1.0
    C_ext = 2 * np.pi / k_wav ** 2 * (np.real(an + bn) @ two_n1)
    wx = dist.pdf(r) * wr
    wx /= wx.sum()
    return float(np.sum(wx * C_ext))


# ---------------------------------------------------------------------------
# Phase reconstruction + delta-BGE truncation
# ---------------------------------------------------------------------------

def reconstruct_phase(greek: GreekCoefs, mu):
    """Angle-space scattering matrix from Greek coefficients
    (mie_helper_functions.jl:415-439). Returns dict of f11..f44."""
    l_max = greek.l_max
    P, P2, R2, T2 = compute_legendre_poly(mu, l_max)
    ls = np.arange(l_max)
    with np.errstate(divide="ignore"):
        fac = np.where(ls >= 2,
                       1.0 / np.sqrt(np.maximum(1.0, (ls - 1.0) * ls * (ls + 1.0) * (ls + 2.0))),
                       0.0)
    return {
        "f11": P @ greek.beta,
        "f44": P @ greek.delta,
        "f12": P2 @ (fac * greek.gamma),
        "f34": P2 @ (fac * greek.epsilon),
        "f22": R2 @ (fac * greek.alpha) + T2 @ (fac * greek.zeta),
        "f33": R2 @ (fac * greek.zeta) + T2 @ (fac * greek.alpha),
    }


def truncate_phase_delta_bge(aero: AerosolOptics, l_max: int,
                             delta_angle_deg: float = 2.0) -> AerosolOptics:
    """delta-BGE forward-peak truncation (Sanghavi & Stephens 2015;
    truncate_phase.jl:149-272, the weighted-normal-equations variant).

    Fits l_max-term expansions of f11 (Legendre) and f12/f34 (P^2 basis)
    with relative-error weights w/f^2 over the full angle grid; renormalizes
    by the retained fraction c0 and returns f_t = 1 - c0.
    """
    greek = aero.greek_coefs
    n_mu = greek.l_max
    mu, w = np.polynomial.legendre.leggauss(n_mu)
    f = reconstruct_phase(greek, mu)
    P, P2, _, _ = compute_legendre_poly(mu, l_max)

    ls = np.arange(l_max)
    with np.errstate(divide="ignore"):
        fac = np.where(ls >= 2,
                       1.0 / np.sqrt(np.maximum(1.0, (ls - 1.0) * ls * (ls + 1.0) * (ls + 2.0))),
                       0.0)

    def _fit(basis, y, cols):
        """Weighted normal equations A c = b with weights w / y^2."""
        B = basis[:, cols]
        wy2 = w / y ** 2
        A = (B * wy2[:, None]).T @ B
        b = B.T @ (w / y)
        return np.linalg.solve(A, b)

    cl = _fit(P, f["f11"], slice(0, l_max))
    gamma_t = np.zeros(l_max)
    eps_t = np.zeros(l_max)
    B2 = P2 * fac[None, :]
    gamma_t[2:] = _fit(B2, f["f12"], slice(2, l_max))
    eps_t[2:] = _fit(B2, f["f34"], slice(2, l_max))

    c0 = cl[0]
    beta_t = cl / c0
    delta_t = (greek.delta[:l_max] - (greek.beta[:l_max] - cl)) / c0
    alpha_t = (greek.alpha[:l_max] - (greek.beta[:l_max] - cl)) / c0
    zeta_t = (greek.zeta[:l_max] - (greek.beta[:l_max] - cl)) / c0

    return AerosolOptics(
        greek_coefs=GreekCoefs(alpha_t, beta_t, gamma_t, delta_t, eps_t, zeta_t),
        ssa=aero.ssa, k=aero.k, f_trunc=1.0 - c0)


def truncate_phase_none(aero: AerosolOptics) -> AerosolOptics:
    """NoTruncation passthrough, resetting the raw-Mie f_t = 1 sentinel to 0
    (truncate_phase.jl:16-31)."""
    return AerosolOptics(greek_coefs=aero.greek_coefs, ssa=aero.ssa,
                         k=aero.k, f_trunc=0.0)


# ---------------------------------------------------------------------------
# Analytic phase functions (analytic_phase_functions.jl)
# ---------------------------------------------------------------------------

def hg_phase_function(g: float, cos_theta):
    return (1 - g ** 2) / (1 + g ** 2 - 2 * g * np.asarray(cos_theta)) ** 1.5


def hg_greek_coefficients(g: float, l_max: int = 64,
                          nquad: Optional[int] = None,
                          polarization_fraction: float = 0.0) -> GreekCoefs:
    """Greek projection of (optionally synthetically polarized)
    Henyey-Greenstein (analytic_phase_functions.jl:64-140)."""
    if nquad is None:
        nquad = max(2 * l_max + 1, 64)
    mu, w = np.polynomial.legendre.leggauss(nquad)
    f11 = hg_phase_function(g, mu)
    f12 = polarization_fraction * f11 * (1 - mu ** 2) / (1 + mu ** 2)
    f33 = f11.copy()
    f34 = np.zeros_like(f11)
    return greek_from_scattering_matrix(mu, w, f11, f12, f33, f34, l_max=l_max)


def analytic_aerosol_optics(g: float, ssa: float = 1.0, k: float = 1.0,
                            l_max: int = 64,
                            polarization_fraction: float = 0.0) -> AerosolOptics:
    greek = hg_greek_coefficients(g, l_max=l_max,
                                  polarization_fraction=polarization_fraction)
    return AerosolOptics(greek_coefs=greek, ssa=ssa, k=k, f_trunc=0.0)
