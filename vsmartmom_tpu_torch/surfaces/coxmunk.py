"""Cox-Munk (1954) wind-roughened ocean surface BRDF, fully polarized.

Behavioral reference: vSmartMOM.jl src/CoreRT/Surfaces/coxmunk_surface.jl
(+ fresnel.jl, water_refraction.jl):

* Fresnel reflection from tilted wave facets (full Mueller matrix with
  Stokes rotations, Mishchenko & Travis 1997 / Zhai et al. 2010 geometry)
* isotropic Gaussian slope distribution sigma^2 = 0.003 + 0.00512 U
* Monahan & O'Muircheartaigh (1980) whitecap fraction, Lambertian whitecaps
* Smith (1967) bistatic shadow masking
* Fourier-moment projection by 100-point azimuth quadrature
* TMS single-scatter correction of the truncated glint hotspot

Everything here is host-side float64 NumPy, vectorized over the full
(mu_out, mu_in, phi) geometry grid — the reference's triple scalar loop is
replaced by broadcast arrays, and the expensive Mueller grid is built once
and reused for every Fourier moment. The wind-speed Jacobian rides the same
einsums: ``cox_munk_mueller_wind_tangent`` differentiates the Mueller grid
analytically through sigma^2 and the whitecap fraction.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
from scipy.special import erfc

from ..utils.quadrature import gauleg

# Segelstein (1981) water refractive index table, 200-2600 nm subset
# (data reproduced from the reference's water_refraction.jl table).
_WATER_NM = np.array([
    200., 210., 220., 230., 240., 250., 260., 270., 280., 290.,
    300., 310., 320., 330., 340., 350., 360., 370., 380., 390.,
    400., 410., 420., 430., 440., 450., 460., 470., 480., 490.,
    500., 510., 520., 530., 540., 550., 560., 570., 580., 590.,
    600., 610., 620., 630., 640., 650., 660., 670., 680., 690.,
    700., 720., 740., 760., 780., 800., 820., 840., 860., 880.,
    900., 920., 940., 960., 980., 1000., 1050., 1100., 1150., 1200.,
    1250., 1300., 1350., 1400., 1450., 1500., 1550., 1600., 1650., 1700.,
    1750., 1800., 1850., 1900., 1950., 2000., 2100., 2200., 2300., 2400.,
    2500., 2600.])
_WATER_N = np.array([
    1.396, 1.373, 1.362, 1.354, 1.349, 1.346, 1.343, 1.341, 1.339, 1.338,
    1.337, 1.336, 1.335, 1.335, 1.334, 1.334, 1.333, 1.333, 1.333, 1.332,
    1.332, 1.332, 1.331, 1.331, 1.331, 1.331, 1.330, 1.330, 1.330, 1.330,
    1.329, 1.329, 1.329, 1.329, 1.328, 1.328, 1.328, 1.328, 1.327, 1.327,
    1.327, 1.326, 1.326, 1.326, 1.325, 1.325, 1.325, 1.325, 1.324, 1.324,
    1.324, 1.323, 1.322, 1.322, 1.321, 1.320, 1.319, 1.319, 1.318, 1.317,
    1.316, 1.315, 1.314, 1.313, 1.312, 1.311, 1.308, 1.306, 1.303, 1.300,
    1.296, 1.293, 1.289, 1.285, 1.277, 1.268, 1.261, 1.255, 1.253, 1.255,
    1.260, 1.268, 1.279, 1.295, 1.306, 1.304, 1.279, 1.232, 1.188, 1.147,
    1.131, 1.129])
_WATER_K = np.array([
    1.42e-7, 7.00e-8, 4.00e-8, 2.60e-8, 1.80e-8, 1.40e-8, 1.10e-8, 9.00e-9,
    7.50e-9, 6.50e-9, 6.00e-9, 4.60e-9, 3.50e-9, 2.70e-9, 2.20e-9, 1.80e-9,
    1.60e-9, 1.40e-9, 1.30e-9, 1.30e-9, 1.30e-9, 1.40e-9, 1.50e-9, 1.60e-9,
    1.70e-9, 1.80e-9, 1.90e-9, 2.05e-9, 2.30e-9, 2.69e-9, 3.21e-9, 3.81e-9,
    4.36e-9, 4.78e-9, 5.14e-9, 5.69e-9, 6.49e-9, 7.63e-9, 9.22e-9, 1.09e-8,
    1.26e-8, 1.39e-8, 1.48e-8, 1.55e-8, 1.63e-8, 1.74e-8, 1.91e-8, 2.20e-8,
    2.72e-8, 3.59e-8, 4.78e-8, 7.50e-8, 1.10e-7, 1.43e-7, 1.65e-7, 1.72e-7,
    1.63e-7, 1.46e-7, 1.32e-7, 1.28e-7, 1.38e-7, 1.65e-7, 2.41e-7, 4.42e-7,
    7.40e-7, 1.06e-6, 1.79e-6, 1.65e-6, 1.10e-6, 9.60e-7, 1.32e-6, 2.26e-6,
    4.58e-6, 1.07e-5, 2.94e-5, 5.88e-5, 7.15e-5, 6.71e-5, 5.68e-5, 4.65e-5,
    3.85e-5, 3.44e-5, 3.72e-5, 5.63e-5, 1.27e-4, 2.98e-4, 6.56e-4, 1.14e-3,
    1.67e-3, 1.89e-3, 1.67e-3, 1.19e-3])


def water_refractive_index(lam_nm: float) -> complex:
    """Segelstein-1981 n + i*k; n linear, k log-linear in log(lambda)."""
    loglam = np.log(np.clip(lam_nm, _WATER_NM[0], _WATER_NM[-1]))
    logx = np.log(_WATER_NM)
    n = np.interp(loglam, logx, _WATER_N)
    k = np.exp(np.interp(loglam, logx, np.log(_WATER_K)))
    return complex(n, k)


@dataclass
class CoxMunkSurface:
    """Reference CoreRT/types.jl:525-536."""
    wind_speed: float
    n_water: Optional[complex] = None
    whitecap_albedo: float = 0.22
    include_whitecaps: bool = True
    shadowing: bool = True

    def sigma2(self) -> float:
        return 0.003 + 0.00512 * self.wind_speed

    def get_n_water(self, lam_nm: float = 550.0) -> complex:
        if self.n_water is not None:
            return complex(self.n_water)
        return water_refractive_index(lam_nm)


def whitecap_fraction(U: float) -> float:
    return 0.0 if U <= 0 else 2.95e-6 * U ** 3.52


def whitecap_fraction_dU(U: float) -> float:
    """d f_wc / d wind_speed (Monahan 1980 power law)."""
    return 0.0 if U <= 0 else 3.52 * 2.95e-6 * U ** 2.52


def _smith_lambda(mu, sigma2):
    """Smith (1967) monostatic shadowing integral Lambda(mu), vectorized."""
    mu = np.asarray(mu, dtype=np.float64)
    sin2 = np.maximum(1e-30, 1.0 - mu ** 2)
    cot = mu / np.sqrt(sin2)
    nu = cot / (np.sqrt(2.0) * np.sqrt(sigma2))
    lam = (np.exp(-nu ** 2) / (np.sqrt(2 * np.pi) * nu) - erfc(nu)) / 2.0
    lam = np.maximum(0.0, lam)
    return np.where(mu <= 0, 1e10, lam)


def _smith_lambda_dsigma2(mu, sigma2):
    """d Lambda / d sigma^2 (analytic; reference coxmunk_surface.jl carries
    the sigma^2 chain for its wind Jacobian, coxmunk_surface.jl:61-101).

    Lambda(nu) = (exp(-nu^2)/(sqrt(2 pi) nu) - erfc(nu)) / 2 with
    nu = cot(theta)/(sqrt(2) sigma):
      dLambda/dnu = [-exp(-nu^2)(2 nu^2 + 1)/(sqrt(2 pi) nu^2)
                     + (2/sqrt(pi)) exp(-nu^2)] / 2
      dnu/dsigma2 = -nu / (2 sigma^2).
    Zero where Lambda is clipped (mu <= 0 sentinel, or the lam < 0 clip
    region where nu is huge and the derivative underflows anyway)."""
    mu = np.asarray(mu, dtype=np.float64)
    sin2 = np.maximum(1e-30, 1.0 - mu ** 2)
    cot = mu / np.sqrt(sin2)
    nu = cot / (np.sqrt(2.0) * np.sqrt(sigma2))
    safe_nu = np.where(np.abs(nu) > 1e-30, nu, 1.0)
    e = np.exp(-nu ** 2)
    dlam_dnu = (-e * (2 * nu ** 2 + 1) / (np.sqrt(2 * np.pi) * safe_nu ** 2)
                + (2.0 / np.sqrt(np.pi)) * e) / 2.0
    dnu_ds2 = -nu / (2.0 * sigma2)
    lam_raw = (e / (np.sqrt(2 * np.pi) * safe_nu) - erfc(nu)) / 2.0
    return np.where((mu <= 0) | (lam_raw <= 0), 0.0, dlam_dnu * dnu_ds2)


def fresnel_coefficients(n_rel: complex, cos_ti):
    """Complex amplitude reflection (r_s, r_p); cos_ti array-ok."""
    sin2 = np.maximum(0.0, 1.0 - np.asarray(cos_ti) ** 2)
    cos_tt = np.sqrt(1.0 - sin2 / n_rel ** 2 + 0j)
    r_s = (cos_ti - n_rel * cos_tt) / (cos_ti + n_rel * cos_tt)
    r_p = (n_rel * cos_ti - cos_tt) / (n_rel * cos_ti + cos_tt)
    return r_s, r_p


def fresnel_mueller(r_s, r_p, ns: int):
    """Mueller matrix of Fresnel reflection, shape (..., ns, ns).
    Element layout follows fresnel.jl:50-85 (M[2,3] = -Im(rs rp*),
    M[3,2] = +Im in 0-based rows 2/3)."""
    rs2 = np.abs(r_s) ** 2
    rp2 = np.abs(r_p) ** 2
    hs = (rs2 + rp2) / 2.0
    hd = (rs2 - rp2) / 2.0
    M = np.zeros(hs.shape + (ns, ns))
    M[..., 0, 0] = hs
    if ns >= 2:
        M[..., 0, 1] = hd
        M[..., 1, 0] = hd
        M[..., 1, 1] = hs
    if ns >= 3:
        rsp = r_s * np.conj(r_p)
        M[..., 2, 2] = rsp.real
    if ns == 4:
        M[..., 2, 3] = -rsp.imag
        M[..., 3, 2] = rsp.imag
        M[..., 3, 3] = rsp.real
    return M


def stokes_rotation(phi, ns: int):
    """Stokes reference-plane rotation L(phi), shape (..., ns, ns)
    (fresnel.jl:100-124: L[1,2] = -sin 2phi, L[2,1] = +sin 2phi 0-based)."""
    phi = np.asarray(phi, dtype=np.float64)
    c2, s2 = np.cos(2 * phi), np.sin(2 * phi)
    L = np.zeros(phi.shape + (ns, ns))
    L[..., 0, 0] = 1.0
    if ns >= 2:
        L[..., 1, 1] = c2
    if ns >= 3:
        L[..., 1, 2] = -s2
        L[..., 2, 1] = s2
        L[..., 2, 2] = c2
    if ns == 4:
        L[..., 3, 3] = 1.0
    return L


def _geometry(mu_a, mu_b, dphi):
    """Facet geometry for 'incident' cosines mu_a and 'reflected' mu_b over
    relative azimuths dphi, all broadcastable arrays
    (coxmunk_surface.jl:124-249 coxmunk_geometry, vectorized).

    Returns (cos_beta, cos_theta_local, zx, zy, alpha1, alpha2)."""
    sin_a = np.sqrt(np.maximum(0.0, 1.0 - mu_a ** 2))
    sin_b = np.sqrt(np.maximum(0.0, 1.0 - mu_b ** 2))
    cd, sd = np.cos(dphi), np.sin(dphi)

    nx = -sin_a + sin_b * cd
    ny = sin_b * sd
    nz = mu_a + mu_b
    norm = np.sqrt(nx ** 2 + ny ** 2 + nz ** 2)
    ok = norm >= 1e-15
    safe = np.where(ok, norm, 1.0)
    nx, ny, nz = nx / safe, ny / safe, nz / safe

    cos_beta = np.where(ok, np.maximum(1e-10, nz), 1.0)
    cos_tl = np.where(ok, np.clip((mu_a + mu_b) / (2.0 * cos_beta), 0.0, 1.0), 1.0)
    zx = np.where(ok, -nx / cos_beta, 0.0)
    zy = np.where(ok, -ny / cos_beta, 0.0)

    # Rotation angles between the scattering plane and the facet
    # incidence/reflection planes (Zhai et al. 2010 Appendix A).
    cos_T = -mu_a * mu_b + sin_a * sin_b * cd
    sin_T = np.sqrt(np.maximum(0.0, 1.0 - cos_T ** 2))
    nondeg = sin_T >= 1e-12

    sp_x = -mu_a * sin_b * sd
    sp_y = mu_a * sin_b * cd - sin_a * mu_b
    sp_z = -sin_a * sin_b * sd

    ip_x = mu_a * ny
    ip_y = -mu_a * nx - sin_a * nz
    ip_z = sin_a * ny

    def _angle(px, py, pz, kx, ky, kz):
        dot = sp_x * px + sp_y * py + sp_z * pz
        mag_sp = np.sqrt(sp_x ** 2 + sp_y ** 2 + sp_z ** 2)
        mag_p = np.sqrt(px ** 2 + py ** 2 + pz ** 2)
        good = (mag_sp >= 1e-15) & (mag_p >= 1e-15) & nondeg
        denom = np.where(good, mag_sp * mag_p, 1.0)
        cos_al = np.clip(dot / denom, -1.0, 1.0)
        cx = sp_y * pz - sp_z * py
        cy = sp_z * px - sp_x * pz
        cz = sp_x * py - sp_y * px
        sign = kx * cx + ky * cy + kz * cz
        al = np.where(sign >= 0, np.arccos(cos_al), -np.arccos(cos_al))
        return np.where(good, al, 0.0)

    alpha1 = _angle(ip_x, ip_y, ip_z, sin_a, 0.0, -mu_a)

    rp_x = (-sin_b * sd) * nz - mu_b * ny
    rp_y = mu_b * nx - (-sin_b * cd) * nz
    rp_z = (-sin_b * cd) * ny - (-sin_b * sd) * nx
    alpha2 = _angle(rp_x, rp_y, rp_z, -sin_b * cd, -sin_b * sd, mu_b)

    return cos_beta, cos_tl, zx, zy, alpha1, alpha2


def cox_munk_mueller(surf: CoxMunkSurface, ns: int, mu_a, mu_b, dphi,
                     n_water: Optional[complex] = None):
    """BRDF Mueller matrix (sr^-1) at geometry grid, shape
    broadcast(mu_a, mu_b, dphi) + (ns, ns). Argument roles follow
    coxmunk_brdf_mueller (coxmunk_surface.jl:259-301)."""
    if n_water is None:
        n_water = surf.get_n_water()
    s2 = surf.sigma2()
    mu_a, mu_b, dphi = np.broadcast_arrays(
        np.asarray(mu_a, dtype=np.float64), np.asarray(mu_b, dtype=np.float64),
        np.asarray(dphi, dtype=np.float64))

    cos_beta, cos_tl, zx, zy, a1, a2 = _geometry(mu_a, mu_b, dphi)

    P = np.exp(-(zx ** 2 + zy ** 2) / (2 * s2)) / (2 * np.pi * s2)
    r_s, r_p = fresnel_coefficients(n_water, cos_tl)
    M_F = fresnel_mueller(r_s, r_p, ns)
    L1 = stokes_rotation(-a1, ns)
    L2 = stokes_rotation(a2, ns)
    M_facet = L2 @ M_F @ L1

    pref = P / (4.0 * mu_a * mu_b * cos_beta ** 4)
    if surf.shadowing:
        lam = _smith_lambda(mu_a, s2) + _smith_lambda(mu_b, s2)
        pref = pref / (1.0 + lam)
    glint = pref[..., None, None] * M_facet

    if surf.include_whitecaps:
        f_wc = whitecap_fraction(surf.wind_speed)
        wc = np.zeros((ns, ns))
        wc[0, 0] = surf.whitecap_albedo / np.pi
        return (1.0 - f_wc) * glint + f_wc * wc
    return glint


def cox_munk_mueller_wind_tangent(surf: CoxMunkSurface, ns: int, mu_a, mu_b,
                                  dphi, n_water: Optional[complex] = None):
    """(M, dM/dU): BRDF Mueller matrix and its analytic wind derivative.

    The facet geometry (cos_beta, local incidence, Stokes rotations,
    Fresnel Mueller) is wind-INDEPENDENT; wind enters only through the
    slope variance sigma^2 = 0.003 + 0.00512 U (slope pdf P and Smith
    shadowing) and the whitecap fraction. So

      d glint/dU = glint * [ (zx^2+zy^2)/(2 s2^2) - 1/s2
                             - (dLam_a + dLam_b)/(1 + Lam_a + Lam_b) ]
                   * 0.00512
      dM/dU = (1 - f_wc) d glint/dU + f_wc'(U) (wc - glint).

    Mirrors the reference's analytic sigma^2 chain
    (coxmunk_surface.jl:61-101)."""
    if n_water is None:
        n_water = surf.get_n_water()
    s2 = surf.sigma2()
    mu_a, mu_b, dphi = np.broadcast_arrays(
        np.asarray(mu_a, dtype=np.float64), np.asarray(mu_b, dtype=np.float64),
        np.asarray(dphi, dtype=np.float64))

    cos_beta, cos_tl, zx, zy, a1, a2 = _geometry(mu_a, mu_b, dphi)

    P = np.exp(-(zx ** 2 + zy ** 2) / (2 * s2)) / (2 * np.pi * s2)
    r_s, r_p = fresnel_coefficients(n_water, cos_tl)
    M_F = fresnel_mueller(r_s, r_p, ns)
    L1 = stokes_rotation(-a1, ns)
    L2 = stokes_rotation(a2, ns)
    M_facet = L2 @ M_F @ L1

    pref = P / (4.0 * mu_a * mu_b * cos_beta ** 4)
    dlog_ds2 = (zx ** 2 + zy ** 2) / (2.0 * s2 ** 2) - 1.0 / s2
    if surf.shadowing:
        lam_sum = _smith_lambda(mu_a, s2) + _smith_lambda(mu_b, s2)
        pref = pref / (1.0 + lam_sum)
        dlam_ds2 = (_smith_lambda_dsigma2(mu_a, s2)
                    + _smith_lambda_dsigma2(mu_b, s2))
        dlog_ds2 = dlog_ds2 - dlam_ds2 / (1.0 + lam_sum)
    glint = pref[..., None, None] * M_facet
    dglint_dU = 0.00512 * dlog_ds2[..., None, None] * glint

    if surf.include_whitecaps:
        U = surf.wind_speed
        f_wc = whitecap_fraction(U)
        df_dU = whitecap_fraction_dU(U)
        wc = np.zeros((ns, ns))
        wc[0, 0] = surf.whitecap_albedo / np.pi
        M = (1.0 - f_wc) * glint + f_wc * wc
        dM = (1.0 - f_wc) * dglint_dU + df_dU * (wc - glint)
        return M, dM
    return glint, dglint_dU


N_QUAD_PHI = 100


def _azimuthal_kernels(ns: int, m: int, phi):
    """az[p, si, sj]: cos(m phi) for same-parity Stokes blocks, sin otherwise
    (coxmunk_surface.jl:444-452)."""
    is_iq = np.arange(ns) < 2
    same = np.equal.outer(is_iq, is_iq)
    cosm = np.cos(m * phi)[:, None, None]
    sinm = np.sin(m * phi)[:, None, None]
    return np.where(same[None], cosm, sinm)


def coxmunk_mueller_grid(surf: CoxMunkSurface, ns: int, mu,
                         n_water: Optional[complex] = None,
                         wind_tangent: bool = False):
    """Mueller matrices over the (mu_out, mu_in, phi_quad) grid plus the
    azimuth quadrature: the m-independent part of the Fourier projection,
    computed once and reused for every moment. Returns (M, phi, w); with
    ``wind_tangent`` (M, dM, phi, w), dM the grid's analytic wind-speed
    tangent."""
    phi, w = gauleg(N_QUAD_PHI, 0.0, np.pi)
    mu = np.asarray(mu, dtype=np.float64)
    args = (mu[:, None, None], mu[None, :, None], phi[None, None, :])
    if wind_tangent:
        return (*cox_munk_mueller_wind_tangent(surf, ns, *args,
                                               n_water=n_water), phi, w)
    return cox_munk_mueller(surf, ns, *args, n_water=n_water), phi, w


def coxmunk_reflectance_fourier(M_grid, phi, w, ns: int, m: int):
    """Fourier moment m of the BRDF supermatrix from the precomputed grid.
    Returns the raw (N, N) reflectance matrix (no mu*w quadrature factor,
    no m=0 doubling) — coxmunk_surface.jl:464-491 reflectance()."""
    az = _azimuthal_kernels(ns, m, phi)                    # (P, ns, ns)
    # R[(i,si),(j,sj)] = ff/pi * sum_p w_p M[i,j,p,si,sj] az[p,si,sj]
    R = np.einsum("p,ijpst,pst->isjt", w, M_grid, az, optimize=True)
    nmu = M_grid.shape[0]
    ff = 1.0 if m == 0 else 2.0
    return (ff / np.pi) * R.reshape(nmu * ns, nmu * ns)


def coxmunk_surface_operator_arrays(surf: CoxMunkSurface, quad, ns: int,
                                    n_m: int, wind_tangent: bool = False,
                                    n_water: Optional[complex] = None):
    """(surf_r, surf_j[, d_surf_r, d_surf_j]): the solver's per-moment
    surface operators (incl. the m = 0 factor 2 and diag(mu*w) quadrature
    factor; see model._surface_arrays) and, when requested, their ANALYTIC
    wind-speed tangents — the Fourier projection is linear in the Mueller
    grid, so the tangent rides the same einsum."""
    *grids, phi, w = coxmunk_mueller_grid(surf, ns, quad.qp_mu, n_water,
                                          wind_tangent)
    N = quad.Nquad * ns
    sl = slice(quad.i_mu0_start, quad.i_mu0_start + ns)
    qw = quad.qp_mu_N * quad.wt_mu_N
    outs = []
    for G in grids:
        surf_r = np.zeros((n_m, N, N))
        surf_j = np.zeros((n_m, N, ns))
        for m in range(n_m):
            R_raw = coxmunk_reflectance_fourier(G, phi, w, ns, m)
            if m == 0:
                R_raw = 2.0 * R_raw
            surf_r[m] = R_raw * qw[None, :]
            surf_j[m] = quad.mu0 * R_raw[:, sl]
        outs += [surf_r, surf_j]
    return tuple(outs)


def tms_correction(surf: CoxMunkSurface, ns: int, vza_deg, vaz_deg, mu0,
                   tau_total, m_max: int,
                   n_water: Optional[complex] = None,
                   wind_tangent: bool = False):
    """TMS single-scatter correction of the truncated specular hotspot
    (coxmunk_surface.jl:509-569). Returns (nVZA, ns, nSpec) to ADD to R_SFI;
    with ``wind_tangent`` also its analytic d/d(wind_speed) (the whole
    correction is linear in the Mueller grid)."""
    if n_water is None:
        n_water = surf.get_n_water()
    phi_q, w_q = gauleg(N_QUAD_PHI, 0.0, np.pi)
    tau_total = np.atleast_1d(np.asarray(tau_total, dtype=np.float64))
    out = np.zeros((len(vza_deg), ns, len(tau_total)))
    dout = np.zeros_like(out)

    def mueller(mu_v, mu_i, ph):
        if wind_tangent:
            return cox_munk_mueller_wind_tangent(surf, ns, mu_v, mu_i, ph,
                                                 n_water=n_water)
        return cox_munk_mueller(surf, ns, mu_v, mu_i, ph,
                                n_water=n_water), None

    for iv, (vza, vaz) in enumerate(zip(vza_deg, vaz_deg)):
        mu_v = np.cos(np.deg2rad(vza))
        dphi = np.deg2rad(vaz)
        M_exact, dM_exact = mueller(mu_v, mu0, dphi)
        # Fourier reconstruction at this geometry from the same quadrature
        M_q, dM_q = mueller(mu_v, mu0, phi_q)
        M_fourier = np.zeros((ns, ns))
        dM_fourier = np.zeros((ns, ns))
        for m in range(m_max + 1):
            ff = 1.0 if m == 0 else 2.0
            wm = 0.5 if m == 0 else 1.0
            az_q = _azimuthal_kernels(ns, m, phi_q)
            az_here = _azimuthal_kernels(ns, m, np.array([dphi]))[0]
            coeff = (ff / np.pi) * np.einsum("p,pst,pst->st", w_q, M_q, az_q)
            M_fourier += wm * az_here * coeff
            if wind_tangent:
                dcoeff = (ff / np.pi) * np.einsum("p,pst,pst->st",
                                                  w_q, dM_q, az_q)
                dM_fourier += wm * az_here * dcoeff
        atten = mu0 * np.exp(-tau_total / mu0)              # (nSpec,)
        out[iv] = np.outer(M_exact[:, 0] - M_fourier[:, 0], atten)
        if wind_tangent:
            dout[iv] = np.outer(dM_exact[:, 0] - dM_fourier[:, 0], atten)
    if wind_tangent:
        return out, dout
    return out
