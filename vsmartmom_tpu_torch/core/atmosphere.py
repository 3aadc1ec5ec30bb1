"""Atmospheric profile fields and Rayleigh layer optics (host, float64).

Behavioral reference: vSmartMOM.jl src/CoreRT/tools/atmo_prof.jl
(compute_atmos_profile_fields:36-91, reduce_profile:110-167,
getRayleighLayerOptProp:238-262, getAerosolLayerOptProp:269-298) and the
altitude-form aerosol profile of the JAX package.
"""

from dataclasses import dataclass

import numpy as np

NA = 6.02214179e23          # Avogadro [1/mol]
R_GAS = 8.3144598           # [J/mol/K]
G0 = 9.8032465              # [m/s^2] (Bodhaine 1999 Eq. 30 convention)
DRY_MASS = 28.9644e-3       # [kg/mol]
WET_MASS = 18.01534e-3      # [kg/mol]


@dataclass
class AtmosphericProfile:
    """Reference CoreRT/types.jl:41-60 (TOA -> BOA ordering)."""
    T: np.ndarray          # (Nz,) layer temperatures [K]
    p_full: np.ndarray     # (Nz,) layer-center pressures [hPa]
    q: np.ndarray          # (Nz,) specific humidity [kg/kg]
    p_half: np.ndarray     # (Nz+1,) boundary pressures [hPa]
    vmr_h2o: np.ndarray    # (Nz,)
    vcd_dry: np.ndarray    # (Nz,) dry column density [molec/cm^2]
    vcd_h2o: np.ndarray    # (Nz,)
    vmr: dict              # per-species VMR (scalar or (Nz,))
    dz: np.ndarray         # (Nz,) layer thickness [m]

    @property
    def nz(self) -> int:
        return len(self.T)


def compute_atmos_profile_fields(T, p_half, q=None, vmr=None) -> AtmosphericProfile:
    """Hydrostatic column densities and layer thicknesses (atmo_prof.jl:36-91)."""
    T = np.asarray(T, dtype=np.float64)
    p_half = np.asarray(p_half, dtype=np.float64)
    nz = len(T)
    q = np.zeros(nz) if q is None else np.asarray(q, dtype=np.float64)
    vmr = {} if vmr is None else vmr

    p_full = 0.5 * (p_half[1:] + p_half[:-1])
    dp = np.diff(p_half)
    ratio = DRY_MASS / WET_MASS
    # Guard q -> 1 (saturated / placeholder specific humidities in e.g.
    # GeosChem ingests would otherwise divide by zero and NaN the column):
    # physically q stays well below ~0.1, so clip the mixing-ratio
    # conversion rather than propagate infinities.
    q_safe = np.clip(q, 0.0, 0.5)
    vmr_h2o = q_safe / (1.0 - q_safe) * ratio
    vmr_dry = 1.0 - vmr_h2o
    M = vmr_dry * DRY_MASS + vmr_h2o * WET_MASS
    # hPa -> SI -> molec/cm^2 (the reference's *100/100^2 scalings combined)
    vcd = NA * dp / (M * G0 * 100.0 ** 2) * 100.0
    vcd_dry = vmr_dry * vcd
    vcd_h2o = vmr_h2o * vcd
    dz = (np.log(p_half[1:]) - np.log(p_half[:-1])) / (G0 * M / (R_GAS * T))

    new_vmr = {}
    for species, value in vmr.items():
        arr = np.asarray(value, dtype=np.float64)
        if arr.ndim == 0:
            new_vmr[species] = float(arr)
        elif len(arr) == nz:
            new_vmr[species] = arr
        else:
            grid = np.linspace(p_full.min(), p_full.max(), len(arr))
            new_vmr[species] = np.interp(p_full, grid, arr)

    return AtmosphericProfile(T=T, p_full=p_full, q=q, p_half=p_half,
                              vmr_h2o=vmr_h2o, vcd_dry=vcd_dry,
                              vcd_h2o=vcd_h2o, vmr=new_vmr, dz=dz)


def reduce_profile(n: int, profile: AtmosphericProfile) -> AtmosphericProfile:
    """Interpolate onto n uniform pressure layers (atmo_prof.jl:110-167)."""
    assert n < profile.nz
    p_half = np.linspace(profile.p_half[0], profile.p_half[-1], n + 1)
    p_full = 0.5 * (p_half[:-1] + p_half[1:])

    old = profile.p_full

    def interp(data):
        grid = np.linspace(old.min(), old.max(), len(data))
        return np.interp(p_full, grid, data)

    T = interp(profile.T)
    q = interp(profile.q)
    vmr_h2o = interp(profile.vmr_h2o)

    dp = np.diff(p_half)
    vmr_dry = 1.0 - vmr_h2o
    M = vmr_dry * DRY_MASS + vmr_h2o * WET_MASS
    vcd = NA * dp / (M * G0 * 100.0 ** 2) * 100.0
    dz = (np.log(p_half[1:]) - np.log(p_half[:-1])) / (G0 * M / (R_GAS * T))

    new_vmr = {k: (interp(v) if np.ndim(v) > 0 else v)
               for k, v in profile.vmr.items()}
    return AtmosphericProfile(T=T, p_full=p_full, q=q, p_half=p_half,
                              vmr_h2o=vmr_h2o, vcd_dry=vmr_dry * vcd,
                              vcd_h2o=vmr_h2o * vcd, vmr=new_vmr, dz=dz)


def rayleigh_layer_tau(psurf_hpa: float, lambda_um, depol: float,
                       vcd_dry) -> np.ndarray:
    """Rayleigh optical depth per (wavelength, layer), Bodhaine 1999 Eq. 30
    rescaled from its implicit depol 0.0279 to ``depol``
    (atmo_prof.jl:238-262). ``lambda_um`` in microns. Returns (nSpec, Nz)."""
    lam = np.atleast_1d(np.asarray(lambda_um, dtype=np.float64))
    vcd_dry = np.asarray(vcd_dry, dtype=np.float64)
    tau = (0.002152 * (1.0455996 - 341.29061 * lam ** -2 - 0.90230850 * lam ** 2)
           / (1.0 + 0.0027059889 * lam ** -2 - 85.968563 * lam ** 2))
    tau = tau * (psurf_hpa / 1013.25)
    rho0 = 0.0279
    tau = tau * ((6.0 - 7.0 * rho0) * (6.0 + 3.0 * depol)
                 / ((6.0 + 3.0 * rho0) * (6.0 - 7.0 * depol)))
    k = tau / vcd_dry.sum()
    return k[:, None] * vcd_dry[None, :]


def aerosol_layer_tau_gauss(total_tau: float, p0: float, sigma_p: float,
                            p_half) -> np.ndarray:
    """Gaussian-in-pressure aerosol profile (atmo_prof.jl:269-286)."""
    p_half = np.asarray(p_half, dtype=np.float64)
    dp = np.diff(p_half)
    p = 0.5 * (p_half[1:] + p_half[:-1])
    rho = (1.0 / (sigma_p * np.sqrt(2 * np.pi))) * \
        np.exp(-(p - p0) ** 2 / (2 * sigma_p ** 2)) * dp
    return (total_tau / rho.sum()) * rho


def layer_z_bounds(profile: AtmosphericProfile) -> np.ndarray:
    """Altitude at layer boundaries [m], TOA -> BOA, surface = 0
    (cumulated hydrostatic thicknesses profile.dz)."""
    dz = np.asarray(profile.dz, dtype=np.float64)
    z_half = np.zeros(len(dz) + 1)
    z_half[:-1] = np.cumsum(dz[::-1])[::-1]     # height of each layer TOP
    return z_half


def aerosol_layer_tau_gauss_z(total_tau: float, z0_km: float,
                              sigma0: float,
                              profile: AtmosphericProfile) -> np.ndarray:
    """Altitude-form aerosol profile LogNormal(log z0, sigma0) in height,
    integrated EXACTLY over each layer's altitude span (log-normal CDF
    difference), normalized to ``total_tau``.

    The reference documents this (z0, sigma0) form as the PREFERRED input
    and stores the distribution (IO/Parameters.jl:495-556:
    ``LogNormal(log(z0), sigma0)``) but stubs the altitude ->
    pressure-grid integration as a no-op; here it integrates properly on
    the hydrostatic z grid (profile.dz). z0 in km, sigma0 the
    dimensionless log-width."""
    from scipy.special import erf
    z_half = layer_z_bounds(profile) / 1e3      # (Nz+1,) [km], TOA -> BOA
    lnz = np.log(np.maximum(z_half, 1e-12))
    cdf = 0.5 * (1.0 + erf((lnz - np.log(z0_km))
                           / (np.sqrt(2.0) * sigma0)))
    cdf = np.where(z_half <= 0, 0.0, cdf)
    rho = cdf[:-1] - cdf[1:]                    # mass in [z_bot, z_top]
    s = rho.sum()
    if s <= 0:
        raise ValueError(
            f"altitude-form aerosol profile (z0={z0_km} km, sigma0={sigma0})"
            f" has no mass inside the column [0, {z_half[0]:.1f} km]")
    return (total_tau / s) * rho


def aerosol_profile_shape(aer, profile: AtmosphericProfile) -> np.ndarray:
    """Unit-total vertical profile for an RTAerosol in either form:
    Gaussian-in-pressure (p0, sigma_p) or Gaussian-in-altitude
    (z0, sigma_z)."""
    if getattr(aer, "z0", None) is not None:
        return aerosol_layer_tau_gauss_z(1.0, aer.z0, aer.sigma_z, profile)
    return aerosol_layer_tau_gauss(1.0, aer.p0, aer.sigma_p, profile.p_half)


def doubling_number(dtau_max: float, tau_end: float):
    """(dtau, ndoubl) so that dtau * 2^ndoubl = tau_end with dtau <= dtau_max
    (rt_helper_functions.jl:49-69)."""
    if tau_end <= dtau_max:
        return tau_end, 0
    tlimit = (np.log10(tau_end) - np.log10(dtau_max)) / np.log10(2.0)
    nlimit = int(np.floor(tlimit))
    if tlimit - nlimit < np.finfo(np.float64).eps:
        return dtau_max, nlimit
    ndoubl = nlimit + 1
    return 10.0 ** (np.log10(tau_end) - np.log10(2.0) * ndoubl), ndoubl


def compute_ndoubl(tau_scat_max: float, mu_min_weighted: float,
                   dtau_max_threshold: float = 1e-3,
                   dtau_min_floor: float | None = None,
                   dtype=np.float64) -> int:
    """Per-layer doubling count (rt_kernel.jl:266-287 get_dtau_ndoubl)."""
    if dtau_min_floor is None:
        dtau_min_floor = 1024 * np.finfo(dtype).eps
    if tau_scat_max <= 0:
        return 0
    dtau_max = max(dtau_min_floor,
                   min(tau_scat_max, dtau_max_threshold * mu_min_weighted))
    return doubling_number(dtau_max, tau_scat_max)[1]
