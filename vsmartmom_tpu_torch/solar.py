"""Blackbody source spectra and the per-layer thermal source.

Counterpart of ``vsmartmom_tpu/solar.py`` (reference SolarModel.jl,
thermal_emission.jl and surface_sif.jl): Planck spectra in wavenumber and
wavelength space; ``add_thermal_emission``, which attaches each layer's
Planck radiance to every band as its second source; a loader for a solar
spectrum file (``load_solar_spectrum``: .npy, .npz or two-column text of
[wavenumber, irradiance], interpolated onto the model grid: the reference
fetches its Kurucz artifact from the network, the port reads a local
file), the synthetic default spectrum ``default_solar_spectrum`` (a Planck
continuum with the strong Fraunhofer lines) for ``BandData.f0_spec``, and
``set_surface_sif``, which attaches an isotropic surface SIF spectrum.
Host NumPy in float64.
"""

import numpy as np

C1_WN = 1.1910427e-5      # mW / (m^2 sr cm^-1)
C2_WN = 1.4387752         # K cm
C1_WL = 1.1910427e8       # W / (m^2 sr um)
C2_WL = 1.4387752e4       # K um


def planck_spectrum_wn(T: float, nu_grid) -> np.ndarray:
    """Blackbody radiance [mW m^-2 sr^-1 / cm^-1] on a wavenumber grid
    [cm^-1] (SolarModel.jl:26-35)."""
    nu = np.asarray(nu_grid, dtype=np.float64)
    return C1_WN * nu ** 3 / np.expm1(C2_WN * nu / T)


def planck_spectrum_wl(T: float, lam_grid_um) -> np.ndarray:
    """Blackbody radiance [W m^-2 sr^-1 / um] on a wavelength grid [um]
    (SolarModel.jl:44-51)."""
    lam = np.asarray(lam_grid_um, dtype=np.float64)
    return C1_WL / (lam ** 5 * np.expm1(C2_WL / (lam * T)))


def load_solar_spectrum(path: str, nu_grid) -> np.ndarray:
    """Interpolate a two-column [cm^-1, irradiance] solar spectrum file onto
    ``nu_grid``. Accepts .npy / .npz (key 'spectrum') / whitespace text."""
    if path.endswith(".npy"):
        data = np.load(path)
    elif path.endswith(".npz"):
        data = np.load(path)["spectrum"]
    else:
        data = np.loadtxt(path)
    nu, F = data[:, 0], data[:, 1]
    out = np.interp(np.asarray(nu_grid), nu, F)
    lo, hi = nu.min(), nu.max()
    grid = np.asarray(nu_grid)
    if grid.min() < lo or grid.max() > hi:
        raise ValueError(
            f"model grid [{grid.min():.1f}, {grid.max():.1f}] cm^-1 exceeds "
            f"solar spectrum coverage [{lo:.1f}, {hi:.1f}]")
    return out


# Strong Fraunhofer lines: (center wavelength [nm, air], equivalent width
# [nm], Gaussian central depth). Wavelengths and equivalent widths are the
# classical Rowland/Moore solar-atlas values quoted in every spectroscopy
# reference; depths chosen so saturated lines (Ca II H/K, H I, Na D) bottom
# near the observed residual intensity.
_FRAUNHOFER = [
    (393.366, 2.025, 0.95),   # Ca II K
    (396.847, 1.547, 0.95),   # Ca II H
    (410.175, 0.313, 0.85),   # H-delta
    (422.673, 0.146, 0.80),   # Ca I g
    (434.047, 0.286, 0.85),   # H-gamma
    (438.355, 0.101, 0.75),   # Fe I d
    (486.134, 0.368, 0.85),   # H-beta
    (516.733, 0.065, 0.70),   # Mg I b4
    (517.270, 0.126, 0.75),   # Mg I b2
    (518.362, 0.158, 0.75),   # Mg I b1
    (527.039, 0.164, 0.70),   # Fe I E
    (588.995, 0.0752, 0.85),  # Na I D2
    (589.592, 0.0564, 0.80),  # Na I D1
    (656.281, 0.402, 0.85),   # H-alpha C
    (849.802, 0.146, 0.70),   # Ca II IR triplet
    (854.209, 0.367, 0.80),   # Ca II IR triplet
    (866.214, 0.260, 0.75),   # Ca II IR triplet
]


def default_solar_spectrum(nu_grid, T_eff: float = 5772.0,
                           normalize: bool = True) -> np.ndarray:
    """Default solar irradiance spectrum: Planck continuum at the solar
    effective temperature with the strong Fraunhofer lines superposed.

    The reference ships a measured Kurucz-merged artifact
    (SolarModel.jl:12-15, fetched from the network); the JAX package and the
    port provide a synthetic default instead — a T_eff = 5772 K Planck continuum times
    Gaussian absorption lines with published centers/equivalent widths —
    so Ring-effect (Fraunhofer filling-in) and continuum work run out of
    the box. Swap in a measured file via ``load_solar_spectrum`` for
    quantitative line work.

    Returns the relative irradiance on ``nu_grid`` (normalized to a
    continuum of ~1 when ``normalize``, suitable for ``band.f0_spec``).
    """
    nu = np.asarray(nu_grid, dtype=np.float64)
    cont = planck_spectrum_wn(T_eff, nu)
    wl = 1e7 / nu                                   # nm
    trans = np.ones_like(wl)
    for wl0, ew, depth in _FRAUNHOFER:
        if wl0 < wl.min() - 5 or wl0 > wl.max() + 5:
            continue
        sigma = ew / (depth * np.sqrt(2.0 * np.pi))
        trans *= 1.0 - depth * np.exp(-0.5 * ((wl - wl0) / sigma) ** 2)
    F = cont * trans
    if normalize:
        F = F / cont.max()
    return F


def add_thermal_emission(model, T_layers=None):
    """Attach a per-layer Planck thermal volume source to every band
    (reference ThermalEmission(T_layers, nu_grid), thermal_emission.jl:104):
    ``band.thermal_b`` (Nz, nSpec), which makes the band a two-source
    (K = 2) scene. ``T_layers`` defaults to the model's layer temperatures.
    Returns the model."""
    T = np.asarray(T_layers if T_layers is not None else model.profile.T,
                   dtype=np.float64)
    for band in model.bands:
        band.thermal_b = np.stack([planck_spectrum_wn(t, band.nu_grid)
                                   for t in T])
    return model


def set_surface_sif(model, sif_spectrum):
    """Attach an isotropic surface SIF emission spectrum (irradiance units,
    per band or shared; reference SurfaceSIF, surface_sif.jl)."""
    for band in model.bands:
        sif = np.broadcast_to(np.asarray(sif_spectrum, dtype=np.float64),
                              (band.n_spec,)).copy()
        band.sif_spec = sif
    return model
