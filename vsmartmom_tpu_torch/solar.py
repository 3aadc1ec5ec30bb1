"""Blackbody source spectra and the per-layer thermal source.

Counterpart of ``vsmartmom_tpu/solar.py`` (reference SolarModel.jl and
thermal_emission.jl) for what the thermal runs need: Planck spectra in
wavenumber and wavelength space, and ``add_thermal_emission``, which
attaches each layer's Planck radiance to every band as its second source.
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
