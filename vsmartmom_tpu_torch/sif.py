"""Solar-induced fluorescence (SIF) spectra: loaders + default shape.

Counterpart of ``vsmartmom_tpu/sif.py``; behavioral reference vSmartMOM.jl
src/SIF_emission/sif_loader.jl (load_sif_spectrum CSV reader with nm ->
cm^-1 conversion and the 0.5*pi/peak rescaling, load_ficus_reflectance,
build_sif_source). The reference ships its sif-spectra.csv outside its
repository; like the JAX package, the port also provides
``default_sif_spectrum``, the standard two-Gaussian chlorophyll-a
fluorescence shape (red peak ~685 nm, far-red peak ~740 nm), so SIF runs
need no file. Host NumPy in float64.
"""

import numpy as np


def default_sif_spectrum(nu_grid, peak_ratio: float = 1.3,
                         rescale_to_peak: bool = True) -> np.ndarray:
    """Two-Gaussian chlorophyll fluorescence shape on a wavenumber grid.

    F(lambda) = G(685 nm, sigma 10 nm) + peak_ratio * G(740 nm, sigma 35 nm);
    converted to per-wavenumber flux via the 1e7/nu^2 Jacobian and, like the
    reference loader, rescaled so the peak is 0.5*pi (shape-only source for
    grid/retrieval work — sif_loader.jl:37-41 documents the same hack).
    """
    nu = np.asarray(nu_grid, dtype=np.float64)
    wl = 1e7 / nu                                   # nm
    f_nm = (np.exp(-0.5 * ((wl - 685.0) / 10.0) ** 2)
            + peak_ratio * np.exp(-0.5 * ((wl - 740.0) / 35.0) ** 2))
    f_wn = f_nm * 1e7 / nu ** 2
    if rescale_to_peak and f_wn.max() > 0:
        f_wn = f_wn * (0.5 * np.pi / f_wn.max())
    return f_wn


def load_sif_spectrum(path: str, column: str = "SIF_OLD",
                      rescale_to_peak: bool = True):
    """Load a SIF emission CSV (wavelength-nm first column, named flux
    columns in mW/m^2/nm) -> (nu [cm^-1] ascending, jSIF [mW/m^2/cm^-1]).

    Mirrors sif_loader.jl:42-66 incl. the 0.5*pi/peak rescale and the
    dlambda/dnu = 1e7/nu^2 Jacobian.
    """
    with open(path) as f:
        header = [h.strip() for h in f.readline().split(",")]
    if column not in header:
        raise ValueError(f"column {column} not found in {path} "
                         f"(available: {header[1:]})")
    data = np.loadtxt(path, delimiter=",", skiprows=1)
    wl_nm = data[:, 0]
    flux_nm = data[:, header.index(column)]
    if rescale_to_peak:
        peak = flux_nm.max()
        if peak <= 0:
            raise ValueError("SIF spectrum peak is zero; cannot rescale")
        flux_nm = flux_nm * (0.5 * np.pi / peak)
    nu = (1e7 / wl_nm)[::-1].copy()
    jsif = flux_nm[::-1] * 1e7 / nu ** 2
    return nu, jsif


def load_ficus_reflectance(path: str):
    """Two-column leaf-reflectance sample (lambda um, reflectance %), with
    an optional metadata header ending at the first blank line
    (sif_loader.jl:69-86). Returns (lambda_um, R dimensionless)."""
    with open(path) as f:
        lines = f.readlines()
    start = 0
    for i, line in enumerate(lines):
        if not line.strip():
            start = i + 1
            break
    data = np.loadtxt(lines[start:])
    return data[:, 0], data[:, 1] / 100.0


def build_sif_source(model, nu_sif=None, jsif=None, path: str = None,
                     column: str = "SIF_OLD"):
    """Interpolate a SIF spectrum onto every band grid and attach it as the
    surface SIF source (reference build_sif_source, sif_loader.jl:88-110;
    the solver reads band.sif_spec into its surface SIF source).

    With no arguments, uses ``default_sif_spectrum``.
    """
    if path is not None:
        nu_sif, jsif = load_sif_spectrum(path, column=column)
    for band in model.bands:
        if nu_sif is None:
            band.sif_spec = default_sif_spectrum(band.nu_grid)
        else:
            band.sif_spec = np.interp(band.nu_grid, nu_sif, jsif)
    return model
