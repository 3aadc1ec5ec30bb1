"""Aerosol scheme types and moment/size conversions.

Counterpart of the JAX package's ``aerosols/schemes.py`` (the same NumPy
f64 host code). Behavioral reference: vSmartMOM.jl src/Aerosols/types.jl
(TOMAS15Scheme, TwoMomentScheme, AerosolSpeciesData, AerosolData) and
schemes/{tomas15,two_moment}.jl (unit conversions, lognormal moment
relations, Angstrom AOD scaling).
"""

from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np

K_B = 1.380649e-23          # J/K
R_GAS = 8.314462618         # J/(mol K)
M_AIR = 28.9644e-3          # kg/mol


@dataclass
class TOMAS15Scheme:
    """TOMAS microphysics, 15 logarithmically spaced dry-diameter bins
    (types.jl:21-48)."""
    species: List[str]
    n_bins: int
    diam_min: float             # nm
    diam_max: float             # nm
    bin_edges: np.ndarray       # (n_bins+1,) nm
    bin_centers: np.ndarray     # (n_bins,) nm, geometric centers
    refractive_indices: Dict[str, str]
    densities: Dict[str, float]         # kg/m^3
    molar_masses: Dict[str, float]      # kg/mol

    @classmethod
    def from_config(cls, config: dict):
        sp_cfg = config["aerosol_scheme"]["species"]
        sz = config["aerosol_scheme"]["size_bins"]
        n_bins = int(sz["n_bins"])
        dmin, dmax = float(sz["diam_min_nm"]), float(sz["diam_max_nm"])
        edges = dmin * (dmax / dmin) ** (np.arange(n_bins + 1) / n_bins)
        centers = np.sqrt(edges[:-1] * edges[1:])
        return cls(
            species=list(sp_cfg), n_bins=n_bins, diam_min=dmin,
            diam_max=dmax, bin_edges=edges, bin_centers=centers,
            refractive_indices={s: c["refractive_index"]
                                for s, c in sp_cfg.items()},
            densities={s: float(c["density"]) for s, c in sp_cfg.items()},
            molar_masses={s: float(c["molar_mass"])
                          for s, c in sp_cfg.items()})


@dataclass
class TwoMomentScheme:
    """Bulk two-moment scheme: per species AOD + effective radius with a
    fixed lognormal sigma_g (types.jl:51-66)."""
    species: List[str]
    sigma_g: Dict[str, float]
    aod_wavelength: Dict[str, float]        # um
    refractive_indices: Dict[str, str]

    @classmethod
    def from_config(cls, config: dict):
        sp_cfg = config["aerosol_scheme"]["species"]
        return cls(
            species=list(sp_cfg),
            sigma_g={s: float(c["sigma_g"]) for s, c in sp_cfg.items()},
            aod_wavelength={s: float(c["aod_reference_wavelength"])
                            for s, c in sp_cfg.items()},
            refractive_indices={s: c["refractive_index"]
                                for s, c in sp_cfg.items()})


@dataclass
class AerosolSpeciesData:
    data: Dict[str, Any]
    units: Dict[str, str]
    description: str = ""


@dataclass
class AerosolData:
    scheme: Any
    species_data: Dict[str, AerosolSpeciesData]
    coordinates: Dict[str, np.ndarray] = field(default_factory=dict)
    metadata: Dict[str, Any] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Conversions (schemes/tomas15.jl:347-413, two_moment.jl:160-260)
# ---------------------------------------------------------------------------

def compute_number_concentration(vmr, pressure_pa, temperature):
    """VMR -> number concentration [#/cm^3] (tomas15.jl:347-368)."""
    n_air = np.asarray(pressure_pa) / (K_B * np.asarray(temperature))
    return np.asarray(vmr) * n_air * 1e-6


def compute_mass_concentration(vmr, molar_mass, pressure_pa, temperature):
    """VMR -> mass concentration [ug/m^3] (tomas15.jl:384-404)."""
    rho = (np.asarray(vmr) * np.asarray(pressure_pa) * molar_mass
           / (R_GAS * np.asarray(temperature)))
    return rho * 1e9


def bin_volume(diam_nm: float) -> float:
    """Spherical particle volume [nm^3] (tomas15.jl:410-413)."""
    r = diam_nm / 2.0
    return (4.0 / 3.0) * np.pi * r ** 3


def scale_aod_wavelength(aod_ref: float, lam_ref: float, lam_target: float,
                         angstrom_exponent: float = 1.0) -> float:
    """Angstrom-law AOD scaling AOD(l) = AOD(l_ref) (l/l_ref)^-alpha
    (two_moment.jl:160-166)."""
    return aod_ref * (lam_target / lam_ref) ** (-angstrom_exponent)


def effective_radius_from_moments(r_med: float, sigma_g: float) -> float:
    """r_eff = r_med exp(2.5 ln^2 sigma_g) (two_moment.jl:219-223)."""
    return r_med * np.exp(2.5 * np.log(sigma_g) ** 2)


def median_radius_from_effective(r_eff: float, sigma_g: float) -> float:
    """Inverse of effective_radius_from_moments (two_moment.jl:239-242)."""
    return r_eff / np.exp(2.5 * np.log(sigma_g) ** 2)


def lognormal_size_distribution(r, r_eff: float, sigma_g: float):
    """Normalized dN/dr for a lognormal with given effective radius
    (two_moment.jl:188-204)."""
    r = np.asarray(r, dtype=np.float64)
    ln_s = np.log(sigma_g)
    r_med = median_radius_from_effective(r_eff, sigma_g)
    return (1.0 / (r * np.sqrt(2 * np.pi) * ln_s)
            * np.exp(-np.log(r / r_med) ** 2 / (2 * ln_s ** 2)))
