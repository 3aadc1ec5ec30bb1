"""Aerosol schemes, refractive-index database, and GEOS-Chem ingest
(counterpart of the JAX package's ``aerosols/``; reference
src/Aerosols/)."""

from .ncio import NCFile, horizontal_mean_profile
from .optics import (compute_mie_efficiencies, compute_optical_properties,
                     to_rt_aerosols)
from .readers import read_aerosol_data, read_tomas15, read_two_moment
from .refractive import (DEFAULT_DB, RefractiveIndexDatabase,
                         RefractiveIndexLUT, get_refractive_index,
                         load_refractive_index_database)
from .schemes import (AerosolData, AerosolSpeciesData, TOMAS15Scheme,
                      TwoMomentScheme, bin_volume,
                      compute_mass_concentration,
                      compute_number_concentration,
                      effective_radius_from_moments,
                      lognormal_size_distribution,
                      median_radius_from_effective, scale_aod_wavelength)

__all__ = [n for n in dir() if not n.startswith("_")]
