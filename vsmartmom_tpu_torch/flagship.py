"""The flagship scene of the port: a polarized IQUV Rayleigh column (33
layers) over a wind-roughened Cox-Munk ocean, with a parameterizable
spectral width — the same profile and arguments as the JAX package's
``__graft_entry__._flagship_model``, built by the port's own host code."""

import numpy as np

from .core.model import Parameters, SurfaceDescriptor, model_from_parameters
from .scattering.stokes import STOKES_IQUV

# ocean_coxmunk profile: layer temperatures [K] and half-level pressures [hPa]
FLAGSHIP_T = np.array([
    244.33, 251.34, 258.09, 264.25, 269.15, 272.59, 274.07, 273.30, 269.65,
    264.27, 258.11, 251.52, 245.22, 239.20, 234.05, 229.71, 225.70, 222.70,
    220.62, 219.32, 217.93, 216.98, 217.10, 218.35, 223.33, 234.19, 249.34,
    264.12, 277.20, 280.77, 282.60, 284.40, 285.80])
FLAGSHIP_P = np.array([
    0.14, 0.22, 0.30, 0.39, 0.53, 0.71, 0.96, 1.28, 1.70, 2.27, 3.03, 4.03,
    5.44, 7.26, 9.67, 12.90, 17.23, 23.30, 31.00, 42.07, 56.09, 74.78, 99.69,
    131.00, 176.85, 236.64, 314.58, 418.87, 557.76, 735.00, 800.12, 849.00,
    912.00, 980.00])
FLAGSHIP_NU0 = 19417.0          # first wavenumber [cm^-1], 0.05 cm^-1 steps


def flagship_model(n_spec=256, dtype=np.float32, nstreams=8,
                   surface="coxmunk", nz=None, fused=None):
    """RTModel of the flagship scene (``surface="lambertian"`` swaps the
    ocean for a 0.05-albedo Lambertian floor). ``fused`` overrides the
    execution strategy (None = the band kernel for f32 on CUDA)."""
    if surface == "coxmunk":
        surf = SurfaceDescriptor("CoxMunkSurface", [], {"wind_speed": 5.0})
    else:
        surf = SurfaceDescriptor("LambertianSurfaceScalar", [0.05])
    params = Parameters(
        spec_bands=[FLAGSHIP_NU0 + 0.05 * np.arange(n_spec)],
        surfaces=[surf],
        nstreams=nstreams,
        polarization=STOKES_IQUV,
        sza=30.0,
        vza=[60.0, 45.0, 30.0, 15.0, 0.0, 15.0, 30.0, 45.0, 60.0],
        vaz=[180.0, 180.0, 180.0, 180.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        obs_alt=1000.0,
        T=FLAGSHIP_T, p=FLAGSHIP_P,
        profile_reduction=(nz if nz is not None else -1),
        depol=-1.0,
        float_type=dtype,
        fused=fused)
    return model_from_parameters(params)
