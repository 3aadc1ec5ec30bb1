"""vsmartmom_tpu_torch — the PyTorch/CUDA port of vsmartmom_tpu.

The JAX package ``vsmartmom_tpu`` stays the reference; this package mirrors
its module paths and never imports it (nor JAX). Host setup (quadrature,
profiles, depolarization, Greek coefficients, Z supermatrices, surfaces, the
Newton-Schulz schedule probe) is the port's own float64 NumPy copy. The
solver runs on torch tensors; the whole-moment band path launches the
hand-written Hopper kernel ``csrc/fused_band.cu`` and the rotational-Raman
paths (air and stellar) also ``csrc/fused_rrs.cu``, the Jacobian path ``csrc/fused_lin.cu``
(for solar and, after ``add_thermal_emission``, solar + Planck sources) and
the multisensor path the per-layer doubling kernel of ``csrc/fused_rt.cu``,
each built by ``nvcc`` at first use into ``vsmartmom_tpu_torch/_build/``.
Gas absorption (``absorption/``) sums HITRAN lines in float64 on the
device (plain torch) when a model is built. Scenes come from a YAML, TOML
or JSON scene file (``parameters_from_file``, ``io/``) and from GEOS-Chem
output (``io.geoschem``, ``aerosols/``). Surfaces: Lambertian (a scalar,
per-point, Legendre or spline albedo), Cox-Munk, RPV, Ross-Li and a
vegetation canopy over any of them (``CanopySurface``, whose slab is built
on the model's device in float64); sources: the solar spectrum
(``solar.default_solar_spectrum`` as ``f0_spec``), surface SIF
(``build_sif_source``, ``set_surface_sif``) and thermal emission.

Entry points (``rt_run``, ``rt_run_full``, ``rt_run_streams``, ``rt_solve``,
``rt_run_ss`` (truncated single scattering), ``run_exact_ss`` and
``run_exact_ss_with_jacobians`` (the standalone exact single-scatter
solver), ``rt_run_inelastic`` (rotational and vibrational Raman),
``rt_run_stellar`` (H2 Raman), ``rt_run_lin``, ``rt_run_ms``,
``rt_run_ms_rrs``) run on CUDA unless the caller passes ``device`` (e.g.
``device="cpu"``); without CUDA and without a device they raise.
"""

from .core.inelastic import rt_run_inelastic
from .core.linearization import ParameterLayout, default_layout, rt_run_lin
from .core.model import Parameters, SurfaceDescriptor, model_from_parameters
from .core.multisensor import rt_run_ms, rt_run_ms_rrs
from .core.singlescatter import rt_run_ss
from .core.solver import rt_run, rt_run_full, rt_run_streams, rt_solve
from .flagship import (aband_model, canopy_model, flagship_model,
                       rrs_sif_model, stellar_sif_model, stellar_vs_sif_model,
                       thermal_lin_model, vs_sif_model)
from .inelastic.stellar import rt_run_stellar
from .io.yaml_input import (parameters_from_dict, parameters_from_file,
                            parameters_from_toml, parameters_from_yaml)
from .sif import build_sif_source
from .solar import add_thermal_emission, set_surface_sif
from .standalone_ss import run_exact_ss, run_exact_ss_with_jacobians
from .surfaces.canopy import CanopySurface

__all__ = ["Parameters", "SurfaceDescriptor", "model_from_parameters",
           "rt_run", "rt_run_full", "rt_run_streams", "rt_solve",
           "rt_run_inelastic", "rt_run_lin", "rt_run_ms", "rt_run_ms_rrs",
           "rt_run_stellar", "default_layout", "ParameterLayout",
           "flagship_model", "rrs_sif_model", "vs_sif_model",
           "stellar_sif_model", "stellar_vs_sif_model", "thermal_lin_model",
           "aband_model", "add_thermal_emission", "parameters_from_yaml",
           "parameters_from_dict", "parameters_from_file",
           "parameters_from_toml", "rt_run_ss", "run_exact_ss",
           "run_exact_ss_with_jacobians", "CanopySurface", "canopy_model",
           "set_surface_sif", "build_sif_source"]
