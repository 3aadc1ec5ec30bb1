"""The scenes the port is driven at, built by its own host code.

* The flagship: a polarized IQUV Rayleigh column (33 layers) over a
  wind-roughened Cox-Munk ocean, with a parameterizable spectral width —
  the same profile and arguments as the JAX package's
  ``__graft_entry__._flagship_model``; ``aerosol=True`` adds its log-normal
  Mie aerosol (the Jacobian scene of ``scripts/bench_lin.py``).
* The thermal Jacobian scene ``thermal_lin_model``: the aerosol flagship
  moved to the mid-wave window (2500 cm^-1) with each layer's Planck
  emission as a second source.
* The RRS+SIF scene of the JAX package's RRS bench
  (``scripts/bench_rrs.py:23-36``): an 8-layer Rayleigh column over a
  Lambertian floor with surface SIF, IQU, 0.6 cm^-1 spacing.
* The small RRS scene of the stored JAX reference ``data/rrs_ref_f64.npz``
  and the small aerosol Jacobian scene of ``data/lin_ref_f64.npz``, which
  the CPU tests and the chip smoke test both build from here.
* The Raman scenes on the RRS+SIF column (``sif_column_model``): the
  vibrational ``vs_sif_model``, the stellar rotational ``stellar_sif_model``
  (a dipped stellar spectrum) and the stellar vibrational
  ``stellar_vs_sif_model``; and the small scenes of the stored JAX
  references ``data/vs_ref_f64.npz``, ``data/stellar_ref_f64.npz`` and
  ``data/ms_rrs_ref_f64.npz`` (``vs_ref_model``, ``stellar_ref_model``,
  ``ms_rrs_ref_model``).
* The O2 A-band scene ``aband_model``: the flagship moved to 12980 cm^-1
  with O2 line absorption from a synthetic line list
  (``write_aband_par``), and its small twin ``aband_ref_model`` of the
  stored JAX reference ``data/aband_ref_f64.npz``.
* The GEOS-Chem column ``geoschem_model``: SYNTHETIC GCHP StateMet and
  Aerosols collections (``write_geoschem_column``, 72 levels, three
  two-moment aerosols) driven through the TOML scene-file front end with
  the flagship's settings, and its small twin ``geoschem_ref_model`` of
  the stored JAX reference ``data/geoschem_ref_f64.npz``.
* The vegetated red-edge column ``canopy_model``: the flagship's column
  over 755 -> 672 nm with a three-sublayer canopy (SYNTHETIC leaf optics:
  no PROSPECT table is in the repository) over an RPV soil, with a solar
  spectrum and surface SIF; its small twin ``canopy_ref_model``; the
  Gauss-Radau flagship ``radau_model``; the exact single-scatter configs
  of ``exact_ss_config``; the small scenes of the stored JAX reference
  ``data/surfaces_ref_f64.npz``.
"""

import os
import tempfile
from pathlib import Path

import numpy as np

from .core.model import (AbsorptionParams, Parameters, RTAerosol,
                         ScatteringParams, SurfaceDescriptor,
                         model_from_parameters)
from .scattering.stokes import STOKES_I, STOKES_IQU, STOKES_IQUV
from .solar import add_thermal_emission

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
#: The flagship's Mie aerosol (RTAerosol keywords: tau_ref 0.15 at 700 hPa,
#: r_mode 0.12 um, sigma_g 1.5, n = 1.4 - 0.003i) and its Mie quadrature
#: (300 radius nodes to r_max 10 um, untruncated; lambda_ref is the band's
#: first wavelength).
FLAGSHIP_AEROSOL = dict(tau_ref=0.15, p0=700.0, sigma_p=60.0,
                        mu_log=float(np.log(0.12)),
                        sigma_log=float(np.log(1.5)), n_r=1.4, n_i=0.003)
FLAGSHIP_MIE = dict(nquad_radius=300, r_max=10.0)
#: First wavenumber of the thermal Jacobian scene [cm^-1]: 4 um, the
#: mid-wave window where solar and Planck sources are of one order.
THERMAL_NU0 = 2500.0


def flagship_params(n_spec=256, dtype=np.float32, nstreams=8, nz=None,
                    fused=None, nu0=FLAGSHIP_NU0):
    """``Parameters`` keywords of the flagship, less ``surfaces``,
    ``polarization`` and ``scattering_params`` (plain data, so the JAX
    package's ``Parameters`` takes them too): 0.05 cm^-1 steps from
    ``nu0``, sza 30, nine view angles."""
    return dict(
        spec_bands=[nu0 + 0.05 * np.arange(n_spec)],
        nstreams=nstreams,
        sza=30.0,
        vza=[60.0, 45.0, 30.0, 15.0, 0.0, 15.0, 30.0, 45.0, 60.0],
        vaz=[180.0, 180.0, 180.0, 180.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        obs_alt=1000.0,
        T=FLAGSHIP_T, p=FLAGSHIP_P,
        profile_reduction=(nz if nz is not None else -1),
        depol=-1.0,
        float_type=dtype,
        fused=fused)


def _flagship_aerosol(nu0):
    return ScatteringParams(rt_aerosols=[RTAerosol(**FLAGSHIP_AEROSOL)],
                            lambda_ref=1e4 / nu0, **FLAGSHIP_MIE)


def flagship_model(n_spec=256, dtype=np.float32, nstreams=8,
                   surface="coxmunk", nz=None, fused=None, aerosol=False,
                   polarization=STOKES_IQUV):
    """RTModel of the flagship scene (``surface="lambertian"`` swaps the
    ocean for a 0.05-albedo Lambertian floor). ``fused`` overrides the
    execution strategy (None = the band kernel for f32 on CUDA).
    ``aerosol=True`` adds ``FLAGSHIP_AEROSOL``: 7 aerosol and 1 wind
    Jacobian parameters. Its width is N = n_stokes (nstreams + 5): the
    sun's node and four distinct view cosines join the streams (N = 52 at
    nstreams 8, IQUV; the wide flagship, nstreams 16, N = 84)."""
    if surface == "coxmunk":
        surf = SurfaceDescriptor("CoxMunkSurface", [], {"wind_speed": 5.0})
    else:
        surf = SurfaceDescriptor("LambertianSurfaceScalar", [0.05])
    return model_from_parameters(Parameters(
        scattering_params=_flagship_aerosol(FLAGSHIP_NU0) if aerosol
        else None,
        surfaces=[surf], polarization=polarization,
        **flagship_params(n_spec, dtype, nstreams, nz, fused)))


#: Widths of the wide kernels' launch checks: N -> (Stokes vector,
#: nstreams, views). Gauss streams come in pairs, so the flagship's nine
#: views (the sun's node and four distinct view cosines join the streams:
#: N = n_stokes (2 floor(nstreams / 2) + 5)) give odd node counts; the
#: widths with an even count take one nadir view (two nodes join).
WIDE_CHECK_STREAMS = {52: (STOKES_IQUV, 8, "flagship"),
                      53: (STOKES_I, 48, "flagship"),
                      64: (STOKES_IQUV, 14, "nadir"),
                      65: (STOKES_I, 60, "flagship"),
                      68: (STOKES_IQUV, 12, "flagship"),
                      84: (STOKES_IQUV, 16, "flagship"),
                      104: (STOKES_IQUV, 24, "nadir"),
                      128: (STOKES_IQUV, 30, "nadir")}


def wide_check_model(N, n_spec=64, nz=3, aerosol=False, thermal=False,
                     dtype=np.float32):
    """RTModel of the flagship's column and ocean cut to ``nz`` layers and
    ``n_spec`` points at width N (``WIDE_CHECK_STREAMS``): the operands of
    one kernel launch check. ``aerosol`` gives K2 its 8 parameters;
    ``thermal`` adds each layer's Planck source (K = 2, uniform 0.1..1
    from a seed, as the narrow K = 2 checks)."""
    pol, nstreams, views = WIDE_CHECK_STREAMS[N]
    kw = flagship_params(n_spec, dtype, nstreams, nz)
    if views == "nadir":
        kw.update(vza=[0.0], vaz=[0.0])
    model = model_from_parameters(Parameters(
        scattering_params=_flagship_aerosol(FLAGSHIP_NU0) if aerosol
        else None,
        surfaces=[SurfaceDescriptor("CoxMunkSurface", [],
                                    {"wind_speed": 5.0})],
        polarization=pol, **kw))
    if thermal:
        model.bands[0].thermal_b = np.random.default_rng(0).uniform(
            0.1, 1.0, (model.profile.nz, n_spec))
    return model


def thermal_lin_model(n_spec=1024, dtype=np.float32, thermal=True):
    """RTModel of the thermal Jacobian scene: ``flagship_model(aerosol=
    True)``'s column, aerosol, Cox-Munk ocean (wind 5), IQUV and nstreams 8
    (N = 52), 33 layers and P = 8 (7 aerosol + wind), with its grid from
    ``THERMAL_NU0`` = 2500 cm^-1 (4 um, 0.05 cm^-1 steps; the aerosol's
    lambda_ref moved with it) and, with ``thermal``, ``add_thermal_emission``
    at the profile's own layer temperatures (``FLAGSHIP_T``): a K = 2
    (solar + Planck) scene. At 2500 cm^-1 B(250 K) is ~0.1 mW m^-2 sr^-1
    (cm^-1)^-1, of the order of the solar term; at the flagship's 19417
    cm^-1 it is ~1e-34.

    The JAX package builds the same scene from the same ``Parameters``
    keywords (``flagship_params(..., nu0=THERMAL_NU0)`` and the aerosol
    ``FLAGSHIP_AEROSOL`` with ``FLAGSHIP_MIE``) and its own
    ``solar.add_thermal_emission``."""
    model = model_from_parameters(Parameters(
        scattering_params=_flagship_aerosol(THERMAL_NU0),
        surfaces=[SurfaceDescriptor("CoxMunkSurface", [],
                                    {"wind_speed": 5.0})],
        polarization=STOKES_IQUV,
        **flagship_params(n_spec, dtype, nu0=THERMAL_NU0)))
    return add_thermal_emission(model) if thermal else model


def sif_column_model(nu_grid, dtype=np.float32, nstreams=8,
                     polarization=STOKES_IQU, fused=None):
    """RTModel of the RRS+SIF scene's column on the wavenumber grid
    ``nu_grid``: 8 Rayleigh layers (230-290 K, 50-1013 hPa) over a
    0.05-albedo Lambertian floor emitting SIF of 1e-3, sza 45, vza
    0/30/60."""
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    params = Parameters(
        spec_bands=[nu_grid],
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar", [0.05])],
        nstreams=nstreams, polarization=polarization,
        sza=45.0, vza=[0.0, 30.0, 60.0], vaz=[0.0, 0.0, 0.0], obs_alt=0.0,
        T=np.linspace(230.0, 290.0, 8), p=np.linspace(50.0, 1013.0, 9),
        depol=-1.0, float_type=dtype, fused=fused)
    model = model_from_parameters(params)
    model.bands[0].sif_spec = 1e-3 * np.ones(len(nu_grid))
    return model


def rrs_sif_model(n_spec=256, dtype=np.float32, nstreams=8,
                  polarization=STOKES_IQU, fused=None):
    """RTModel of the RRS+SIF scene: ``sif_column_model`` from 12950
    cm^-1 at 0.6 cm^-1 steps; at nSpec = 256 the rotational-Raman
    redistribution has 58 shifts."""
    return sif_column_model(12950.0 + 0.6 * np.arange(n_spec), dtype,
                            nstreams, polarization, fused)


def vs_sif_model(mode="VS_0to1", dtype=np.float32):
    """RTModel of the vibrational-Raman scene: the RRS+SIF column on
    ``vs_band_grid(25000.0, mode=mode)`` (the reference's recipe: the
    incident 25000 cm^-1, then the scattered band 400 cm^-1 wide at 0.3
    cm^-1 around the mean N2/O2 Q-branch shift; 1335 points, 15 of them
    with weight)."""
    from .inelastic.vs_setup import vs_band_grid
    return sif_column_model(vs_band_grid(25000.0, mode=mode), dtype)


def stellar_f0_dip(nu_grid, width=12.0, depth=0.7):
    """A Fraunhofer-like line in a flat stellar spectrum: 1 - depth
    exp(-((nu - nu_c) / width)^2) about the grid's middle point nu_c (the
    JAX package's stellar Ring test: a 70% deep line, 12 cm^-1 wide)."""
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    x = (nu_grid - nu_grid[len(nu_grid) // 2]) / width
    return 1.0 - depth * np.exp(-x ** 2)


#: The stellar rotational-Raman scene's grid: 1024 points from 18000 cm^-1
#: (555.6 nm) at 1.5625 cm^-1, which the H2 lines reach in 8 shifts.
STELLAR_NU0, STELLAR_STEP = 18000.0, 1.5625


def stellar_sif_model(n_spec=1024, dtype=np.float32):
    """RTModel of the stellar rotational-Raman scene: the RRS+SIF column
    from ``STELLAR_NU0`` at ``STELLAR_STEP`` with the stellar spectrum
    ``stellar_f0_dip`` as ``f0_spec``."""
    nu = STELLAR_NU0 + STELLAR_STEP * np.arange(n_spec)
    model = sif_column_model(nu, dtype)
    model.bands[0].f0_spec = stellar_f0_dip(nu)
    return model


def stellar_vs_sif_model(mode="sol_VS_0to1", dtype=np.float32):
    """RTModel of the stellar vibrational-Raman scene: the RRS+SIF column
    on ``sol_vs_plus_grid(540.0, mode, dnu=1.0)`` (the incident 540 nm,
    then the H2 rovibrational band: 3552 points for sol_VS_0to1)."""
    from .inelastic.stellar import sol_vs_plus_grid
    return sif_column_model(sol_vs_plus_grid(540.0, mode, dnu=1.0), dtype)


#: The small RRS scene of ``data/rrs_ref_f64.npz`` (the scene of the JAX
#: package's tests/test_fused_rrs.py cut to nSpec = 16): floor albedo,
#: surface SIF and width.
RRS_REF_ALBEDO, RRS_REF_SIF, RRS_REF_N_SPEC = 0.1, 2e-3, 16


def rrs_ref_params(n_spec=RRS_REF_N_SPEC):
    """``Parameters`` keywords of the small RRS scene, less ``surfaces`` and
    ``polarization``: 3 Rayleigh layers, nstreams 4, 2.4 cm^-1 spacing, f32
    (plain data, so the JAX package's ``Parameters`` takes them too)."""
    return dict(spec_bands=[12950.0 + 2.4 * np.arange(n_spec)], nstreams=4,
                sza=42.0, vza=[15.0, 45.0], vaz=[0.0, 30.0], obs_alt=0.0,
                T=np.array([240.0, 260.0, 280.0]),
                p=np.array([200.0, 500.0, 800.0, 1013.0]), depol=-1.0,
                float_type=np.float32)


def rrs_ref_model(n_spec=RRS_REF_N_SPEC, polarization=STOKES_IQU):
    """RTModel of the small RRS scene: ``rrs_ref_params`` over a
    ``RRS_REF_ALBEDO`` Lambertian floor emitting SIF of ``RRS_REF_SIF``."""
    model = model_from_parameters(Parameters(
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar",
                                    [RRS_REF_ALBEDO])],
        polarization=polarization, **rrs_ref_params(n_spec)))
    model.bands[0].sif_spec = RRS_REF_SIF * np.ones(n_spec)
    return model


def lin_ref_params(dtype=np.float32):
    """``Parameters`` keywords of the small aerosol Jacobian scene, less
    ``surfaces``, ``polarization`` and ``scattering_params``: the scene of
    the JAX package's tests/test_linearization.py (3 layers, nstreams 4,
    two points near 755 nm, sza 40) with delta-BGE truncation, so that its
    Mie optics build in seconds (plain data: the JAX package's
    ``Parameters`` takes them too)."""
    nu0 = 1e7 / 755.0
    return dict(spec_bands=[np.array([nu0, nu0 + 0.5])], nstreams=4,
                sza=40.0, vza=[10.0, 45.0], vaz=[30.0, 150.0], obs_alt=0.0,
                T=np.array([230.0, 260.0, 285.0]),
                p=np.array([10.0, 400.0, 800.0, 1013.0]), depol=0.0,
                truncation="deltaBGE", float_type=dtype)


#: The aerosol of the small Jacobian scene (RTAerosol keywords) and its
#: Mie quadrature: 60 radius nodes to r_max 10 um, k_ref at 755 nm.
LIN_REF_AEROSOL = dict(tau_ref=0.15, p0=700.0, sigma_p=60.0,
                       mu_log=float(np.log(0.12)),
                       sigma_log=float(np.log(1.5)), n_r=1.4, n_i=0.003)
LIN_REF_MIE = dict(nquad_radius=60, r_max=10.0, lambda_ref=0.755)


def lin_ref_model(dtype=np.float32, surface="coxmunk"):
    """RTModel of the small aerosol Jacobian scene: ``lin_ref_params`` with
    one Mie aerosol, over a wind-6 Cox-Munk ocean (IQU; 7 aerosol + wind
    parameters) or, with ``surface="lambertian"``, a 0.2-albedo floor."""
    from .scattering.stokes import STOKES_IQU
    if surface == "coxmunk":
        surf = SurfaceDescriptor("CoxMunkSurface", [], {"wind_speed": 6.0})
    else:
        surf = SurfaceDescriptor("LambertianSurfaceScalar", [0.2])
    return model_from_parameters(Parameters(
        surfaces=[surf], polarization=STOKES_IQU,
        scattering_params=ScatteringParams(
            rt_aerosols=[RTAerosol(**LIN_REF_AEROSOL)], **LIN_REF_MIE),
        **lin_ref_params(dtype)))


#: Seed and range of the per-layer thermal source of the small thermal
#: Jacobian scene (``data/lin_thermal_ref_f64.npz``).
LIN_THERMAL_SEED, LIN_THERMAL_RANGE = 5, (0.05, 0.5)


def lin_thermal_b(nz, n_spec):
    """(nz, n_spec) thermal source of the small thermal Jacobian scene:
    uniform in ``LIN_THERMAL_RANGE`` from ``LIN_THERMAL_SEED``."""
    return np.random.default_rng(LIN_THERMAL_SEED).uniform(
        *LIN_THERMAL_RANGE, (nz, n_spec))


def lin_thermal_model(dtype=np.float32):
    """``lin_ref_model()`` (Cox-Munk) with the seeded thermal source
    ``lin_thermal_b``: a K = 2 scene of N = 21 and 8 parameters."""
    model = lin_ref_model(dtype)
    model.bands[0].thermal_b = lin_thermal_b(model.profile.nz,
                                             model.bands[0].n_spec)
    return model


#: The small vibrational-Raman scene of ``data/vs_ref_f64.npz`` (the scene
#: of the JAX package's tests/test_raman.py TestVibrationalRaman, its grid
#: cut to 102 points): ``vs_band_grid(25000.0, VS_REF_HALF_WIDTH,
#: VS_REF_STEP)`` (15 targets with weight) and the column's Rayleigh depth.
VS_REF_HALF_WIDTH, VS_REF_STEP, VS_REF_TAU = 200.0, 4.0, 0.15


def vs_ref_params(mode="VS_0to1"):
    """``Parameters`` keywords of the small VS scene, less ``surfaces`` and
    ``polarization``: 2 layers, nstreams 4, sza 45, f32 (plain data, so
    the JAX package's ``Parameters`` takes them too)."""
    from .inelastic.vs_setup import vs_band_grid
    return dict(spec_bands=[vs_band_grid(25000.0, VS_REF_HALF_WIDTH,
                                         VS_REF_STEP, mode)],
                nstreams=4, sza=45.0, vza=[0.0, 40.0], vaz=[0.0, 90.0],
                obs_alt=0.0, T=np.array([250.0, 275.0]),
                p=np.array([100.0, 500.0, 1013.0]), depol=-1.0,
                float_type=np.float32)


def vs_ref_model(mode="VS_0to1", polarization=STOKES_IQU):
    """RTModel of the small VS scene: ``vs_ref_params`` over a black
    Lambertian floor, the Rayleigh depth ``VS_REF_TAU`` split evenly over
    the two layers."""
    model = model_from_parameters(Parameters(
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar", [0.0])],
        polarization=polarization, **vs_ref_params(mode)))
    model.bands[0].tau_rayl[:] = VS_REF_TAU / 2
    return model


#: The small stellar scenes of ``data/stellar_ref_f64.npz`` (the scene of
#: the JAX package's tests/test_stellar_raman.py): the sol_RRS grid
#: (200 points, 8 H2 shifts), the sol_VS grid step and the column's
#: scattering depth.
STELLAR_REF_NU = np.arange(18000.0, 19600.0, 8.0)
STELLAR_REF_VS_STEP, STELLAR_REF_TAU = 16.0, 0.3


def stellar_ref_params(mode="sol_RRS"):
    """``Parameters`` keywords of the small stellar scene, less
    ``surfaces`` and ``polarization``: 2 layers, nstreams 4, sza 30, the
    H2 Rayleigh depolarization 0.02, f32; the grid ``STELLAR_REF_NU`` for
    sol_RRS, ``sol_vs_plus_grid(540.0, mode, STELLAR_REF_VS_STEP)``
    otherwise (plain data: the JAX package's ``Parameters`` takes them
    too)."""
    from .inelastic.stellar import sol_vs_plus_grid
    nu = STELLAR_REF_NU if mode == "sol_RRS" else \
        sol_vs_plus_grid(540.0, mode, dnu=STELLAR_REF_VS_STEP)
    return dict(spec_bands=[np.asarray(nu, dtype=np.float64)], nstreams=4,
                sza=30.0, vza=[0.0, 40.0], vaz=[0.0, 0.0], obs_alt=0.0,
                T=np.array([200.0, 300.0]),
                p=np.array([100.0, 500.0, 1013.0]), depol=0.02,
                float_type=np.float32)


def stellar_ref_model(mode="sol_RRS"):
    """RTModel of the small stellar scene: ``stellar_ref_params(mode)``,
    Stokes I, over a black Lambertian floor, the scattering depth
    ``STELLAR_REF_TAU`` split evenly over the layers (the H2 column); for
    sol_RRS the stellar spectrum ``stellar_f0_dip`` as ``f0_spec``."""
    model = model_from_parameters(Parameters(
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar", [0.0])],
        polarization=STOKES_I, **stellar_ref_params(mode)))
    band = model.bands[0]
    band.tau_rayl[:] = STELLAR_REF_TAU / band.tau_rayl.shape[1]
    if mode == "sol_RRS":
        band.f0_spec = stellar_f0_dip(band.nu_grid)
    return model


#: The small multisensor-Raman scene of ``data/ms_rrs_ref_f64.npz`` (the
#: scene of the JAX package's tests/test_multisensor_rrs.py, its RRS grid
#: cut to 16 points, 6 shifts): the RRS grid, the floor's albedo, each
#: layer's Rayleigh depth and the sensor levels.
MS_RRS_REF_NU = 12950.0 + 2.0 * np.arange(16)
MS_RRS_REF_ALBEDO, MS_RRS_REF_TAUS = 0.3, (0.075, 0.075)
MS_RRS_REF_LEVELS = (0, 1, 2)


def ms_rrs_ref_params(mode="RRS"):
    """``Parameters`` keywords of the small multisensor-Raman scene, less
    ``surfaces`` and ``polarization``: 2 layers, nstreams 4, sza 45, f32;
    the grid ``MS_RRS_REF_NU`` for RRS, ``vs_ref_params``'s for the VS
    modes (plain data: the JAX package's ``Parameters`` takes them too)."""
    nu = MS_RRS_REF_NU if mode == "RRS" else \
        vs_ref_params(mode)["spec_bands"][0]
    return dict(spec_bands=[nu], nstreams=4, sza=45.0, vza=[0.0, 40.0],
                vaz=[0.0, 90.0], obs_alt=0.0, T=np.linspace(250.0, 285.0, 2),
                p=np.linspace(100.0, 1013.0, 3), depol=-1.0,
                float_type=np.float32)


def ms_rrs_ref_model(mode="RRS", polarization=STOKES_IQU):
    """RTModel of the small multisensor-Raman scene: ``ms_rrs_ref_params``
    over a ``MS_RRS_REF_ALBEDO`` Lambertian floor, layer Rayleigh depths
    ``MS_RRS_REF_TAUS``."""
    model = model_from_parameters(Parameters(
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar",
                                    [MS_RRS_REF_ALBEDO])],
        polarization=polarization, **ms_rrs_ref_params(mode)))
    for i, t in enumerate(MS_RRS_REF_TAUS):
        model.bands[0].tau_rayl[:, i] = t
    return model


# ---------------------------------------------------------------------------
# The O2 A-band scene
# ---------------------------------------------------------------------------

#: First wavenumber of the A-band scene [cm^-1]; at 0.05 cm^-1 steps its
#: 4096 points span 12980-13184.75 cm^-1 (the P and R branches of 16O2).
ABAND_NU0 = 12980.0
#: O2 volume mixing ratio of the A-band scenes, and the seed of their
#: synthetic line list.
ABAND_VMR_O2, ABAND_SEED = 0.2095, 12
#: Band origin [cm^-1], lower- and upper-state rotational constants [cm^-1]
#: and relative abundance of the synthetic list's three O2 isotopologues
#: (HITRAN iso 1 16O2, 2 16O18O, 3 16O17O).
ABAND_ISOS = {1: (13122.0, 1.438, 1.391, 1.0),
              2: (13118.0, 1.357, 1.313, 4.0e-3),
              3: (13120.0, 1.395, 1.350, 7.4e-4)}
#: Strength [cm/molecule] of the strongest 16O2 line, the number of weak
#: background lines and their strength range.
ABAND_S_MAX, ABAND_N_WEAK, ABAND_S_WEAK = 1e-23, 636, (1e-28, 1e-26)


def aband_lines(seed=ABAND_SEED) -> dict:
    """A SYNTHETIC O2 A-band line list, drawn from ``seed`` with numpy: the
    columns of a ``HitranTable`` (molecule 7).

    No HITRAN O2 line list is in the repository, so the A-band scenes run
    on this one; a real HITRAN list replaces it once one is in the
    repository. The lines are the P and R branches of a rigid rotor: for
    each isotopologue of ``ABAND_ISOS``, nu = nu0 + B' J'(J' + 1) -
    B'' J''(J'' + 1) with J' = J'' -+ 1, E'' = B'' J''(J'' + 1), strengths
    on a 296 K Boltzmann envelope (2 J'' + 1) exp(-c2 E'' / 296) scaled so
    that the strongest 16O2 line is ``ABAND_S_MAX`` and the others by their
    abundance: 16O2 with odd J'' <= 61 in two spin components 1.9 cm^-1
    apart, the minor isotopologues with every J'' <= 60; plus
    ``ABAND_N_WEAK`` weak 16O2 lines spread over 12940-13225 cm^-1. Line
    cores saturate (column tau >> 1) while the points between the branches
    stay near the Rayleigh optical depth. gamma_air 0.04-0.05, n_air ~0.7,
    delta_air ~-0.008."""
    rng = np.random.default_rng(seed)
    c2 = 1.4387769
    cols = {k: [] for k in ("iso", "nu", "sw", "e_lower")}
    for iso, (nu0, b_lo, b_up, abund) in ABAND_ISOS.items():
        J = np.arange(1, 62, 2) if iso == 1 else np.arange(1, 61)
        e_low = b_lo * J * (J + 1)
        envelope = (2 * J + 1) * np.exp(-c2 * e_low / 296.0)
        envelope = abund * envelope / envelope.max()
        for Jp in (J - 1, J + 1):                       # P and R branches
            nu = nu0 + b_up * Jp * (Jp + 1) - e_low
            for shift in ((0.0, 1.9) if iso == 1 else (0.0,)):
                cols["iso"].append(np.full(J.size, iso))
                cols["nu"].append(nu + shift)
                cols["sw"].append(envelope)
                cols["e_lower"].append(e_low)
    cols = {k: np.concatenate(v) for k, v in cols.items()}
    cols["sw"] = ABAND_S_MAX * cols["sw"]
    n = cols["nu"].size + ABAND_N_WEAK
    cols["iso"] = np.concatenate([cols["iso"], np.ones(ABAND_N_WEAK, int)])
    cols["nu"] = np.concatenate([cols["nu"],
                                 rng.uniform(12940.0, 13225.0, ABAND_N_WEAK)])
    cols["sw"] = np.concatenate([cols["sw"], 10 ** rng.uniform(
        *np.log10(ABAND_S_WEAK), ABAND_N_WEAK)])
    cols["e_lower"] = np.concatenate([cols["e_lower"],
                                      rng.uniform(0.0, 1500.0, ABAND_N_WEAK)])
    order = np.argsort(cols["nu"], kind="stable")
    out = {k: v[order] for k, v in cols.items()}
    out["mol"] = np.full(n, 7)
    out["gamma_air"] = rng.uniform(0.04, 0.05, n)
    out["gamma_self"] = out["gamma_air"] + 0.002
    out["n_air"] = 0.7 + rng.uniform(-0.03, 0.03, n)
    out["delta_air"] = -0.008 + rng.uniform(-0.001, 0.001, n)
    return out


def write_aband_par(path=None, seed=ABAND_SEED) -> str:
    """Write ``aband_lines(seed)`` as a HITRAN .par file of 160-character
    records to ``path`` (default ``aband_synthetic_<seed>.par`` in the
    temporary directory), replaced atomically, and return the path."""
    path = Path(path) if path is not None else \
        Path(tempfile.gettempdir()) / f"aband_synthetic_{seed}.par"
    lines = aband_lines(seed)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".par")
    with os.fdopen(fd, "w") as f:
        for k in range(len(lines["nu"])):
            # the fields a HitranTable reads; Einstein A 1e-9, the rest blank
            rec = (f"{int(lines['mol'][k]):2d}{int(lines['iso'][k]):1d}"
                   f"{lines['nu'][k]:12.6f}{lines['sw'][k]:10.3E}{1e-9:10.3E}"
                   f"{lines['gamma_air'][k]:5.3f}"
                   f"{lines['gamma_self'][k]:5.3f}"
                   f"{lines['e_lower'][k]:10.4f}{lines['n_air'][k]:4.2f}"
                   f"{lines['delta_air'][k]:8.5f}")
            f.write(rec.ljust(160) + "\n")
    os.replace(tmp, path)
    return str(path)


def aband_absorption(par_path) -> dict:
    """``AbsorptionParams`` keywords of the A-band scenes: O2 at
    ``ABAND_VMR_O2`` from the line list at ``par_path`` (Voigt, the
    Humlicek/Weideman CEF, 40 cm^-1 wings; plain data, so the JAX
    package's ``AbsorptionParams`` takes them too)."""
    return dict(molecules=[["O2"]], vmr={"O2": ABAND_VMR_O2},
                par_paths={"O2": str(par_path)})


def aband_params(n_spec=4096, dtype=np.float32, nstreams=8, nz=None,
                 fused=None):
    """``Parameters`` keywords of the A-band scene, less ``surfaces``,
    ``polarization`` and ``absorption_params``: the flagship's
    (``flagship_params``) from ``ABAND_NU0``."""
    return flagship_params(n_spec, dtype, nstreams, nz, fused,
                           nu0=ABAND_NU0)


def aband_model(n_spec=4096, dtype=np.float32, nstreams=8, nz=None,
                fused=None, device=None, par_path=None):
    """RTModel of the O2 A-band scene: the flagship's column (33 layers),
    Cox-Munk ocean (wind 5), IQUV and nstreams 8 (N = 52) from
    ``ABAND_NU0`` at 0.05 cm^-1 steps, with O2 absorption from the
    synthetic line list (``write_aband_par`` unless ``par_path`` names
    one). The line sum runs on ``device`` (CUDA unless given). Its Jacobian
    layout is ("vmr_O2", "wind_speed")."""
    par = par_path if par_path is not None else write_aband_par()
    return model_from_parameters(Parameters(
        surfaces=[SurfaceDescriptor("CoxMunkSurface", [],
                                    {"wind_speed": 5.0})],
        polarization=STOKES_IQUV,
        absorption_params=AbsorptionParams(**aband_absorption(par)),
        **aband_params(n_spec, dtype, nstreams, nz, fused)), device=device)


#: Spectral points of the small A-band scene and their spacing [cm^-1]:
#: 3.75 cm^-1 around the strongest 16O2 line of the scene's grid.
ABAND_REF_N_SPEC, ABAND_REF_STEP = 16, 0.25


def aband_ref_params(dtype=np.float32):
    """``Parameters`` keywords of the small A-band scene, less
    ``surfaces``, ``polarization`` and ``absorption_params``: 3 layers,
    nstreams 4, sza 40, two views, 16 points 0.25 cm^-1 apart from 2 cm^-1
    below the strongest 16O2 line (plain data: the JAX package's
    ``Parameters`` takes them too)."""
    lines = aband_lines()
    strong = lines["nu"][np.argmax(np.where(lines["iso"] == 1, lines["sw"],
                                            0.0))]
    nu0 = np.round(strong, 1) - 2.0
    return dict(spec_bands=[nu0 + ABAND_REF_STEP * np.arange(
        ABAND_REF_N_SPEC)], nstreams=4, sza=40.0, vza=[10.0, 45.0],
        vaz=[30.0, 150.0], obs_alt=0.0, T=np.array([230.0, 260.0, 285.0]),
        p=np.array([10.0, 400.0, 800.0, 1013.0]), depol=-1.0,
        float_type=dtype)


def aband_ref_model(dtype=np.float32, surface="coxmunk", device=None,
                    par_path=None):
    """RTModel of the small A-band scene: ``aband_ref_params`` over a wind-5
    Cox-Munk ocean (or, with ``surface="lambertian"``, a 0.2-albedo floor),
    IQU, O2 from the synthetic line list; its Jacobian layout is ("vmr_O2",
    "wind_speed") (or ("vmr_O2", "albedo"))."""
    par = par_path if par_path is not None else write_aband_par()
    surf = SurfaceDescriptor("CoxMunkSurface", [], {"wind_speed": 5.0}) \
        if surface == "coxmunk" else \
        SurfaceDescriptor("LambertianSurfaceScalar", [0.2])
    return model_from_parameters(Parameters(
        surfaces=[surf], polarization=STOKES_IQU,
        absorption_params=AbsorptionParams(**aband_absorption(par)),
        **aband_ref_params(dtype)), device=device)


# ---------------------------------------------------------------------------
# The GEOS-Chem column scene
# ---------------------------------------------------------------------------

#: GCHP's native level count, the synthetic collections' cubed-sphere grid
#: (6 faces of 4 x 4 cells), the column the scenes read (idx, idy, idf;
#: 0-based) and the seed of the synthetic fields.
GEOSCHEM_N_LEV = 72
GEOSCHEM_NF, GEOSCHEM_NY, GEOSCHEM_NX = 6, 4, 4
GEOSCHEM_COLUMN = (1, 2, 3)
GEOSCHEM_SEED = 14
#: Top of the synthetic level grid [hPa]: at 72 levels its top layer is
#: ~0.01 hPa thick and its bottom one ~16 hPa, GEOS's 72-level shape.
GEOSCHEM_P_TOP = 0.04
#: The two-moment species of the synthetic Aerosols collection: the
#: two-moment reader's keys (GCHP's AOD and hygroscopic-radius diagnostics
#: for sulfate and accumulation-mode sea salt; GEOS-Chem fixes dust radii
#: per size bin, so the synthetic file carries a dust radius field of its
#: own) and, for the writer, the column AOD at 550 nm, the effective
#: radius [um] and the vertical shape: an exponential of scale height
#: ``h_km`` or, with ``z_km``, a Gaussian layer of 1/e half-width ``h_km``.
GEOSCHEM_SPECIES = {
    "SO4": dict(aod_variable="AODHyg550nm_{species}",
                radius_variable="AerHygroscopicRadius_{species}",
                sigma_g=1.6, refractive_index="sulfate_suso",
                aod_reference_wavelength=0.55,
                column_aod=0.12, r_eff=0.15, h_km=2.0),
    "SALA": dict(aod_variable="AODHyg550nm_{species}",
                 radius_variable="AerHygroscopicRadius_{species}",
                 sigma_g=1.5, refractive_index="seasalt_sscm",
                 aod_reference_wavelength=0.55,
                 column_aod=0.05, r_eff=0.35, h_km=0.8),
    "DST": dict(aod_variable="AODDust550nm",
                radius_variable="AerDustRadius",
                sigma_g=1.8, refractive_index="dust_opac",
                aod_reference_wavelength=0.55,
                column_aod=0.08, r_eff=0.8, h_km=1.2, z_km=3.0)}
#: Keys of a GEOSCHEM_SPECIES entry that the two-moment reader reads.
_TWO_MOMENT_KEYS = ("aod_variable", "radius_variable", "sigma_g",
                    "refractive_index", "aod_reference_wavelength")
#: The small GEOS-Chem scene of ``data/geoschem_ref_f64.npz``: levels,
#: species, streams, points and Mie radius nodes.
GEOSCHEM_REF_N_LEV, GEOSCHEM_REF_SPECIES = 6, ("SO4", "DST")
GEOSCHEM_REF_NSTREAMS, GEOSCHEM_REF_N_SPEC = 3, 8
GEOSCHEM_REF_NQUAD = 60


def geoschem_aerosol_config(species=tuple(GEOSCHEM_SPECIES)) -> dict:
    """The two-moment reader's configuration of the synthetic Aerosols
    collection (plain data: the JAX package's ``read_aerosol_data`` takes
    it too), with ``vertical_flip`` so that the aerosol levels run TOA ->
    BOA like the met column of ``geoschem_to_dict``."""
    return {"aerosol_scheme": {
        "type": "two_moment",
        "species": {s: {k: GEOSCHEM_SPECIES[s][k] for k in _TWO_MOMENT_KEYS}
                    for s in species}},
        "processing": {"vertical_flip": True}}


def _us_standard_temperature(z_km):
    """US Standard Atmosphere 1976 temperature [K] at altitude z [km]."""
    base = [(0.0, 288.15, -6.5), (11.0, 216.65, 0.0), (20.0, 216.65, 1.0),
            (32.0, 228.65, 2.8), (47.0, 270.65, 0.0), (51.0, 270.65, -2.8),
            (71.0, 214.65, -2.0)]
    T = np.empty_like(z_km)
    for z0, t0, lapse in base:
        at = z_km >= z0
        T[at] = t0 + lapse * (z_km[at] - z0)
    return T


def geoschem_fields(seed=GEOSCHEM_SEED, n_lev=GEOSCHEM_N_LEV,
                    species=tuple(GEOSCHEM_SPECIES)) -> dict:
    """SYNTHETIC GCHP fields, drawn from ``seed`` with numpy, in GCHP's C
    order ``(time=1, lev, nf, Ydim, Xdim)`` with ``lev`` BOA -> TOA (the
    surface pressure ``(time, nf, Ydim, Xdim)``).

    No GEOS-Chem output is in the repository; these fields stand in for
    it. Met: ``Met_PS2WET`` about 1000 hPa (+-5); ``Met_DELP`` [hPa] on
    edges ps exp(ln(p_top / ps) (k / n_lev)^1.5); ``Met_T`` the US Standard
    Atmosphere at z = 7 km ln(1000 / p) plus 1 K noise; ``Met_SPHU``
    12 exp(-z / 2.2 km) + 0.003 g/kg. Aerosols: for each species of
    ``GEOSCHEM_SPECIES``, its AOD diagnostic per layer (its vertical shape
    times the layer's pressure thickness, each cell's column scaled by
    0.8-1.2 of the species' column AOD) and its radius diagnostic (the
    effective radius, 30% larger in moist layers, 5% noise)."""
    rng = np.random.default_rng(seed)
    cells = (GEOSCHEM_NF, GEOSCHEM_NY, GEOSCHEM_NX)
    ps = 1000.0 + rng.uniform(-5.0, 5.0, (1,) + cells)
    x = (np.arange(n_lev + 1) / n_lev) ** 1.5
    edges = ps[:, None] * np.exp(
        np.log(GEOSCHEM_P_TOP / 1000.0) * x[None, :, None, None, None])
    delp = edges[:, :-1] - edges[:, 1:]
    p_mid = 0.5 * (edges[:, :-1] + edges[:, 1:])
    z = 7.0 * np.log(1000.0 / p_mid)
    shape = (1, n_lev) + cells
    fields = {
        "Met_PS2WET": ps, "Met_DELP": delp,
        "Met_T": _us_standard_temperature(z) + rng.normal(0.0, 1.0, shape),
        "Met_SPHU": 12.0 * np.exp(-z / 2.2) + 0.003}
    moist = np.exp(-z / 2.2)
    for s in species:
        sp = GEOSCHEM_SPECIES[s]
        if "z_km" in sp:
            prof = np.exp(-((z - sp["z_km"]) / sp["h_km"]) ** 2)
        else:
            prof = np.exp(-z / sp["h_km"])
        aod = prof * delp
        aod *= sp["column_aod"] * rng.uniform(0.8, 1.2, (1, 1) + cells) \
            / aod.sum(axis=1, keepdims=True)
        radius = sp["r_eff"] * (1.0 + 0.3 * moist) \
            * (1.0 + 0.05 * rng.standard_normal(shape))
        fields[sp["aod_variable"].replace("{species}", s)] = aod
        fields[sp["radius_variable"].replace("{species}", s)] = radius
    return fields


_GCHP_DIMS = ("time", "lev", "nf", "Ydim", "Xdim")


def _write_netcdf3(path, variables, dims, n_lev):
    """Write ``variables`` ({name: (dimension names, array)}) with a ``lev``
    (1..n_lev) and a ``time`` coordinate as NetCDF-3 float64 through
    scipy, replacing ``path`` atomically."""
    from scipy.io import netcdf_file
    path = Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".nc")
    os.close(fd)
    with netcdf_file(tmp, "w") as nc:
        for name, size in dims.items():
            nc.createDimension(name, size)
        lev = nc.createVariable("lev", "d", ("lev",))
        lev[:] = np.arange(1, n_lev + 1, dtype=np.float64)
        lev.positive = b"up"
        time = nc.createVariable("time", "d", ("time",))
        time[:] = [0.0]
        for name, (var_dims, arr) in variables.items():
            nc.createVariable(name, "d", var_dims)[:] = arr
    os.replace(tmp, path)
    return str(path)


def write_geoschem_column(directory=None, seed=GEOSCHEM_SEED,
                          n_lev=GEOSCHEM_N_LEV,
                          species=tuple(GEOSCHEM_SPECIES)) -> dict:
    """Write ``geoschem_fields(seed, n_lev, species)`` as two SYNTHETIC
    GCHP collections, NetCDF-3 through scipy, into ``directory`` (default:
    the temporary directory): ``met``, the StateMet collection, and
    ``aerosols``, the Aerosols collection, both in GCHP's C order ``(time,
    lev, nf, Ydim, Xdim)``; and ``aerosols_lev_time``, the same aerosol
    profiles as ``(lev, time)`` fields (each the horizontal mean profile of
    its GCHP field, ``aerosols.ncio.horizontal_mean_profile``): the layout
    the JAX package's aerosol readers read right. Returns the three paths
    by those names."""
    from .aerosols.ncio import horizontal_mean_profile
    directory = Path(directory) if directory is not None else \
        Path(tempfile.gettempdir())
    fields = geoschem_fields(seed, n_lev, species)
    dims = dict(zip(_GCHP_DIMS, (1, n_lev, GEOSCHEM_NF, GEOSCHEM_NY,
                                 GEOSCHEM_NX)))
    met = {k: (_GCHP_DIMS if v.ndim == 5 else ("time", "nf", "Ydim", "Xdim"),
               v) for k, v in fields.items() if k.startswith("Met_")}
    aer = {k: (_GCHP_DIMS, v) for k, v in fields.items()
           if not k.startswith("Met_")}
    twin = {k: (("lev", "time"), horizontal_mean_profile(v, d)[:, None])
            for k, (d, v) in aer.items()}
    tag = f"{seed}_{n_lev}_{'_'.join(species)}"
    return {
        "met": _write_netcdf3(directory / f"GEOSChem.StateMet.{tag}.nc",
                              met, dims, n_lev),
        "aerosols": _write_netcdf3(directory / f"GEOSChem.Aerosols.{tag}.nc",
                                   aer, dims, n_lev),
        "aerosols_lev_time": _write_netcdf3(
            directory / f"GEOSChem.Aerosols.{tag}.lev_time.nc", twin,
            {"lev": n_lev, "time": 1}, n_lev)}


def _toml_value(v):
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    return repr(float(v)) if isinstance(v, float) else str(v)


def geoschem_scene_toml(n_spec=4096, dtype=np.float32, nstreams=8,
                        polarization="Stokes_IQUV",
                        nquad_radius=FLAGSHIP_MIE["nquad_radius"]) -> str:
    """The GEOS-Chem scene file (TOML): the flagship's settings
    (``flagship_params``: sza 30, nine views, 0.05 cm^-1 steps from
    ``FLAGSHIP_NU0``) over a wind-5 Cox-Munk ocean, the automatic
    (delta-BGE) phase truncation, and a ``scattering`` block (the
    flagship's Mie radius range, lambda_ref 0.55 um) with no aerosol of its
    own: the aerosols, and the atmospheric profile, come from the
    GEOS-Chem collections (``geoschem_model``)."""
    flag = flagship_params(n_spec, dtype, nstreams)
    nu = FLAGSHIP_NU0 + 0.05 * (n_spec - 1)
    sections = {
        "radiative_transfer": {
            "spec_bands": [f"{FLAGSHIP_NU0!r}:0.05:{nu!r}"],
            "surface": ["CoxMunkSurface(wind_speed=5.0)"],
            "polarization_type": f"{polarization}()",
            "nstreams": nstreams, "truncation": "auto", "depol": -1.0,
            "float_type": "Float32" if dtype == np.float32 else "Float64",
            "architecture": "default_architecture"},
        "geometry": {k: flag[k] for k in ("sza", "vza", "vaz", "obs_alt")},
        "scattering": {"aerosols": [], "r_max": FLAGSHIP_MIE["r_max"],
                       "nquad_radius": nquad_radius,
                       "λ_ref": 0.55, "decomp_type": "NAI2()"}}
    lines = ["# GEOS-Chem column scene: the atmospheric profile and the",
             "# aerosols are read from the GEOS-Chem collections."]
    for name, sec in sections.items():
        lines.append(f"\n[{name}]")
        for k, v in sec.items():
            key = k if k.isascii() else f'"{k}"'
            lines.append(f"{key} = {_toml_value(v)}")
    return "\n".join(lines) + "\n"


def geoschem_model(n_spec=4096, dtype=np.float32, files=None, device=None,
                   validate=False, nstreams=8, polarization="Stokes_IQUV",
                   species=tuple(GEOSCHEM_SPECIES),
                   nquad_radius=FLAGSHIP_MIE["nquad_radius"],
                   n_lev=GEOSCHEM_N_LEV):
    """RTModel of the GEOS-Chem column scene, built as a user of the front
    end builds it: the scene file (``geoschem_scene_toml``, written next to
    the collections) loaded (``io.formats.load_config``) with the
    ``atmospheric_profile`` of the GCHP column ``GEOSCHEM_COLUMN`` (idx,
    idy, idf) put in (``io.geoschem.geoschem_to_dict``; checked against
    the schema with ``validate``, which needs ``jsonschema``), then
    ``parameters_from_dict``, then the two-moment aerosols of the Aerosols
    collection (``read_aerosol_data`` in GCHP's layout, ``to_rt_aerosols``
    at the column's layer mid-pressures) as the scene's aerosols, then
    ``model_from_parameters`` (on ``device``, used by a gas line sum only).

    ``files`` are ``write_geoschem_column``'s paths; by default the
    collections of ``GEOSCHEM_SEED``, ``n_lev`` and ``species`` are written
    to the temporary directory. At the defaults: 72 layers, three Mie
    aerosols (sulfate, sea salt, dust; 300 radius nodes to 10 um), IQUV and
    nstreams 8 (N = 52), f32, 4096 points."""
    from .aerosols import (load_refractive_index_database,
                           read_aerosol_data, to_rt_aerosols)
    from .io.formats import load_config, validate_config
    from .io.geoschem import GeosChemSource, geoschem_to_dict
    from .io.yaml_input import parameters_from_dict
    if files is None:
        files = write_geoschem_column(n_lev=n_lev, species=species)
    met = Path(files["met"])
    scene = met.with_name(f"geoschem_scene_{n_spec}_{np.dtype(dtype).name}_"
                          f"{nstreams}_{polarization}_{nquad_radius}.toml")
    fd, tmp = tempfile.mkstemp(dir=scene.parent, suffix=".toml")
    with os.fdopen(fd, "w") as f:
        f.write(geoschem_scene_toml(n_spec, dtype, nstreams, polarization,
                                    nquad_radius))
    os.replace(tmp, scene)
    d = load_config(str(scene))
    prof = geoschem_to_dict(GeosChemSource(str(met), *GEOSCHEM_COLUMN))
    d["atmospheric_profile"] = {            # lists: the schema's arrays
        k: v.tolist() if isinstance(v, np.ndarray) else v
        for k, v in prof["atmospheric_profile"].items()}
    if validate:
        validate_config(d)
    params = parameters_from_dict(d)
    p_half = np.asarray(d["atmospheric_profile"]["p"])
    data = read_aerosol_data(geoschem_aerosol_config(species),
                             files["aerosols"])
    params.scattering_params.rt_aerosols = to_rt_aerosols(
        data, load_refractive_index_database(),
        p_full=0.5 * (p_half[1:] + p_half[:-1]))
    return model_from_parameters(params, device=device)


def geoschem_ref_model(dtype=np.float64, files=None, device=None,
                       validate=False):
    """RTModel of the small GEOS-Chem scene of ``data/geoschem_ref_f64.npz``:
    ``geoschem_model`` on collections of ``GEOSCHEM_REF_N_LEV`` levels and
    the species ``GEOSCHEM_REF_SPECIES``, nstreams 3, IQU, 8 points, 60
    Mie radius nodes, f64 by default."""
    return geoschem_model(
        GEOSCHEM_REF_N_SPEC, dtype, files, device, validate,
        nstreams=GEOSCHEM_REF_NSTREAMS, polarization="Stokes_IQU",
        species=GEOSCHEM_REF_SPECIES, nquad_radius=GEOSCHEM_REF_NQUAD,
        n_lev=GEOSCHEM_REF_N_LEV)


# ---- The land-surface and single-scatter scenes ----

#: The red-edge band of the canopy scene: 0.4 cm^-1 steps from 13245 cm^-1
#: (755 nm; 4096 points reach 14883 cm^-1, 672 nm).
CANOPY_NU0, CANOPY_DNU = 13245.0, 0.4
#: The canopy's leaf optics grid [nm]: 5 nm steps from 650 to 800 nm.
CANOPY_LEAF_GRID_NM = np.arange(650.0, 800.0 + 1e-9, 5.0)
#: Leaf area index, sublayers, leaf-angle distribution and clumping.
CANOPY_LAI, CANOPY_LAYERS, CANOPY_LAD, CANOPY_CLUMPING = 3.0, 3, \
    "spherical", 1.0
#: The RPV soil under the canopy: rpvSurfaceScalar(rho0, rho_c, k, theta).
CANOPY_SOIL = ("rpvSurfaceScalar", [0.1, 0.1, 0.75, -0.1])
#: The small canopy scene of ``data/surfaces_ref_f64.npz``: 8 points across
#: the band, 6 layers, nstreams 3, IQU.
CANOPY_REF_NU = np.linspace(CANOPY_NU0, CANOPY_NU0 + CANOPY_DNU * 4095, 8)
CANOPY_REF_NZ, CANOPY_REF_NSTREAMS = 6, 3


def canopy_leaf_optics(grid_nm=CANOPY_LEAF_GRID_NM, edge_nm=715.0,
                       scale_nm=10.0):
    """SYNTHETIC leaf optics (no PROSPECT table is in the repository): a
    logistic red edge at ``edge_nm`` (``scale_nm`` scale; 715 and 10 nm),
    reflectance 0.05 -> 0.45 and transmittance 0.03 -> 0.45 from the red
    to the near infrared. Returns (reflectance, transmittance) on
    ``grid_nm``."""
    edge = 1.0 / (1.0 + np.exp(-(np.asarray(grid_nm) - edge_nm) / scale_nm))
    return 0.05 + 0.40 * edge, 0.03 + 0.42 * edge


def canopy_surface(LAI=CANOPY_LAI, band_nu=None) -> SurfaceDescriptor:
    """The canopy over its RPV soil, as a ``SurfaceDescriptor``: LAI in
    ``CANOPY_LAYERS`` equal sublayers, spherical LAD, no clumping, the
    leaf optics of ``canopy_leaf_optics`` on a 5 nm grid (``n_coarse`` 7
    nodes on the band: spectrally resolved surface operators). With
    ``band_nu`` (a band's wavenumbers) the synthetic red edge moves to the
    band's middle wavelength, its scale an eighth of the band's width, on
    a grid of 31 points across the band: the surface then varies across
    any band, not only across the red edge."""
    from .surfaces.canopy import CanopySurface
    grid = CANOPY_LEAF_GRID_NM.copy()
    rho, tau = canopy_leaf_optics()
    if band_nu is not None:
        lam = 1e7 / np.asarray(band_nu, dtype=np.float64)
        lo, hi = float(lam.min()), float(lam.max())
        grid = np.linspace(lo, hi, 31)
        rho, tau = canopy_leaf_optics(grid, 0.5 * (lo + hi),
                                      max(hi - lo, 1e-3) / 8.0)
    return SurfaceDescriptor("CanopySurface", [], {
        "_surface_obj": CanopySurface(
            soil=SurfaceDescriptor(CANOPY_SOIL[0], list(CANOPY_SOIL[1])),
            LAI=float(LAI), n_layers=CANOPY_LAYERS, leaf_reflectance=rho,
            leaf_transmittance=tau, leaf_optics_grid=grid, grid_unit="nm",
            clumping_omega=CANOPY_CLUMPING, lad=CANOPY_LAD, n_coarse=7)})


def over_canopy(model, device=None):
    """``model``'s scene with the canopy of ``canopy_surface`` in place of
    each band's surface, its red edge moved into that band
    (``band_nu``): a spectrally resolved (4-D) surface on any of the
    entry points' scenes. Each band's f0_spec, sif_spec and thermal_b are
    carried over; the canopy's slab is built on ``device`` (CUDA unless
    given) at every ``build_band``."""
    import dataclasses
    params = dataclasses.replace(model.params, surfaces=[
        canopy_surface(band_nu=b.nu_grid) for b in model.bands])
    out = model_from_parameters(params, device=device)
    for band, src in zip(out.bands, model.bands):
        for f in ("f0_spec", "sif_spec", "thermal_b"):
            setattr(band, f, getattr(src, f))
    return out


def canopy_params(nu, dtype=np.float32, nstreams=8, nz=None,
                  polarization=STOKES_IQUV, LAI=CANOPY_LAI,
                  soil_only=False) -> Parameters:
    """``Parameters`` of the canopy scenes on the grid ``nu``: the
    flagship's column, geometry and settings over the canopy (or, with
    ``soil_only``, over its bare RPV soil)."""
    kw = flagship_params(len(nu), dtype, nstreams, nz)
    kw["spec_bands"] = [np.asarray(nu, dtype=np.float64)]
    surf = SurfaceDescriptor(CANOPY_SOIL[0], list(CANOPY_SOIL[1])) \
        if soil_only else canopy_surface(LAI)
    return Parameters(surfaces=[surf], polarization=polarization, **kw)


def with_sources(model):
    """The canopy scenes' sources on every band: the synthetic solar
    spectrum (``solar.default_solar_spectrum``) as ``f0_spec`` and the
    default SIF shape (``sif.build_sif_source``). Returns the model."""
    from .sif import build_sif_source
    from .solar import default_solar_spectrum
    for band in model.bands:
        band.f0_spec = default_solar_spectrum(band.nu_grid)
    return build_sif_source(model)


def canopy_model(n_spec=4096, dtype=np.float32, device=None, LAI=CANOPY_LAI,
                 soil_only=False):
    """RTModel of the vegetated red-edge column, the land slice's main
    path: the flagship's 33 layers, IQUV, nstreams 8, sza 30 and nine view
    angles (N = 52) over ``n_spec`` points at 0.4 cm^-1 from 13245 cm^-1
    (4096: 755 -> 672 nm); under it a canopy of LAI 3 in 3 sublayers
    (spherical LAD, clumping 1.0, SYNTHETIC leaf optics,
    ``canopy_leaf_optics``) over an RPV soil (rho0 0.1, rho_c 0.1, k 0.75,
    theta -0.1); ``f0_spec`` the synthetic solar spectrum and the default
    SIF shape (``with_sources``). The canopy's slab is built on ``device``
    (``model_from_parameters``; CUDA unless given) at every ``build_band``.
    ``soil_only`` drops the canopy (the LAI -> 0 control's twin)."""
    nu = CANOPY_NU0 + CANOPY_DNU * np.arange(n_spec)
    return with_sources(model_from_parameters(
        canopy_params(nu, dtype, LAI=LAI, soil_only=soil_only),
        device=device))


def canopy_ref_model(dtype=np.float64, device=None, LAI=CANOPY_LAI,
                     soil_only=False):
    """RTModel of the small canopy scene of ``data/surfaces_ref_f64.npz``:
    ``canopy_model``'s construction on ``CANOPY_REF_NU`` (8 points across
    the band), 6 layers, nstreams 3, IQU; f64 by default."""
    return with_sources(model_from_parameters(
        canopy_params(CANOPY_REF_NU, dtype, CANOPY_REF_NSTREAMS,
                      CANOPY_REF_NZ, STOKES_IQU, LAI, soil_only),
        device=device))


#: The small flagship scenes of ``data/surfaces_ref_f64.npz`` (single
#: scatter over Cox-Munk, Gauss-Radau streams): 8 points, 6 layers,
#: nstreams 3.
SURF_REF_N_SPEC, SURF_REF_NZ, SURF_REF_NSTREAMS = 8, 6, 3


def radau_params(n_spec=1024, dtype=np.float32, nstreams=8,
                 nz=None, polarization=STOKES_IQU) -> Parameters:
    """``Parameters`` of the flagship over Cox-Munk (wind 5) on Gauss-Radau
    streams (``quadrature="RadauQuad"``: the solar cosine a weighted node):
    at nstreams 8 Radau gives 14 nodes and the view angles three more, 17
    nodes, N = 51 at IQU and N = 68 at IQUV (the IQUV Radau flagship, a
    wide scene that K1 still takes in one block a point)."""
    kw = flagship_params(n_spec, dtype, nstreams, nz)
    return Parameters(
        surfaces=[SurfaceDescriptor("CoxMunkSurface", [], {"wind_speed": 5.0})],
        polarization=polarization, quadrature="RadauQuad", **kw)


def radau_model(n_spec=1024, dtype=np.float32, nstreams=8, nz=None,
                polarization=STOKES_IQU):
    """RTModel of ``radau_params`` (a host build)."""
    return model_from_parameters(radau_params(n_spec, dtype, nstreams, nz,
                                              polarization))


#: The exact single-scatter scenes: the flagship's geometry, a Rayleigh
#: column and a Henyey-Greenstein aerosol (g 0.7, ssa 0.9, tau 0.15
#: centred at 700 hPa, width 60 hPa).
EXACT_SS_HG = dict(g=0.7, ssa=0.9, tau_ref=0.15, p0=700.0, sigma_p=60.0)


def exact_ss_config(n_spec=4096, surface="lambertian", n_stokes=3, nz=None,
                    albedo=0.05, nu0=FLAGSHIP_NU0):
    """(``standalone_ss.ExactSSConfig``, its arrays as plain data) of the
    flagship's geometry (mu0 = cos 30 deg, the nine view angles and their
    azimuths) over ``nz`` layers of the flagship's column (None: all 33):
    Rayleigh (the band's optical depths and depolarization) plus the
    ``EXACT_SS_HG`` aerosol, over a Lambertian floor of ``albedo`` or a
    Cox-Munk ocean (wind 5). The plain data (``geometry``, ``rayleigh``,
    ``hg`` keywords) lets the JAX package build the same config."""
    from .core.atmosphere import aerosol_profile_shape
    from .standalone_ss import (CoxMunkSSSurface, ExactSSConfig,
                                HGAerosolSSContributor, LambertianSSSurface,
                                RayleighSSContributor, SSGeometry)
    host = flagship_model(n_spec, np.float64, nstreams=2, nz=nz,
                          surface="lambertian")
    band = host.bands[0]
    kw = flagship_params(n_spec)
    hg = EXACT_SS_HG
    shape = aerosol_profile_shape(
        RTAerosol(tau_ref=hg["tau_ref"], p0=hg["p0"], sigma_p=hg["sigma_p"]),
        host.profile)
    data = dict(
        geometry=dict(mu0=float(np.cos(np.deg2rad(kw["sza"]))),
                      mu_v=np.cos(np.deg2rad(np.asarray(kw["vza"]))),
                      dphi=np.deg2rad(np.asarray(kw["vaz"]))),
        rayleigh=dict(tau=np.ascontiguousarray(band.tau_rayl.T),
                      depol=float(band.depol_rayleigh)),
        hg=dict(g=hg["g"], ssa=hg["ssa"],
                tau=np.repeat((hg["tau_ref"] * shape)[:, None], n_spec, 1)),
        surface=surface, albedo=albedo, n_stokes=n_stokes)
    surf = LambertianSSSurface(albedo=albedo) if surface == "lambertian" \
        else CoxMunkSSSurface(wind_speed=5.0)
    config = ExactSSConfig(
        geometry=SSGeometry(**data["geometry"]), surface=surf,
        contributors=[RayleighSSContributor(**data["rayleigh"]),
                      HGAerosolSSContributor(**data["hg"])],
        n_stokes=n_stokes)
    return config, data


def surfaces_ref_outputs(name, dtype=np.float64, device=None):
    """The port's run of one entry of ``data/surfaces_ref_f64.npz`` on
    ``device`` (CUDA unless given): {f"{name}_{key}": array}. ``canopy``:
    ``rt_run_full`` of ``canopy_ref_model``; ``radau``: R and T of the
    small Gauss-Radau flagship; ``ss_canopy``, ``ss_coxmunk``: ``rt_run_ss``
    of the small canopy and the small flagship over Cox-Munk; ``exact_all``
    / ``exact_cm``: ``run_exact_ss_with_jacobians`` of ``exact_ss_config``
    over Lambertian ("all") and Cox-Munk ("paths_1_2"). The stored file
    holds the JAX package's CPU f64 run of the same scenes."""
    from .core.singlescatter import rt_run_ss
    from .core.solver import rt_run_full
    from .core.types import resolve_device
    from .standalone_ss import run_exact_ss_with_jacobians
    device = resolve_device(device)
    small = dict(n_spec=SURF_REF_N_SPEC, nz=SURF_REF_NZ)
    if name == "canopy":
        out = rt_run_full(canopy_ref_model(dtype, device=device),
                          device=device)
    elif name == "radau":
        out = rt_run_full(radau_model(dtype=dtype,
                                      nstreams=SURF_REF_NSTREAMS, **small),
                          device=device)
        out = {k: out[k] for k in ("R", "T")}
    elif name == "ss_canopy":
        out = rt_run_ss(canopy_ref_model(dtype, device=device),
                        device=device)
    elif name == "ss_coxmunk":
        out = rt_run_ss(flagship_model(dtype=dtype,
                                       nstreams=SURF_REF_NSTREAMS, **small),
                        device=device)
    else:
        surface, paths = {"exact_all": ("lambertian", "all"),
                          "exact_cm": ("coxmunk", "paths_1_2")}[name]
        config, _ = exact_ss_config(surface=surface, **small)
        res, jac = run_exact_ss_with_jacobians(config, paths, device=device)
        out = {k: res[k] for k in ("path1", "path2", "path3", "path4",
                                   "total")}
        out.update(jac)
    return {f"{name}_{k}": np.asarray(v) for k, v in out.items()}


# ---- The multichip dry run ----

def _dryrun_rank(rank, world, device_type):
    """One rank of ``dryrun_multichip``: its slice of the flagship at nSpec
    8 x world and nstreams 4 through ``rt_solve`` on ``device_type``, R
    gathered over the spectral mesh. Returns (R's shape, all finite, the
    gathered R as numpy, this rank's spectral points)."""
    import torch
    from .core.solver import rt_solve
    from .parallel.sharding import (gather_outputs, shard_inputs,
                                    spectral_mesh)
    dev = torch.device(device_type if device_type == "cpu" else
                       f"cuda:{torch.cuda.current_device()}")
    mesh = spectral_mesh()
    model = flagship_model(n_spec=8 * world, nstreams=4)
    inputs, config = shard_inputs(*model.build_band(0, device=dev), mesh)
    R = gather_outputs({"R": rt_solve(inputs, config, dev)["R"]}, mesh)["R"]
    return (tuple(R.shape), bool(torch.isfinite(R).all()), R.cpu().numpy(),
            config.n_spec)


def dryrun_multichip(n_devices: int, device=None):
    """Shard the spectral axis of the flagship (nSpec 8 n, nstreams 4) over
    n ranks of ``torch.distributed``, run ``rt_solve`` on each rank's
    slice and gather R (the counterpart of
    ``__graft_entry__.dryrun_multichip``): NCCL with one GPU a rank on
    CUDA (the default), gloo on the CPU when ``device="cpu"``. Checks R's
    shape and that it is finite, prints one "OK" line and returns the
    gathered R as numpy."""
    from .core.types import resolve_device
    from .parallel.sharding import run_ranks
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    outs = run_ranks(_dryrun_rank, n_devices, dev.type, backend=backend,
                     threads=1 if dev.type == "cpu" else None)
    n_spec = 8 * n_devices
    want = (len(flagship_params()["vza"]), 4, n_spec)
    for shape, finite, _, local in outs:
        assert shape == want, (shape, want)
        assert finite
        assert local == n_spec // n_devices
    R = outs[0][2]
    print(f"dryrun_multichip OK: {n_devices}-rank spectral mesh ({backend}), "
          f"nSpec={n_spec}, R {R.shape} gathered on every rank")
    return R
