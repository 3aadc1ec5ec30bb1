"""Model build: user parameters -> RTModel (host setup + solver inputs).

Counterpart of ``vsmartmom_tpu/core/model.py``: Rayleigh columns with
optional Mie or analytic (Henyey-Greenstein) aerosols and gas absorption
over any surface the JAX package builds (Lambertian with a scalar,
per-point, Legendre or spline albedo; Cox-Munk; RPV; Ross-Li; a
vegetation canopy over any of them), on Gauss-Legendre or Gauss-Radau
streams, with optional per-layer thermal emission. All setup physics runs
on the host in float64 NumPy, as in the JAX package; ``build_band`` hands
the arrays to the device as float64 tensors and the solver casts them to
``config.dtype``. The generalized spherical functions behind the Z moments
are computed once per build for every moment and component
(``zmatrix.legendre_tables``), not once per moment as in the JAX package:
the numbers are the same.

Two parts of the build run on a torch device, the one
``model_from_parameters(params, device=...)`` was given (CUDA unless
given): the line sum of gas absorption (``AbsorptionParams``: HITRAN line
lists; look-up tables, CIA and MT_CKD stay on the host;
``absorption/cross_section.py``) and a canopy surface's slab
(``surfaces/canopy.py``, float64), whose operators come back to the host.
A canopy with spectral leaf optics gives spectrally resolved surface
operators, (n_m, nSpec, N, N) and (n_m, nSpec, N, n_stokes); ``build_band``
keeps those two on the CPU; ``rt_solve`` moves one spectral chunk of them
to its device at a time, the other solves the whole of them at once.

The model build's stages (``rayleigh``, ``absorption``, ``mie``, and
``surface`` in ``build_band``) are timed into ``utils.timing``'s table.
"""

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..inelastic.molecular import air_depolarization
from ..scattering.greek import GreekCoefs, greek_rayleigh
from ..scattering.stokes import Polarization
from ..scattering.zmatrix import compute_Z_moments, legendre_tables
from ..surfaces.lambertian import (lambertian_legendre_scale,
                                   lambertian_spectral_scale,
                                   lambertian_surface_arrays)
from ..utils import timing
from ..utils.quadrature import (QuadPoints, nearest_index, rt_set_streams,
                                rt_set_streams_radau)
from .atmosphere import (AtmosphericProfile, aerosol_profile_shape,
                         compute_atmos_profile_fields, compute_ndoubl,
                         rayleigh_layer_tau, reduce_profile)
from .types import (SPECTRAL_SURFACE, SolverConfig, auto_kernel,
                    kernel_takes_width, resolve_device,
                    solver_inputs_from_numpy, stokes_d_vector)


@dataclass
class Parameters:
    """User configuration (reference vSmartMOM_Parameters, types.jl:770-860)."""

    spec_bands: list                    # list of wavenumber grids [cm^-1]
    surfaces: list                      # per-band surface descriptors
    nstreams: int
    polarization: Polarization
    sza: float
    vza: list
    vaz: list
    obs_alt: float
    T: np.ndarray                       # (Nz,) layer temperatures
    p: np.ndarray                       # (Nz+1,) half-level pressures [hPa]
    q: Optional[np.ndarray] = None
    profile_reduction: int = -1
    depol: float = -1.0                 # < 0 -> auto from N2/O2 constants
    float_type: Any = np.float64
    truncation: str = "NoTruncation"    # or "deltaBGE" (aerosol phase)
    absorption_params: Optional["AbsorptionParams"] = None
    scattering_params: Optional["ScatteringParams"] = None
    dtau_max_threshold: float = 1e-3
    dtau_min_floor: Optional[float] = None
    include_solar: bool = True          # zero F0 for thermal-only runs
    quadrature: str = "GaussLegQuad"    # or "RadauQuad" (SZA a weighted node)
    verbose: bool = False               # print the per-stage timing table
    # Execution strategy (None = auto: the band kernel for f32 on CUDA
    # where the scene's width fits it).
    fused: Optional[bool] = None

    @property
    def stream_l_cap(self) -> int:
        return 2 * self.nstreams - 1


@dataclass
class SurfaceDescriptor:
    kind: str
    args: list
    kwargs: dict = field(default_factory=dict)


@dataclass
class RTAerosol:
    """One aerosol species (reference RT_Aerosol, types.jl:83-103):
    microphysics (log-normal + refractive index) or an analytic phase
    function, a reference optical depth, and a vertical profile in EITHER
    Gaussian-in-pressure (p0, sigma_p [hPa]) or log-normal-in-altitude
    (z0 [km], sigma_z = sigma0 log-width) form."""
    tau_ref: float
    p0: Optional[float] = None         # profile center [hPa]
    sigma_p: Optional[float] = None    # profile width [hPa]
    z0: Optional[float] = None         # profile median altitude [km]
    sigma_z: Optional[float] = None    # log-normal sigma0 (dimensionless)
    mu_log: Optional[float] = None     # log-normal median radius [um], log
    sigma_log: Optional[float] = None  # log-normal geometric sigma, log
    n_r: float = 1.0
    n_i: float = 0.0
    phase_function_g: Optional[float] = None   # HG asymmetry (analytic path)
    ssa: Optional[float] = None                # analytic-path SSA

    def __post_init__(self):
        has_p = self.p0 is not None
        has_z = self.z0 is not None
        if has_p == has_z:
            raise ValueError("RTAerosol needs exactly one vertical-profile "
                             "form: (p0, sigma_p) or (z0, sigma_z)")
        if has_p and self.sigma_p is None:
            raise ValueError("pressure-form profile needs sigma_p")
        if has_z and self.sigma_z is None:
            raise ValueError("altitude-form profile needs sigma_z")


@dataclass
class AbsorptionParams:
    """Reference AbsorptionParameters (types.jl:659-680). Line data sources
    are explicit paths: ``par_paths[molecule] = /path/to/lines.par``, a
    file registered with ``absorption.artifacts.register_par``, or
    ``luts[band][molecule]`` InterpolationModel objects."""
    molecules: list                     # per-band molecule-name lists
    vmr: dict                           # species -> scalar or (Nz,) profile
    broadening: str = "Voigt"
    cef: str = "HumlicekWeidemann32SDErrorFunction"
    wing_cutoff: float = 40.0
    par_paths: dict = field(default_factory=dict)
    luts: list = field(default_factory=list)
    cia_files: list = field(default_factory=list)   # HITRAN .cia paths
    mtckd_file: str = ""                            # AER absco-ref .nc path


@dataclass
class ScatteringParams:
    """Reference ScatteringParameters (types.jl:687-700)."""
    rt_aerosols: list
    r_max: float = 50.0
    nquad_radius: int = 2500
    lambda_ref: float = 0.55
    n_ref: Optional[complex] = None
    decomp_type: str = "NAI2"


@dataclass
class ScatteringComponent:
    """One aerosol of a layer mix: its Greek coefficients, its (Nz,) optical
    depth profile at the band value and its single-scattering albedo, both
    after delta-M scaling (createAero, compEffectiveLayerProperties.jl:67-72),
    plus the raw optics the Jacobian build reads."""
    greek: GreekCoefs
    tau_profile: np.ndarray
    ssa: float
    aer: Optional[RTAerosol] = None     # source aerosol
    k_over_kref: float = 1.0            # band-to-reference extinction ratio
    f_trunc: float = 0.0                # delta-M truncation factor
    ssa_raw: float = 1.0                # pre-truncation single-scatter albedo


@dataclass
class BandData:
    """Mutable per-band optics for one spectral band."""
    nu_grid: np.ndarray                 # (nSpec,)
    tau_rayl: np.ndarray                # (nSpec, Nz), mutable for overrides
    tau_abs: np.ndarray                 # (nSpec, Nz)
    greek_rayleigh: GreekCoefs
    aerosols: list = field(default_factory=list)   # ScatteringComponent
    depol_rayleigh: float = 0.0
    depol_cabannes: float = 0.0
    pi_cabannes: float = 1.0
    surface: SurfaceDescriptor = None
    # optional per-layer Planck radiance (Nz, nSpec): a second source slot
    thermal_b: Optional[np.ndarray] = None
    # optional surface SIF emission (nSpec,), isotropic, m = 0 only
    sif_spec: Optional[np.ndarray] = None
    # per-molecule absorption components (nSpec, Nz), for gas-VMR Jacobians
    tau_abs_by_mol: dict = field(default_factory=dict)
    # optional solar or stellar irradiance spectrum (nSpec,) scaling F0
    f0_spec: Optional[np.ndarray] = None

    @property
    def n_spec(self) -> int:
        return len(self.nu_grid)


def _surface_m_support(surface: SurfaceDescriptor, stream_l_cap: int) -> int:
    """Fourier support of the surface BRDF (component_m_max.jl): every
    Lambertian kind -> 0; Cox-Munk, RPV, Ross-Li and a canopy -> the
    stream cap."""
    if surface.kind.startswith("Lambertian"):
        return 0
    return stream_l_cap


def _surface_arrays(surface: SurfaceDescriptor, quad: QuadPoints,
                    n_stokes: int, n_m: int, n_spec: int, pol=None,
                    nu_grid=None, atm_tau=None, device=None):
    """(surf_r, surf_j_m, surf_spec, surf_direct_m), as in the JAX package:
    surf_r[m] includes the m = 0 factor 2 and the diag(mu*w) quadrature
    factor, surf_j_m[m] = mu0 * R_raw[:, solar block], surf_spec scales both
    spectrally and surf_direct_m masks the moments with a direct-beam j0+
    (Lambertian: m = 0 only; numeric BRDFs: every m). ``nu_grid`` is the
    band's grid (spline albedos, canopies), ``pol`` its polarization and
    ``atm_tau`` the within-canopy absorption (``_canopy_atm_tau``); a
    canopy's slab runs on ``device`` (resolved: CUDA unless given)."""
    kind = surface.kind
    direct_m = np.zeros(n_m)
    direct_m[0] = 1.0

    if kind in ("LambertianSurfaceScalar", "LambertianSurfaceSpectrum",
                "LambertianSurfaceLegendre", "LambertianSurfaceSpline"):
        r, j = lambertian_surface_arrays(quad, n_stokes, n_m)
        if kind == "LambertianSurfaceLegendre":
            spec = lambertian_legendre_scale(np.asarray(surface.args), n_spec)
        elif kind == "LambertianSurfaceSpline":
            # Cubic-spline spectral albedo (reference types.jl:545-548 +
            # lambertian_surface.jl:161-183): knots on a wavelength [nm]
            # or wavenumber [cm^-1] grid, evaluated on the band grid.
            from scipy.interpolate import CubicSpline
            grid = np.asarray(surface.kwargs.get(
                "grid", surface.args[0] if surface.args else None),
                dtype=np.float64)
            vals = np.asarray(surface.kwargs.get(
                "albedo", surface.args[1] if len(surface.args) > 1 else None),
                dtype=np.float64)
            unit = str(surface.kwargs.get("grid_unit", "nm"))
            if nu_grid is None:
                raise ValueError("LambertianSurfaceSpline needs the band grid")
            x = 1e7 / np.asarray(nu_grid) if unit == "nm" else \
                np.asarray(nu_grid)
            order = np.argsort(grid)
            cs = CubicSpline(grid[order], vals[order])
            spec = np.clip(cs(np.clip(x, grid.min(), grid.max())), 0.0, None)
        else:
            albedo = surface.args[0] if kind == "LambertianSurfaceScalar" \
                else np.asarray(surface.args[0])
            spec = lambertian_spectral_scale(albedo, n_spec)
        return r, j, spec, direct_m

    if kind == "CoxMunkSurface":
        from ..surfaces.coxmunk import (CoxMunkSurface,
                                        coxmunk_surface_operator_arrays)
        surf = surface.kwargs.get("_surface_obj") or CoxMunkSurface(
            **{k: v for k, v in surface.kwargs.items() if not k.startswith("_")})
        surf_r, surf_j = coxmunk_surface_operator_arrays(
            surf, quad, n_stokes, n_m)
        return surf_r, surf_j, np.ones(n_spec), np.ones(n_m)

    if kind in ("rpvSurfaceScalar", "RossLiSurfaceScalar"):
        from ..surfaces.land_brdf import (RPVSurface, RossLiSurface,
                                          rossli_reflectance, rpv_reflectance,
                                          scalar_brdf_surface_arrays)
        if kind == "rpvSurfaceScalar":
            # ctor order: rpvSurfaceScalar(rho0, rho_c, k, theta)
            s = RPVSurface(*[float(a) for a in surface.args]) \
                if surface.args else RPVSurface(**surface.kwargs)
            fn = lambda mi, mr, dp: rpv_reflectance(s, mi, mr, dp)  # noqa: E731
        else:
            # ctor order: RossLiSurfaceScalar(fvol, fgeo, fiso)
            s = RossLiSurface(*[float(a) for a in surface.args]) \
                if surface.args else RossLiSurface(**surface.kwargs)
            fn = lambda mi, mr, dp: rossli_reflectance(s, mi, mr, dp)  # noqa: E731
        r, j = scalar_brdf_surface_arrays(fn, quad, n_stokes, n_m)
        return r, j, np.ones(n_spec), np.ones(n_m)

    if kind == "CanopySurface":
        from ..surfaces.canopy import (CanopySurface, canopy_surface_arrays,
                                       interp_surface_operators)
        canopy = surface.kwargs.get("_surface_obj")
        if canopy is None:
            canopy = CanopySurface(
                **{k: v for k, v in surface.kwargs.items()
                   if not k.startswith("_")})
        soil_r, soil_j, soil_spec, soil_direct = _surface_arrays(
            canopy.soil, quad, n_stokes, n_m, n_spec, pol=pol,
            nu_grid=nu_grid)
        if nu_grid is None:
            nu_grid = np.linspace(0.0, 1.0, n_spec)
        nodes, R_eff, J_eff = canopy_surface_arrays(
            canopy, quad, pol, n_m, nu_grid, soil_r, soil_j, soil_spec,
            atm_tau=atm_tau, device=resolve_device(device))
        # Direct-beam j0+ slot: canopy-TOP bookkeeping, as in the JAX
        # package. The composite canopy+soil operators act at the canopy
        # top, so the BOA outputs (T, bhr_dw) are the fields at canopy top,
        # and the direct slot keeps the soil's mask with the above-canopy
        # attenuation only: LAI -> 0 reduces continuously to bare soil, and
        # a conservative surface keeps bhr_uw == bhr_dw. (canopy_surface.jl:
        # 459 zeroes the slot instead: there the canopy slab carries the
        # beam.)
        if len(nodes) == 1:
            # Spectrally constant canopy: squeeze to the (n_m, N, N) path.
            return R_eff[:, 0], J_eff[:, 0], np.ones(n_spec), soil_direct
        R, J = interp_surface_operators(nodes, R_eff, J_eff, nu_grid)
        return R, J, np.ones(n_spec), soil_direct

    raise NotImplementedError(f"Surface type {kind} not yet implemented")


def _canopy_atm_tau(band, profile):
    """Within-canopy gas absorption spectrum of a CanopySurface scene with
    ``include_atm`` and ``canopy_dp`` (reference canopy_surface.jl
    _compute_canopy_atm_tau!): the bottom layer's tau_abs scaled by the
    canopy's air column vcd = N_A dp / (M g 100^2) * 100 over the bottom
    layer's dry column. Returns (nSpec,) or None."""
    surf = band.surface
    if surf.kind != "CanopySurface":
        return None
    canopy = surf.kwargs.get("_surface_obj")
    if canopy is not None:
        include, dp = canopy.include_atm, canopy.canopy_dp
    else:
        include = surf.kwargs.get("include_atm", False)
        dp = surf.kwargs.get("canopy_dp")
    if not include or dp is None:
        return None
    iz = profile.nz - 1
    N_A, g0 = 6.0221408e23, 9.8067
    dry_mass, wet_mass = 0.028964, 0.018015
    vmr_h2o = float(np.atleast_1d(profile.vmr_h2o)[iz]) \
        if profile.vmr_h2o is not None else 0.0
    M = (1.0 - vmr_h2o) * dry_mass + vmr_h2o * wet_mass
    vcd_canopy = N_A * float(dp) / (M * g0 * 100.0 ** 2) * 100.0
    vcd_bot = float(np.atleast_1d(profile.vcd_dry)[iz])
    if vcd_bot <= 0:
        return None
    return np.asarray(band.tau_abs)[:, iz] * (vcd_canopy / vcd_bot)


class RTModel:
    """Built model: geometry + profile + per-band optics.

    ``build_band`` assembles one band's (SolverInputs, SolverConfig) from the
    current (possibly user-mutated) optics. ``device`` is where the build's
    device parts run (a canopy's slab; None: CUDA, resolved at use)."""

    def __init__(self, params: Parameters, quad: QuadPoints,
                 profile: AtmosphericProfile, bands: list, device=None):
        self.params = params
        self.quad = quad
        self.profile = profile
        self.bands = bands
        self.device = device
        self.vza_idx = tuple(nearest_index(quad.qp_mu, np.cos(np.deg2rad(v)))
                             for v in params.vza)

    def __repr__(self):
        """Reference-style model banner (tools/show_utils.jl)."""
        p = self.params
        lines = [f"RTModel  {p.polarization.name}  nstreams={p.nstreams} "
                 f"(Nquad={self.quad.Nquad})  sza={p.sza:.1f}  "
                 f"vza={[float(v) for v in p.vza]}  Nz={self.profile.nz}  "
                 f"f{np.dtype(p.float_type).itemsize*8}"]
        for i, b in enumerate(self.bands):
            nu = b.nu_grid
            aer = f", {len(b.aerosols)} aerosol(s)" if b.aerosols else ""
            abs_ = ", abs" if np.any(b.tau_abs) else ""
            lines.append(
                f"  band[{i}]: {nu.min():.1f}-{nu.max():.1f} cm^-1 "
                f"({b.n_spec} pts), m_max={self._band_m_max(b)}, "
                f"{b.surface.kind}{aer}{abs_}, "
                f"tau_rayl={np.asarray(b.tau_rayl).sum(axis=-1).max():.4f}")
        return "\n".join(lines)

    # -- accessors of the reference API, which the published-table suites
    # read --
    @property
    def tau_rayl(self):
        return [b.tau_rayl for b in self.bands]

    @property
    def mu0(self):
        return self.quad.mu0

    def band_solver_args(self, device=None):
        """``build_band`` of every band on ``device``."""
        return [self.build_band(i, device=device)
                for i in range(len(self.bands))]

    def _band_m_max(self, band: BandData) -> int:
        """Per-band Fourier order from component support, clamped by the
        stream contract stream_l_cap = 2*Nstreams - 1."""
        cap = self.params.stream_l_cap
        supports = [band.greek_rayleigh.l_max - 1,
                    _surface_m_support(band.surface, cap)]
        supports += [a.greek.l_max - 1 for a in band.aerosols]
        return min(max(supports), cap)

    def build_band(self, i_band: int, device=None, rrs: bool = False):
        """(SolverInputs on ``device`` as float64, SolverConfig) for one band.

        ``device`` also picks the strategy when ``params.fused`` is None:
        the band kernel for an f32 model on CUDA (``types.auto_kernel``)
        whose width N fits it (``ops.fused_band.KERNEL_MAX_N``; a wider
        scene warns and takes the plain path), the plain path otherwise (an
        f64 model stays on the plain path, as in the JAX package).
        ``rrs=True`` builds the elastic half of a rotational-Raman run: the
        Cabannes Greek coefficients and scattering weight
        tau_rayl * pi_cabannes (compEffectiveLayerProperties.jl:8-9,36-41);
        the Raman part is transported by ``core/inelastic.py``."""
        dev = resolve_device(device)
        params, quad = self.params, self.quad
        pol = params.polarization
        ns = pol.n
        band = self.bands[i_band]
        n_spec = band.n_spec
        nz = self.profile.nz
        ft = np.dtype(params.float_type).type

        m_max = self._band_m_max(band)
        n_m = m_max + 1
        with timing.stage(f"surface[{i_band}]"):
            surf_r, surf_j, surf_spec, surf_direct_m = _surface_arrays(
                band.surface, quad, ns, n_m, n_spec, pol=pol,
                nu_grid=band.nu_grid,
                atm_tau=_canopy_atm_tau(band, self.profile),
                device=self.device)

        # Phase supermatrices per Fourier moment per scattering component:
        # Rayleigh (or its Cabannes line for RRS runs), then each aerosol.
        greek0 = greek_rayleigh(band.depol_cabannes) if rrs \
            else band.greek_rayleigh
        Z_pp, Z_mp = z_moment_stack(
            pol, quad.qp_mu, [greek0] + [a.greek for a in band.aerosols],
            n_m)

        # Layer mixing weights: scattering weight tau_c * ssa_c per component
        # (Rayleigh ssa = 1; compEffectiveLayerProperties.jl:40).
        n_comp = 1 + len(band.aerosols)
        scat_w = np.zeros((nz, n_comp, n_spec))
        scat_w[:, 0, :] = band.tau_rayl.T * (band.pi_cabannes if rrs else 1.0)
        tau = band.tau_rayl.T + band.tau_abs.T                 # (Nz, nSpec)
        for c, aer in enumerate(band.aerosols, start=1):
            prof = np.asarray(aer.tau_profile, dtype=np.float64)
            tau_aer = prof[:, None] if prof.ndim == 1 else prof.T
            scat_w[:, c, :] = tau_aer * aer.ssa
            tau = tau + tau_aer

        # Uniform doubling count: max of the per-layer rule
        # (rt_kernel.jl:266-287).
        weighted = quad.wt_mu > np.finfo(np.float64).eps
        mu_min = quad.qp_mu[weighted].min()
        ndoubl = max(
            (compute_ndoubl(scat_w[z].sum(axis=0).max(), mu_min,
                            params.dtau_max_threshold, params.dtau_min_floor,
                            dtype=ft) for z in range(nz)), default=0)

        # Azimuthal postprocessing weights (postprocessing_vza.jl:23-37).
        vza_w = np.zeros((n_m, len(params.vza), ns))
        for m in range(n_m):
            w = 0.5 / np.pi if m == 0 else 1.0 / np.pi
            for iv, phi in enumerate(params.vaz):
                cosm = np.cos(np.deg2rad(m * phi))
                sinm = np.sin(np.deg2rad(m * phi))
                vza_w[m, iv] = w * np.array([cosm, cosm, sinm, sinm][:ns])

        F0 = np.tile(pol.I0[:, None], (1, n_spec))
        if band.f0_spec is not None:
            F0 = F0 * np.asarray(band.f0_spec)[None, :]
        if not params.include_solar:
            F0 = np.zeros_like(F0)

        n_sources = 2 if band.thermal_b is not None else 1
        thermal_b = band.thermal_b if band.thermal_b is not None \
            else np.zeros((nz, n_spec))

        # --- Execution strategy: the whole-moment band kernel for f32 on
        # CUDA; one spectral point per operator (no block-diagonal packing);
        # a scene-probed Newton-Schulz schedule on the kernel path.
        fused = params.fused
        if fused is None:
            from ..ops.fused_band import KERNEL_MAX_N
            fused = auto_kernel(dev, ft) and kernel_takes_width(
                "K1 (csrc/fused_band.cu)", KERNEL_MAX_N, quad.Nquad * ns)
        ns_sched, ns_inter = (), 6
        if fused and ndoubl > 0:
            from ..ops.ns_schedule import probe_ns_schedule
            # Probe at the spectrally worst point: max layer scattering.
            s_star = int(np.argmax(scat_w.sum(axis=1).max(axis=0)))
            tau_p = tau[:, s_star]
            safe_tau = np.where(tau_p > 0, tau_p, 1.0)
            wZ_pp_l = np.einsum("zc,cij->zij", scat_w[:, :, s_star],
                                Z_pp[0]) / safe_tau[:, None, None]
            wZ_mp_l = np.einsum("zc,cij->zij", scat_w[:, :, s_star],
                                Z_mp[0]) / safe_tau[:, None, None]
            d_vec = stokes_d_vector(ns, quad.Nquad)
            surf0 = np.asarray(surf_r[0])
            if surf0.ndim == 3:
                # Spectrally resolved surface: probe its brightest point.
                surf0 = surf0[int(np.argmax(np.abs(surf0).sum(axis=(1, 2))))]
            surf_probe = surf0 * float(np.max(surf_spec)) \
                if np.size(surf_spec) else None
            ns_sched, ns_inter = probe_ns_schedule(
                wZ_pp_l, wZ_mp_l, tau_p, quad.qp_mu_N, quad.wt_mu_N,
                d_vec, int(ndoubl), surf_r=surf_probe)

        # Highest moment with atmospheric scattering: beyond it the column
        # is purely absorbing and the solver's exact Beer-law shortcut
        # applies (Cox-Munk pushes m_max to the stream cap, Rayleigh
        # scatters only to m = 2, an aerosol to its l_max - 1).
        m_scat = min(m_max, max([band.greek_rayleigh.l_max - 1]
                                + [a.greek.l_max - 1 for a in band.aerosols]))

        config = SolverConfig(n_stokes=ns, nquad=quad.Nquad, n_spec=n_spec,
                              nz=nz, m_max=m_max, ndoubl=int(ndoubl),
                              i_mu0=quad.i_mu0, vza_idx=self.vza_idx, dtype=ft,
                              n_sources=n_sources, fused=bool(fused),
                              ns_sched=ns_sched, ns_inter=int(ns_inter),
                              m_scat=int(m_scat))
        fields = dict(
            qp_mu_N=quad.qp_mu_N, wt_mu_N=quad.wt_mu_N,
            tau=tau, scat_w=scat_w, Z_pp=Z_pp, Z_mp=Z_mp, F0=F0,
            surf_r=surf_r, surf_j_m=surf_j, surf_spec=surf_spec,
            surf_direct_m=surf_direct_m, vza_w=vza_w,
            thermal_b=thermal_b,
            sif_spec=band.sif_spec if band.sif_spec is not None
            else np.zeros(n_spec))
        # Spectrally resolved surface operators stay on the host (1.4 GB in
        # f64 at nSpec 4096, N = 52): the solver moves a chunk at a time.
        host = [k for k in SPECTRAL_SURFACE if np.ndim(fields[k]) == 4]
        inputs = solver_inputs_from_numpy(
            {k: np.zeros(0) if k in host else v for k, v in fields.items()},
            dev, torch.float64)
        return inputs._replace(**{
            k: torch.as_tensor(np.ascontiguousarray(fields[k]),
                               dtype=torch.float64) for k in host}), config


def z_moment_stack(pol, mu, greeks, n_m: int):
    """(Z_pp, Z_mp), each (n_m, len(greeks), N, N): the Z moments m < n_m of
    each Greek expansion, from one set of Legendre tables."""
    N = len(mu) * pol.n
    Z_pp = np.zeros((n_m, len(greeks), N, N))
    Z_mp = np.zeros((n_m, len(greeks), N, N))
    if not greeks:
        return Z_pp, Z_mp
    tables = legendre_tables(mu, max(g.l_max for g in greeks), n_m)
    for m in range(n_m):
        for c, gk in enumerate(greeks):
            Z_pp[m, c], Z_mp[m, c] = compute_Z_moments(pol, mu, gk, m,
                                                       tables)
    return Z_pp, Z_mp


def uses_delta_bge(params: Parameters) -> bool:
    return params.truncation in ("AutoTruncation", "auto", "deltaBGE",
                                 "dBGE", "\u03b4BGE")


def band_lambda_um(nu) -> float:
    """Band-mean wavelength [um] at which the aerosol optics are taken."""
    return 1e4 * (1.0 / nu.min() + 1.0 / nu.max()) / 2.0


def build_one_aerosol(params: Parameters, profile: AtmosphericProfile,
                      aer: RTAerosol, lam_band: float) -> ScatteringComponent:
    """Mie (NAI-2) or analytic optics of one aerosol, optionally delta-BGE
    truncated, with its delta-M-scaled layer profile
    (model_from_parameters.jl:376-476 + createAero,
    compEffectiveLayerProperties.jl:67-72)."""
    from ..scattering.mie import (Aerosol, SizeDistribution,
                                  analytic_aerosol_optics,
                                  compute_aerosol_optical_properties,
                                  compute_ref_aerosol_extinction,
                                  truncate_phase_delta_bge,
                                  truncate_phase_none)
    scat = params.scattering_params
    l_cap = params.stream_l_cap
    profile_shape = aerosol_profile_shape(aer, profile)
    if aer.phase_function_g is not None:
        optics = analytic_aerosol_optics(aer.phase_function_g,
                                         ssa=aer.ssa or 1.0,
                                         l_max=min(l_cap + 1, 64))
        tau_prof = aer.tau_ref * profile_shape
        k_scale = 1.0
    else:
        mie_aero = Aerosol(SizeDistribution(aer.mu_log, aer.sigma_log),
                           aer.n_r, aer.n_i)
        n_ref = scat.n_ref if scat.n_ref is not None else \
            complex(aer.n_r, -aer.n_i)
        ref_aero = Aerosol(mie_aero.size_distribution,
                           n_ref.real, -n_ref.imag)
        k_ref = compute_ref_aerosol_extinction(
            ref_aero, scat.lambda_ref, scat.r_max, scat.nquad_radius)
        raw = compute_aerosol_optical_properties(
            mie_aero, lam_band, scat.r_max, scat.nquad_radius)
        if uses_delta_bge(params) and raw.greek_coefs.l_max > l_cap:
            optics = truncate_phase_delta_bge(raw, l_cap)
        else:
            optics = truncate_phase_none(raw)
        k_scale = raw.k / k_ref
        tau_prof = aer.tau_ref * k_scale * profile_shape

    # delta-M scaling (createAero): tau* = (1 - f_t w) tau,
    # w* = (1 - f_t) w / (1 - f_t w)
    ft, w = optics.f_trunc, optics.ssa
    tau_mod = (1.0 - ft * w) * tau_prof
    ssa_mod = (1.0 - ft) * w / (1.0 - ft * w)
    return ScatteringComponent(greek=optics.greek_coefs,
                               tau_profile=tau_mod, ssa=float(ssa_mod),
                               aer=aer, k_over_kref=float(k_scale),
                               f_trunc=float(ft), ssa_raw=float(w))


def _build_band_absorption(params: Parameters, profile: AtmosphericProfile,
                           nu: np.ndarray, i_band: int, device=None):
    """Gas absorption tau per (wavenumber, layer) for one band
    (model_from_parameters.jl:305-366): (tau_abs (nSpec, Nz), the
    per-molecule components for VMR Jacobians). A molecule's line sum runs
    on ``device``, resolved (``types.resolve_device``: CUDA unless given)
    only for a molecule read from a line list; look-up tables, CIA and
    MT_CKD run on the host."""
    ap = params.absorption_params
    nz = profile.nz
    tau_abs = np.zeros((len(nu), nz))
    by_mol = {}
    if ap is None or not ap.molecules:
        return tau_abs, by_mol
    from ..absorption.cross_section import (HitranModel,
                                            compute_absorption_profile)
    from ..absorption.hitran import read_hitran

    molecules = ap.molecules[i_band] if i_band < len(ap.molecules) else []
    for mol_name in molecules:
        if mol_name not in ap.vmr:
            raise ValueError(f"molecule {mol_name} listed but no vmr given")
        luts = ap.luts[i_band] if i_band < len(ap.luts) else {}
        if mol_name in luts:
            lut = luts[mol_name]
            vmr = np.atleast_1d(ap.vmr[mol_name])
            tau_mol = np.zeros((len(nu), nz))
            for iz in range(nz):
                tau_mol[:, iz] = (lut.interpolate(nu, profile.p_full[iz],
                                                  profile.T[iz])
                                  * profile.vcd_dry[iz]
                                  * vmr[min(iz, vmr.size - 1)])
            by_mol[mol_name] = tau_mol
            tau_abs += tau_mol
            continue
        if mol_name not in ap.par_paths:
            # The registry of local line files (the reference downloads
            # hitran.org artifacts here).
            from ..absorption.artifacts import artifact, hitran_is_cached
            if hitran_is_cached(mol_name):
                ap.par_paths[mol_name] = artifact(mol_name)
            else:
                import warnings
                warnings.warn(
                    f"No HITRAN line data for {mol_name} "
                    f"(band {i_band}): tau_abs contribution skipped. "
                    f"Provide absorption_params.par_paths['{mol_name}'], "
                    f"register_par('{mol_name}', path), or a LUT.",
                    stacklevel=3)
                continue
        dev = resolve_device(device)
        table = read_hitran(ap.par_paths[mol_name],
                            nu_min=nu.min() - ap.wing_cutoff,
                            nu_max=nu.max() + ap.wing_cutoff)
        model = HitranModel(hitran=table, broadening=ap.broadening,
                            wing_cutoff=ap.wing_cutoff, cef=ap.cef, vmr=0.0)
        tau_mol = compute_absorption_profile(model, nu, ap.vmr[mol_name],
                                             profile, dev)
        by_mol[mol_name] = tau_mol
        tau_abs += tau_mol

    # Collision-induced absorption and the MT_CKD H2O continuum
    # (model_from_parameters.jl:347-366); continua are not per-molecule
    # Jacobian components in the reference either.
    if ap.cia_files:
        from ..absorption.continuum import compute_tau_cia, load_cia_table
        for cia_path in ap.cia_files:
            tau_abs += compute_tau_cia(load_cia_table(cia_path, nu), profile,
                                       ap.vmr)
    if ap.mtckd_file:
        from ..absorption.continuum import (compute_tau_h2o_continuum,
                                            load_mtckd)
        tau_abs += compute_tau_h2o_continuum(load_mtckd(ap.mtckd_file), nu,
                                             profile, profile.vmr_h2o)
    return tau_abs, by_mol


def model_from_parameters(params: Parameters, device=None) -> RTModel:
    """The host build of every band. A band with gas lines
    (``params.absorption_params``) sums them on ``device``, and
    ``build_band`` runs a canopy surface's slab there: CUDA unless given,
    and without CUDA and without a device those builds raise. A scene
    without line lists or canopy builds on the host alone.
    ``params.quadrature`` "RadauQuad" takes Gauss-Radau streams with the
    solar cosine as a weighted node, "GaussLegQuad" Gauss-Legendre."""
    pol = params.polarization
    if params.quadrature == "RadauQuad":
        quad = rt_set_streams_radau(params.nstreams, params.sza, params.vza,
                                    pol.n)
    elif params.quadrature == "GaussLegQuad":
        quad = rt_set_streams(params.nstreams, params.sza, params.vza, pol.n)
    else:
        raise ValueError(f"Unknown quadrature: {params.quadrature}")

    profile = compute_atmos_profile_fields(params.T, params.p, params.q)
    if params.profile_reduction != -1:
        profile = reduce_profile(params.profile_reduction, profile)

    bands = []
    for i_band, nu in enumerate(params.spec_bands):
        nu = np.asarray(nu, dtype=np.float64)
        lam_um = 1e4 / nu
        # Depolarization sourcing rule (model_from_parameters.jl:249-297):
        # auto (depol < 0) derives Rayleigh/Cabannes depol from N2/O2
        # molecular constants at the band-mean wavenumber.
        nu_mean = 0.5 * (nu[0] + nu[-1])
        depol_ray_auto, depol_cab_auto, pi_cab = air_depolarization(nu_mean)
        if params.depol < 0:
            depol_ray, depol_cab = depol_ray_auto, depol_cab_auto
        else:
            depol_ray = depol_cab = float(params.depol)
        with timing.stage(f"rayleigh[{i_band}]"):
            tau_rayl = rayleigh_layer_tau(profile.p_half[-1], lam_um,
                                          depol_ray,
                                          profile.vcd_dry)    # (nSpec, Nz)
        with timing.stage(f"absorption[{i_band}]"):
            tau_abs, tau_abs_by_mol = _build_band_absorption(
                params, profile, nu, i_band, device)
        surface = params.surfaces[min(len(bands), len(params.surfaces) - 1)]
        scat = params.scattering_params
        with timing.stage(f"mie[{i_band}]"):
            aerosols = [build_one_aerosol(params, profile, aer,
                                          band_lambda_um(nu))
                        for aer in (scat.rt_aerosols if scat else [])]
        bands.append(BandData(nu_grid=nu, tau_rayl=tau_rayl,
                              tau_abs=tau_abs,
                              greek_rayleigh=greek_rayleigh(depol_ray),
                              aerosols=aerosols,
                              depol_rayleigh=depol_ray,
                              depol_cabannes=depol_cab,
                              pi_cabannes=pi_cab, surface=surface,
                              tau_abs_by_mol=tau_abs_by_mol))
    return RTModel(params=params, quad=quad, profile=profile, bands=bands,
                   device=device)
