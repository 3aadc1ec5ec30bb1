"""Model build: user parameters -> RTModel (host setup + solver inputs).

Counterpart of ``vsmartmom_tpu/core/model.py`` for the scenes this slice of
the port covers: Rayleigh-only columns over a Cox-Munk ocean or a
Lambertian surface, with optional per-layer thermal emission. All setup
physics runs on the host in float64 NumPy, as in the JAX package;
``build_band`` hands the arrays to the device as float64 tensors and the
solver casts them to ``config.dtype``.

Aerosols, gas absorption, the Radau quadrature and the other surfaces raise
``NotImplementedError``; they are queued in ROADMAP.md.
"""

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..inelastic.molecular import air_depolarization
from ..scattering.greek import GreekCoefs, greek_rayleigh
from ..scattering.stokes import Polarization
from ..scattering.zmatrix import compute_Z_moments
from ..surfaces.lambertian import (lambertian_spectral_scale,
                                   lambertian_surface_arrays)
from ..utils.quadrature import QuadPoints, nearest_index, rt_set_streams
from .atmosphere import (AtmosphericProfile, compute_atmos_profile_fields,
                         compute_ndoubl, rayleigh_layer_tau, reduce_profile)
from .types import (SolverConfig, resolve_device, solver_inputs_from_numpy,
                    stokes_d_vector)


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
    absorption_params: Optional[Any] = None   # not ported yet: must be None
    scattering_params: Optional[Any] = None   # not ported yet: must be None
    dtau_max_threshold: float = 1e-3
    quadrature: str = "GaussLegQuad"
    # Execution strategy (None = auto: the band kernel for f32 on CUDA).
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
class BandData:
    """Mutable per-band optics for one spectral band."""
    nu_grid: np.ndarray                 # (nSpec,)
    tau_rayl: np.ndarray                # (nSpec, Nz), mutable for overrides
    tau_abs: np.ndarray                 # (nSpec, Nz)
    greek_rayleigh: GreekCoefs
    depol_rayleigh: float = 0.0
    depol_cabannes: float = 0.0
    pi_cabannes: float = 1.0
    surface: SurfaceDescriptor = None
    # optional per-layer Planck radiance (Nz, nSpec): a second source slot
    thermal_b: Optional[np.ndarray] = None
    # optional surface SIF emission (nSpec,), isotropic, m = 0 only
    sif_spec: Optional[np.ndarray] = None

    @property
    def n_spec(self) -> int:
        return len(self.nu_grid)


def _surface_m_support(surface: SurfaceDescriptor, stream_l_cap: int) -> int:
    """Fourier support of the surface BRDF (component_m_max.jl:
    Lambertian -> 0; Cox-Munk -> the stream cap)."""
    if surface.kind.startswith("Lambertian"):
        return 0
    return stream_l_cap


def _surface_arrays(surface: SurfaceDescriptor, quad: QuadPoints,
                    n_stokes: int, n_m: int, n_spec: int):
    """(surf_r, surf_j_m, surf_spec, surf_direct_m), as in the JAX package:
    surf_r[m] includes the m = 0 factor 2 and the diag(mu*w) quadrature
    factor, surf_j_m[m] = mu0 * R_raw[:, solar block], surf_spec scales both
    spectrally and surf_direct_m masks the moments with a direct-beam j0+."""
    kind = surface.kind
    if kind == "LambertianSurfaceScalar":
        direct_m = np.zeros(n_m)
        direct_m[0] = 1.0
        r, j = lambertian_surface_arrays(quad, n_stokes, n_m)
        return r, j, lambertian_spectral_scale(surface.args[0], n_spec), \
            direct_m
    if kind == "CoxMunkSurface":
        from ..surfaces.coxmunk import (CoxMunkSurface,
                                        coxmunk_surface_operator_arrays)
        surf = CoxMunkSurface(**{k: v for k, v in surface.kwargs.items()
                                 if not k.startswith("_")})
        surf_r, surf_j = coxmunk_surface_operator_arrays(
            surf, quad, n_stokes, n_m)
        return surf_r, surf_j, np.ones(n_spec), np.ones(n_m)
    raise NotImplementedError(f"surface {kind} is not ported yet")


class RTModel:
    """Built model: geometry + profile + per-band optics.

    ``build_band`` assembles one band's (SolverInputs, SolverConfig) from the
    current (possibly user-mutated) optics."""

    def __init__(self, params: Parameters, quad: QuadPoints,
                 profile: AtmosphericProfile, bands: list):
        self.params = params
        self.quad = quad
        self.profile = profile
        self.bands = bands
        self.vza_idx = tuple(nearest_index(quad.qp_mu, np.cos(np.deg2rad(v)))
                             for v in params.vza)

    def _band_m_max(self, band: BandData) -> int:
        """Per-band Fourier order from component support, clamped by the
        stream contract stream_l_cap = 2*Nstreams - 1."""
        cap = self.params.stream_l_cap
        supports = [band.greek_rayleigh.l_max - 1,
                    _surface_m_support(band.surface, cap)]
        return min(max(supports), cap)

    def build_band(self, i_band: int, device=None, rrs: bool = False):
        """(SolverInputs on ``device`` as float64, SolverConfig) for one band.

        ``device`` also picks the strategy when ``params.fused`` is None:
        the band kernel for an f32 model on CUDA, the plain path otherwise
        (an f64 model stays on the plain path, as in the JAX package).
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
        N = quad.Nquad * ns
        surf_r, surf_j, surf_spec, surf_direct_m = _surface_arrays(
            band.surface, quad, ns, n_m, n_spec)

        # Phase supermatrices per Fourier moment (one component: Rayleigh,
        # or its Cabannes line for RRS runs).
        greek0 = greek_rayleigh(band.depol_cabannes) if rrs \
            else band.greek_rayleigh
        Z_pp = np.zeros((n_m, 1, N, N))
        Z_mp = np.zeros((n_m, 1, N, N))
        for m in range(n_m):
            Z_pp[m, 0], Z_mp[m, 0] = compute_Z_moments(
                pol, quad.qp_mu, greek0, m)

        # Layer mixing weight tau_c * ssa_c (Rayleigh ssa = 1).
        scat_w = band.tau_rayl.T[:, None, :] \
            * (band.pi_cabannes if rrs else 1.0)               # (Nz, 1, s)
        tau = band.tau_rayl.T + band.tau_abs.T                 # (Nz, nSpec)

        # Uniform doubling count: max of the per-layer rule
        # (rt_kernel.jl:266-287).
        weighted = quad.wt_mu > np.finfo(np.float64).eps
        mu_min = quad.qp_mu[weighted].min()
        ndoubl = max(
            (compute_ndoubl(scat_w[z].sum(axis=0).max(), mu_min,
                            params.dtau_max_threshold, dtype=ft) for z in range(nz)), default=0)

        # Azimuthal postprocessing weights (postprocessing_vza.jl:23-37).
        vza_w = np.zeros((n_m, len(params.vza), ns))
        for m in range(n_m):
            w = 0.5 / np.pi if m == 0 else 1.0 / np.pi
            for iv, phi in enumerate(params.vaz):
                cosm = np.cos(np.deg2rad(m * phi))
                sinm = np.sin(np.deg2rad(m * phi))
                vza_w[m, iv] = w * np.array([cosm, cosm, sinm, sinm][:ns])

        F0 = np.tile(pol.I0[:, None], (1, n_spec))

        n_sources = 2 if band.thermal_b is not None else 1
        thermal_b = band.thermal_b if band.thermal_b is not None \
            else np.zeros((nz, n_spec))

        # --- Execution strategy: the whole-moment band kernel for f32 on
        # CUDA; one spectral point per operator (no block-diagonal packing);
        # a scene-probed Newton-Schulz schedule on the kernel path.
        fused = params.fused
        if fused is None:
            fused = dev.type == "cuda" and ft == np.float32
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
            surf_probe = np.asarray(surf_r[0]) * float(np.max(surf_spec)) \
                if np.size(surf_spec) else None
            ns_sched, ns_inter = probe_ns_schedule(
                wZ_pp_l, wZ_mp_l, tau_p, quad.qp_mu_N, quad.wt_mu_N,
                d_vec, int(ndoubl), surf_r=surf_probe)

        # Highest moment with atmospheric scattering: beyond it the column
        # is purely absorbing and the solver's exact Beer-law shortcut
        # applies (Cox-Munk pushes m_max to the stream cap, Rayleigh
        # scatters only to m = 2).
        m_scat = min(m_max, band.greek_rayleigh.l_max - 1)

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
        return solver_inputs_from_numpy(fields, dev, torch.float64), config


def model_from_parameters(params: Parameters) -> RTModel:
    if params.quadrature != "GaussLegQuad":
        raise NotImplementedError(
            f"quadrature {params.quadrature} is not ported yet")
    if params.scattering_params is not None:
        raise NotImplementedError("aerosols are not ported yet")
    if params.absorption_params is not None:
        raise NotImplementedError("gas absorption is not ported yet")
    pol = params.polarization
    quad = rt_set_streams(params.nstreams, params.sza, params.vza, pol.n)

    profile = compute_atmos_profile_fields(params.T, params.p, params.q)
    if params.profile_reduction != -1:
        profile = reduce_profile(params.profile_reduction, profile)
    nz = profile.nz

    bands = []
    for nu in params.spec_bands:
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
        tau_rayl = rayleigh_layer_tau(profile.p_half[-1], lam_um, depol_ray,
                                      profile.vcd_dry)        # (nSpec, Nz)
        surface = params.surfaces[min(len(bands), len(params.surfaces) - 1)]
        bands.append(BandData(nu_grid=nu, tau_rayl=tau_rayl,
                              tau_abs=np.zeros((len(nu), nz)),
                              greek_rayleigh=greek_rayleigh(depol_ray),
                              depol_rayleigh=depol_ray,
                              depol_cabannes=depol_cab,
                              pi_cabannes=pi_cab, surface=surface))
    return RTModel(params=params, quad=quad, profile=profile, bands=bands)
