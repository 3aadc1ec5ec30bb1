"""StandaloneSS: the exact single-scattering solver and its Jacobians.

Counterpart of ``vsmartmom_tpu/standalone_ss.py``; behavioral reference
vSmartMOM.jl src/StandaloneSS/{types,solver,kernels,surfaces,
chain_rule}.jl. Four single-scatter light paths through a plane-parallel
column (solver.jl:1-13):

  path 1: solar beam -> one atmospheric scatter -> viewer (exact phase)
  path 2: solar beam -> surface BRDF -> viewer (direct-direct)
  path 3: one atmospheric scatter -> Lambertian surface -> viewer
  path 4: solar beam -> Lambertian surface -> one atmospheric scatter -> viewer

Stokes vectors for paths 1-2 come from the phase matrix's first column with
the scattering-plane rotation (analytic_phase_functions.jl:168-208) and the
Cox-Munk Mueller matrix's first column.

The optics (phase tables, the surface BRDF) are host float64 NumPy
(``_pack``); the paths are one pure torch function of the packed arrays
(``_ss_paths``, float64 on the given device), so exact Jacobians with
respect to each contributor's optical depths, the single-scattering albedos
and the surface albedo come from ``torch.func.jacfwd`` (the JAX package
uses ``jax.jacfwd``; the reference writes its chain rule by hand,
chain_rule.jl). The Jacobian in tau is dense in the spectral axis: keep S
small there.
"""

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .core.types import resolve_device
from .scattering.greek import GreekCoefs
from .scattering.mie import hg_phase_function, reconstruct_phase


# ---------------------------------------------------------------------------
# Configuration types (StandaloneSS/types.jl)
# ---------------------------------------------------------------------------

@dataclass
class SSGeometry:
    mu0: float                  # positive solar cosine
    mu_v: np.ndarray            # positive upward viewing cosines
    dphi: np.ndarray            # view-sun relative azimuth [rad]


@dataclass
class LambertianSSSurface:
    albedo: float               # scalar or (nSpec,)


@dataclass
class CoxMunkSSSurface:
    wind_speed: float
    n_water: Optional[complex] = None
    whitecap_albedo: float = 0.22
    include_whitecaps: bool = True
    shadowing: bool = True


@dataclass
class RayleighSSContributor:
    tau: np.ndarray             # (nLayer, nSpec)
    depol: float = 0.0
    ssa: float = 1.0


@dataclass
class HGAerosolSSContributor:
    g: float
    ssa: float
    tau: np.ndarray


@dataclass
class GreekCoefsSSContributor:
    greek_coefs: GreekCoefs
    ssa: float
    tau: np.ndarray


@dataclass
class AbsorptionSSContributor:
    tau: np.ndarray
    ssa: float = 0.0


@dataclass
class ExactSSConfig:
    geometry: SSGeometry
    surface: object
    contributors: Sequence
    I0: float = 1.0
    n_stokes: int = 1
    inner_nquad: int = 16
    azimuth_nquad: int = 64


# ---------------------------------------------------------------------------
# Phase evaluations (host, f64)
# ---------------------------------------------------------------------------

def _rayleigh_greek(depol: float) -> GreekCoefs:
    from .scattering.greek import greek_rayleigh
    return greek_rayleigh(depol)


def _contributor_greek(c) -> Optional[GreekCoefs]:
    if isinstance(c, RayleighSSContributor):
        return _rayleigh_greek(c.depol)
    if isinstance(c, GreekCoefsSSContributor):
        return c.greek_coefs
    return None


def exact_phase_function(c, cos_theta):
    """Scalar phase function at exact scattering angles (types.jl:146-171)."""
    cos_theta = np.atleast_1d(np.asarray(cos_theta, dtype=np.float64))
    if isinstance(c, RayleighSSContributor):
        dpl = (1 - c.depol) / (1 + c.depol / 2)
        P2 = (3 * cos_theta ** 2 - 1) / 2
        return 1.0 + 0.5 * dpl * P2
    if isinstance(c, HGAerosolSSContributor):
        return hg_phase_function(c.g, cos_theta)
    if isinstance(c, GreekCoefsSSContributor):
        return reconstruct_phase(c.greek_coefs, cos_theta)["f11"]
    return np.zeros_like(cos_theta)


def _scattering_cos(mu0, mu_v, dphi):
    s0 = np.sqrt(max(0.0, 1 - mu0 ** 2))
    sv = np.sqrt(np.maximum(0.0, 1 - np.asarray(mu_v) ** 2))
    return -mu0 * np.asarray(mu_v) + s0 * sv * np.cos(np.asarray(dphi))


def _rotation_from_scattering_plane(mu0, mu_v, dphi, cos_T):
    """(cos 2chi, sin 2chi) rotating the scattering-plane Stokes frame to the
    meridian frame (analytic_phase_functions.jl:173-186)."""
    sin_T2 = np.maximum(0.0, 1 - cos_T ** 2)
    safe = sin_T2 > np.finfo(np.float64).eps
    sin_T = np.sqrt(np.where(safe, sin_T2, 1.0))
    s0 = np.sqrt(max(0.0, 1 - mu0 ** 2))
    sv = np.sqrt(np.maximum(0.0, 1 - mu_v ** 2))
    cos_chi = (mu0 * sv + mu_v * s0 * np.cos(dphi)) / sin_T
    sin_chi = s0 * np.sin(dphi) / sin_T
    c2 = np.where(safe, cos_chi ** 2 - sin_chi ** 2, 1.0)
    s2 = np.where(safe, 2 * sin_chi * cos_chi, 0.0)
    return c2, s2


def phase_first_column(greek: GreekCoefs, mu0, mu_v, dphi, n_stokes: int):
    """First column of the phase matrix for an unpolarized beam at exact
    geometry: [f11, f12 cos2chi, f12 sin2chi, 0][:n]."""
    mu_v = np.atleast_1d(np.asarray(mu_v, dtype=np.float64))
    dphi = np.atleast_1d(np.asarray(dphi, dtype=np.float64))
    cos_T = _scattering_cos(mu0, mu_v, dphi)
    f = reconstruct_phase(greek, cos_T)
    c2, s2 = _rotation_from_scattering_plane(mu0, mu_v, dphi, cos_T)
    cols = np.zeros((len(mu_v), n_stokes))
    cols[:, 0] = f["f11"]
    if n_stokes >= 2:
        cols[:, 1] = f["f12"] * c2
    if n_stokes >= 3:
        cols[:, 2] = f["f12"] * s2
    return cols


def _azimuth_average_phase(c, mu_a, mu_b, n_phi: int):
    """(1/2pi) int P(cos Theta(mu_a, mu_b, phi)) dphi by uniform rule
    (solver.jl:146-163), broadcast over (mu_a, mu_b) arrays."""
    mu_a = np.asarray(mu_a, dtype=np.float64)
    mu_b = np.asarray(mu_b, dtype=np.float64)
    if isinstance(c, RayleighSSContributor):
        # closed form (kernels.jl:94-100)
        a = mu_a * mu_b
        b = np.sqrt(np.maximum(0.0, 1 - mu_a ** 2)) * \
            np.sqrt(np.maximum(0.0, 1 - mu_b ** 2))
        mean_cos2 = a ** 2 + 0.5 * b ** 2
        dpl = (1 - c.depol) / (1 + c.depol / 2)
        return 1.0 + 0.5 * dpl * (3 * mean_cos2 - 1) / 2
    phis = 2 * np.pi * np.arange(n_phi) / n_phi
    a = (mu_a * mu_b)[..., None]
    b = (np.sqrt(np.maximum(0.0, 1 - mu_a ** 2))
         * np.sqrt(np.maximum(0.0, 1 - mu_b ** 2)))[..., None]
    cos_T = np.clip(a + b * np.cos(phis), -1.0, 1.0)
    return exact_phase_function(c, cos_T.ravel()).reshape(cos_T.shape).mean(-1)


# ---------------------------------------------------------------------------
# The path evaluations (torch, pure: forward-mode AD passes through)
# ---------------------------------------------------------------------------

def _ss_paths(tau_contrib, ssa_contrib, P1_cols, brdf_cols, P3_bar, P4_bar,
              mu0, mu_v, I0, albedo, mu_nodes, mu_wts, n_stokes: int,
              lambertian_surface: bool = False):
    """All four path radiances from the packed arrays (torch tensors on one
    device): tau_contrib (C, Nz, S); ssa_contrib (C,); P1_cols (C, nGeom,
    nStokes); brdf_cols (nGeom, nStokes, S); P3_bar / P4_bar (C, nGeom, K),
    the azimuth-averaged phase at the inner nodes against the mu0 and the
    mu_v directions; mu0 a float; mu_v (nGeom,); I0, albedo (S,); mu_nodes,
    mu_wts (K,). Returns a dict of path1..path4, each (nGeom, nStokes, S).
    No in-place op, no host read: ``torch.func.jacfwd`` runs through it."""
    C, nz, S = tau_contrib.shape
    nG = mu_v.shape[0]
    dt, dev = tau_contrib.dtype, tau_contrib.device

    tau_layer = tau_contrib.sum(dim=0)                       # (Nz, S)
    scat_w = tau_contrib * ssa_contrib[:, None, None]        # (C, Nz, S)
    tau_scat = scat_w.sum(dim=0)
    tau_cum = torch.cat([torch.zeros((1, S), dtype=dt, device=dev),
                         torch.cumsum(tau_layer, dim=0)], dim=0)
    tau_tot = tau_cum[-1]                                    # (S,)

    # ---- path 1: exact atmospheric single scatter (kernels.jl:1-37) ----
    a = 1.0 / mu0 + 1.0 / mu_v                               # (nG,)
    pref = I0[None, :] / (4 * np.pi * mu_v[:, None] * a[:, None])  # (nG, S)
    layer_fac = (torch.exp(-tau_cum[:-1][None] * a[:, None, None])
                 - torch.exp(-tau_cum[1:][None] * a[:, None, None]))
    # weighted phase: sum_c scat_w P1_col / tau_layer -> (nG, nstk, Nz, S)
    wP = torch.einsum("czs,cgk->gkzs", scat_w, P1_cols)
    safe_tau = torch.where(tau_layer > 0, tau_layer,
                           torch.ones_like(tau_layer))
    path1 = pref[:, None, :] * torch.einsum(
        "gkzs,gzs->gks", wP / safe_tau[None, None], layer_fac)

    # ---- path 2: beam -> surface -> viewer (kernels.jl:40-62) ----
    att = torch.exp(-tau_tot[None, :] / mu0) * \
        torch.exp(-tau_tot[None, :] / mu_v[:, None])         # (nG, S)
    if lambertian_surface:
        # brdf = albedo/pi on Stokes-I only, differentiable in albedo
        brdf_eff = torch.cat([
            (albedo / np.pi)[None, None, :].expand(nG, 1, S),
            torch.zeros((nG, n_stokes - 1, S), dtype=dt, device=dev)], dim=1)
    else:
        brdf_eff = brdf_cols
    path2 = mu0 * I0[None, None, :] * brdf_eff * att[:, None, :]

    # ---- paths 3/4: Lambertian-coupled diffuse (kernels.jl:64-200) ----
    # inner tau integral per layer and node:
    # int exp(-t/mu_first - (T - t)/mu_in) dt over each layer
    def tau_integral(mu_first):
        b = 1.0 / mu_first[:, None] - 1.0 / mu_nodes[None, :]        # (nG, K)
        t_top = tau_cum[:-1]                                          # (Nz, S)
        t_bot = tau_cum[1:]

        def f(t):
            return torch.exp(
                -t[None, :, :, None] / mu_first[:, None, None, None]
                - (tau_tot[None, None, :, None] - t[None, :, :, None])
                / mu_nodes[None, None, None, :])             # (nG,Nz,S,K)
        f_top, f_bot = f(t_top), f(t_bot)
        small = torch.abs(b) < 1e-10
        safe_b = torch.where(small, torch.ones_like(b), b)
        exact = (f_top - f_bot) / safe_b[:, None, None, :]
        lim = 0.5 * (f_top + f_bot) * (t_bot - t_top)[None, :, :, None]
        return torch.where(small[:, None, None, :], lim, exact)

    # path 3: the downwelling flux at the surface from one scatter of the
    # direct beam (first leg mu0)
    ti3 = tau_integral(torch.full_like(mu_v, mu0))           # (nG,Nz,S,K)
    ssa_eff = tau_scat / safe_tau
    safe_scat = torch.where(tau_scat > 0, tau_scat,
                            torch.ones_like(tau_scat))
    wP3 = torch.einsum("czs,cgk->gzsk", scat_w, P3_bar) \
        / safe_scat[None, :, :, None]
    inner3 = 0.5 * torch.einsum("gzsk,gzsk,k->gs",
                                wP3 * ssa_eff[None, :, :, None], ti3, mu_wts)
    F_surf = I0[None, :] * inner3
    p3 = (albedo[None, :] / np.pi) * F_surf * \
        torch.exp(-tau_tot[None, :] / mu_v[:, None])

    # path 4: direct to the surface, Lambertian up, one scatter to the
    # viewer
    ti4 = tau_integral(mu_v)
    wP4 = torch.einsum("czs,cgk->gzsk", scat_w, P4_bar) \
        / safe_scat[None, :, :, None]
    inner4 = 0.5 * torch.einsum("gzsk,gzsk,k->gs",
                                wP4 * ssa_eff[None, :, :, None], ti4, mu_wts)
    L_surf = (albedo[None, :] / np.pi) * mu0 * I0[None, :] * \
        torch.exp(-tau_tot[None, :] / mu0)
    p4 = L_surf * inner4 / mu_v[:, None]

    zpad = torch.zeros((nG, n_stokes - 1, S), dtype=dt, device=dev)
    path3 = torch.cat([p3[:, None, :], zpad], dim=1)
    path4 = torch.cat([p4[:, None, :], zpad], dim=1)
    return {"path1": path1, "path2": path2, "path3": path3, "path4": path4}


def _pack(config: ExactSSConfig):
    """Host precompute (float64 NumPy): packed tau / ssa, the phase tables
    and the surface BRDF."""
    geo = config.geometry
    mu_v = np.asarray(geo.mu_v, dtype=np.float64)
    dphi = np.asarray(geo.dphi, dtype=np.float64)
    n_stokes = config.n_stokes
    contribs = list(config.contributors)
    nz, S = np.asarray(contribs[0].tau).shape
    C = len(contribs)
    nG = len(mu_v)

    tau_contrib = np.stack([np.asarray(c.tau, dtype=np.float64)
                            for c in contribs])
    ssa_contrib = np.array([c.ssa for c in contribs])

    # exact phase first columns per contributor per geometry
    P1 = np.zeros((C, nG, n_stokes))
    cos_T = _scattering_cos(geo.mu0, mu_v, dphi)
    for ic, c in enumerate(contribs):
        gk = _contributor_greek(c)
        if n_stokes > 1 and gk is not None:
            P1[ic] = phase_first_column(gk, geo.mu0, mu_v, dphi, n_stokes)
        else:
            P1[ic, :, 0] = exact_phase_function(c, cos_T)

    # azimuthally averaged phase tables at inner quadrature nodes
    x, w = np.polynomial.legendre.leggauss(config.inner_nquad)
    mu_nodes, mu_wts = (x + 1) / 2, w / 2
    P3 = np.zeros((C, nG, config.inner_nquad))
    P4 = np.zeros((C, nG, config.inner_nquad))
    for ic, c in enumerate(contribs):
        p3 = _azimuth_average_phase(c, mu_nodes[None, :],
                                    np.full((nG, 1), geo.mu0),
                                    config.azimuth_nquad)
        p4 = _azimuth_average_phase(c, mu_nodes[None, :], mu_v[:, None],
                                    config.azimuth_nquad)
        P3[ic], P4[ic] = p3, p4

    # surface BRDF first columns (path 2) + Lambertian albedo (paths 3/4)
    brdf = np.zeros((nG, n_stokes, S))
    lambertian_surface = isinstance(config.surface, LambertianSSSurface)
    if lambertian_surface:
        albedo = np.broadcast_to(np.asarray(config.surface.albedo,
                                            dtype=np.float64), (S,)).copy()
    elif isinstance(config.surface, CoxMunkSSSurface):
        from .surfaces.coxmunk import CoxMunkSurface, cox_munk_mueller
        s = config.surface
        cm = CoxMunkSurface(wind_speed=s.wind_speed, n_water=s.n_water,
                            whitecap_albedo=s.whitecap_albedo,
                            include_whitecaps=s.include_whitecaps,
                            shadowing=s.shadowing)
        M = cox_munk_mueller(cm, max(n_stokes, 1), mu_v, geo.mu0, dphi)
        brdf[:, :, :] = M[:, :n_stokes, 0][:, :, None]
        albedo = np.zeros(S)        # paths 3/4 are Lambertian-only (reference)
    else:
        raise NotImplementedError(type(config.surface))

    I0 = np.broadcast_to(np.asarray(config.I0, dtype=np.float64), (S,)).copy()
    return dict(tau_contrib=tau_contrib, ssa_contrib=ssa_contrib,
                P1_cols=P1, brdf_cols=brdf, P3_bar=P3, P4_bar=P4,
                mu0=geo.mu0, mu_v=mu_v, I0=I0, albedo=albedo,
                mu_nodes=mu_nodes, mu_wts=mu_wts,
                lambertian_surface=lambertian_surface)


_PATH_SETS = {
    "path1": ("path1",), "path2": ("path2",), "path3": ("path3",),
    "path4": ("path4",), "paths_1_2": ("path1", "path2"),
    "all": ("path1", "path2", "path3", "path4"),
    "all_four": ("path1", "path2", "path3", "path4"),
}


_PATH_SETS = {
    "path1": ("path1",), "path2": ("path2",), "path3": ("path3",),
    "path4": ("path4",), "paths_1_2": ("path1", "path2"),
    "all": ("path1", "path2", "path3", "path4"),
    "all_four": ("path1", "path2", "path3", "path4"),
}

#: The packed arrays ``_ss_paths`` takes as tensors (``mu0`` is a float).
_TENSORS = ("tau_contrib", "ssa_contrib", "P1_cols", "brdf_cols", "P3_bar",
            "P4_bar", "mu_v", "I0", "albedo", "mu_nodes", "mu_wts")


def _on_device(packed, dev):
    """``_pack``'s arrays as float64 tensors on ``dev`` (mu0 stays a
    float), and the surface flag apart."""
    kw = {k: torch.as_tensor(packed[k], dtype=torch.float64, device=dev)
          for k in _TENSORS}
    kw["mu0"] = float(packed["mu0"])
    return kw, bool(packed["lambertian_surface"])


def run_exact_ss(config: ExactSSConfig, paths: str = "paths_1_2",
                 device=None):
    """Run the standalone exact single-scatter solver (solver.jl:516-598
    run_exact_ss) on ``device`` (CUDA unless given). Returns a dict with
    path1..path4 and total (each (nGeom, nStokes, nSpec) numpy; the paths
    not asked for are zeros) and metadata."""
    if paths not in _PATH_SETS:
        raise ValueError(f"paths must be one of {sorted(_PATH_SETS)}")
    packed = _pack(config)
    kw, lamb = _on_device(packed, resolve_device(device))
    out = _ss_paths(**kw, n_stokes=config.n_stokes, lambertian_surface=lamb)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    wanted = _PATH_SETS[paths]
    total = sum(out[k] for k in wanted)
    nG, ns, S = out["path1"].shape
    result = {k: (out[k] if k in wanted else np.zeros_like(out[k]))
              for k in out}
    result["total"] = total
    result["metadata"] = dict(n_layers=packed["tau_contrib"].shape[1],
                              n_spec=S, n_geom=nG, n_stokes=ns, paths=paths)
    return result


def run_exact_ss_with_jacobians(config: ExactSSConfig,
                                paths: str = "paths_1_2", device=None):
    """Forward run and exact Jacobians with respect to each contributor's
    layer optical depths, the single-scattering albedos and the surface
    albedo: ``torch.func.jacfwd`` through ``_ss_paths`` (in place of
    chain_rule.jl's hand-written combinators). Returns (result, jac):
    ``run_exact_ss``'s result and jac["d_tau"] (nGeom, nStokes, S, C, Nz,
    S), jac["d_ssa"] (nGeom, nStokes, S, C), jac["d_albedo"] (nGeom,
    nStokes, S, S), each the derivative of the paths' total (numpy)."""
    if paths not in _PATH_SETS:
        raise ValueError(f"paths must be one of {sorted(_PATH_SETS)}")
    dev = resolve_device(device)
    packed = _pack(config)
    kw, lamb = _on_device(packed, dev)
    wanted = _PATH_SETS[paths]

    def total_of(tau_contrib, ssa_contrib, albedo):
        out = _ss_paths(**{**kw, "tau_contrib": tau_contrib,
                           "ssa_contrib": ssa_contrib, "albedo": albedo},
                        n_stokes=config.n_stokes, lambertian_surface=lamb)
        return sum(out[k] for k in wanted)

    d_tau, d_ssa, d_albedo = torch.func.jacfwd(total_of, argnums=(0, 1, 2))(
        kw["tau_contrib"], kw["ssa_contrib"], kw["albedo"])
    jac = {"d_tau": d_tau.cpu().numpy(), "d_ssa": d_ssa.cpu().numpy(),
           "d_albedo": d_albedo.cpu().numpy()}
    return run_exact_ss(config, paths, dev), jac
