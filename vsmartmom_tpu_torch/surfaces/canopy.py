"""Canopy-coupled surface: a vegetation canopy over a soil BRDF as the
lower boundary of the atmospheric RT.

Counterpart of ``vsmartmom_tpu/surfaces/canopy.py``; behavioral reference
vSmartMOM.jl src/CoreRT/Surfaces/canopy_surface.jl (CanopySurface,
_init_canopy_cache!, create_surface_layer!) and the CanopyOptics.jl
bi-Lambertian leaf model it drives.

Leaves are bi-Lambertian plates (hemispherical reflectance rho_L and
transmittance tau_L, ideally diffuse on both sides). With a *spherical*
leaf-angle distribution (LAD; G(mu) = 1/2 exactly) the area-scattering phase
function depends only on the scattering angle beta (Ross 1981; Shultis &
Myneni 1988), normalized to (1/4pi) Integral p dOmega = 1:

    p(beta) = (8 / 3pi) (sin beta - beta cos beta)
              + (8 tau_L / (3 omega_L)) cos beta,   omega_L = rho_L + tau_L,

so the canopy takes the Greek-coefficient -> Z-supermatrix path of an
aerosol (``bilambertian_greek``), with only the beta series non-zero (the
scattered light is unpolarized). A non-spherical LAD (the de Wit family of
``LAD_FAMILIES``) takes the exact Ross projection ``project_G`` and a
numerical per-moment phase kernel ``lad_phase_fourier``, and its slab the
directional elemental ``_elemental_directional`` (effective cosines
mu / G(mu)).

Canopy optical depth: tau_c = G * Omega_clump * LAI; single-scattering
albedo omega_L. Spectral leaf optics are taken at up to ``n_coarse``
wavenumber nodes and the effective surface operators interpolated to the
band grid (``interp_surface_operators``); with ``include_atm`` and a
within-canopy absorption spectrum (``core/model._canopy_atm_tau``) gap
layers are interleaved between the sublayers and the operators are built
at every point of the band.

``canopy_surface_arrays`` runs the canopy slab through the port's own
plain adding-doubling core (``core/kernels.py``: ``elemental``,
``doubling``, ``interaction``) in torch float64 on a torch device (the
JAX package runs its jnp kernels in float64), one sublayer and one Fourier
moment at a time. Two exact rearrangements keep it cheap at full width:

* the leaf phase kernels are linear in (rho_L, tau_L): omega_L Z(rho_L,
  tau_L) = rho_L Z(1, 0) + tau_L Z(0, 1), so each moment builds two kernels
  and every node's weighted Z is their combination;
* the incident Stokes beams e_k are the K = n_stokes source columns of one
  batch of nodes (the JAX package batches them as nodes x beams), which the
  doubling and interaction steps carry as they carry the solar and thermal
  sources.

Not ported (as in the JAX package): Chen-Leblanc clumping (a constant
clumping index Omega is supported).
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..scattering.greek import GreekCoefs

#: Spherical (uniform) leaf-angle distribution projection factor.
G_SPHERICAL = 0.5

#: de Wit trigonometric leaf-angle distribution family g(theta_L) on
#: [0, pi/2], normalized to unit integral (Bunnik 1978; Ross 1981).
LAD_FAMILIES = {
    "spherical": lambda t: np.sin(t),
    "uniform": lambda t: np.full_like(t, 2.0 / np.pi),
    "planophile": lambda t: (2.0 / np.pi) * (1.0 + np.cos(2.0 * t)),
    "erectophile": lambda t: (2.0 / np.pi) * (1.0 - np.cos(2.0 * t)),
    "plagiophile": lambda t: (2.0 / np.pi) * (1.0 - np.cos(4.0 * t)),
    "extremophile": lambda t: (2.0 / np.pi) * (1.0 + np.cos(4.0 * t)),
}


def ross_psi(mu, mu_L):
    """Exact azimuth-averaged projection kernel
    psi(mu, mu_L) = (1/2pi) Int |Omega . Omega_L| dphi  (Ross 1981):
    psi = |a| for |a| >= b, else (2/pi)(a phi0 + b sin phi0) - a with
    a = mu mu_L, b = sin(theta) sin(theta_L), phi0 = arccos(-a/b)."""
    mu = np.asarray(mu, dtype=np.float64)[:, None]
    mu_L = np.asarray(mu_L, dtype=np.float64)[None, :]
    a = mu * mu_L
    b = np.sqrt(np.maximum(0.0, 1.0 - mu ** 2)) \
        * np.sqrt(np.maximum(0.0, 1.0 - mu_L ** 2))
    b_safe = np.where(b > 0, b, 1.0)
    phi0 = np.arccos(np.clip(-a / b_safe, -1.0, 1.0))
    general = (2.0 / np.pi) * (a * phi0 + b * np.sin(phi0)) - a
    return np.where(np.abs(a) >= b, np.abs(a), general)


def project_G(mu, lad: str = "spherical", n_gauss: int = 96):
    """Ross projection function G(mu) = Int g(theta_L) psi dtheta_L for a
    named LAD (reference CanopyOptics.G; spherical gives exactly 1/2)."""
    if lad == "spherical":
        return np.full(np.shape(np.atleast_1d(mu)), G_SPHERICAL)
    g = LAD_FAMILIES[lad]
    x, w = np.polynomial.legendre.leggauss(n_gauss)
    tl = 0.25 * np.pi * (x + 1.0)
    wl = 0.25 * np.pi * w
    psi = ross_psi(np.atleast_1d(mu), np.cos(tl))       # (n_mu, n_gauss)
    return psi @ (g(tl) * wl)


def bilambertian_phase(mu, rho: float, tau: float):
    """Normalized scattering phase function p(cos beta) of a bi-Lambertian
    leaf with spherical LAD; (1/4pi) Integral p dOmega = 1."""
    mu = np.asarray(mu, dtype=np.float64)
    omega = rho + tau
    if omega <= 0:
        return np.zeros_like(mu)
    beta = np.arccos(np.clip(mu, -1.0, 1.0))
    sin_b = np.sqrt(np.maximum(0.0, 1.0 - mu ** 2))
    return (8.0 / (3.0 * np.pi)) * (sin_b - beta * mu) \
        + (8.0 * tau / (3.0 * omega)) * mu


def bilambertian_greek(rho: float, tau: float, l_max: int) -> GreekCoefs:
    """Legendre (Greek beta) expansion of the bi-Lambertian canopy phase
    function; alpha/gamma/delta/epsilon/zeta are zero (ideal diffuse leaf
    scattering is fully depolarizing)."""
    # Gauss-Legendre projection on mu in [-1, 1]; p is C^1 (its derivative
    # is -arccos-like), so a few hundred nodes resolve l <= ~100 exactly.
    n_gauss = max(4 * l_max, 128)
    x, w = np.polynomial.legendre.leggauss(n_gauss)
    p = bilambertian_phase(x, rho, tau)
    beta = np.zeros(l_max)
    P_prev = np.ones_like(x)
    P_curr = x.copy()
    for l in range(l_max):
        if l == 0:
            Pl = P_prev
        elif l == 1:
            Pl = P_curr
        else:
            Pl = ((2 * l - 1) * x * P_curr - (l - 1) * P_prev) / l
            P_prev, P_curr = P_curr, Pl
        beta[l] = (2 * l + 1) / 2.0 * np.sum(w * p * Pl)
    z = np.zeros(l_max)
    return GreekCoefs(alpha=z, beta=beta, gamma=z, delta=z,
                      epsilon=z, zeta=z)


def lad_phase_fourier(lad: str, rho: float, tau: float, qp_mu, n_m: int,
                      n_tl: int = 48, n_pl: int = 96, n_dphi: int = 64):
    """Per-Fourier-moment scalar canopy phase kernels for an arbitrary
    LAD, by direct numerical projection (the reference's CanopyOptics
    compute_Z_matrices_aniso path, re-derived):

        Gamma(Om_in -> Om_out) = (1/2pi) Int g(tL) dtL Int dphL
            [rho 1(d_in d_out < 0) + tau 1(> 0)] |d_in| |d_out|,
        p_eff = 4 Gamma / (w_L G(mu_in)),
        Z_m(i, j) = (2 - delta_m0) <p_eff cos(m dphi)>_dphi,

    with d = Om . Om_L. The normalizations are pinned to the spherical
    Greek pipeline: for lad='spherical' the numerical p_eff equals
    bilambertian_phase exactly (measured ratio 0.25 = 1/4 on Gamma) and
    the (2 - delta_m0) Fourier factor matches compute_Z_moments.

    Returns (Z_pp, Z_mp) of shape (n_m, Nq, Nq) — scalar I-block kernels
    (bi-Lambertian scattering is ideally depolarizing; the reference's
    vector canopy leaves Q/U/V blocks empty too, canopy_surface.jl
    _check_Z_flux_conservation docstring). ``qp_mu`` are the stream
    cosines, one a node (the surface build passes ``quad.qp_mu``).
    """
    qp_mu = np.asarray(qp_mu, dtype=np.float64)
    Nq = len(qp_mu)
    omega = rho + tau
    if omega <= 0:
        z = np.zeros((n_m, Nq, Nq))
        return z, z
    x, w = np.polynomial.legendre.leggauss(n_tl)
    tl = 0.25 * np.pi * (x + 1.0)
    wl = 0.25 * np.pi * w * LAD_FAMILIES[lad](tl)          # g-weighted
    mu_L = np.cos(tl)
    s_L = np.sin(tl)
    phl = 2.0 * np.pi * np.arange(n_pl) / n_pl
    dphi = 2.0 * np.pi * np.arange(n_dphi) / n_dphi

    s_mu = np.sqrt(np.maximum(0.0, 1.0 - qp_mu ** 2))
    G_in = project_G(qp_mu, lad)

    # d factors: leaf-normal grid (L = (tl, phl)) dotted with stream
    # directions. Incident propagation is DOWN (-mu_j), azimuth 0;
    # outgoing azimuth dphi with z-comp -mu_i (Z++) or +mu_i (Z-+).
    # d_in: (Nq, n_tl, n_pl)
    d_in = (-qp_mu[:, None, None] * mu_L[None, :, None]
            + s_mu[:, None, None] * s_L[None, :, None]
            * np.cos(phl)[None, None, :])
    # d_out: (n_dphi, Nq, n_tl, n_pl)
    cos_out = np.cos(dphi[:, None, None, None] - phl[None, None, None, :])
    s_part = s_mu[None, :, None, None] * s_L[None, None, :, None] * cos_out
    z_part = qp_mu[None, :, None, None] * mu_L[None, None, :, None]
    d_up = z_part + s_part
    d_dn = -z_part + s_part

    wgt = wl[:, None] * (1.0 / n_pl)                        # (n_tl, n_pl)
    cos_m = np.cos(np.outer(np.arange(n_m), dphi))          # (n_m, n_dphi)
    cos_m *= np.where(np.arange(n_m) == 0, 1.0, 2.0)[:, None] / n_dphi

    Z_pp = np.zeros((n_m, Nq, Nq))
    Z_mp = np.zeros((n_m, Nq, Nq))
    for j in range(Nq):                                     # incident
        dj = d_in[j]                                        # (n_tl, n_pl)
        for (d_out, Z) in ((d_dn, Z_pp), (d_up, Z_mp)):
            prod = d_out * dj[None, None, :, :]
            f = np.where(prod < 0.0, rho, tau) * np.abs(prod)
            gam = np.einsum("ditp,tp->di", f, wgt)          # (n_dphi, Nq)
            p_eff = 4.0 * gam / (omega * G_in[j])
            Z[:, :, j] = cos_m @ p_eff                      # (n_m, Nq)
    return Z_pp, Z_mp


def _scalar_to_super(Z_scalar, ns: int):
    """(Nq, Nq) scalar I-kernel -> (Nq ns, Nq ns) supermatrix with the
    I->I block populated (depolarizing diffuse scattering)."""
    Nq = Z_scalar.shape[0]
    Z = np.zeros((Nq * ns, Nq * ns))
    Z[::ns, ::ns] = Z_scalar
    return Z


def _elemental_directional(wZ_pp, wZ_mp, L_sub, att_solar, qp_mu_N, wt_mu_N,
                           G_N, mu0, G0, i_mu0_start, ns, F0, fourier_w):
    """Exact finite-slab elemental operators with DIRECTION-DEPENDENT
    extinction k(mu) = G(mu)/mu per unit leaf area (the reference's
    elemental_canopy.jl physics, re-derived): with effective cosines
    mu~ = mu/G(mu), the Fell operators keep their form with mu~ in every
    exponential and denominator and one G prefactor:

      r(i,j)  = fw wZ-+ wt_j [mu_j / (G_i (mu~_i + mu~_j))] (1 - e^{-L(1/mu~_i + 1/mu~_j)})
      t(i,j)  = fw wZ++ wt_j [mu_j / (G_i (mu~_i - mu~_j))] (e^{-L/mu~_i} - e^{-L/mu~_j})
      t(i,i) += e^{-L/mu~_i}                          (Beer diagonal)

    (the spherical limit mu~ = 2 mu reproduces ``kernels.elemental``).
    Torch on the device of ``wZ_pp``, in its dtype: wZ_pp / wZ_mp (nb, N, N),
    qp_mu_N, wt_mu_N, G_N (N,), att_solar (nb,) or a scalar, F0 (ns, nb);
    L_sub the sublayer's clumped leaf area index (a scalar or (nb,)).
    Returns (r_mp, t_pp, j0_p, j0_m), sources (nb, N)."""
    dev, dt = wZ_pp.device, wZ_pp.dtype

    def t_(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    qp, wt, G_N = t_(qp_mu_N), t_(wt_mu_N), t_(G_N)
    mu_t = qp / G_N
    mu0_t = mu0 / G0
    L = torch.atleast_1d(t_(L_sub))[:, None, None]

    mu_j = qp[None, :]
    mt_i, mt_j = mu_t[:, None], mu_t[None, :]
    G_i = G_N[:, None]
    wct = fourier_w * wt[None, :]

    E = torch.exp(-L / mu_t[None, None, :])
    E_i = torch.exp(-L / mu_t[None, :, None])
    r_geom = mu_j / (G_i * (mt_i + mt_j)) * wct
    one_m_EE = -torch.expm1(-L * (1.0 / mt_i + 1.0 / mt_j)[None])
    r_mp = wZ_mp * r_geom[None] * one_m_EE

    # transmission: (E_i - E_j)/(mt_i - mt_j) in the cancellation-free
    # E_j expm1(x) L / (mt_i mt_j x) form, x = L (1/mt_j - 1/mt_i)
    x = L * (1.0 / mt_j - 1.0 / mt_i)[None]
    zero = x == 0.0
    xr = torch.where(zero, torch.ones_like(x),
                     torch.expm1(x) / torch.where(zero, torch.ones_like(x), x))
    ratio = E * xr * L / (mt_i * mt_j)[None]
    t_geom = (mu_j / G_i) * wct
    t_pp = wZ_pp * t_geom[None] * ratio
    Np = t_pp.shape[-1]
    t_pp = t_pp + E_i * torch.eye(Np, dtype=dt, device=dev)[None]

    # solar sources: incident beam mu0 (effective mu0_t), unit F0 columns
    sl = slice(i_mu0_start, i_mu0_start + ns)
    F0 = t_(F0)
    Zp_I0 = torch.einsum("bik,kb->bi", wZ_pp[:, :, sl], F0)
    Zm_I0 = torch.einsum("bik,kb->bi", wZ_mp[:, :, sl], F0)
    Lv = L[..., 0]                                          # (nb, 1)
    E_0 = torch.exp(-Lv / mu0_t)
    j_m = fourier_w * Zm_I0 * (mu0 / (G_N * (mu_t + mu0_t)))[None] \
        * (-torch.expm1(-Lv * (1.0 / mu_t[None, :] + 1.0 / mu0_t)))
    y = Lv * (1.0 / mu0_t - 1.0 / mu_t[None, :])
    zero = y == 0.0
    yr = torch.where(zero, torch.ones_like(y),
                     torch.expm1(y) / torch.where(zero, torch.ones_like(y), y))
    # (E_i - E_0)/(k_0 - k_i) = L E_0 expm1(y)/y,  y = L(1/mu0~ - 1/mu~_i)
    ratio_v = E_0 * yr * Lv / (mu_t[None, :] * mu0_t)
    j_p = fourier_w * Zp_I0 * (mu0 / G_N)[None] * ratio_v
    att = torch.atleast_1d(t_(att_solar))[:, None]
    return r_mp, t_pp, j_p * att, j_m * att


@dataclass
class CanopySurface:
    """Canopy + soil lower boundary (reference CoreRT/types.jl:560-647).

    soil: a SurfaceDescriptor (any supported surface type) for the ground
    below the canopy. leaf_reflectance/transmittance may be scalars or
    arrays on ``leaf_optics_grid`` (grid_unit 'nm' wavelengths or 'wn'
    wavenumbers in cm^-1).
    """
    soil: object
    LAI: float = 3.0
    n_layers: int = 1
    leaf_reflectance: object = 0.4
    leaf_transmittance: object = 0.05
    leaf_optics_grid: Optional[np.ndarray] = None
    grid_unit: str = "nm"
    clumping_omega: float = 1.0     # ConstantClumping Omega (1 = no clumping)
    lad: str = "spherical"          # leaf-angle distribution (LAD_FAMILIES)
    lai_fractions: Optional[tuple] = None
                                    # per-sublayer LAI fractions (len
                                    # n_layers; None = uniform split)
    include_atm: bool = False       # interleave within-canopy gas absorption
    canopy_dp: Optional[float] = None
                                    # within-canopy pressure depth [hPa] for
                                    # include_atm (canopy_surface.jl
                                    # _compute_canopy_atm_tau!)
    n_coarse: int = 7               # coarse spectral nodes for Z cache
    # Canopy sublayer doubling target. The exact-single-scatter elemental
    # truncates multiple scattering within d_tau, an O(d_tau) *total* energy
    # error after composing tau_c/d_tau slabs (the JAX package measured a
    # 0.6% leak at d_tau = 7e-4, halving per doubling). 2e-5 keeps closure
    # ~< 1e-4 at ~6 more doublings.
    dtau_max: float = 2e-5

    def leaf_grid_wn(self) -> Optional[np.ndarray]:
        if self.leaf_optics_grid is None:
            return None
        g = np.asarray(self.leaf_optics_grid, dtype=np.float64)
        return 1e7 / g if self.grid_unit == "nm" else g

    def tau_canopy(self) -> float:
        """Nadir-projected canopy optical depth (spherical-G bookkeeping;
        directional paths use project_G per stream)."""
        return G_SPHERICAL * self.clumping_omega * self.LAI

    def sublayer_lai(self) -> np.ndarray:
        """Clumped leaf-area index per sublayer (reference _sublayer_lai:
        LAI * lai_fractions[i], or a uniform LAI / n_layers split)."""
        n = max(1, int(self.n_layers))
        if self.lai_fractions is not None:
            fr = np.asarray(self.lai_fractions, dtype=np.float64)
            assert len(fr) == n, (len(fr), n)
            lai = self.LAI * fr
        else:
            lai = np.full(n, self.LAI / n)
        return self.clumping_omega * lai


def _leaf_optics_nodes(canopy: CanopySurface, nu_grid):
    """Coarse wavenumber nodes + leaf (rho, tau) at each node.

    Scalar leaf optics -> a single node. Spectral leaf optics -> up to
    ``n_coarse`` nodes spanning the band (reference
    _build_spectral_canopy_cache coarse grid)."""
    grid_wn = canopy.leaf_grid_wn()
    if grid_wn is None:
        return (np.array([float(np.mean(nu_grid))]),
                np.array([float(canopy.leaf_reflectance)]),
                np.array([float(canopy.leaf_transmittance)]))
    order = np.argsort(grid_wn)
    grid_wn = grid_wn[order]
    R = np.asarray(canopy.leaf_reflectance, dtype=np.float64)[order]
    T = np.asarray(canopy.leaf_transmittance, dtype=np.float64)[order]
    lo, hi = float(np.min(nu_grid)), float(np.max(nu_grid))
    n_nodes = max(2, min(canopy.n_coarse,
                         int(np.sum((grid_wn >= lo) & (grid_wn <= hi))) + 2))
    nodes = np.linspace(lo, hi, n_nodes)
    R_n = np.interp(nodes, grid_wn, R)
    T_n = np.interp(nodes, grid_wn, T)
    return nodes, R_n, T_n


def _leaf_kernels(canopy: CanopySurface, quad, pol, n_m: int):
    """The two leaf phase kernels of every moment, (K_R, K_T) each
    (n_m, N, N): the weighted Z of a node with leaf optics (rho, tau) is
    rho K_R + tau K_T (p is linear in (rho, tau) once times omega). A
    spherical LAD takes the Greek path (``bilambertian_greek`` at (1, 0) and
    (0, 1), its series capped at the stream limit 2 Nstreams - 1, the
    contract aerosols get by delta truncation: longer series break the
    discrete energy closure); any other LAD the numerical projection
    ``lad_phase_fourier`` on the I blocks."""
    from ..scattering.zmatrix import compute_Z_moments, legendre_tables
    ns = pol.n
    if canopy.lad != "spherical":
        out = []
        for rho, tau in ((1.0, 0.0), (0.0, 1.0)):
            Zpp, Zmp = lad_phase_fourier(canopy.lad, rho, tau,
                                         np.asarray(quad.qp_mu), n_m)
            out.append(np.stack([[_scalar_to_super(Z[m], ns)
                                  for m in range(n_m)] for Z in (Zpp, Zmp)]))
        return out[0], out[1]
    l_max = min(max(n_m + 1, 3), 2 * quad.Nstreams - 1)
    tables = legendre_tables(quad.qp_mu, l_max, n_m)
    out = []
    for rho, tau in ((1.0, 0.0), (0.0, 1.0)):
        gk = bilambertian_greek(rho, tau, l_max)
        out.append(np.stack([np.stack(compute_Z_moments(pol, quad.qp_mu, gk,
                                                        m, tables))
                             for m in range(n_m)], axis=1))
    return out[0], out[1]        # (2, n_m, N, N): [Z++, Z-+]


def canopy_surface_arrays(canopy: CanopySurface, quad, pol, n_m: int,
                          nu_grid, soil_r, soil_j, soil_spec,
                          atm_tau=None, device="cpu"):
    """Effective canopy+soil surface operators per Fourier moment.

    Runs the canopy slab (tau_c = G Omega LAI, ssa = rho + tau, the leaf
    kernels of ``_leaf_kernels``) through ``core/kernels.py``'s elemental,
    doubling and interaction in torch float64 on ``device``, then adds the
    soil surface layer under it: one batch of the leaf-optics nodes, the
    incident Stokes beams e_k its source columns (model-build work, like
    the reference's _init_canopy_cache!).

    Returns (node_wn, R_eff (n_m, n_nodes, N, N), J_eff (n_m, n_nodes, N,
    ns)) as float64 NumPy in the solver's surface-operator convention: R_eff
    includes every quadrature factor; J_eff[:, :, :, k] is the upwelling
    source for a unit direct beam e_k at canopy top (before the
    exp(-tau_atm/mu0) attenuation, which the solver's surface layer
    applies)."""
    from ..core.kernels import (AddedLayer, doubling, elemental,
                                identity_composite, interaction)
    from ..core.types import stokes_d_vector

    dev = torch.device(device)
    f64 = torch.float64

    def t_(x):
        return torch.as_tensor(np.asarray(x), dtype=f64, device=dev)

    ns = pol.n
    N = quad.Nquad * ns
    mu0 = float(quad.qp_mu[quad.i_mu0])
    i_mu0_start = quad.i_mu0 * ns

    use_atm = bool(canopy.include_atm) and atm_tau is not None \
        and canopy.n_layers > 1 and np.any(np.asarray(atm_tau) != 0.0)
    if use_atm:
        # Within-canopy line absorption cannot be interpolated between
        # nodes: build the effective operators at every point of the band.
        nodes = np.asarray(nu_grid, dtype=np.float64)
        grid_wn = canopy.leaf_grid_wn()
        if grid_wn is None:
            R_leaf = np.full(len(nodes), float(canopy.leaf_reflectance))
            T_leaf = np.full(len(nodes), float(canopy.leaf_transmittance))
        else:
            order = np.argsort(grid_wn)
            R_leaf = np.interp(nodes, grid_wn[order],
                               np.asarray(canopy.leaf_reflectance,
                                          dtype=np.float64)[order])
            T_leaf = np.interp(nodes, grid_wn[order],
                               np.asarray(canopy.leaf_transmittance,
                                          dtype=np.float64)[order])
        tau_gap = np.asarray(atm_tau, dtype=np.float64) \
            / max(1, canopy.n_layers - 1)
    else:
        nodes, R_leaf, T_leaf = _leaf_optics_nodes(canopy, nu_grid)
        tau_gap = None
    nb = len(nodes)

    soil_spec_nodes = np.interp(nodes, np.sort(np.asarray(nu_grid)),
                                np.asarray(soil_spec)[np.argsort(nu_grid)]) \
        if len(np.atleast_1d(soil_spec)) > 1 else \
        np.full(nb, float(np.atleast_1d(soil_spec)[0]))

    L_subs = canopy.sublayer_lai()           # clumped LAI per sublayer
    n_sub = len(L_subs)
    directional = canopy.lad != "spherical"
    G_N = project_G(np.asarray(quad.qp_mu_N), canopy.lad)
    G0 = float(project_G(np.array([mu0]), canopy.lad)[0])
    G_max = float(np.max(G_N)) if directional else G_SPHERICAL

    def _ndoubl(L_k):
        t_eff = L_k * G_max
        return 0 if t_eff <= canopy.dtau_max else \
            int(np.ceil(np.log2(t_eff / canopy.dtau_max)))

    K_R, K_T = (t_(k) for k in _leaf_kernels(canopy, quad, pol, n_m))
    rho_b = t_(R_leaf)[:, None, None]
    tau_b = t_(T_leaf)[:, None, None]
    d_vec = t_(stokes_d_vector(ns, quad.Nquad))
    qp_mu_N, wt_mu_N = t_(quad.qp_mu_N), t_(quad.wt_mu_N)
    eye_k = torch.eye(ns, dtype=f64, device=dev)
    beams = [eye_k[:, k:k + 1].expand(ns, nb) for k in range(ns)]

    # The solar path above each sublayer (leaf and gap depth), per node.
    tau_above, tau_solar = [], np.zeros(nb)
    for iz in range(n_sub):
        tau_above.append(tau_solar.copy())
        tau_solar = tau_solar + G0 * float(L_subs[iz])
        if use_atm and iz < n_sub - 1:
            tau_solar = tau_solar + tau_gap
    att_c = t_(np.exp(-tau_solar / mu0))
    spec_b = t_(soil_spec_nodes)
    if use_atm:
        t_gap = torch.diag_embed(torch.exp(-t_(tau_gap)[:, None]
                                           / qp_mu_N[None, :]))
        zero_m = torch.zeros((nb, N, N), dtype=f64, device=dev)
        zero_v = torch.zeros((nb, N, ns), dtype=f64, device=dev)
        gap = AddedLayer(zero_m, zero_m, t_gap, t_gap, zero_v, zero_v)

    R_eff = np.zeros((n_m, nb, N, N))
    J_eff = np.zeros((n_m, nb, N, ns))
    eye_b = torch.eye(N, dtype=f64, device=dev).expand(nb, N, N)
    for m in range(n_m):
        fourier_w = 0.5 if m == 0 else 0.25
        wZ_pp = rho_b * K_R[0, m][None] + tau_b * K_T[0, m][None]
        wZ_mp = rho_b * K_R[1, m][None] + tau_b * K_T[1, m][None]
        comp = identity_composite(nb, N, f64, dev, ns)
        for iz in range(n_sub):
            L_k = float(L_subs[iz])
            ndoubl = _ndoubl(L_k)
            dL = L_k / (2 ** ndoubl)
            if directional:
                att = np.exp(-tau_above[iz] / mu0)
                elem = [_elemental_directional(
                    wZ_pp, wZ_mp, dL, att, quad.qp_mu_N, quad.wt_mu_N, G_N,
                    mu0, G0, i_mu0_start, ns, F0, fourier_w) for F0 in beams]
                expk = torch.full((nb, ns), np.exp(-dL * G0 / mu0),
                                  dtype=f64, device=dev)
            else:
                dtau = torch.full((nb,), G_SPHERICAL * dL, dtype=f64,
                                  device=dev)
                elem = [elemental(wZ_pp, wZ_mp, dtau, t_(tau_above[iz]),
                                  qp_mu_N, wt_mu_N, mu0, i_mu0_start, ns, F0,
                                  fourier_w) for F0 in beams]
                expk = torch.exp(-dtau / mu0)[:, None].expand(nb, ns)
            r_mp, t_pp = elem[0][:2]
            j_p = torch.stack([e[2] for e in elem], dim=-1)   # (nb, N, ns)
            j_m = torch.stack([e[3] for e in elem], dim=-1)
            comp = interaction(comp, doubling(r_mp, t_pp, j_p, j_m, expk,
                                              ndoubl, d_vec))
            if use_atm and iz < n_sub - 1:
                # Absorption-only gap layer between canopy sublayers
                # (_interleave_atm_layer!): t = diag(e^{-tau_gap/mu_i}),
                # r = 0, no sources.
                comp = interaction(comp, gap)

        # Soil as a surface layer under the canopy: its reflection scaled by
        # the node's spectral albedo, its source the soil BRDF's response to
        # the canopy-attenuated direct beam.
        r_soil = t_(soil_r[m])[None] * spec_b[:, None, None]
        jm_soil = t_(soil_j[m])[None] * (att_c * spec_b)[:, None, None]
        out = interaction(comp, AddedLayer(
            r_soil, torch.zeros_like(r_soil), eye_b, eye_b,
            torch.zeros_like(jm_soil), jm_soil))
        R_eff[m] = out.R_mp.cpu().numpy()
        J_eff[m] = out.J0_m.cpu().numpy()
    return nodes, R_eff, J_eff


def interp_surface_operators(nodes, R_eff, J_eff, nu_grid):
    """Linearly interpolate per-node effective surface operators onto the
    full spectral grid -> (n_m, n_spec, N, N) / (n_m, n_spec, N, ns), one
    moment at a time (the JAX package's arithmetic, without its whole-array
    temporaries: at nSpec 4096 and N = 52 the result alone is 1.4 GB)."""
    nu = np.asarray(nu_grid, dtype=np.float64)
    n_m, n_spec = R_eff.shape[0], len(nu)
    R = np.empty((n_m, n_spec) + R_eff.shape[2:])
    J = np.empty((n_m, n_spec) + J_eff.shape[2:])
    if len(nodes) == 1:
        R[:] = R_eff[:, :1]
        J[:] = J_eff[:, :1]
        return R, J
    idx = np.clip(np.searchsorted(nodes, nu) - 1, 0, len(nodes) - 2)
    x0, x1 = nodes[idx], nodes[idx + 1]
    w = np.clip((nu - x0) / np.where(x1 > x0, x1 - x0, 1.0), 0.0, 1.0)
    for m in range(n_m):
        for out, op in ((R, R_eff), (J, J_eff)):
            lo = op[m, idx]
            out[m] = lo + w[:, None, None] * (op[m, idx + 1] - lo)
    return R, J
