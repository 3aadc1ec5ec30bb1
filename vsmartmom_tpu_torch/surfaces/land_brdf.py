"""Scalar land-surface BRDFs: RPV and Ross-Li (kernel-weighted).

Counterpart of ``vsmartmom_tpu/surfaces/land_brdf.py``; behavioral
reference vSmartMOM.jl src/CoreRT/Surfaces/{rpv_surface.jl,
rossli_surface.jl}. Both are scalar (Stokes-I only) models;
the polarized blocks of the surface supermatrix are zero. Conventions follow
the reference's RAMI adaptations: the RPV hot-spot parameter enters negated
(rpv_surface.jl:139-141) and Ross-Li evaluates at the reversed relative
azimuth pi - dphi (rossli_surface.jl:36-38).

Vectorized over the full (mu_out, mu_in, phi) grid; the Fourier projection
reuses one BRDF grid for all moments. Host float64 NumPy, as in the JAX
package.
"""

from dataclasses import dataclass

import numpy as np

from ..utils.quadrature import QuadPoints, gauleg

N_QUAD_PHI = 100


@dataclass
class RPVSurface:
    """Rahman-Pinty-Verstraete BRDF (types.jl rpvSurfaceScalar)."""
    rho0: float     # amplitude
    rho_c: float    # geometric (bowl) term amplitude
    k: float        # Minnaert exponent
    theta: float    # hot-spot asymmetry


@dataclass
class RossLiSurface:
    """RossThick + LiSparse kernel BRDF (types.jl RossLiSurfaceScalar)."""
    f_vol: float
    f_geo: float
    f_iso: float


def rpv_reflectance(surf: RPVSurface, mu_i, mu_r, dphi):
    """RPV BRDF (Rahman et al. 1993; rpv_surface.jl:114-150), broadcast."""
    mu_i, mu_r, dphi = np.broadcast_arrays(mu_i, mu_r, dphi)
    ti = np.arccos(np.clip(mu_i, 0, 1))
    tr = np.arccos(np.clip(mu_r, 0, 1))
    cosg = -mu_i * mu_r + np.sin(ti) * np.sin(tr) * np.cos(dphi)
    G = np.sqrt(np.maximum(
        0.0, np.tan(ti) ** 2 + np.tan(tr) ** 2
        + 2 * np.tan(ti) * np.tan(tr) * np.cos(dphi)))
    M = (mu_i * mu_r) ** (surf.k - 1) / (mu_i + mu_r) ** (1 - surf.k)
    th = -surf.theta                      # RAMI sign convention
    F = (1 - th ** 2) / (1 + th ** 2 + 2 * th * cosg) ** 1.5
    H = 1 + (1 - surf.rho_c) / (1 + G)
    return surf.rho0 * M * F * H


def rossli_reflectance(surf: RossLiSurface, mu_i, mu_r, dphi):
    """Ross-Li BRDF (Lucht/Schaaf/Strahler 2000; rossli_surface.jl:34-98),
    broadcast. RAMI kernel constants h/b = 2, b/r = 1."""
    mu_i, mu_r, dphi = np.broadcast_arrays(
        np.asarray(mu_i, dtype=np.float64), np.asarray(mu_r, dtype=np.float64),
        np.asarray(dphi, dtype=np.float64))
    dphi = np.pi - dphi                   # RAMI azimuth reversal
    ti = np.arccos(np.clip(mu_i, 0, 1))
    tr = np.arccos(np.clip(mu_r, 0, 1))

    xi = np.arccos(np.clip(np.cos(ti) * np.cos(tr)
                           + np.sin(ti) * np.sin(tr) * np.cos(dphi), -1, 1))
    K_vol = (((np.pi / 2 - xi) * np.cos(xi) + np.sin(xi))
             / (np.cos(ti) + np.cos(tr)) - np.pi / 4)

    tip = np.arctan(np.tan(ti))           # b/r = 1
    trp = np.arctan(np.tan(tr))
    xip = np.arccos(np.clip(np.cos(tip) * np.cos(trp)
                            + np.sin(tip) * np.sin(trp) * np.cos(dphi), -1, 1))
    D = np.sqrt(np.maximum(
        0.0, np.tan(tip) ** 2 + np.tan(trp) ** 2
        - 2 * np.tan(tip) * np.tan(trp) * np.cos(dphi)))
    sec_sum = 1 / np.cos(tip) + 1 / np.cos(trp)
    ct = np.clip(2.0 * np.sqrt(D ** 2 + (np.tan(tip) * np.tan(trp)
                                         * np.sin(dphi)) ** 2) / sec_sum,
                 -1, 1)
    t = np.arccos(ct)
    O = (1 / np.pi) * (t - np.sin(t) * np.cos(t)) * sec_sum
    K_geo = O - sec_sum + 0.5 * (1 + np.cos(xip)) \
        / (np.cos(tip) * np.cos(trp))

    return surf.f_iso + surf.f_vol * K_vol + surf.f_geo * K_geo


def scalar_brdf_surface_arrays(reflectance_fn, quad: QuadPoints,
                               n_stokes: int, n_m: int):
    """Surface operator stack for a scalar BRDF through the generic
    numeric-BRDF path (rpv_surface.jl:51-96 create_surface_layer! +
    reflectance Fourier projection at l.152-191).

    Returns (surf_r (n_m, N, N), surf_j (n_m, N, n_stokes)) — only the
    Stokes-I sub-blocks are populated.
    """
    mu = quad.qp_mu
    nmu = quad.Nquad
    N = nmu * n_stokes
    phi, w = gauleg(N_QUAD_PHI, 0.0, np.pi)

    # BRDF grid: rho[i (reflected), j (incident), p (azimuth)]
    rho = reflectance_fn(mu[:, None, None], mu[None, :, None],
                         phi[None, None, :])

    surf_r = np.zeros((n_m, N, N))
    surf_j = np.zeros((n_m, N, n_stokes))
    qw = quad.qp_mu_N * quad.wt_mu_N
    i_I = np.arange(nmu) * n_stokes       # Stokes-I rows/cols
    for m in range(n_m):
        ff = 1.0 if m == 0 else 2.0
        R_scalar = (ff / np.pi) * np.einsum("p,ijp->ij", w * np.cos(m * phi),
                                            rho, optimize=True)
        if m == 0:
            R_scalar = 2.0 * R_scalar     # m=0 factor (rpv_surface.jl:68-70)
        R_raw = np.zeros((N, N))
        R_raw[np.ix_(i_I, i_I)] = R_scalar
        surf_r[m] = R_raw * qw[None, :]
        sl = slice(quad.i_mu0_start, quad.i_mu0_start + n_stokes)
        surf_j[m] = quad.mu0 * R_raw[:, sl]
    return surf_r, surf_j
