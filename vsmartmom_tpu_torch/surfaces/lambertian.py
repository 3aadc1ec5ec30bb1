"""Lambertian surface BRDF operators.

Behavioral reference: vSmartMOM.jl src/CoreRT/Surfaces/lambertian_surface.jl
(create_surface_layer! for the scalar/spectrum/Legendre flavors).

A Lambertian surface contributes only to the m = 0 Fourier moment with

    R_raw[i, j] = 2 * albedo   when both i and j are Stokes-I rows
    r-+          = R_raw @ diag(qp_mu_N * wt_mu_N)
    j0-          = mu0 * R_raw[:, solar block] @ F0 * exp(-tau_sum/mu0)

For m > 0 the surface operators vanish (transmission stays identity).

The functions below separate the angular pattern (built at unit albedo)
from the spectral albedo scaling ``surf_spec``, so scalar, per-wavelength
and Legendre-coefficient albedos flow through the same SolverInputs.
"""

import numpy as np

from ..scattering.legendre import compute_legendre_poly
from ..utils.quadrature import QuadPoints


def lambertian_surface_arrays(quad: QuadPoints, n_stokes: int, n_m: int):
    """(surf_r, surf_j_m) at unit albedo.

    surf_r: (n_m, N, N)        reflection operator incl. quadrature factor
    surf_j_m: (n_m, N, n_stokes) mu0 * R_raw[:, solar block]
    """
    N = quad.Nquad * n_stokes
    surf_r = np.zeros((n_m, N, N))
    surf_j = np.zeros((n_m, N, n_stokes))

    is_I = (np.arange(N) % n_stokes) == 0
    R_raw = np.where(np.outer(is_I, is_I), 2.0, 0.0)
    surf_r[0] = R_raw * (quad.qp_mu_N * quad.wt_mu_N)[None, :]
    sl = slice(quad.i_mu0_start, quad.i_mu0_start + n_stokes)
    surf_j[0] = quad.mu0 * R_raw[:, sl]
    return surf_r, surf_j


def lambertian_spectral_scale(albedo, n_spec: int) -> np.ndarray:
    """Spectral albedo vector for ``surf_spec`` (scalar or per-wavelength)."""
    arr = np.asarray(albedo, dtype=np.float64)
    if arr.ndim == 0:
        return np.full(n_spec, float(arr))
    if len(arr) != n_spec:
        raise ValueError("spectral albedo length must equal nSpec")
    return arr


def lambertian_legendre_scale(coeffs, n_spec: int) -> np.ndarray:
    """Legendre-polynomial spectral albedo over the band
    (lambertian_surface.jl:97-143): albedo(x) = sum_k c_k P_k(x),
    x uniform in [-1, 1] across the band grid."""
    coeffs = np.asarray(coeffs, dtype=np.float64)
    x = np.linspace(-1.0, 1.0, n_spec)
    P = compute_legendre_poly(x, max(len(coeffs), 2))[0][:, :len(coeffs)]
    return P @ coeffs
