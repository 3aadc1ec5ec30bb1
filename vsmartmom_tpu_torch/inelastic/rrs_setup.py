"""RRS spectral setup: redistribution grids and Raman phase coefficients.

Counterpart of ``vsmartmom_tpu/inelastic/rrs_setup.py``, float64 NumPy on
the host like the JAX module. Behavioral reference: vSmartMOM.jl
src/Inelastic/raman_atmo_prop.jl (getRamanSSProp! for RRS, l.57-104),
inelastic_helper.jl (apply_gridlines! l.543-614, get_greek_raman
l.864-882) and the weight normalization of rt_run
(normalize_raman_weights!, rt_run.jl:275).
"""

import numpy as np

from ..scattering.greek import GreekCoefs, greek_rayleigh
from .molecular import get_raman_atmo_constants, pi_cabannes_air


def greek_raman() -> GreekCoefs:
    """Rotational-Raman phase coefficients: Rayleigh form at the fixed
    rotational-Raman depolarization rho = 2*(3/4)/(1 + 3/4) = 6/7
    (inelastic_helper.jl:864-882 with gamma_C_RotRaman = 3/4)."""
    depol = 2.0 * 0.75 / (1.0 + 0.75)
    return greek_rayleigh(depol)


def _deposit_lines(dnu_lines, sigma_lines, nu0, grid, sigma_out):
    """Deposit each Raman line onto its two nearest grid points with S/2
    each (apply_gridlines!, inelastic_helper.jl:543-614), S = sigma * nu^4."""
    dgrid = grid - nu0
    lo, hi = dgrid.min(), dgrid.max()
    for dnu, sig in zip(dnu_lines, sigma_lines):
        if not (lo < dnu < hi) or sig == 0:
            continue
        S = sig * (dnu + nu0) ** 4
        i = int(np.argmin(np.abs(dnu - dgrid)))
        if dgrid[i] < dnu:
            i0, i1 = i, i + 1
        else:
            i0, i1 = i - 1, i
        for k in (i0, i1):
            if 0 <= k < len(grid):
                sigma_out[k] += S / 2.0


def rrs_redistribution(nu_grid, T: float = 300.0):
    """Raman redistribution for a uniform wavenumber grid.

    Returns (shifts, weights, pi_cab):
      shifts  (nR,) int   index offsets: source index n0 = n1 + shift
      weights (nR,) float normalized so sum = 1 - pi_Cabannes
      pi_cab  float       elastic Cabannes fraction at band center
    (getRamanSSProp! RRS, raman_atmo_prop.jl:57-80 + weight normalization.)
    """
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    nu0 = 0.5 * (nu_grid[0] + nu_grid[-1])
    lam_nm = 1e7 / nu0
    n2, o2 = get_raman_atmo_constants(nu0, T)

    sigma_rayl = (n2.vmr * n2.sigma_Rayl_coeff
                  + o2.vmr * o2.sigma_Rayl_coeff) * nu0 ** 4

    sigma_out = np.zeros_like(nu_grid)
    for mol in (n2, o2):
        tmp = np.zeros_like(nu_grid)
        _deposit_lines(mol.dnu_RR_Jp2, mol.sigma_RR_Jp2, nu0, nu_grid, tmp)
        _deposit_lines(mol.dnu_RR_Jm2, mol.sigma_RR_Jm2, nu0, nu_grid, tmp)
        sigma_out += mol.vmr * tmp

    pi_cab = pi_cabannes_air(lam_nm, n2, o2)
    nonzero = np.flatnonzero(sigma_out > 0)
    if len(nonzero) == 0:
        return np.zeros(0, dtype=np.int32), np.zeros(0), pi_cab
    i_center = int(np.argmin(np.abs(nu_grid - nu0)))
    offsets = nonzero - i_center
    weights = sigma_out[nonzero] / sigma_rayl

    # Invert: the central wavelength becomes the *recipient* of RRS from
    # neighboring source wavelengths (raman_atmo_prop.jl:71-76).
    offsets = -offsets[::-1]
    weights = weights[::-1]

    # Normalize so the total Raman weight equals the inelastic fraction
    # (normalize_raman_weights!, rt_run.jl:271-275).
    weights = weights * (1.0 - pi_cab) / weights.sum()
    return offsets.astype(np.int32), weights, pi_cab
