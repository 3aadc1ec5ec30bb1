"""Vibrational Raman (VS 0->1 / 1->0) spectral setup.

Counterpart of ``vsmartmom_tpu/inelastic/vs_setup.py``, float64 NumPy on
the host like the JAX module. Behavioral reference: vSmartMOM.jl
src/Inelastic/raman_atmo_prop.jl
(getRamanSSProp! for VS_0to1/VS_1to0, l.20-40), inelastic_helper.jl
(compute_optical_RS! VS variants l.665-758, ϖ_Cabannes_VS l.285-292) and the
VS elemental kernel convention (elemental_inelastic.jl get_elem_rt_VS!,
l.279-343): the **incident wavelength is the FIRST element of the spectral
grid**; all other grid points form the scattered (VS-shifted) band.

Scattered light at grid point n1 receives single-scatter vibrational Raman
from the incident point n0 = 0 with weight w(n1) = sigma_VS(n1)/sigma_Rayl,
where sigma_VS combines the Q-branch (VRS, polarizability-derivative lines)
and the O/S branches (RVRS, anisotropy-derivative lines). The phase matrix
for all of them is the Rayleigh form at the rotational-Raman depolarization
6/7 (get_greek_raman, inelastic_helper.jl:864-882 — shared with RRS).
"""

import numpy as np

from .molecular import get_raman_atmo_constants
from .rrs_setup import _deposit_lines, greek_raman  # noqa: F401 (re-export)


def _vs_lines(mol, mode: str):
    """(dnu, sigma) arrays of all vibrational lines of one molecule."""
    if mode == "VS_0to1":
        pairs = [(mol.dnu_VR_0to1, mol.sigma_VR_0to1),
                 (mol.dnu_RVR_0to1_Jp2, mol.sigma_RVR_0to1_Jp2),
                 (mol.dnu_RVR_0to1_Jm2, mol.sigma_RVR_0to1_Jm2)]
    elif mode == "VS_1to0":
        pairs = [(mol.dnu_VR_1to0, mol.sigma_VR_1to0),
                 (mol.dnu_RVR_1to0_Jp2, mol.sigma_RVR_1to0_Jp2),
                 (mol.dnu_RVR_1to0_Jm2, mol.sigma_RVR_1to0_Jm2)]
    else:
        raise ValueError(f"unknown VS mode {mode!r}")
    return pairs


def vs_redistribution(nu_grid, mode: str, T: float = 300.0):
    """Vibrational-Raman redistribution for a grid whose FIRST point is the
    incident wavelength.

    Returns (w_targets, pi_cab_vs, k_rayl_scatt):
      w_targets    (nSpec,) per-target weights sigma_VS(n1)/sigma_Rayl(nu0);
                   zero at the incident point and wherever no line lands
      pi_cab_vs    1 - (sigma_VRS + sigma_RVRS)/sigma_Rayl at nu0
                   (inelastic_helper.jl:285-292)
      k_rayl_scatt sigma_Rayl(mean scattered nu)/sigma_Rayl(nu0)
                   (raman_atmo_prop.jl:24-28)
    """
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    nu0 = float(nu_grid[0])
    n2, o2 = get_raman_atmo_constants(nu0, T)

    sigma_rayl = (n2.vmr * n2.sigma_Rayl_coeff
                  + o2.vmr * o2.sigma_Rayl_coeff) * nu0 ** 4

    sigma_out = np.zeros_like(nu_grid)
    sigma_tot = 0.0                       # full VS cross-section (all lines)
    for mol in (n2, o2):
        tmp = np.zeros_like(nu_grid)
        for dnu, sig in _vs_lines(mol, mode):
            _deposit_lines(dnu, sig, nu0, nu_grid, tmp)
            sigma_tot += mol.vmr * np.sum((nu0 + dnu) ** 4 * sig)
        sigma_out += mol.vmr * tmp
    sigma_out[0] = 0.0                    # incident point receives nothing

    w_targets = sigma_out / sigma_rayl
    pi_cab_vs = 1.0 - sigma_tot / sigma_rayl

    nu_scatt = 0.5 * (nu_grid[1] + nu_grid[-1]) if len(nu_grid) > 2 \
        else nu_grid[-1]
    n2s, o2s = get_raman_atmo_constants(float(nu_scatt), T)
    sigma_rayl_scatt = (n2s.vmr * n2s.sigma_Rayl_coeff
                        + o2s.vmr * o2s.sigma_Rayl_coeff) * nu_scatt ** 4
    return w_targets, pi_cab_vs, float(sigma_rayl_scatt / sigma_rayl)


def vs_band_grid(nu0: float, half_width: float = 200.0,
                 dnu: float = 0.3, mode: str = "VS_0to1",
                 T: float = 300.0) -> np.ndarray:
    """Convenience: build a VS grid [nu0, scattered band] centered on the
    mean N2/O2 vibrational shift (the reference's TMP grid recipe,
    inelastic_helper.jl:672,720)."""
    n2, o2 = get_raman_atmo_constants(nu0, T)
    if mode == "VS_0to1":
        shift = 0.5 * (n2.dnu_VR_0to1[0] + o2.dnu_VR_0to1[0])
    else:
        shift = 0.5 * (n2.dnu_VR_1to0[0] + o2.dnu_VR_1to0[0])
    center = nu0 + shift
    band = np.arange(center - half_width, center + half_width + dnu / 2, dnu)
    return np.concatenate([[nu0], band])
