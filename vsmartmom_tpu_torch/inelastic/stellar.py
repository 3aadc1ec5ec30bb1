"""Stellar (H2-atmosphere) Raman scattering: sol_RRS / sol_VS modes.

Counterpart of ``vsmartmom_tpu/inelastic/stellar.py``: the setup is float64
NumPy on the host like the JAX module; ``rt_run_stellar`` runs the port's
inelastic solves. The reference's stellar Raman twins (sol_RRS,
sol_VS_0to1, sol_VS_1to0 and their concatenated-grid ``_plus`` variants)
reuse the atmospheric RRS/VS transport algebra with three changes,
mirrored here:

* the scatterer is molecular hydrogen (H2) instead of the N2/O2 air mix
  (behavioral refs: vSmartMOM.jl src/Inelastic/stellar_types.jl:13-210,
  src/molecular_constructors.jl:145-216 H2 constants,
  stellar_inelastic_helper.jl:29-52 getRamanSolarConstants);
* the Cabannes fraction is defined against the H2 Rayleigh cross-section
  (stellar_inelastic_helper.jl:72-154 compute_w_Cabannes);
* the source F0 is a full stellar spectrum (pol.n, nSpec), plumbed through
  the band's ``f0_spec`` field, and the vibrational modes carry TWO Raman
  channels with distinct phase matrices: the O/S rovibrational branches at
  the rotational-Raman depolarization 6/7 and the Q-branch at the
  vibrational depolarization 2 gC/(1 + gC), gC = 3/(45 eps'^2 + 4)
  (stellar_inelastic_helper.jl:642-683 get_greek_raman[_VS],
  inelastic_cross_section.jl:46-57).

Design note: the reference carries both VS channels through one kernel pass
with two sets of Z matrices. The inelastic transport is first-order in the
redistribution source (the ie operators never multiply each other — the
block-triangular algebra of ``core/inelastic.py``), so the two channels
run as two passes of the plain fixed-source solve and their ie outputs are
summed, as in the JAX package. sol_RRS takes the port's RRS route: the
kernels K1 and K3 for an f32 model on CUDA, with K3's ie ladder at the
elastic (full) resolution, since the JAX reference solves sol_RRS at full
resolution only.
"""

import numpy as np

from ..scattering.greek import GreekCoefs, greek_rayleigh
from .molecular import Molecule, compute_molecular_constants
from .rrs_setup import _deposit_lines


def _h2(vmr: float = 0.91) -> Molecule:
    """H2 molecular constants (getMolecularConstants(H2(), vmr),
    molecular_constructors.jl:145-216). Default vmr 0.91: solar/gas-giant
    atmosphere H2 fraction."""
    Y = np.zeros((5, 5))
    Y[0, 1] = 60.853        # B_e [cm^-1]
    Y[0, 2] = -0.0471       # -D_e
    Y[1, 0] = 4401.21       # omega_e
    Y[1, 1] = -3.062        # -alpha_e
    Y[2, 0] = -121.33       # -omega_e x_e
    return Molecule("H2", vmr, alpha00=0.8032e-24, alpha00_prime=0.90e-24,
                    omega0=2.1399e16, alpha_b=5.870e-6, alpha_c=7.544e-9,
                    gamma00=0.288e-24, gamma00_prime=1.02e-24,
                    Y=Y, gs_odd=3, gs_even=1)


def get_raman_solar_constants(nu_eff: float, T: float = 273.0,
                              vmr_h2: float = 0.91) -> Molecule:
    """H2 constants at effective wavenumber nu_eff [cm^-1]
    (getRamanSolarConstants, stellar_inelastic_helper.jl:29-52)."""
    return compute_molecular_constants(nu_eff, T, _h2(vmr_h2))


def rho_depol_rayleigh(mol: Molecule) -> float:
    """Rayleigh depolarization of the stellar atmosphere,
    2 gC / (1 + gC) (inelastic_cross_section.jl:49,54) — use as the
    ``depol`` model parameter for H2 scenes."""
    g = mol.gamma_C_Rayl
    return 2.0 * g / (1.0 + g)


def greek_raman_stellar() -> GreekCoefs:
    """Phase coefficients for H2 rotational/rovibrational Raman:
    Rayleigh form at depol = 2*(3/4)/(1+3/4) = 6/7
    (get_greek_raman, stellar_inelastic_helper.jl:642-662 with
    gamma_C_RotRaman = 3/4, inelastic_cross_section.jl:50)."""
    return greek_rayleigh(2.0 * 0.75 / 1.75)


def greek_raman_stellar_vs(mol: Molecule) -> GreekCoefs:
    """Phase coefficients for the H2 vibrational Q-branch: Rayleigh form at
    depol = 2 gC/(1 + gC), gC = 3/(45 (alpha'/gamma')^2 + 4)
    (get_greek_raman_VS, stellar_inelastic_helper.jl:664-683 +
    inelastic_cross_section.jl:51-52,56)."""
    eps_prime = mol.alpha_prime / mol.gamma_prime
    g = 3.0 / (45.0 * eps_prime ** 2 + 4.0)
    return greek_rayleigh(2.0 * g / (1.0 + g))


def sol_rrs_redistribution(nu_grid, T: float = 273.0, vmr_h2: float = 0.91):
    """H2 rotational-Raman redistribution for a uniform wavenumber grid.

    Returns (shifts, weights, pi_cab):
      shifts  (nR,) int   index offsets (source n0 = n1 + shift)
      weights (nR,)       sigma_RRS(line)/sigma_Rayl, normalized so the
                          total equals 1 - pi_cab
      pi_cab  float       sigma_el / (sigma_RRS + sigma_el)
    (getRamanSSProp!(sol_RRS), raman_stellar_prop.jl:61-81;
    compute_stellar_RS! sol_RRS, stellar_inelastic_helper.jl:458-489;
    compute_w_Cabannes sol_RRS, stellar_inelastic_helper.jl:72-112.)
    """
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    nu0 = 0.5 * (nu_grid[0] + nu_grid[-1])
    h2 = get_raman_solar_constants(nu0, T, vmr_h2)

    sigma_rayl = h2.vmr * h2.sigma_Rayl_coeff * nu0 ** 4
    dnu_p, sig_p = _significant(h2.dnu_RR_Jp2, h2.sigma_RR_Jp2)
    dnu_m, sig_m = _significant(h2.dnu_RR_Jm2, h2.sigma_RR_Jm2)
    sigma_out = np.zeros_like(nu_grid)
    _deposit_lines(dnu_p, sig_p, nu0, nu_grid, sigma_out)
    _deposit_lines(dnu_m, sig_m, nu0, nu_grid, sigma_out)
    sigma_out *= h2.vmr

    sigma_rrs_tot = h2.vmr * (np.sum((nu0 + dnu_p) ** 4 * sig_p)
                              + np.sum((nu0 + dnu_m) ** 4 * sig_m))
    pi_cab = sigma_rayl / (sigma_rrs_tot + sigma_rayl)

    nonzero = np.flatnonzero(sigma_out > 0)
    if len(nonzero) == 0:
        return np.zeros(0, dtype=np.int32), np.zeros(0), pi_cab
    i_center = int(np.argmin(np.abs(nu_grid - nu0)))
    offsets = nonzero - i_center
    weights = sigma_out[nonzero] / sigma_rayl
    # Grid inversion: the central wavelength is the RECIPIENT of RRS from
    # neighboring sources (raman_stellar_prop.jl:74-78).
    offsets = -offsets[::-1]
    weights = weights[::-1]
    weights = weights * (1.0 - pi_cab) / weights.sum()
    return offsets.astype(np.int32), weights, pi_cab


#: Relative line-strength floor: drop lines below this fraction of the
#: strongest line. H2's huge rotational constant (B_e = 60.85 cm^-1) makes
#: the Dunham expansion's centrifugal term dominate at high J, producing
#: nonsense shifts for levels whose Boltzmann population is ~ e^-40 — the
#: floor removes them without touching any populated line.
_SIGMA_FLOOR = 1e-10


def _significant(dnu, sig):
    sig = np.asarray(sig)
    keep = sig > _SIGMA_FLOOR * sig.max() if sig.max() > 0 else sig > 0
    return np.asarray(dnu)[keep], sig[keep]


def _h2_vs_lines(mol: Molecule, mode: str):
    """((dnu, sigma) RVRS O/S branches, (dnu, sigma) VRS Q branch)."""
    if mode in ("sol_VS_0to1", "VS_0to1"):
        rvrs = [(mol.dnu_RVR_0to1_Jp2, mol.sigma_RVR_0to1_Jp2),
                (mol.dnu_RVR_0to1_Jm2, mol.sigma_RVR_0to1_Jm2)]
        vrs = [(mol.dnu_VR_0to1, mol.sigma_VR_0to1)]
    elif mode in ("sol_VS_1to0", "VS_1to0"):
        rvrs = [(mol.dnu_RVR_1to0_Jp2, mol.sigma_RVR_1to0_Jp2),
                (mol.dnu_RVR_1to0_Jm2, mol.sigma_RVR_1to0_Jm2)]
        vrs = [(mol.dnu_VR_1to0, mol.sigma_VR_1to0)]
    else:
        raise ValueError(f"unknown stellar VS mode {mode!r}")
    return rvrs, vrs


def sol_vs_redistribution(nu_grid, mode: str, T: float = 273.0,
                          vmr_h2: float = 0.91):
    """H2 vibrational-Raman redistribution; FIRST grid point = incident.

    Returns (w_rvrs, w_vrs, pi_cab_vs, k_rayl_scatt):
      w_rvrs (nSpec,)  per-target O/S-branch weights (phase fn:
                       greek_raman_stellar)
      w_vrs  (nSpec,)  per-target Q-branch weights (phase fn:
                       greek_raman_stellar_vs)
      pi_cab_vs        sigma_el / (sigma_VRS + sigma_RVRS + sigma_el)
                       (compute_w_Cabannes _plus,
                       stellar_inelastic_helper.jl:114-154)
      k_rayl_scatt     sigma_Rayl(mean scattered)/sigma_Rayl(incident)
                       (raman_stellar_prop.jl:23-42)
    """
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    nu0 = float(nu_grid[0])
    h2 = get_raman_solar_constants(nu0, T, vmr_h2)
    sigma_rayl = h2.vmr * h2.sigma_Rayl_coeff * nu0 ** 4

    rvrs, vrs = _h2_vs_lines(h2, mode)
    w_rvrs = np.zeros_like(nu_grid)
    w_vrs = np.zeros_like(nu_grid)
    sigma_tot = 0.0
    for dnu, sig in rvrs:
        dnu, sig = _significant(dnu, sig)
        _deposit_lines(dnu, sig, nu0, nu_grid, w_rvrs)
        sigma_tot += h2.vmr * np.sum((nu0 + dnu) ** 4 * sig)
    for dnu, sig in vrs:
        dnu, sig = _significant(dnu, sig)
        _deposit_lines(dnu, sig, nu0, nu_grid, w_vrs)
        sigma_tot += h2.vmr * np.sum((nu0 + dnu) ** 4 * sig)
    w_rvrs[0] = w_vrs[0] = 0.0
    w_rvrs = h2.vmr * w_rvrs / sigma_rayl
    w_vrs = h2.vmr * w_vrs / sigma_rayl
    pi_cab_vs = sigma_rayl / (sigma_tot + sigma_rayl)

    nu_scatt = 0.5 * (nu_grid[1] + nu_grid[-1]) if len(nu_grid) > 2 \
        else nu_grid[-1]
    h2s = get_raman_solar_constants(float(nu_scatt), T, vmr_h2)
    k = (h2s.vmr * h2s.sigma_Rayl_coeff * nu_scatt ** 4) / sigma_rayl
    return w_rvrs, w_vrs, pi_cab_vs, float(k)


def sol_vs_plus_grid(lambda_inc_nm: float, mode: str = "sol_VS_0to1",
                     dnu: float = 0.3, pad: float = 2.0,
                     T: float = 273.0, vmr_h2: float = 0.91) -> np.ndarray:
    """Concatenated two-band grid of the ``_plus`` stellar VS variants:
    band 1 = the single incident wavenumber, band 2 = the VS-shifted output
    band spanning [min line shift - pad, max line shift + pad]
    (getRamanSSProp! sol_VS_*to*_plus, raman_stellar_prop.jl:106-233:
    grid_in = [nu_inc:nu_inc, band_min:0.3:band_max]).

    The concatenated axis IS the reference's bandSpecLim layout flattened:
    point 0 is band 1 (the incident), points 1..end are band 2 — which is
    exactly the fixed-source-at-0 convention of the VS solver path.
    """
    nu_inc = 1e7 / lambda_inc_nm
    h2 = get_raman_solar_constants(nu_inc, T, vmr_h2)
    rvrs, _ = _h2_vs_lines(h2, mode)
    shifts = np.concatenate([_significant(d, s)[0] for d, s in rvrs])
    band_min = nu_inc + shifts.min() - pad
    band_max = nu_inc + shifts.max() + pad
    band2 = np.arange(band_min, band_max + dnu / 2, dnu)
    return np.concatenate([[nu_inc], band2])


def sol_rrs_setup(model, i_band: int = 0, T: float = 273.0,
                  vmr_h2: float = 0.91, device=None):
    """Setup of the sol_RRS solve, as ``core.inelastic.inelastic_setup``
    sets up RRS: (inputs, config, shifts, w_shifts, Z_r_pp, Z_r_mp,
    fscatt) with the H2 shifts and weights, the stellar Raman phase
    matrices and the H2 fraction of layer scattering, tensors on
    ``device`` as float64."""
    from ..core.inelastic import (raman_z_stack, rayleigh_fraction,
                                  refuse_thermal)
    from ..core.types import resolve_device, rrs_setup_from_numpy
    dev = resolve_device(device)
    band = model.bands[i_band]
    refuse_thermal(band)
    inputs, config = model.build_band(i_band, device=dev, rrs=True)
    shifts, w, _ = sol_rrs_redistribution(band.nu_grid, T, vmr_h2)
    if len(shifts) == 0:
        raise ValueError("grid too narrow/coarse for any H2 rotational-"
                         "Raman shift (H2 lines span ~ +-1800 cm^-1 "
                         "with ~350 cm^-1 spacing)")
    return (inputs, config, *rrs_setup_from_numpy(
        shifts, w, *raman_z_stack(model, config, greek_raman_stellar()),
        rayleigh_fraction(band), dev))


def rt_run_stellar(model, i_band: int = 0, mode: str = "sol_RRS",
                   T: float = 273.0, vmr_h2: float = 0.91, device=None):
    """Stellar-Raman forward run (reference rt_run(sol_RS_type, model)).

    mode="sol_RRS": rotational Raman on a uniform H2-atmosphere band
    (``sol_rrs_setup``), by ``core.inelastic.solve_rrs_route`` (the kernel
    path K1 + K3 for an f32 model on CUDA, at full ie-ladder resolution;
    the plain path otherwise). mode="sol_VS_0to1"/"sol_VS_1to0":
    vibrational Raman, two plain fixed-source passes (O/S branches, then
    the Q branch) on any device; the band grid's FIRST point must be the
    incident wavelength (build with ``sol_vs_plus_grid``, the ``_plus``
    concatenated layout).

    The stellar irradiance spectrum enters through the band's ``f0_spec``
    (stellar_types.jl F0 field). Runs on CUDA unless ``device`` is given.
    Returns numpy (R, T, ieR, ieT), each (nVZA, n_stokes, nSpec); total
    radiance = R + ieR.
    """
    from ..core.inelastic import (_src_fixed0, raman_z_stack,
                                  rayleigh_fraction, refuse_thermal,
                                  rt_solve_rrs, solve_rrs_route)
    from ..core.types import resolve_device, rrs_setup_from_numpy

    if mode not in ("sol_RRS", "sol_VS_0to1", "sol_VS_1to0"):
        raise ValueError(f"unknown stellar mode {mode!r}")
    dev = resolve_device(device)

    def keys(out):
        return tuple(out[k].cpu().numpy() for k in ("R", "T", "ieR", "ieT"))

    if mode == "sol_RRS":
        inputs, config, *rrs = sol_rrs_setup(model, i_band, T, vmr_h2, dev)
        return keys(solve_rrs_route(model, inputs, config, rrs, dev,
                                    ie_fullres=True))

    band = model.bands[i_band]
    refuse_thermal(band)
    inputs, config = model.build_band(i_band, device=dev, rrs=True)
    fscatt = rayleigh_fraction(band)          # H2 fraction of scattering
    h2 = get_raman_solar_constants(float(band.nu_grid[0]), T, vmr_h2)
    w_rvrs, w_vrs, _, _ = sol_vs_redistribution(band.nu_grid, mode, T,
                                                vmr_h2)
    if not (np.any(w_rvrs > 0) or np.any(w_vrs > 0)):
        raise ValueError(f"no H2 {mode} line lands on the scattered band; "
                         "build the grid with sol_vs_plus_grid")
    # Two Raman channels, distinct phase matrices, summed ie output
    # (first-order transport — see module docstring).
    R = Tt = ieR = ieT = None
    for w_t, greek in ((w_rvrs, greek_raman_stellar()),
                       (w_vrs, greek_raman_stellar_vs(h2))):
        rrs = rrs_setup_from_numpy(
            (0,), w_t[None, :], *raman_z_stack(model, config, greek),
            fscatt, dev)
        out = keys(rt_solve_rrs(inputs, config, *rrs, dev,
                                src_fn=_src_fixed0))
        if R is None:
            R, Tt, ieR, ieT = out
        else:
            ieR, ieT = ieR + out[2], ieT + out[3]
    return R, Tt, ieR, ieT
