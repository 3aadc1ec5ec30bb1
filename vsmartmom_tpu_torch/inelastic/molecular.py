"""N2/O2 molecular Raman/Rayleigh constants for air depolarization.

Computes, per wavelength, the effective polarizability, anisotropy,
rotational-Raman line strengths (Placzek theory), and from them the
Rayleigh/Cabannes depolarization factors and the Cabannes (elastic)
single-scattering fraction of air. These drive the "auto depol" path
(params.depol < 0) of the model build and the RRS redistribution weights;
the vibrational Q-branch and rovibrational O/S-branch lines (v 0<->1)
drive the vibrational-Raman setups (``vs_setup.py``, ``stellar.py``).

Behavioral references:
  vSmartMOM.jl src/Inelastic/src/molecular_constructors.jl:1-143
  vSmartMOM.jl src/Inelastic/src/inelastic_cross_section.jl:33-385
  vSmartMOM.jl src/Inelastic/inelastic_helper.jl:228-467

All CGS units (cm, erg): c = 2.998e10 cm/s, h = 6.626e-27 erg s,
k_B = 1.381e-16 erg/K, polarizabilities in cm^3.
"""

from dataclasses import dataclass, field

import numpy as np

C_CGS = 2.99792458e10        # speed of light [cm/s]
H_CGS = 6.62607015e-27       # Planck [erg s]
KB_CGS = 1.380649e-16        # Boltzmann [erg/K]

_RAYL_PREFACTOR = 128.0 * np.pi ** 5
_ROVIB_PREFACTOR = (256.0 / 27.0) * np.pi ** 5

JMAX = 30
VMAX = 2


@dataclass
class Molecule:
    """Diatomic molecule state for Placzek rotational-Raman computations."""

    name: str
    vmr: float
    # Polarizability tensor (Buldakov et al. 1996/1999)
    alpha00: float          # mean polarizability at T=0, freq ref [cm^3]
    alpha00_prime: float    # d(alpha)/dr scaled [cm^3]
    omega0: float           # reference frequency [Hz]
    alpha_b: float          # linear T coefficient [1/K]
    alpha_c: float          # quadratic T coefficient [1/K^2]
    gamma00: float          # anisotropy [cm^3]
    gamma00_prime: float
    Y: np.ndarray           # 5x5 Dunham coefficients [cm^-1]
    gs_odd: int             # nuclear spin multiplicity, odd J
    gs_even: int            # nuclear spin multiplicity, even J

    # Effective, computed fields
    alpha_bar: float = 0.0
    gamma_bar: float = 0.0
    alpha_prime: float = 0.0
    gamma_prime: float = 0.0
    gamma_C_Rayl: float = 0.0
    sigma_Rayl_coeff: float = 0.0
    E_vJ: np.ndarray = field(default=None, repr=False)
    # Rotational Raman lines (J -> J+-2), arrays over Ji = 0..JMAX
    sigma_RR_Jp2: np.ndarray = field(default=None, repr=False)
    sigma_RR_Jm2: np.ndarray = field(default=None, repr=False)
    dnu_RR_Jp2: np.ndarray = field(default=None, repr=False)
    dnu_RR_Jm2: np.ndarray = field(default=None, repr=False)
    # Vibrational Raman Q-branch lines v: 0<->1 per Ji
    # (compute_sigma_Rayl_VibRaman_coeff_hires!,
    # inelastic_cross_section.jl:84-153)
    sigma_VR_0to1: np.ndarray = field(default=None, repr=False)
    sigma_VR_1to0: np.ndarray = field(default=None, repr=False)
    dnu_VR_0to1: np.ndarray = field(default=None, repr=False)
    dnu_VR_1to0: np.ndarray = field(default=None, repr=False)
    # Rovibrational Raman O/S branches (J -> J+-2, v: 0<->1)
    # (compute_sigma_RoVibRaman_coeff!, inelastic_cross_section.jl:222-376)
    sigma_RVR_0to1_Jp2: np.ndarray = field(default=None, repr=False)
    sigma_RVR_0to1_Jm2: np.ndarray = field(default=None, repr=False)
    sigma_RVR_1to0_Jp2: np.ndarray = field(default=None, repr=False)
    sigma_RVR_1to0_Jm2: np.ndarray = field(default=None, repr=False)
    dnu_RVR_0to1_Jp2: np.ndarray = field(default=None, repr=False)
    dnu_RVR_0to1_Jm2: np.ndarray = field(default=None, repr=False)
    dnu_RVR_1to0_Jp2: np.ndarray = field(default=None, repr=False)
    dnu_RVR_1to0_Jm2: np.ndarray = field(default=None, repr=False)


def _n2(vmr=0.8) -> Molecule:
    Y = np.zeros((5, 5))
    Y[0, 1] = 1.99824       # B_e
    Y[0, 2] = -5.76e-6      # -D_e
    Y[1, 0] = 2358.57       # omega_e
    Y[1, 1] = -0.017318     # -alpha_e
    Y[2, 0] = -14.324       # -omega_e x_e
    Y[3, 0] = -2.26e-3
    return Molecule("N2", vmr, alpha00=1.7406e-24, alpha00_prime=1.86e-24,
                    omega0=2.6049e16, alpha_b=1.8e-6, alpha_c=0.0,
                    gamma00=0.71e-24, gamma00_prime=2.23e-24,
                    Y=Y, gs_odd=3, gs_even=6)


def _o2(vmr=0.2) -> Molecule:
    Y = np.zeros((5, 5))
    Y[0, 1] = 1.4376766
    Y[0, 2] = -4.839e-6
    Y[1, 0] = 1580.19
    Y[1, 1] = -0.01590
    Y[2, 0] = -11.98
    return Molecule("O2", vmr, alpha00=1.5658e-24, alpha00_prime=1.76e-24,
                    omega0=2.1801e16, alpha_b=-2.369e-6, alpha_c=8.687e-9,
                    gamma00=1.080e-24, gamma00_prime=3.19e-24,
                    Y=Y, gs_odd=1, gs_even=0)


def _energy_levels(Y, vmax=VMAX, jmax=JMAX):
    """Dunham expansion E(v, J) = sum_{k,l} Y[k,l] (v+1/2)^k [J(J+1)]^l [cm^-1]
    (inelastic_cross_section.jl:162-182)."""
    v = np.arange(vmax + 1)[:, None]
    J = np.arange(jmax + 1)[None, :]
    E = np.zeros((vmax + 1, jmax + 1))
    JJ1 = (J * (J + 1)).astype(np.float64)
    vh = v + 0.5
    for l in range(5):
        for k in range(5):
            E += (vh ** k) * (JJ1 ** l) * Y[k, l]
    return E


def compute_molecular_constants(nu_eff: float, T: float, mol: Molecule) -> Molecule:
    """Fill the effective coefficients of ``mol`` at wavenumber nu_eff [cm^-1]
    and temperature T [K]."""
    # Effective polarizability with frequency + temperature corrections
    # (inelastic_cross_section.jl:44-48; Buldakov 1996 Eqs. 36a-39b).
    mol.alpha_bar = (mol.alpha00 * (1 + mol.alpha_b * T + mol.alpha_c * T ** 2)
                     / (1 - (C_CGS * nu_eff / mol.omega0) ** 2))
    mol.gamma_bar = mol.gamma00
    mol.alpha_prime = mol.alpha00_prime * np.sqrt(mol.Y[0, 1] / mol.Y[1, 0])
    mol.gamma_prime = mol.gamma00_prime * np.sqrt(mol.Y[0, 1] / mol.Y[1, 0])
    eps = mol.alpha_bar / mol.gamma_bar
    mol.gamma_C_Rayl = 3.0 / (45.0 * eps ** 2 + 4.0)

    # Rayleigh cross-section prefactor (x nu^4 later), Cabannes+RRS total
    # (inelastic_cross_section.jl:69-75).
    g = mol.gamma_C_Rayl
    mol.sigma_Rayl_coeff = (_RAYL_PREFACTOR * mol.alpha_bar ** 2
                            * (1 + 2 * g) / (3 - 4 * g))

    mol.E_vJ = _energy_levels(mol.Y)

    # Rotational Raman line strengths J -> J+-2 with Placzek b-factors and
    # Boltzmann populations (inelastic_cross_section.jl:222-376).
    Ji = np.arange(JMAX + 1)
    gN = np.where(Ji % 2 == 1, mol.gs_odd, mol.gs_even).astype(np.float64)
    boltz0 = np.exp(-H_CGS * C_CGS * mol.E_vJ[0, :] / (KB_CGS * T))
    boltz1 = np.exp(-H_CGS * C_CGS * mol.E_vJ[1, :] / (KB_CGS * T))
    Z_pf = np.sum(gN * (2 * Ji + 1) * (boltz0 + boltz1))

    with np.errstate(divide="ignore", invalid="ignore"):
        b_Jm2 = 3.0 * Ji * (Ji - 1) / (2.0 * (2 * Ji + 1) * (2 * Ji - 1))
        b_Jp2 = 3.0 * (Ji + 1) * (Ji + 2) / (2.0 * (2 * Ji + 1) * (2 * Ji + 3))
    b_Jm2 = np.where(Ji >= 2, b_Jm2, 0.0)

    base = _ROVIB_PREFACTOR * gN * (2 * Ji + 1) * boltz0 * mol.gamma_bar ** 2 / Z_pf
    mol.sigma_RR_Jm2 = np.where(Ji >= 2, base * b_Jm2, 0.0)
    mol.sigma_RR_Jp2 = np.where(Ji + 2 <= JMAX, base * b_Jp2, 0.0)

    E0 = mol.E_vJ[0, :]
    dnu_m2 = np.zeros(JMAX + 1)
    dnu_m2[2:] = -(E0[:-2] - E0[2:])     # scattered-light shift for J -> J-2
    dnu_p2 = np.zeros(JMAX + 1)
    dnu_p2[:-2] = -(E0[2:] - E0[:-2])    # J -> J+2 (Stokes, negative shift)
    mol.dnu_RR_Jm2 = np.where(Ji >= 2, dnu_m2, 0.0)
    mol.dnu_RR_Jp2 = np.where(Ji + 2 <= JMAX, dnu_p2, 0.0)

    # --- Vibrational Raman v: 0<->1 ---------------------------------------
    # Q-branch (Delta J = 0) lines with the polarizability-derivative
    # anisotropy ratio (compute_sigma_Rayl_VibRaman_coeff_hires!,
    # inelastic_cross_section.jl:84-153): per-line gamma_C from
    # 3/(4 + 45 (alpha'/(b_JJ gamma'))^2).
    E1 = mol.E_vJ[1, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        b_JJ = Ji * (Ji + 1) / ((2 * Ji - 1.0) * (2 * Ji + 3.0))
        # Ji = 0: b_JJ = 0 -> gamma_C -> 3/(4+inf) = 0 (isotropic Q line)
        gamma_C_vib = 3.0 / (4.0 + 45.0 * (mol.alpha_prime
                                           / (b_JJ * mol.gamma_prime)) ** 2)
    pol_fac = (1.0 + 2.0 * gamma_C_vib) / (3.0 - 4.0 * gamma_C_vib)
    kv = _RAYL_PREFACTOR * mol.alpha_prime ** 2
    mol.sigma_VR_0to1 = kv * gN * (2 * Ji + 1) * boltz0 * pol_fac / Z_pf
    mol.sigma_VR_1to0 = kv * gN * (2 * Ji + 1) * boltz1 * pol_fac / Z_pf
    mol.dnu_VR_0to1 = -(E1 - E0)           # Stokes: scattered nu decreases
    mol.dnu_VR_1to0 = -(E0 - E1)           # anti-Stokes

    # O/S branches (Delta J = +-2) with gamma_prime^2 and Placzek b-factors
    # (compute_sigma_RoVibRaman_coeff!, inelastic_cross_section.jl:222-376).
    base_rv0 = (_ROVIB_PREFACTOR * gN * (2 * Ji + 1) * boltz0
                * mol.gamma_prime ** 2 / Z_pf)
    base_rv1 = (_ROVIB_PREFACTOR * gN * (2 * Ji + 1) * boltz1
                * mol.gamma_prime ** 2 / Z_pf)
    mol.sigma_RVR_0to1_Jm2 = np.where(Ji >= 2, base_rv0 * b_Jm2, 0.0)
    mol.sigma_RVR_0to1_Jp2 = np.where(Ji + 2 <= JMAX, base_rv0 * b_Jp2, 0.0)
    mol.sigma_RVR_1to0_Jm2 = np.where(Ji >= 2, base_rv1 * b_Jm2, 0.0)
    mol.sigma_RVR_1to0_Jp2 = np.where(Ji + 2 <= JMAX, base_rv1 * b_Jp2, 0.0)

    def _dnu(vf_E, vi_E, dJ):
        out = np.zeros(JMAX + 1)
        if dJ == -2:
            out[2:] = -(vf_E[:-2] - vi_E[2:])
        else:
            out[:-2] = -(vf_E[2:] - vi_E[:-2])
        return out

    mol.dnu_RVR_0to1_Jm2 = np.where(Ji >= 2, _dnu(E1, E0, -2), 0.0)
    mol.dnu_RVR_0to1_Jp2 = np.where(Ji + 2 <= JMAX, _dnu(E1, E0, +2), 0.0)
    mol.dnu_RVR_1to0_Jm2 = np.where(Ji >= 2, _dnu(E0, E1, -2), 0.0)
    mol.dnu_RVR_1to0_Jp2 = np.where(Ji + 2 <= JMAX, _dnu(E0, E1, +2), 0.0)
    return mol


def get_raman_atmo_constants(nu_eff: float, T: float = 300.0,
                             vmr_n2: float = 0.8, vmr_o2: float = 0.2):
    """N2 and O2 constants at effective wavenumber nu_eff [cm^-1]
    (inelastic_helper.jl:28-47)."""
    n2 = compute_molecular_constants(nu_eff, T, _n2(vmr_n2))
    o2 = compute_molecular_constants(nu_eff, T, _o2(vmr_o2))
    return n2, o2


def _sigma_rrs(nu0: float, mol: Molecule) -> float:
    """Total rotational-Raman cross section at incident wavenumber nu0 with
    per-line (nu0 + dnu)^4 frequency weighting."""
    return (np.sum((nu0 + mol.dnu_RR_Jp2) ** 4 * mol.sigma_RR_Jp2)
            + np.sum((nu0 + mol.dnu_RR_Jm2) ** 4 * mol.sigma_RR_Jm2))


def pi_cabannes_mol(lambda0_nm: float, mol: Molecule) -> float:
    """Elastic (Cabannes) fraction of a single molecule's Rayleigh scattering
    (inelastic_helper.jl:298-322)."""
    nu0 = 1e7 / lambda0_nm
    sigma_rayl = mol.sigma_Rayl_coeff * nu0 ** 4
    return 1.0 - _sigma_rrs(nu0, mol) / sigma_rayl


def pi_cabannes_air(lambda0_nm: float, n2: Molecule, o2: Molecule) -> float:
    """Elastic (Cabannes) fraction of air Rayleigh scattering
    (inelastic_helper.jl:228-260)."""
    nu0 = 1e7 / lambda0_nm
    sigma_rayl = (n2.vmr * n2.sigma_Rayl_coeff + o2.vmr * o2.sigma_Rayl_coeff) * nu0 ** 4
    sigma_rrs = n2.vmr * _sigma_rrs(nu0, n2) + o2.vmr * _sigma_rrs(nu0, o2)
    return 1.0 - sigma_rrs / sigma_rayl


def gamma_mol_cabannes(lambda0_nm: float, mol: Molecule) -> float:
    """Cabannes-line Greek gamma for one molecule (inelastic_helper.jl:430-449)."""
    pi_cab = pi_cabannes_mol(lambda0_nm, mol)
    g_rayl = mol.gamma_C_Rayl
    tmp1 = 1 + 2 * g_rayl
    num = tmp1 * (2 + 3 * pi_cab) - 5
    den = tmp1 * (1 - pi_cab) + 5
    return 0.5 * num / den


def gamma_air_cabannes(lambda0_nm: float, n2: Molecule, o2: Molecule):
    """(gamma_air_Cabannes, pi_air_Cabannes) for the N2/O2 mixture
    (inelastic_helper.jl:384-406)."""
    out = []
    for mol in (n2, o2):
        g = gamma_mol_cabannes(lambda0_nm, mol)
        w = pi_cabannes_mol(lambda0_nm, mol)
        sig = w * mol.sigma_Rayl_coeff * (3 - 4 * g) / (1 + 2 * g)
        out.append((g, w, sig, mol.sigma_Rayl_coeff, mol.vmr))
    tmp1 = sum(s * v for (_, _, s, _, v) in out)
    tmp2 = sum(s * v * g / (3 - 4 * g) for (g, _, s, _, v) in out)
    gamma_air = 3.0 / (4.0 + tmp1 / tmp2)
    pi_air = (sum(w * s0 * v for (_, w, _, s0, v) in out)
              / sum(s0 * v for (_, _, _, s0, v) in out))
    return gamma_air, pi_air


def gamma_air_rayleigh(lambda0_nm: float, n2: Molecule, o2: Molecule):
    """(gamma_air_Rayleigh, sigma_air_Rayleigh [cm^2/molec]) for the mixture
    (inelastic_helper.jl:409-427)."""
    out = []
    for mol in (n2, o2):
        g = mol.gamma_C_Rayl
        sig = mol.sigma_Rayl_coeff * (3 - 4 * g) / (1 + 2 * g)
        out.append((g, sig, mol.sigma_Rayl_coeff, mol.vmr))
    tmp1 = sum(s * v for (_, s, _, v) in out)
    tmp2 = sum(s * v * g / (3 - 4 * g) for (g, s, _, v) in out)
    gamma_air = 3.0 / (4.0 + tmp1 / tmp2)
    nu0 = 1e7 / lambda0_nm
    sigma_air = (sum(s0 * v for (_, _, s0, v) in out) * nu0 ** 4
                 / sum(v for (_, _, _, v) in out))
    return gamma_air, sigma_air


def air_depolarization(nu_mean_cm1: float, T: float = 300.0):
    """Auto-depol rule of the model build (model_from_parameters.jl:280-297).

    Returns (depol_rayleigh, depol_cabannes, pi_cabannes) at band-mean
    wavenumber nu_mean_cm1, where depol = 2*gamma / (1 + gamma).
    """
    lambda_nm = 1e7 / nu_mean_cm1
    n2, o2 = get_raman_atmo_constants(nu_mean_cm1, T)
    pi_cab = pi_cabannes_air(lambda_nm, n2, o2)
    g_cab, _ = gamma_air_cabannes(lambda_nm, n2, o2)
    g_ray, _ = gamma_air_rayleigh(lambda_nm, n2, o2)
    depol_cab = 2 * g_cab / (1 + g_cab)
    depol_ray = 2 * g_ray / (1 + g_ray)
    return depol_ray, depol_cab, pi_cab
