"""Aerosol bulk optical properties and conversion to RT model inputs.

Counterpart of the JAX package's ``aerosols/optics.py`` (host f64 NumPy on
the port's ``scattering.mie``). Behavioral reference: vSmartMOM.jl
src/Aerosols/optical_properties.jl (compute_optical_properties for
TOMAS-15 and two-moment, compute_mie_efficiencies). Where the reference
uses anomalous-diffraction approximations for the Mie efficiencies
(optical_properties.jl:225-255, marked as placeholder), the exact
Lorenz-Mie series is evaluated through the a_n/b_n recursion of
``scattering.mie``.
"""

import numpy as np

from ..scattering.mie import compute_mie_ab, get_n_max
from .refractive import RefractiveIndexDatabase, get_refractive_index
from .schemes import (AerosolData, TOMAS15Scheme, TwoMomentScheme,
                      median_radius_from_effective, scale_aod_wavelength)


def compute_mie_efficiencies(x: float, m: complex):
    """Exact (Q_ext, Q_sca, Q_abs, g) from the Lorenz-Mie series
    (Bohren & Huffman 1983 Eqs. 4.61-4.62; replaces the reference's
    approximation, optical_properties.jl:225-255)."""
    if x <= 0:
        return 0.0, 0.0, 0.0, 0.0
    n_max = get_n_max(x)
    an, bn = compute_mie_ab(np.array([x]), m, n_max)
    an, bn = an[0], bn[0]
    n = np.arange(1, n_max + 1)
    c = 2 * n + 1
    q_ext = (2.0 / x ** 2) * np.sum(c * (an.real + bn.real))
    q_sca = (2.0 / x ** 2) * np.sum(c * (np.abs(an) ** 2 + np.abs(bn) ** 2))
    # asymmetry parameter (B&H Eq. 4.63)
    a1, b1 = an[:-1], bn[:-1]
    a2, b2 = an[1:], bn[1:]
    nn = n[:-1]
    t1 = nn * (nn + 2) / (nn + 1) * (a1 * np.conj(a2)
                                     + b1 * np.conj(b2)).real
    t2 = c[:-1] / (nn * (nn + 1)) * (a1 * np.conj(b1)).real
    t2_last = c[-1] / (n[-1] * (n[-1] + 1)) * (an[-1]
                                               * np.conj(bn[-1])).real
    g_num = (4.0 / x ** 2) * (np.sum(t1) + np.sum(t2) + t2_last)
    g = g_num / q_sca if q_sca > 0 else 0.0
    return float(q_ext), float(q_sca), float(q_ext - q_sca), float(g)


def compute_optical_properties(data: AerosolData, wavelengths,
                               ri_db: RefractiveIndexDatabase) -> dict:
    """Bulk extinction/scattering/absorption/SSA/g per (level, wavelength)
    (optical_properties.jl:37-221). TOMAS-15: exact per-bin Mie with the
    species particle-number columns; two-moment: Angstrom-scaled AOD with
    lognormal-median Mie for SSA/g."""
    if isinstance(data.scheme, TOMAS15Scheme):
        return _tomas_optics(data, wavelengths, ri_db)
    if isinstance(data.scheme, TwoMomentScheme):
        return _two_moment_optics(data, wavelengths, ri_db)
    raise TypeError(f"unsupported scheme {type(data.scheme).__name__}")


def _tomas_optics(data, wavelengths, ri_db):
    scheme = data.scheme
    first = next(v for k, v in data.species_data.items()
                 if not k.startswith("_"))
    n_lev = first.data["particle_number"].shape[1]
    n_lam = len(wavelengths)
    ext = np.zeros((n_lev, n_lam))
    sca = np.zeros((n_lev, n_lam))
    g_acc = np.zeros((n_lev, n_lam))
    for il, lam in enumerate(wavelengths):
        for sp in scheme.species:
            num = data.species_data[sp].data["particle_number"]  # (bins,lev)
            m = get_refractive_index(
                ri_db, scheme.refractive_indices[sp], lam)
            for b in range(scheme.n_bins):
                r_um = scheme.bin_centers[b] / 2000.0
                x = 2 * np.pi * r_um / lam
                qe, qs, _, g = compute_mie_efficiencies(x, m)
                sig_geom_m2 = np.pi * (r_um * 1e-6) ** 2
                n_m3 = num[b] * 1e6                      # #/cm^3 -> #/m^3
                ext[:, il] += n_m3 * qe * sig_geom_m2 * 1e3   # 1/km
                sca[:, il] += n_m3 * qs * sig_geom_m2 * 1e3
                g_acc[:, il] += n_m3 * qs * sig_geom_m2 * 1e3 * g
    ssa = np.clip(sca / np.where(ext > 0, ext, 1.0), 0.0, 1.0)
    g = g_acc / np.where(sca > 0, sca, 1.0)
    return {"extinction": ext, "scattering": sca, "absorption": ext - sca,
            "ssa": ssa, "asymmetry_parameter": g}


def _two_moment_optics(data, wavelengths, ri_db):
    scheme = data.scheme
    first = next(iter(data.species_data.values()))
    n_lev = len(first.data["aod"])
    n_lam = len(wavelengths)
    ext = np.zeros((n_lev, n_lam))
    sca = np.zeros((n_lev, n_lam))
    g_out = np.zeros((n_lev, n_lam))
    for il, lam in enumerate(wavelengths):
        for sp in scheme.species:
            d = data.species_data[sp].data
            aod = np.array([
                scale_aod_wavelength(a, scheme.aod_wavelength[sp], lam)
                for a in d["aod"]])
            m = get_refractive_index(
                ri_db, scheme.refractive_indices[sp], lam)
            # SSA/g at the lognormal median radius per level
            for lv in range(n_lev):
                r_med = median_radius_from_effective(
                    max(d["radius"][lv], 1e-6), scheme.sigma_g[sp])
                x = 2 * np.pi * r_med / lam
                qe, qs, _, g = compute_mie_efficiencies(x, m)
                w = qs / qe if qe > 0 else 0.0
                ext[lv, il] += aod[lv]
                sca[lv, il] += aod[lv] * w
                g_out[lv, il] += aod[lv] * w * g
    ssa = np.clip(sca / np.where(ext > 0, ext, 1.0), 0.0, 1.0)
    g = g_out / np.where(sca > 0, sca, 1.0)
    return {"extinction": ext, "scattering": sca, "absorption": ext - sca,
            "ssa": ssa, "asymmetry_parameter": g}


def to_rt_aerosols(data: AerosolData, ri_db: RefractiveIndexDatabase,
                   lam_ref_um: float = 0.55, p_full=None) -> list:
    """Convert two-moment AerosolData to RTAerosol inputs for
    model_from_parameters (the bridge the reference builds through
    RT_Aerosol construction in its GEOS-Chem examples).

    Each species becomes one RTAerosol with a lognormal size distribution
    (column-AOD-weighted effective radius), band refractive index at
    lam_ref_um, total column tau_ref, and a Gaussian-in-pressure vertical
    profile fit to the AOD profile (matching the RT model's aerosol
    vertical parameterization).

    ``p_full`` [hPa] are the levels' mid-pressures in the order of the
    AOD profile. Without it the ``lev`` coordinate stands in for them, as
    in the JAX package; in a GCHP file ``lev`` is a level index or a
    hybrid coefficient, not a pressure, so pass the column's pressures.
    """
    from ..core.model import RTAerosol

    if not isinstance(data.scheme, TwoMomentScheme):
        raise TypeError("to_rt_aerosols supports the two-moment scheme; "
                        "use TOMAS optics tables for size-resolved input")
    scheme = data.scheme
    n_lev = len(next(iter(data.species_data.values())).data["aod"])
    if p_full is None:
        p_full = np.asarray(data.coordinates.get(
            "lev", np.linspace(1.0, 1000.0, n_lev)), np.float64)
    out = []
    for sp in scheme.species:
        d = data.species_data[sp].data
        aod = np.asarray(d["aod"], np.float64)
        tau_tot = float(aod.sum())
        if tau_tot <= 0:
            continue
        w = aod / tau_tot
        r_eff = float(np.sum(w * d["radius"]))
        sigma_g = scheme.sigma_g[sp]
        m = get_refractive_index(ri_db, scheme.refractive_indices[sp],
                                 lam_ref_um)
        p0 = float(np.sum(w * p_full))
        sigma_p = float(np.sqrt(np.sum(w * (p_full - p0) ** 2)) + 1e-3)
        out.append(RTAerosol(
            tau_ref=tau_tot, p0=p0, sigma_p=sigma_p,
            mu_log=np.log(median_radius_from_effective(
                max(r_eff, 1e-4), sigma_g)),
            sigma_log=np.log(sigma_g), n_r=m.real, n_i=-m.imag))
    return out
