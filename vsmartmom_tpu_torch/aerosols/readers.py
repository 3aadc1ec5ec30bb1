"""GEOS-Chem aerosol ingest: TOMAS-15 and two-moment scheme readers.

Counterpart of the JAX package's ``aerosols/readers.py``. Behavioral
reference: vSmartMOM.jl src/Aerosols/readers.jl (read_aerosol_data,
extract_coordinates, aerosol_processing_options) and
schemes/{tomas15,two_moment}.jl (read_tomas15 l.72-345, read_two_moment
l.46-151). Fields are horizontally averaged (cubed-sphere faces + X/Y) to a
single column profile, with optional vertical flip so layers run TOA->BOA.
The port averages each field by its dimension names
(``ncio.horizontal_mean_profile``), so a GCHP collection in its own C
order, ``(time, lev, nf, Ydim, Xdim)``, reads as its level profile.
"""

import numpy as np

from .ncio import NCFile
from .schemes import (M_AIR, AerosolData, AerosolSpeciesData, TOMAS15Scheme,
                      TwoMomentScheme, bin_volume)


def aerosol_processing_options(config: dict) -> dict:
    return dict(config.get("processing", {}))


def _extract_coordinates(nc: NCFile, config: dict) -> dict:
    coords = {}
    for name in ("lon", "lat", "lev", "time"):
        if name in nc:
            coords[name] = nc.read(name)
    if "lev" not in coords:
        raise ValueError("no 'lev' coordinate in aerosol file")
    return coords


def _maybe_flip(arr: np.ndarray, flip: bool, axis: int = -1) -> np.ndarray:
    return np.flip(arr, axis=axis) if flip else arr


def read_tomas15(config: dict, path: str) -> AerosolData:
    """Read TOMAS-15 size-resolved aerosol from a GEOS-Chem SpeciesConc
    file (tomas15.jl:72-345).

    Number per bin: N [#/cm^3] = (NK/1000) (Met_AD/M_air) / (Met_AIRVOL 1e6);
    per-species mass [ug/m^3] from mol/mol via Met_AD/Met_AIRVOL; particle
    number per species from mass / (rho 4/3 pi r^3).
    """
    scheme = TOMAS15Scheme.from_config(config)
    opts = aerosol_processing_options(config)
    flip = bool(opts.get("vertical_flip", False))
    nk_tpl = (config["aerosol_scheme"].get("nk_variable")
              or "SpeciesConcVV_NK{bin:02d}")
    sp_tpl = (config["aerosol_scheme"].get("species_variable")
              or "SpeciesConcVV_{species}{bin}")

    with NCFile(path) as nc:
        coords = _extract_coordinates(nc, config)
        n_lev = len(coords["lev"])

        ad = nc.profile("Met_AD")              # kg
        airvol = nc.profile("Met_AIRVOL")      # m^3

        nk = np.zeros((scheme.n_bins, n_lev))
        for b in range(scheme.n_bins):
            var = nk_tpl.format(bin=b + 1)
            if var in nc:
                nk[b] = nc.profile(var)
        n_conc = (nk / 1000.0) * (ad / M_AIR) / (airvol * 1e6)     # #/cm^3

        dlogd = np.diff(np.log10(scheme.bin_edges))
        dn_dlogd = n_conc / dlogd[:, None]

        species_data = {}
        for sp in scheme.species:
            vmr = np.zeros((scheme.n_bins, n_lev))
            for b in range(scheme.n_bins):
                var = sp_tpl.format(species=sp, bin=b + 1)
                if var in nc:
                    vmr[b] = nc.profile(var)
            mw_ug = scheme.molar_masses[sp] * 1e9                  # ug/mol
            mass = vmr * (ad / M_AIR)[None, :] * mw_ug / airvol[None, :]
            rho = scheme.densities[sp]                             # kg/m^3
            # particle mass per bin [ug]: rho * V(cm^3) * 1e9
            v_cm3 = bin_volume(scheme.bin_centers) * 1e-21         # nm^3->cm^3
            m_part = rho * v_cm3 * 1e9
            part_num = np.where(m_part[:, None] > 0,
                                mass / m_part[:, None] * 1e-6, 0.0)
            species_data[sp] = AerosolSpeciesData(
                data={"concentration": _maybe_flip(vmr, flip),
                      "mass": _maybe_flip(mass, flip),
                      "particle_number": _maybe_flip(part_num, flip)},
                units={"concentration": "mol mol-1", "mass": "ug m-3",
                       "particle_number": "cm-3"},
                description=f"TOMAS-15 {sp}")

        species_data["_NK"] = AerosolSpeciesData(
            data={"number": _maybe_flip(n_conc, flip),
                  "dN_dlogD": _maybe_flip(dn_dlogd, flip)},
            units={"number": "cm-3", "dN_dlogD": "cm-3"},
            description="TOMAS-15 total particle number")
        meta = nc.attrs()
    return AerosolData(scheme, species_data, coords, meta)


def read_two_moment(config: dict, path: str) -> AerosolData:
    """Read bulk two-moment aerosol (per-species AOD + effective radius
    profiles) from a GEOS-Chem Aerosols collection (two_moment.jl:46-151)."""
    scheme = TwoMomentScheme.from_config(config)
    opts = aerosol_processing_options(config)
    flip = bool(opts.get("vertical_flip", False))
    sp_cfg = config["aerosol_scheme"]["species"]

    with NCFile(path) as nc:
        coords = _extract_coordinates(nc, config)
        n_lev = len(coords["lev"])
        species_data = {}
        for sp in scheme.species:
            aod_var = sp_cfg[sp]["aod_variable"].replace("{species}", sp)
            rad_var = sp_cfg[sp]["radius_variable"].replace("{species}", sp)
            aod = nc.profile(aod_var) if aod_var in nc else np.zeros(n_lev)
            radius = (nc.profile(rad_var) if rad_var in nc
                      else np.zeros(n_lev))
            species_data[sp] = AerosolSpeciesData(
                data={"aod": _maybe_flip(aod, flip, 0),
                      "radius": _maybe_flip(radius, flip, 0)},
                units={"aod": f"1 (at {scheme.aod_wavelength[sp]} um)",
                       "radius": "um"},
                description=f"two-moment {sp} (sigma_g="
                            f"{scheme.sigma_g[sp]})")
        meta = nc.attrs()
    return AerosolData(scheme, species_data, coords, meta)


def read_aerosol_data(config: dict, path: str) -> AerosolData:
    """Dispatch on config['aerosol_scheme']['type'] (readers.jl:51-72)."""
    kind = config["aerosol_scheme"]["type"].lower()
    if kind in ("tomas15", "tomas-15", "tomas"):
        return read_tomas15(config, path)
    if kind in ("two_moment", "two-moment", "twomoment"):
        return read_two_moment(config, path)
    raise ValueError(f"unknown aerosol scheme type {kind!r}")
