"""GEOS-Chem NetCDF scene ingest.

Counterpart of the JAX package's ``io/geoschem.py``; Python counterpart of
the reference's IO/NetCDF/GeosChem.jl (geoschem_to_dict,
read_geoschem_profile): reads a GCHP cubed-sphere diagnostics file at one
grid column and converts it to the configuration dict consumed by
``parameters_from_dict``. Reads through ``aerosols.ncio.NCFile`` (scipy
NetCDF-3 / h5py NetCDF-4, no netCDF4 binding).

GCHP layout: variables are indexed (time, lev, nf, Ydim, Xdim) with lev
running BOA -> TOA; everything is flipped to the TOA -> BOA convention.

GCHP writes ``Met_SPHU`` in g/kg; the profile (``core.atmosphere``) takes
specific humidity in kg/kg, so the port divides by 1000. The JAX package
passes g/kg through, and its profile clips anything above 0.5 "kg/kg"
(ROADMAP.md section 3, faults on the reference side).
"""

from dataclasses import dataclass

import numpy as np

from ..aerosols.ncio import NCFile

#: Trace gases extracted when present (SpeciesConcVV_*), GeosChem.jl:83.
MOLECULES_TO_READ = ("N2O", "CH4", "C2H6", "CO2", "CO", "H2O")


@dataclass(frozen=True)
class GeosChemSource:
    """One grid column of a GCHP file: face ``idf``, position (idx, idy).

    Indices are 0-based (the reference's Julia API is 1-based:
    IO/Sources.jl:33-45)."""
    path: str
    idx: int
    idy: int
    idf: int = 0


def _column(var, src: GeosChemSource):
    """Extract the (lev,) column regardless of (time, lev, nf, Y, X) vs
    (X, Y, nf, lev, time) storage order (h5py stores C-order as written)."""
    a = np.asarray(var)
    if a.ndim == 5:
        # netCDF dimension order (time, lev, nf, Ydim, Xdim)
        return a[0, :, src.idf, src.idy, src.idx]
    if a.ndim == 4:          # no face dimension
        return a[0, :, src.idy, src.idx]
    raise ValueError(f"unexpected GCHP variable rank {a.ndim}")


def _scalar(var, src: GeosChemSource):
    a = np.asarray(var)
    if a.ndim == 4:
        return a[0, src.idf, src.idy, src.idx]
    if a.ndim == 3:
        return a[0, src.idy, src.idx]
    raise ValueError(f"unexpected GCHP variable rank {a.ndim}")


def geoschem_to_dict(src: GeosChemSource) -> dict:
    """Read one GCHP column -> config dict (atmospheric_profile +
    absorption sections), TOA -> BOA ordered (GeosChem.jl:49-124)."""
    nc = NCFile(src.path)
    try:
        dp = _column(nc.read("Met_DELP"), src)        # layer thickness [hPa]
        sp = _scalar(nc.read("Met_PS2WET"), src)      # surface pressure [hPa]
        # Half-level pressures BOA -> TOA, then flip to TOA -> BOA.
        p_half = np.concatenate([[sp], sp + np.cumsum(-dp)])[::-1].copy()
        T = _column(nc.read("Met_T"), src)[::-1].copy()
        # [g/kg] -> [kg/kg]
        q = _column(nc.read("Met_SPHU"), src)[::-1] / 1000.0

        vmr = {}
        for mol in MOLECULES_TO_READ:
            name = f"SpeciesConcVV_{mol}"
            if name in nc:
                vmr[mol] = np.asarray(
                    _column(nc.read(name), src)[::-1], dtype=np.float64)
    finally:
        nc.close()

    config = {
        "atmospheric_profile": {
            "T": np.asarray(T, dtype=np.float64),
            "p": np.asarray(p_half, dtype=np.float64),
            "q": np.asarray(q, dtype=np.float64),
            "profile_reduction": -1,
        },
    }
    if vmr:
        config["absorption_vmr"] = vmr
    return config


def read_geoschem_profile(src: GeosChemSource):
    """(T, p_half, q, vmr) column in TOA -> BOA order."""
    d = geoschem_to_dict(src)
    prof = d["atmospheric_profile"]
    return prof["T"], prof["p"], prof["q"], d.get("absorption_vmr", {})
