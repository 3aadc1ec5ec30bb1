"""HITRAN line-list parsing, isotopologue metadata and TIPS partition sums.

Counterpart of the JAX package's ``absorption/hitran.py``. The two public
tables it reads from NetCDF files (HITRAN isotopologue metadata and the
TIPS-2017 total internal partition sums) are read here from the port's own
copy, ``vsmartmom_tpu_torch/data/hitran_tables.npz``: iso_info's
``molecule``, ``isotope``, ``mol_weight``, ``abundance`` and ``mol_name``
(a unicode array), and ``TIPS_2017_T`` / ``TIPS_2017_Q`` (nT, iso, mol)
float32. No HDF5 reader is needed. The interpolation is the JAX one.
"""

from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np

TABLES_PATH = Path(__file__).resolve().parents[1] / "data" / \
    "hitran_tables.npz"

# HITRAN 160-character .par record layout (read_hitran.jl:40-44)
_PAR_FIELDS = [
    ("mol", 2, int), ("iso", 1, int), ("nu", 12, float), ("sw", 10, float),
    ("a", 10, float), ("gamma_air", 5, float), ("gamma_self", 5, float),
    ("elower", 10, float), ("n_air", 4, float), ("delta_air", 8, float),
    ("global_upper_quanta", 15, str), ("global_lower_quanta", 15, str),
    ("local_upper_quanta", 15, str), ("local_lower_quanta", 15, str),
    ("ierr", 6, str), ("iref", 12, str), ("line_mixing_flag", 1, str),
    ("gp", 7, float), ("gpp", 7, float),
]
#: HitranTable's columns, in the order of the record's first ten fields.
COLUMNS = ("mol", "iso", "nu", "sw", "gamma_air", "gamma_self", "e_lower",
           "n_air", "delta_air")


@dataclass
class HitranTable:
    """Column-vector line list (reference Absorption/types.jl:24-63)."""
    mol: np.ndarray
    iso: np.ndarray
    nu: np.ndarray          # line position [cm^-1]
    sw: np.ndarray          # intensity at 296 K [cm^-1/(molec cm^-2)]
    gamma_air: np.ndarray   # air-broadened HWHM [cm^-1/atm]
    gamma_self: np.ndarray
    e_lower: np.ndarray     # lower-state energy [cm^-1]
    n_air: np.ndarray       # T exponent of gamma_air
    delta_air: np.ndarray   # pressure shift [cm^-1/atm]

    def __len__(self):
        return len(self.nu)


def hitran_table_from_numpy(fields) -> HitranTable:
    """``HitranTable`` from a dict of arrays or any object with the
    columns as attributes (e.g. the JAX package's line table), copied."""
    get = fields.get if isinstance(fields, dict) else \
        (lambda k: getattr(fields, k))
    return HitranTable(**{
        k: np.array(get(k), dtype=np.int32 if k in ("mol", "iso")
                    else np.float64) for k in COLUMNS})


def read_hitran(path: str, mol: int = -1, iso: int = -1,
                nu_min: float = 0.0, nu_max: float = np.inf,
                min_strength: float = 0.0) -> HitranTable:
    """Parse a fixed-width HITRAN .par file with optional filters."""
    cols = {name: [] for name, _, _ in _PAR_FIELDS[:10]}
    starts = np.cumsum([0] + [w for _, w, _ in _PAR_FIELDS])
    with open(path) as f:
        for line in f:
            try:
                m = int(line[0:2])
                i = int(line[2:3])
                nu = float(line[3:15])
                s = float(line[15:25])
            except ValueError:
                continue
            if mol != -1 and m != mol:
                continue
            if iso != -1 and i != iso:
                continue
            if not (nu_min <= nu <= nu_max) or s < min_strength:
                continue
            vals = [m, i, nu, s]
            for k in range(4, 10):
                _, _, typ = _PAR_FIELDS[k]
                raw = line[starts[k]:starts[k + 1]]
                try:
                    vals.append(typ(raw))
                except ValueError:
                    vals.append(typ(0))
            for (name, _, _), v in zip(_PAR_FIELDS[:10], vals):
                cols[name].append(v)
    if not cols["nu"]:
        raise ValueError(f"No HITRAN lines matched filters in {path}")
    return HitranTable(
        mol=np.asarray(cols["mol"], dtype=np.int32),
        iso=np.asarray(cols["iso"], dtype=np.int32),
        nu=np.asarray(cols["nu"]),
        sw=np.asarray(cols["sw"]),
        gamma_air=np.asarray(cols["gamma_air"]),
        gamma_self=np.asarray(cols["gamma_self"]),
        e_lower=np.asarray(cols["elower"]),
        n_air=np.asarray(cols["n_air"]),
        delta_air=np.asarray(cols["delta_air"]))


@lru_cache(maxsize=1)
def tables() -> dict:
    """The iso_info and TIPS-2017 arrays of ``hitran_tables.npz``."""
    with np.load(TABLES_PATH, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def mol_weight(mol: int, iso: int) -> float:
    """Molar mass [kg/mol] for HITRAN (molecule, isotopologue) ids."""
    w = tables()["mol_weight"][iso - 1, mol - 1]
    if w < 0:
        raise KeyError(f"no isotopologue (mol={mol}, iso={iso})")
    return float(w)


def mol_weights(mol, iso) -> np.ndarray:
    """``mol_weight`` of every (mol, iso) pair of two id arrays, as one
    table gather (float64)."""
    w = tables()["mol_weight"][np.asarray(iso) - 1,
                               np.asarray(mol) - 1].astype(np.float64)
    if (w < 0).any():
        j = int(np.argmax(w < 0))
        raise KeyError(f"no isotopologue (mol={int(np.asarray(mol)[j])}, "
                       f"iso={int(np.asarray(iso)[j])})")
    return w


def mol_number(name: str) -> int:
    """HITRAN molecule id from name (e.g. 'O2' -> 7)."""
    t = tables()
    hits = np.flatnonzero(t["mol_name"][0] == name)
    if not hits.size:
        raise KeyError(f"unknown molecule {name!r}")
    return int(t["molecule"][hits[0]])


@lru_cache(maxsize=512)
def _tips_for(mol: int, iso: int):
    t = tables()["TIPS_2017_T"][:, iso - 1, mol - 1]
    q = tables()["TIPS_2017_Q"][:, iso - 1, mol - 1]
    valid = t != -1
    if not valid.any():
        raise KeyError(f"no TIPS data for (mol={mol}, iso={iso})")
    return t[valid].astype(np.float64), q[valid].astype(np.float64)


def qoft(mol: int, iso: int, T: float, T_ref: float = 296.0) -> float:
    """Partition-sum ratio Q(T_ref)/Q(T) by linear interpolation in the
    TIPS-2017 tables (TIPS_2017.jl qoft!)."""
    tt, qq = _tips_for(mol, iso)
    q_t = np.interp(T, tt, qq)
    q_ref = np.interp(T_ref, tt, qq)
    return float(q_ref / q_t)


def qoft_ratios(mol, iso, T, T_ref: float = 296.0) -> np.ndarray:
    """(len(T), n_lines) ``qoft`` of every line's (mol, iso) at each
    temperature of ``T``: one interpolation per isotopologue and
    temperature, gathered to the lines."""
    pairs, inv = np.unique(np.stack([np.asarray(mol), np.asarray(iso)], 1),
                           axis=0, return_inverse=True)
    T = np.atleast_1d(np.asarray(T, dtype=np.float64))
    per_pair = np.array([[qoft(int(m), int(i), t, T_ref) for m, i in pairs]
                         for t in T]).reshape(len(T), len(pairs))
    return per_pair[:, np.ravel(inv)]
