"""Wavelength-dependent refractive-index database.

Counterpart of the JAX package's ``aerosols/refractive.py``. Behavioral
reference: vSmartMOM.jl src/Aerosols/refractive_index.jl
(load_refractive_index_database, get_refractive_index). The default
database, ``vsmartmom_tpu_torch/data/refractive_indices.json``, holds the
JAX package's six species (published OPAC / Shettle-Fenn / Bond-Bergstrom
compilations) with the same numbers as JSON, so that it loads without
PyYAML; a user's YAML database still loads (``yaml`` is imported only for
a ``.yaml`` / ``.yml`` file).
"""

import json
import os
from dataclasses import dataclass
from typing import Dict

import numpy as np

DEFAULT_DB = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "data", "refractive_indices.json")


@dataclass
class RefractiveIndexLUT:
    species: str
    wavelengths: np.ndarray     # um
    n_real: np.ndarray
    n_imag: np.ndarray
    source: str = ""


@dataclass
class RefractiveIndexDatabase:
    data: Dict[str, RefractiveIndexLUT]

    def species(self):
        return sorted(self.data)


def _load_raw(path: str) -> dict:
    if os.path.splitext(path)[1].lower() in (".yaml", ".yml"):
        import yaml
        with open(path) as f:
            return yaml.safe_load(f)
    with open(path) as f:
        return json.load(f)


def load_refractive_index_database(path: str = None) -> \
        RefractiveIndexDatabase:
    """Load a JSON or YAML refractive-index database
    (refractive_index.jl:17-39). Accepts both the shipped schema
    (species/{lam,n,k}) and the reference's
    (refractive_indices/{wavelengths,n_real,n_imag})."""
    raw = _load_raw(path or DEFAULT_DB)
    entries = raw.get("species") or raw.get("refractive_indices") or {}
    luts = {}
    for key, e in entries.items():
        lam = np.asarray(e.get("lam", e.get("wavelengths")), np.float64)
        n = np.asarray(e.get("n", e.get("n_real")), np.float64)
        k = np.asarray(e.get("k", e.get("n_imag")), np.float64)
        if not (len(lam) == len(n) == len(k)):
            raise ValueError(f"refractive-index entry {key!r}: "
                             "inconsistent array lengths")
        luts[key] = RefractiveIndexLUT(
            key, lam, n, k, e.get("source", e.get("about", "")))
    return RefractiveIndexDatabase(luts)


def get_refractive_index(db: RefractiveIndexDatabase, species: str,
                         lam_um: float) -> complex:
    """Complex refractive index n - i*k at lam_um by linear interpolation
    (refractive_index.jl:42-95). Raises outside the tabulated range."""
    if species not in db.data:
        raise KeyError(f"species {species!r} not in database "
                       f"(available: {db.species()})")
    lut = db.data[species]
    if not (lut.wavelengths[0] <= lam_um <= lut.wavelengths[-1]):
        raise ValueError(
            f"wavelength {lam_um} um outside [{lut.wavelengths[0]}, "
            f"{lut.wavelengths[-1]}] um for species {species!r}")
    n = np.interp(lam_um, lut.wavelengths, lut.n_real)
    k = np.interp(lam_um, lut.wavelengths, lut.n_imag)
    return complex(n, -k)
