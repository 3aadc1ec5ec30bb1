"""Polarization (Stokes-vector) types.

Reference: vSmartMOM.jl src/Scattering/types.jl:129-197.
Each type carries the number of Stokes components ``n``, the D-matrix
diagonal used by the polarization symmetry relations (Sanghavi 2014,
Eqs. 29-32), and the incident (unpolarized) Stokes vector I0.
"""

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class Polarization:
    name: str
    n: int
    D: np.ndarray = field(repr=False)
    I0: np.ndarray = field(repr=False)


def _pol(name, d, i0):
    return Polarization(name=name, n=len(d),
                        D=np.asarray(d, dtype=np.float64),
                        I0=np.asarray(i0, dtype=np.float64))


STOKES_I = _pol("Stokes_I", [1.0], [1.0])
STOKES_IQ = _pol("Stokes_IQ", [1.0, 1.0], [1.0, 0.0])
STOKES_IQU = _pol("Stokes_IQU", [1.0, 1.0, -1.0], [1.0, 0.0, 0.0])
STOKES_IQUV = _pol("Stokes_IQUV", [1.0, 1.0, -1.0, -1.0], [1.0, 0.0, 0.0, 0.0])

BY_NAME = {p.name: p for p in (STOKES_I, STOKES_IQ, STOKES_IQU, STOKES_IQUV)}


def polarization_from_name(name: str) -> Polarization:
    """The Polarization of a scene file's ``polarization_type`` string
    (``"Stokes_IQU"`` or ``"Stokes_IQU()"``)."""
    key = name.strip().replace("()", "")
    if key not in BY_NAME:
        raise ValueError(f"Unknown polarization type {name!r}; "
                         f"choose from {sorted(BY_NAME)}")
    return BY_NAME[key]
