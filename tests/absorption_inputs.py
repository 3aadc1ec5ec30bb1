"""Inputs shared by the port's absorption tests, made from numpy seeds:
the synthetic O2 A-band line list (``flagship.write_aband_par``), the JAX
package's synthetic 40-line .par (tests/test_absorption.py) with a second
isotopologue added, and the comparison they all use."""

import numpy as np
import pytest

from vsmartmom_tpu_torch.flagship import write_aband_par


def rel(a, b):
    """max|a - b| / max|b|, in float64."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def par(tmp_path_factory):
    """The synthetic A-band line list, written once for the module."""
    return write_aband_par(tmp_path_factory.mktemp("aband") / "o2.par")


@pytest.fixture(scope="module")
def o2_par(tmp_path_factory):
    """The JAX package's synthetic 40-line .par (tests/test_absorption.py),
    with a second isotopologue's lines added."""
    from test_absorption import _synthetic_par
    path = str(tmp_path_factory.mktemp("hitran") / "o2_synth.par")
    rng = np.random.default_rng(7)
    lines = []
    for k in range(40):
        nu = 13040.0 + 2.0 * k + rng.uniform(-0.5, 0.5)
        lines.append((7, 1 + k % 2, nu, 10 ** rng.uniform(-26, -24), 0.045,
                      0.05, 100.0 + 10 * k, 0.7, -0.008))
    _synthetic_par(path, lines)
    return path
