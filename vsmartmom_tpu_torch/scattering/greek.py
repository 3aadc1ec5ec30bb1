"""Greek (generalized spherical function) expansion coefficients.

Reference: vSmartMOM.jl src/Scattering/types.jl:368-381 (GreekCoefs) and
mie_helper_functions.jl:454-468 (get_greek_rayleigh).
"""

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class GreekCoefs:
    """Six coefficient vectors (alpha..zeta) over degree l = 0..l_max-1,
    Hovenier convention for the 4x4 polarized phase matrix."""

    alpha: np.ndarray
    beta: np.ndarray
    gamma: np.ndarray
    delta: np.ndarray
    epsilon: np.ndarray
    zeta: np.ndarray

    @property
    def l_max(self) -> int:
        return len(self.beta)

    def padded(self, l_max: int) -> "GreekCoefs":
        """Zero-pad every coefficient vector to length ``l_max``."""
        def pad(v):
            out = np.zeros(l_max)
            out[: len(v)] = v
            return out
        return GreekCoefs(*(pad(getattr(self, f)) for f in
                            ("alpha", "beta", "gamma", "delta", "epsilon", "zeta")))


def greek_rayleigh(depol: float) -> GreekCoefs:
    """Rayleigh Greek coefficients for depolarization factor ``depol``
    (reference: mie_helper_functions.jl:454-468)."""
    dpl_p = (1.0 - depol) / (1.0 + depol / 2.0)
    dpl_r = (1.0 - 2.0 * depol) / (1.0 - depol)
    return GreekCoefs(
        alpha=np.array([0.0, 0.0, 3.0 * dpl_p]),
        beta=np.array([1.0, 0.0, 0.5 * dpl_p]),
        gamma=np.array([0.0, 0.0, dpl_p * np.sqrt(1.5)]),
        delta=np.array([0.0, dpl_p * dpl_r * 1.5, 0.0]),
        epsilon=np.array([0.0, 0.0, 0.0]),
        zeta=np.array([0.0, 0.0, 0.0]),
    )
