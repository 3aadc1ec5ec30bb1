"""Phase-matrix Fourier moments Z++(m), Z-+(m) on the stream cosines.

Z(mu, mu'; m) = sum_l Pi_l(m, mu) B_l Pi_l(m, mu')   (Hovenier 2.66/2.69;
Sanghavi 2014 Eqs. 11, 15-16). Behavioral reference:
vSmartMOM.jl src/Scattering/compute_Z_matrices.jl:26-110 plus the
Pi/B-matrix constructors in mie_helper_functions.jl:532-607.

Host-side float64 NumPy, vectorized with einsum over (degree, angle) axes
instead of the reference's per-(l, i, j) loops. Output: two dense
(N, N) supermatrices with N = n_mu * n_stokes, ready to upload per
Fourier moment. Single-scattering albedo and tau are NOT folded in here.

The generalized spherical functions cost O(l_max^2) Python steps, which
dominates at a Mie aerosol's l_max of a few hundred; ``legendre_tables``
computes them once for every moment and component of a build, and
``compute_Z_moments`` reads them.
"""

import numpy as np

from .greek import GreekCoefs
from .legendre import compute_associated_legendre_PRT
from .stokes import Polarization


def _pi_tensor(pol: Polarization, P, R, T, m: int):
    """Stack the Pi_l(m) matrices for all angles/degrees.

    Returns array (n_mu, n_deg, ns, ns) where n_deg spans degrees 0..l_max-1
    (entries for l < m are zero by construction of P/R/T).
    """
    ns = pol.n
    nmu, lmax, _ = P.shape
    Pi = np.zeros((nmu, lmax, ns, ns))
    p = P[:, :, m]
    if ns == 1:
        Pi[:, :, 0, 0] = p
        return Pi
    r = R[:, :, m]
    t = T[:, :, m]
    Pi[:, :, 0, 0] = p
    Pi[:, :, 1, 1] = r
    if ns >= 3:
        Pi[:, :, 1, 2] = -t
        Pi[:, :, 2, 1] = -t
        Pi[:, :, 2, 2] = r
    if ns == 4:
        Pi[:, :, 3, 3] = p
    return Pi


def _b_tensor(pol: Polarization, greek: GreekCoefs):
    """Stack the B_l matrices (n_deg, ns, ns) from the Greek coefficients."""
    ns = pol.n
    ndeg = greek.l_max
    B = np.zeros((ndeg, ns, ns))
    B[:, 0, 0] = greek.beta
    if ns >= 2:
        B[:, 0, 1] = greek.gamma
        B[:, 1, 0] = greek.gamma
        B[:, 1, 1] = greek.alpha
    if ns >= 3:
        B[:, 2, 2] = greek.zeta
    if ns == 4:
        B[:, 2, 3] = greek.epsilon
        B[:, 3, 2] = -greek.epsilon
        B[:, 3, 3] = greek.delta
    return B


def legendre_tables(mu, l_max: int, n_orders: int):
    """P, R, T at ``mu`` and at ``-mu`` for degrees < l_max and orders
    < n_orders: what ``compute_Z_moments`` reads for any Greek expansion of
    at most l_max terms and any moment m < n_orders."""
    mu = np.asarray(mu, dtype=np.float64)
    return (compute_associated_legendre_PRT(mu, l_max, n_orders)
            + compute_associated_legendre_PRT(-mu, l_max, n_orders))


def compute_Z_moments(pol: Polarization, mu, greek: GreekCoefs, m: int,
                      tables):
    """Z++ and Z-+ Fourier-moment supermatrices for azimuth mode ``m``.

    ``mu`` must lie in (0, 1]; both matrices have shape
    (n_mu * n_stokes, n_mu * n_stokes), Stokes index fastest (matching the
    reference supermatrix layout with qp_mu_N blocks). ``tables`` is a
    ``legendre_tables(mu, L, n)`` result with L >= greek.l_max and n > m.
    """
    mu = np.asarray(mu, dtype=np.float64)
    if not np.all((mu > 0) & (mu <= 1)):
        raise ValueError("all mu must be in (0, 1]")
    l_max = greek.l_max
    if m >= l_max:
        n = len(mu) * pol.n
        return np.zeros((n, n)), np.zeros((n, n))

    fact = 0.5 if m == 0 else 1.0
    if tables[0].shape[1] < l_max or tables[0].shape[2] <= m:
        raise ValueError(f"Legendre tables of shape {tables[0].shape} do "
                         f"not cover l_max={l_max}, m={m}")
    P, R, T, Pm, Rm, Tm = (x[:, :l_max] for x in tables)

    Pi = _pi_tensor(pol, P, R, T, m)       # (nmu, ndeg, ns, ns)
    Pi_neg = _pi_tensor(pol, Pm, Rm, Tm, m)
    B = _b_tensor(pol, greek)              # (ndeg, ns, ns)

    # A(i, j)[a, e] = sum_d Pi_d(mu_i)[a, b] B_d[b, c] Pi_d(mu_j)[c, e]
    A_pp = np.einsum("idab,dbc,jdce->iaje", Pi, B, Pi, optimize=True)
    A_mp = np.einsum("idab,dbc,jdce->iaje", Pi, B, Pi_neg, optimize=True)

    nmu, ns = len(mu), pol.n
    n = nmu * ns
    Z_pp = (2.0 * fact) * A_pp.reshape(n, n)

    # Sign flip of the (I,Q)x(U,V) off-diagonal blocks for Z-+
    # (compute_Z_matrices.jl:96-105; equivalent to (A + DAD + AD - DA)/2).
    sign = np.ones((ns, ns))
    if ns >= 3:
        sign[:2, 2:] = -1.0
        sign[2:, :2] = -1.0
    Z_mp = (2.0 * fact) * (A_mp * sign[None, :, None, :]).reshape(n, n)
    return Z_pp, Z_mp
