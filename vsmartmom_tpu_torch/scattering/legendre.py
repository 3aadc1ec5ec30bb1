"""Generalized spherical functions for the polarized phase matrix.

Host-side float64 NumPy implementations of the normalized associated
Legendre / generalized-spherical-function recursions used to build the
Pi-matrices of Sanghavi (2014, JQSRT 133:412-433, Eq. 15).

Behavioral reference: vSmartMOM.jl src/Scattering/legendre_functions.jl
(compute_associated_legendre_PRT, compute_legendre_poly); normalization
convention sqrt((l-m)!/(l+m)!) per de Rooij & Stap (1984) / Siewert.

These run once per model build over a handful of angles — vectorized over
the angle axis, plain Python loops over (l, m).
"""

import numpy as np


def compute_associated_legendre_PRT(mu, l_max: int, n_orders=None):
    """Normalized P_l^m, R_l^m, T_l^m on angle cosines ``mu``.

    Returns three arrays of shape (len(mu), l_max, n_orders) indexed
    ``[i_mu, l, m]`` (0-based degrees/orders, entries for l < m are zero);
    ``n_orders`` (default l_max) keeps the orders m < n_orders only. Each
    order's recursion runs over l alone, so the kept entries do not depend
    on ``n_orders``, nor an entry of degree l on ``l_max``. The third return
    is the "true" T (the recursion computes -T internally, mirroring
    legendre_functions.jl:183-184).
    """
    mu = np.asarray(mu, dtype=np.float64)
    nmu = len(mu)
    n_orders = l_max if n_orders is None else min(int(n_orders), l_max)
    P = np.zeros((nmu, l_max, n_orders))
    R = np.zeros((nmu, l_max, n_orders))
    T = np.zeros((nmu, l_max, n_orders))

    smu = np.sqrt(1.0 - mu ** 2)
    cmu = mu

    for m in range(n_orders):
        for l in range(m, l_max):
            if m == 0:
                if l == 0:
                    P[:, 0, 0] = 1.0
                elif l == 1:
                    P[:, 1, 0] = cmu
                elif l == 2:
                    P[:, 2, 0] = 0.5 * (3.0 * cmu ** 2 - 1.0)
                    R[:, 2, 0] = 0.5 * np.sqrt(1.5) * smu ** 2
                else:
                    P[:, l, 0] = (P[:, l - 1, 0] * (2 * l - 1) * cmu
                                  - P[:, l - 2, 0] * (l - 1)) / l
                    yr = np.sqrt((l + 1.0) * (l - 3.0))
                    xr = np.sqrt(l * l - 4.0)
                    R[:, l, 0] = (R[:, l - 1, 0] * (2 * l - 1) * cmu
                                  - R[:, l - 2, 0] * yr) / xr
            elif m == 1:
                if l == 1:
                    P[:, 1, 1] = np.sqrt(0.5) * smu
                elif l == 2:
                    m1 = np.sqrt(1.0 / 6.0)
                    cB = np.sqrt(1.5) * smu
                    P[:, 2, 1] = m1 * 3.0 * cmu * smu
                    R[:, 2, 1] = -m1 * cmu * cB
                    T[:, 2, 1] = m1 * cB
                else:
                    m1 = np.sqrt((l - 1.0) / (l + 1.0))
                    m2 = m1 * np.sqrt((l - 2.0) / l)
                    yp = l - 1 + m
                    xp = l - m
                    P[:, l, 1] = (m1 * P[:, l - 1, 1] * (2 * l - 1) * cmu
                                  - m2 * P[:, l - 2, 1] * yp) / xp
                    z = (2.0 * m * (2 * l - 1)) / (l * (l - 1.0))
                    y = ((l + m - 1.0) / (l - 1.0)) * np.sqrt((l - 3.0) * (l + 1.0))
                    x = ((l - m) / float(l)) * np.sqrt(l * l - 4.0)
                    R[:, l, 1] = (m1 * R[:, l - 1, 1] * (2 * l - 1) * cmu
                                  - m2 * R[:, l - 2, 1] * y
                                  + m1 * T[:, l - 1, 1] * z) / x
                    T[:, l, 1] = (m1 * T[:, l - 1, 1] * (2 * l - 1) * cmu
                                  - m2 * T[:, l - 2, 1] * y
                                  + m1 * R[:, l - 1, 1] * z) / x
            else:
                if l == m:
                    fact1 = np.ones(nmu)
                    fact2 = np.ones(nmu)
                    shalf = smu / 2.0
                    for i in range(1, m + 1):
                        fact1 = fact1 * ((2 * i - 1) * smu) / np.sqrt(i * (i + m))
                        if i > 2:
                            fact2 = fact2 * shalf * np.sqrt((m + i) / (i - 2.0))
                        else:
                            fact2 = fact2 * shalf
                    safe = smu > 1e-8
                    with np.errstate(divide="ignore", invalid="ignore"):
                        Aii = np.where(safe, fact2 * (1.0 + cmu ** 2) / (smu ** 2),
                                       0.5 if m == 2 else 0.0)
                        Aij = np.where(safe, fact2 * (2.0 * cmu) / (smu ** 2),
                                       0.5 if m == 2 else 0.0)
                    P[:, l, m] = fact1
                    R[:, l, m] = Aii
                    T[:, l, m] = -Aij
                elif l == m + 1:
                    m1 = np.sqrt(1.0 / (l + m))
                    xp = l - m
                    P[:, l, m] = (m1 * P[:, l - 1, m] * (2 * l - 1) * cmu) / xp
                    z = (2.0 * m * (2 * l - 1)) / (l * (l - 1.0))
                    x = ((l - m) / float(l)) * np.sqrt(l * l - 4.0)
                    R[:, l, m] = (m1 * R[:, l - 1, m] * (2 * l - 1) * cmu
                                  + m1 * T[:, l - 1, m] * z) / x
                    T[:, l, m] = (m1 * T[:, l - 1, m] * (2 * l - 1) * cmu
                                  + m1 * R[:, l - 1, m] * z) / x
                else:
                    m1 = np.sqrt((l - m) / (l + m + 0.0))
                    m2 = m1 * np.sqrt((l - m - 1.0) / (l + m - 1.0))
                    yp = l - 1 + m
                    xp = l - m
                    P[:, l, m] = (m1 * P[:, l - 1, m] * (2 * l - 1) * cmu
                                  - m2 * P[:, l - 2, m] * yp) / xp
                    z = (2.0 * m * (2 * l - 1)) / (l * (l - 1.0))
                    y = ((l + m - 1.0) / (l - 1.0)) * np.sqrt((l - 3.0) * (l + 1.0))
                    x = ((l - m) / float(l)) * np.sqrt(l * l - 4.0)
                    R[:, l, m] = (m1 * R[:, l - 1, m] * (2 * l - 1) * cmu
                                  - m2 * R[:, l - 2, m] * y
                                  + m1 * T[:, l - 1, m] * z) / x
                    T[:, l, m] = (m1 * T[:, l - 1, m] * (2 * l - 1) * cmu
                                  - m2 * T[:, l - 2, m] * y
                                  + m1 * R[:, l - 1, m] * z) / x

    return P, R, -T


def compute_legendre_poly(x, nmax: int):
    """Legendre P_l and the P^2/R^2/T^2 generalized functions on x in [-1,1].

    Mirror of legendre_functions.jl:223-265 (used by Mie Greek projection and
    the Legendre-albedo surface). Returns arrays of shape (len(x), nmax).
    """
    x = np.asarray(x, dtype=np.float64)
    assert nmax > 1
    n = len(x)
    P0 = np.zeros((n, nmax))
    P2 = np.zeros((n, nmax))
    R2 = np.zeros((n, nmax))
    T2 = np.zeros((n, nmax))
    P0[:, 0] = 1.0
    P0[:, 1] = x
    if nmax > 2:
        P2[:, 2] = 3.0 * (1.0 - x ** 2)
        R2[:, 2] = np.sqrt(1.5) * (1.0 + x ** 2)
        T2[:, 2] = np.sqrt(6.0) * x
    for k in range(2, nmax):
        l = k - 1
        P0[:, k] = ((2 * l + 1) * x * P0[:, k - 1] - l * P0[:, k - 2]) / (l + 1)
        if k > 2:
            ia = (2 * l + 1) * x
            ib = np.sqrt((l + 2.0) * (l - 2.0)) * (l + 2.0) / l
            ic = 4.0 * (2 * l + 1) / ((l + 1.0) * l)
            idd = np.sqrt((l + 3.0) * (l - 1.0)) * (l - 1.0) / (l + 1.0)
            P2[:, k] = (ia * P2[:, k - 1] - (l + 2) * P2[:, k - 2]) / (l - 1.0)
            R2[:, k] = (ia * R2[:, k - 1] - ib * R2[:, k - 2] - ic * T2[:, k - 1]) / idd
            T2[:, k] = (ia * T2[:, k - 1] - ib * T2[:, k - 2] - ic * R2[:, k - 1]) / idd
    return P0, P2, R2, T2


def compute_mie_pi_tau(mu, nmax: int):
    """Mie angular functions pi_n, tau_n (legendre_functions.jl:195-214)."""
    mu = np.asarray(mu, dtype=np.float64)
    n_ang = len(mu)
    pi_ = np.zeros((n_ang, nmax))
    tau_ = np.zeros((n_ang, nmax))
    pi_[:, 0] = 1.0
    pi_[:, 1] = 3.0 * mu
    tau_[:, 0] = mu
    tau_[:, 1] = 6.0 * mu ** 2 - 3.0
    for n in range(2, nmax):
        pi_[:, n] = ((2 * n + 1) * mu * pi_[:, n - 1]
                     - (n + 1) * pi_[:, n - 2]) / n
        tau_[:, n] = (n + 1) * mu * pi_[:, n] - (n + 2) * pi_[:, n - 1]
    return pi_, tau_
