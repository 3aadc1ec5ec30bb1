"""Wigner 3j symbol tables for the Domke-PCW Greek decomposition.

Counterpart of the JAX package's ``scattering/wigner.py`` (the same NumPy
f64 host code). Behavioral reference: vSmartMOM.jl
src/Scattering/compute_wigner_values.jl (Sanghavi 2014 recursions, Eqs.
25-31, with the two typo corrections noted there). Re-derived as
vectorized NumPy: the reference memoizes a scalar
top-down recursion; here the downward m-recursion runs as array ops over all
n simultaneously (host f64 setup work, like the Mie path).

Three symbol families are needed (j1=m, j2=n, j3=l):
  A[m, n] = 3j(m, n, l; -1,  1, 0)
  W[m, n] = 3j(m, n, l;  0,  0, 0)
  B[m, n] = 3j(m, n, l; -1, -1, 2)

One mathematical correction vs the reference implementation: the reference
caps its preallocated tables at m <= 2*N_max+1 and silently treats larger m
as zero (compute_wigner_values.jl:31-33), which poisons the downward
recursion for (n, l) with n + l > 2*N_max+1; here the recursion is always
seeded from the true base value at m = n + l.
"""

import numpy as np


def _base_diagonal(l: int, n_cap: int) -> np.ndarray:
    """A(m=n+l, n, l) for n = 1..n_cap (Eqs. 27-28): base[0] unused."""
    n = np.arange(1, n_cap + 1, dtype=np.float64)
    base1 = (-1.0) ** l * np.sqrt(
        (l + 1.0) * (l + 2.0) / ((2.0 * l + 1.0) * (2.0 * l + 2.0)
                                 * (2.0 * l + 3.0)))
    ratio = np.ones(n_cap)
    nn = n[1:]
    ratio[1:] = -np.sqrt(nn * (2.0 * nn - 1.0) * ((nn + l) ** 2 - 1.0)
                         / ((nn + l) * (2.0 * (nn + l) + 1.0)
                            * (nn ** 2 - 1.0)))
    return base1 * np.cumprod(ratio)


def wigner_AB_for_l(l: int, n_cap: int):
    """(A_l, B_l) tables for one l, shape (m_rows, n_cap + 1) with true
    1-based (m, n) indexing (row m, column n); rows span m = 0..n_cap+l+2.

    A_l[m, n] = 3j(m, n, l; -1, 1, 0); B_l[m, n] = 3j(m, n, l; -1, -1, 2).
    """
    m_rows = n_cap + l + 3
    n = np.arange(0, n_cap + 1, dtype=np.float64)         # column index
    A = np.zeros((m_rows, n_cap + 1))
    W = np.zeros((m_rows, n_cap + 1))

    base = _base_diagonal(l, n_cap)
    rows = (np.arange(1, n_cap + 1) + l)
    A[rows, np.arange(1, n_cap + 1)] = base

    # 000 base (Eq. 30): W(n+l, n, l) = A(n+l,n,l) * 2 sqrt((n+l)(n+l+1)n(n+1))
    #                                   / (l(l+1) - (n+l)(n+l+1) - n(n+1))
    nn = np.arange(1, n_cap + 1, dtype=np.float64)
    denom0 = l * (l + 1.0) - (nn + l) * (nn + l + 1.0) - nn * (nn + 1.0)
    W[rows, np.arange(1, n_cap + 1)] = base * 2.0 * np.sqrt(
        (nn + l) * (nn + l + 1.0) * nn * (nn + 1.0)) / denom0

    lo = np.abs(n - l)                                     # triangle floor
    hi = n + l
    # Downward recursions over m (Eqs. 25-26 for A; Eq. 29 for W).
    for m in range(m_rows - 3, 0, -1):
        active = (m >= lo) & (m < hi) & (n >= 1)
        if not active.any():
            if m < l - n_cap:          # below every triangle floor
                break
            continue
        k = m + 1.0
        with np.errstate(invalid="ignore", divide="ignore"):
            D_k = np.sqrt(np.maximum(
                (k ** 2 - 1.0) * (k ** 2 - (l - n) ** 2)
                * ((n + l + 1.0) ** 2 - k ** 2), 0.0)) / k
            M_k = 1.0 - (n * (n + 1.0) - l * (l + 1.0)) / (k * (k + 1.0))
            k2 = m + 2.0
            D_k2 = np.sqrt(np.maximum(
                (k2 ** 2 - 1.0) * (k2 ** 2 - (l - n) ** 2)
                * ((n + l + 1.0) ** 2 - k2 ** 2), 0.0)) / k2
            A_m = (M_k * (2.0 * m + 3.0) * A[m + 1] - D_k2 * A[m + 2]) / D_k
            # W: two-step recursion (parity-preserving); the (1 - 1/(n+l-m))
            # factor zeroes m = n+l-1 automatically.
            W_m = -W[m + 2] * np.sqrt(
                np.maximum(((m + 2.0) ** 2 - (n - l) ** 2)
                           / np.maximum((m + 1.0) ** 2 - (n - l) ** 2, 1e-300),
                           0.0)) * np.sqrt(np.maximum(
                               (1.0 - 1.0 / np.maximum(n + l - m, 1e-300))
                               * (1.0 + 1.0 / (m + n + l + 2.0)), 0.0))
        # keep base-diagonal entries (m == n + l) already stored in this row
        A[m] = np.where(active, A_m, A[m])
        W[m] = np.where(active, W_m, W[m])

    # B via Eq. 31 (zero for l < 2: j3 >= |m3| = 2).
    if l < 2:
        return A, np.zeros_like(A)
    m_col = np.arange(m_rows, dtype=np.float64)[:, None]
    sign = np.where((m_col + n[None, :] + l) % 2 == 0, 1.0, -1.0)
    pref = ((l - 1.0) * l * (l + 1.0) * (l + 2.0)) ** (-0.5)
    B = sign * pref * (
        (m_col * (m_col + 1.0) + sign * n[None, :] * (n[None, :] + 1.0)) * A
        + 2.0 * np.sqrt(np.maximum(m_col * (m_col + 1.0)
                                   * n[None, :] * (n[None, :] + 1.0), 0.0)) * W)
    B[:, 0] = 0.0
    B[0, :] = 0.0
    return A, B


def compute_wigner_values(N_max: int):
    """Full (wigner_A, wigner_B) tables, shape (2N+1, N+1, 2N+1) indexed
    [m-1, n-1, l_idx-1] with l_idx = j3 + 1 — the reference's table layout
    (compute_wigner_values.jl:188-210) for save/load interoperability."""
    m_cap, n_cap, l_cap = 2 * N_max + 1, N_max + 1, 2 * N_max + 1
    A = np.zeros((m_cap, n_cap, l_cap))
    B = np.zeros((m_cap, n_cap, l_cap))
    for l_idx in range(1, l_cap + 1):
        A_l, B_l = wigner_AB_for_l(l_idx - 1, n_cap)
        rows = min(m_cap, A_l.shape[0] - 1)
        A[:rows, :, l_idx - 1] = A_l[1:rows + 1, 1:]
        B[:rows, :, l_idx - 1] = B_l[1:rows + 1, 1:]
    return A, B


def save_wigner_values(path, wigner_A, wigner_B):
    np.savez_compressed(path, wigner_A=wigner_A, wigner_B=wigner_B)


def load_wigner_values(path):
    d = np.load(path)
    return d["wigner_A"], d["wigner_B"]
