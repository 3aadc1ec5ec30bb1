"""Quadrature streams for the RT solver.

Reimplements the semantics of the reference's stream set-up
(vSmartMOM.jl src/CoreRT/tools/rt_set_streams.jl:25-182):

* Half-space Gauss-Legendre quadrature on [0, 1] with ``(Ltrunc + 2) // 2``
  weighted nodes (``Ltrunc = 2*nstreams - 2``, so nstreams weighted nodes).
* The solar zenith cosine and all viewing zenith cosines are appended as
  zero-weight output nodes (deduplicated), used only for source-function
  postprocessing — they never drive the doubling criterion.
* ``Nstreams`` counts nonzero weights (public contract
  ``stream_l_cap = 2*Nstreams - 1``); ``Nquad`` is the augmented node count.
* ``qp_mu_N``/``wt_mu_N`` are the Stokes-expanded vectors (each node repeated
  ``n_stokes`` times) used by the (N, N) supermatrix operators.
* ``rt_set_streams_radau`` is the Gauss-Radau set (``RadauQuad``,
  rt_set_streams.jl:60-130): the solar cosine is a weighted node.

Everything here is host-side float64 NumPy — quadrature is setup, not hot.
"""

from dataclasses import dataclass

import numpy as np


def gauleg(n: int, a: float = 0.0, b: float = 1.0):
    """Gauss-Legendre nodes/weights on [a, b] (reference: Scattering.gauleg)."""
    x, w = np.polynomial.legendre.leggauss(n)
    xm, xl = 0.5 * (b + a), 0.5 * (b - a)
    return xm + xl * x, xl * w


def nearest_index(arr, value) -> int:
    """Index of the element of ``arr`` closest to ``value``
    (reference: rt_helper_functions.jl nearest_point)."""
    return int(np.argmin(np.abs(np.asarray(arr) - value)))


@dataclass(frozen=True)
class QuadPoints:
    """Quadrature node set (reference: CoreRT/types.jl:872-891 QuadPoints).

    All arrays are host float64; the model build casts them to the solver
    dtype when packing device inputs.
    """

    mu0: float              # cos(SZA)
    i_mu0: int              # 0-based index of the SZA node in qp_mu
    qp_mu: np.ndarray       # (Nquad,) node cosines
    wt_mu: np.ndarray       # (Nquad,) weights (0 for appended SZA/VZA nodes)
    qp_mu_N: np.ndarray     # (Nquad*n_stokes,) Stokes-expanded nodes
    wt_mu_N: np.ndarray     # (Nquad*n_stokes,) Stokes-expanded weights
    Nquad: int              # total node count (incl. zero-weight outputs)
    Nstreams: int           # count of nonzero weights

    @property
    def i_mu0_start(self) -> int:
        """0-based start row of the solar stream block in the supermatrix."""
        n = len(self.qp_mu_N) // self.Nquad
        return n * self.i_mu0


def gaussradau(n: int):
    """Gauss-Radau nodes/weights on [-1, 1] with x = -1 a FIXED node.

    Interior nodes are the roots of the Jacobi polynomial P_{n-1}^{(0,1)};
    weights w_i = (1 - x_i) / (n^2 [P_{n-1}(x_i)]^2) for interior nodes
    and w_0 = 2/n^2 at the fixed endpoint. Exact for polynomials of degree
    <= 2n - 2 (the rule of FastGaussQuadrature.gaussradau, which the
    reference uses, rt_set_streams.jl:74).
    """
    if n < 2:
        return np.array([-1.0]), np.array([2.0])
    from scipy.special import eval_legendre, roots_jacobi
    x, _ = roots_jacobi(n - 1, 0.0, 1.0)
    Pn1 = eval_legendre(n - 1, x)
    w = (1.0 - x) / (n * n * Pn1 * Pn1)
    return np.concatenate([[-1.0], x]), np.concatenate([[2.0 / n ** 2], w])


def rt_set_streams_radau(nstreams: int, sza_deg: float, vza_deg,
                         n_stokes: int) -> QuadPoints:
    """Gauss-Radau stream set with the SZA as a FULL weighted node (DNI).

    Mirrors rt_set_streams(::RadauQuad, ...) (vSmartMOM.jl
    src/CoreRT/tools/rt_set_streams.jl:60-130): a Radau rule per interval
    [0, mu0] and [mu0, 1], each with its fixed endpoint mapped onto mu0 (and
    1), so the direct beam's direction carries quadrature weight; VZA
    cosines are appended as zero-weight output nodes.
    """
    ltrunc = 2 * nstreams - 2
    n_half = max((ltrunc + 1) // 2, 2)   # reference: Nquad = (Ltrunc+1) ÷ 2
    x, w = gaussradau(n_half)
    # reference orientation: qp = -reverse(x) puts the fixed node at +1
    qp0 = -x[::-1]
    wt0 = w[::-1]
    mu0 = float(np.cos(np.deg2rad(sza_deg)))

    # Two intervals with the shared fixed endpoint landing on mu0.
    qp_lo = (mu0 + mu0 * qp0) / 2.0          # [0, mu0], fixed node -> mu0
    wt_lo = mu0 * wt0 / 2.0
    qp_hi = ((1 + mu0) + (1 - mu0) * qp0) / 2.0   # [mu0, 1], fixed -> 1
    wt_hi = (1 - mu0) * wt0 / 2.0
    qp = np.concatenate([qp_lo, qp_hi])
    wt = np.concatenate([wt_lo, wt_hi])

    mu_v = np.cos(np.deg2rad(np.atleast_1d(
        np.asarray(vza_deg, dtype=np.float64))))
    merged = list(qp)
    for extra in mu_v:
        if not any(abs(extra - q) < 1e-9 for q in merged):
            merged.append(float(extra))
    qp_mu = np.asarray(merged, dtype=np.float64)
    wt_mu = np.concatenate([wt, np.zeros(len(qp_mu) - len(wt))])

    i_mu0 = nearest_index(qp_mu, mu0)
    return QuadPoints(mu0=mu0, i_mu0=i_mu0, qp_mu=qp_mu, wt_mu=wt_mu,
                      qp_mu_N=np.repeat(qp_mu, n_stokes),
                      wt_mu_N=np.repeat(wt_mu, n_stokes),
                      Nquad=len(qp_mu),
                      Nstreams=int(np.count_nonzero(wt_mu)))


def rt_set_streams(nstreams: int, sza_deg: float, vza_deg, n_stokes: int) -> QuadPoints:
    """Build the Gauss-Legendre stream set with appended zero-weight outputs.

    Mirrors rt_set_streams(::GaussLegQuad, Ltrunc, ...) at
    vSmartMOM.jl src/CoreRT/tools/rt_set_streams.jl:25-47 with
    ``Ltrunc = 2*nstreams - 2`` (kwarg form, l.153-161).
    """
    if nstreams < 1:
        raise ValueError(f"nstreams must be >= 1; got {nstreams}")
    ltrunc = 2 * nstreams - 2
    n_weighted = (ltrunc + 2) // 2

    qp, wt = gauleg(n_weighted, 0.0, 1.0)
    mu0 = float(np.cos(np.deg2rad(sza_deg)))
    mu_v = np.cos(np.deg2rad(np.atleast_1d(np.asarray(vza_deg, dtype=np.float64))))

    # Append VZA cosines then the SZA cosine as zero-weight nodes, dropping
    # duplicates while keeping first-seen order. Unlike the reference's exact
    # unique() (rt_set_streams.jl:37), we deduplicate with a tolerance:
    # cos(60 deg) = 0.49999999999999994 must merge with an exact Gauss node
    # at 0.5 — near-duplicate nodes catastrophically amplify rounding in the
    # elemental mu_j/(mu_i - mu_j) transmission term on f32 hardware.
    merged = list(qp)
    for extra in [*mu_v, mu0]:
        if not any(abs(extra - q) < 1e-9 for q in merged):
            merged.append(float(extra))
    qp_mu = np.asarray(merged, dtype=np.float64)
    wt_mu = np.concatenate([wt, np.zeros(len(qp_mu) - len(wt))])

    nquad = len(qp_mu)
    nstreams_actual = int(np.count_nonzero(wt_mu))
    i_mu0 = nearest_index(qp_mu, mu0)

    qp_mu_N = np.repeat(qp_mu, n_stokes)
    wt_mu_N = np.repeat(wt_mu, n_stokes)
    return QuadPoints(mu0=mu0, i_mu0=i_mu0, qp_mu=qp_mu, wt_mu=wt_mu,
                      qp_mu_N=qp_mu_N, wt_mu_N=wt_mu_N,
                      Nquad=nquad, Nstreams=nstreams_actual)
