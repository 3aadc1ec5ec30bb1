"""Scene-derived Newton-Schulz iteration schedule (host-side probe).

The solver's geometric-series factors (I - S)^-1 are Newton-Schulz
iterations whose error after k iterations is rho(S)^(2^(k+1)).  A fixed
worst-case count (6 iters + 2 refinements, sized for rho = 0.8) wastes
2-3x FLOPs on real scenes: early doubling-ladder steps have
rho(r r) ~ (pi dtau)^2 ~ 1e-6 and converge in one iteration, and typical
Rayleigh-layer composites sit far below the conservative-cloud worst case
(round-2 VERDICT weak item 2; ADVICE round-2 medium item: fixed counts
also silently under-converge when rho -> 1).

This module runs the m = 0 adding-doubling recursion for ONE spectral
point in numpy float64 on the host (microseconds next to the device
solve), records the infinity-norm bound ||S||_inf >= rho(S) of every
inverse argument — each doubling-ladder step, each layer interaction, and
the surface interaction — and converts the bounds into per-step iteration
counts with one extra safety iteration.  m = 0 has the largest phase
matrices, so its bounds dominate all moments.

Behavioral reference for the probed algebra:
vSmartMOM.jl src/CoreRT/CoreKernel/{elemental,doubling,interaction}.jl
(the probe mirrors core/kernels.py elemental/doubling/interaction).
"""

import numpy as np

#: Convergence target for ||I - M A||; one extra NS iteration squares the
#: error term, so the realized error is ~tol^2 at the scheduled count.
TOL = 1e-8

#: Iteration-count clamp: 12 iterations reach rho^8192 (< 1e-17 even at
#: rho = 0.995); above that the scene is numerically singular and the
#: XLA fallback's residual-checked refinement is the safety net.
MAX_ITERS = 12


def iters_for_rho(rho: float, tol: float = TOL) -> int:
    """Smallest k with rho^(2^(k+1)) < tol, +1 safety, clamped [0, 12].

    0 means the Neumann SEED I + S alone: its residual is exactly
    ||S^2|| <= rho^2, so when rho^2 < tol the inverse costs ZERO dots —
    early doubling-ladder steps have rho ~ (pi dtau)^2 ~ 1e-6 and take
    this path (round-5 ladder shave; the +1 safety iteration is not
    needed because the infinity-norm bound is already >= the spectral
    radius)."""
    if not np.isfinite(rho) or rho >= 1.0:
        return MAX_ITERS
    if rho <= 0.0 or rho * rho < tol:
        return 0
    need = np.log(tol) / np.log(rho)       # required exponent 2^(k+1)
    k = int(np.ceil(np.log2(max(need, 2.0)))) - 1
    return int(np.clip(k + 1, 1, MAX_ITERS))


def _elemental_rt(wZ_pp, wZ_mp, dtau, qp_mu_N, wt_mu_N, fourier_w=0.5):
    """Numpy port of kernels.elemental r/t (sources not needed for norms)."""
    mu_i = qp_mu_N[:, None]
    mu_j = qp_mu_N[None, :]
    wct = fourier_w * wt_mu_N[None, :]
    Em1 = np.expm1(-dtau / qp_mu_N)
    E = 1.0 + Em1

    r_geom = (mu_j / (mu_i + mu_j)) * wct
    one_m_EE = -(Em1[:, None] + Em1[None, :] + Em1[:, None] * Em1[None, :])
    r_mp = wZ_mp * r_geom * one_m_EE

    same_mu = np.abs(mu_i - mu_j) <= 1e-9 * np.maximum(mu_i, mu_j)
    delta = np.where(same_mu, 1.0, mu_i - mu_j)
    ratio = np.expm1(dtau * (delta / (mu_i * mu_j))) / delta
    t_off = wZ_pp * (mu_j * wct) * E[None, :] * ratio
    t_same = E[None, :] * wZ_pp * (dtau / mu_i) * wct
    t_pp = np.where(same_mu, t_same + np.diag(E), t_off)
    return r_mp, t_pp


def probe_ns_schedule(wZ_pp_layers, wZ_mp_layers, tau_layers, qp_mu_N,
                      wt_mu_N, d_vec, ndoubl: int, surf_r=None,
                      tol: float = TOL):
    """Per-step NS iteration counts from a 1-point m = 0 host solve.

    Args:
      wZ_pp_layers / wZ_mp_layers: (nz, N, N) premixed ``pi * Z`` matrices
        at the probe spectral point, m = 0.
      tau_layers: (nz,) layer optical depths at the probe point.
      qp_mu_N / wt_mu_N: (N,) Stokes-expanded streams.
      d_vec: (N,) +-1 D-matrix diagonal.
      ndoubl: uniform doubling count.
      surf_r: optional (N, N) surface reflection operator (with quadrature
        factor), for the final surface-interaction bound.

    Returns (ns_sched, ns_inter): tuple of ndoubl per-ladder-step counts
    (max over layers), and the interaction count (max over layers incl.
    surface).
    """
    nz, N, _ = np.shape(wZ_pp_layers)
    eye = np.eye(N)
    rho_dbl = np.zeros(max(ndoubl, 1))
    rho_int = 0.0

    R_mp = np.zeros((N, N))
    R_pm = np.zeros((N, N))
    T_pp = eye.copy()
    T_mm = eye.copy()
    sgn = np.outer(d_vec, d_vec)

    for z in range(nz):
        dtau = tau_layers[z] / (2 ** ndoubl)
        r_mp, t = _elemental_rt(wZ_pp_layers[z], wZ_mp_layers[z], dtau,
                                qp_mu_N, wt_mu_N)
        r = r_mp * d_vec[:, None]          # starred ladder, as in the kernel
        for k in range(ndoubl):
            S = r @ r
            rho_dbl[k] = max(rho_dbl[k], np.abs(S).sum(axis=1).max())
            gp = np.linalg.solve(eye - S, eye)
            tt_gp = t @ gp
            r = r + tt_gp @ (r @ t)
            t = tt_gp @ t
        r_mp = r * d_vec[:, None]
        r_pm = sgn * r_mp
        t_mm = sgn * t

        S1 = r_mp @ R_pm
        rho_int = max(rho_int, np.abs(S1).sum(axis=1).max())
        inv1 = np.linalg.solve(eye - S1, eye)
        T01 = T_mm @ inv1
        R_mp_new = R_mp + T01 @ (r_mp @ T_pp)
        T_mm_new = T01 @ t_mm
        inv2 = np.linalg.solve(eye - R_pm @ r_mp, eye)
        T21 = t @ inv2
        T_pp_new = T21 @ T_pp
        R_pm_new = r_pm + T21 @ (R_pm @ t_mm)
        R_mp, R_pm, T_pp, T_mm = R_mp_new, R_pm_new, T_pp_new, T_mm_new

    if surf_r is not None:
        S1 = np.asarray(surf_r) @ R_pm
        rho_int = max(rho_int, np.abs(S1).sum(axis=1).max())

    ns_sched = tuple(iters_for_rho(float(r), tol) for r in rho_dbl[:ndoubl])
    ns_inter = iters_for_rho(float(rho_int), tol)
    return ns_sched, ns_inter
