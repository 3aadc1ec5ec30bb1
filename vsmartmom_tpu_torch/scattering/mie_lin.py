"""Exact linearized Mie: forward-mode tangents of the NAI-2 -> delta-BGE ->
delta-M pipeline with respect to the aerosol microphysics (n_r, n_i,
mu_log, sigma_log).

Counterpart of ``vsmartmom_tpu/scattering/mie_lin.py``. The reference
differentiates its Mie code with ForwardDiff dual numbers
(src/Scattering/compute_NAI2_lin.jl); the JAX package traces the same
pipeline and takes ``jax.jacfwd``; here it is written in torch at float64 on
the CPU and differentiated with ``torch.func.jacfwd``. Mie is set-up work,
not the hot loop: the tangents run once per scene.

Discretization convention (the JAX package's): series lengths (n_max, nmx),
validity masks and the angular grid are frozen at their primal values; the
radius quadrature NODES move with (mu_log, sigma_log) (r_min is a
log-normal quantile, so the whole log-spaced grid moves with the
distribution), and that motion is part of the derivative of the
discretized integral. The two recursions of ``compute_mie_ab`` are Python
loops over the series order; the upward Riccati-Bessel one masks its
growing invalid lanes before any use, so no inf or NaN reaches a tangent.
"""

import numpy as np
import torch
from scipy.special import erfinv

from .greek import GreekCoefs
from .legendre import compute_legendre_poly, compute_mie_pi_tau
from .mie import SizeDistribution, gauleg_log, get_n_max

_SQRT2PI = float(np.sqrt(2.0 * np.pi))
_F64 = torch.float64
_C128 = torch.complex128


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=_F64)


def _abs2(z):
    return z.real ** 2 + z.imag ** 2


def _lognorm_pdf(r, mu_log, sigma_log):
    ln = torch.log(r)
    return torch.exp(-((ln - mu_log) ** 2) / (2.0 * sigma_log ** 2)) / (
        r * sigma_log * _SQRT2PI)


def _mie_ab(x, m_ref, n_max: int, nmx: int, valid_mask):
    """mie.compute_mie_ab as differentiable torch: x (nr,) real, m_ref a
    complex scalar tensor, valid_mask (n_max, nr) bool (n <= n_max(x_i)).
    Returns (an, bn), each (nr, n_max) complex."""
    y = x * m_ref
    D = torch.zeros_like(y)
    Dn = [None] * n_max
    for n in range(nmx - 1, 0, -1):               # downward log-derivative
        ratio = (n + 1.0) / y
        D = ratio - 1.0 / (D + ratio)
        if n <= n_max:
            Dn[n - 1] = D

    psi0, psi1 = torch.cos(x), torch.sin(x)
    chi0, chi1 = -torch.sin(x), torch.cos(x)
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    czero = torch.zeros_like(y)
    an, bn = [], []
    for n in range(1, n_max + 1):
        valid = valid_mask[n - 1]
        psi = (2.0 * n - 1.0) * psi1 / x - psi0
        chi = (2.0 * n - 1.0) * chi1 / x - chi0
        # Mask the exponentially growing invalid lanes BEFORE any use.
        psi_s = torch.where(valid, psi, one)
        chi_s = torch.where(valid, chi, zero)
        psi1_s = torch.where(valid, psi1, one)
        chi1_s = torch.where(valid, chi1, zero)
        xi = torch.complex(psi_s, chi_s)
        xi1 = torch.complex(psi1_s, chi1_s)
        t_a = Dn[n - 1] / m_ref + n / x
        t_b = Dn[n - 1] * m_ref + n / x
        an.append(torch.where(valid, (t_a * psi_s - psi1_s)
                              / (t_a * xi - xi1), czero))
        bn.append(torch.where(valid, (t_b * psi_s - psi1_s)
                              / (t_b * xi - xi1), czero))
        # keep the carried recursion bounded on invalid lanes
        psi0, psi1 = psi1, torch.where(valid, psi, one)
        chi0, chi1 = chi1, torch.where(valid, chi, one)
    return torch.stack(an, dim=1), torch.stack(bn, dim=1)


def _radius_grid(mu_log, sigma_log, *, xi, w_leg, ln_hi, z8, ln_lo_const):
    """Radius quadrature as a function of the distribution parameters
    (mie.gauleg_log with r_min = max(quantile(1e-8), 1e-6 r_max):
    ln r_min = mu + sigma z8, or the constant branch when z8 is None)."""
    ln_lo = _t(ln_lo_const) if z8 is None else mu_log + sigma_log * z8
    r = torch.exp(0.5 * (ln_hi - ln_lo) * xi + 0.5 * (ln_hi + ln_lo))
    return r, w_leg * r * (ln_hi - ln_lo) / 2.0


def _complex_index(n_r, n_i):
    return torch.complex(n_r, -n_i)


def _bulk_extinction(theta, *, grid_static, k_wav, n_max, nmx, valid_mask,
                     fixed_m):
    """Bulk C_ext at one wavelength (mie.compute_ref_aerosol_extinction)."""
    n_r, n_i, mu_log, sigma_log = theta
    m_ref = _complex_index(n_r, n_i) if fixed_m is None else \
        torch.tensor(fixed_m, dtype=_C128)
    r, wr = _radius_grid(mu_log, sigma_log, **grid_static)
    x = k_wav * r
    an, bn = _mie_ab(x, m_ref, n_max, nmx, valid_mask)
    two_n1 = 2.0 * torch.arange(1, n_max + 1, dtype=_F64) + 1.0
    C_ext = 2 * np.pi / k_wav ** 2 * ((an + bn).real @ two_n1)
    wx = _lognorm_pdf(r, mu_log, sigma_log) * wr
    wx = wx / wx.sum()
    return (wx * C_ext).sum()


def _nai2(theta, *, grid_static, k_wav, n_max, nmx, valid_mask, leg_pi,
          leg_tau, mu, w_mu, P, P2, R2, T2, fac, half):
    """NAI-2 bulk optics (mie.compute_aerosol_optical_properties): the six
    Greek vectors, the single-scattering albedo and C_ext."""
    n_r, n_i, mu_log, sigma_log = theta
    r, wr = _radius_grid(mu_log, sigma_log, **grid_static)
    x = k_wav * r
    an, bn = _mie_ab(x, _complex_index(n_r, n_i), n_max, nmx, valid_mask)

    ns = torch.arange(1, n_max + 1, dtype=_F64)
    two_n1 = 2.0 * ns + 1.0
    C_sca = 2 * np.pi / k_wav ** 2 * ((_abs2(an) + _abs2(bn)) @ two_n1)
    C_ext = 2 * np.pi / k_wav ** 2 * ((an + bn).real @ two_n1)

    cn = two_n1 / (ns * (ns + 1.0))
    tc = (leg_tau * cn).to(_C128)
    pc = (leg_pi * cn).to(_C128)
    S1 = tc @ an.T + pc @ bn.T                            # (n_mu, nr)
    S2 = pc @ an.T + tc @ bn.T

    inv_x2 = 0.5 / x ** 2
    s12 = S1 * torch.conj(S2)
    f11 = inv_x2 * (_abs2(S1) + _abs2(S2))
    f33 = inv_x2 * (2.0 * s12.real)
    f12 = -inv_x2 * (_abs2(S1) - _abs2(S2))
    f34 = -inv_x2 * (s12 - S2 * torch.conj(S1)).imag

    wx = _lognorm_pdf(r, mu_log, sigma_log) * wr
    wx = wx / wx.sum()
    bulk_C_sca = (wx * C_sca).sum()
    bulk_C_ext = (wx * C_ext).sum()
    wr_phase = 4 * np.pi * r ** 2 * wx
    bf11 = f11 @ wr_phase / bulk_C_sca
    bf33 = f33 @ wr_phase / bulk_C_sca
    bf12 = f12 @ wr_phase / bulk_C_sca
    bf34 = f34 @ wr_phase / bulk_C_sca

    # Greek projection (mie.greek_from_scattering_matrix)
    beta = half * ((w_mu * bf11) @ P)
    delta = half * ((w_mu * bf33) @ P)
    gamma = fac * ((w_mu * bf12) @ P2)
    eps = fac * ((w_mu * bf34) @ P2)
    zeta = fac * ((w_mu * bf33) @ R2 + (w_mu * bf11) @ T2)
    alpha = fac * ((w_mu * bf11) @ R2 + (w_mu * bf33) @ T2)
    return (alpha, beta, gamma, delta, eps, zeta), bulk_C_sca / bulk_C_ext, \
        bulk_C_ext


def _delta_bge(greek6, l_max: int, *, w_t, Pt, P2t, fac_full, fac_t):
    """delta-BGE truncation (mie.truncate_phase_delta_bge)."""
    alpha, beta, gamma, delta, eps, zeta = greek6
    f11 = Pt @ beta
    f12 = P2t @ (fac_full * gamma)
    f34 = P2t @ (fac_full * eps)

    def fit(B, y):
        wy2 = w_t / y ** 2
        A = (B * wy2[:, None]).T @ B
        b = B.T @ (w_t / y)
        return torch.linalg.solve(A, b)

    cl = fit(Pt[:, :l_max], f11)
    B2 = P2t[:, 2:l_max] * fac_t[None, 2:]
    gcoef = fit(B2, f12)
    ecoef = fit(B2, f34)

    c0 = cl[0]
    beta_t = cl / c0
    corr = beta[:l_max] - cl
    delta_t = (delta[:l_max] - corr) / c0
    alpha_t = (alpha[:l_max] - corr) / c0
    zeta_t = (zeta[:l_max] - corr) / c0
    z2 = torch.zeros(2, dtype=_F64)
    return (alpha_t, beta_t, torch.cat([z2, gcoef]), delta_t,
            torch.cat([z2, ecoef]), zeta_t), 1.0 - c0


def _fac(ls, scale):
    with np.errstate(divide="ignore"):
        return np.where(ls >= 2, scale / np.sqrt(np.maximum(
            1.0, (ls - 1.0) * ls * (ls + 1.0) * (ls + 2.0))), 0.0)


def build_lin_aerosol_fn(aer, scat, lam_band: float, profile_shape,
                         use_bge: bool, l_cap: int):
    """(fn, theta0): fn maps theta = (n_r, n_i, mu_log, sigma_log), a (4,)
    float64 tensor, to the aerosol component the model build makes of it
    (model.build_one_aerosol for a Mie aerosol): a dict of greek (6, L),
    ssa (delta-M scaled), tau_profile (Nz,) and k_over_kref."""
    theta0 = np.array([aer.n_r, aer.n_i, aer.mu_log, aer.sigma_log])

    # Discretization frozen at the primal point; the nodes move.
    dist = SizeDistribution(aer.mu_log, aer.sigma_log)
    q8 = dist.quantile(1e-8)
    lo_const = 1e-6 * scat.r_max
    r_min = max(q8, lo_const)
    r, _ = gauleg_log(scat.nquad_radius, r_min, scat.r_max)
    xi_leg, w_leg = np.polynomial.legendre.leggauss(scat.nquad_radius)
    z8 = float(np.sqrt(2.0) * erfinv(2 * 1e-8 - 1.0)) if q8 >= lo_const \
        else None
    grid_static = dict(xi=_t(xi_leg), w_leg=_t(w_leg),
                       ln_hi=float(np.log(scat.r_max)), z8=z8,
                       ln_lo_const=float(np.log(r_min)))
    # nmx of the D_n recursion covers |y| = |x m| at the primal index.
    m0 = abs(complex(aer.n_r, -aer.n_i))

    def static_geom(lam):
        k_wav = 2 * np.pi / lam
        x = k_wav * r
        n_max = get_n_max(np.max(x))
        n_max_i = np.array([get_n_max(v) for v in x])
        valid = np.arange(1, n_max + 1)[:, None] <= n_max_i[None, :]
        nmx = int(max(n_max, np.max(x) * max(m0, 1.0)) + 51)
        return dict(grid_static=grid_static, k_wav=k_wav, n_max=n_max,
                    nmx=nmx, valid_mask=torch.as_tensor(valid))

    g_band = static_geom(lam_band)
    n_mu = 2 * g_band["n_max"] - 1
    mu, w_mu = np.polynomial.legendre.leggauss(n_mu)
    leg_pi, leg_tau = compute_mie_pi_tau(mu, g_band["n_max"])
    P, P2, R2, T2 = compute_legendre_poly(mu, n_mu)
    ls = np.arange(n_mu)
    half = (2 * ls + 1) / 2.0
    g_band.update(leg_pi=_t(leg_pi), leg_tau=_t(leg_tau), mu=_t(mu),
                  w_mu=_t(w_mu), P=_t(P), P2=_t(P2), R2=_t(R2), T2=_t(T2),
                  fac=_t(_fac(ls, half)), half=_t(half))

    fixed_m = complex(scat.n_ref) if scat.n_ref is not None else None
    g_ref = static_geom(scat.lambda_ref)

    truncate = use_bge and n_mu > l_cap
    if truncate:
        # reconstruct_phase on the same n_mu-point Gauss grid
        fac_full = _fac(ls, 1.0)
        tr_static = dict(w_t=_t(w_mu), Pt=_t(P), P2t=_t(P2),
                         fac_full=_t(fac_full), fac_t=_t(fac_full[:l_cap]))

    shape = _t(profile_shape)
    tau_ref = aer.tau_ref

    def fn(theta):
        greek6, ssa_raw, k_band = _nai2(theta, **g_band)
        k_ref = _bulk_extinction(theta, fixed_m=fixed_m, **g_ref)
        if truncate:
            greek6, ft = _delta_bge(greek6, l_cap, **tr_static)
        else:
            ft = torch.zeros((), dtype=_F64)
        k_scale = k_band / k_ref
        tau_prof = tau_ref * k_scale * shape
        return {"greek": torch.stack(greek6),
                "ssa": (1.0 - ft) * ssa_raw / (1.0 - ft * ssa_raw),
                "tau_profile": (1.0 - ft * ssa_raw) * tau_prof,
                "k_over_kref": k_scale}

    return fn, theta0


def exact_aerosol_mie_tangents(aer, scat, lam_band: float, profile_shape,
                               use_bge: bool, l_cap: int):
    """Exact d{greek, ssa, tau_profile, k_over_kref}/d(n_r, n_i, mu_log,
    sigma_log) by ``torch.func.jacfwd`` at float64 on the CPU.

    Returns (primal, jac) as dicts of numpy arrays; each jac leaf has a
    trailing parameter axis of 4 in the order (n_r, n_i, mu_log,
    sigma_log)."""
    fn, theta0 = build_lin_aerosol_fn(aer, scat, lam_band, profile_shape,
                                      use_bge, l_cap)
    theta = torch.as_tensor(theta0, dtype=_F64)
    with torch.no_grad():
        primal = fn(theta)
    jac = torch.func.jacfwd(fn)(theta)
    return ({k: v.numpy() for k, v in primal.items()},
            {k: v.detach().numpy() for k, v in jac.items()})


def greek_tangent_as_coefs(jac_greek, i_param: int) -> GreekCoefs:
    """Slice the stacked (6, L, 4) greek Jacobian into a GreekCoefs tangent."""
    g = jac_greek[:, :, i_param]
    return GreekCoefs(*[np.asarray(g[i]) for i in range(6)])
