"""The port's aerosol host build against the JAX package: Mie optics (NAI-2,
delta-BGE, the analytic phase function), the exact Mie tangents, the
aerosol profiles, the Z moments at a Mie aerosol's l_max and the Cox-Munk
wind tangent.

Tolerances, relative to max|ref|: 1e-12 where both packages run the same
NumPy float64 arithmetic; 1e-9 for the exact Mie tangents (torch's
``jacfwd`` and JAX's order the complex recursions' operations differently,
and the upward Riccati-Bessel recursion amplifies the rounding); the
port's central-difference Mie route against its exact route at the gates
of the JAX package's tests/test_mie_lin.py (1e-5 on tau and ssa, 1e-4 on
the Greek coefficients).
"""

import numpy as np
import pytest
import torch

from vsmartmom_tpu_torch.flagship import LIN_REF_AEROSOL

GREEK = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _greek_rel(a, b):
    return max(_rel(getattr(a, f), getattr(b, f)) for f in GREEK)


#: (mu_log, sigma_log, n_r, n_i, lambda um, r_max, nquad_radius): the small
#: Jacobian scene's aerosol and the aerosol flagship's (l_max 303).
AEROSOLS = {"lin_ref": (np.log(0.12), np.log(1.5), 1.4, 0.003, 0.755, 10.0,
                        60),
            "flagship": (np.log(0.12), np.log(1.5), 1.4, 0.003,
                         1e4 / 19417.0, 10.0, 300)}


def test_mie_helpers_match_jax():
    from vsmartmom_tpu.scattering import legendre as jl, mie as jm
    from vsmartmom_tpu_torch.scattering import legendre as pl, mie as pm
    for x in (0.3, 7.9, 8.1, 120.0):
        assert pm.get_n_max(x) == jm.get_n_max(x)
    for a, b in zip(pm.gauleg_log(40, 1e-3, 10.0),
                    jm.gauleg_log(40, 1e-3, 10.0)):
        assert _rel(a, b) <= 1e-12
    mu = np.linspace(-1.0, 1.0, 21)
    for a, b in zip(pl.compute_mie_pi_tau(mu, 30),
                    jl.compute_mie_pi_tau(mu, 30)):
        assert _rel(a, b) <= 1e-12
    x = np.geomspace(0.05, 40.0, 25)
    for a, b in zip(pm.compute_mie_ab(x, 1.45 - 0.01j, 60),
                    jm.compute_mie_ab(x, 1.45 - 0.01j, 60)):
        assert _rel(a, b) <= 1e-12


@pytest.mark.parametrize("name", AEROSOLS)
def test_aerosol_optics_match_jax(name):
    """NAI-2 bulk optics, the reference-wavelength extinction, delta-BGE
    and no truncation."""
    from vsmartmom_tpu.scattering import mie as jm
    from vsmartmom_tpu_torch.scattering import mie as pm
    mu_log, sigma_log, n_r, n_i, lam, r_max, nq = AEROSOLS[name]
    out = {}
    for mod in (pm, jm):
        aer = mod.Aerosol(mod.SizeDistribution(mu_log, sigma_log), n_r, n_i)
        raw = mod.compute_aerosol_optical_properties(aer, lam, r_max, nq)
        out[mod] = (raw, mod.compute_ref_aerosol_extinction(aer, 0.55, r_max,
                                                            nq),
                    mod.truncate_phase_delta_bge(raw, 15),
                    mod.truncate_phase_none(raw))
    (raw, k_ref, bge, none), (raw_j, k_ref_j, bge_j, none_j) = \
        out[pm], out[jm]
    assert raw.greek_coefs.l_max == raw_j.greek_coefs.l_max
    assert _greek_rel(raw.greek_coefs, raw_j.greek_coefs) <= 1e-12
    for a, b in ((raw.ssa, raw_j.ssa), (raw.k, raw_j.k), (k_ref, k_ref_j),
                 (bge.f_trunc, bge_j.f_trunc)):
        assert abs(a - b) <= 1e-12 * abs(b)
    assert _greek_rel(bge.greek_coefs, bge_j.greek_coefs) <= 1e-12
    assert bge.greek_coefs.l_max == 15 and none.f_trunc == none_j.f_trunc == 0


def test_analytic_optics_match_jax():
    from vsmartmom_tpu.scattering.mie import analytic_aerosol_optics as ja
    from vsmartmom_tpu_torch.scattering.mie import analytic_aerosol_optics
    a, b = analytic_aerosol_optics(0.6, ssa=0.95, l_max=8), ja(0.6, ssa=0.95,
                                                              l_max=8)
    assert _greek_rel(a.greek_coefs, b.greek_coefs) <= 1e-12
    assert a.ssa == b.ssa and a.f_trunc == b.f_trunc == 0


def test_aerosol_profiles_match_jax():
    """Gaussian-in-pressure and log-normal-in-altitude profiles on the
    flagship column."""
    from vsmartmom_tpu.core import atmosphere as ja
    from vsmartmom_tpu.core.model import RTAerosol as JaxAerosol
    from vsmartmom_tpu_torch.core import atmosphere as pa
    from vsmartmom_tpu_torch.core.model import RTAerosol
    from vsmartmom_tpu_torch.flagship import FLAGSHIP_P, FLAGSHIP_T
    prof = pa.compute_atmos_profile_fields(FLAGSHIP_T, FLAGSHIP_P)
    prof_j = ja.compute_atmos_profile_fields(FLAGSHIP_T, FLAGSHIP_P)
    assert _rel(pa.aerosol_layer_tau_gauss(0.15, 700.0, 60.0, prof.p_half),
                ja.aerosol_layer_tau_gauss(0.15, 700.0, 60.0,
                                           prof_j.p_half)) <= 1e-12
    assert _rel(pa.layer_z_bounds(prof), ja.layer_z_bounds(prof_j)) <= 1e-12
    assert _rel(pa.aerosol_layer_tau_gauss_z(0.2, 2.0, 0.5, prof),
                ja.aerosol_layer_tau_gauss_z(0.2, 2.0, 0.5, prof_j)) <= 1e-12
    for kw in (dict(p0=700.0, sigma_p=60.0), dict(z0=2.0, sigma_z=0.5)):
        shape = pa.aerosol_profile_shape(RTAerosol(tau_ref=0.1, **kw), prof)
        assert abs(shape.sum() - 1.0) <= 1e-12
        assert _rel(shape, ja.aerosol_profile_shape(
            JaxAerosol(tau_ref=0.1, **kw), prof_j)) <= 1e-12


def test_z_moments_at_mie_l_max_match_jax():
    """The Z moments of a Mie aerosol's long expansion (the flagship
    aerosol's first 120 of 303 terms, which keeps the JAX package's
    per-moment Legendre recursion to about a second) from the port's
    once-per-build Legendre tables against the JAX package's per-moment
    ones, at the lowest and highest moment."""
    from vsmartmom_tpu.scattering import mie as jm
    from vsmartmom_tpu.scattering.stokes import STOKES_IQUV as JAX_IQUV
    from vsmartmom_tpu.scattering.zmatrix import compute_Z_moments
    from vsmartmom_tpu_torch.core.model import z_moment_stack
    from vsmartmom_tpu_torch.scattering.greek import GreekCoefs
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_IQUV
    from vsmartmom_tpu_torch.utils.quadrature import rt_set_streams
    mu_log, sigma_log, n_r, n_i, lam, r_max, nq = AEROSOLS["flagship"]
    greek_j = jm.compute_aerosol_optical_properties(
        jm.Aerosol(jm.SizeDistribution(mu_log, sigma_log), n_r, n_i), lam,
        r_max, nq).greek_coefs
    assert greek_j.l_max == 303
    greek_j = type(greek_j)(*(np.asarray(getattr(greek_j, f))[:120]
                              for f in GREEK))
    greek = GreekCoefs(*(getattr(greek_j, f) for f in GREEK))
    mu = rt_set_streams(8, 30.0, [0.0, 60.0], 4).qp_mu
    Z_pp, Z_mp = z_moment_stack(STOKES_IQUV, mu, [greek], 16)
    for m in (0, 15):
        ref_pp, ref_mp = compute_Z_moments(JAX_IQUV, mu, greek_j, m)
        assert _rel(Z_pp[m, 0], ref_pp) <= 1e-12
        assert _rel(Z_mp[m, 0], ref_mp) <= 1e-12


def test_exact_mie_tangents_match_jax():
    """The setup of the JAX package's tests/test_mie_lin.py, untruncated:
    primal and Jacobian of (greek, ssa, tau_profile, k_over_kref) within
    1e-9. (Through delta-BGE the fit's weighted normal equations amplify
    the two LU factorisations' rounding to ~1e-8 at that file's l_cap 20;
    the Jacobian scene's delta-BGE tangents at l_cap 7 are held at 1e-9 in
    tests/test_torch_lin.py.)"""
    from vsmartmom_tpu.core.model import RTAerosol as JaxAerosol
    from vsmartmom_tpu.core.model import ScatteringParams as JaxScat
    from vsmartmom_tpu.scattering.mie_lin import \
        exact_aerosol_mie_tangents as jax_tangents
    from vsmartmom_tpu_torch.core.model import RTAerosol, ScatteringParams
    from vsmartmom_tpu_torch.scattering.mie_lin import \
        exact_aerosol_mie_tangents
    kw = dict(tau_ref=0.2, p0=800.0, sigma_p=50.0, mu_log=np.log(0.3),
              sigma_log=np.log(1.8), n_r=1.45, n_i=0.003)
    scat_kw = dict(r_max=10.0, nquad_radius=60, lambda_ref=0.55)
    shape = np.array([0.1, 0.5, 0.4])
    aer_j = JaxAerosol(**kw)
    ref = [{k: np.asarray(v) for k, v in d.items()} for d in jax_tangents(
        aer_j, JaxScat(rt_aerosols=[aer_j], **scat_kw), 0.765, shape,
        False, 0)]
    aer = RTAerosol(**kw)
    out = exact_aerosol_mie_tangents(
        aer, ScatteringParams(rt_aerosols=[aer], **scat_kw), 0.765, shape,
        False, 0)
    for o, r in zip(out, ref):
        assert set(o) == set(r)
        for k in r:
            assert o[k].shape == r[k].shape
            assert _rel(o[k], r[k]) <= 1e-9, k


def test_fd_route_agrees_with_exact_route():
    """The port's two Mie tangent routes on the small Jacobian scene."""
    from vsmartmom_tpu_torch.core.linearization import _aerosol_tangents
    from vsmartmom_tpu_torch.flagship import lin_ref_model
    model = lin_ref_model(np.float64)
    assert model.bands[0].aerosols[0].aer.n_i == LIN_REF_AEROSOL["n_i"]
    exact = _aerosol_tangents(model, 0, 0, mie_method="exact")
    fd = _aerosol_tangents(model, 0, 0, fd_rel=1e-5, mie_method="fd")
    tau = model.bands[0].aerosols[0].tau_profile
    for p in ("n_r", "n_i", "r_mode", "sigma_g"):
        e, f = exact[p], fd[p]
        scale = max(np.abs(f["tau_profile"]).max(), np.abs(tau).max())
        assert np.abs(e["tau_profile"] - f["tau_profile"]).max() / scale \
            < 1e-5, p
        assert abs(e["ssa"] - f["ssa"]) < 1e-5 * max(1.0, abs(f["ssa"])), p
        for g in ("beta", "gamma"):
            a, b = getattr(e["greek"], g), getattr(f["greek"], g)
            assert np.abs(a - b).max() / max(np.abs(b).max(), 1.0) < 1e-4, \
                (p, g)
    with pytest.raises(ValueError, match="mie_method"):
        _aerosol_tangents(model, 0, 0, mie_method="finite")


def test_coxmunk_wind_tangent_matches_jax():
    """The analytic wind derivative of the Mueller grid, of the surface
    operators and of the TMS correction."""
    from vsmartmom_tpu.surfaces import coxmunk as jc
    from vsmartmom_tpu.utils.quadrature import rt_set_streams as jax_streams
    from vsmartmom_tpu_torch.surfaces import coxmunk as pc
    from vsmartmom_tpu_torch.utils.quadrature import rt_set_streams
    assert pc.whitecap_fraction_dU(6.0) == jc.whitecap_fraction_dU(6.0)
    mu = np.linspace(0.05, 1.0, 7)
    assert _rel(pc._smith_lambda_dsigma2(mu, 0.03),
                jc._smith_lambda_dsigma2(mu, 0.03)) <= 1e-12
    surf, surf_j = pc.CoxMunkSurface(wind_speed=6.0), \
        jc.CoxMunkSurface(wind_speed=6.0)
    grid = (mu[:, None, None], mu[None, :, None],
            np.linspace(0, np.pi, 9)[None, None, :])
    for a, b in zip(pc.cox_munk_mueller_wind_tangent(surf, 3, *grid),
                    jc.cox_munk_mueller_wind_tangent(surf_j, 3, *grid)):
        assert _rel(a, b) <= 1e-12
    quad, quad_j = rt_set_streams(4, 40.0, [10.0, 45.0], 3), \
        jax_streams(4, 40.0, [10.0, 45.0], 3)
    out = pc.coxmunk_surface_operator_arrays(surf, quad, 3, 8,
                                             wind_tangent=True)
    ref = jc.coxmunk_surface_operator_arrays(surf_j, quad_j, 3, 8,
                                             wind_tangent=True)
    assert len(out) == len(ref) == 4
    for a, b in zip(out, ref):
        assert _rel(a, b) <= 1e-12
    tau = np.array([0.1, 0.3])
    args = (3, [10.0, 45.0], [30.0, 150.0], quad.mu0, tau, 7)
    for a, b in zip(pc.tms_correction(surf, *args, wind_tangent=True),
                    jc.tms_correction(surf_j, *args, wind_tangent=True)):
        assert _rel(a, b) <= 1e-12
