"""Faults of the port repaired against the JAX package, each held on the
CPU (the JAX package keeps all three; ROADMAP.md section 3 lists them on
the reference side):

* a Jacobian run whose layout holds no parameter (a scene over RPV with no
  aerosol and no line-list gas) raises a ``ValueError`` naming the empty
  layout before any band build, and the two Jacobian solves refuse an
  empty tangent list (the JAX package fails there with a ``TypeError``);
* the plain elemental operators of an optically thick layer (dtau 3 in
  f32, 20 in f64, past which E_j expm1(x) overflows) are finite and match
  the reference formula evaluated in long double: 1e-6 of max|ref| in
  f32, 1e-12 in f64; their tangent along dtau is finite;
* over Cox-Munk the aerosol's ``tau_ref`` dR carries the TMS term's
  derivative through the column's optical depth: within 2e-3 of max|FD|
  of a central difference of the port's own ``rt_run`` (CPU, f64).
"""

import numpy as np
import pytest
import torch

from port_threads import _one_thread  # noqa: F401  (autouse)


def _rpv_model():
    """The RPV scene of tests/test_torch_land_brdf.py (3 layers, nstreams
    2, IQU, four points), f64: no aerosol, no gas, no surface parameter."""
    from test_torch_land_brdf import _params
    from vsmartmom_tpu_torch.core.model import model_from_parameters
    return model_from_parameters(_params("rpv", np.float64))


def test_empty_layout_is_refused_before_any_build():
    from vsmartmom_tpu_torch import default_layout, rt_run_lin
    model = _rpv_model()
    assert default_layout(model).n_total == 0

    def no_build(*args, **kw):
        raise AssertionError("build_band ran")
    model.build_band = no_build
    with pytest.raises(ValueError, match="layout .* holds no parameter"):
        rt_run_lin(model, device="cpu")


@pytest.mark.parametrize("route", ["jvp", "multitangent"])
def test_jacobian_solves_refuse_no_tangent(route):
    from vsmartmom_tpu_torch.core.linearization import rt_solve_jvp
    from vsmartmom_tpu_torch.ops.fused_lin import rt_solve_multitangent
    inputs, config = _rpv_model().build_band(0, device="cpu")
    solve = rt_solve_jvp if route == "jvp" else rt_solve_multitangent
    with pytest.raises(ValueError, match="no tangent"):
        solve(inputs, [], config, "cpu")


# -- the elemental operators of a thick layer --------------------------------

def _elemental_inputs(dtype):
    """The flagship's stream cosines and weights (nstreams 8, IQUV, N = 52)
    and seeded positive premixed phase matrices for two points."""
    from vsmartmom_tpu_torch.flagship import flagship_model
    inputs, config = flagship_model(n_spec=2, dtype=np.float64, nz=2) \
        .build_band(0, device="cpu")
    rng = np.random.default_rng(7)
    N = config.N
    wZ = rng.uniform(0.05, 1.0, (2, 2, N, N))
    F0 = rng.uniform(0.5, 1.0, (config.n_stokes, 2))
    return (inputs.qp_mu_N.numpy(), inputs.wt_mu_N.numpy(), wZ, F0,
            config.i_mu0_start, config.n_stokes)


def _reference_elemental(wZ_pp, wZ_mp, dtau, tau_sum, mu, wt, i0, ns, F0,
                         fw):
    """``kernels.elemental``'s formulas as written (E_j expm1(x) / delta,
    the source's E_0 expm1(x_s)), evaluated in long double."""
    ld = np.longdouble
    mu, wt = mu.astype(ld), wt.astype(ld)
    wZ_pp, wZ_mp, F0 = wZ_pp.astype(ld), wZ_mp.astype(ld), F0.astype(ld)
    d = np.asarray(dtau, dtype=ld)[:, None]
    mu0 = mu[i0]
    mi, mj = mu[:, None], mu[None, :]
    wct = fw * wt[None, :]
    E = np.exp(-d / mu[None, :])                       # (s, N)
    r_mp = wZ_mp * (mj / (mi + mj) * wct)[None] * (
        1 - E[:, :, None] * E[:, None, :])
    same = np.abs(mi - mj) <= 1e-9 * np.maximum(mi, mj)
    delta = np.where(same, 1, mi - mj)
    dd = d[:, :, None]
    x = np.where(same[None], 0, dd * (delta / (mi * mj))[None])
    t_off = wZ_pp * (mj * wct)[None] * E[:, None, :] * np.expm1(x) \
        / delta[None]
    t_same = E[:, None, :] * wZ_pp * (dd / mi) * wct[None] \
        + E[:, :, None] * np.eye(len(mu), dtype=ld)[None]
    t_pp = np.where(same[None], t_same, t_off)
    Zp = np.einsum("sik,ks->si", wZ_pp[:, :, i0:i0 + ns], F0)
    Zm = np.einsum("sik,ks->si", wZ_mp[:, :, i0:i0 + ns], F0)
    E0 = np.exp(-d / mu0)
    idx = np.arange(len(mu))
    blk = ((idx >= i0) & (idx < i0 + ns)) | (np.abs(mu - mu0) <= 1e-9 * mu0)
    ds = np.where(blk, 1, mu - mu0)[None, :]
    jp = np.where(blk[None], fw * Zp * (d / mu[None]) * E,
                  fw * Zp * (mu0 / ds) * E0 * np.expm1(
                      d * ds / (mu[None] * mu0)))
    jm = fw * Zm * (mu0 / (mu[None] + mu0)) * (1 - E * E0)
    att = np.exp(-np.asarray(tau_sum, dtype=ld) / mu0)[:, None]
    return r_mp, t_pp, jp * att, jm * att


@pytest.mark.parametrize("dtype,dtau,tol", [(np.float32, 3.0, 1e-6),
                                            (np.float64, 20.0, 1e-12)])
def test_thick_layer_elemental_is_finite_and_exact(dtype, dtau, tol):
    from vsmartmom_tpu_torch.core.kernels import elemental
    mu, wt, wZ, F0, i0, ns = _elemental_inputs(dtype)
    tdt = {np.float32: torch.float32, np.float64: torch.float64}[dtype]
    dt = np.array([dtau, 0.5 * dtau])
    ts = np.array([0.1, 0.3])

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=dtype), dtype=tdt)

    def run(d, s):
        return elemental(t(wZ[0]), t(wZ[1]), d, s, t(mu), t(wt), t(mu[i0]),
                         i0, ns, t(F0), 0.25)
    out = run(t(dt), t(ts))
    ref = _reference_elemental(wZ[0], wZ[1], dt, ts, mu, wt, i0, ns, F0, 0.25)
    # the unsplit formula overflows at this depth in this dtype
    x = dtau * (1 / mu.min() - 1 / mu.max())
    assert x > np.log(np.finfo(dtype).max)
    for name, a, b in zip(("r", "t", "j0_p", "j0_m"), out, ref):
        a = a.numpy().astype(np.float64)
        b = b.astype(np.float64)
        assert np.isfinite(a).all(), name
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), name
    _, d_out = torch.func.jvp(run, (t(dt), t(ts)),
                              (torch.ones(2, dtype=tdt),
                               torch.ones(2, dtype=tdt)))
    for name, d in zip(("r", "t", "j0_p", "j0_m"), d_out):
        assert torch.isfinite(d).all(), name


# -- the TMS term in a tau tangent -------------------------------------------

def test_aerosol_tau_jacobian_over_the_ocean_matches_finite_difference():
    """dR/d tau_ref of the small aerosol scene over Cox-Munk (wind 6;
    ``flagship.lin_ref_model`` solved in f64) against the central difference
    of ``rt_run`` in tau_ref (tau_ref (1 +- 1e-4)): 2e-3 of max|FD| (4e-10
    here; without the TMS term's derivative, as in the JAX package, the dR
    misses by 13% of max|FD|)."""
    import copy
    import dataclasses
    from test_torch_lin import solve_in_f64
    from vsmartmom_tpu_torch import (default_layout, model_from_parameters,
                                     rt_run, rt_run_lin)
    from vsmartmom_tpu_torch.flagship import lin_ref_model
    model = solve_in_f64(lin_ref_model())
    layout = default_layout(model)
    assert layout.names()[0] == "aer0_tau_ref"
    _, _, dR, _ = rt_run_lin(model, layout=layout, device="cpu")
    aer = model.params.scattering_params.rt_aerosols[0]
    h = 1e-4 * aer.tau_ref
    R = []
    for sign in (1, -1):
        params = copy.deepcopy(model.params)
        params.scattering_params.rt_aerosols[0] = dataclasses.replace(
            aer, tau_ref=aer.tau_ref + sign * h)
        R.append(rt_run(solve_in_f64(model_from_parameters(params)),
                        device="cpu")[0])
    fd = (R[0] - R[1]) / (2 * h)
    scale = np.abs(fd).max()
    assert scale > 0
    assert np.abs(dR[..., 0] - fd).max() <= 2e-3 * scale
