"""The thermal (K = 2: solar + Planck source) slice of the port against the
JAX package: the Planck spectra and ``add_thermal_emission``,
``Parameters.include_solar``, the plain K1' and the thermal Jacobian route.

* Planck spectra and the per-layer source on the thermal test scene of
  tests/test_sources.py (``TIR``: 3 isothermal layers at 1000 cm^-1,
  Stokes I, black floor) and on ``flagship.thermal_lin_model(8)``'s host
  build: 1e-12 (the same NumPy arithmetic in both packages).
* The plain K1' (``moment_multitangent_reference`` at K = 2, forward-mode
  AD of the plain moment body) against ``jax.jvp`` through the JAX
  package's ``fused_moment(..., n_sources=2, interpret=True)`` (the Pallas
  kernel K1 whose JVP rule builds K1') on small synthetic operands (N = 6,
  nz = 2, C = 2, s = 3, P = 2): f32, 2e-5 of max|ref| per output. Every
  JAX operand carries an instantiated tangent (zeros for the constants),
  the kernel's differentiability contract.
* The port's thermal Jacobian route through the plain K2 at K = 2 against
  its own jvp route on ``flagship.lin_thermal_model`` (f32): 2e-5.

The thermal ``rt_run_lin`` against the JAX ``rt_run_lin`` and the stored
reference ``vsmartmom_tpu_torch/data/lin_thermal_ref_f64.npz`` are held in
tests/test_torch_lin.py, which already pays the JAX package's exact Mie
tangent compiles for the same aerosol. ``python tests/test_torch_thermal.py``
rewrites that reference.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from port_threads import _one_thread  # noqa: F401  (autouse)

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

#: The thermal test scene of tests/test_sources.py (_tir_params), less
#: ``surfaces`` and ``polarization`` (a black Lambertian floor, Stokes I).
TIR = dict(spec_bands=[np.array([1000.0, 1001.0])], nstreams=4, sza=45.0,
           vza=[0.0, 40.0], vaz=[0.0, 120.0], obs_alt=0.0,
           T=np.array([260.0, 260.0, 260.0]),
           p=np.array([10.0, 400.0, 800.0, 1013.0]), depol=0.0,
           include_solar=False)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _tir_models(**kw):
    """(JAX model, port model) of the TIR scene from the same keywords."""
    from vsmartmom_tpu.core import model as jm
    from vsmartmom_tpu.scattering.stokes import STOKES_I as J_I
    from vsmartmom_tpu_torch.core import model as pm
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_I
    args = dict(TIR, **kw)
    return (jm.model_from_parameters(jm.Parameters(
                surfaces=[jm.SurfaceDescriptor("LambertianSurfaceScalar",
                                               [0.0])],
                polarization=J_I, **args)),
            pm.model_from_parameters(pm.Parameters(
                surfaces=[pm.SurfaceDescriptor("LambertianSurfaceScalar",
                                               [0.0])],
                polarization=STOKES_I, **args)))


def _thermal_lin_models(n_spec):
    """(JAX model, port model) of ``thermal_lin_model(n_spec)`` without its
    thermal source, the JAX one from the same ``Parameters`` keywords."""
    from vsmartmom_tpu.core import model as jm
    from vsmartmom_tpu.scattering.stokes import STOKES_IQUV as J_IQUV
    from vsmartmom_tpu_torch.flagship import (FLAGSHIP_AEROSOL, FLAGSHIP_MIE,
                                              THERMAL_NU0, flagship_params,
                                              thermal_lin_model)
    jax_model = jm.model_from_parameters(jm.Parameters(
        scattering_params=jm.ScatteringParams(
            rt_aerosols=[jm.RTAerosol(**FLAGSHIP_AEROSOL)],
            lambda_ref=1e4 / THERMAL_NU0, **FLAGSHIP_MIE),
        surfaces=[jm.SurfaceDescriptor("CoxMunkSurface", [],
                                       {"wind_speed": 5.0})],
        polarization=J_IQUV,
        **flagship_params(n_spec, np.float32, nu0=THERMAL_NU0)))
    return jax_model, thermal_lin_model(n_spec, thermal=False)


def test_planck_spectra_match_jax():
    from vsmartmom_tpu import solar as jsolar
    from vsmartmom_tpu_torch import solar
    nu = np.arange(50.0, 3000.0, 10.0)
    for T in (200.0, 260.0, 300.0):
        assert _rel(solar.planck_spectrum_wn(T, nu),
                    jsolar.planck_spectrum_wn(T, nu)) <= 1e-12
        assert _rel(solar.planck_spectrum_wl(T, 1e4 / nu),
                    jsolar.planck_spectrum_wl(T, 1e4 / nu)) <= 1e-12


@pytest.mark.parametrize("scene", ["tir", "thermal_lin"])
def test_add_thermal_emission_matches_jax(scene):
    """The per-layer Planck source (Nz, nSpec) at the profile's own layer
    temperatures, on the TIR scene and on the thermal Jacobian scene's
    host build (whose aerosol optics and profile are held too)."""
    from vsmartmom_tpu.solar import add_thermal_emission as jax_add
    from vsmartmom_tpu_torch import add_thermal_emission
    jax_model, model = _tir_models() if scene == "tir" \
        else _thermal_lin_models(8)
    assert jax_add(jax_model) is jax_model
    assert add_thermal_emission(model) is model
    jb, b = jax_model.bands[0], model.bands[0]
    assert b.thermal_b.shape == (model.profile.nz, b.n_spec)
    assert _rel(b.thermal_b, jb.thermal_b) <= 1e-12
    assert _rel(model.profile.T, jax_model.profile.T) <= 1e-12
    for a, ja in zip(b.aerosols, jb.aerosols):
        assert _rel(a.tau_profile, ja.tau_profile) <= 1e-12
        assert abs(a.ssa - ja.ssa) <= 1e-12
    if scene == "thermal_lin":
        # The mid-wave window: the Planck source is of the solar term's
        # order (F0 = 1), not the ~1e-34 of the flagship's 515 nm.
        assert 1e-2 < b.thermal_b.max() < 10.0


@pytest.mark.parametrize("include_solar", [True, False])
def test_include_solar_sets_f0(include_solar):
    """``include_solar=False`` zeroes F0 (and only F0), as in JAX."""
    from vsmartmom_tpu.solar import add_thermal_emission as jax_add
    from vsmartmom_tpu_torch import add_thermal_emission
    jax_model, model = _tir_models(include_solar=include_solar)
    jax_add(jax_model)
    add_thermal_emission(model)
    j_inp, _ = jax_model.build_band(0)
    inp, config = model.build_band(0, device="cpu")
    assert config.n_sources == 2
    for f in inp._fields:
        a, b = getattr(inp, f).numpy(), np.asarray(getattr(j_inp, f))
        assert a.shape == b.shape, f
        if np.abs(b).max() == 0:
            assert np.abs(a).max() == 0, f
        else:
            assert _rel(a, b) <= 1e-12, f
    assert bool((inp.F0 != 0).any()) == include_solar


def test_plain_k1prime_matches_jax_jvp():
    """The plain K1' against jax.jvp through the JAX band kernel at K = 2
    (interpret mode), P = 2 tangents of (Z_pp, Z_mp, tau, scat_w, F0); the
    thermal column's tangent comes through tau and scat_w."""
    import jax
    import jax.numpy as jnp
    from vsmartmom_tpu.ops.fused_band import fused_moment as jax_moment
    from vsmartmom_tpu_torch.ops.fused_band import band_operands
    from vsmartmom_tpu_torch.ops.fused_lin import (
        moment_multitangent_reference, operand_tangents)

    rng = np.random.default_rng(11)
    nz, C, s, ns, nq, P = 2, 2, 3, 2, 3, 2
    N, ndoubl, sched, ns_inter = ns * nq, 3, (0, 1, 2), 2
    const = dict(qp=np.tile(np.array([0.2, 0.55, 0.9])[:, None],
                            (1, ns)).ravel(),
                 wct=np.tile(np.array([0.3, 0.4, 0.3])[:, None],
                             (1, ns)).ravel(),
                 d_vec=np.tile(np.array([1.0, -1.0]), nq),
                 is_I=(np.arange(N) % ns == 0).astype(float),
                 in_blk=((np.arange(N) >= 2) & (np.arange(N) < 4))
                 .astype(float))
    prim = dict(Z_pp=rng.uniform(0.1, 1, (C, N, N)),
                Z_mp=rng.uniform(0.1, 1, (C, N, N)),
                tau=rng.uniform(0.05, 0.3, (nz, s)),
                scat_w=rng.uniform(0.01, 0.04, (nz, C, s)),
                F0=rng.uniform(0.5, 1, (ns, s)))
    planck = rng.uniform(0.1, 0.5, (nz, s))
    tan = {k: rng.normal(size=(P,) + v.shape) * 0.1 * np.abs(v).mean()
           for k, v in prim.items()}
    mu0 = float(const["qp"][2])
    kw = dict(ndoubl=ndoubl, n_stokes=ns, i_mu0_start=2, n_sources=2)

    def args(Z_pp, Z_mp, tau, scat_w, F0, qp, wct, d_vec, is_I, in_blk,
             xp):
        """The band kernel's 15 operands from the differentiable inputs:
        the precursors and the thermal source (2 pi (1 - ssa) B) of tau and
        scat_w, as ``core.solver.moment_args`` builds them."""
        dtau = tau / 2.0 ** ndoubl
        tau_sum = xp.concatenate([tau[:1] * 0, xp.cumsum(tau, 0)[:-1]], 0)
        th = 2.0 * np.pi * (1.0 - scat_w.sum(1) / tau) * xp.asarray(
            planck, dtype=tau.dtype)
        return (Z_pp, Z_mp, tau, scat_w,
                xp.expm1(-dtau[:, :, None] / qp[None, None, :]),
                xp.expm1(-dtau / mu0), xp.exp(-tau_sum / mu0),
                xp.exp(-dtau / mu0), th, F0, qp, wct, d_vec, is_I, in_blk)

    f32 = jnp.float32
    jprim = tuple(jnp.asarray(v, f32) for v in (*prim.values(),
                                                *const.values()))

    def jfn(*x):
        return jax_moment(*args(*x, xp=jnp), ns_sched=sched,
                          ns_inter=ns_inter, block=8, interpret=True, **kw)

    jvp = jax.jit(lambda *d: jax.jvp(jfn, jprim, d))
    ref_t = []
    for q in range(P):
        d = tuple(jnp.asarray(tan[k][q], f32) for k in prim) + tuple(
            jnp.zeros_like(x) for x in jprim[len(prim):])
        ref_p, t = jvp(*d)
        ref_t.append([np.asarray(x) for x in t])
    ref_p = [np.asarray(x) for x in ref_p]

    t32 = torch.float32
    tconst = tuple(torch.as_tensor(v, dtype=t32) for v in const.values())

    def tprep(*x):
        return band_operands(*args(*x, *tconst, xp=torch), **kw)
    tprim = tuple(torch.as_tensor(v, dtype=t32) for v in prim.values())
    out_p, out_t = moment_multitangent_reference(
        tprep(*tprim), operand_tangents(tprep, tprim, tuple(
            torch.as_tensor(tan[k], dtype=t32) for k in prim)),
        sched, ns_inter)
    assert out_p[4].shape == (s, N, 2) and out_t[4].shape == (P, s, N, 2)
    for a, b in zip(out_p, ref_p):
        assert _rel(a.numpy(), b) <= 2e-5
    for q in range(P):
        for i, (a, b) in enumerate(zip(out_t, ref_t[q])):
            assert np.abs(b).max() > 0
            assert _rel(a[q].numpy(), b) <= 2e-5, (q, i)
    # The thermal column (m = 0 here) carries signal and a tangent.
    assert np.abs(ref_p[5][..., 1]).max() > 0
    assert np.abs(ref_t[0][5][..., 1]).max() > 0


def test_fused_thermal_route_matches_jvp_route():
    """rt_solve_multitangent at K = 2 (the plain K2 on the CPU) against the
    jvp route through rt_solve, both f32 on the small thermal scene with
    the scene-probed Newton-Schulz schedule: R, T and each parameter's dR
    2e-5 of their max; dT 2e-5 of the stack's max (the profile-shape
    parameters' dT is ~1e-7 of the others')."""
    from vsmartmom_tpu_torch.core.linearization import (build_tangent_inputs,
                                                        default_layout,
                                                        rt_solve_jvp)
    from vsmartmom_tpu_torch.flagship import lin_thermal_model
    from vsmartmom_tpu_torch.ops.fused_lin import (fused_moment_multitangent,
                                                   rt_solve_multitangent)
    model = lin_thermal_model()
    model.params.fused = True
    inputs, config, tangents = build_tangent_inputs(
        model, 0, default_layout(model), device="cpu")
    assert config.fused and config.n_sources == 2 and config.ns_sched
    before = fused_moment_multitangent.launches
    out = rt_solve_multitangent(inputs, tangents, config, "cpu")
    assert fused_moment_multitangent.launches == before     # CPU: plain K2
    ref = rt_solve_jvp(inputs, tangents,
                       dataclasses.replace(config, fused=False), "cpu")
    for a, b in zip(out[:2], ref[:2]):
        assert _rel(a, b) <= 2e-5
    for q in range(len(tangents)):
        assert _rel(out[2][q], ref[2][q]) <= 2e-5, q
    assert _rel(out[3], ref[3]) <= 2e-5


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_lin import KEYS, THERMAL_REF_PATH, jax_rt_run_lin
    out = jax_rt_run_lin("coxmunk", thermal=True)
    np.savez(THERMAL_REF_PATH, **{k: out[k] for k in KEYS})
    print(f"wrote {THERMAL_REF_PATH}")
