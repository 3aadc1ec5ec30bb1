"""The port's multisensor solve (vsmartmom_tpu_torch/core/multisensor.py)
against the JAX package's, and its truth anchors.

* ``rt_solve_ms`` (device "cpu") against the JAX ``rt_solve_ms`` on one JAX
  ``build_band`` output carried across (``solver_inputs_from_numpy`` /
  ``solver_config_from_dict``), at every sensor level 0..nz, on the scenes of
  tests/test_multisensor.py: a 4-layer Stokes-I Lambertian column and its IQU
  twin. Tolerances, relative to max|ref|: 1e-9 in f64, 2e-5 in f32 (the
  port's gate 1: the frameworks sum products in another order).
* The port's own build of the flagship, ``flagship_model(n_spec=4,
  nstreams=2)``, against the JAX ``__graft_entry__._flagship_model`` at the
  same size, levels (0, 16, 33), f32.
* The kernel route's host side on the CPU: with ``config.fused`` the ladder
  goes through ``fused_doubling`` (its plain Newton-Schulz version on CPU
  tensors) and back through the unstar and parity step; it must give the
  plain (LU) route's answer.
* The truth anchors of tests/test_multisensor.py on the port: the TOA sensor
  reports rt_solve's (R, T), the BOA sensor's downwelling equals T, and a
  black surface gives exactly zero BOA upwelling.

JAX outputs are converted to numpy at once, before torch runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

NU = np.array([14000.0, 14010.0, 14020.0])
TOL = {np.float64: 1e-9, np.float32: 2e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _params(pkg, pol, albedo=0.3, nlay=4):
    """Parameters of the tests/test_multisensor.py scene in package
    ``pkg`` (the JAX package or the port; the same plain arguments)."""
    return pkg.Parameters(
        spec_bands=[NU],
        surfaces=[pkg.SurfaceDescriptor("LambertianSurfaceScalar", [albedo])],
        nstreams=4, polarization=pol, sza=45.0, vza=[20.0, 50.0],
        vaz=[0.0, 120.0], obs_alt=0.0, T=np.linspace(230.0, 290.0, nlay),
        p=np.linspace(100.0, 1013.0, nlay + 1), depol=0.0)


def _port_model(pol_name="STOKES_I", albedo=0.3, nlay=4, tau_tot=0.25):
    import vsmartmom_tpu_torch as pkg
    from vsmartmom_tpu_torch.scattering import stokes
    model = pkg.model_from_parameters(
        _params(pkg, getattr(stokes, pol_name), albedo, nlay))
    model.bands[0].tau_rayl[:] = tau_tot / nlay
    return model


@pytest.fixture(scope="module")
def jax_scenes():
    """JAX build_band output of the Stokes-I and the IQU scene."""
    from vsmartmom_tpu.core import model as jmodel
    from vsmartmom_tpu.scattering import stokes
    out = {}
    for name in ("STOKES_I", "STOKES_IQU"):
        model = jmodel.model_from_parameters(
            _params(jmodel, getattr(stokes, name)))
        model.bands[0].tau_rayl[:] = 0.25 / 4
        out[name] = model.build_band(0)
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("pol", ["STOKES_I", "STOKES_IQU"])
def test_rt_solve_ms_matches_jax(jax_scenes, pol, dtype):
    from vsmartmom_tpu.core.multisensor import rt_solve_ms as jax_solve_ms
    from vsmartmom_tpu_torch.core.multisensor import rt_solve_ms
    from vsmartmom_tpu_torch.core.types import (solver_config_from_dict,
                                                solver_inputs_from_numpy)
    inputs, config = jax_scenes[pol]
    config = dataclasses.replace(config, dtype=dtype)
    levels = tuple(range(config.nz + 1))
    ref = {k: np.asarray(v)
           for k, v in jax_solve_ms(inputs, config, levels).items()}
    out = rt_solve_ms(
        solver_inputs_from_numpy({f: np.asarray(getattr(inputs, f))
                                  for f in inputs._fields}, "cpu"),
        solver_config_from_dict(dataclasses.asdict(config)), levels, "cpu")
    for k in ("uwJ", "dwJ"):
        assert out[k].shape == (len(levels), 2, config.n_stokes, len(NU))
        assert _rel(out[k].numpy(), ref[k]) <= TOL[dtype], k


def test_flagship_build_matches_jax():
    from __graft_entry__ import _flagship_model
    from vsmartmom_tpu.core.multisensor import rt_run_ms as jax_run_ms
    from vsmartmom_tpu_torch import flagship_model, rt_run_ms
    levels = (0, 16, 33)
    ref = [np.asarray(x) for x in jax_run_ms(
        _flagship_model(n_spec=4, nstreams=2), levels)]
    out = rt_run_ms(flagship_model(n_spec=4, nstreams=2), levels,
                    device="cpu")
    for got, want in zip(out, ref):
        assert got.shape == want.shape == (3, 9, 4, 4)
        assert _rel(got, want) <= TOL[np.float32]


@pytest.mark.parametrize("pol", ["STOKES_I", "STOKES_IQU"])
def test_kernel_route_host_side_matches_plain_route(pol):
    from vsmartmom_tpu_torch.core.multisensor import rt_solve_ms
    from vsmartmom_tpu_torch.ops.fused_rt import fused_doubling
    inputs, config = _port_model(pol).build_band(0, device="cpu")
    assert not config.fused
    levels = tuple(range(config.nz + 1))
    plain = rt_solve_ms(inputs, config, levels, "cpu")
    before = fused_doubling.launches
    fused = rt_solve_ms(inputs, dataclasses.replace(config, fused=True),
                        levels, "cpu")
    assert fused_doubling.launches == before
    for k in ("uwJ", "dwJ"):
        assert _rel(fused[k], plain[k]) <= 1e-9, k


@pytest.mark.parametrize("pol", ["STOKES_I", "STOKES_IQU"])
def test_toa_sensor_equals_rt_solve(pol):
    from vsmartmom_tpu_torch.core.multisensor import rt_solve_ms
    from vsmartmom_tpu_torch.core.solver import rt_solve
    inputs, config = _port_model(pol).build_band(0, device="cpu")
    ref = rt_solve(inputs, config, "cpu")
    out = rt_solve_ms(inputs, config, (0,), "cpu")
    np.testing.assert_allclose(out["uwJ"][0], ref["R"], rtol=1e-10,
                               atol=1e-14)
    np.testing.assert_allclose(out["dwJ"][0], ref["T"], rtol=1e-10,
                               atol=1e-14)


def test_boa_downwelling_equals_T():
    from vsmartmom_tpu_torch import rt_run, rt_run_ms
    model = _port_model()
    _, T = rt_run(model, device="cpu")
    _, dwJ = rt_run_ms(model, [model.profile.nz], device="cpu")
    np.testing.assert_allclose(dwJ[0], T, rtol=1e-8, atol=1e-12)


def test_black_surface_boa_upwelling_zero():
    from vsmartmom_tpu_torch import rt_run_ms
    model = _port_model(albedo=0.0)
    uwJ, _ = rt_run_ms(model, [model.profile.nz], device="cpu")
    assert np.abs(uwJ[0]).max() == 0.0


def test_sensor_levels_outside_the_column_are_refused():
    from vsmartmom_tpu_torch import rt_run_ms
    model = _port_model()
    for level in (-1, model.profile.nz + 1):
        with pytest.raises(ValueError, match="outside"):
            rt_run_ms(model, [level], device="cpu")
