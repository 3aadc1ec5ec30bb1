"""The port's host model build against the JAX package's.

``vsmartmom_tpu_torch`` carries its own float64 NumPy copy of the setup
physics (quadrature, profile, depolarization, Greek coefficients, Z
supermatrices, surfaces, the Newton-Schulz schedule probe). Built from the
same arguments, its ``build_band`` must give the JAX package's arrays to
rounding (rtol 1e-12) and the same static facts, for the Cox-Munk and the
Lambertian flagship scene (nstreams = 4, nSpec = 8).
"""

import dataclasses

import numpy as np
import pytest

from port_threads import _one_thread  # noqa: F401  (autouse)

SURFACES = ["coxmunk", "lambertian"]


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if a.size == 0:
        return 0.0
    scale = np.max(np.abs(b))
    return float(np.max(np.abs(a - b)) / scale) if scale > 0 \
        else float(np.max(np.abs(a)))


@pytest.fixture(scope="module")
def builds():
    """{surface: ((jax inputs, jax config), (port inputs, port config))},
    both with the band kernel forced on so the NS schedule is probed."""
    from __graft_entry__ import _flagship_model
    from vsmartmom_tpu_torch import flagship_model
    out = {}
    for surface in SURFACES:
        jm = _flagship_model(n_spec=8, nstreams=4, surface=surface)
        jm.params.fused = True
        pm = flagship_model(n_spec=8, nstreams=4, surface=surface,
                            fused=True)
        out[surface] = (jm.build_band(0), pm.build_band(0, device="cpu"))
    return out


@pytest.mark.parametrize("surface", SURFACES)
def test_build_band_arrays(builds, surface):
    (j_inp, _), (p_inp, _) = builds[surface]
    for f in p_inp._fields:
        a, b = getattr(p_inp, f).numpy(), np.asarray(getattr(j_inp, f))
        assert a.shape == b.shape, f
        assert _rel(a, b) <= 1e-12, (f, _rel(a, b))


@pytest.mark.parametrize("surface", SURFACES)
def test_config_facts(builds, surface):
    (_, jc), (_, pc) = builds[surface]
    for k in ("N", "nquad", "n_spec", "nz", "ndoubl", "m_max", "m_scat",
              "vza_idx", "i_mu0", "n_sources", "n_stokes"):
        assert getattr(pc, k) == getattr(jc, k), k
    assert pc.dtype == jc.dtype == np.float32


@pytest.mark.parametrize("surface", SURFACES)
def test_probed_ns_schedule(builds, surface):
    (_, jc), (_, pc) = builds[surface]
    assert pc.fused and jc.fused
    assert len(pc.ns_sched) == pc.ndoubl
    assert pc.ns_sched == jc.ns_sched and pc.ns_inter == jc.ns_inter
    assert 0 in pc.ns_sched                 # seed-only steps are scheduled


def test_cpu_default_strategy_is_plain():
    from vsmartmom_tpu_torch import flagship_model
    _, cfg = flagship_model(n_spec=8, nstreams=4).build_band(0, device="cpu")
    assert not cfg.fused and cfg.ns_sched == ()


def test_tms_correction_matches_jax():
    from vsmartmom_tpu.surfaces import coxmunk as jcm
    from vsmartmom_tpu_torch.surfaces import coxmunk as pcm
    rng = np.random.default_rng(3)
    tau = rng.uniform(0.05, 0.4, 5)
    vza = [60.0, 30.0, 0.0, 45.0]
    vaz = [180.0, 0.0, 0.0, 90.0]
    for ns in (1, 3, 4):
        a = pcm.tms_correction(pcm.CoxMunkSurface(wind_speed=7.0), ns, vza,
                               vaz, 0.8, tau, 15)
        b = jcm.tms_correction(jcm.CoxMunkSurface(wind_speed=7.0), ns, vza,
                               vaz, 0.8, tau, 15)
        np.testing.assert_array_equal(a, b)


def test_solver_config_round_trip(builds):
    """solver_config_from_dict keeps every field the port has and drops the
    TPU-only ones; a packed configuration is refused."""
    from vsmartmom_tpu_torch.core.types import solver_config_from_dict
    (_, jc), (_, pc) = builds["coxmunk"]
    d = dataclasses.asdict(dataclasses.replace(jc, pack=1))
    assert solver_config_from_dict(d) == pc
    with pytest.raises(ValueError):
        solver_config_from_dict({**d, "pack": 2})


@pytest.mark.parametrize("which", ["prt", "poly"])
def test_legendre_functions_match_jax(which):
    from vsmartmom_tpu.scattering import legendre as jl
    from vsmartmom_tpu_torch.scattering import legendre as pl
    x = np.random.default_rng(11).uniform(-0.99, 0.99, 7)
    if which == "prt":
        a = pl.compute_associated_legendre_PRT(x, 9)
        b = jl.compute_associated_legendre_PRT(x, 9)
    else:
        a, b = pl.compute_legendre_poly(x, 9), jl.compute_legendre_poly(x, 9)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_model_accessors_match_jax():
    """The reference API's accessors, which the published-table suites read
    (``model.mu0``, ``model.tau_rayl``), the banner and
    ``band_solver_args`` on the aerosol flagship, against the JAX model of
    the same scene."""
    from __graft_entry__ import _flagship_model
    from vsmartmom_tpu_torch import flagship_model
    jm = _flagship_model(n_spec=8, nstreams=4, aerosol=True)
    pm = flagship_model(n_spec=8, nstreams=4, aerosol=True)
    assert repr(pm) == repr(jm)
    assert "1 aerosol(s)" in repr(pm) and "CoxMunkSurface" in repr(pm)
    assert pm.mu0 == jm.mu0 == pm.quad.mu0
    assert len(pm.tau_rayl) == len(jm.tau_rayl) == 1
    assert pm.tau_rayl[0] is pm.bands[0].tau_rayl
    assert _rel(pm.tau_rayl[0], jm.tau_rayl[0]) <= 1e-12
    ((inputs, config),) = pm.band_solver_args(device="cpu")
    assert inputs.tau.device.type == "cpu" and config.N == 4 * pm.quad.Nquad


def _wide_model(fused=None):
    """A Rayleigh column over a 0.1-albedo floor, IQUV at nstreams 14
    (N = 68 with the sun's and view nodes: wider than K1 takes), 2 layers,
    2 points, f32."""
    from vsmartmom_tpu_torch import (Parameters, SurfaceDescriptor,
                                     model_from_parameters)
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_IQUV
    return model_from_parameters(Parameters(
        spec_bands=[np.array([13000.0, 13000.5])],
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar", [0.1])],
        nstreams=14, polarization=STOKES_IQUV, sza=40.0, vza=[10.0, 45.0],
        vaz=[30.0, 150.0], obs_alt=0.0, T=np.array([250.0, 280.0]),
        p=np.array([300.0, 700.0, 1013.0]), depol=0.0,
        float_type=np.float32, fused=fused))


def test_wide_scene_takes_the_plain_route(monkeypatch):
    """A scene wider than K1 takes (N > 64) with the strategy left
    automatic: build_band warns, naming K1, its limit and N, and picks the
    plain path, so rt_run equals an explicit fused=False run. The
    automatic choice is made as on the card (``types.auto_kernel``); on the
    CPU the band route would run the plain K1, which differs from the plain
    path in rounding. An explicit fused=True keeps the band route."""
    from vsmartmom_tpu_torch import rt_run
    from vsmartmom_tpu_torch.core import model as model_mod
    monkeypatch.setattr(model_mod, "auto_kernel", lambda dev, ft: True)
    model = _wide_model()
    with pytest.warns(UserWarning, match=r"K1 .* N <= 64; this scene has "
                                         r"N = 68"):
        _, config = model.build_band(0, device="cpu")
    assert not config.fused and config.N == 68
    with pytest.warns(UserWarning, match="K1"):
        out = rt_run(model, device="cpu")
    for a, b in zip(out, rt_run(_wide_model(fused=False), device="cpu")):
        assert np.array_equal(a, b)
    _, config = _wide_model(fused=True).build_band(0, device="cpu")
    assert config.fused
