"""The canopy surface of the port (``surfaces/canopy.py``, the canopy
branch of ``core/model._surface_arrays`` and ``_canopy_atm_tau``, the
spectrally resolved surface operators in ``core/solver.py`` and the
``canopy:`` section of the front end) against the JAX package on the CPU.
Tolerances, relative to max|ref|:

* ``ross_psi``, ``project_G`` (every LAD), ``bilambertian_phase`` /
  ``bilambertian_greek``, ``lad_phase_fourier``, ``_elemental_directional``
  and ``canopy_surface_arrays`` (scalar and spectral leaves,
  ``lai_fractions`` with a non-spherical LAD, ``include_atm``): 1e-10;
* the small canopy scene (``flagship.canopy_ref_model``: spectral leaves,
  RPV soil, SIF, solar spectrum; 4-D surface) through ``rt_run_full``,
  f64: 1e-9 against a fresh JAX run, which sends every moment down the
  full path; the port's Beer-law tail above ``m_scat`` with the 4-D
  surface 1e-9 against it; the stored ``data/surfaces_ref_f64.npz``
  entries against the fresh run 1e-12 (``python tests/test_torch_canopy.py``
  rewrites the whole file, PYTHONPATH=.);
* LAI = 0 equals the bare soil (1e-12); the ``canopy:`` section parses to
  the JAX package's ``CanopySurface`` fields exactly.

The JAX package's ``canopy_surface_arrays`` runs its jnp kernels op by op:
the arrays cases use a coarse ``dtau_max`` and few streams.
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
from surface_inputs import (REF_NAMES, REF_PATH, jax_model,  # noqa: E402
                            jax_reference, rel, stored)

LADS = ("spherical", "uniform", "planophile", "erectophile", "plagiophile",
        "extremophile")


def test_projection_and_phase_match_jax():
    import vsmartmom_tpu.surfaces.canopy as J
    import vsmartmom_tpu_torch.surfaces.canopy as P
    mu = np.linspace(0.02, 1.0, 17)
    np.testing.assert_allclose(P.ross_psi(mu, mu[::-1]),
                               J.ross_psi(mu, mu[::-1]), rtol=1e-10,
                               atol=1e-14)
    for lad in LADS:
        g = J.project_G(mu, lad)
        assert rel(P.project_G(mu, lad), g) <= 1e-10, lad
    x = np.linspace(-1.0, 1.0, 41)
    for rho, tau in ((0.4, 0.05), (0.05, 0.45), (0.0, 0.3), (0.0, 0.0)):
        np.testing.assert_allclose(P.bilambertian_phase(x, rho, tau),
                                   J.bilambertian_phase(x, rho, tau),
                                   rtol=1e-10, atol=1e-14)
        a, b = P.bilambertian_greek(rho, tau, 12), \
            J.bilambertian_greek(rho, tau, 12)
        for f in ("alpha", "beta", "gamma", "delta", "epsilon", "zeta"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=1e-10, atol=1e-14)


def test_lad_phase_fourier_matches_jax():
    import vsmartmom_tpu.surfaces.canopy as J
    import vsmartmom_tpu_torch.surfaces.canopy as P
    mu = np.array([0.1, 0.4, 0.7, 0.95])
    for out, ref in zip(P.lad_phase_fourier("erectophile", 0.3, 0.2, mu, 3),
                        J.lad_phase_fourier("erectophile", 0.3, 0.2, mu, 3)):
        assert rel(out, ref) <= 1e-10
    Z = np.arange(16.0).reshape(4, 4)
    np.testing.assert_array_equal(P._scalar_to_super(Z, 3),
                                  J._scalar_to_super(Z, 3))


def test_elemental_directional_matches_jax():
    """The directional elemental on random weighted Z (seed 15) at a
    planophile G(mu): r, t and both sources, 1e-10."""
    import vsmartmom_tpu.surfaces.canopy as J
    import vsmartmom_tpu_torch.surfaces.canopy as P
    rng = np.random.default_rng(15)
    ns, nq, nb = 3, 4, 5
    N = ns * nq
    qp = np.repeat([0.15, 0.45, 0.8, 1.0], ns)
    wt = np.repeat([0.3, 0.35, 0.25, 0.1], ns)
    G_N = J.project_G(qp, "planophile")
    G0 = float(J.project_G(np.array([0.8]), "planophile")[0])
    wZ_pp, wZ_mp = rng.uniform(0.0, 1.0, (2, nb, N, N))
    F0 = rng.uniform(0.0, 1.0, (ns, nb))
    att = rng.uniform(0.5, 1.0, nb)
    args = (0.03, att, qp, wt, G_N, 0.8, G0, 2 * ns, ns, F0, 0.25)
    ref = J._elemental_directional(wZ_pp, wZ_mp, *args)
    out = P._elemental_directional(torch.as_tensor(wZ_pp),
                                   torch.as_tensor(wZ_mp), *args)
    for a, b in zip(out, ref):
        assert rel(a.numpy(), b) <= 1e-10


#: canopy_surface_arrays cases: (polarization, CanopySurface keywords,
#: within-canopy absorption).
GRID = np.array([650.0, 700.0, 720.0, 800.0])
SPECTRAL = dict(leaf_optics_grid=GRID,
                leaf_reflectance=np.array([0.05, 0.1, 0.3, 0.45]),
                leaf_transmittance=np.array([0.03, 0.08, 0.3, 0.45]),
                n_coarse=3)
ARRAY_CASES = {
    "scalar": ("Stokes_IQU", dict(LAI=2.0, n_layers=2), None),
    "spectral": ("Stokes_IQU", dict(LAI=2.0, n_layers=2, **SPECTRAL), None),
    "lai_fractions": ("Stokes_I", dict(LAI=3.0, n_layers=3,
                                       lai_fractions=(0.2, 0.5, 0.3),
                                       lad="erectophile", clumping_omega=0.8,
                                       **SPECTRAL), None),
    "include_atm": ("Stokes_IQU", dict(LAI=2.0, n_layers=2, include_atm=True,
                                       canopy_dp=50.0, **SPECTRAL),
                    np.array([0.0, 0.4, 1.5])),
}


def _canopy_arrays(pkg, case):
    """``canopy_surface_arrays`` of one case in package ``pkg`` over an
    RPV soil, 3 points at 13300-14500 cm^-1, nstreams 2, moments 0 and 1
    (the JAX package compiles its doubling scan at every sublayer and
    moment)."""
    import importlib
    M = importlib.import_module(f"{pkg}.core.model")
    C = importlib.import_module(f"{pkg}.surfaces.canopy")
    Q = importlib.import_module(f"{pkg}.utils.quadrature")
    S = importlib.import_module(f"{pkg}.scattering.stokes")
    pol_name, kw, atm_tau = ARRAY_CASES[case]
    pol = S.polarization_from_name(pol_name)
    quad = Q.rt_set_streams(2, 30.0, [0.0, 45.0], pol.n)
    nu = np.array([13300.0, 13900.0, 14500.0])
    n_m = 2
    soil = M.SurfaceDescriptor("rpvSurfaceScalar", [0.1, 0.1, 0.75, -0.1])
    soil_r, soil_j, soil_spec, _ = M._surface_arrays(
        soil, quad, pol.n, n_m, len(nu), pol=pol, nu_grid=nu)
    canopy = C.CanopySurface(soil=soil, dtau_max=1e-3, **kw)
    extra = {"device": "cpu"} if pkg.endswith("_torch") else {}
    return C.canopy_surface_arrays(canopy, quad, pol, n_m, nu, soil_r,
                                   soil_j, soil_spec, atm_tau=atm_tau,
                                   **extra)


@pytest.mark.parametrize("case", list(ARRAY_CASES))
def test_canopy_surface_arrays_match_jax(case):
    ref = _canopy_arrays("vsmartmom_tpu", case)
    ref = tuple(np.asarray(x) for x in ref)
    out = _canopy_arrays("vsmartmom_tpu_torch", case)
    np.testing.assert_array_equal(out[0], ref[0])
    assert out[1].shape == ref[1].shape and out[2].shape == ref[2].shape
    assert rel(out[1], ref[1]) <= 1e-10 and rel(out[2], ref[2]) <= 1e-10
    if case == "include_atm":           # a node per point of the band
        assert len(out[0]) == 3 and np.abs(out[2][0, 2]).max() \
            < np.abs(out[2][0, 0]).max()


@pytest.fixture(scope="module")
def jax_canopy():
    """A fresh JAX CPU f64 ``rt_run_full`` of ``canopy_ref_model``."""
    return jax_reference("canopy")


def _port_canopy(**kw):
    from vsmartmom_tpu_torch.flagship import canopy_ref_model
    return canopy_ref_model(np.float64, device="cpu", **kw)


def test_small_canopy_rt_run_full_matches_jax(jax_canopy):
    """The port's f64 plain path on the small canopy scene (spectral
    leaves: (n_m, 8, N, N) surface operators) in one solve and in
    chunks of 3 points against the JAX package's: 1e-9."""
    from vsmartmom_tpu_torch.core.solver import rt_run_full
    model = _port_canopy()
    inputs, _ = model.build_band(0, device="cpu")
    assert inputs.surf_r.dim() == 4 and inputs.surf_r.device.type == "cpu"
    for chunk in (None, 3):
        out = rt_run_full(model, device="cpu", spectral_chunk=chunk)
        for k in ("R", "T", "hdr", "bhr_uw", "bhr_dw"):
            assert rel(out[k], jax_canopy[f"canopy_{k}"]) <= 1e-9, (chunk, k)


def test_beer_tail_with_a_spectral_surface_matches_the_full_path(
        jax_canopy):
    """With the 4-D surface the port runs moments m_scat+1..m_max on the
    Beer-law tail; the JAX package runs them down the full path. Both
    agree (1e-9), and the port's own full path (m_scat = -1) too."""
    from vsmartmom_tpu_torch.core.solver import rt_solve
    inputs, config = _port_canopy().build_band(0, device="cpu")
    assert 0 <= config.m_scat < config.m_max
    for cfg in (config, dataclasses.replace(config, m_scat=-1)):
        out = rt_solve(inputs, cfg, "cpu")
        for k in ("R", "T", "hdr"):
            assert rel(out[k].numpy(), jax_canopy[f"canopy_{k}"]) <= 1e-9


def test_stored_reference_matches_a_fresh_jax_run(jax_canopy):
    ref = stored()
    for k, v in jax_canopy.items():
        assert rel(ref[k], v) <= 1e-12, k


def test_lai_zero_equals_the_soil():
    """LAI = 0 reduces to the bare RPV soil scene (canopy-top bookkeeping
    of the direct slot): R, T, hdr and the fluxes within 1e-12."""
    from vsmartmom_tpu_torch.core.solver import rt_run_full
    canopy = rt_run_full(_port_canopy(LAI=0.0), device="cpu")
    soil = rt_run_full(_port_canopy(soil_only=True), device="cpu")
    for k, v in soil.items():
        assert rel(canopy[k], v) <= 1e-12, k


def test_include_atm_build_routes_the_canopy_absorption():
    """A canopy with ``include_atm`` and ``canopy_dp`` at the model level:
    ``_canopy_atm_tau`` from the bottom layer's tau_abs against the JAX
    package's (1e-12), and ``build_band``'s surface arrays those of
    ``canopy_surface_arrays`` with that absorption (1e-14; that
    function against the JAX package's: the include_atm case above)."""
    from vsmartmom_tpu_torch.core.model import (Parameters,
                                                SurfaceDescriptor,
                                                _canopy_atm_tau,
                                                _surface_arrays,
                                                model_from_parameters)
    from vsmartmom_tpu_torch.flagship import CANOPY_SOIL, flagship_params
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_I
    from vsmartmom_tpu_torch.surfaces.canopy import (CanopySurface,
                                                     canopy_surface_arrays)
    canopy = CanopySurface(
        soil=SurfaceDescriptor(CANOPY_SOIL[0], list(CANOPY_SOIL[1])),
        LAI=2.0, n_layers=2, include_atm=True, canopy_dp=80.0,
        dtau_max=1e-3, **SPECTRAL)
    kw = flagship_params(3, np.float64, nstreams=2, nz=3)
    kw["spec_bands"] = [np.array([13300.0, 13900.0, 14500.0])]
    model = model_from_parameters(Parameters(
        surfaces=[SurfaceDescriptor("CanopySurface", [],
                                    {"_surface_obj": canopy})],
        polarization=STOKES_I, **kw), device="cpu")
    band = model.bands[0]
    band.tau_abs[:, -1] = [0.0, 0.3, 1.5]
    jm = jax_model(model)
    jm.bands[0].tau_abs = band.tau_abs.copy()
    from vsmartmom_tpu.core.model import _canopy_atm_tau as jax_atm_tau
    atm = _canopy_atm_tau(band, model.profile)
    assert rel(atm, jax_atm_tau(jm.bands[0], jm.profile)) <= 1e-12
    assert atm[0] == 0.0 and 0.0 < atm[1] < atm[2]
    inputs, config = model.build_band(0, device="cpu")
    quad, pol = model.quad, model.params.polarization
    n_m = config.m_max + 1
    soil = _surface_arrays(canopy.soil, quad, pol.n, n_m, 3, pol=pol,
                           nu_grid=band.nu_grid)
    nodes, R, J = canopy_surface_arrays(canopy, quad, pol, n_m,
                                        band.nu_grid, *soil[:3],
                                        atm_tau=atm, device="cpu")
    np.testing.assert_array_equal(nodes, band.nu_grid)
    # interp_surface_operators at the nodes themselves: lo + w (hi - lo)
    assert rel(inputs.surf_r.numpy(), R) <= 1e-14
    assert rel(inputs.surf_j_m.numpy(), J) <= 1e-14


def _scene(canopy):
    return {"radiative_transfer": {
        "spec_bands": ["[13300.0 13900.0]"],
        "surface": ["rpvSurfaceScalar(0.1, 0.1, 0.75, -0.1)"],
        "polarization_type": "Stokes_IQU()", "nstreams": 3, "depol": -1,
        "float_type": "Float64", "quadrature_type": "RadauQuad()"},
        "canopy": canopy,
        "geometry": {"sza": 30, "vza": [0, 30, 60], "vaz": [0, 0, 0],
                     "obs_alt": 1000.0},
        "atmospheric_profile": {"T": [250.0, 270.0, 285.0],
                                "p": [100.0, 500.0, 800.0, 1000.0]}}


def test_canopy_section_parses_to_jax_fields():
    """The ``canopy:`` section (clumping as a number, a string and a
    table, ``lai_fractions``, ``include_atm`` with ``canopy_dp``, a LAD,
    spectral leaf optics, a soil of its own) gives the JAX package's
    ``CanopySurface`` fields; Chen-Leblanc clumping is refused by both."""
    from vsmartmom_tpu.io.yaml_input import parameters_from_dict as jax_pd
    from vsmartmom_tpu_torch.io.yaml_input import parameters_from_dict
    spectral = {"leaf_optics_grid": [650.0, 700.0, 800.0],
                "leaf_reflectance": [0.05, 0.2, 0.45],
                "leaf_transmittance": [0.03, 0.2, 0.45]}
    cases = [
        {"LAI": 3.0, "n_layers": 3, "clumping": 0.9, "LAD": "Erectophile",
         "lai_fractions": [0.2, 0.3, 0.5], **spectral},
        {"LAI": 2.0, "n_layers": 2, "clumping": "no-clumping",
         "include_atm": True, "canopy_dp": 60.0,
         "soil": "LambertianSurfaceScalar(0.2)"},
        {"clumping": {"type": "constant", "Omega": 0.7}},
    ]
    for c in cases:
        port, ref = parameters_from_dict(_scene(c)), jax_pd(_scene(c))
        assert port.quadrature == ref.quadrature == "RadauQuad"
        a, b = (p.surfaces[0].kwargs["_surface_obj"] for p in (port, ref))
        assert port.surfaces[0].kind == ref.surfaces[0].kind \
            == "CanopySurface"
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name == "soil":
                assert (x.kind, x.args, x.kwargs) == (y.kind, y.args,
                                                      y.kwargs)
            elif isinstance(y, np.ndarray) or isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y, f.name
    bad = _scene({"clumping": {"type": "ChenLeblanc"}})
    for fn in (parameters_from_dict, jax_pd):
        with pytest.raises(ValueError, match="clumping"):
            fn(bad)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    ref = {}
    for name in REF_NAMES:
        ref.update(jax_reference(name))
    np.savez(REF_PATH, **ref)
    print(f"wrote {REF_PATH}")
