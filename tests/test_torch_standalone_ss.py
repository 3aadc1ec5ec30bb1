"""The port's standalone exact single-scatter solver
(``vsmartmom_tpu_torch/standalone_ss.py``) against the JAX package on the
CPU in f64. Tolerances, relative to max|ref|:

* the host phase tables (``exact_phase_function`` of every contributor
  kind, ``phase_first_column`` with the scattering-plane rotation,
  ``_azimuth_average_phase``): 1e-12;
* ``run_exact_ss`` (the four paths and the total) and
  ``run_exact_ss_with_jacobians`` (d_tau, d_ssa, d_albedo: the port's
  ``torch.func.jacfwd`` against ``jax.jacfwd``) for every path set, over
  Lambertian and Cox-Munk, at n_stokes 1 and 3: 1e-10;
* the stored ``exact_all`` / ``exact_cm`` entries of
  ``data/surfaces_ref_f64.npz``: the port 1e-10, a fresh JAX run 1e-12.

The configs carry Rayleigh, Henyey-Greenstein, Greek-coefficient and
absorbing contributors over 4 layers and 3 points (the tau Jacobian is
dense in the spectral axis).
"""

import importlib

import numpy as np
import pytest

from port_threads import _one_thread  # noqa: F401  (autouse)
from surface_inputs import jax_reference, rel, stored

PATH_SETS = ("path1", "path2", "path3", "path4", "paths_1_2", "all",
             "all_four")
PATHS = ("path1", "path2", "path3", "path4", "total")


def _config(pkg, surface, n_stokes, seed=16):
    """An ``ExactSSConfig`` of package ``pkg``: 4 layers, 3 points, the
    contributors' optical depths from ``seed``; geometry of three views."""
    X = importlib.import_module(f"{pkg}.standalone_ss")
    mie = importlib.import_module(f"{pkg}.scattering.mie")
    rng = np.random.default_rng(seed)
    tau = rng.uniform(0.005, 0.08, (4, 4, 3))
    geo = X.SSGeometry(mu0=0.8, mu_v=np.array([0.95, 0.6, 0.25]),
                       dphi=np.array([0.2, 1.7, 3.1]))
    surf = X.LambertianSSSurface(albedo=np.array([0.1, 0.2, 0.3])) \
        if surface == "lambertian" else X.CoxMunkSSSurface(wind_speed=6.0)
    return X.ExactSSConfig(
        geometry=geo, surface=surf, n_stokes=n_stokes, contributors=[
            X.RayleighSSContributor(tau=tau[0], depol=0.03),
            X.HGAerosolSSContributor(g=0.7, ssa=0.9, tau=tau[1]),
            X.GreekCoefsSSContributor(
                greek_coefs=mie.hg_greek_coefficients(0.5, 16), ssa=0.8,
                tau=tau[2]),
            X.AbsorptionSSContributor(tau=tau[3])])


def test_host_tables_match_jax():
    import vsmartmom_tpu.standalone_ss as J
    import vsmartmom_tpu_torch.standalone_ss as P
    cos_t = np.linspace(-1.0, 1.0, 11)
    mu_a = np.linspace(0.1, 1.0, 4)[None, :]
    mu_b = np.array([[0.3], [0.8]])
    for i, (c, d) in enumerate(zip(_config("vsmartmom_tpu_torch", "lambertian",
                                           3).contributors,
                                   _config("vsmartmom_tpu", "lambertian",
                                           3).contributors)):
        assert rel(P.exact_phase_function(c, cos_t),
                   J.exact_phase_function(d, cos_t)) <= 1e-12, i
        assert rel(P._azimuth_average_phase(c, mu_a, mu_b, 32),
                   J._azimuth_average_phase(d, mu_a, mu_b, 32)) <= 1e-12, i
    from vsmartmom_tpu.scattering.greek import greek_rayleigh as jax_gr
    from vsmartmom_tpu_torch.scattering.greek import greek_rayleigh
    mu_v, dphi = np.array([0.9, 0.5, 0.2]), np.array([0.0, 1.0, 2.5])
    for ns in (1, 2, 3):
        assert rel(P.phase_first_column(greek_rayleigh(0.03), 0.7, mu_v,
                                        dphi, ns),
                   J.phase_first_column(jax_gr(0.03), 0.7, mu_v, dphi,
                                        ns)) <= 1e-12


@pytest.mark.parametrize("surface", ["lambertian", "coxmunk"])
@pytest.mark.parametrize("n_stokes", [1, 3])
def test_paths_and_jacobians_match_jax(surface, n_stokes):
    """Every path set: the four paths and the total, and the Jacobians of
    the total in each contributor's tau, the ssa's and the albedo."""
    import vsmartmom_tpu.standalone_ss as J
    import vsmartmom_tpu_torch.standalone_ss as P
    jc = _config("vsmartmom_tpu", surface, n_stokes)
    pc = _config("vsmartmom_tpu_torch", surface, n_stokes)
    for paths in PATH_SETS:
        res, jac = J.run_exact_ss_with_jacobians(jc, paths)
        ref = {k: np.asarray(res[k]) for k in PATHS}
        ref_jac = {k: np.asarray(v) for k, v in jac.items()}
        out, out_jac = P.run_exact_ss_with_jacobians(pc, paths, device="cpu")
        assert out["metadata"] == res["metadata"]
        for k in PATHS:
            if np.abs(ref[k]).max() == 0:
                assert np.abs(out[k]).max() == 0, (paths, k)
            else:
                assert rel(out[k], ref[k]) <= 1e-10, (paths, k)
        assert out_jac.keys() == ref_jac.keys()
        for k, v in ref_jac.items():
            assert out_jac[k].shape == v.shape, (paths, k)
            if np.abs(v).max() == 0:
                assert np.abs(out_jac[k]).max() == 0, (paths, k)
            else:
                assert rel(out_jac[k], v) <= 1e-10, (paths, k)
    with pytest.raises(ValueError, match="paths"):
        P.run_exact_ss(pc, "path5", device="cpu")


@pytest.mark.parametrize("name", ["exact_all", "exact_cm"])
def test_stored_references(name):
    from vsmartmom_tpu_torch.flagship import surfaces_ref_outputs
    ref, fresh = stored(), jax_reference(name)
    out = surfaces_ref_outputs(name, device="cpu")
    assert out.keys() == fresh.keys()
    for k, v in fresh.items():
        assert rel(ref[k], v) <= 1e-12, k
        if np.abs(v).max() > 0:
            assert rel(out[k], v) <= 1e-10, k
        else:
            assert np.abs(out[k]).max() == 0, k
