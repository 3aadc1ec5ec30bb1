"""The land surfaces, spectral Lambertian albedos and Gauss-Radau streams
of the port against the JAX package on the CPU. Tolerances, relative to
max|ref|:

* ``rpv_reflectance`` / ``rossli_reflectance`` on a grid of geometries:
  1e-12; ``core/model._surface_arrays`` of each kind (RPV, Ross-Li, and
  the Lambertian spectrum, Legendre and spline albedos): 1e-12;
* ``gaussradau`` and ``rt_set_streams_radau``: nodes and weights 1e-13;
* a small ``rt_run_full`` over each kind, and the flagship's column on
  Radau streams: f64 1e-9, f32 2e-5 (each package's own plain path at
  that dtype), the doubling counts equal (one scene sets
  ``dtau_min_floor``); the stored ``radau`` entries of
  ``data/surfaces_ref_f64.npz`` against a fresh JAX run 1e-12.

JAX outputs are converted with ``np.asarray`` before the torch side runs.
"""

import importlib

import numpy as np
import pytest

from port_threads import _one_thread  # noqa: F401  (autouse)
from surface_inputs import jax_params, jax_reference, rel, stored

#: Surface kinds: (kind, args, kwargs) of the SurfaceDescriptor.
KINDS = {
    "rpv": ("rpvSurfaceScalar", [0.1, 0.1, 0.75, -0.1], {}),
    "rossli": ("RossLiSurfaceScalar", [0.3, 0.05, 0.15], {}),
    "spectrum": ("LambertianSurfaceSpectrum", [[0.05, 0.1, 0.2, 0.35]], {}),
    "legendre": ("LambertianSurfaceLegendre", [0.2, 0.05, -0.02], {}),
    "spline": ("LambertianSurfaceSpline", [], {
        "grid": [660.0, 700.0, 720.0, 760.0],
        "albedo": [0.05, 0.1, 0.35, 0.45], "grid_unit": "nm"}),
}
NU = np.array([13300.0, 13700.0, 14100.0, 14500.0])


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.mark.parametrize("kind", ["rpv", "rossli"])
def test_brdf_reflectance_matches_jax(kind):
    J, P = (_mod(p, "surfaces.land_brdf")
            for p in ("vsmartmom_tpu", "vsmartmom_tpu_torch"))
    mu = np.linspace(0.05, 1.0, 7)
    phi = np.linspace(0.0, np.pi, 5)
    grid = (mu[:, None, None], mu[None, :, None], phi[None, None, :])
    args = KINDS[kind][1]
    if kind == "rpv":
        out = P.rpv_reflectance(P.RPVSurface(*args), *grid)
        ref = J.rpv_reflectance(J.RPVSurface(*args), *grid)
    else:
        out = P.rossli_reflectance(P.RossLiSurface(*args), *grid)
        ref = J.rossli_reflectance(J.RossLiSurface(*args), *grid)
    assert np.isfinite(out).all() and rel(out, ref) <= 1e-12


@pytest.mark.parametrize("kind", list(KINDS))
def test_surface_arrays_match_jax(kind):
    """surf_r, surf_j_m, surf_spec and surf_direct_m at IQU, nstreams 3,
    the band grid ``NU``."""
    out = []
    for pkg in ("vsmartmom_tpu", "vsmartmom_tpu_torch"):
        M = _mod(pkg, "core.model")
        pol = _mod(pkg, "scattering.stokes").polarization_from_name(
            "Stokes_IQU")
        quad = _mod(pkg, "utils.quadrature").rt_set_streams(
            3, 30.0, [0.0, 45.0], pol.n)
        name, args, kwargs = KINDS[kind]
        out.append([np.asarray(x) for x in M._surface_arrays(
            M.SurfaceDescriptor(name, args, kwargs), quad, pol.n, 6,
            len(NU), pol=pol, nu_grid=NU)])
    for a, b in zip(out[1], out[0]):
        assert a.shape == b.shape and rel(a, b) <= 1e-12
    if kind == "legendre":
        from vsmartmom_tpu.surfaces.lambertian import \
            lambertian_legendre_scale as jax_scale
        from vsmartmom_tpu_torch.surfaces.lambertian import \
            lambertian_legendre_scale
        c = np.array([0.2, 0.05, -0.02, 0.01])
        assert rel(lambertian_legendre_scale(c, 9), jax_scale(c, 9)) <= 1e-13


def test_radau_streams_match_jax():
    import vsmartmom_tpu.utils.quadrature as J
    import vsmartmom_tpu_torch.utils.quadrature as P
    for n in (1, 2, 5, 7):
        for a, b in zip(P.gaussradau(n), J.gaussradau(n)):
            assert rel(a, b) <= 1e-13
    for nstreams, sza, vza, ns in ((3, 30.0, [0.0, 45.0], 3),
                                   (8, 30.0, [60.0, 45.0, 30.0, 15.0, 0.0],
                                    4),
                                   (4, 57.0, [10.0, 70.0], 1)):
        q, r = (m.rt_set_streams_radau(nstreams, sza, vza, ns)
                for m in (P, J))
        for f in ("qp_mu", "wt_mu", "qp_mu_N", "wt_mu_N"):
            assert rel(getattr(q, f), getattr(r, f)) <= 1e-13, f
        assert (q.mu0, q.i_mu0, q.Nquad, q.Nstreams) == \
            (r.mu0, r.i_mu0, r.Nquad, r.Nstreams)
        assert q.wt_mu[q.i_mu0] > 0          # the solar cosine carries weight
    q = P.rt_set_streams_radau(8, 30.0, [60.0, 45.0, 30.0, 15.0, 0.0], 3)
    assert q.Nquad * 3 == 51


def _params(kind, dtype):
    from vsmartmom_tpu_torch.core.model import Parameters, SurfaceDescriptor
    from vsmartmom_tpu_torch.flagship import flagship_params, radau_params
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_IQU
    if kind == "radau":
        return radau_params(4, dtype, nstreams=3, nz=3)
    kw = flagship_params(len(NU), dtype, nstreams=2, nz=3)
    kw["spec_bands"] = [NU]
    if kind == "spectrum":
        kw["dtau_min_floor"] = 5e-3
    name, args, kwargs = KINDS[kind]
    return Parameters(surfaces=[SurfaceDescriptor(name, args, kwargs)],
                      polarization=STOKES_IQU, **kw)


@pytest.mark.parametrize("kind", [*KINDS, "radau"])
def test_rt_run_full_matches_jax(kind):
    """Each package's own build and plain solve of one small scene, f64
    and f32."""
    from vsmartmom_tpu.core.model import model_from_parameters as jax_build
    from vsmartmom_tpu.core.solver import rt_run_full as jax_run
    from vsmartmom_tpu_torch.core.model import model_from_parameters
    from vsmartmom_tpu_torch.core.solver import rt_run_full
    for dtype, tol in ((np.float64, 1e-9), (np.float32, 2e-5)):
        params = _params(kind, dtype)
        jm = jax_build(jax_params(params))
        ref = {k: np.asarray(v) for k, v in jax_run(jm).items()}
        model = model_from_parameters(params)
        assert model.build_band(0, "cpu")[1].ndoubl == \
            jm.build_band(0)[1].ndoubl
        out = rt_run_full(model, device="cpu")
        for k in ("R", "T", "hdr", "bhr_uw", "bhr_dw"):
            assert rel(out[k], ref[k]) <= tol, (dtype, k)
    if kind == "spectrum":
        from vsmartmom_tpu_torch.core.model import Parameters
        floorless = _params(kind, np.float64).__dict__ | \
            {"dtau_min_floor": None}
        assert model_from_parameters(Parameters(**floorless)).build_band(
            0, "cpu")[1].ndoubl > model.build_band(0, "cpu")[1].ndoubl
    if kind == "radau":
        fresh, ref = jax_reference("radau"), stored()
        for k, v in fresh.items():
            assert rel(ref[k], v) <= 1e-12, k
