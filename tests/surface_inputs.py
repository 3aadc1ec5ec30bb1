"""Shared inputs of the land-surface and single-scatter port tests: the JAX
package's twin of a port model or config (same plain data, the JAX
package's own classes), the stored reference ``data/surfaces_ref_f64.npz``
and the error measure. JAX outputs go to numpy at once."""

import dataclasses
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parents[1] / "vsmartmom_tpu_torch" / "data"
REF_PATH = DATA / "surfaces_ref_f64.npz"


def rel(a, b):
    """max|a - b| / max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def jax_surface(desc):
    """The JAX package's ``SurfaceDescriptor`` of a port one (a canopy's
    ``CanopySurface`` and its soil converted field by field)."""
    from vsmartmom_tpu.core.model import SurfaceDescriptor
    kwargs = dict(desc.kwargs)
    obj = kwargs.get("_surface_obj")
    if obj is not None and type(obj).__name__ == "CanopySurface":
        from vsmartmom_tpu.surfaces.canopy import CanopySurface
        fields = {f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(obj)}
        fields["soil"] = jax_surface(obj.soil)
        kwargs["_surface_obj"] = CanopySurface(**fields)
    return SurfaceDescriptor(desc.kind, list(desc.args), kwargs)


def jax_params(params):
    """The JAX package's ``Parameters`` of a port ``Parameters`` (no
    absorption parameters: the scenes of these tests have none)."""
    from vsmartmom_tpu.core.model import (Parameters, RTAerosol,
                                          ScatteringParams)
    from vsmartmom_tpu.scattering.stokes import polarization_from_name
    assert params.absorption_params is None
    kw = {f.name: getattr(params, f.name)
          for f in dataclasses.fields(params)}
    kw["surfaces"] = [jax_surface(s) for s in params.surfaces]
    kw["polarization"] = polarization_from_name(params.polarization.name)
    scat = params.scattering_params
    if scat is not None:
        kw["scattering_params"] = ScatteringParams(**{
            **dataclasses.asdict(scat),
            "rt_aerosols": [RTAerosol(**dataclasses.asdict(a))
                            for a in scat.rt_aerosols]})
    return Parameters(**kw)


def jax_model(model):
    """The JAX package's model of a port model: the same ``Parameters``,
    then each band's f0_spec, sif_spec and thermal_b copied over."""
    from vsmartmom_tpu.core.model import model_from_parameters
    jm = model_from_parameters(jax_params(model.params))
    for jb, b in zip(jm.bands, model.bands):
        for f in ("f0_spec", "sif_spec", "thermal_b"):
            setattr(jb, f, getattr(b, f))
    return jm


def jax_exact_config(data):
    """The JAX package's ``ExactSSConfig`` of ``flagship.exact_ss_config``'s
    plain data."""
    import vsmartmom_tpu.standalone_ss as X
    surf = X.LambertianSSSurface(albedo=data["albedo"]) \
        if data["surface"] == "lambertian" \
        else X.CoxMunkSSSurface(wind_speed=5.0)
    return X.ExactSSConfig(
        geometry=X.SSGeometry(**data["geometry"]), surface=surf,
        contributors=[X.RayleighSSContributor(**data["rayleigh"]),
                      X.HGAerosolSSContributor(**data["hg"])],
        n_stokes=data["n_stokes"])


def stored():
    """The stored JAX CPU f64 reference as a dict of arrays."""
    with np.load(REF_PATH) as f:
        return {k: f[k] for k in f.files}


def jax_reference(name):
    """One entry of the stored reference, computed afresh by the JAX
    package on the CPU in f64: {key: array}, keys prefixed by ``name``.

    * ``canopy``: ``rt_run_full`` of ``flagship.canopy_ref_model`` (R, T,
      hdr, bhr_uw, bhr_dw; spectrally resolved canopy, every moment on the
      full path);
    * ``ss_canopy``, ``ss_coxmunk``: ``rt_run_ss`` of that scene and of the
      small flagship over Cox-Munk (R, T, hem_R, hem_T);
    * ``exact_all``, ``exact_cm``: ``run_exact_ss_with_jacobians`` of
      ``flagship.exact_ss_config`` over Lambertian ("all" paths) and over
      Cox-Munk ("paths_1_2"), IQU (total and the paths, d_tau, d_ssa,
      d_albedo);
    * ``radau``: ``rt_run_full`` of the small Gauss-Radau flagship, IQU
      (R, T)."""
    from vsmartmom_tpu_torch import flagship as F
    small = dict(n_spec=F.SURF_REF_N_SPEC, nz=F.SURF_REF_NZ)
    if name in ("canopy", "ss_canopy"):
        model = jax_model(F.canopy_ref_model(np.float64, device="cpu"))
    elif name == "ss_coxmunk":
        model = jax_model(F.flagship_model(
            dtype=np.float64, nstreams=F.SURF_REF_NSTREAMS, **small))
    elif name == "radau":
        model = jax_model(F.radau_model(
            dtype=np.float64, nstreams=F.SURF_REF_NSTREAMS, **small))
    if name in ("canopy", "radau"):
        from vsmartmom_tpu.core.solver import rt_run_full
        out = rt_run_full(model)
        keys = ("R", "T", "hdr", "bhr_uw", "bhr_dw") if name == "canopy" \
            else ("R", "T")
        return {f"{name}_{k}": np.asarray(out[k]) for k in keys}
    if name.startswith("ss_"):
        from vsmartmom_tpu.core.singlescatter import rt_run_ss
        return {f"{name}_{k}": np.asarray(v)
                for k, v in rt_run_ss(model).items()}
    from vsmartmom_tpu.standalone_ss import run_exact_ss_with_jacobians
    surface, paths = {"exact_all": ("lambertian", "all"),
                      "exact_cm": ("coxmunk", "paths_1_2")}[name]
    _, data = F.exact_ss_config(surface=surface, **small)
    res, jac = run_exact_ss_with_jacobians(jax_exact_config(data), paths)
    out = {f"{name}_{k}": np.asarray(res[k])
           for k in ("path1", "path2", "path3", "path4", "total")}
    out.update({f"{name}_{k}": np.asarray(v) for k, v in jac.items()})
    return out


#: The entries of ``data/surfaces_ref_f64.npz``.
REF_NAMES = ("canopy", "ss_canopy", "ss_coxmunk", "exact_all", "exact_cm",
             "radau")


def entry_canopy(spectral=False):
    """A one-slab canopy (LAI 1.5, ``dtau_max`` 1: no doubling) over a
    Lambertian soil, with scalar leaf optics ((n_m, N, N) operators) or,
    with ``spectral``, leaf optics on a grid (a 4-D surface)."""
    from vsmartmom_tpu_torch.core.model import SurfaceDescriptor
    from vsmartmom_tpu_torch.surfaces.canopy import CanopySurface
    kw = dict(leaf_optics_grid=np.array([500.0, 700.0, 800.0]),
              leaf_reflectance=np.array([0.1, 0.2, 0.45]),
              leaf_transmittance=np.array([0.05, 0.15, 0.45])) \
        if spectral else dict(leaf_reflectance=0.4, leaf_transmittance=0.3)
    return SurfaceDescriptor("CanopySurface", [], {"_surface_obj": CanopySurface(
        soil=SurfaceDescriptor("LambertianSurfaceScalar", [0.2]), LAI=1.5,
        n_layers=1, dtau_max=1.0, **kw)})


def entry_model(scene, spectral=False):
    """A port model of one small scene over the canopy of
    ``entry_canopy``, f64, nstreams 2: "lin" and "ms" the Jacobian scene
    (``flagship.lin_ref_params``) with a Henyey-Greenstein aerosol, "rrs",
    "stellar" (Stokes I, the dipped stellar spectrum) and "ms_rrs" the
    small scenes of the Raman references."""
    from vsmartmom_tpu_torch import flagship as F
    from vsmartmom_tpu_torch.core.model import (Parameters, RTAerosol,
                                                ScatteringParams,
                                                model_from_parameters)
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_I, STOKES_IQU
    pol, scat = STOKES_IQU, None
    if scene in ("lin", "ms"):
        kw = F.lin_ref_params(np.float64)
        scat = ScatteringParams(rt_aerosols=[RTAerosol(
            tau_ref=0.15, p0=700.0, sigma_p=60.0, phase_function_g=0.7,
            ssa=0.9)])
    elif scene == "rrs":
        kw = {**F.rrs_ref_params(), "float_type": np.float64}
    elif scene == "stellar":
        kw = {**F.stellar_ref_params(), "float_type": np.float64}
        pol = STOKES_I
    else:
        kw = {**F.ms_rrs_ref_params(), "float_type": np.float64}
    kw["nstreams"] = 2
    model = model_from_parameters(Parameters(
        surfaces=[entry_canopy(spectral)], polarization=pol,
        scattering_params=scat, **kw), device="cpu")
    if scene == "stellar":
        model.bands[0].f0_spec = F.stellar_f0_dip(model.bands[0].nu_grid)
    return model


def entry_run(pkg, scene, model):
    """(outputs, ...) of ``scene``'s entry point in package ``pkg`` on
    ``model`` (that package's), as numpy."""
    if pkg == "jax":
        from vsmartmom_tpu.core.inelastic import rt_run_inelastic
        from vsmartmom_tpu.core.linearization import rt_run_lin
        from vsmartmom_tpu.core.multisensor import rt_run_ms, rt_run_ms_rrs
        from vsmartmom_tpu.inelastic.stellar import rt_run_stellar
        kw = {}
    else:
        from vsmartmom_tpu_torch import (rt_run_inelastic, rt_run_lin,
                                         rt_run_ms, rt_run_ms_rrs,
                                         rt_run_stellar)
        kw = {"device": "cpu"}
    out = {"lin": lambda: rt_run_lin(model, **kw),
           "ms": lambda: rt_run_ms(model, [0, 2, 3], **kw),
           "rrs": lambda: rt_run_inelastic(model, mode="RRS", **kw),
           "stellar": lambda: rt_run_stellar(model, mode="sol_RRS", **kw),
           "ms_rrs": lambda: rt_run_ms_rrs(model, [0, 1, 2], mode="RRS",
                                           **kw)}[scene]()
    return tuple(np.asarray(x) for x in out)
