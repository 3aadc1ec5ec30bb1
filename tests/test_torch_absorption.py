"""The port's gas absorption in its model build and the gas-VMR tangent
against the JAX package on the CPU, on the synthetic O2 A-band line list
of ``flagship.write_aband_par`` (the line sum and the tables are held in
tests/test_torch_absorption_lines.py, the CEFs in test_torch_voigt.py).
Tolerances, relative to max|ref|:

* the small gas scene's ``tau_abs`` / ``tau_abs_by_mol``, its VMR tangent,
  and a scene with a line list, a look-up table, CIA and MT_CKD through
  both builds: 1e-12;
* the port's f64 plain ``rt_run`` and ``rt_run_lin`` of the small A-band
  scene against the stored ``vsmartmom_tpu_torch/data/aband_ref_f64.npz``
  (the JAX package's ``rt_run_lin``: R, T, dR, dT, and dR_tms, the Cox-Munk
  TMS term's derivative through the JAX tangents' tau, which the port adds
  to every dR over the ocean and the JAX package leaves out; the port's dR
  is held against dR + dR_tms): 1e-9, and the stored file against a fresh
  JAX run: 1e-12 (so it cannot go stale); ``python
  tests/test_torch_absorption.py`` rewrites it;
* the port's VMR dR against its own central difference in f64, over a
  Lambertian floor and over the ocean: 2e-3 (the JAX package's
  TestGasJacobian gate).

JAX outputs are converted with ``np.asarray`` before the torch side runs.
"""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from port_threads import _one_thread  # noqa: F401  (autouse)

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
from absorption_inputs import o2_par, par, rel as _rel  # noqa: F401,E402
from vsmartmom_tpu_torch.flagship import (aband_absorption,  # noqa: E402
                                          aband_ref_params, write_aband_par)

DATA = Path(__file__).resolve().parents[1] / "vsmartmom_tpu_torch" / "data"
REF_PATH = DATA / "aband_ref_f64.npz"
REF_KEYS = ("R", "T", "dR", "dT")
STORED_KEYS = REF_KEYS + ("dR_tms",)


def _jax_absorption(par_path, **extra):
    from vsmartmom_tpu.core.model import AbsorptionParams
    return AbsorptionParams(**aband_absorption(par_path), **extra)


def jax_aband_model(par_path, surface="coxmunk"):
    """The JAX package's model of ``flagship.aband_ref_model``, from the same
    keywords."""
    from vsmartmom_tpu import model_from_parameters
    from vsmartmom_tpu.core.model import Parameters, SurfaceDescriptor
    from vsmartmom_tpu.scattering.stokes import STOKES_IQU
    surf = SurfaceDescriptor("CoxMunkSurface", [], {"wind_speed": 5.0}) \
        if surface == "coxmunk" else \
        SurfaceDescriptor("LambertianSurfaceScalar", [0.2])
    return model_from_parameters(Parameters(
        surfaces=[surf], polarization=STOKES_IQU,
        absorption_params=_jax_absorption(par_path),
        **aband_ref_params()))


def jax_aband_run(par_path):
    """JAX rt_run_lin (its plain jvp route on the CPU) of the small A-band
    scene, the f32 model's configuration solved in f64, with the band build
    and VMR tangent, as numpy. Its R and T are rt_run's: the layout holds
    the wind, so both add the TMS term to the same solve. ``dR_tms`` is
    that term's tau derivative along the JAX tangents."""
    from test_torch_lin import jax_tms_tau_term, solve_in_f64
    from vsmartmom_tpu.core.linearization import (build_tangent_inputs,
                                                  default_layout, rt_run_lin)
    model = solve_in_f64(jax_aband_model(par_path))
    band = model.bands[0]
    out = {"tau_abs": np.asarray(band.tau_abs),
           "tau_O2": np.asarray(band.tau_abs_by_mol["O2"])}
    layout = default_layout(model)
    out["names"] = layout.names()
    inputs, config, tangents = build_tangent_inputs(model, 0, layout)
    out["d_tau_vmr"] = np.asarray(tangents[layout.gas_index(0)].tau)
    out["dR_tms"] = jax_tms_tau_term(model, inputs, config, tangents)
    out.update(zip(REF_KEYS, (np.asarray(x) for x in rt_run_lin(
        model, layout=layout))))
    return out


@pytest.fixture(scope="module")
def jax_aband(par):
    return jax_aband_run(par)


def test_model_absorption_matches_jax(jax_aband, par):
    """tau_abs and tau_abs_by_mol of the small gas scene (the dense line sum
    over 3 layers): 1e-12; the Jacobian layout lists the gas."""
    from vsmartmom_tpu_torch import default_layout
    from vsmartmom_tpu_torch.flagship import aband_ref_model
    model = aband_ref_model(device="cpu", par_path=par)
    band = model.bands[0]
    assert list(band.tau_abs_by_mol) == ["O2"]
    assert jax_aband["tau_abs"].max() > 10.0    # saturated core
    assert _rel(band.tau_abs, jax_aband["tau_abs"]) <= 1e-12
    assert _rel(band.tau_abs_by_mol["O2"], jax_aband["tau_O2"]) <= 1e-12
    assert default_layout(model).names() == jax_aband["names"] == [
        "vmr_O2", "wind_speed"]


def test_vmr_tangent_matches_jax(jax_aband, par):
    from vsmartmom_tpu_torch import default_layout
    from vsmartmom_tpu_torch.core.linearization import build_tangent_inputs
    from vsmartmom_tpu_torch.flagship import aband_ref_model
    model = aband_ref_model(device="cpu", par_path=par)
    layout = default_layout(model)
    inputs, _, tangents = build_tangent_inputs(model, 0, layout,
                                               device="cpu")
    assert len(tangents) == 2
    d = tangents[layout.gas_index(0)]
    assert _rel(d.tau.numpy(), jax_aband["d_tau_vmr"]) <= 1e-12
    for f in d._fields:
        if f != "tau":
            assert not getattr(d, f).any(), f


def test_continua_and_luts_in_the_model_match_jax(o2_par, tmp_path):
    """A scene with a line list, a look-up table, CIA and MT_CKD through
    both packages' ``model_from_parameters``: tau_abs 1e-12."""
    from test_continuum import _write_cia, _write_mtckd
    from vsmartmom_tpu import model_from_parameters as jax_build
    from vsmartmom_tpu.absorption.cross_section import (
        HitranModel as JaxHitranModel, make_interpolation_model)
    from vsmartmom_tpu.absorption.hitran import read_hitran as jax_read
    from vsmartmom_tpu.core.model import AbsorptionParams as JaxAbs
    from vsmartmom_tpu.core.model import Parameters as JaxParams
    from vsmartmom_tpu.core.model import SurfaceDescriptor as JaxSurf
    from vsmartmom_tpu.scattering.stokes import STOKES_I as JAX_I
    from vsmartmom_tpu_torch import Parameters, SurfaceDescriptor
    from vsmartmom_tpu_torch import model_from_parameters
    from vsmartmom_tpu_torch.absorption.cross_section import \
        interpolation_model_from_numpy
    from vsmartmom_tpu_torch.core.model import AbsorptionParams
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_I
    cia, mt = tmp_path / "o2o2.cia", tmp_path / "mtckd.nc"
    _write_cia(cia)
    _write_mtckd(mt)
    grid = np.arange(13040.0, 13044.0, 0.25)
    lut = make_interpolation_model(JaxHitranModel(hitran=jax_read(o2_par)),
                                   np.arange(13038.0, 13046.0, 0.1),
                                   p_grid=np.linspace(50, 1050, 4),
                                   t_grid=np.linspace(180, 310, 4))
    kw = dict(spec_bands=[grid], nstreams=2, sza=30.0, vza=[0.0], vaz=[0.0],
              obs_alt=0.0, T=np.array([250.0, 275.0]),
              p=np.array([10.0, 500.0, 1000.0]), q=np.array([0.001, 0.01]))
    abs_kw = dict(molecules=[["O2", "H2O"]], vmr={"O2": 0.21, "H2O": 0.01},
                  par_paths={"O2": o2_par}, cia_files=[str(cia)],
                  mtckd_file=str(mt))
    ref = jax_build(JaxParams(
        surfaces=[JaxSurf("LambertianSurfaceScalar", [0.1])],
        polarization=JAX_I, absorption_params=JaxAbs(
            luts=[{"H2O": lut}], **abs_kw), **kw)).bands[0]
    band = model_from_parameters(Parameters(
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar", [0.1])],
        polarization=STOKES_I, absorption_params=AbsorptionParams(
            luts=[{"H2O": interpolation_model_from_numpy(lut)}], **abs_kw),
        **kw), device="cpu").bands[0]
    assert list(band.tau_abs_by_mol) == ["O2", "H2O"]
    for mol in ("O2", "H2O"):
        assert _rel(band.tau_abs_by_mol[mol], ref.tau_abs_by_mol[mol]) \
            <= 1e-12
    assert _rel(band.tau_abs, ref.tau_abs) <= 1e-12


# -- the small A-band scene end to end ---------------------------------------

def port_aband_run(par_path, dtype=np.float64):
    """The port's plain rt_run and rt_run_lin of the small A-band scene on
    the CPU; with float64, the f32 model's configuration solved in f64 (the
    stored reference's recipe)."""
    from test_torch_lin import solve_in_f64
    from vsmartmom_tpu_torch import rt_run, rt_run_lin
    from vsmartmom_tpu_torch.flagship import aband_ref_model
    model = aband_ref_model(device="cpu", par_path=par_path)
    if dtype == np.float64:
        model = solve_in_f64(model)
    out = dict(zip(REF_KEYS, rt_run_lin(model, device="cpu")))
    out.update(zip(("fwd_R", "fwd_T"), rt_run(model, device="cpu")))
    return out


def test_rt_runs_match_the_stored_reference(par):
    """The port's f64 plain rt_run_lin of the small A-band scene against
    ``aband_ref_f64.npz``: R, T, dR, dT 1e-9, each parameter's dR on its
    own scale too, against the stored dR + dR_tms; rt_run's R and T too
    (the layout holds the wind, so both entry points add the TMS term to
    the same solve)."""
    stored = dict(np.load(REF_PATH))
    assert np.abs(stored["dR_tms"]).max() > 0
    stored["dR"] = stored["dR"] + stored["dR_tms"]
    out = port_aband_run(par)
    for k in REF_KEYS:
        assert out[k].shape == stored[k].shape and np.isfinite(out[k]).all()
        assert _rel(out[k], stored[k]) <= 1e-9, k
    for q in range(stored["dR"].shape[-1]):
        assert _rel(out["dR"][..., q], stored["dR"][..., q]) <= 1e-9, q
    for k in ("R", "T"):
        assert _rel(out["fwd_" + k], stored[k]) <= 1e-9, k
    assert stored["dR"].shape == (2, 3, 16, 2)


def test_stored_aband_reference_is_current(jax_aband):
    stored = np.load(REF_PATH)
    for k in STORED_KEYS:
        assert stored[k].shape == jax_aband[k].shape
        assert _rel(stored[k], jax_aband[k]) <= 1e-12, k


def test_vmr_jacobian_matches_finite_difference(par):
    """The port's VMR dR (f64, plain jvp route) against its own central
    difference of rt_run in the VMR scale (vmr -> vmr (1 +- 1e-3)), on the
    Lambertian twin of the small A-band scene: 2e-3 of max|FD|, as the JAX
    package's TestGasJacobian."""
    from test_torch_lin import solve_in_f64
    from vsmartmom_tpu_torch import (default_layout, model_from_parameters,
                                     rt_run, rt_run_lin)
    from vsmartmom_tpu_torch.flagship import ABAND_VMR_O2, aband_ref_model
    model = solve_in_f64(aband_ref_model(surface="lambertian", device="cpu",
                                         par_path=par))
    layout = default_layout(model)
    assert layout.names() == ["vmr_O2", "albedo"]
    _, _, dR, _ = rt_run_lin(model, layout=layout, device="cpu")
    h, R = 1e-3, []
    for sign in (1, -1):
        params = copy.deepcopy(model.params)
        params.absorption_params.vmr["O2"] = ABAND_VMR_O2 * (1 + sign * h)
        R.append(rt_run(solve_in_f64(model_from_parameters(
            params, device="cpu")), device="cpu")[0])
    fd = (R[0] - R[1]) / (2 * h)
    assert np.abs(fd).max() > 0
    assert np.abs(dR[..., layout.gas_index(0)] - fd).max() \
        <= 2e-3 * np.abs(fd).max()


def test_vmr_jacobian_over_the_ocean_matches_finite_difference(par):
    """Over the Cox-Munk ocean the VMR dR carries the derivative of the TMS
    glint term, whose attenuation mu0 exp(-tau / mu0) depends on the gas:
    against the central difference of rt_run it sits within 2e-3 of
    max|FD| on the small A-band scene. Without that term, -TMS sum_z tau_O2
    / mu0 (the JAX package's tangent leaves it out), it misses 50-60% of
    max|FD|."""
    from test_torch_lin import solve_in_f64
    from vsmartmom_tpu_torch import (default_layout, model_from_parameters,
                                     rt_run, rt_run_lin)
    from vsmartmom_tpu_torch.flagship import ABAND_VMR_O2, aband_ref_model
    from vsmartmom_tpu_torch.surfaces.coxmunk import (CoxMunkSurface,
                                                      tms_correction)
    model = solve_in_f64(aband_ref_model(device="cpu", par_path=par))
    layout = default_layout(model)
    _, _, dR, _ = rt_run_lin(model, layout=layout, device="cpu")
    h, R = 1e-3, []
    for sign in (1, -1):
        params = copy.deepcopy(model.params)
        params.absorption_params.vmr["O2"] = ABAND_VMR_O2 * (1 + sign * h)
        R.append(rt_run(solve_in_f64(model_from_parameters(
            params, device="cpu")), device="cpu")[0])
    fd = (R[0] - R[1]) / (2 * h)
    band = model.bands[0]
    tau_total = (band.tau_rayl + band.tau_abs).sum(axis=1)
    tms = tms_correction(CoxMunkSurface(**band.surface.kwargs),
                         model.params.polarization.n, model.params.vza,
                         model.params.vaz, model.quad.mu0, tau_total,
                         model._band_m_max(band))
    d_tms = -tms * band.tau_abs_by_mol["O2"].sum(axis=1) / model.quad.mu0
    scale = np.abs(fd).max()
    assert np.abs(dR[..., layout.gas_index(0)] - fd).max() <= 2e-3 * scale
    gap = np.abs(dR[..., layout.gas_index(0)] - d_tms - fd).max() / scale
    assert 0.5 < gap < 0.6


def test_vmr_scale_is_linear_in_tau_abs(par):
    """Building the scene at vmr (1 + h) scales tau_abs_by_mol by (1 + h)
    exactly as the VMR tangent says (the line sum is linear in the VMR)."""
    from vsmartmom_tpu_torch import model_from_parameters
    from vsmartmom_tpu_torch.flagship import aband_ref_model
    base = aband_ref_model(device="cpu", par_path=par).bands[0]
    model = aband_ref_model(device="cpu", par_path=par)
    model.params.absorption_params.vmr["O2"] *= 1.01
    scaled = model_from_parameters(model.params, device="cpu").bands[0]
    assert _rel(scaled.tau_abs, 1.01 * base.tau_abs) <= 1e-14


# -- the device rule, the registry, missing data -----------------------------

def test_gas_scene_needs_cuda_or_an_explicit_device(par, monkeypatch):
    """A scene with a line list sums it on a device: without CUDA and
    without ``device=`` its build raises; a scene without line lists builds
    on the host as before."""
    from vsmartmom_tpu_torch.absorption.cross_section import (
        HitranModel, compute_absorption_cross_section)
    from vsmartmom_tpu_torch.absorption.hitran import read_hitran
    from vsmartmom_tpu_torch.flagship import aband_ref_model, flagship_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aband_ref_model(par_path=par)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compute_absorption_cross_section(
            HitranModel(hitran=read_hitran(par)), [13000.0, 13000.1], 500.0,
            250.0)
    assert not flagship_model(n_spec=2, nstreams=2).bands[0].tau_abs.any()


def test_registry_and_model_fallback(o2_par, tmp_path, monkeypatch):
    """The port's line-file registry: its own cache directory, SHA-256
    provenance, corruption caught, and the model build's fallback to a
    registered file; a molecule with no data warns and is skipped."""
    from vsmartmom_tpu_torch import Parameters, SurfaceDescriptor
    from vsmartmom_tpu_torch import model_from_parameters
    from vsmartmom_tpu_torch.absorption import artifacts as A
    from vsmartmom_tpu_torch.absorption.hitran import read_hitran
    from vsmartmom_tpu_torch.core.model import AbsorptionParams
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_I
    monkeypatch.setenv("VSM_TORCH_HITRAN_DIR", str(tmp_path / "cache"))
    edition = A.get_hitran_edition()
    A.set_hitran_edition("testlocal")
    try:
        kw = dict(spec_bands=[np.arange(13040.0, 13042.0, 0.2)],
                  surfaces=[SurfaceDescriptor("LambertianSurfaceScalar",
                                              [0.1])],
                  nstreams=2, polarization=STOKES_I, sza=30.0, vza=[0.0],
                  vaz=[0.0], obs_alt=0.0, T=np.array([250.0, 275.0]),
                  p=np.array([10.0, 500.0, 1000.0]))
        assert not A.hitran_is_cached("O2")
        with pytest.raises(FileNotFoundError, match="zero-egress"):
            A.artifact("O2")
        with pytest.warns(UserWarning, match="No HITRAN line data"):
            model = model_from_parameters(Parameters(
                absorption_params=AbsorptionParams(
                    molecules=[["O2"]], vmr={"O2": 0.21}), **kw))
        assert not model.bands[0].tau_abs.any()
        path = A.register_par("O2", o2_par)
        assert str(tmp_path / "cache" / "testlocal") in path
        assert len(read_hitran(A.artifact("O2"))) == 40
        prov = A.hitran_provenance("O2")
        assert prov["sha256"] and prov["edition"] == "testlocal"
        model = model_from_parameters(Parameters(
            absorption_params=AbsorptionParams(
                molecules=[["O2"]], vmr={"O2": 0.21}), **kw), device="cpu")
        assert model.bands[0].tau_abs.max() > 0
        with open(path, "a") as f:
            f.write("x")
        with pytest.raises(ValueError, match="corruption"):
            A.artifact("O2")
    finally:
        A.set_hitran_edition(edition)


def make_aband_ref():
    """R, T, dR, dT (rt_run_lin; R and T are also rt_run's) of the small
    A-band scene from the JAX package on the CPU, the f32 model's
    configuration solved in f64, and dR_tms, the TMS term's tau derivative
    along its tangents."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        out = jax_aband_run(write_aband_par(Path(d) / "o2.par"))
    return {k: out[k] for k in STORED_KEYS}


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    np.savez(REF_PATH, **make_aband_ref())
    print(f"wrote {REF_PATH}")
