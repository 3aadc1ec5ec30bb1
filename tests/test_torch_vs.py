"""The port's vibrational-Raman path (VS_0to1 / VS_1to0) against the JAX
package, and the refusal of inelastic runs with thermal emission.

Scene: the JAX package's tests/test_raman.py TestVibrationalRaman scene (2
Rayleigh layers over a black floor, nstreams 4) on
``vs_band_grid(25000.0, 200.0, 4.0)``: 102 points, the first the incident
wavelength, 15 targets with weight (``flagship.vs_ref_model``). Both modes
share one grid length, so the JAX solve compiles once. JAX outputs are
turned to numpy at once. Tolerances, relative to max|ref|: 1e-12 for the
host setup (the molecular lines, the redistribution, the grid); 1e-10 for
the port's plain f64 solve against the JAX f64 solve of the same f32
model's configuration (each package on its own host build); 1e-4, the
reference's F32 gate, for the port's f32 run on the CPU against the
stored reference (R reads 3.0e-5: f32 rounding over the ladder); 1e-10
for the port's own check that VS with weight only at target t equals RRS
with the single shift -t.

Holds the stored cross-framework reference
``vsmartmom_tpu_torch/data/vs_ref_f64.npz`` (the IQU scene's f32 model in
both modes, solved in f64 by the JAX package), which the chip smoke test
compares the port on the card against: a test recomputes it so it cannot
go stale. ``python tests/test_torch_vs.py`` rewrites it.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from vsmartmom_tpu_torch.flagship import (VS_REF_TAU, rrs_ref_params,
                                          vs_ref_model, vs_ref_params)

from port_threads import _one_thread  # noqa: F401  (autouse)
from raman_inputs import solved_in_f64

MODES = ("VS_0to1", "VS_1to0")
KEYS = ("R", "T", "ieR", "ieT")
REF_PATH = (Path(__file__).resolve().parents[1] / "vsmartmom_tpu_torch"
            / "data" / "vs_ref_f64.npz")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def jax_model(mode, pol_name="STOKES_IQU"):
    """The JAX package's model of ``flagship.vs_ref_model``."""
    from vsmartmom_tpu import model_from_parameters
    from vsmartmom_tpu.core.model import Parameters, SurfaceDescriptor
    from vsmartmom_tpu.scattering import stokes
    model = model_from_parameters(Parameters(
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar", [0.0])],
        polarization=getattr(stokes, pol_name), **vs_ref_params(mode)))
    model.bands[0].tau_rayl[:] = VS_REF_TAU / 2
    return model


def make_vs_ref():
    """R, T, ieR, ieT of the IQU scene in both modes from the JAX package
    on the CPU (the f32 model's configuration in f64), keys
    "<mode>_<field>"."""
    from vsmartmom_tpu.core.inelastic import rt_run_inelastic
    out = {}
    for mode in MODES:
        res = rt_run_inelastic(solved_in_f64(jax_model(mode)), mode=mode)
        out.update({f"{mode}_{k}": np.asarray(v) for k, v in zip(KEYS, res)})
    return out


@pytest.fixture(scope="module")
def jax_vs():
    return make_vs_ref()


def test_molecular_lines_match_jax():
    """The vibrational Q-branch and rovibrational O/S-branch lines of N2
    and O2 (1e-12), and every field the auto-depol path reads, and its
    result, bit for bit."""
    from vsmartmom_tpu.inelastic import molecular as jm
    from vsmartmom_tpu_torch.inelastic import molecular as pm
    new = ("alpha_prime", "gamma_prime", "sigma_VR_0to1", "sigma_VR_1to0",
           "dnu_VR_0to1", "dnu_VR_1to0", "sigma_RVR_0to1_Jp2",
           "sigma_RVR_0to1_Jm2", "sigma_RVR_1to0_Jp2", "sigma_RVR_1to0_Jm2",
           "dnu_RVR_0to1_Jp2", "dnu_RVR_0to1_Jm2", "dnu_RVR_1to0_Jp2",
           "dnu_RVR_1to0_Jm2")
    old = ("alpha_bar", "gamma_bar", "gamma_C_Rayl", "sigma_Rayl_coeff",
           "E_vJ", "sigma_RR_Jp2", "sigma_RR_Jm2", "dnu_RR_Jp2",
           "dnu_RR_Jm2")
    for nu, T in ((25000.0, 300.0), (13075.0, 250.0)):
        for a, b in zip(pm.get_raman_atmo_constants(nu, T),
                        jm.get_raman_atmo_constants(nu, T)):
            for f in new:
                assert _rel(getattr(a, f), getattr(b, f)) <= 1e-12, f
                assert np.max(np.abs(getattr(a, f))) > 0, f
            for f in old:
                assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert pm.air_depolarization(nu, T) == jm.air_depolarization(nu, T)


@pytest.mark.parametrize("mode", MODES)
def test_vs_redistribution_and_grid_match_jax(mode):
    """vs_band_grid and vs_redistribution against JAX (1e-12): weights
    zero at the incident point, a VS effect of 1e-3 or less."""
    from vsmartmom_tpu.inelastic import vs_setup as jvs
    from vsmartmom_tpu_torch.inelastic import vs_setup
    for kw in (dict(), dict(half_width=200.0, dnu=4.0),
               dict(half_width=120.0, dnu=0.5, T=250.0)):
        grid = vs_setup.vs_band_grid(25000.0, mode=mode, **kw)
        grid_j = jvs.vs_band_grid(25000.0, mode=mode, **kw)
        assert grid.shape == grid_j.shape and _rel(grid, grid_j) <= 1e-12
        T = kw.get("T", 300.0)
        w, pi_cab, k = vs_setup.vs_redistribution(grid, mode, T)
        w_j, pi_j, k_j = jvs.vs_redistribution(grid_j, mode, T)
        assert w[0] == 0.0 and np.any(w > 0) and w.sum() < 1e-2
        assert _rel(w, w_j) <= 1e-12
        assert abs(pi_cab - pi_j) <= 1e-12 and abs(k - k_j) <= 1e-12


def test_vs_setup_matches_jax_and_carries_across():
    """The port's inelastic_setup in VS_0to1 against the JAX one (1e-12):
    one fixed-source slot, shifts (0,), per-target weights (1, nSpec);
    ``rrs_setup_from_numpy`` takes the JAX outputs as they are, and
    refuses a weight array of another shape."""
    from vsmartmom_tpu.core.inelastic import inelastic_setup as jax_setup
    from vsmartmom_tpu_torch.core.inelastic import (_src_fixed0,
                                                    inelastic_setup,
                                                    source_map)
    from vsmartmom_tpu_torch.core.types import rrs_setup_from_numpy
    (_, config, shifts, w, Zp, Zm, fsc,
     src_fn) = jax_setup(jax_model("VS_0to1"), mode="VS_0to1")
    assert src_fn.__name__ == "_src_fixed0"
    (_, p_cfg, p_shifts, p_w, p_Zp, p_Zm,
     p_fsc) = inelastic_setup(vs_ref_model("VS_0to1"), mode="VS_0to1",
                              device="cpu")
    assert source_map("VS_0to1") is _src_fixed0
    assert p_shifts == shifts == (0,)
    assert tuple(p_w.shape) == (1, config.n_spec) == np.shape(w)
    assert (p_cfg.N, p_cfg.nz, p_cfg.ndoubl, p_cfg.m_max) == \
        (config.N, config.nz, config.ndoubl, config.m_max)
    for a, b in ((p_w, w), (p_Zp, Zp), (p_Zm, Zm), (p_fsc, fsc)):
        assert _rel(a.numpy(), b) <= 1e-12
    carried = rrs_setup_from_numpy(shifts, np.asarray(w), np.asarray(Zp),
                                   np.asarray(Zm), np.asarray(fsc), "cpu")
    assert carried[0] == (0,) and tuple(carried[1].shape) == (1,
                                                              config.n_spec)
    with pytest.raises(ValueError, match="w_shifts of shape"):
        rrs_setup_from_numpy(shifts, np.asarray(w)[:, :-1], np.asarray(Zp),
                             np.asarray(Zm), np.asarray(fsc), "cpu")


@pytest.mark.parametrize("mode", MODES)
def test_plain_vs_matches_jax(jax_vs, mode):
    """rt_run_inelastic in a VS mode, each package on its own host build of
    the f32 scene and solving its configuration in f64: 1e-10 of max."""
    from vsmartmom_tpu_torch.core.inelastic import rt_run_inelastic
    out = rt_run_inelastic(solved_in_f64(vs_ref_model(mode)), mode=mode,
                           device="cpu")
    for k, v in zip(KEYS, out):
        assert v.dtype == np.float64
        assert _rel(v, jax_vs[f"{mode}_{k}"]) <= 1e-10, k
    assert np.max(np.abs(jax_vs[f"{mode}_ieR"])) > 0


def test_vs_single_target_equals_rrs_single_shift():
    """The port's own check of the JAX test: with spectrally flat optics, VS
    with weight only at target t equals RRS run with the single shift -t
    at t (1e-10), and the VS field is exactly zero away from t."""
    from vsmartmom_tpu_torch import flagship
    from vsmartmom_tpu_torch.core.inelastic import (_roll0, _src_fixed0,
                                                    raman_z_stack,
                                                    rt_solve_rrs)
    from vsmartmom_tpu_torch.core.model import (Parameters,
                                                SurfaceDescriptor,
                                                model_from_parameters)
    from vsmartmom_tpu_torch.inelastic.rrs_setup import greek_raman
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_I
    nu = np.arange(13000.0, 13030.0, 2.0)
    params = dict(vs_ref_params(), spec_bands=[nu], float_type=np.float64)
    model = model_from_parameters(Parameters(
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar", [0.0])],
        polarization=STOKES_I, **params))
    model.bands[0].tau_rayl[:] = flagship.VS_REF_TAU / 2
    inputs, config = model.build_band(0, device="cpu", rrs=True)
    Zp, Zm = (torch.as_tensor(z) for z in
              raman_z_stack(model, config, greek_raman()))
    fsc = torch.ones((config.nz, len(nu)), dtype=torch.float64)
    t, w0 = 9, 0.01
    w_vec = torch.zeros((1, len(nu)), dtype=torch.float64)
    w_vec[0, t] = w0
    vs = rt_solve_rrs(inputs, config, (0,), w_vec, Zp, Zm, fsc, "cpu",
                      src_fn=_src_fixed0)
    rrs = rt_solve_rrs(inputs, config, (-t,),
                       torch.tensor([w0], dtype=torch.float64), Zp, Zm, fsc,
                       "cpu", src_fn=_roll0)
    for k in ("ieR", "ieT"):
        assert _rel(vs[k][..., t].numpy(), rrs[k][..., t].numpy()) <= 1e-10
    mask = np.ones(len(nu), bool)
    mask[t] = False
    assert float(vs["ieR"][..., mask].abs().max()) == 0.0
    assert float(vs["ieR"][..., t].abs().max()) > 0.0


def test_rt_run_inelastic_vs_on_the_cpu():
    """The entry point end to end on the port's own f32 build on the CPU
    (the plain fixed-source solve) lands on the stored JAX reference
    (1e-4); nothing reaches the incident point, every weighted target
    gets light; the kernel route refuses a VS setup."""
    from vsmartmom_tpu_torch.core.inelastic import (inelastic_setup,
                                                    rt_run_inelastic,
                                                    rt_solve_rrs_fused)
    from vsmartmom_tpu_torch.inelastic.vs_setup import vs_redistribution
    stored = np.load(REF_PATH)
    for mode in MODES:
        model = vs_ref_model(mode)
        out = dict(zip(KEYS, rt_run_inelastic(model, mode=mode,
                                              device="cpu")))
        for k in KEYS:
            assert out[k].shape == stored[f"{mode}_{k}"].shape
            assert _rel(out[k], stored[f"{mode}_{k}"]) <= 1e-4, k
        w, _, _ = vs_redistribution(model.bands[0].nu_grid, mode)
        assert np.all(out["ieR"][:, :, 0] == 0.0)
        assert np.all(out["ieR"][:, 0, w > 0] > 0)
    inputs, config, *vs = inelastic_setup(model, mode=mode, device="cpu")
    with pytest.raises(ValueError, match="RRS roll"):
        rt_solve_rrs_fused(inputs, config, *vs, device="cpu")


def test_stored_vs_reference_is_current(jax_vs):
    stored = np.load(REF_PATH)
    assert sorted(stored.files) == sorted(jax_vs)
    for k, v in jax_vs.items():
        assert stored[k].shape == v.shape
        assert _rel(stored[k], v) <= 1e-12, k


def _thermal_scene(pkg, thermal):
    """The small RRS scene moved to 2500 cm^-1 (4 um) with absorbing layers
    (tau_abs 0.2), in f64, from ``pkg`` ("jax" or "port"), with or
    without ``add_thermal_emission``."""
    if pkg == "jax":
        from vsmartmom_tpu.core import model as M
        from vsmartmom_tpu.scattering.stokes import STOKES_I
        from vsmartmom_tpu.solar import add_thermal_emission
    else:
        from vsmartmom_tpu_torch.core import model as M
        from vsmartmom_tpu_torch.scattering.stokes import STOKES_I
        from vsmartmom_tpu_torch.solar import add_thermal_emission
    params = dict(rrs_ref_params(), float_type=np.float64,
                  spec_bands=[2500.0 + 2.4 * np.arange(16)])
    model = M.model_from_parameters(M.Parameters(
        surfaces=[M.SurfaceDescriptor("LambertianSurfaceScalar", [0.1])],
        polarization=STOKES_I, **params))
    model.bands[0].tau_rayl[:] = 0.1
    model.bands[0].tau_abs[:] = 0.2
    return add_thermal_emission(model) if thermal else model


def test_inelastic_runs_with_thermal_emission_are_refused():
    """The JAX package's rt_run_inelastic never reads the Planck source: on
    a scene after add_thermal_emission it returns the port's solar-only
    answer (1e-10), while rt_run there differs from its solar-only run by
    several times the signal. So the port refuses such a scene in every
    inelastic entry point instead of copying the silent drop."""
    from vsmartmom_tpu.core.inelastic import rt_run_inelastic as jax_run
    from vsmartmom_tpu_torch.core.inelastic import rt_run_inelastic
    from vsmartmom_tpu_torch.core.multisensor import rt_run_ms_rrs
    from vsmartmom_tpu_torch.core.solver import rt_run
    from vsmartmom_tpu_torch.inelastic.stellar import rt_run_stellar
    ref = [np.asarray(x) for x in jax_run(_thermal_scene("jax", True))]
    solar = rt_run_inelastic(_thermal_scene("port", False), device="cpu")
    for a, b in zip(solar, ref):
        assert _rel(a, b) <= 1e-10
    R_th, _ = rt_run(_thermal_scene("port", True), device="cpu")
    R_sol, _ = rt_run(_thermal_scene("port", False), device="cpu")
    assert np.max(np.abs(R_th - R_sol)) > np.max(np.abs(R_sol))
    model = _thermal_scene("port", True)
    for run in (lambda: rt_run_inelastic(model, device="cpu"),
                lambda: rt_run_inelastic(model, mode="VS_0to1",
                                         device="cpu"),
                lambda: rt_run_ms_rrs(model, [0], device="cpu"),
                lambda: rt_run_stellar(model, device="cpu")):
        with pytest.raises(NotImplementedError, match="thermal emission"):
            run()


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax
    jax.config.update("jax_platforms", "cpu")
    np.savez(REF_PATH, **make_vs_ref())
    print(f"wrote {REF_PATH}")
