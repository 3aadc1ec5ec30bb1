"""The port's stellar (H2) Raman path against the JAX package: sol_RRS,
sol_VS_0to1 and sol_VS_1to0 (``inelastic/stellar.py``), and the stellar
spectrum ``BandData.f0_spec``.

Scenes: the JAX package's tests/test_stellar_raman.py scene (an H2 column
of 2 layers, scattering depth 0.3, over a black floor, nstreams 4, Stokes
I; ``flagship.stellar_ref_model``): sol_RRS on 18000-19592 cm^-1 at 8
cm^-1 (200 points, 8 H2 shifts) with a 70% deep line in the stellar
spectrum, the sol_VS modes on ``sol_vs_plus_grid(540.0, mode, dnu=16.0)``
(224 and 242 points). JAX outputs are turned to numpy at once.
Tolerances, relative to max|ref|: 1e-12 for the host setup (H2 lines,
Greek sets, redistributions, grids, F0); 1e-10 for the port's f64 runs
against the JAX package's, each on its own host build of the f32 scene
solving its configuration in f64; 1e-4, the reference's F32 gate, for the
port's f32 runs on the CPU (the plain route, and the kernel route's plain
K1 and K3 at full ie-ladder resolution) against the stored reference.

Holds the stored cross-framework reference
``vsmartmom_tpu_torch/data/stellar_ref_f64.npz`` (the three modes, solved
in f64 by the JAX package), which the chip smoke test compares the port on
the card against: a test recomputes it so it cannot go stale.
``python tests/test_torch_stellar.py`` rewrites it.
"""

import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from vsmartmom_tpu_torch.flagship import (STELLAR_REF_TAU, stellar_f0_dip,
                                          stellar_ref_model,
                                          stellar_ref_params)

from port_threads import _one_thread  # noqa: F401  (autouse)
from raman_inputs import solved_in_f64

MODES = ("sol_RRS", "sol_VS_0to1", "sol_VS_1to0")
KEYS = ("R", "T", "ieR", "ieT")
REF_PATH = (Path(__file__).resolve().parents[1] / "vsmartmom_tpu_torch"
            / "data" / "stellar_ref_f64.npz")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def jax_model(mode):
    """The JAX package's model of ``flagship.stellar_ref_model(mode)``."""
    from vsmartmom_tpu import model_from_parameters
    from vsmartmom_tpu.core.model import Parameters, SurfaceDescriptor
    from vsmartmom_tpu.scattering.stokes import STOKES_I
    model = model_from_parameters(Parameters(
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar", [0.0])],
        polarization=STOKES_I, **stellar_ref_params(mode)))
    band = model.bands[0]
    band.tau_rayl[:] = STELLAR_REF_TAU / band.tau_rayl.shape[1]
    if mode == "sol_RRS":
        band.f0_spec = stellar_f0_dip(band.nu_grid)
    return model


def make_stellar_ref():
    """R, T, ieR, ieT of the three modes from the JAX package on the CPU
    (the f32 scene's configuration in f64), keys "<mode>_<field>"."""
    from vsmartmom_tpu.inelastic.stellar import rt_run_stellar
    out = {}
    for mode in MODES:
        res = rt_run_stellar(solved_in_f64(jax_model(mode)), mode=mode)
        out.update({f"{mode}_{k}": np.asarray(v) for k, v in zip(KEYS, res)})
    return out


@pytest.fixture(scope="module")
def jax_stellar():
    return make_stellar_ref()


def test_h2_constants_and_greek_sets_match_jax():
    """Every H2 field (1e-12; the populated lines nonzero), the Rayleigh
    depolarization and both stellar Greek sets."""
    from vsmartmom_tpu.inelastic import stellar as js
    from vsmartmom_tpu_torch.inelastic import stellar
    fields = ("alpha_bar", "gamma_bar", "alpha_prime", "gamma_prime",
              "gamma_C_Rayl", "sigma_Rayl_coeff", "E_vJ", "sigma_RR_Jp2",
              "sigma_RR_Jm2", "dnu_RR_Jp2", "dnu_RR_Jm2", "sigma_VR_0to1",
              "sigma_VR_1to0", "dnu_VR_0to1", "dnu_VR_1to0",
              "sigma_RVR_0to1_Jp2", "sigma_RVR_0to1_Jm2",
              "sigma_RVR_1to0_Jp2", "sigma_RVR_1to0_Jm2",
              "dnu_RVR_0to1_Jp2", "dnu_RVR_0to1_Jm2", "dnu_RVR_1to0_Jp2",
              "dnu_RVR_1to0_Jm2")
    for nu, T, vmr in ((18500.0, 273.0, 0.91), (1e7 / 540.0, 150.0, 0.85)):
        h2 = stellar.get_raman_solar_constants(nu, T, vmr)
        h2_j = js.get_raman_solar_constants(nu, T, vmr)
        for f in fields:
            assert _rel(getattr(h2, f), getattr(h2_j, f)) <= 1e-12, f
            assert np.max(np.abs(getattr(h2, f))) > 0, f
        assert abs(stellar.rho_depol_rayleigh(h2)
                   - js.rho_depol_rayleigh(h2_j)) <= 1e-12
        for g, g_j in ((stellar.greek_raman_stellar(),
                        js.greek_raman_stellar()),
                       (stellar.greek_raman_stellar_vs(h2),
                        js.greek_raman_stellar_vs(h2_j))):
            for f in ("alpha", "beta", "gamma", "delta", "epsilon", "zeta"):
                assert np.max(np.abs(getattr(g, f) - getattr(g_j, f))) \
                    <= 1e-12, f


@pytest.mark.parametrize("mode", ["sol_VS_0to1", "sol_VS_1to0"])
def test_stellar_redistributions_and_grids_match_jax(mode):
    """sol_rrs_redistribution (on the small scene's grid and the chip
    smoke test's 1024-point grid: 8 shifts, +-226/227 and +-374-376 steps
    there), sol_vs_plus_grid (dnu 8 and 1) and sol_vs_redistribution
    against JAX (1e-12)."""
    from vsmartmom_tpu.inelastic import stellar as js
    from vsmartmom_tpu_torch.flagship import STELLAR_NU0, STELLAR_STEP
    from vsmartmom_tpu_torch.inelastic import stellar
    for nu in (stellar_ref_params()["spec_bands"][0],
               STELLAR_NU0 + STELLAR_STEP * np.arange(1024)):
        sh, w, pi = stellar.sol_rrs_redistribution(nu)
        sh_j, w_j, pi_j = js.sol_rrs_redistribution(nu)
        assert np.array_equal(sh, sh_j) and len(sh) == 8
        assert _rel(w, w_j) <= 1e-12 and abs(pi - pi_j) <= 1e-12
    assert sorted(np.abs(sh)) == [226, 227, 227, 228, 374, 375, 375, 376]
    for dnu in (8.0, 1.0):
        grid = stellar.sol_vs_plus_grid(540.0, mode, dnu=dnu)
        grid_j = js.sol_vs_plus_grid(540.0, mode, dnu=dnu)
        assert grid.shape == grid_j.shape and _rel(grid, grid_j) <= 1e-12
        out = stellar.sol_vs_redistribution(grid, mode)
        ref = js.sol_vs_redistribution(grid_j, mode)
        assert out[0][0] == out[1][0] == 0.0
        assert np.any(out[0] > 0) and np.any(out[1] > 0)
        for a, b in zip(out, ref):
            assert _rel(a, b) <= 1e-12
    if mode == "sol_VS_0to1":
        assert len(stellar.sol_vs_plus_grid(540.0, mode, dnu=1.0)) == 3552


def test_f0_spec_scales_f0_and_carries_across():
    """``BandData.f0_spec`` scales F0 in the port's build as in the JAX
    build (1e-12), before ``include_solar`` zeroes it;
    ``solver_inputs_from_numpy`` carries the scaled F0 across; a scene
    without ``f0_spec`` builds the bits of the build without it (F0 the
    tiled I0, as before the field existed), and one with a flat
    ``f0_spec`` of ones the same bits."""
    from vsmartmom_tpu_torch.core.types import solver_inputs_from_numpy
    inputs_j, _ = jax_model("sol_RRS").build_band(0, rrs=True)
    model = stellar_ref_model("sol_RRS")
    f0 = model.bands[0].f0_spec
    inputs, _ = model.build_band(0, device="cpu", rrs=True)
    assert _rel(inputs.F0.numpy(), np.asarray(inputs_j.F0)) <= 1e-12
    assert np.array_equal(inputs.F0.numpy(),
                          model.params.polarization.I0[:, None] * f0[None])
    carried = solver_inputs_from_numpy(
        {f: np.asarray(getattr(inputs_j, f)) for f in inputs_j._fields},
        "cpu")
    assert _rel(carried.F0.numpy(), inputs.F0.numpy()) <= 1e-12
    plain = stellar_ref_model("sol_RRS")
    plain.bands[0].f0_spec = None
    flat = stellar_ref_model("sol_RRS")
    flat.bands[0].f0_spec = np.ones_like(f0)
    base, _ = plain.build_band(0, device="cpu")
    assert np.array_equal(base.F0.numpy(), np.tile(
        plain.params.polarization.I0[:, None], (1, len(f0))))
    for other in (flat.build_band(0, device="cpu")[0],):
        for a, b in zip(base, other):
            assert torch.equal(a, b)
    dark = stellar_ref_model("sol_RRS")
    dark.params.include_solar = False
    assert not dark.build_band(0, device="cpu")[0].F0.any()


#: SHA-256 of the CPU build (every SolverInputs tensor's bytes, then the
#: config's repr) of scenes that set no ``f0_spec``, recorded on the tree
#: before the field existed: the small RRS scene with ``rrs=True`` and
#: without, and the flagship at nSpec 8, nstreams 4.
BUILD_SHA256 = {
    "rrs_ref_rrs":
        "17ade675c0284a7e292a85a291a07b7b4fa5c8869a438313a23993f3e7fcc822",
    "rrs_ref":
        "539daf5ce75095eddacfdc3fbddd236675eba162c3c025113051f732c0729fa9",
    "flagship":
        "8de559b2ed65662c1381a4eeb8b64653e938f9927e150e1c0f68e3199b04c757"}


@pytest.mark.parametrize("scene", sorted(BUILD_SHA256))
def test_builds_without_f0_spec_keep_their_bits(scene):
    import hashlib
    from vsmartmom_tpu_torch.flagship import flagship_model, rrs_ref_model
    model, kw = {"rrs_ref_rrs": (rrs_ref_model(), {"rrs": True}),
                 "rrs_ref": (rrs_ref_model(), {}),
                 "flagship": (flagship_model(n_spec=8, nstreams=4), {})}[
                     scene]
    assert model.bands[0].f0_spec is None
    inputs, config = model.build_band(0, device="cpu", **kw)
    h = hashlib.sha256()
    for x in inputs:
        h.update(x.numpy().tobytes())
    h.update(repr(config).encode())
    assert h.hexdigest() == BUILD_SHA256[scene]


@pytest.mark.parametrize("mode", MODES)
def test_rt_run_stellar_matches_jax(jax_stellar, mode):
    """rt_run_stellar, each package on its own host build of the f32 scene
    solving its configuration in f64: 1e-10 of max; sol_VS puts no light
    on the incident point."""
    from vsmartmom_tpu_torch.inelastic.stellar import rt_run_stellar
    out = rt_run_stellar(solved_in_f64(stellar_ref_model(mode)), mode=mode,
                         device="cpu")
    for k, v in zip(KEYS, out):
        assert v.dtype == np.float64
        assert _rel(v, jax_stellar[f"{mode}_{k}"]) <= 1e-10, k
    assert np.max(np.abs(out[2])) > 0
    if mode != "sol_RRS":
        assert np.all(np.abs(out[2][:, :, 0]) <= 1e-12 * np.abs(out[2]).max())


def test_sol_rrs_routes_on_the_cpu(monkeypatch):
    """sol_RRS of the f32 scene on the CPU: the plain route, and the kernel
    route (the automatic choice made as on the card; on the CPU it runs
    the plain K1 and K3, the ie ladder at full resolution) against the
    stored JAX reference (1e-4) and each other; the line core is filled
    in (its ie / elastic ratio more than twice the median). A scene wider
    than K3 takes (its limit patched to 4 here) warns and runs the plain
    route."""
    from vsmartmom_tpu_torch.core import inelastic
    from vsmartmom_tpu_torch.core import model as model_mod
    from vsmartmom_tpu_torch.inelastic.stellar import rt_run_stellar
    stored = np.load(REF_PATH)
    plain = dict(zip(KEYS, rt_run_stellar(stellar_ref_model(), device="cpu")))
    monkeypatch.setattr(model_mod, "auto_kernel", lambda dev, ft: True)
    calls = []
    real = inelastic.rt_solve_rrs_fused
    monkeypatch.setattr(inelastic, "rt_solve_rrs_fused",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        kern = dict(zip(KEYS, rt_run_stellar(stellar_ref_model(),
                                             device="cpu")))
    assert calls == [{"ie_fullres": True}]
    for k in KEYS:
        assert _rel(plain[k], stored[f"sol_RRS_{k}"]) <= 1e-4, k
        assert _rel(kern[k], stored[f"sol_RRS_{k}"]) <= 1e-4, k
    ratio = kern["ieR"][0, 0] / kern["R"][0, 0]
    inner = slice(40, len(ratio) - 40)
    assert ratio[len(ratio) // 2] > 2.0 * np.median(ratio[inner])
    monkeypatch.setattr(inelastic, "KERNEL_MAX_N", 4)
    with pytest.warns(UserWarning, match=r"K3 .* N <= 4; this scene has "
                                         r"N = 7"):
        wide = rt_run_stellar(stellar_ref_model(), device="cpu")
    assert len(calls) == 1
    for a, k in zip(wide, KEYS):
        assert np.array_equal(a, plain[k])


def test_stored_stellar_reference_is_current(jax_stellar):
    stored = np.load(REF_PATH)
    assert sorted(stored.files) == sorted(jax_stellar)
    for k, v in jax_stellar.items():
        assert stored[k].shape == v.shape
        assert _rel(stored[k], v) <= 1e-12, k


def test_rt_run_stellar_needs_cuda_or_an_explicit_device(monkeypatch):
    from vsmartmom_tpu_torch import rt_run_stellar
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt_run_stellar(stellar_ref_model())
    with pytest.raises(ValueError, match="unknown stellar mode"):
        rt_run_stellar(stellar_ref_model(), mode="RRS", device="cpu")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax
    jax.config.update("jax_platforms", "cpu")
    np.savez(REF_PATH, **make_stellar_ref())
    print(f"wrote {REF_PATH}")
