"""The port's truncated single-scatter solve (``core/singlescatter.py``:
``rt_solve_ss``, ``rt_run_ss``) against the JAX package on the CPU in
f64. Tolerances, relative to max|ref|:

* ``rt_run_ss`` (R, T, hem_R, hem_T) over a Lambertian floor, a Cox-Munk
  ocean and a canopy with spectral leaf optics (a 4-D surface, every
  moment): 1e-9;
* the stored ``ss_canopy`` and ``ss_coxmunk`` entries of
  ``data/surfaces_ref_f64.npz``: the port 1e-9; ``ss_coxmunk`` against a
  fresh JAX run 1e-12 (``ss_canopy``'s scene is the canopy reference's,
  held against a fresh run in ``tests/test_torch_canopy.py``);
* single scattering stays at or below the full solve's Stokes I at every
  point (higher orders add non-negative intensity).

JAX outputs are converted with ``np.asarray`` before the torch side runs.
"""

import numpy as np
import pytest

from port_threads import _one_thread  # noqa: F401  (autouse)
from surface_inputs import (entry_canopy, jax_model, jax_reference, rel,
                            stored)

KEYS = ("R", "T", "hem_R", "hem_T")


def _model(surface):
    from vsmartmom_tpu_torch.core.model import (Parameters,
                                                SurfaceDescriptor,
                                                model_from_parameters)
    from vsmartmom_tpu_torch.flagship import flagship_params
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_IQU
    surf = {"lambertian": SurfaceDescriptor("LambertianSurfaceScalar",
                                            [0.15]),
            "coxmunk": SurfaceDescriptor("CoxMunkSurface", [],
                                         {"wind_speed": 5.0}),
            "canopy": entry_canopy(spectral=True)}[surface]
    kw = flagship_params(4, np.float64, nstreams=2, nz=3)
    kw["spec_bands"] = [np.array([13300.0, 13700.0, 14100.0, 14500.0])]
    return model_from_parameters(Parameters(
        surfaces=[surf], polarization=STOKES_IQU, **kw), device="cpu")


@pytest.mark.parametrize("surface", ["lambertian", "coxmunk", "canopy"])
def test_rt_run_ss_matches_jax(surface):
    from vsmartmom_tpu.core.singlescatter import rt_run_ss as jax_run
    from vsmartmom_tpu_torch.core.singlescatter import rt_run_ss
    model = _model(surface)
    if surface == "canopy":
        assert model.build_band(0, "cpu")[0].surf_r.dim() == 4
    ref = {k: np.asarray(v) for k, v in jax_run(jax_model(model)).items()}
    out = rt_run_ss(model, device="cpu")
    assert out.keys() == ref.keys() == set(KEYS)
    for k in KEYS:
        assert out[k].shape == ref[k].shape and rel(out[k], ref[k]) <= 1e-9


@pytest.mark.parametrize("name", ["ss_canopy", "ss_coxmunk"])
def test_stored_references(name):
    from vsmartmom_tpu_torch.flagship import surfaces_ref_outputs
    ref = stored()
    out = surfaces_ref_outputs(name, device="cpu")
    for k, v in out.items():
        assert rel(v, ref[k]) <= 1e-9, k
    if name == "ss_coxmunk":
        for k, v in jax_reference(name).items():
            assert rel(ref[k], v) <= 1e-12, k


def test_single_scatter_stays_below_the_full_solve():
    from vsmartmom_tpu_torch.core.singlescatter import rt_run_ss
    from vsmartmom_tpu_torch.core.solver import rt_run
    from vsmartmom_tpu_torch.flagship import canopy_ref_model
    model = canopy_ref_model(device="cpu")
    ss = rt_run_ss(model, device="cpu")["R"][:, 0]
    full = rt_run(model, device="cpu")[0][:, 0]
    assert np.all(ss > 0) and np.all(ss <= full + 1e-12 * full.max())
    assert np.all(full - ss > 1e-3 * full)
