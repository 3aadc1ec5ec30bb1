"""The port's multisensor Raman path (``rt_run_ms_rrs``: RRS and VS at
any sensor level) against the JAX package.

Scene: the JAX package's tests/test_multisensor_rrs.py scene (2 Rayleigh
layers of depth 0.075 over a 0.3-albedo Lambertian floor, nstreams 4,
IQU; ``flagship.ms_rrs_ref_model``), its RRS grid cut to 16 points at 2
cm^-1 (6 shifts), the VS mode on the small VS scene's grid (102 points).
The JAX package runs the sensor levels (0, 1, 2) once a mode; each level
stands alone, so the port's runs at [0] and [nz] are held against its
rows. JAX outputs are turned to numpy at once. Tolerances, relative to
max|ref|: 1e-10 for the port's f64 runs against the JAX package's (each on
its own host build of the f32 scene, solving its configuration in f64)
and for the TOA sensor against the port's own rt_run_inelastic; 1e-4, the
reference's F32 gate, for the port's f32 run on the CPU against the stored
reference.

Holds the stored cross-framework reference
``vsmartmom_tpu_torch/data/ms_rrs_ref_f64.npz`` (both modes at levels 0,
1, 2, solved in f64 by the JAX package), which the chip smoke test
compares the port on the card against: a test recomputes it so it cannot
go stale. ``python tests/test_torch_ms_rrs.py`` rewrites it.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from vsmartmom_tpu_torch.flagship import (MS_RRS_REF_ALBEDO,
                                          MS_RRS_REF_LEVELS,
                                          MS_RRS_REF_TAUS, ms_rrs_ref_model,
                                          ms_rrs_ref_params)

from port_threads import _one_thread  # noqa: F401  (autouse)
from raman_inputs import solved_in_f64

MODES = ("RRS", "VS_0to1")
KEYS = ("uwJ", "dwJ", "ieuwJ", "iedwJ")
REF_PATH = (Path(__file__).resolve().parents[1] / "vsmartmom_tpu_torch"
            / "data" / "ms_rrs_ref_f64.npz")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def jax_model(mode):
    """The JAX package's model of ``flagship.ms_rrs_ref_model(mode)``."""
    from vsmartmom_tpu import model_from_parameters
    from vsmartmom_tpu.core.model import Parameters, SurfaceDescriptor
    from vsmartmom_tpu.scattering.stokes import STOKES_IQU
    model = model_from_parameters(Parameters(
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar",
                                    [MS_RRS_REF_ALBEDO])],
        polarization=STOKES_IQU, **ms_rrs_ref_params(mode)))
    for i, t in enumerate(MS_RRS_REF_TAUS):
        model.bands[0].tau_rayl[:, i] = t
    return model


def make_ms_rrs_ref():
    """uwJ, dwJ, ieuwJ, iedwJ of both modes at ``MS_RRS_REF_LEVELS`` from
    the JAX package on the CPU (the f32 scene's configuration in f64),
    keys "<mode>_<field>"."""
    from vsmartmom_tpu.core.multisensor import rt_run_ms_rrs
    out = {}
    for mode in MODES:
        res = rt_run_ms_rrs(solved_in_f64(jax_model(mode)),
                            list(MS_RRS_REF_LEVELS), mode=mode)
        out.update({f"{mode}_{k}": np.asarray(v) for k, v in zip(KEYS, res)})
    return out


@pytest.fixture(scope="module")
def jax_ms():
    return make_ms_rrs_ref()


@pytest.mark.parametrize("mode", MODES)
def test_ms_rrs_matches_jax(jax_ms, mode):
    """rt_run_ms_rrs at levels [0, 1, 2], [0] and [nz] against the JAX
    package's levels (0, 1, 2) (1e-10 of each field's max); the airborne
    level's ie fields nonzero."""
    from vsmartmom_tpu_torch.core.multisensor import rt_run_ms_rrs
    model = solved_in_f64(ms_rrs_ref_model(mode))
    nz = len(MS_RRS_REF_TAUS)
    runs = [(list(MS_RRS_REF_LEVELS), slice(None)), ([0], slice(0, 1)),
            ([nz], slice(nz, nz + 1))]
    for levels, rows in runs:
        out = rt_run_ms_rrs(model, levels, mode=mode, device="cpu")
        for k, v in zip(KEYS, out):
            ref = jax_ms[f"{mode}_{k}"]
            assert v.dtype == np.float64 and v.shape[0] == len(levels)
            assert float(np.max(np.abs(v - ref[rows]))) <= \
                1e-10 * np.max(np.abs(ref)), (levels, k)
    assert np.max(np.abs(jax_ms[f"{mode}_ieuwJ"][1])) > 0
    assert np.max(np.abs(jax_ms[f"{mode}_iedwJ"][1])) > 0


@pytest.mark.parametrize("mode", MODES)
def test_toa_sensor_equals_rt_run_inelastic(mode):
    """The port's own check of the JAX test: the TOA sensor's (uwJ, dwJ,
    ieuwJ, iedwJ) equal rt_run_inelastic's (R, T, ieR, ieT) (f64, 1e-10),
    and the level-0 downwelling pair the BOA sensor's."""
    from vsmartmom_tpu_torch.core.inelastic import rt_run_inelastic
    from vsmartmom_tpu_torch.core.multisensor import rt_run_ms_rrs
    ms = rt_run_ms_rrs(solved_in_f64(ms_rrs_ref_model(mode)), [0, 2],
                       mode=mode, device="cpu")
    full = rt_run_inelastic(solved_in_f64(ms_rrs_ref_model(mode)),
                            mode=mode, device="cpu")
    for a, b in zip(ms, full):
        assert _rel(a[0], b) <= 1e-10
    for k in (1, 3):
        assert _rel(ms[k][0], ms[k][1]) <= 1e-10


def test_ms_rrs_on_the_cpu():
    """The f32 scene on the CPU (plain torch, as on the card) against the
    stored JAX reference (1e-4 of each field's max), for both modes; the
    per-moment ie stash reckoned as (nz, nR, nSpec, N, N) per matrix
    field; levels outside [0, nz] refused."""
    from vsmartmom_tpu_torch.core.inelastic import inelastic_setup
    from vsmartmom_tpu_torch.core.multisensor import (ie_stash_bytes,
                                                      rt_run_ms_rrs)
    stored = np.load(REF_PATH)
    for mode in MODES:
        model = ms_rrs_ref_model(mode)
        out = rt_run_ms_rrs(model, MS_RRS_REF_LEVELS, mode=mode,
                            device="cpu")
        for k, v in zip(KEYS, out):
            assert v.dtype == np.float32
            assert _rel(v, stored[f"{mode}_{k}"]) <= 1e-4, (mode, k)
    _, config, shifts, *_ = inelastic_setup(model, mode=mode, device="cpu")
    per = config.nz * len(shifts) * config.n_spec
    assert ie_stash_bytes(config, len(shifts)) == \
        (4 * config.N ** 2 + 2 * config.N) * per * 4
    with pytest.raises(ValueError, match="outside"):
        rt_run_ms_rrs(model, [config.nz + 1], mode=mode, device="cpu")


def test_stored_ms_rrs_reference_is_current(jax_ms):
    stored = np.load(REF_PATH)
    assert sorted(stored.files) == sorted(jax_ms)
    for k, v in jax_ms.items():
        assert stored[k].shape == v.shape
        assert _rel(stored[k], v) <= 1e-12, k


def test_rt_run_ms_rrs_needs_cuda_or_an_explicit_device(monkeypatch):
    from vsmartmom_tpu_torch import rt_run_ms_rrs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt_run_ms_rrs(ms_rrs_ref_model(), [0])


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax
    jax.config.update("jax_platforms", "cpu")
    np.savez(REF_PATH, **make_ms_rrs_ref())
    print(f"wrote {REF_PATH}")
