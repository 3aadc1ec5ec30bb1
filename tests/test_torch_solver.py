"""The port's plain solver (vsmartmom_tpu_torch, device="cpu") against the
JAX package's ``rt_solve`` / ``rt_run`` on identical inputs.

Both packages run on the JAX ``build_band`` output (handed across with
``solver_inputs_from_numpy`` / ``solver_config_from_dict``) at the small
flagship scene of tests/test_packed_solver.py (nstreams = 4, nSpec = 8:
N = 36, nz = 33, ndoubl = 8). Tolerances, relative to max|ref|: 1e-9 in
f64; 2e-5 in f32, where the two frameworks sum products in another order.

Also holds the stored cross-framework reference
``vsmartmom_tpu_torch/data/flagship_ref_f64.npz`` (flagship, nstreams = 8,
nSpec = 16, solved in f64 by the JAX package on the CPU), which the chip
smoke test compares the port's kernel path against: a test regenerates it
here so it cannot go stale. ``python tests/test_torch_solver.py`` rewrites it.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from port_threads import _one_thread  # noqa: F401  (autouse)

KEYS = ("R", "T", "hdr", "bhr_uw", "bhr_dw")
TOL = {np.float64: 1e-9, np.float32: 2e-5}
REF_PATH = (Path(__file__).resolve().parents[1] / "vsmartmom_tpu_torch"
            / "data" / "flagship_ref_f64.npz")
REF_N_SPEC = 16


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _port(jax_inputs, jax_config, **replace):
    """The port's rt_solve on the JAX build_band output, on the CPU."""
    from vsmartmom_tpu_torch.core.solver import rt_solve
    from vsmartmom_tpu_torch.core.types import (solver_config_from_dict,
                                                solver_inputs_from_numpy)
    cfg = solver_config_from_dict(
        dataclasses.asdict(dataclasses.replace(jax_config, **replace)))
    inp = solver_inputs_from_numpy(
        {f: np.asarray(getattr(jax_inputs, f)) for f in jax_inputs._fields},
        "cpu")
    return {k: v.numpy() for k, v in rt_solve(inp, cfg, "cpu").items()
            if v is not None}


def _jax(jax_inputs, jax_config, **replace):
    from vsmartmom_tpu.core.solver import rt_solve
    out = rt_solve(jax_inputs, dataclasses.replace(jax_config, **replace))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def scenes():
    """JAX build_band output of the Cox-Munk and the Lambertian scene."""
    from __graft_entry__ import _flagship_model
    out = {}
    for surface in ("coxmunk", "lambertian"):
        model = _flagship_model(n_spec=8, nstreams=4, surface=surface)
        out[surface] = model.build_band(0)
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("surface", ["coxmunk", "lambertian"])
def test_plain_solver_matches_jax(scenes, surface, dtype):
    inputs, config = scenes[surface]
    ref = _jax(inputs, config, dtype=dtype)
    out = _port(inputs, config, dtype=dtype)
    for k in KEYS:
        assert _rel(out[k], ref[k]) <= TOL[dtype], (k, _rel(out[k], ref[k]))


def test_thermal_and_sif_sources_match_jax(scenes):
    """Two source slots (solar + per-layer Planck thermal) and surface SIF
    emission, from seeded random spectra, through the plain path."""
    inputs, config = scenes["lambertian"]
    rng = np.random.default_rng(1)
    inputs = dataclasses.replace(
        inputs, thermal_b=rng.uniform(0.1, 1.0, np.shape(inputs.thermal_b)),
        sif_spec=rng.uniform(0.0, 0.05, np.shape(inputs.sif_spec)))
    kw = dict(dtype=np.float64, n_sources=2)
    ref, out = _jax(inputs, config, **kw), _port(inputs, config, **kw)
    for k in KEYS:
        assert _rel(out[k], ref[k]) <= 1e-9, k


def test_without_moment_split_matches_jax(scenes):
    """m_scat = m_max: every moment through the full layer chain. Only the
    Cox-Munk scene splits; the Lambertian one has m_scat == m_max already,
    so test_plain_solver_matches_jax covers it unsplit."""
    assert scenes["lambertian"][1].m_scat == scenes["lambertian"][1].m_max
    inputs, config = scenes["coxmunk"]
    assert config.m_scat < config.m_max
    kw = dict(dtype=np.float64, m_scat=config.m_max)
    ref, out = _jax(inputs, config, **kw), _port(inputs, config, **kw)
    for k in KEYS:
        assert _rel(out[k], ref[k]) <= 1e-9, k


def test_streams_match_jax(scenes):
    """Per-moment stream vectors (save_streams), both halves of the moment
    split: m <= m_scat through the layers, the rest through Beer's law."""
    inputs, config = scenes["coxmunk"]
    kw = dict(dtype=np.float64, save_streams=True)
    ref, out = _jax(inputs, config, **kw), _port(inputs, config, **kw)
    for k in ("J_up_per_m", "J_dn_per_m", "J0_up_toa", "J0_dn_boa"):
        assert out[k].shape == ref[k].shape, k
        assert _rel(out[k], ref[k]) <= 1e-9, k


def test_rt_run_matches_jax_with_tms():
    """rt_run end to end, host TMS glint correction included, f64 models
    built by each package's own host code."""
    from __graft_entry__ import _flagship_model
    from vsmartmom_tpu.core.solver import rt_run as jax_rt_run
    from vsmartmom_tpu_torch import flagship_model, rt_run
    R_ref, T_ref = jax_rt_run(_flagship_model(n_spec=8, nstreams=4,
                                              dtype=np.float64))
    R, T = rt_run(flagship_model(n_spec=8, nstreams=4, dtype=np.float64),
                  device="cpu")
    assert _rel(R, R_ref) <= 1e-9 and _rel(T, T_ref) <= 1e-9


def test_rt_run_streams_matches_jax():
    from __graft_entry__ import _flagship_model
    from vsmartmom_tpu.core.solver import rt_run_streams as jax_streams
    from vsmartmom_tpu_torch import flagship_model, rt_run_streams
    ref = jax_streams(_flagship_model(n_spec=4, nstreams=3,
                                      dtype=np.float64))
    out = rt_run_streams(flagship_model(n_spec=4, nstreams=3,
                                        dtype=np.float64), device="cpu")
    assert set(out) == set(ref)
    for k in ("J_up_per_m", "J_dn_per_m", "weights", "qp_mu", "tau_total",
              "R"):
        assert out[k].shape == np.shape(ref[k]), k
        assert _rel(out[k], ref[k]) <= 1e-9, k


def test_near_duplicate_nodes():
    """sza = vza = 60 deg at nstreams = 3: cos(60) must merge with the Gauss
    node 0.5 (tolerance dedup) and the elemental same-mu branch must hold,
    or f32 roundoff in mu_j/(mu_i - mu_j) blows up."""
    from vsmartmom_tpu.core.model import Parameters as JParameters
    from vsmartmom_tpu.core.model import SurfaceDescriptor as JSurface
    from vsmartmom_tpu.core.model import model_from_parameters as jax_build
    from vsmartmom_tpu.core.solver import rt_run as jax_rt_run
    from vsmartmom_tpu.scattering.stokes import STOKES_IQUV as J_IQUV
    from vsmartmom_tpu_torch import (Parameters, SurfaceDescriptor,
                                     model_from_parameters, rt_run)
    from vsmartmom_tpu_torch.flagship import FLAGSHIP_P, FLAGSHIP_T
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_IQUV
    kw = dict(spec_bands=[19417.0 + 0.05 * np.arange(4)], nstreams=3,
              sza=60.0, vza=[60.0], vaz=[0.0], obs_alt=1000.0,
              T=FLAGSHIP_T, p=FLAGSHIP_P, float_type=np.float32)
    jm = jax_build(JParameters(
        surfaces=[JSurface("LambertianSurfaceScalar", [0.1])],
        polarization=J_IQUV, **kw))
    pm = model_from_parameters(Parameters(
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar", [0.1])],
        polarization=STOKES_IQUV, **kw))
    assert pm.quad.Nquad == jm.quad.Nquad == 3    # 60 deg merged with 0.5
    R_ref, T_ref = jax_rt_run(jm)
    R, T = rt_run(pm, device="cpu")
    assert np.isfinite(R).all() and np.isfinite(T).all()
    assert _rel(R, R_ref) <= 2e-5 and _rel(T, T_ref) <= 2e-5


def make_flagship_ref():
    """R, T of the flagship (nstreams = 8, nSpec = 16) from the JAX package
    on the CPU: the f32 model's configuration solved in f64, TMS included."""
    from __graft_entry__ import _flagship_model
    from vsmartmom_tpu.core.solver import rt_solve
    from vsmartmom_tpu.surfaces.coxmunk import CoxMunkSurface, tms_correction
    model = _flagship_model(n_spec=REF_N_SPEC, nstreams=8)
    inputs, config = model.build_band(0)
    out = rt_solve(inputs, dataclasses.replace(config, dtype=np.float64))
    R = np.asarray(out["R"]) + tms_correction(
        CoxMunkSurface(wind_speed=5.0), config.n_stokes, model.params.vza,
        model.params.vaz, model.quad.mu0, np.asarray(inputs.tau).sum(axis=0),
        config.m_max)
    return {"R": R, "T": np.asarray(out["T"])}


def test_stored_flagship_reference_is_current():
    stored = np.load(REF_PATH)
    fresh = make_flagship_ref()
    for k in ("R", "T"):
        assert stored[k].shape == fresh[k].shape
        assert _rel(stored[k], fresh[k]) <= 1e-12, k


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    np.savez(REF_PATH, **make_flagship_ref())
    print(f"wrote {REF_PATH}")
