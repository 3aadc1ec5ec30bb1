"""The GEOS-Chem column path of the port against the JAX package on the
CPU: ``io.geoschem`` on the synthetic GCHP collections of
``flagship.write_geoschem_column``, the aerosol profiles read from them,
the scene's ``Parameters`` and ``RTAerosol``s, and the small GEOS-Chem
scene (``flagship.geoschem_ref_model``: 6 levels, sulfate and dust,
nstreams 3, IQU, 8 points) end to end. Tolerances, relative to max|ref|:

* the met column (T, p): equal; q: the JAX package's divided by 1000
  (GCHP's Met_SPHU is g/kg, which the JAX package passes to a profile that
  takes kg/kg: a reference-side fault, ROADMAP.md section 3);
* the aerosol profiles the port reads from the GCHP-ordered collection:
  equal to those both packages read from its ``(lev, time)`` twin, the
  layout the JAX readers read right (they misread GCHP's own order);
* the scene's ``Parameters``: equal; its ``RTAerosol``s: 1e-12;
* ``rt_run`` of the small scene: the port's f64 plain path against the
  stored ``vsmartmom_tpu_torch/data/geoschem_ref_f64.npz`` (the JAX
  package's R and T from the same files) 1e-9, the port's f32 against the
  JAX package's f32 2e-5, the stored file against a fresh JAX run 1e-12
  (``python tests/test_torch_geoschem.py`` rewrites it, PYTHONPATH=.).

JAX outputs are converted with ``np.asarray`` before the torch side runs.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from port_threads import _one_thread  # noqa: F401  (autouse)

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from vsmartmom_tpu_torch.flagship import (  # noqa: E402
    GEOSCHEM_COLUMN, GEOSCHEM_REF_N_LEV, GEOSCHEM_REF_NQUAD,
    GEOSCHEM_REF_N_SPEC, GEOSCHEM_REF_NSTREAMS, GEOSCHEM_REF_SPECIES,
    geoschem_aerosol_config, geoschem_scene_toml, write_geoschem_column)

DATA = Path(__file__).resolve().parents[1] / "vsmartmom_tpu_torch" / "data"
REF_PATH = DATA / "geoschem_ref_f64.npz"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The small scene's collections: StateMet and Aerosols in GCHP's
    order, and the Aerosols' (lev, time) twin."""
    return write_geoschem_column(tmp_path_factory.mktemp("gchp"),
                                 n_lev=GEOSCHEM_REF_N_LEV,
                                 species=GEOSCHEM_REF_SPECIES)


def jax_geoschem_params(files, dtype, directory):
    """The JAX package's ``Parameters`` of ``flagship.geoschem_ref_model``,
    composed as that function composes the port's: the same scene file
    (``geoschem_scene_toml``) and met column, the JAX ``geoschem_to_dict``
    with q divided by 1000 (kg/kg, as the port reads it),
    ``parameters_from_dict``, and ``to_rt_aerosols`` of
    ``read_aerosol_data`` on the ``(lev, time)`` twin at the column's layer
    mid-pressures."""
    from vsmartmom_tpu.aerosols import (load_refractive_index_database,
                                        read_aerosol_data, to_rt_aerosols)
    from vsmartmom_tpu.io.formats import load_config
    from vsmartmom_tpu.io.geoschem import GeosChemSource, geoschem_to_dict
    from vsmartmom_tpu.io.yaml_input import parameters_from_dict
    scene = Path(directory) / f"jax_scene_{np.dtype(dtype).name}.toml"
    scene.write_text(geoschem_scene_toml(
        GEOSCHEM_REF_N_SPEC, dtype, GEOSCHEM_REF_NSTREAMS, "Stokes_IQU",
        GEOSCHEM_REF_NQUAD))
    d = load_config(str(scene))
    prof = geoschem_to_dict(GeosChemSource(files["met"], *GEOSCHEM_COLUMN))[
        "atmospheric_profile"]
    prof["q"] = prof["q"] / 1000.0
    d["atmospheric_profile"] = prof
    params = parameters_from_dict(d)
    data = read_aerosol_data(geoschem_aerosol_config(GEOSCHEM_REF_SPECIES),
                             files["aerosols_lev_time"])
    p = prof["p"]
    params.scattering_params.rt_aerosols = to_rt_aerosols(
        data, load_refractive_index_database(), p_full=0.5 * (p[1:] + p[:-1]))
    return params


def jax_geoschem_run(files, dtype, directory):
    """(R, T) of the JAX package's ``rt_run`` of the small scene, as
    numpy."""
    from vsmartmom_tpu import model_from_parameters, rt_run
    R, T = rt_run(model_from_parameters(jax_geoschem_params(files, dtype,
                                                            directory)))
    return np.asarray(R), np.asarray(T)


@pytest.fixture(scope="module")
def jax_runs(files, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_scene")
    return {dt: jax_geoschem_run(files, dt, d)
            for dt in (np.float64, np.float32)}


def test_geoschem_column_matches_jax(files):
    """``geoschem_to_dict`` and ``read_geoschem_profile`` of one column:
    T and p equal to the JAX package's, TOA first; q the JAX package's
    over 1000."""
    import vsmartmom_tpu.io.geoschem as J
    import vsmartmom_tpu_torch.io.geoschem as P
    src = (files["met"], *GEOSCHEM_COLUMN)
    port = P.geoschem_to_dict(P.GeosChemSource(*src))
    ref = J.geoschem_to_dict(J.GeosChemSource(*src))
    assert port.keys() == ref.keys() == {"atmospheric_profile"}
    a, b = port["atmospheric_profile"], ref["atmospheric_profile"]
    assert a.keys() == b.keys()
    for k in ("T", "p"):
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["q"], b["q"] / 1000.0)
    assert a["profile_reduction"] == b["profile_reduction"] == -1
    assert a["T"].shape == (GEOSCHEM_REF_N_LEV,)
    assert np.all(np.diff(a["p"]) > 0) and 990.0 < a["p"][-1] < 1010.0
    assert 0.02 < a["p"][0] < 0.06
    T, p, q, vmr = P.read_geoschem_profile(P.GeosChemSource(*src))
    for x, y in ((T, a["T"]), (p, a["p"]), (q, a["q"])):
        np.testing.assert_array_equal(x, y)
    assert vmr == {}


def test_specific_humidity_units(files):
    """GCHP's Met_SPHU is g/kg (~5 in the lowest of 6 layers here). The
    port's profile gets kg/kg; the JAX package's gets g/kg, which its
    profile clips at 0.5 kg/kg: a water-vapour fraction near 0.62 and a
    dry column cut by that much in the moist layers."""
    import vsmartmom_tpu.io.geoschem as J
    from vsmartmom_tpu.core.atmosphere import \
        compute_atmos_profile_fields as jax_profile
    import vsmartmom_tpu_torch.io.geoschem as P
    from vsmartmom_tpu_torch.core.atmosphere import \
        compute_atmos_profile_fields
    src = (files["met"], *GEOSCHEM_COLUMN)
    T, p, q, _ = P.read_geoschem_profile(P.GeosChemSource(*src))
    jT, jp, jq, _ = J.read_geoschem_profile(J.GeosChemSource(*src))
    assert 1.0 < jq[-1] < 20.0 and 0.001 < q[-1] < 0.02
    port, ref = compute_atmos_profile_fields(T, p, q), jax_profile(jT, jp, jq)
    assert port.vmr_h2o[-1] < 0.03 and ref.vmr_h2o[-1] > 0.6
    assert ref.vcd_dry[-1] < 0.5 * port.vcd_dry[-1]


def test_aerosol_profiles_from_gchp_order(files):
    """Every aerosol array the port reads from the GCHP-ordered collection
    equals, exactly, what both packages read from the (lev, time) twin.
    The JAX reader on the GCHP-ordered collection returns profiles of the
    wrong length (Ydim, not lev)."""
    from vsmartmom_tpu.aerosols import read_aerosol_data as jax_read
    from vsmartmom_tpu_torch.aerosols import read_aerosol_data
    cfg = geoschem_aerosol_config(GEOSCHEM_REF_SPECIES)
    port = read_aerosol_data(cfg, files["aerosols"])
    twin = read_aerosol_data(cfg, files["aerosols_lev_time"])
    ref = jax_read(cfg, files["aerosols_lev_time"])
    for other in (twin, ref):
        assert list(port.species_data) == list(other.species_data)
        for sp, d in port.species_data.items():
            for k, v in d.data.items():
                assert v.shape == (GEOSCHEM_REF_N_LEV,)
                np.testing.assert_array_equal(v, other.species_data[sp]
                                              .data[k])
    assert sum(d.data["aod"].sum() for d in port.species_data.values()) > 0.1
    wrong = jax_read(cfg, files["aerosols"])
    assert wrong.species_data["SO4"].data["aod"].shape != \
        (GEOSCHEM_REF_N_LEV,)


def test_scene_parameters_and_aerosols_match_jax(files, tmp_path):
    """The small scene's ``Parameters`` from both front ends, field by
    field (the port's with its aerosols from the GCHP-ordered collection,
    the JAX package's from the twin): equal, the RTAerosols 1e-12; the
    composed dict passes the schema; nothing in the port's build read
    the ``lev`` coordinate as a pressure."""
    from test_torch_io import _same
    from vsmartmom_tpu_torch.flagship import geoschem_ref_model
    model = geoschem_ref_model(files=files, validate=True)
    port = model.params
    ref = jax_geoschem_params(files, np.float64, tmp_path)
    aers, refs = port.scattering_params.rt_aerosols, \
        ref.scattering_params.rt_aerosols
    port.scattering_params.rt_aerosols = ref.scattering_params.rt_aerosols \
        = []
    _same(port, ref)
    assert len(aers) == len(refs) == 2
    for a, b in zip(aers, refs):
        for f, v in a.__dict__.items():
            w = getattr(b, f)
            assert (v is None and w is None) or \
                abs(v - w) <= 1e-12 * max(abs(w), 1e-300), f
    p_half = port.p
    for a in aers:
        assert p_half[0] < a.p0 < p_half[-1] and a.sigma_p > 0
    assert model.profile.nz == GEOSCHEM_REF_N_LEV
    assert len(model.bands[0].aerosols) == 2


def test_small_scene_f64_matches_the_stored_reference(files):
    from vsmartmom_tpu_torch import rt_run
    from vsmartmom_tpu_torch.flagship import geoschem_ref_model
    stored = np.load(REF_PATH)
    R, T = rt_run(geoschem_ref_model(files=files), device="cpu")
    assert R.shape == stored["R"].shape == (9, 3, GEOSCHEM_REF_N_SPEC)
    assert np.isfinite(R).all() and np.isfinite(T).all()
    assert _rel(R, stored["R"]) <= 1e-9 and _rel(T, stored["T"]) <= 1e-9


def test_small_scene_f32_matches_jax(files, jax_runs):
    from vsmartmom_tpu_torch import rt_run
    from vsmartmom_tpu_torch.flagship import geoschem_ref_model
    jR, jT = jax_runs[np.float32]
    model = geoschem_ref_model(np.float32, files=files)
    assert model.build_band(0, device="cpu")[1].dtype == np.float32
    assert _rel(jR, jax_runs[np.float64][0]) > 1e-9     # an f32 solve
    R, T = rt_run(model, device="cpu")
    assert _rel(R, jR) <= 2e-5 and _rel(T, jT) <= 2e-5


def test_stored_geoschem_reference_is_current(jax_runs):
    stored = np.load(REF_PATH)
    for k, v in zip(("R", "T"), jax_runs[np.float64]):
        assert stored[k].shape == v.shape
        assert _rel(stored[k], v) <= 1e-12, k


def test_full_scene_validates_and_builds(tmp_path):
    """The GEOS-Chem column scene at its full width, cut to 8 points: the
    composed dict passes the schema; 72 layers, three Mie aerosols with
    column AODs of ~0.12, ~0.05 and ~0.08, N = 52; every layer's optical
    depth far below the plain path's f32 elemental overflow (dtau ~1.8)."""
    from vsmartmom_tpu_torch.flagship import geoschem_model
    files72 = write_geoschem_column(tmp_path)
    model = geoschem_model(n_spec=8, files=files72, validate=True)
    aers = model.params.scattering_params.rt_aerosols
    assert model.profile.nz == 72 and len(aers) == 3
    np.testing.assert_allclose([a.tau_ref for a in aers], [0.12, 0.05, 0.08],
                               rtol=0.1)
    inputs, config = model.build_band(0, device="cpu")
    assert config.N == 52 and config.nz == 72 and config.m_scat >= 1
    assert float(inputs.tau.max()) < 0.1


def make_geoschem_ref():
    """R and T of the small GEOS-Chem scene from the JAX package on the
    CPU in f64."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        files = write_geoschem_column(d, n_lev=GEOSCHEM_REF_N_LEV,
                                      species=GEOSCHEM_REF_SPECIES)
        R, T = jax_geoschem_run(files, np.float64, d)
    return {"R": R, "T": T}


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    np.savez(REF_PATH, **make_geoschem_ref())
    print(f"wrote {REF_PATH}")
