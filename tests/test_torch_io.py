"""The port's scene-file front end (``vsmartmom_tpu_torch/io``:
``formats``, ``yaml_input``) against the JAX package's on the CPU: the
same dicts and files give the same ``Parameters``, field by field (arrays
equal, bit for bit); the schema, the safe numeric parser and the parse
errors behave as the JAX package's. A ``canopy:`` section gives both
packages' CanopySurface (its fields: ``tests/test_torch_canopy.py``)."""

import copy
import dataclasses
import json
import textwrap

import numpy as np
import pytest

from port_threads import _one_thread  # noqa: F401  (autouse)

#: The keywords ``parameters_from_dict`` sets: every one is compared.
PARSED = ("spec_bands", "surfaces", "nstreams", "polarization", "sza", "vza",
          "vaz", "obs_alt", "T", "p", "q", "profile_reduction", "depol",
          "float_type", "truncation", "quadrature", "absorption_params",
          "scattering_params")

BASE = {
    "radiative_transfer": {
        "spec_bands": ["[12987.0]"],
        "surface": ["LambertianSurfaceScalar(0.15)"],
        "polarization_type": "Stokes_I()", "nstreams": 3, "depol": 0.0,
        "float_type": "Float64", "architecture": "default_architecture"},
    "geometry": {"sza": 30.0, "vza": [0.0], "vaz": [0.0], "obs_alt": 0.0},
    "atmospheric_profile": {"T": [250.0, 275.0], "p": [10.0, 500.0, 1000.0],
                            "profile_reduction": -1},
}


def _scene(kind):
    d = copy.deepcopy(BASE)
    rt = d["radiative_transfer"]
    if kind == "bands_aerosols_gas":
        rt.update(spec_bands=["(1e7/775):0.5:(1e7/770)", "13000:0.5:13002",
                              "[13100.0, 13100.5 13101]"],
                  surface=["LambertianSurfaceScalar(0.15)",
                           "CoxMunkSurface(wind_speed=7.0)"],
                  polarization_type="Stokes_IQUV()", nstreams=8,
                  truncation="δBGE(15, 2.0)")
        d["geometry"] = {"sza": 42.0, "vza": [0.0, 30.0, 60.0],
                         "vaz": [0.0, 90.0, 180.0], "obs_alt": 700.0}
        d["atmospheric_profile"].update(q=[0.001, 0.01],
                                        profile_reduction=1)
        d["scattering"] = {
            "aerosols": [
                {"τ_ref": 0.1, "p₀": 700.0, "σp": 50.0, "μ": 0.1,
                 "σ": 1.5, "nᵣ": 1.4, "nᵢ": 0.003},
                {"τ_ref": 0.05, "p0": 300.0, "sigma_p": 20.0,
                 "phase_function": "HenyeyGreensteinPhaseFunction(0.7)",
                 "ssa": 0.9}],
            "r_max": 5.0, "nquad_radius": 100, "λ_ref": 0.77,
            "n_ref": "1.45 - 0.002im", "decomp_type": "PCW()"}
        d["absorption"] = {
            "molecules": [["O2"], ["O2", "H2O"], []],
            "vmr": {"O2": 0.21, "H2O": [0.01, 0.02]},
            "broadening": "Voigt()", "CEF":
            "HumlicekWeidemann32SDErrorFunction()", "wing_cutoff": 25,
            "par_paths": {"O2": "${ENV:VSM_TEST_PAR_DIR}/o2.par"}}
    elif kind == "legacy_radau_altitude":
        rt.pop("nstreams")
        rt.update(l_trunc=10, quadrature_type="RadauQuad()",
                  polarization_type="Stokes_IQU()", float_type="Float32",
                  truncation="NoTruncation()", depol=0.03)
        d["scattering"] = {"aerosols": [
            {"τ_ref": 0.2, "z₀": 3.0, "σ₀": 0.3, "μ": 0.2, "σ": 1.6,
             "nᵣ": 1.5, "nᵢ": 0.01}]}
    return d


def _same(a, b, where="params"):
    """Field-by-field equality of the two packages' objects: dataclasses
    by their common fields (of the same class name), arrays bit for
    bit."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        fa = {f.name for f in dataclasses.fields(a)}
        fb = {f.name for f in dataclasses.fields(b)}
        for name in sorted(fa & fb):
            _same(getattr(a, name), getattr(b, name), f"{where}.{name}")
        return sorted(fa & fb)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def _same_params(port, ref):
    common = _same(port, ref)
    assert set(PARSED) <= set(common)


@pytest.mark.parametrize("kind", ["rayleigh", "bands_aerosols_gas",
                                  "legacy_radau_altitude"])
def test_parameters_from_dict_matches_jax(kind, monkeypatch):
    from vsmartmom_tpu.io.yaml_input import parameters_from_dict as jax_pfd
    from vsmartmom_tpu_torch import parameters_from_dict
    monkeypatch.setenv("VSM_TEST_PAR_DIR", "/data/lines")
    d = _scene(kind)
    port, ref = parameters_from_dict(copy.deepcopy(d)), jax_pfd(d)
    _same_params(port, ref)
    if kind == "bands_aerosols_gas":
        assert len(port.spec_bands) == 3 and port.spec_bands[0].size == 168
        assert port.absorption_params.par_paths == {
            "O2": "/data/lines/o2.par"}
        assert port.scattering_params.decomp_type == "PCW"
        assert port.scattering_params.n_ref == complex(1.45, -0.002)
    if kind == "legacy_radau_altitude":
        assert port.nstreams == 6 and port.quadrature == "RadauQuad"


TOML_SCENE = textwrap.dedent("""
    [radiative_transfer]
    spec_bands = ["13000:0.5:13002"]
    surface = ["CoxMunkSurface(wind_speed=7.0)"]
    polarization_type = "Stokes_IQU()"
    nstreams = 4
    truncation = "auto"
    depol = -1.0
    float_type = "Float32"
    architecture = "default_architecture"

    [geometry]
    sza = 30.0
    vza = [0.0, 45.0]
    vaz = [0.0, 90.0]
    obs_alt = 0.0

    [atmospheric_profile]
    T = [250.0, 275.0]
    p = [10.0, 500.0, 1000.0]
    profile_reduction = -1

    [scattering]
    r_max = 5.0
    nquad_radius = 100
    "λ_ref" = 0.55

    [[scattering.aerosols]]
    "τ_ref" = 0.1
    "p₀" = 700.0
    "σp" = 50.0
    "μ" = 0.1
    "σ" = 1.5
    "nᵣ" = 1.4
    "nᵢ" = 0.003
""")


@pytest.mark.parametrize("fmt", ["yaml", "toml", "json"])
def test_scene_files_match_jax(tmp_path, fmt):
    """The same scene as YAML, TOML and JSON through
    ``parameters_from_file`` (schema-validated) of both packages, and
    ``parameters_from_yaml`` / ``parameters_from_toml``; each file equal to
    the dict it was written from."""
    import vsmartmom_tpu.io.yaml_input as J
    import vsmartmom_tpu_torch as P
    if fmt == "toml":
        text = TOML_SCENE
        import tomllib
        d = tomllib.loads(text)
    else:
        d = _scene("bands_aerosols_gas")
        d.pop("absorption")
        if fmt == "yaml":
            import yaml
            text = yaml.safe_dump(d, allow_unicode=True)
        else:
            text = json.dumps(d, ensure_ascii=False)
    path = tmp_path / f"scene.{fmt}"
    path.write_text(text)
    port, ref = P.parameters_from_file(str(path)), \
        J.parameters_from_file(str(path))
    _same_params(port, ref)
    _same_params(port, P.parameters_from_dict(d))
    if fmt == "yaml":
        _same_params(P.parameters_from_yaml(str(path)),
                     J.parameters_from_yaml(str(path)))
    if fmt == "toml":
        _same_params(P.parameters_from_toml(str(path)),
                     J.parameters_from_toml(str(path)))
        assert port.scattering_params.rt_aerosols[0].p0 == 700.0


def test_schema_rejects_unknown_keys_and_sections():
    """The port's copy of the schema is the JAX package's, byte for byte;
    an unknown key and an unknown section fail validation in both
    packages, a valid scene passes."""
    from pathlib import Path

    import vsmartmom_tpu.io.formats as J
    import vsmartmom_tpu_torch.io.formats as P
    assert Path(P._SCHEMA_PATH).resolve().read_bytes() == \
        Path(J._SCHEMA_PATH).resolve().read_bytes()
    for kind in ("rayleigh", "bands_aerosols_gas"):
        d = _scene(kind)
        d.get("absorption", {}).pop("par_paths", None)
        P.validate_config(d)
        J.validate_config(d)
    bad = _scene("rayleigh")
    bad["radiative_transfer"]["not_a_real_key"] = 1
    for fmt in (P, J):
        with pytest.raises(ValueError, match="not_a_real_key"):
            fmt.validate_config(bad)
    bad = _scene("rayleigh")
    bad["mystery_section"] = {}
    for fmt in (P, J):
        with pytest.raises(ValueError, match="schema validation"):
            fmt.validate_config(bad)


def test_safe_numeric_parser_matches_jax():
    from vsmartmom_tpu.io.yaml_input import _eval_number as jax_eval
    from vsmartmom_tpu_torch.io.yaml_input import _eval_number
    for tok in ("(1e7/770)", "2+3*4", "-1.5e3", " 2**10 ", "+(3-1)/4",
                "12987.0"):
        assert _eval_number(tok) == jax_eval(tok)
    assert _eval_number("(1e7/770)") == pytest.approx(1e7 / 770)
    for bad in ("__import__('os')", "().__class__", "open('x')",
                "1 if 1 else 2", "[1,2]", "1/0", "x", "lambda: 1"):
        with pytest.raises(ValueError):
            _eval_number(bad)
        with pytest.raises(ValueError):
            jax_eval(bad)


def test_unregistered_extension_raises(tmp_path, monkeypatch):
    from vsmartmom_tpu_torch.io import formats
    from vsmartmom_tpu_torch.io.formats import load_config, register_format
    monkeypatch.setattr(formats, "_format_registry",
                        dict(formats._format_registry))
    p = tmp_path / "scene.xml"
    p.write_text("<x/>")
    with pytest.raises(ValueError, match="No parser registered"):
        load_config(str(p))
    p = tmp_path / "scene.cfg"
    p.write_text("{}")
    with pytest.raises(ValueError, match="No parser registered"):
        load_config(str(p))
    register_format(".CFG", lambda path: {"read": path})
    assert load_config(str(p)) == {"read": str(p)}


def test_canopy_section_raises_not_implemented():
    """Both packages wrap each surface in a CanopySurface (ported since
    the canopy slice; the full field-by-field check is in
    tests/test_torch_canopy.py), and both refuse what neither implements:
    Chen-Leblanc clumping."""
    from vsmartmom_tpu.io.yaml_input import parameters_from_dict as jax_pfd
    from vsmartmom_tpu_torch import parameters_from_dict
    d = _scene("rayleigh")
    d["canopy"] = {"LAI": 2.0, "n_layers": 1}
    port, ref = parameters_from_dict(d), jax_pfd(d)
    assert port.surfaces[0].kind == ref.surfaces[0].kind == "CanopySurface"
    a, b = (p.surfaces[0].kwargs["_surface_obj"] for p in (port, ref))
    assert (a.LAI, a.n_layers, a.soil.kind) == (b.LAI, b.n_layers,
                                                b.soil.kind)
    d["canopy"]["clumping"] = {"type": "ChenLeblanc"}
    for fn in (parameters_from_dict, jax_pfd):
        with pytest.raises(ValueError, match="Chen-Leblanc"):
            fn(d)


def test_parse_errors_match_jax():
    """An aerosol with both vertical forms or none, an unknown phase
    function, quadrature or polarization, and no stream count: the same
    exception from both packages."""
    from vsmartmom_tpu.io.yaml_input import parameters_from_dict as jax_pfd
    from vsmartmom_tpu_torch import parameters_from_dict
    for case, exc in [("both_forms", ValueError), ("no_form", ValueError),
                      ("phase_function", NotImplementedError),
                      ("quadrature", ValueError), ("no_streams", KeyError),
                      ("polarization", ValueError)]:
        d = _scene("rayleigh")
        aer = {"τ_ref": 0.1, "μ": 0.1, "σ": 1.5, "nᵣ": 1.4, "nᵢ": 0.0}
        if case == "both_forms":
            aer.update({"p₀": 700.0, "σp": 50.0, "z₀": 3.0, "σ₀": 0.3})
        elif case == "phase_function":
            aer.update({"p₀": 700.0, "σp": 50.0,
                        "phase_function": "RayleighPhaseFunction()"})
        elif case == "quadrature":
            d["radiative_transfer"]["quadrature_type"] = "LobattoQuad()"
        elif case == "no_streams":
            d["radiative_transfer"].pop("nstreams")
        elif case == "polarization":
            d["radiative_transfer"]["polarization_type"] = "Stokes_V()"
        if case in ("both_forms", "no_form", "phase_function"):
            d["scattering"] = {"aerosols": [aer]}
        with pytest.raises(exc):
            parameters_from_dict(copy.deepcopy(d))
        with pytest.raises(exc):
            jax_pfd(d)


def test_polarization_and_band_strings_match_jax():
    """``polarization_from_name`` and the band strings (lists, literals,
    ranges with arithmetic tokens, two-part ranges, a bare number) of both
    packages."""
    from vsmartmom_tpu.io.yaml_input import _parse_band as jax_band
    from vsmartmom_tpu.scattering.stokes import \
        polarization_from_name as jax_pol
    from vsmartmom_tpu_torch.io.yaml_input import _parse_band
    from vsmartmom_tpu_torch.scattering.stokes import polarization_from_name
    for name in ("Stokes_I", "Stokes_IQ()", " Stokes_IQU() ", "Stokes_IQUV"):
        _same(polarization_from_name(name), jax_pol(name))
    for spec in ("[12987.0]", "[1, 2.5, 3]", "(1e7/775):0.05:(1e7/770)",
                 "13000:13004", "19417.0:0.05:19621.75", "14000",
                 [13000.0, 13001.0]):
        a, b = _parse_band(spec), jax_band(spec)
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_parse_band("19417.0:0.05:19621.75"),
                                  19417.0 + 0.05 * np.arange(4096))
