"""The port's aerosol ingest (``vsmartmom_tpu_torch/aerosols``) against the
JAX package's on the CPU, on the same seeded inputs and files. Tolerances:

* schemes and the unit / lognormal conversions: 1e-14 (relative);
* the JSON refractive database against the JAX package's YAML: equal,
  entry by entry;
* Mie efficiencies, the TOMAS-15 and two-moment readers (NetCDF-3, and
  NetCDF-4 where h5py is installed), bulk optics and ``to_rt_aerosols``:
  1e-12;
* ``horizontal_mean_profile``: bit for bit on the ``(..., lev, time)``
  layout that the JAX function reads right. On GCHP's own C order,
  ``(time, lev, nf, Ydim, Xdim)``, the port returns the level profile
  while the JAX function returns a Ydim-long vector (a reference-side
  fault, ROADMAP.md section 3): both are asserted.
"""

import numpy as np
import pytest

from port_threads import _one_thread  # noqa: F401  (autouse)

TOMAS_CFG = {
    "aerosol_scheme": {
        "type": "tomas15",
        "size_bins": {"n_bins": 15, "diam_min_nm": 3.0,
                      "diam_max_nm": 10000.0},
        "species": {
            "SF": {"refractive_index": "sulfate_suso", "density": 1780.0,
                   "molar_mass": 0.096},
            "DU": {"refractive_index": "dust_opac", "density": 2650.0,
                   "molar_mass": 0.1},
        },
    },
    "processing": {"vertical_flip": True},
}

TM_CFG = {
    "aerosol_scheme": {
        "type": "two_moment",
        "species": {
            "SO4": {"sigma_g": 2.03, "aod_reference_wavelength": 0.55,
                    "refractive_index": "sulfate_suso",
                    "aod_variable": "AODHyg550nm_{species}",
                    "radius_variable": "AerHygroscopicRadius_{species}"},
            "BC": {"sigma_g": 1.8, "aod_reference_wavelength": 0.55,
                   "refractive_index": "black_carbon",
                   "aod_variable": "AOD550nm_{species}",
                   "radius_variable": "Radius_{species}"},
        },
    },
    "processing": {"vertical_flip": True},
}

N_LEV = 5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _tomas_fields(rng, n_lev=N_LEV):
    """TOMAS-15 fields in the JAX test's (nf, Xdim, Ydim, lev, time)
    layout, drawn from ``rng``."""
    shape = (2, 2, 2, n_lev, 1)
    out = {"Met_AD": 3e15 * (1.0 + 0.1 * rng.random(shape)),
           "Met_AIRVOL": 5e13 * (1.0 + 0.1 * rng.random(shape))}
    for b in range(1, 16):
        out[f"SpeciesConcVV_NK{b:02d}"] = 1e-10 * b * (
            1.0 + 0.05 * rng.random(shape))
        out[f"SpeciesConcVV_SF{b}"] = 1e-12 * (1.0 + 0.05 * rng.random(shape))
        out[f"SpeciesConcVV_DU{b}"] = 3e-12 * (1.0 + 0.05 * rng.random(shape))
    return out


def _two_moment_fields(rng, n_lev=N_LEV):
    """Two-moment profiles as (lev, time) fields: AODs summing to ~0.2 and
    ~0.05, radii 0.1-0.2 um, drawn from ``rng``."""
    return {"AODHyg550nm_SO4": 0.04 * rng.uniform(0.5, 1.5, (n_lev, 1)),
            "AerHygroscopicRadius_SO4": rng.uniform(0.1, 0.2, (n_lev, 1)),
            "AOD550nm_BC": 0.01 * rng.uniform(0.5, 1.5, (n_lev, 1)),
            "Radius_BC": rng.uniform(0.05, 0.1, (n_lev, 1))}


DIMS = {5: ("nf", "Xdim", "Ydim", "lev", "time"), 2: ("lev", "time")}


def _write_nc3(path, fields, n_lev=N_LEV):
    from scipy.io import netcdf_file
    with netcdf_file(str(path), "w") as nc:
        for name, size in (("nf", 2), ("Xdim", 2), ("Ydim", 2),
                           ("lev", n_lev), ("time", 1)):
            nc.createDimension(name, size)
        lev = nc.createVariable("lev", "d", ("lev",))
        lev[:] = np.linspace(200.0, 1000.0, n_lev)
        for name, arr in fields.items():
            nc.createVariable(name, "d", DIMS[arr.ndim])[:] = arr
    return str(path)


def _write_nc4(path, fields, n_lev=N_LEV):
    """The same fields as NetCDF-4 (HDF5) with dimension scales."""
    h5py = pytest.importorskip("h5py")
    with h5py.File(str(path), "w") as f:
        for name, size in (("nf", 2), ("Xdim", 2), ("Ydim", 2),
                           ("time", 1)):
            f[name] = np.arange(size, dtype=np.float64)
            f[name].make_scale(name)
        f["lev"] = np.linspace(200.0, 1000.0, n_lev)
        f["lev"].make_scale("lev")
        for name, arr in fields.items():
            f[name] = arr
            for i, dim in enumerate(DIMS[arr.ndim]):
                f[name].dims[i].attach_scale(f[dim])
    return str(path)


def _assert_data_equal(port, ref, tol=1e-12):
    assert list(port.species_data) == list(ref.species_data)
    for sp, d in port.species_data.items():
        r = ref.species_data[sp]
        assert list(d.data) == list(r.data) and d.units == r.units
        assert d.description == r.description
        for k, v in d.data.items():
            assert v.shape == r.data[k].shape, (sp, k)
            assert _rel(v, r.data[k]) <= tol, (sp, k)
    for k, v in ref.coordinates.items():
        np.testing.assert_array_equal(port.coordinates[k], v)


def test_schemes_and_conversions_match_jax():
    import vsmartmom_tpu.aerosols as J
    import vsmartmom_tpu_torch.aerosols as P
    for cfg, cls in ((TOMAS_CFG, "TOMAS15Scheme"),
                     (TM_CFG, "TwoMomentScheme")):
        a = getattr(P, cls).from_config(cfg).__dict__
        b = getattr(J, cls).from_config(cfg).__dict__
        assert a.keys() == b.keys()
        for k, v in a.items():
            if isinstance(v, np.ndarray):
                assert _rel(v, b[k]) <= 1e-14, k
            else:
                assert v == b[k], k
    rng = np.random.default_rng(1)
    vmr, p, T = rng.uniform(1e-10, 1e-8, 7), rng.uniform(1e4, 1e5, 7), \
        rng.uniform(200.0, 300.0, 7)
    r = np.logspace(-3, 1, 50)
    pairs = [
        (P.compute_number_concentration(vmr, p, T),
         J.compute_number_concentration(vmr, p, T)),
        (P.compute_mass_concentration(vmr, 0.096, p, T),
         J.compute_mass_concentration(vmr, 0.096, p, T)),
        (P.bin_volume(137.0), J.bin_volume(137.0)),
        (P.scale_aod_wavelength(0.2, 0.55, 0.77, 1.3),
         J.scale_aod_wavelength(0.2, 0.55, 0.77, 1.3)),
        (P.effective_radius_from_moments(0.1, 1.8),
         J.effective_radius_from_moments(0.1, 1.8)),
        (P.median_radius_from_effective(0.3, 2.0),
         J.median_radius_from_effective(0.3, 2.0)),
        (P.lognormal_size_distribution(r, 0.3, 1.7),
         J.lognormal_size_distribution(r, 0.3, 1.7))]
    for i, (a, b) in enumerate(pairs):
        assert _rel(a, b) <= 1e-14, i


def test_json_refractive_database_equals_the_jax_yaml(tmp_path):
    """The port's JSON database holds the JAX package's six species with
    the same numbers; a YAML database still loads (the JAX file through
    the port's loader)."""
    import vsmartmom_tpu.aerosols as J
    import vsmartmom_tpu_torch.aerosols as P
    assert P.DEFAULT_DB.endswith("refractive_indices.json")
    port, ref = P.load_refractive_index_database(), \
        J.load_refractive_index_database()
    assert port.species() == ref.species() == sorted(
        ["sulfate_suso", "organic_carbon", "black_carbon", "seasalt_sscm",
         "dust_opac", "water"])
    from_yaml = P.load_refractive_index_database(J.DEFAULT_DB)
    for db in (port, from_yaml):
        for sp in ref.species():
            a, b = db.data[sp], ref.data[sp]
            for f in ("wavelengths", "n_real", "n_imag"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert a.species == b.species and a.source == b.source
    for sp in ref.species():
        lut = ref.data[sp]
        for lam in np.linspace(lut.wavelengths[0], lut.wavelengths[-1], 7):
            assert P.get_refractive_index(port, sp, lam) == \
                J.get_refractive_index(ref, sp, lam)
    with pytest.raises(ValueError):
        P.get_refractive_index(port, "sulfate_suso", 50.0)
    with pytest.raises(KeyError):
        P.get_refractive_index(port, "unobtainium", 0.55)
    bad = tmp_path / "bad.json"
    bad.write_text('{"species": {"x": {"lam": [0.5, 0.6], "n": [1.4], '
                   '"k": [0.0, 0.0]}}}')
    with pytest.raises(ValueError, match="inconsistent"):
        P.load_refractive_index_database(str(bad))


def test_mie_efficiencies_match_jax():
    """(Q_ext, Q_sca, Q_abs, g) from x = 0 (all zero) through the Rayleigh
    limit to a large sphere, absorbing and not: 1e-12."""
    from vsmartmom_tpu.aerosols import compute_mie_efficiencies as jax_q
    from vsmartmom_tpu_torch.aerosols import compute_mie_efficiencies
    for x, m in [(0.0, complex(1.5, 0.0)), (0.01, complex(1.5, 0.0)),
                 (0.8, complex(1.43, -1e-8)), (3.7, complex(1.53, -0.008)),
                 (25.0, complex(1.75, -0.44)),
                 (200.0, complex(1.33, -1e-9))]:
        port, ref = compute_mie_efficiencies(x, m), jax_q(x, m)
        for a, b in zip(port, ref):
            assert abs(a - b) <= 1e-12 * max(abs(b), 1e-300), (x, port, ref)


@pytest.mark.parametrize("fmt", ["nc3", "nc4"])
def test_readers_match_jax(tmp_path, fmt):
    """TOMAS-15 (the JAX test's (nf, Xdim, Ydim, lev, time) fields, two
    species) and two-moment ((lev, time) fields, two species) through
    ``read_aerosol_data`` of both packages on the same file: every array
    of every species 1e-12, the coordinates equal."""
    from vsmartmom_tpu.aerosols import read_aerosol_data as jax_read
    from vsmartmom_tpu_torch.aerosols import read_aerosol_data
    write = _write_nc3 if fmt == "nc3" else _write_nc4
    rng = np.random.default_rng(7)
    for cfg, fields in ((TOMAS_CFG, _tomas_fields(rng)),
                        (TM_CFG, _two_moment_fields(rng))):
        path = write(tmp_path / f"{cfg['aerosol_scheme']['type']}.{fmt}",
                     fields)
        port, ref = read_aerosol_data(cfg, path), jax_read(cfg, path)
        assert type(port.scheme).__name__ == type(ref.scheme).__name__
        _assert_data_equal(port, ref)


def test_bulk_optics_and_rt_aerosols_match_jax(tmp_path):
    """``compute_optical_properties`` (TOMAS-15: exact Mie per bin; two
    moment: Angstrom-scaled AOD, Mie at the lognormal median) at 0.55 and
    1.1 um, and ``to_rt_aerosols`` with and without ``p_full``: 1e-12."""
    import vsmartmom_tpu.aerosols as J
    import vsmartmom_tpu_torch.aerosols as P
    rng = np.random.default_rng(11)
    db_p, db_j = P.load_refractive_index_database(), \
        J.load_refractive_index_database()
    lams = [0.55, 1.1]
    for cfg, fields in ((TOMAS_CFG, _tomas_fields(rng)),
                        (TM_CFG, _two_moment_fields(rng))):
        path = _write_nc3(tmp_path / f"{cfg['aerosol_scheme']['type']}.nc",
                          fields)
        port, ref = P.read_aerosol_data(cfg, path), \
            J.read_aerosol_data(cfg, path)
        a = P.compute_optical_properties(port, lams, db_p)
        b = J.compute_optical_properties(ref, lams, db_j)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == (N_LEV, 2) and _rel(a[k], b[k]) <= 1e-12, k
    for p_full in (None, np.array([150.0, 320.0, 560.0, 800.0, 950.0])):
        aers = P.to_rt_aerosols(port, db_p, p_full=p_full)
        refs = J.to_rt_aerosols(ref, db_j, p_full=p_full)
        assert len(aers) == len(refs) == 2
        for x, y in zip(aers, refs):
            for f, v in x.__dict__.items():
                w = getattr(y, f)
                if v is None:
                    assert w is None, f
                else:
                    assert abs(v - w) <= 1e-12 * max(abs(w), 1e-300), f
    with pytest.raises(TypeError):
        P.to_rt_aerosols(P.read_aerosol_data(TOMAS_CFG, _write_nc3(
            tmp_path / "t.nc", _tomas_fields(rng))), db_p)


@pytest.mark.parametrize("dims", [("lev", "time"),
                                  ("nf", "Xdim", "Ydim", "lev", "time")])
@pytest.mark.parametrize("n_time", [1, 3])
def test_horizontal_mean_profile_matches_jax_on_lev_time(dims, n_time):
    """On the (..., lev, time) layout the JAX function assumes, the port's
    result equals it bit for bit."""
    from vsmartmom_tpu.aerosols import horizontal_mean_profile as jax_hmp
    from vsmartmom_tpu_torch.aerosols import horizontal_mean_profile
    shape = {"nf": 6, "Xdim": 3, "Ydim": 4, "lev": 9, "time": n_time}
    arr = np.random.default_rng(3).random([shape[d] for d in dims])
    port = horizontal_mean_profile(arr, dims)
    assert port.shape == (9,)
    np.testing.assert_array_equal(port, jax_hmp(arr))
    vec = arr.reshape(-1)[:9]
    np.testing.assert_array_equal(horizontal_mean_profile(vec), jax_hmp(vec))


def test_horizontal_mean_profile_on_gchp_order_differs_from_jax():
    """The reference-side fault: on a GCHP field in C order, (time=1,
    lev=72, nf=6, Ydim=3, Xdim=4), whose values are the level index, the
    port returns the 72-level profile; the JAX function takes ``a[..., 0]``
    (Xdim 0, not time 0) and averages the leading axes, levels included:
    a Ydim-long vector of 35.5."""
    from vsmartmom_tpu.aerosols import horizontal_mean_profile as jax_hmp
    from vsmartmom_tpu_torch.aerosols import horizontal_mean_profile
    arr = np.broadcast_to(np.arange(72.0)[None, :, None, None, None],
                          (1, 72, 6, 3, 4)).copy()
    port = horizontal_mean_profile(arr, ("time", "lev", "nf", "Ydim",
                                         "Xdim"))
    np.testing.assert_array_equal(port, np.arange(72.0))
    ref = jax_hmp(arr)
    assert ref.shape == (3,)
    np.testing.assert_allclose(ref, 35.5, rtol=1e-15)


def test_horizontal_mean_profile_needs_a_lev_dimension():
    from vsmartmom_tpu_torch.aerosols import horizontal_mean_profile
    arr = np.ones((1, 4, 2))
    for dims in (None, ("time", "level", "x"), ("time", "lev")):
        with pytest.raises(ValueError, match="'lev'"):
            horizontal_mean_profile(arr, dims)
    np.testing.assert_array_equal(
        horizontal_mean_profile(arr, ("time", "lev", "x")), np.ones(4))


@pytest.mark.parametrize("fmt", ["nc3", "nc4"])
def test_ncfile_names_dimensions(tmp_path, fmt):
    """``NCFile.dimensions`` in storage order for NetCDF-3 (scipy) and
    NetCDF-4 (h5py dimension scales); None for an HDF5 axis without one."""
    from vsmartmom_tpu_torch.aerosols import NCFile
    fields = _two_moment_fields(np.random.default_rng(0))
    fields["Met_AD"] = np.ones((2, 2, 2, N_LEV, 1))
    write = _write_nc3 if fmt == "nc3" else _write_nc4
    path = write(tmp_path / f"x.{fmt}", fields)
    with NCFile(path) as nc:
        assert nc.dimensions("Met_AD") == DIMS[5]
        assert nc.dimensions("AODHyg550nm_SO4") == ("lev", "time")
        assert nc.dimensions("lev") == ("lev",)
        np.testing.assert_array_equal(nc.profile("Met_AD"), np.ones(N_LEV))
    if fmt == "nc4":
        import h5py
        with h5py.File(path, "a") as f:
            f["bare"] = np.ones((3, 2))
        with NCFile(path) as nc:
            assert nc.dimensions("bare") is None
            with pytest.raises(ValueError, match="'lev'"):
                nc.profile("bare")
