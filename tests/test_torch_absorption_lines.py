"""The port's HITRAN tables, line lists, cross sections, look-up tables and
continua (``absorption/{hitran,cross_section,continuum}.py``) against the
JAX package on the CPU, on the synthetic line lists of
``absorption_inputs`` and the synthetic .cia / MT_CKD files of the JAX
package's tests/test_continuum.py:

* ``read_hitran``: identical arrays; ``mol_weight``, ``mol_number``,
  ``qoft`` and their table gathers: equal; ``hitran_tables.npz`` equal to
  both .nc files read with h5py (skipped only where h5py is absent);
* cross sections (Voigt windowed, dense, on a non-uniform grid and on a
  narrow band, Lorentz, Doppler; the line sum in float64 on the CPU) and
  the look-up table: 1e-12 of max; CIA and MT_CKD: 1e-12.
"""

from pathlib import Path

import numpy as np
import pytest

from absorption_inputs import o2_par, par, rel as _rel  # noqa: F401
from port_threads import _one_thread  # noqa: F401  (autouse)

JAX_DATA = Path(__file__).resolve().parents[1] / "vsmartmom_tpu" / \
    "absorption" / "data"


def test_read_hitran_matches_jax(par, o2_par):
    """Identical arrays, with and without the molecule, isotopologue,
    wavenumber and strength filters; the A-band list has ~1,000 lines of
    three isotopologues."""
    from vsmartmom_tpu.absorption.hitran import read_hitran as jax_read
    from vsmartmom_tpu_torch.absorption.hitran import COLUMNS, read_hitran
    cases = [(par, {}), (par, dict(iso=2, nu_min=12980.0, nu_max=13180.0)),
             (par, dict(min_strength=1e-25)), (o2_par, dict(mol=7, iso=1))]
    for path, kw in cases:
        a, b = read_hitran(path, **kw), jax_read(path, **kw)
        for k in COLUMNS:
            assert getattr(a, k).dtype == getattr(b, k).dtype
            assert np.array_equal(getattr(a, k), getattr(b, k)), (kw, k)
    full = read_hitran(par)
    assert 950 <= len(full) <= 1050 and set(full.iso) == {1, 2, 3}


def test_line_table_carries_across(par):
    from vsmartmom_tpu.absorption.hitran import read_hitran as jax_read
    from vsmartmom_tpu_torch.absorption.hitran import (COLUMNS,
                                                       hitran_table_from_numpy)
    src = jax_read(par)
    a = hitran_table_from_numpy(src)
    b = hitran_table_from_numpy({k: getattr(src, k) for k in COLUMNS})
    for k in COLUMNS:
        assert np.array_equal(getattr(a, k), getattr(src, k))
        assert np.array_equal(getattr(b, k), getattr(src, k))


def test_mol_weight_and_qoft_match_jax():
    from vsmartmom_tpu.absorption import hitran as J
    from vsmartmom_tpu_torch.absorption import hitran as P
    for name in ("H2O", "CO2", "O3", "O2", "CH4"):
        assert P.mol_number(name) == J.mol_number(name)
    pairs = [(7, 1), (7, 2), (7, 3), (1, 1), (2, 3), (6, 2)]
    for mol, iso in pairs:
        assert P.mol_weight(mol, iso) == J.mol_weight(mol, iso)
        for T in (180.0, 230.5, 296.0, 311.7):
            assert P.qoft(mol, iso, T) == J.qoft(mol, iso, T)
    mol, iso = np.array(pairs).T
    assert np.array_equal(P.mol_weights(mol, iso),
                          [J.mol_weight(m, i) for m, i in pairs])
    T = np.array([200.0, 285.3])
    assert np.array_equal(P.qoft_ratios(mol, iso, T),
                          [[J.qoft(m, i, t) for m, i in pairs] for t in T])
    with pytest.raises(KeyError):
        P.mol_weight(7, 9)
    with pytest.raises(KeyError):
        P.mol_number("XX")


def test_hitran_tables_match_the_nc_files():
    """``hitran_tables.npz`` holds the two .nc tables' arrays unchanged."""
    h5py = pytest.importorskip("h5py")
    from vsmartmom_tpu_torch.absorption.hitran import tables
    t = tables()
    with h5py.File(JAX_DATA / "iso_info.nc", "r") as f:
        for k in ("molecule", "isotope", "mol_weight", "abundance"):
            assert t[k].dtype == f[k].dtype
            assert np.array_equal(t[k], f[k][()]), k
        names = np.vectorize(lambda n: n.decode() if isinstance(n, bytes)
                             else str(n))(f["mol_name"][()])
        assert t["mol_name"].dtype.kind == "U"
        assert np.array_equal(t["mol_name"], names)
    with h5py.File(JAX_DATA / "TIPS_2017.nc", "r") as f:
        for k in ("TIPS_2017_T", "TIPS_2017_Q"):
            assert t[k].shape == (451, 18, 53) and t[k].dtype == np.float32
            assert np.array_equal(t[k], f[k][()]), k


# -- cross sections --------------------------------------------------------

CROSS_CASES = {
    # (broadening, wing cutoff, grid, force_dense): the path the JAX
    # package picks for it, and the port must pick too
    "voigt-windowed": ("Voigt", 10.0, ("uniform", 13040.0, 13120.0, 0.02),
                       False),
    "voigt-dense": ("Voigt", 10.0, ("uniform", 13040.0, 13120.0, 0.02), True),
    "voigt-nonuniform": ("Voigt", 10.0, ("random", 13040.0, 13120.0, 900),
                         False),
    "voigt-narrow": ("Voigt", 40.0, ("uniform", 13040.0, 13060.0, 0.05),
                     False),
    "lorentz": ("Lorentz", 5.0, ("uniform", 13040.0, 13100.0, 0.02), False),
    "doppler": ("Doppler", 5.0, ("uniform", 13040.0, 13100.0, 0.02), False),
}


def _grid(kind, a, b, arg):
    if kind == "uniform":
        return np.arange(a, b, arg)
    return np.sort(a + (b - a) * np.random.default_rng(3).random(arg))


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_cross_section_matches_jax(o2_par, case):
    from vsmartmom_tpu.absorption import cross_section as J
    from vsmartmom_tpu.absorption.hitran import read_hitran as jax_read
    from vsmartmom_tpu_torch.absorption import cross_section as P
    from vsmartmom_tpu_torch.absorption.hitran import read_hitran
    broadening, cutoff, grid, dense = CROSS_CASES[case]
    grid = _grid(*grid)
    kw = dict(broadening=broadening, wing_cutoff=cutoff, vmr=0.01)
    ref = J.compute_absorption_cross_section(
        J.HitranModel(hitran=jax_read(o2_par), **kw), grid, 500.0, 250.0,
        force_dense=dense)
    out = P.compute_absorption_cross_section(
        P.HitranModel(hitran=read_hitran(o2_par), **kw), grid, 500.0, 250.0,
        force_dense=dense, device="cpu")
    assert ref.max() > 0 and _rel(out, ref) <= 1e-12


def test_preprocessing_matches_jax_per_layer(par):
    """The batched host preprocessing (every layer at once, table gathers
    for masses and TIPS ratios) equals the JAX package's per-layer one."""
    from vsmartmom_tpu.absorption import cross_section as J
    from vsmartmom_tpu.absorption.hitran import read_hitran as jax_read
    from vsmartmom_tpu_torch.absorption import cross_section as P
    from vsmartmom_tpu_torch.absorption.hitran import read_hitran
    grid = 12980.0 + 0.05 * np.arange(4096)
    p, T = np.array([0.5, 300.0, 946.0]), np.array([220.0, 251.3, 285.8])
    out = P.preprocess_layers(P.HitranModel(hitran=read_hitran(par)), grid,
                              p, T)
    for iz in range(3):
        ref = J._preprocess_lines(J.HitranModel(hitran=jax_read(par)), grid,
                                  p[iz], T[iz])
        for a, b in zip(out, ref):
            assert np.array_equal(a[iz], b)


def test_lut_and_its_save_load_match_jax(o2_par, tmp_path):
    from vsmartmom_tpu.absorption import cross_section as J
    from vsmartmom_tpu.absorption.hitran import read_hitran as jax_read
    from vsmartmom_tpu_torch.absorption import cross_section as P
    from vsmartmom_tpu_torch.absorption.hitran import read_hitran
    grid = np.arange(13040.0, 13050.0, 0.1)
    kw = dict(p_grid=np.linspace(50, 1050, 5), t_grid=np.linspace(180, 310, 4))
    ref = J.make_interpolation_model(J.HitranModel(hitran=jax_read(o2_par)),
                                     grid, **kw)
    lut = P.make_interpolation_model(P.HitranModel(hitran=read_hitran(o2_par)),
                                     grid, device="cpu", **kw)
    assert lut.sigma.shape == ref.sigma.shape
    assert _rel(lut.sigma, ref.sigma) <= 1e-12
    query = np.arange(13039.0, 13051.0, 0.07)
    for p_, t_ in ((500.0, 250.0), (20.0, 330.0)):
        assert _rel(lut.interpolate(query, p_, t_),
                    ref.interpolate(query, p_, t_)) <= 1e-12
    path = str(tmp_path / "lut.npz")
    lut.save(path)
    back = P.InterpolationModel.load(path)
    assert back.order == "cubic" and np.array_equal(back.sigma, lut.sigma)
    jax_back = J.InterpolationModel.load(path)       # the same format
    assert np.array_equal(jax_back.sigma, lut.sigma)
    carried = P.interpolation_model_from_numpy(ref)
    assert np.array_equal(carried.sigma, ref.sigma)
    assert np.array_equal(carried.interpolate(query, 500.0, 250.0),
                          ref.interpolate(query, 500.0, 250.0))


# -- continua --------------------------------------------------------------

def test_cia_matches_jax(tmp_path):
    from test_continuum import _write_cia
    from vsmartmom_tpu.absorption import continuum as J
    from vsmartmom_tpu.core.atmosphere import compute_atmos_profile_fields
    from vsmartmom_tpu_torch.absorption import continuum as P
    path = tmp_path / "o2o2.cia"
    _write_cia(path)
    nu = np.array([999.0, 1000.0, 1002.5, 1005.0, 1010.0, 1011.0])
    blocks = P.parse_cia_file(str(path))
    assert [b.formula for b in blocks] == ["O2-O2", "O2-O2"]
    table, ref = P.load_cia_table(str(path), nu), J.load_cia_table(str(path),
                                                                   nu)
    assert np.array_equal(table.sigma_nuT, ref.sigma_nuT)
    for T in (150.0, 250.0, 400.0):
        assert np.array_equal(P.cia_sigma_at_T(table, T),
                              J.cia_sigma_at_T(ref, T))
    prof = compute_atmos_profile_fields(T=[230.0, 270.0],
                                        p_half=[100.0, 500.0, 1000.0])
    for vmr in ({}, {"O2": 0.2095}):
        a = P.compute_tau_cia(table, prof, vmr)
        assert a.max() > 0 and _rel(a, J.compute_tau_cia(ref, prof, vmr)) \
            <= 1e-12


def test_mtckd_matches_jax(tmp_path):
    from test_continuum import _write_mtckd
    from vsmartmom_tpu.absorption import continuum as J
    from vsmartmom_tpu.core.atmosphere import compute_atmos_profile_fields
    from vsmartmom_tpu_torch.absorption import continuum as P
    path = tmp_path / "mtckd.nc"
    _write_mtckd(path)
    table, ref = P.load_mtckd(str(path)), J.load_mtckd(str(path))
    assert (table.p_ref, table.T_ref) == (ref.p_ref, ref.T_ref)
    nu = np.array([500.0, 1234.5, 3000.0])
    band = P.build_mtckd_band(table, nu)
    assert np.array_equal(band.C_self, J.build_mtckd_band(ref, nu).C_self)
    prof = compute_atmos_profile_fields(T=[280.0, 290.0],
                                        p_half=[700.0, 900.0, 1000.0],
                                        q=np.array([0.004, 0.008]))
    a = P.compute_tau_h2o_continuum(table, nu, prof, prof.vmr_h2o)
    b = J.compute_tau_h2o_continuum(ref, nu, prof, prof.vmr_h2o)
    assert a.max() > 0 and a[2].max() == 0.0 and _rel(a, b) <= 1e-12
