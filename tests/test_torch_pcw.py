"""The port's Domke-PCW Greek decomposition (``scattering/pcw.py``) and its
Wigner 3j tables (``scattering/wigner.py``) against the JAX package's on
the CPU. Tolerances:

* Wigner tables at N_max 6 and 20, and the per-l tables: 1e-13 of max;
* PCW against the JAX package's PCW at r_max 2 um, 300 radii: rtol 1e-12
  (the Greek coefficients relative to each one's max, SSA and k);
* PCW against the port's NAI-2 (``scattering/mie.py``): the identity is
  exact, so 1e-10 absolute on the Greek coefficients and 1e-12 on SSA
  and k, as in the JAX package's tests/test_mie.py TestPCWInRepo.

The JAX m-recursion is a Python loop per l; at the truth file's size
(tests/data/pcw_aerosol_optics.npz, r_max 30) a run takes tens of
seconds, so these tests stay at r_max <= 2.
"""

import numpy as np
import pytest

from port_threads import _one_thread  # noqa: F401  (autouse)

GREEK = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta")


def _rel(a, b):
    return float(np.abs(np.asarray(a) - b).max()
                 / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("n_max", [6, 20])
def test_wigner_tables_match_jax(n_max):
    from vsmartmom_tpu.scattering.wigner import compute_wigner_values as jw
    from vsmartmom_tpu_torch.scattering.wigner import compute_wigner_values
    A, B = compute_wigner_values(n_max)
    jA, jB = jw(n_max)
    assert A.shape == jA.shape == (2 * n_max + 1, n_max + 1, 2 * n_max + 1)
    assert _rel(A, jA) <= 1e-13 and _rel(B, jB) <= 1e-13


def test_wigner_per_l_tables_and_roundtrip(tmp_path):
    """``wigner_AB_for_l`` at l = 0, 1, 2, 7, 30 (n_cap 25) against the JAX
    package's; an exact 3j value; save / load keeps every bit."""
    from vsmartmom_tpu.scattering.wigner import wigner_AB_for_l as jw_l
    from vsmartmom_tpu_torch.scattering.wigner import (compute_wigner_values,
                                                       load_wigner_values,
                                                       save_wigner_values,
                                                       wigner_AB_for_l)
    for ll in (0, 1, 2, 7, 30):
        A, B = wigner_AB_for_l(ll, 25)
        jA, jB = jw_l(ll, 25)
        assert A.shape == jA.shape == (25 + ll + 3, 26)
        assert _rel(A, jA) <= 1e-13
        if ll < 2:
            assert not B.any() and not jB.any()
        else:
            assert _rel(B, jB) <= 1e-13
    A, B = compute_wigner_values(6)
    # 3j(1 1 0; -1 1 0) = (-1)^(1 + 1) / sqrt(3): A[m-1, n-1, l] at
    # m = n = 1, l = 0
    assert A[0, 0, 0] == pytest.approx(1.0 / np.sqrt(3.0), abs=1e-15)
    path = tmp_path / "wigner.npz"
    save_wigner_values(path, A, B)
    A2, B2 = load_wigner_values(path)
    np.testing.assert_array_equal(A, A2)
    np.testing.assert_array_equal(B, B2)


@pytest.fixture(scope="module")
def pcw_pair():
    """PCW optics of one log-normal aerosol (r_mode 0.1 um, sigma_g 1.5,
    n = 1.4 - 0.003i) at 0.55 um, r_max 2 um, 300 radii, from both
    packages, and the port's NAI-2 optics of the same aerosol."""
    from vsmartmom_tpu.scattering import mie as jmie
    from vsmartmom_tpu.scattering import pcw as jpcw
    from vsmartmom_tpu_torch.scattering import mie, pcw
    dist = (np.log(0.1), np.log(1.5))
    port = pcw.compute_aerosol_optical_properties_pcw(
        mie.Aerosol(mie.SizeDistribution(*dist), 1.4, 0.003), 0.55, 2.0, 300)
    ref = jpcw.compute_aerosol_optical_properties_pcw(
        jmie.Aerosol(jmie.SizeDistribution(*dist), 1.4, 0.003), 0.55, 2.0,
        300)
    nai2 = mie.compute_aerosol_optical_properties(
        mie.Aerosol(mie.SizeDistribution(*dist), 1.4, 0.003), 0.55, 2.0, 300)
    return port, ref, nai2


def test_pcw_matches_jax_pcw(pcw_pair):
    port, ref, _ = pcw_pair
    assert port.ssa == pytest.approx(ref.ssa, rel=1e-12)
    assert port.k == pytest.approx(ref.k, rel=1e-12)
    assert port.f_trunc == ref.f_trunc == 1.0
    for name in GREEK:
        a, b = getattr(port.greek_coefs, name), getattr(ref.greek_coefs, name)
        assert a.shape == b.shape and len(a) > 40
        assert _rel(a, b) <= 1e-12, name


def test_pcw_equals_the_ports_nai2(pcw_pair):
    """The NAI-2 == PCW identity on the port's own two routes."""
    port, _, nai2 = pcw_pair
    assert port.ssa == pytest.approx(nai2.ssa, rel=1e-12)
    assert port.k == pytest.approx(nai2.k, rel=1e-12)
    for name in GREEK:
        a = getattr(nai2.greek_coefs, name)
        b = getattr(port.greek_coefs, name)
        L = min(len(a), len(b))
        assert np.abs(a[:L] - b[:L]).max() < 1e-10, name
        assert np.abs(a[L:]).max(initial=0.0) < 1e-10, name
        assert np.abs(b[L:]).max(initial=0.0) < 1e-10, name


def test_greek_coefs_pcw_match_jax_on_given_coefficients():
    """``compute_greek_coefs_pcw`` on seeded Mie coefficients and weights,
    with the default and a shorter l_max: 1e-12 of each coefficient's
    max."""
    from vsmartmom_tpu.scattering.pcw import compute_greek_coefs_pcw as jg
    from vsmartmom_tpu_torch.scattering.mie import compute_mie_ab, get_n_max
    from vsmartmom_tpu_torch.scattering.pcw import compute_greek_coefs_pcw
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(0.2, 6.0, 40))
    an, bn = compute_mie_ab(x, complex(1.5, -0.01), get_n_max(x.max()))
    wx = rng.random(40)
    wx /= wx.sum()
    for l_max in (None, 9):
        a = compute_greek_coefs_pcw(an, bn, wx, 2 * np.pi / 0.55, 0.37,
                                    l_max=l_max)
        b = jg(an, bn, wx, 2 * np.pi / 0.55, 0.37, l_max=l_max)
        assert a.l_max == b.l_max == (l_max or 2 * an.shape[1] - 1)
        for name in GREEK:
            assert _rel(getattr(a, name), getattr(b, name)) <= 1e-12, name


def test_decomp_type_is_parsed_but_no_build_reads_it():
    """``scattering.decomp_type`` reaches ``ScatteringParams`` through the
    front end of both packages; the port's model build gives the same
    band with "PCW" as with "NAI2" (neither package routes its build
    through PCW)."""
    from vsmartmom_tpu.io.yaml_input import parameters_from_dict as jax_pfd
    from vsmartmom_tpu_torch import model_from_parameters
    from vsmartmom_tpu_torch.io.yaml_input import parameters_from_dict
    scene = {
        "radiative_transfer": {
            "spec_bands": ["[18000.0 18001.0]"],
            "surface": ["LambertianSurfaceScalar(0.1)"],
            "polarization_type": "Stokes_IQU()", "nstreams": 3,
            "depol": 0.0, "float_type": "Float64",
            "architecture": "default_architecture"},
        "geometry": {"sza": 30.0, "vza": [0.0], "vaz": [0.0],
                     "obs_alt": 0.0},
        "atmospheric_profile": {"T": [250.0, 280.0],
                                "p": [100.0, 500.0, 1000.0],
                                "profile_reduction": -1},
        "scattering": {"aerosols": [{"τ_ref": 0.1, "p₀": 700.0, "σp": 50.0,
                                     "μ": 0.1, "σ": 1.5, "nᵣ": 1.4,
                                     "nᵢ": 0.003}],
                       "r_max": 2.0, "nquad_radius": 60}}
    bands = []
    for decomp in ("NAI2()", "PCW()"):
        scene["scattering"]["decomp_type"] = decomp
        params = parameters_from_dict(scene)
        assert params.scattering_params.decomp_type == \
            jax_pfd(scene).scattering_params.decomp_type == decomp[:-2]
        bands.append(model_from_parameters(params).bands[0])
    a, b = bands
    assert a.aerosols[0].ssa == b.aerosols[0].ssa
    np.testing.assert_array_equal(a.aerosols[0].tau_profile,
                                  b.aerosols[0].tau_profile)
    for name in GREEK:
        np.testing.assert_array_equal(getattr(a.aerosols[0].greek, name),
                                      getattr(b.aerosols[0].greek, name))
