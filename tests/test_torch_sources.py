"""The port's source spectra and timing table against the JAX package:
``sif.py`` (``default_sif_spectrum``, ``load_sif_spectrum``,
``load_ficus_reflectance``, ``build_sif_source``), the ``solar.py``
additions (``load_solar_spectrum`` from .npy, .npz and text,
``default_solar_spectrum``, ``set_surface_sif``) and ``utils/timing.py``.
Files are written under ``tmp_path`` from seeded numbers; every array
1e-13 of max|ref| (the same NumPy arithmetic).
"""

import numpy as np
import pytest

from port_threads import _one_thread  # noqa: F401  (autouse)
from surface_inputs import jax_model, rel

NU = np.linspace(13245.0, 14883.0, 97)


def test_default_spectra_match_jax():
    import vsmartmom_tpu.sif as JS
    import vsmartmom_tpu.solar as JO
    import vsmartmom_tpu_torch.sif as PS
    import vsmartmom_tpu_torch.solar as PO
    wide = np.linspace(11000.0, 26000.0, 4001)      # Ca II to H-alpha
    for kw in ({}, {"peak_ratio": 2.0, "rescale_to_peak": False}):
        assert rel(PS.default_sif_spectrum(NU, **kw),
                   JS.default_sif_spectrum(NU, **kw)) <= 1e-13
    for kw in ({}, {"T_eff": 5000.0, "normalize": False}):
        out = PO.default_solar_spectrum(wide, **kw)
        assert rel(out, JO.default_solar_spectrum(wide, **kw)) <= 1e-13
    f = PO.default_solar_spectrum(wide)
    h_alpha = np.argmin(np.abs(1e7 / wide - 656.281))
    assert f.max() <= 1.0 and f[h_alpha] < 0.5 * f[h_alpha - 40]


@pytest.mark.parametrize("fmt", ["npy", "npz", "txt"])
def test_load_solar_spectrum_matches_jax(tmp_path, fmt):
    import vsmartmom_tpu.solar as J
    import vsmartmom_tpu_torch.solar as P
    rng = np.random.default_rng(15)
    data = np.stack([np.linspace(13000.0, 15000.0, 301),
                     rng.uniform(0.5, 1.5, 301)], axis=1)
    path = tmp_path / f"solar.{fmt}"
    if fmt == "npy":
        np.save(path, data)
    elif fmt == "npz":
        np.savez(path, spectrum=data)
    else:
        np.savetxt(path, data)
    assert rel(P.load_solar_spectrum(str(path), NU),
               J.load_solar_spectrum(str(path), NU)) <= 1e-13
    with pytest.raises(ValueError, match="exceeds"):
        P.load_solar_spectrum(str(path), NU + 1000.0)


def test_sif_files_match_jax(tmp_path):
    import vsmartmom_tpu.sif as J
    import vsmartmom_tpu_torch.sif as P
    rng = np.random.default_rng(16)
    wl = np.linspace(640.0, 850.0, 106)
    csv = tmp_path / "sif.csv"
    rows = np.stack([wl, rng.uniform(0, 2, 106), rng.uniform(0, 3, 106)], 1)
    csv.write_text("wavelength, SIF_OLD, SIF_NEW\n" + "\n".join(
        ",".join(f"{v:.9g}" for v in r) for r in rows) + "\n")
    for kw in ({}, {"column": "SIF_NEW", "rescale_to_peak": False}):
        for a, b in zip(P.load_sif_spectrum(str(csv), **kw),
                        J.load_sif_spectrum(str(csv), **kw)):
            assert rel(a, b) <= 1e-13
    with pytest.raises(ValueError, match="column"):
        P.load_sif_spectrum(str(csv), column="SIF_X")
    leaf = tmp_path / "ficus.txt"
    leaf.write_text("# ficus sample\nunits: um, %\n\n" + "\n".join(
        f"{w / 1000:.6f} {v:.6f}" for w, v in zip(wl, 50 * rows[:, 1])))
    for a, b in zip(P.load_ficus_reflectance(str(leaf)),
                    J.load_ficus_reflectance(str(leaf))):
        assert rel(a, b) <= 1e-13


def test_model_sources_match_jax(tmp_path):
    """``build_sif_source`` (default shape, arrays, a file) and
    ``set_surface_sif`` on a model's bands, as in the JAX package."""
    import vsmartmom_tpu.sif as JS
    import vsmartmom_tpu.solar as JO
    import vsmartmom_tpu_torch.sif as PS
    import vsmartmom_tpu_torch.solar as PO
    from vsmartmom_tpu_torch.flagship import flagship_model
    model = flagship_model(n_spec=8, dtype=np.float64, nstreams=2, nz=3)
    jm = jax_model(model)
    nu_sif = np.linspace(13000.0, 16000.0, 50)
    j_sif = np.random.default_rng(17).uniform(0.0, 1.0, 50)
    for kw in ({}, {"nu_sif": nu_sif, "jsif": j_sif}):
        PS.build_sif_source(model, **kw)
        JS.build_sif_source(jm, **kw)
        assert rel(model.bands[0].sif_spec, jm.bands[0].sif_spec) <= 1e-13
    PO.set_surface_sif(model, 0.25)
    JO.set_surface_sif(jm, 0.25)
    np.testing.assert_array_equal(model.bands[0].sif_spec,
                                  jm.bands[0].sif_spec)


def test_timing_table(monkeypatch, capsys):
    """Stages nest, ``sync`` runs only while timing is on, ``report`` has
    the JAX package's layout, ``VSM_TIMING`` switches it on, and
    ``Parameters.verbose`` prints the table after ``rt_run``."""
    from vsmartmom_tpu.utils import timing as J
    from vsmartmom_tpu_torch import rt_run
    from vsmartmom_tpu_torch.flagship import flagship_model
    from vsmartmom_tpu_torch.utils import timing as P
    monkeypatch.delenv("VSM_TIMING", raising=False)
    assert not P.enabled() and not J.enabled()
    P.reset()
    synced = []
    with P.stage("outer"):
        with P.stage("inner", sync=lambda: synced.append(1)):
            pass
    with P.stage("on", sync=lambda: synced.append(2), on=True):
        pass
    assert synced == [2]
    assert list(P._REGISTRY) == ["outer/inner", "outer", "on"]
    P.reset()
    J.reset()
    assert P.report() == J.report() == "(no stages recorded)"
    for m in (P, J):
        m.record("build", 0.25)
        m.record("build/surface", 0.125)
        m.record("solve", 0.5)
    assert P.report() == J.report() and "  surface" in P.report()
    P.reset()
    J.reset()
    monkeypatch.setenv("VSM_TIMING", "1")
    assert P.enabled() and J.enabled()
    monkeypatch.delenv("VSM_TIMING")
    model = flagship_model(n_spec=2, dtype=np.float64, nstreams=2, nz=3)
    model.params.verbose = True
    rt_run(model, device="cpu")
    out = capsys.readouterr().out
    for stage in ("build_band[0]", "surface[0]", "rt_solve[0]"):
        assert stage in out
    P.reset()
