"""The port's complex error functions (``absorption/voigt.py``) against the
JAX package's on the CPU: each of the seven CEFs on a seeded grid of
complex points spanning every region, 1e-13 of |ref| per point;
``weideman_coeffs`` equal."""

import numpy as np
import pytest
import torch

from port_threads import _one_thread  # noqa: F401  (autouse)

CEF_NAMES = ("HumlicekWeidemann32SDErrorFunction",
             "HumlicekWeidemann32VoigtErrorFunction", "HumlicekErrorFunction",
             "CPF12ErrorFunction", "ErfcErrorFunction",
             "ErfcHumliErrorFunctionVoigt", "ErfcHumliErrorFunctionSD")


def _cef_points():
    """Complex points spanning every CEF region: |x| + y from 0 to 130,
    y from 1e-6 to 100, the CPF12 and Humlicek w4 boundaries included."""
    rng = np.random.default_rng(3)
    x = np.concatenate([np.linspace(-30, 30, 61), rng.uniform(-30, 30, 40)])
    y = np.concatenate([np.logspace(-6, 2, 17), rng.uniform(0, 2, 8)])
    X, Y = np.meshgrid(x, y)
    return (X + 1j * Y).ravel()


@pytest.fixture(scope="module")
def jax_cefs():
    import jax.numpy as jnp
    from vsmartmom_tpu.absorption.voigt import CEFS
    z = _cef_points()
    return z, {n: np.asarray(CEFS[n](jnp.asarray(z))) for n in CEF_NAMES}


@pytest.mark.parametrize("name", CEF_NAMES)
def test_cef_matches_jax(jax_cefs, name):
    from vsmartmom_tpu_torch.absorption.voigt import CEFS
    z, ref = jax_cefs
    out = CEFS[name](torch.as_tensor(z)).numpy()
    assert out.dtype == np.complex128
    assert np.max(np.abs(out - ref[name]) / np.abs(ref[name])) <= 1e-13


def test_weideman_coeffs_match_jax():
    from vsmartmom_tpu.absorption.voigt import weideman_coeffs as jax_wc
    from vsmartmom_tpu_torch.absorption.voigt import (_WEIDEMAN32_A,
                                                      weideman_coeffs)
    for n in (32, 64):
        assert np.array_equal(weideman_coeffs(n), jax_wc(n))
    np.testing.assert_allclose(weideman_coeffs(32), _WEIDEMAN32_A,
                               atol=1e-14)
