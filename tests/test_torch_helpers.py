"""The port's last two public helpers against the JAX package's on the CPU:
``surfaces.coxmunk.coxmunk_mueller_grid`` (the m-independent Mueller grid
and azimuth quadrature of the Cox-Munk Fourier projection, which the
port's operator build takes as well) and ``core.types.mu0_value``: 1e-12
of max|ref|."""

import numpy as np
import pytest

from port_threads import _one_thread  # noqa: F401  (autouse)

TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("ns,wind,whitecaps", [(1, 5.0, True),
                                               (3, 2.0, False),
                                               (4, 9.0, True)])
def test_coxmunk_mueller_grid_matches_jax(ns, wind, whitecaps):
    import vsmartmom_tpu.surfaces.coxmunk as J
    import vsmartmom_tpu_torch.surfaces.coxmunk as P
    from vsmartmom_tpu_torch.utils.quadrature import gauleg
    mu, _ = gauleg(5, 0.0, 1.0)
    out = P.coxmunk_mueller_grid(P.CoxMunkSurface(
        wind, include_whitecaps=whitecaps), ns, mu)
    ref = J.coxmunk_mueller_grid(J.CoxMunkSurface(
        wind, include_whitecaps=whitecaps), ns, mu)
    assert len(out) == len(ref) == 3
    for a, b in zip(out, ref):
        assert a.shape == b.shape and _rel(a, b) <= TOL
    for m in (0, 3):
        assert _rel(P.coxmunk_reflectance_fourier(*out, ns, m),
                    J.coxmunk_reflectance_fourier(*ref, ns, m)) <= TOL
    # The wind tangent rides the same grid: its M is the plain grid's, its
    # dM the analytic tangent against a central difference in the wind.
    M, dM, phi, w = P.coxmunk_mueller_grid(P.CoxMunkSurface(
        wind, include_whitecaps=whitecaps), ns, mu, wind_tangent=True)
    assert _rel(M, out[0]) <= TOL and _rel(phi, out[1]) == 0
    h = 1e-5 * wind
    hi, lo = (P.coxmunk_mueller_grid(P.CoxMunkSurface(
        wind + s * h, include_whitecaps=whitecaps), ns, mu)[0]
        for s in (1, -1))
    assert _rel(dM, (hi - lo) / (2 * h)) <= 1e-6


def test_operator_build_takes_the_grid(monkeypatch):
    """``coxmunk_surface_operator_arrays`` builds its Mueller grid through
    ``coxmunk_mueller_grid`` (one call, with the wind tangent when asked)
    and matches the JAX package's operators."""
    import vsmartmom_tpu.surfaces.coxmunk as J
    import vsmartmom_tpu_torch.surfaces.coxmunk as P
    from vsmartmom_tpu.utils.quadrature import rt_set_streams as j_streams
    from vsmartmom_tpu_torch.utils.quadrature import rt_set_streams
    calls = []
    grid = P.coxmunk_mueller_grid

    def counted(*args):
        calls.append(args[-1])          # wind_tangent
        return grid(*args)
    monkeypatch.setattr(P, "coxmunk_mueller_grid", counted)
    args = (3, 30.0, [0.0, 45.0], 3)
    quad, jquad = rt_set_streams(*args), j_streams(*args)
    for tangent in (False, True):
        out = P.coxmunk_surface_operator_arrays(
            P.CoxMunkSurface(6.0), quad, 3, 4, wind_tangent=tangent)
        ref = J.coxmunk_surface_operator_arrays(
            J.CoxMunkSurface(6.0), jquad, 3, 4, wind_tangent=tangent)
        assert len(out) == len(ref) == (4 if tangent else 2)
        for a, b in zip(out, ref):
            assert _rel(a, b) <= TOL
    assert calls == [False, True]


def test_mu0_value_matches_jax():
    from vsmartmom_tpu.core.types import mu0_value as jax_mu0_value
    from vsmartmom_tpu_torch.core.types import mu0_value
    from vsmartmom_tpu_torch.flagship import flagship_model
    from surface_inputs import jax_model
    model = flagship_model(n_spec=2, dtype=np.float64, nstreams=3, nz=2)
    inputs, config = model.build_band(0, device="cpu")
    jm = jax_model(model)
    j_inputs, j_config = jm.build_band(0)
    out = float(mu0_value(inputs, config))
    ref = float(jax_mu0_value(j_inputs, j_config))
    assert abs(out - ref) <= TOL * ref
    assert abs(out - model.quad.mu0) <= TOL * out
