"""The port's other entry points over a canopy, against the JAX package on
the CPU in f64. A canopy with scalar leaf optics squeezes to (n_m, N, N)
surface operators, which ``rt_run_lin``, ``rt_run_ms``,
``rt_run_inelastic``, ``rt_run_stellar`` and ``rt_run_ms_rrs`` take as
they take any surface: each on a small scene over such a canopy, 1e-9 of
max|ref| per output (here ``rt_run_lin`` and ``rt_run_ms``; the Raman
three in ``tests/test_torch_canopy_raman.py``). A canopy with spectral leaf optics (a 4-D surface) is
refused by each of them with ``NotImplementedError`` naming ROADMAP.md (the
JAX package runs four of them with it, queued there, and fails in
``rt_run_lin``).

The scenes are the small ones of the earlier stored references
(``flagship.lin_ref_params`` with a Henyey-Greenstein aerosol,
``rrs_ref_params``, ``stellar_ref_params``, ``ms_rrs_ref_params``) at
nstreams 2 over a canopy of one elemental slab (LAI 1.5, ``dtau_max`` 1:
no doubling) on a Lambertian soil. The JAX package compiles its canopy's
doubling scan at every moment of every build, and its ``rt_run_lin``
builds the band 8 times. JAX outputs go to numpy at once.
"""

import pytest

from port_threads import _one_thread  # noqa: F401  (autouse)
from surface_inputs import entry_model, entry_run, jax_model, rel

TOL = 1e-9
SCENES = ("lin", "ms")


@pytest.mark.parametrize("scene", SCENES)
def test_scalar_leaf_canopy_runs_as_in_jax(scene):
    model = entry_model(scene)
    inputs, _ = model.build_band(0, device="cpu")
    assert inputs.surf_r.dim() == 3
    ref = entry_run("jax", scene, jax_model(model))
    out = entry_run("port", scene, model)
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert a.shape == b.shape and rel(a, b) <= TOL


@pytest.mark.parametrize("scene", ("lin", "ms", "rrs", "stellar", "ms_rrs"))
def test_spectral_canopy_is_refused(scene):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        entry_run("port", scene, entry_model(scene, spectral=True))
