"""The Raman entry points over a canopy with scalar leaf optics against
the JAX package on the CPU in f64: ``rt_run_inelastic`` (RRS),
``rt_run_stellar`` (sol_RRS) and ``rt_run_ms_rrs`` (RRS) on the small
scenes of their stored references over the one-slab canopy of
``surface_inputs.entry_canopy``, 1e-9 of max|ref| per output (the scenes
and the refusal of a 4-D surface: ``tests/test_torch_canopy_entry.py``).
JAX outputs go to numpy at once.
"""

import pytest

from port_threads import _one_thread  # noqa: F401  (autouse)
from surface_inputs import entry_model, entry_run, jax_model, rel


@pytest.mark.parametrize("scene", ("rrs", "stellar", "ms_rrs"))
def test_scalar_leaf_canopy_runs_as_in_jax(scene):
    model = entry_model(scene)
    inputs, _ = model.build_band(0, device="cpu")
    assert inputs.surf_r.dim() == 3
    ref = entry_run("jax", scene, jax_model(model))
    out = entry_run("port", scene, model)
    assert len(out) == len(ref) == 4
    for a, b in zip(out, ref):
        assert a.shape == b.shape and rel(a, b) <= 1e-9
