"""The port's other entry points over a canopy, against the JAX package on
the CPU in f64: ``rt_run_lin``, ``rt_run_ms``, ``rt_run_inelastic`` (RRS),
``rt_run_stellar`` (sol_RRS) and ``rt_run_ms_rrs``, each on a small scene,
1e-9 of max|ref| per output.

* A canopy with scalar leaf optics squeezes to (n_m, N, N) surface
  operators, which every entry point takes as it takes any surface; here
  ``rt_run_lin`` and ``rt_run_ms`` against a live JAX run (the Raman three
  in ``tests/test_torch_canopy_raman.py``).
* A canopy with spectral leaf optics gives a spectrally resolved (4-D)
  surface, (n_m, nSpec, N, N), which all five take, as the JAX package's
  do (its ``rt_run_lin`` too: its dR over this canopy matches a central
  difference of its ``rt_run_full``). Their outputs are held against the
  JAX package's runs stored in ``vsmartmom_tpu_torch/data/
  entries_4d_ref_f64.npz`` (its canopy build and ``rt_run_lin``'s eight
  builds take most of a minute together); the RRS scene also runs live, and
  the stored file must equal that run to 1e-12, so it cannot go stale.
  ``python tests/test_torch_canopy_entry.py`` (PYTHONPATH=.) rewrites it.

The scenes are the small ones of the earlier stored references
(``flagship.lin_ref_params`` with a Henyey-Greenstein aerosol,
``rrs_ref_params``, ``stellar_ref_params``, ``ms_rrs_ref_params``) at
nstreams 2 over a canopy of one elemental slab (LAI 1.5, ``dtau_max`` 1:
no doubling) on a Lambertian soil. The JAX package compiles its canopy's
doubling scan at every moment of every build, and its ``rt_run_lin``
builds the band 8 times. JAX outputs go to numpy at once.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from port_threads import _one_thread  # noqa: F401  (autouse)

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
from surface_inputs import (DATA, entry_model, entry_run,  # noqa: E402
                            jax_model, rel)

TOL = 1e-9
SCENES = ("lin", "ms")
SPECTRAL_SCENES = ("lin", "ms", "rrs", "stellar", "ms_rrs")
#: The spectral scene that also runs live against the JAX package.
LIVE = "rrs"
REF_4D_PATH = DATA / "entries_4d_ref_f64.npz"


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


def stored_4d(scene):
    """The stored JAX outputs of one spectral scene, in entry-point order."""
    with np.load(REF_4D_PATH) as f:
        keys = sorted((k for k in f.files if k.startswith(scene + "_")
                       and k[len(scene) + 1:].isdigit()),
                      key=lambda k: int(k[len(scene) + 1:]))
        return tuple(f[k] for k in keys)


@pytest.mark.parametrize("scene", SPECTRAL_SCENES)
def test_spectral_canopy_runs_as_in_jax(scene):
    model = entry_model(scene, spectral=True)
    inputs, _ = model.build_band(0, device="cpu")
    assert inputs.surf_r.dim() == 4
    ref = stored_4d(scene)
    out = entry_run("port", scene, model)
    assert len(out) == len(ref) > 0
    for a, b in zip(out, ref):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert rel(a, b) <= TOL
    if scene == LIVE:
        live = entry_run("jax", scene, jax_model(model))
        for a, b, c in zip(out, ref, live):
            assert rel(b, c) <= 1e-12 and rel(a, c) <= TOL


def make_4d_ref():
    """The JAX package's run of every spectral scene on the CPU in f64:
    {f"{scene}_{i}": i-th output}."""
    out = {}
    for scene in SPECTRAL_SCENES:
        res = entry_run("jax", scene,
                        jax_model(entry_model(scene, spectral=True)))
        out.update({f"{scene}_{i}": x for i, x in enumerate(res)})
    return out


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    np.savez(REF_4D_PATH, **make_4d_ref())
    print(f"wrote {REF_4D_PATH}")
