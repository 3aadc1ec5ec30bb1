"""The stored Raman references' recipe, shared by the port's Raman test
files (``tests/test_torch_vs.py``, ``_stellar``, ``_ms_rrs``): either
package's model of an f32 scene, solved in float64."""

import dataclasses

import numpy as np


def solved_in_f64(model):
    """``model`` with its ``build_band`` returning the f32 model's
    configuration in float64 (either package's model): its host build and
    doubling counts stay the f32 scene's, its solve runs in f64."""
    build = model.build_band

    def build_f64(*args, **kw):
        inputs, config = build(*args, **kw)
        return inputs, dataclasses.replace(config, dtype=np.float64)
    model.build_band = build_f64
    return model
