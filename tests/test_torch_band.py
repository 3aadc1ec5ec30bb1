"""The port's band path (ops/fused_band.py) against the JAX package.

``moment_reference`` — the plain torch version of the CUDA band kernel —
is held against the JAX ``fused_moment`` run the way the JAX package's own
CPU tests run it (Pallas interpret mode, tests/test_packed_solver.py), with
pack = 1, exact-f32 ("highest") products and the same Newton-Schulz
schedule, including seed-only (0) and one-iteration (1) steps. Tolerances,
relative to max|ref| per output: 1e-5 in f32, 1e-10 in f64. The whole
fused solve on the CPU is held against the JAX plain path at 5e-5, the
tolerance of tests/test_packed_solver.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

SCHED = (0, 0, 1, 1, 2, 2, 3, 3)        # ndoubl = 8 at the small flagship
NS_INTER = 3
NAMES = ("R_mp", "R_pm", "T_pp", "T_mm", "J0_p", "J0_m")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread is faster and does not fight the
    other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _model(n_spec=8, thermal=False):
    from vsmartmom_tpu_torch import flagship_model
    model = flagship_model(n_spec=n_spec, nstreams=4)
    if thermal:
        model.bands[0].thermal_b = np.random.default_rng(7).uniform(
            0.05, 0.5, (model.profile.nz, n_spec))
    return model


def _compare(model, m, dtype, tol):
    """moment_reference vs the JAX fused_moment (interpret mode) on the
    same operands: the port's band_moment_args, handed across as numpy."""
    import jax.numpy as jnp
    from vsmartmom_tpu.ops.fused_band import fused_moment as jax_fused_moment
    from vsmartmom_tpu_torch.core.solver import band_moment_args
    from vsmartmom_tpu_torch.ops.fused_band import moment_reference
    inputs, config = model.build_band(0, device="cpu")
    assert config.ndoubl == len(SCHED)
    config = dataclasses.replace(config, dtype=dtype, ns_sched=SCHED,
                                 ns_inter=NS_INTER)
    args, kw = band_moment_args(inputs, config, m, "cpu")
    out = moment_reference(*args, **kw)
    ref = jax_fused_moment(*(jnp.asarray(a.numpy()) for a in args), **kw,
                           pack=1, dot_mode="highest")
    for name, a, b in zip(NAMES, out, ref):
        assert a.shape == b.shape, name
        assert _rel(a.numpy(), b) <= tol, (name, _rel(a.numpy(), b))


@pytest.mark.parametrize("m", [0, 1])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-10)],
                         ids=["f32", "f64"])
def test_moment_reference_matches_jax_kernel(m, dtype, tol):
    _compare(_model(), m, dtype, tol)


def test_thermal_source_k2():
    """Two source slots (solar + per-layer Planck thermal, m = 0)."""
    model = _model(thermal=True)
    assert model.build_band(0, device="cpu")[1].n_sources == 2
    _compare(model, 0, np.float32, 1e-5)


def test_awkward_width():
    """nSpec = 36: the JAX kernel pads to its spectral block with vacuum
    points; the port has no padding and must agree on every real point."""
    _compare(_model(n_spec=36), 0, np.float32, 1e-5)


def test_fused_solve_matches_jax_plain():
    """rt_solve with fused=True on the CPU (the wrapper takes
    moment_reference there) against the JAX plain rt_solve, f32."""
    from __graft_entry__ import _flagship_model
    from vsmartmom_tpu.core.solver import rt_solve as jax_rt_solve
    from vsmartmom_tpu_torch import flagship_model
    from vsmartmom_tpu_torch.core.solver import rt_solve
    j_inputs, j_config = _flagship_model(n_spec=8, nstreams=4).build_band(0)
    ref = {k: np.asarray(v) for k, v in jax_rt_solve(j_inputs,
                                                     j_config).items()}
    inputs, config = flagship_model(n_spec=8, nstreams=4,
                                    fused=True).build_band(0, device="cpu")
    assert config.fused and config.ns_sched
    out = rt_solve(inputs, config, "cpu")
    for k in ("R", "T", "hdr", "bhr_uw", "bhr_dw"):
        assert _rel(out[k].numpy(), ref[k]) <= 5e-5, k


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs moment_reference and launches
    nothing."""
    from vsmartmom_tpu_torch.core.solver import band_moment_args
    from vsmartmom_tpu_torch.ops import fused_band
    inputs, config = _model().build_band(0, device="cpu")
    args, kw = band_moment_args(inputs, config, 0, "cpu")
    before = fused_band.fused_moment.launches
    out = fused_band.fused_moment(*args, **kw)
    ref = fused_band.moment_reference(*args, **kw)
    assert fused_band.fused_moment.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
