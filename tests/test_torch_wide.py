"""Wide-stream scenes (65 <= N <= 128) on the port, against the JAX
package.

* K1's launch plan (``ops/fused_band.band_cluster_plan``) at every width
  and source count it takes: one block a point while its shared memory
  fits, else the smallest cluster of 2, 4 or 8 blocks whose row bands do;
  every row in exactly one band; the C side's constants (pure host
  arithmetic; the card's ``tests/test_torch_cuda.py`` holds the C plan to
  it).
* The automatic routes: K1 and K2 take N <= 128 without a word and warn
  above it.
* The plain routes at the wide scenes' widths, each package's own build of
  the same ``Parameters`` in f64: ``rt_run`` of the IQUV Radau flagship
  (N = 68) and of the flagship at nstreams 16 (N = 84), 3 layers, and
  ``rt_run_lin`` of the IQUV Radau flagship with a Henyey-Greenstein
  aerosol over the Cox-Munk ocean (aerosol and wind parameters), 2 layers,
  each at 4 points: 1e-9 of max|ref|. The JAX dR gets the TMS term's tau
  derivative that its tangents leave out (``jax_tms_tau_term``). The
  Jacobian test is the file's slow one (~30 s on one core: 16 moments of
  8 tangents in both packages, the JAX compiles included).
* K1's plain version against the JAX ``fused_moment`` in Pallas interpret
  mode at N = 68 (one moment, 2 layers, f32): 2e-5.
"""

import dataclasses
import re
import warnings
from pathlib import Path

import numpy as np
import pytest

from port_threads import _one_thread  # noqa: F401  (autouse)
from surface_inputs import jax_params, rel

CSRC = Path(__file__).resolve().parents[1] / "vsmartmom_tpu_torch" / "csrc"
SMEM_OPT_IN = 232448


def _define(source, name):
    return re.search(rf"^#define {name} (.+)$", (CSRC / source).read_text(),
                     re.M).group(1).strip()


def test_plan_constants_are_the_kernels():
    """The host's threads and shared-memory budget are the ones the
    kernels are built with."""
    from vsmartmom_tpu_torch.ops import fused_band
    assert fused_band.KERNEL_THREADS == int(_define("fused_band.cu",
                                                    "VSM_THREADS"))
    assert fused_band.CLUSTER_THREADS == int(_define("cluster_band.cuh",
                                                     "VSM_CB_THREADS"))
    assert fused_band.KERNEL_MAX_N == int(_define("cluster_band.cuh",
                                                  "VSM_CB_MAX_N")) == 128
    assert _define("cluster_band.cuh", "VSM_CB_SMEM_BUDGET") == \
        f"({fused_band.SMEM_OPT_IN} - {SMEM_OPT_IN - fused_band.SMEM_BUDGET})"


@pytest.mark.parametrize("K", [1, 2])
def test_band_plan_at_every_width(K):
    """For every N in 1..128: a cluster of 1, 2, 4 or 8 blocks, the
    smallest that fits (a single block while its ten operators do), every
    row in exactly one band of a multiple of 4 rows, and at most the
    232,448 B a block may opt in to. N <= 64 keeps the single block of
    earlier builds (its shared memory unchanged); N = 129 is refused."""
    from vsmartmom_tpu_torch.ops.fused_band import (SMEM_BUDGET,
                                                    band_cluster_plan,
                                                    cluster_smem_bytes,
                                                    single_smem_bytes)
    for N in range(1, 129):
        plan = band_cluster_plan(N, K)
        c, band, rows = plan["cluster"], plan["band"], plan["row_slab"]
        assert c in (1, 2, 4, 8), N
        assert plan["smem"] <= SMEM_BUDGET < SMEM_OPT_IN, N
        owners = [r for r in range(c) for _ in range(rows[r], rows[r + 1])]
        assert rows[0] == 0 and rows[-1] == N and len(rows) == c + 1, N
        assert owners == sorted(owners) and len(owners) == N, N
        if c == 1:
            assert plan["threads"] == 192 and band == N
            assert plan["smem"] == single_smem_bytes(N, K)
            continue
        assert single_smem_bytes(N, K) > SMEM_BUDGET, N
        assert band % 4 == 0 and band * (c - 1) < N <= band * c, N
        assert plan["threads"] == 256, N
        assert plan["smem"] == cluster_smem_bytes(N, K, c), N
        if c > 2:
            assert cluster_smem_bytes(N, K, c // 2) > SMEM_BUDGET, N
        if N <= 64:
            pytest.fail(f"N = {N} left the single block")
    assert band_cluster_plan(84, K)["cluster"] == 2
    assert band_cluster_plan(128, K)["cluster"] == 4
    with pytest.raises(ValueError, match="N <= 128"):
        band_cluster_plan(129, K)


@pytest.mark.parametrize("kernel,module", [
    ("K1 (csrc/fused_band.cu)", "fused_band"),
    ("K2 (csrc/fused_lin.cu)", "fused_lin")])
def test_routes_take_up_to_128(kernel, module):
    """``kernel_takes_width`` at K1's and K2's limits: silent at N = 84,
    one warning naming the kernel, 128 and N at N = 129."""
    import importlib
    from vsmartmom_tpu_torch.core.types import kernel_takes_width
    limit = importlib.import_module(
        f"vsmartmom_tpu_torch.ops.{module}").KERNEL_MAX_N
    assert limit == 128
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert kernel_takes_width(kernel, limit, 84)
        assert kernel_takes_width(kernel, limit, 128)
    with pytest.warns(UserWarning, match=re.escape(kernel.split()[0])
                      + r".* N <= 128; this scene has N = 129"):
        assert not kernel_takes_width(kernel, limit, 129)


def _jax_model(params):
    from vsmartmom_tpu.core.model import model_from_parameters
    return model_from_parameters(jax_params(params))


def _wide_params(scene):
    """f64 ``Parameters`` of a wide scene at 4 points: the IQUV Radau
    flagship (3 layers; with the Henyey-Greenstein aerosol 2) or the
    flagship at nstreams 16 (3 layers)."""
    from vsmartmom_tpu_torch.core.model import (Parameters, RTAerosol,
                                                ScatteringParams,
                                                SurfaceDescriptor)
    from vsmartmom_tpu_torch.flagship import flagship_params, radau_params
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_IQUV
    if scene == "radau_iquv":
        return radau_params(4, np.float64, nz=3, polarization=STOKES_IQUV)
    if scene == "hg_lin":
        return dataclasses.replace(
            radau_params(4, np.float64, nz=2, polarization=STOKES_IQUV),
            scattering_params=ScatteringParams(rt_aerosols=[RTAerosol(
                tau_ref=0.15, p0=700.0, sigma_p=60.0, phase_function_g=0.7,
                ssa=0.9)]))
    return Parameters(
        surfaces=[SurfaceDescriptor("CoxMunkSurface", [],
                                    {"wind_speed": 5.0})],
        polarization=STOKES_IQUV, **flagship_params(4, np.float64, 16, 3))


@pytest.mark.parametrize("scene,N", [("radau_iquv", 68),
                                     ("flagship_16", 84)])
def test_rt_run_matches_jax_at_wide_widths(scene, N):
    """The plain ``rt_run`` of each package on its own build: R and T
    within 1e-9 of max|ref| in f64."""
    from vsmartmom_tpu import rt_run as jax_rt_run
    from vsmartmom_tpu_torch import rt_run
    from vsmartmom_tpu_torch.core.model import model_from_parameters
    params = _wide_params(scene)
    model = model_from_parameters(params)
    _, config = model.build_band(0, device="cpu")
    assert config.N == N and config.nz == 3 and not config.fused
    ref = [np.asarray(x) for x in jax_rt_run(_jax_model(params))]
    out = rt_run(model, device="cpu")
    for k, a, b in zip("RT", out, ref):
        assert a.shape == b.shape, k
        assert rel(a, b) <= 1e-9, (k, rel(a, b))


def test_rt_run_lin_matches_jax_at_n68():
    """``rt_run_lin`` on the plain jvp route of each package, f64, the IQUV
    Radau flagship (N = 68) with the Henyey-Greenstein aerosol and the
    wind: R, T and every
    parameter's dR, dT within 1e-9, the JAX dR with the TMS term's tau
    derivative added."""
    from test_torch_lin import jax_tms_tau_term
    from vsmartmom_tpu.core.linearization import \
        build_tangent_inputs as jax_build_tangents
    from vsmartmom_tpu.core.linearization import \
        default_layout as jax_default_layout
    from vsmartmom_tpu.core.linearization import rt_run_lin as jax_rt_run_lin
    from vsmartmom_tpu_torch import default_layout, rt_run_lin
    from vsmartmom_tpu_torch.core.model import model_from_parameters
    params = _wide_params("hg_lin")
    model = model_from_parameters(params)
    layout = default_layout(model)
    assert "wind_speed" in layout.names() and layout.n_total >= 2
    jm = _jax_model(params)
    j_layout = jax_default_layout(jm)
    inputs, config, tangents = jax_build_tangents(jm, 0, j_layout)
    assert config.N == 68 and not config.fused
    ref = dict(zip(("R", "T", "dR", "dT"), (np.asarray(x) for x in
                                             jax_rt_run_lin(jm, layout=j_layout))))
    ref["dR"] = ref["dR"] + jax_tms_tau_term(jm, inputs, config, tangents)
    out = dict(zip(("R", "T", "dR", "dT"),
                   rt_run_lin(model, layout=layout, device="cpu")))
    assert out["dR"].shape == ref["dR"].shape
    assert out["dR"].shape[-1] == layout.n_total
    for k in ("R", "T"):
        assert rel(out[k], ref[k]) <= 1e-9, k
    for k in ("dR", "dT"):
        for q in range(layout.n_total):
            assert rel(out[k][..., q], ref[k][..., q]) <= 1e-9, (k, q)


def test_moment_reference_matches_jax_kernel_at_n68():
    """K1's plain version (``moment_body_reference``, what the card's wide
    K1 is held to) against the JAX ``fused_moment`` in interpret mode on
    the same f32 operands of the IQUV Radau flagship at N = 68: moment 0,
    2 layers, a seed-only and a one-iteration step on the schedule: 2e-5
    of max|ref| per output."""
    import jax.numpy as jnp
    from vsmartmom_tpu.ops.fused_band import fused_moment as jax_fused_moment
    from vsmartmom_tpu_torch.core.model import model_from_parameters
    from vsmartmom_tpu_torch.core.solver import band_moment_args
    from vsmartmom_tpu_torch.flagship import radau_params
    from vsmartmom_tpu_torch.ops.fused_band import moment_reference
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_IQUV
    model = model_from_parameters(radau_params(
        2, np.float32, nz=2, polarization=STOKES_IQUV))
    inputs, config = model.build_band(0, device="cpu")
    assert config.N == 68
    sched = tuple(min(k, 2) for k in range(config.ndoubl))
    config = dataclasses.replace(config, ns_sched=sched, ns_inter=3)
    args, kw = band_moment_args(inputs, config, 0, "cpu")
    out = moment_reference(*args, **kw)
    ref = jax_fused_moment(*(jnp.asarray(a.numpy()) for a in args), **kw,
                           pack=1, dot_mode="highest")
    for a, b in zip(out, ref):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert rel(a.numpy(), b) <= 2e-5, rel(a.numpy(), b)


def test_wide_multisensor_scene_takes_the_lu_route(monkeypatch):
    """A scene K1 takes but K5 does not (64 < N = 68) with the strategy
    left automatic: build_band picks the band path, and rt_run_ms warns,
    naming K5, its limit and N, and runs the LU ladder, equal to an
    explicit fused=False run. The automatic choice is made as on the card
    (``types.auto_kernel``)."""
    from vsmartmom_tpu_torch import (Parameters, SurfaceDescriptor,
                                     model_from_parameters, rt_run_ms)
    from vsmartmom_tpu_torch.core import model as model_mod
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_IQUV

    def scene(fused=None):
        return model_from_parameters(Parameters(
            spec_bands=[np.array([13000.0, 13000.5])],
            surfaces=[SurfaceDescriptor("LambertianSurfaceScalar", [0.1])],
            nstreams=14, polarization=STOKES_IQUV, sza=40.0,
            vza=[10.0, 45.0], vaz=[30.0, 150.0], obs_alt=0.0,
            T=np.array([250.0, 280.0]), p=np.array([300.0, 700.0, 1013.0]),
            depol=0.0, float_type=np.float32, fused=fused))
    monkeypatch.setattr(model_mod, "auto_kernel", lambda dev, ft: True)
    model = scene()
    _, config = model.build_band(0, device="cpu")
    assert config.fused and config.N == 68
    with pytest.warns(UserWarning, match=r"K5 .* N <= 64; this scene has "
                                         r"N = 68"):
        out = rt_run_ms(model, [0, 1, 2], device="cpu")
    for a, b in zip(out, rt_run_ms(scene(fused=False), [0, 1, 2],
                                   device="cpu")):
        assert np.array_equal(a, b)
