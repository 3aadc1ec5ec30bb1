"""Boundaries of the port: it imports neither JAX nor the JAX package, its
entry points never fall back to the CPU quietly, and its CUDA wrapper
refuses what the kernel does not take before anything is built."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from port_threads import _one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "vsmartmom_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_imports():
    files = sorted((ROOT / "vsmartmom_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [(f.relative_to(ROOT).as_posix(), mod) for f in files
           for mod in _imported_roots(f) if mod in FORBIDDEN]
    assert not bad, bad


def test_entry_points_need_cuda_or_an_explicit_device(monkeypatch):
    from vsmartmom_tpu_torch import flagship_model, rt_run
    from vsmartmom_tpu_torch.core.types import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = flagship_model(n_spec=2, nstreams=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt_run(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.build_band(0)
    assert resolve_device("cpu") == torch.device("cpu")
    R, T = rt_run(model, device="cpu")
    assert R.shape == T.shape == (9, 4, 2) and np.isfinite(R).all()


@pytest.fixture(scope="module")
def cpu_operands():
    from vsmartmom_tpu_torch import flagship_model
    from vsmartmom_tpu_torch.core.solver import band_moment_args
    from vsmartmom_tpu_torch.ops.fused_band import band_operands
    inputs, config = flagship_model(n_spec=3, nstreams=2).build_band(
        0, device="cpu")
    args, kw = band_moment_args(inputs, config, 0, "cpu")
    kw = {k: v for k, v in kw.items() if k not in ("ns_sched", "ns_inter")}
    return band_operands(*args, **kw), config


def test_kernel_wrapper_refuses_wrong_dtype(cpu_operands):
    from vsmartmom_tpu_torch.ops.fused_band import _launch_kernel
    ops, config = cpu_operands
    ops64 = type(ops)(*(x.double() for x in ops))
    with pytest.raises(ValueError, match="float32"):
        _launch_kernel(ops64, (0,) * config.ndoubl, 3)


def test_kernel_wrapper_refuses_wrong_shape(cpu_operands):
    from vsmartmom_tpu_torch.ops.fused_band import _launch_kernel
    ops, config = cpu_operands
    bad = ops._replace(ek=ops.ek[:, :, :0].contiguous())
    with pytest.raises(ValueError, match="shape"):
        _launch_kernel(bad, (0,) * config.ndoubl, 3)


def test_kernel_wrapper_refuses_cpu_tensors(cpu_operands):
    from vsmartmom_tpu_torch.ops.fused_band import _launch_kernel
    ops, config = cpu_operands
    with pytest.raises(ValueError, match="CUDA"):
        _launch_kernel(ops, (0,) * config.ndoubl, 3)


@pytest.fixture(scope="module")
def rrs_cpu_operands():
    from vsmartmom_tpu_torch import rrs_sif_model
    from vsmartmom_tpu_torch.core.inelastic import (inelastic_setup,
                                                    rrs_moment_args)
    from vsmartmom_tpu_torch.ops.fused_rrs import rrs_operands
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_I
    inputs, config, *rrs = inelastic_setup(
        rrs_sif_model(64, nstreams=3, polarization=STOKES_I), device="cpu")
    args, kw = rrs_moment_args(inputs, config, *rrs, 0, "cpu")
    kw = {k: v for k, v in kw.items() if k not in ("ns_sched", "ns_inter")}
    return rrs_operands(*args, **kw), kw["ndoubl"]


@pytest.mark.parametrize("case,match", [
    ("wide", "N <= 64"), ("f64", "float32"), ("cpu", "CUDA")])
def test_rrs_kernel_wrapper_refuses(rrs_cpu_operands, case, match):
    """The RRS kernels take N <= 64 f32 tensors on one CUDA device; the
    wrapper refuses anything else before it builds or launches."""
    from vsmartmom_tpu_torch.ops.fused_rrs import _launch_kernel
    ops, ndoubl = rrs_cpu_operands
    if case == "wide":
        ops = ops._replace(Em1=torch.zeros(ops.Em1.shape[:2] + (130,)))
    elif case == "f64":
        ops = type(ops)(*(x.double() for x in ops))
    with pytest.raises(ValueError, match=match):
        _launch_kernel(ops, (), (0,) * ndoubl, 1)


def test_rt_run_lin_needs_cuda_or_an_explicit_device(monkeypatch):
    from vsmartmom_tpu_torch import flagship_model, rt_run_lin
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt_run_lin(flagship_model(n_spec=2, nstreams=2))


@pytest.fixture(scope="module")
def mt_cpu_operands():
    """K2's operands for a tiny band and two tangents (CPU, f32)."""
    from vsmartmom_tpu_torch import flagship_model
    from vsmartmom_tpu_torch.ops.fused_lin import multitangent_args
    inputs, config = flagship_model(n_spec=3, nstreams=2).build_band(
        0, device="cpu")
    tangents = [inputs._replace(tau=0.1 * inputs.tau),
                inputs._replace(scat_w=0.2 * inputs.scat_w)]
    return multitangent_args(inputs, tangents, config, 0, "cpu")


@pytest.mark.parametrize("case,match", [
    ("K3", "K <= 2"), ("wide", "N <= 52"), ("shape", "shape"),
    ("f64", "float32"), ("cpu", "CUDA")])
def test_mt_kernel_wrapper_refuses(mt_cpu_operands, case, match):
    """K2 takes K <= 2, N <= 52, f32 tensors of matching shapes on one CUDA
    device; its launcher refuses anything else before it builds."""
    from vsmartmom_tpu_torch.ops.fused_lin import _launch_kernel
    ops, dops, sched, ns_inter = mt_cpu_operands
    if case == "K3":
        ops = ops._replace(j0_p=torch.cat([ops.j0_p] * 3, dim=-1))
    elif case == "wide":
        ops = ops._replace(Em1=torch.zeros(ops.Em1.shape[:2] + (56,)))
    elif case == "shape":
        dops = dops._replace(ek=dops.ek[:1].contiguous())
    elif case == "f64":
        dops = type(dops)(*(x.double() for x in dops))
    with pytest.raises(ValueError, match=match):
        _launch_kernel(ops, dops, sched, ns_inter)


def test_mt_wrapper_runs_the_plain_version_on_the_cpu(mt_cpu_operands):
    from vsmartmom_tpu_torch.ops.fused_lin import (
        fused_moment_multitangent, moment_multitangent_reference)
    before = fused_moment_multitangent.launches
    out = fused_moment_multitangent(*mt_cpu_operands)
    ref = moment_multitangent_reference(*mt_cpu_operands)
    assert fused_moment_multitangent.launches == before
    for a, b in zip((*out[0], *out[1]), (*ref[0], *ref[1])):
        assert torch.equal(a, b)
    assert out[1][0].shape[0] == 2


@pytest.mark.parametrize("module", ["core/multisensor.py", "ops/fused_rt.py",
                                    "core/solver.py"])
def test_multisensor_slice_imports_no_jax(module):
    """The multisensor slice's modules (rt_run_ms, the per-layer kernels'
    wrappers, _make_added_layer) import neither JAX nor the JAX package."""
    path = ROOT / "vsmartmom_tpu_torch" / module
    bad = [mod for mod in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, bad


def test_rt_run_ms_needs_cuda_or_an_explicit_device(monkeypatch):
    from vsmartmom_tpu_torch import flagship_model, rt_run_ms
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = flagship_model(n_spec=2, nstreams=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt_run_ms(model, [0, 33])
    uwJ, dwJ = rt_run_ms(model, [0, 33], device="cpu")
    assert uwJ.shape == dwJ.shape == (2, 9, 4, 2)
    assert np.isfinite(uwJ).all() and np.isfinite(dwJ).all()


def _layer_operands(N=12, K=1, s=3, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    mats = [0.01 * torch.rand((s, N, N), generator=g, dtype=dtype)
            for _ in range(6)]
    vecs = [0.1 * torch.rand((s, N, K), generator=g, dtype=dtype)
            for _ in range(4)]
    ek = torch.rand((s, K), generator=g, dtype=dtype)
    d = torch.ones(N, dtype=dtype)
    return mats, vecs, ek, d


@pytest.mark.parametrize("kernel", ["K5", "K4"])
@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"), ("f64", "float32"), ("wide", "N <= 64"),
    ("K3", "K <= 2"), ("shape", "shape"), ("deep", "at most 32")])
def test_layer_kernel_wrappers_refuse(monkeypatch, kernel, case, match):
    """K5 and K4 take f32 tensors of matching shapes on one CUDA device,
    N <= 64, K <= 2 and at most 32 doubling steps; their launchers refuse
    anything else before any build."""
    from vsmartmom_tpu_torch.ops import cuda_build, fused_rt

    def no_build(name):
        raise AssertionError("the launcher tried to build a kernel")
    monkeypatch.setattr(cuda_build, "load", no_build)
    N, K = {"wide": (68, 1), "K3": (12, 3)}.get(case, (12, 1))
    dtype = torch.float64 if case == "f64" else torch.float32
    mats, vecs, ek, d = _layer_operands(N, K, dtype=dtype)
    if case == "shape":
        vecs[2] = vecs[2][:, :-1]
    sched = (1,) * (33 if case == "deep" else 2)
    with pytest.raises(ValueError, match=match):
        if kernel == "K5":
            fused_rt._launch_doubling(mats[4], mats[5], vecs[2], vecs[3], ek,
                                      sched)
        else:
            fused_rt._launch_layer_step((*mats[:4], *vecs[:2]), mats[4],
                                        mats[5], vecs[2], vecs[3], ek, d,
                                        sched, 2)
