"""Boundaries of the port: it imports neither JAX nor the JAX package, its
entry points never fall back to the CPU quietly, and its CUDA wrapper
refuses what the kernel does not take before anything is built."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

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
    ("wide", "N <= 36"), ("f64", "float32"), ("cpu", "CUDA")])
def test_rrs_kernel_wrapper_refuses(rrs_cpu_operands, case, match):
    """The RRS kernel takes N <= 36 f32 tensors on one CUDA device; the
    wrapper refuses anything else before it builds or launches."""
    from vsmartmom_tpu_torch.ops.fused_rrs import _launch_kernel
    ops, ndoubl = rrs_cpu_operands
    if case == "wide":
        ops = ops._replace(Em1=torch.zeros(ops.Em1.shape[:2] + (104,)))
    elif case == "f64":
        ops = type(ops)(*(x.double() for x in ops))
    with pytest.raises(ValueError, match=match):
        _launch_kernel(ops, (0,) * ndoubl, 1)


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
    ("K2", "K = 1"), ("wide", "N <= 52"), ("shape", "shape"),
    ("f64", "float32"), ("cpu", "CUDA")])
def test_mt_kernel_wrapper_refuses(mt_cpu_operands, case, match):
    """K2 takes K = 1, N <= 52, f32 tensors of matching shapes on one CUDA
    device; its launcher refuses anything else before it builds."""
    from vsmartmom_tpu_torch.ops.fused_lin import _launch_kernel
    ops, dops, sched, ns_inter = mt_cpu_operands
    if case == "K2":
        ops = ops._replace(j0_p=torch.cat([ops.j0_p] * 2, dim=-1))
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
