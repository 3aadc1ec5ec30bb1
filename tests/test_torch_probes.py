"""The probe kernels' plain versions against the JAX probes (scripts/probe_*).

Each probe's own Pallas kernel runs on the CPU in interpret mode: the
module-level bodies (P2, P3, P6, P7, P8, P9) through ``pl.pallas_call(...,
interpret=True)`` with the probe's own block specs, the closures and lambdas
(P1, P4, P5) through the script's own builders under
``pltpu.force_tpu_interpret_mode``. Grids and chains are cut with
``monkeypatch`` of the scripts' module constants. Inputs are made with numpy
from a seed. Tolerances: fp32 1e-5 of max|ref| against JAX "highest"; the
single-product modes against the f64 product on (8, 104, 104) standard
normals, tf32 2e-3 and 3xtf32 1e-5; the layout cases exact; the band stages
NaN where the probe gives NaN and 1e-5 of max|ref| where it is finite.
"""

import functools
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _x64_as_the_script_runs(request):
    """JAX's 64-bit mode as each probe script runs with it: off (JAX's
    default) for all but probe_band_bisect, which imports vsmartmom_tpu and
    so runs with it on (the JAX package turns it on when imported, as other
    test files in this process may have done)."""
    with jax.enable_x64("band_bisect" in request.node.name):
        yield


_SCRIPTS = {}


def _script(name):
    """scripts/<name>.py as a module, loaded from its file once (sys.path
    left as it is)."""
    if name not in _SCRIPTS:
        spec = importlib.util.spec_from_file_location(
            f"_probe_script_{name}", ROOT / "scripts" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _SCRIPTS[name] = module
    return _SCRIPTS[name]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _vmem(shape, index_map):
    return pl.BlockSpec(shape, index_map, memory_space=pltpu.VMEM)


# ---------------------------------------------------------------- dot chains

def test_dotperf_mxu_matches_plain(monkeypatch):
    """P8: x <- 0.25 (x @ a) from x = a, a chain of CHAIN products."""
    from vsmartmom_tpu_torch.ops.probe_dots import dot_chain_reference
    P8 = _script("probe_dotperf")
    monkeypatch.setattr(P8, "CHAIN", 3)
    a = (np.random.default_rng(0).random((4, P8.N, P8.N)) / P8.N).astype(
        np.float32)
    spec = _vmem((2, P8.N, P8.N), lambda i: (i, 0, 0))
    fn = pl.pallas_call(functools.partial(P8.mxu_kernel, precision="highest"),
                        grid=(2,), in_specs=[spec], out_specs=spec,
                        out_shape=jax.ShapeDtypeStruct(a.shape, jnp.float32),
                        interpret=True)
    ref = np.asarray(fn(jnp.asarray(a)))
    out = dot_chain_reference(_t(a), _t(a), "right", "fp32", chain=3,
                              scale=0.25)
    assert _rel(out, ref) <= RTOL


def test_dotperf_vpu_matches_plain(monkeypatch):
    """P9: the lane-batched chain on (N, N, s), spectral axis last."""
    from vsmartmom_tpu_torch.ops.probe_dots import lane_dot_chain_reference
    P9 = _script("probe_dotperf")
    monkeypatch.setattr(P9, "CHAIN", 3)
    a = (np.random.default_rng(1).random((P9.N, P9.N, 16)) / P9.N).astype(
        np.float32)
    spec = _vmem((P9.N, P9.N, 8), lambda i: (0, 0, i))
    fn = pl.pallas_call(P9.vpu_kernel, grid=(2,), in_specs=[spec],
                        out_specs=spec,
                        out_shape=jax.ShapeDtypeStruct(a.shape, jnp.float32),
                        interpret=True)
    ref = np.asarray(fn(jnp.asarray(a)))
    out = lane_dot_chain_reference(_t(a), _t(a), 3, 0.25)
    assert _rel(out, ref) <= RTOL


@pytest.mark.parametrize("N", [52, 104])
def test_batched_dot_matches_plain(monkeypatch, N):
    """P1: the closure of pallas_batched, x <- (x @ a) 1.0000001."""
    from vsmartmom_tpu_torch.ops.probe_dots import dot_chain_reference
    P1 = _script("probe_batched_dot")
    monkeypatch.setattr(P1, "S", 8)
    monkeypatch.setattr(P1, "NREP", 3)
    a = (np.random.default_rng(N).random((8, N, N)) / N).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(P1.pallas_batched(N, 4, "highest")(
            jnp.asarray(a), jnp.asarray(a)))
    out = dot_chain_reference(_t(a), _t(a), "right", "fp32", chain=3,
                              scale=1.0000001)
    assert _rel(out, ref) <= RTOL


@pytest.mark.parametrize("prec", ["highest", "float32"])
def test_dot_prec_matches_plain(prec):
    """P6: one batched product at the precisions that map to fp32."""
    from vsmartmom_tpu_torch.ops.probe_dots import (MODE_OF_PRECISION,
                                                    dot_chain_reference)
    P6 = _script("probe_mosaic_dot_prec")
    rng = np.random.default_rng(6)
    x, y = (rng.standard_normal((P6.B, P6.N, P6.N)).astype(np.float32)
            for _ in range(2))
    spec = _vmem((P6.B, P6.N, P6.N), lambda: (0, 0, 0))
    fn = pl.pallas_call(functools.partial(P6.kernel, prec),
                        in_specs=[spec] * 2, out_specs=spec,
                        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
                        interpret=True)
    ref = np.asarray(fn(jnp.asarray(x), jnp.asarray(y)))
    out = dot_chain_reference(_t(x), _t(y), "single", MODE_OF_PRECISION[prec])
    assert _rel(out, ref) <= RTOL


def test_dot_prec_speed_matches_plain(monkeypatch):
    """P2: acc <- x @ acc from acc = y, per grid entry."""
    from vsmartmom_tpu_torch.ops.probe_dots import dot_chain_reference
    P2 = _script("probe_dot_prec_speed")
    monkeypatch.setattr(P2, "CHAIN", 3)
    G, B, N = 2, P2.B, P2.N
    rng = np.random.default_rng(2)
    x = (0.01 * rng.standard_normal((G, B, N, N))).astype(np.float32)
    y = rng.standard_normal((G, B, N, N)).astype(np.float32)
    spec = _vmem((1, B, N, N), lambda i: (i, 0, 0, 0))
    fn = pl.pallas_call(functools.partial(P2.kernel, "highest"), grid=(G,),
                        in_specs=[spec] * 2, out_specs=spec,
                        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
                        interpret=True)
    ref = np.asarray(fn(jnp.asarray(x), jnp.asarray(y)))
    out = dot_chain_reference(_t(x.reshape(G * B, N, N)),
                              _t(y.reshape(G * B, N, N)), "left", "fp32",
                              chain=3)
    assert _rel(out.reshape(ref.shape), ref) <= RTOL


@pytest.mark.parametrize("C", [104, 312])
def test_dot_prec_speed2_matches_plain(monkeypatch, C):
    """P3: acc = sum_k (x + k) @ y, independent products."""
    from vsmartmom_tpu_torch.ops.probe_dots import dot_chain_reference
    P3 = _script("probe_dot_prec_speed2")
    monkeypatch.setattr(P3, "NDOT", 3)
    B, N = P3.B, P3.N
    rng = np.random.default_rng(C)
    x = rng.standard_normal((1, B, N, N)).astype(np.float32)
    y = rng.standard_normal((1, B, N, C)).astype(np.float32)
    fn = pl.pallas_call(
        functools.partial(P3.kernel, "highest"), grid=(1,),
        in_specs=[_vmem((1, B, N, N), lambda i: (i, 0, 0, 0)),
                  _vmem((1, B, N, C), lambda i: (i, 0, 0, 0))],
        out_specs=_vmem((1, B, N, C), lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(y.shape, jnp.float32), interpret=True)
    ref = np.asarray(fn(jnp.asarray(x), jnp.asarray(y)))
    out = dot_chain_reference(_t(x[0]), _t(y[0]), "sum", "fp32", ndot=3)
    assert _rel(out[None], ref) <= RTOL


@pytest.mark.parametrize("mode,tol", [("fp32", 1e-5), ("3xtf32", 1e-5),
                                      ("tf32", 2e-3)])
def test_dot_modes_against_f64(mode, tol):
    """Each mode's single product on (8, 104, 104) standard normals against
    the f64 product: tf32 keeps ~3 decimal digits, 3xtf32 ~f32's."""
    from vsmartmom_tpu_torch.ops.probe_dots import dot_chain_reference
    rng = np.random.default_rng(8)
    x, y = (rng.standard_normal((8, 104, 104)).astype(np.float32)
            for _ in range(2))
    ref = np.einsum("bij,bjk->bik", x.astype(np.float64), y.astype(np.float64))
    err = _rel(dot_chain_reference(_t(x), _t(y), "single", mode), ref)
    assert err <= tol
    if mode == "tf32":
        assert err > 1e-5          # the rounding really happened


def test_round_tf32_rounds_to_nearest_ties_away():
    from vsmartmom_tpu_torch.ops.probe_dots import round_tf32
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                      1 + 1.5 * ulp, 3.0, float("inf"), -float("inf")],
                     dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0,
                         float("inf"), -float("inf")], dtype=torch.float32)
    assert torch.equal(round_tf32(x), want)
    assert torch.isnan(round_tf32(torch.tensor([float("nan")]))).all()
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(
        10000).astype(np.float32))
    t = round_tf32(r)
    assert int((t.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((t - r).abs() / r.abs()).max()) <= 2.0 ** -11


def test_vpu_dot_matches_plain(monkeypatch):
    """P4: the closure of vpu_batched, x <- C(x, a) 1.0000001 on (N, N, s)."""
    from vsmartmom_tpu_torch.ops.probe_dots import lane_dot_chain_reference
    P4 = _script("probe_vpu_dot")
    monkeypatch.setattr(P4, "S", 16)
    monkeypatch.setattr(P4, "NREP", 4)
    a = (np.random.default_rng(4).random((52, 52, 16)) / 52).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(P4.vpu_batched(jnp.asarray(a), 8, inner=2)(
            jnp.asarray(a)))
    out = lane_dot_chain_reference(_t(a), _t(a), 4, 1.0000001)
    assert _rel(out, ref) <= RTOL


# ------------------------------------------------------------ layout cases

@pytest.fixture(scope="module")
def cast_cases():
    """The sixteen (name, lambda, input shapes, output shape) of
    probe_mosaic_casts.main, caught by replacing its ``run``."""
    P5 = _script("probe_mosaic_casts")
    caught = []
    run = P5.run
    P5.run = lambda *case: caught.append(case)
    try:
        P5.main()
    finally:
        P5.run = run
    return caught


@pytest.mark.parametrize("case", range(16))
def test_mosaic_casts_match_plain_exactly(cast_cases, case):
    """P5: every case equal to the probe's lambda. Inputs sit on a 1/256
    grid in [0, 1), so every sum of the dot and reduce cases is exact in
    f32 whatever its order."""
    from vsmartmom_tpu_torch.ops.probe_layout import CASES, layout_op
    name, kernel, in_shapes, out_shape = cast_cases[case]
    assert name == CASES[case].name
    rng = np.random.default_rng(case)
    args = [(rng.integers(0, 256, s) / 256).astype(np.float32)
            for s in in_shapes]
    with pltpu.force_tpu_interpret_mode():
        fn = pl.pallas_call(
            kernel,
            in_specs=[_vmem(s, lambda: (0,) * len(s)) for s in in_shapes],
            out_specs=_vmem(out_shape, lambda: (0,) * len(out_shape)),
            out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32))
        ref = np.asarray(fn(*(jnp.asarray(a) for a in args)))
    out = layout_op(case, *(_t(a) for a in args))
    assert tuple(out.shape) == tuple(out_shape)
    np.testing.assert_array_equal(out.numpy(), ref)


# -------------------------------------------------------------- band stages

def _band_inputs(kind, P7):
    """The probe's own inputs, or bounded ones: Gauss nodes and weights in
    aux, tau in [1e-3, 1e-2], Em1 = expm1(-tau / 16 / mu)."""
    rng = np.random.default_rng(0)
    NZ, S, N = P7.NZ, P7.S, P7.N
    if kind == "probe":
        tau = rng.uniform(0.01, 0.5, (NZ, 1, S))
        Em1 = np.expm1(-rng.uniform(0, 1, (NZ, S, N)))
        aux = rng.uniform(0.2, 1.0, (8, N))
    else:
        x, w = np.polynomial.legendre.leggauss(N)
        mu = (x + 1) / 2
        aux = rng.uniform(0.2, 1.0, (8, N))
        aux[0], aux[1] = mu, w / 2
        tau = rng.uniform(1e-3, 1e-2, (NZ, 1, S))
        Em1 = np.expm1(-tau[:, 0, :, None] / 16 / mu)
    return [a.astype(np.float32) for a in (tau, Em1, aux)]


@pytest.fixture(scope="module")
def band_probe():
    return _script("probe_band_bisect")


@pytest.mark.parametrize("kind", ["probe", "bounded"])
@pytest.mark.parametrize("stage", ["acc", "elem", "src", "pack", "dbl",
                                   "full"])
def test_band_bisect_matches_plain(band_probe, stage, kind):
    """P7: NaN where the probe gives NaN (its dbl and full stages blow up on
    its own inputs, and full on the bounded ones from its all-ones T), the
    values within 1e-5 of max|ref| where it is finite."""
    from vsmartmom_tpu_torch.ops.band_stages import band_stages
    P7 = band_probe
    tau, Em1, aux = _band_inputs(kind, P7)
    bp, Np = P7.S // P7.PACK, P7.PACK * P7.N
    fn = pl.pallas_call(
        functools.partial(P7.kernel, stage), grid=(P7.NZ,),
        in_specs=[_vmem((1, 1, P7.S), lambda z: (z, 0, 0)),
                  _vmem((1, P7.S, P7.N), lambda z: (z, 0, 0)),
                  _vmem((8, P7.N), lambda z: (0, 0))],
        out_specs=_vmem((bp, Np, Np), lambda z: (0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((bp, Np, Np), jnp.float32),
        scratch_shapes=[pltpu.VMEM((bp, Np, Np), jnp.float32)],
        interpret=True)
    ref = np.asarray(fn(*(jnp.asarray(a) for a in (tau, Em1, aux))))
    out = band_stages(stage, _t(tau), _t(Em1), _t(aux)).numpy()
    blows_up = stage == "full" or (stage == "dbl" and kind == "probe")
    assert np.isnan(ref).all() == blows_up
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(out), fin)
    if fin.any():
        assert _rel(out[fin], ref[fin]) <= RTOL


def test_band_bisect_full_stage_is_finite_at_one_layer(band_probe,
                                                     monkeypatch):
    """P7's full stage on the bounded inputs at one layer (the composite
    starts at R = 0): finite throughout in the probe, and the plain version
    within 1e-5 of max|ref|."""
    from vsmartmom_tpu_torch.ops.band_stages import band_stages
    from vsmartmom_tpu_torch.probes.band_bisect import FINITE_CASE
    P7 = band_probe
    stage, kind, nz = FINITE_CASE
    monkeypatch.setattr(P7, "NZ", nz)
    tau, Em1, aux = _band_inputs(kind, P7)
    bp, Np = P7.S // P7.PACK, P7.PACK * P7.N
    fn = pl.pallas_call(
        functools.partial(P7.kernel, stage), grid=(nz,),
        in_specs=[_vmem((1, 1, P7.S), lambda z: (z, 0, 0)),
                  _vmem((1, P7.S, P7.N), lambda z: (z, 0, 0)),
                  _vmem((8, P7.N), lambda z: (0, 0))],
        out_specs=_vmem((bp, Np, Np), lambda z: (0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((bp, Np, Np), jnp.float32),
        scratch_shapes=[pltpu.VMEM((bp, Np, Np), jnp.float32)],
        interpret=True)
    ref = np.asarray(fn(*(jnp.asarray(a) for a in (tau, Em1, aux))))
    out = band_stages(stage, _t(tau), _t(Em1), _t(aux)).numpy()
    assert np.isfinite(ref).all() and np.isfinite(out).all()
    assert np.abs(ref).max() > 0
    assert _rel(out, ref) <= RTOL


@pytest.mark.parametrize("case", range(16))
def test_layout_yardstick_writes_the_output(case):
    """P5's library yardstick does the kernel's work: a new contiguous
    tensor equal to the case's output, never a view of an input (seven of
    the sixteen expressions are views)."""
    from vsmartmom_tpu_torch.ops.probe_layout import (CASES,
                                                      layout_op_reference)
    from vsmartmom_tpu_torch.probes.layout_ops import (inputs, shares_input,
                                                       written_out)
    ins = inputs(case, torch.device("cpu"))
    out = written_out(CASES[case], ins)()
    assert out.is_contiguous() and not shares_input(out, ins)
    assert torch.equal(out, layout_op_reference(case, *ins))
    each = [inputs(i, torch.device("cpu")) for i in range(len(CASES))]
    assert sum(shares_input(c.plain(*x), x) for c, x in zip(CASES, each)) \
        == 7


# ------------------------------------------------------------ probe modules

@pytest.mark.parametrize("module,kw", [
    ("dotperf", dict(s=4, chain=10)),
    ("batched_dot", dict(s=2, chain=10)),
    ("dot_prec", {}),
    ("dot_prec_speed", dict(grid=1, chain=10)),
    ("dot_prec_speed2", dict(grid=1, ndot=2)),
    ("vpu_dot", dict(s=4, chain=10)),
    ("layout_ops", {}),
    ("band_bisect", {})])
def test_probe_module_runs_on_the_cpu(module, kw):
    """Each probe module at cut shapes on the CPU, where its wrappers run
    the plain versions: every case meets its gates, each mode's single
    product is of its class against f64 (tf32 2e-3, the others 1e-5), and
    no time is taken (a CPU time is no device metric)."""
    from vsmartmom_tpu_torch.probes import SITES
    from vsmartmom_tpu_torch.probes.common import chain_failures
    mod = importlib.import_module(f"vsmartmom_tpu_torch.probes.{module}")
    result = mod.run(device="cpu", **kw)
    assert result["device"] == "cpu"
    for site in SITES[module]:
        cases = result[site]
        assert cases and all(c["ms"] is None for c in cases)
        for c in cases:
            if site == "P5":
                assert c["exact"] and c["err_f64"] == 0
            elif site == "P7":
                assert c["nan_match"] and c["err_plain"] == 0
                assert c["finite_share"] == 1.0 or not c["must_be_finite"]
            else:
                assert chain_failures(c) == []
                assert c["err_f64"][1] <= (2e-3 if c["mode"] == "tf32"
                                           else 1e-5)


# ------------------------------------------------------------ the wrappers

def _no_build(monkeypatch):
    from vsmartmom_tpu_torch.ops import cuda_build

    def no_build(name):
        raise AssertionError("the launcher tried to build a kernel")
    monkeypatch.setattr(cuda_build, "load", no_build)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"), ("f64", "float32"), ("shape", "shape"),
    ("wide", "n <= 128"), ("form", "form"), ("mode", "mode"),
    ("chain", ">= 1")])
def test_dot_chain_launcher_refuses(monkeypatch, case, match):
    """The dot_chain launcher takes contiguous f32 tensors of matching
    shapes on one CUDA device, n <= 128, a known form and mode and a chain
    >= 1; it refuses anything else before any build."""
    from vsmartmom_tpu_torch.ops.probe_dots import _launch_dot_chain
    _no_build(monkeypatch)
    n = 130 if case == "wide" else 8
    x = torch.zeros((2, n, n), dtype=torch.float64 if case == "f64"
                    else torch.float32)
    y = x[:, :, :-1] if case == "shape" else x
    kw = dict(form="bad" if case == "form" else "right",
              mode="bf16" if case == "mode" else "fp32",
              chain=0 if case == "chain" else 2, scale=1.0, ndot=1)
    with pytest.raises(ValueError, match=match):
        _launch_dot_chain(x, y, **kw)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"), ("f64", "float32"), ("shape", "shape"),
    ("chain", ">= 1"), ("wide", "n <= 64")])
def test_lane_dot_chain_launcher_refuses(monkeypatch, case, match):
    from vsmartmom_tpu_torch.ops.probe_dots import _launch_lane_dot_chain
    _no_build(monkeypatch)
    n = 65 if case == "wide" else 6
    x = torch.zeros((n, n, 4), dtype=torch.float64 if case == "f64"
                    else torch.float32)
    a = x[:, :, :3] if case == "shape" else x
    with pytest.raises(ValueError, match=match):
        _launch_lane_dot_chain(x, a, 0 if case == "chain" else 2, 1.0)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"), ("f64", "float32"), ("shape", "shape"),
    ("index", "not in"), ("inputs", "takes 2 inputs")])
def test_layout_launcher_refuses(monkeypatch, case, match):
    from vsmartmom_tpu_torch.ops.probe_layout import _launch_layout
    _no_build(monkeypatch)
    dtype = torch.float64 if case == "f64" else torch.float32
    x = torch.zeros((4, 6, 6), dtype=dtype)
    y = torch.zeros((4, 6, 5)) if case == "shape" else x
    which = {"index": 16, "inputs": 12}.get(case, 8)
    inputs = (x,) if case == "inputs" else (x, y)
    with pytest.raises(ValueError, match=match):
        _launch_layout(which, inputs)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"), ("f64", "float32"), ("shape", "shape"),
    ("wide", "2N <= 64"), ("odd", "even S"), ("stage", "stage")])
def test_band_launcher_refuses(monkeypatch, case, match):
    from vsmartmom_tpu_torch.ops.band_stages import _launch_band
    _no_build(monkeypatch)
    nz, S, N = 2, 5 if case == "odd" else 4, 33 if case == "wide" else 6
    dtype = torch.float64 if case == "f64" else torch.float32
    tau = torch.zeros((nz, 1, S), dtype=dtype)
    Em1 = torch.zeros((nz, S, N), dtype=dtype)
    aux = torch.zeros((8, N + (case == "shape")), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        _launch_band("bad" if case == "stage" else "full", tau, Em1, aux)


# ------------------------------------------------------------ launch plans

_FORMS = ("right", "left", "sum", "single")


@pytest.mark.parametrize("mode", ["fp32", "tf32", "3xtf32"])
def test_dot_chain_plan_fills_the_card_for_one_small_batch(mode):
    """P6's single product of (8, 104, 104) runs as >= 112 blocks (the
    batch alone gave 8), each within the shared-memory limit."""
    from vsmartmom_tpu_torch.ops.probe_dots import (SMEM_LIMIT,
                                                    dot_chain_plan)
    plan = dot_chain_plan(8, 104, 104, "single", mode)
    assert plan.blocks >= 112 and plan.smem <= SMEM_LIMIT


@pytest.mark.parametrize("form,modes", [
    ("right", ("fp32", "tf32", "3xtf32")), ("left", ("fp32", "tf32", "3xtf32")),
    ("sum", ("fp32", "tf32"))])
def test_dot_chain_plan_keeps_two_slabs_per_sm_at_104(form, modes):
    """At n = 104 (P1, P2, P3's modes) at least two row or column slabs are
    in flight per SM by shared memory: two resident blocks, or one block of
    two warpgroups that share y (right) or the column slab (left)."""
    from vsmartmom_tpu_torch.ops.probe_dots import dot_chain_plan
    c = 312 if form == "sum" else 104
    for mode in modes:
        plan = dot_chain_plan(512, 104, c, form, mode)
        per_block = plan.threads // 128 if mode != "fp32" else 1
        assert plan.resident_by_smem * per_block >= 2, (mode, plan)


@pytest.mark.parametrize("n", [1, 13, 52, 100, 104, 128])
def test_dot_chain_plan_covers_every_shape(n):
    """Every form and mode has a plan at the ragged widths, batch 1 and
    2048: its blocks cover the output, a chain's block holds all its
    columns (right) or rows (left), and it fits the kernels' limits."""
    from vsmartmom_tpu_torch.ops.probe_dots import (SMEM_LIMIT,
                                                    dot_chain_plan,
                                                    tf32_depth)
    for form in _FORMS:
        c = 3 * n + 5 if form in ("sum", "single") else n
        for mode in ("fp32", "tf32", "3xtf32"):
            for batch in (1, 2048):
                p = dot_chain_plan(batch, n, c, form, mode)
                assert p.grid[0] == batch and p.smem <= SMEM_LIMIT
                assert p.rows * p.grid[1] >= n and p.cols * p.grid[2] >= c
                assert p.rows * (p.grid[1] - 1) < n
                assert p.cols * (p.grid[2] - 1) < c
                if form == "right":
                    assert p.grid[2] == 1
                if form == "left":
                    assert p.grid[1] == 1
                if mode == "fp32":
                    assert p.rows % 4 == 0 and p.cols % 8 == 0
                    assert p.threads <= 256
                else:
                    depth = tf32_depth(n)
                    assert p.rows == 64 or (p.rows == 128 and depth >= 104)
                    assert p.cols in (16, depth)
                    assert p.threads == 2 * p.rows


@pytest.mark.parametrize("n,s", [(52, 2048), (52, 101), (52, 1), (13, 6),
                                 (64, 5)])
def test_lane_dot_chain_plan(n, s):
    """At least two points per block, blocks covering s (also s < P and s
    not a multiple of P), a block's x, a and step output within shared
    memory, and at n = 52 room for two blocks per SM."""
    from vsmartmom_tpu_torch.ops.probe_dots import (SMEM_LIMIT,
                                                    lane_dot_chain_plan)
    p = lane_dot_chain_plan(n, s)
    assert p.points >= 2 and p.grid[0] * p.points >= s
    assert (p.grid[0] - 1) * p.points < s
    assert p.smem <= SMEM_LIMIT and p.threads <= 512
    if n == 52:
        assert p.resident_by_smem >= 2


@pytest.mark.parametrize("args,match", [
    ((8, 130, 130, "right", "fp32"), "n <= 128"),
    ((8, 52, 56, "right", "tf32"), "c == n"),
    ((8, 52, 52, "cube", "fp32"), "form"),
    ((8, 52, 52, "sum", "bf16"), "mode")])
def test_dot_chain_plan_refuses(monkeypatch, args, match):
    """The plan refuses operands the kernels do not take, before any
    build."""
    from vsmartmom_tpu_torch.ops.probe_dots import dot_chain_plan
    _no_build(monkeypatch)
    with pytest.raises(ValueError, match=match):
        dot_chain_plan(*args)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors each wrapper returns its plain version's output and
    counts no launch."""
    from vsmartmom_tpu_torch.ops import band_stages, probe_dots, probe_layout
    g = torch.Generator().manual_seed(0)
    x, y = (torch.rand((3, 8, 8), generator=g) for _ in range(2))
    lanes = torch.rand((6, 6, 5), generator=g)
    tau = torch.rand((2, 1, 4), generator=g)
    Em1 = -0.1 * torch.rand((2, 4, 3), generator=g)
    aux = 0.2 + torch.rand((8, 3), generator=g)
    wrappers = (probe_dots.dot_chain, probe_dots.lane_dot_chain,
                probe_layout.layout_op, band_stages.band_stages)
    before = [w.launches for w in wrappers]
    for mode in probe_dots.MODES:
        assert torch.equal(
            probe_dots.dot_chain(x, y, "left", mode, chain=2),
            probe_dots.dot_chain_reference(x, y, "left", mode, chain=2))
    assert torch.equal(probe_dots.lane_dot_chain(lanes, lanes, 2, 0.5),
                       probe_dots.lane_dot_chain_reference(lanes, lanes, 2,
                                                           0.5))
    assert torch.equal(probe_layout.layout_op(15, x),
                       probe_layout.layout_op_reference(15, x))
    out = band_stages.band_stages("dbl", tau, Em1, aux)
    ref = band_stages.band_stages_reference("dbl", tau, Em1, aux)
    assert torch.equal(out, ref) and out.shape == (2, 6, 6)
    assert [w.launches for w in wrappers] == before
