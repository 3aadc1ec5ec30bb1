"""Boundaries of the port: it imports neither JAX nor the JAX package, names
no path inside the JAX package, its absorption modules import no h5py, its
entry points never fall back to the CPU quietly, and its CUDA wrapper
refuses what the kernel does not take before anything is built."""

import ast
import re
import subprocess
import sys
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
    files = _port_files()
    assert len(files) > 15
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"vsmartmom_tpu_torch/parallel/__init__.py",
            "vsmartmom_tpu_torch/parallel/sharding.py"} <= names
    bad = [(f.relative_to(ROOT).as_posix(), mod) for f in files
           for mod in _imported_roots(f) if mod in FORBIDDEN]
    assert not bad, bad


def test_parallel_modules_import_no_jax():
    """The sharding modules and the dry run's module, imported in a fresh
    interpreter, load neither JAX nor the JAX package."""
    code = ("import sys\n"
            "import vsmartmom_tpu_torch.parallel\n"
            "import vsmartmom_tpu_torch.parallel.sharding\n"
            "from vsmartmom_tpu_torch.flagship import dryrun_multichip\n"
            "print([k for k in ('jax', 'jaxlib', 'vsmartmom_tpu') "
            "if k in sys.modules])\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert run.stdout.strip().splitlines()[-1] == "[]"


#: A "file:line" citation of a TPU kernel (chip_smoke.py's ``replaces``):
#: it names the kernel it stands for and opens no file.
CITATION = re.compile(r"^vsmartmom_tpu/[\w/]+\.py:\d+$")


def _port_files():
    files = sorted((ROOT / "vsmartmom_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _jax_package_paths(path):
    """(line, literal) of each string literal of ``path`` that names a path
    inside the JAX package: a "vsmartmom_tpu" path part (a string or an
    f-string piece, split at / and \\), docstrings and kernel citations
    aside."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docstrings = {id(node.body[0].value) for node in ast.walk(tree)
                  if isinstance(node, (ast.Module, ast.ClassDef,
                                       ast.FunctionDef, ast.AsyncFunctionDef))
                  and node.body and isinstance(node.body[0], ast.Expr)
                  and isinstance(node.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docstrings
                and "vsmartmom_tpu" in re.split(r"[/\\]", node.value)
                and not CITATION.match(node.value)):
            yield node.lineno, node.value


def test_no_path_inside_the_jax_package():
    """No module of the port nor chip_smoke.py names a file or directory of
    the JAX package: the port reads its own copies (e.g. the HITRAN
    tables, ``data/hitran_tables.npz``)."""
    bad = [(f.relative_to(ROOT).as_posix(), line, lit)
           for f in _port_files() for line, lit in _jax_package_paths(f)]
    assert not bad, bad


@pytest.mark.parametrize("literal,flagged", [
    ("vsmartmom_tpu", 2), ("vsmartmom_tpu/absorption/data", 2),
    ("../vsmartmom_tpu/core", 2), ("vsmartmom_tpu\\data", 2),
    ("vsmartmom_tpu_torch", 0), ("vsmartmom_tpu_torch/data", 0),
    ("vsmartmom_tpu/ops/fused_band.py:469", 1)])
def test_the_path_check_finds_jax_package_paths(tmp_path, literal, flagged):
    """The check above flags a JAX-package path in a string and in an
    f-string piece that builds a path from it, and passes the port's own
    paths, docstrings and a bare kernel citation."""
    src = tmp_path / "mod.py"
    src.write_text(f'"""{literal}"""\nP = {literal!r}\n'
                   f'Q = f"{{P}}/{literal}/x"\n')
    assert len(list(_jax_package_paths(src))) == flagged


ABSORPTION_MODULES = ("hitran", "voigt", "cross_section", "continuum",
                      "artifacts")


@pytest.fixture(scope="module")
def absorption_imports():
    """The modules that importing every ``vsmartmom_tpu_torch.absorption``
    module loads, in a fresh interpreter: {module: [h5py / jax loaded]}."""
    code = ("import sys, json\nout = {}\n"
            "for m in %r:\n"
            "    __import__('vsmartmom_tpu_torch.absorption.' + m)\n"
            "    out[m] = [k for k in ('h5py', 'jax', 'jaxlib', "
            "'vsmartmom_tpu') if k in sys.modules]\n"
            "print(json.dumps(out))\n" % (ABSORPTION_MODULES,))
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    import json
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", ABSORPTION_MODULES)
def test_absorption_modules_import_no_h5py_or_jax(absorption_imports,
                                                  module):
    assert absorption_imports[module] == []


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


#: The Raman modules of the port: the vibrational lines, the VS and stellar
#: setups and entry points, the fixed-source map and the multisensor Raman
#: solve.
RAMAN_MODULES = ("inelastic.molecular", "inelastic.vs_setup",
                 "inelastic.stellar", "core.inelastic", "core.multisensor")


@pytest.fixture(scope="module")
def raman_imports():
    """The forbidden modules that importing each Raman module of the port
    loads, in a fresh interpreter: {module: [jax / vsmartmom_tpu loaded]}."""
    code = ("import sys, json\nout = {}\n"
            "for m in %r:\n"
            "    __import__('vsmartmom_tpu_torch.' + m)\n"
            "    out[m] = [k for k in %r if k in sys.modules]\n"
            "print(json.dumps(out))\n" % (RAMAN_MODULES, FORBIDDEN))
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    import json
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", RAMAN_MODULES)
def test_raman_modules_import_no_jax(raman_imports, module):
    path = ROOT / "vsmartmom_tpu_torch" / (module.replace(".", "/") + ".py")
    assert path in _port_files()
    assert raman_imports[module] == []


@pytest.mark.parametrize("mode", ["RRS", "VS_0to1"])
def test_rt_run_inelastic_needs_cuda_or_an_explicit_device(monkeypatch,
                                                            mode):
    from vsmartmom_tpu_torch import rt_run_inelastic
    from vsmartmom_tpu_torch.flagship import vs_ref_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt_run_inelastic(vs_ref_model(), mode=mode)


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
    ("K3", "K <= 2"), ("wide", "N <= 128"), ("shape", "shape"),
    ("f64", "float32"), ("cpu", "CUDA")])
def test_mt_kernel_wrapper_refuses(mt_cpu_operands, case, match):
    """K2 takes K <= 2, N <= 128, f32 tensors of matching shapes on one
    CUDA device; its launcher refuses anything else before it builds."""
    from vsmartmom_tpu_torch.ops.fused_lin import _launch_kernel
    ops, dops, sched, ns_inter = mt_cpu_operands
    if case == "K3":
        ops = ops._replace(j0_p=torch.cat([ops.j0_p] * 3, dim=-1))
    elif case == "wide":
        ops = ops._replace(Em1=torch.zeros(ops.Em1.shape[:2] + (132,)))
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


#: The GEOS-Chem slice's modules: aerosol ingest, the PCW / Wigner
#: decomposition, the scene-file front end and the scenes that drive them.
INGEST_MODULES = ("aerosols", "aerosols.ncio", "aerosols.schemes",
                  "aerosols.refractive", "aerosols.readers",
                  "aerosols.optics", "scattering.wigner", "scattering.pcw",
                  "scattering.stokes", "io.formats", "io.yaml_input",
                  "io.geoschem", "flagship")
#: Packages the card's machine lacks: PyYAML, jsonschema, h5py.
OPTIONAL = ("yaml", "jsonschema", "h5py")


@pytest.fixture(scope="module")
def ingest_imports():
    """In a fresh interpreter with PyYAML, jsonschema and h5py blocked
    (``sys.modules[name] = None``, so importing them raises): each ingest
    module's import error (None if it imported) and the forbidden modules
    it loaded; then the small GEOS-Chem scene built from its NetCDF-3
    collections and TOML scene file without schema validation, as
    chip_smoke.py builds it ("ok" or the error)."""
    code = ("import sys, json, tempfile\n"
            "for name in %r:\n"
            "    sys.modules[name] = None\n"
            "out = {}\n"
            "for m in %r:\n"
            "    try:\n"
            "        __import__('vsmartmom_tpu_torch.' + m)\n"
            "        err = None\n"
            "    except Exception as e:\n"
            "        err = repr(e)\n"
            "    out[m] = [err, [k for k in %r if k in sys.modules]]\n"
            "from vsmartmom_tpu_torch import flagship\n"
            "try:\n"
            "    with tempfile.TemporaryDirectory() as d:\n"
            "        files = flagship.write_geoschem_column(\n"
            "            d, n_lev=6, species=('SO4', 'DST'))\n"
            "        flagship.geoschem_ref_model(files=files)\n"
            "    out['scene'] = 'ok'\n"
            "except Exception as e:\n"
            "    out['scene'] = repr(e)\n"
            "print(json.dumps(out))\n" % (OPTIONAL, INGEST_MODULES,
                                           FORBIDDEN))
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    import json
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", INGEST_MODULES)
def test_ingest_modules_import_without_yaml_jsonschema_h5py(ingest_imports,
                                                            module):
    """Each ingest module imports with PyYAML, jsonschema and h5py blocked,
    and loads neither JAX nor the JAX package."""
    path = ROOT / "vsmartmom_tpu_torch" / module.replace(".", "/")
    assert path.with_suffix(".py") in _port_files() or \
        path / "__init__.py" in _port_files()
    assert ingest_imports[module] == [None, []]


def test_geoschem_scene_builds_without_yaml_jsonschema_h5py(ingest_imports):
    assert ingest_imports["scene"] == "ok"


#: The land and single-scatter slice's modules: the surfaces, the single-
#: scatter solvers, the sources, the timing table, the Radau streams.
LAND_MODULES = ("surfaces.canopy", "surfaces.land_brdf",
                "surfaces.lambertian", "core.singlescatter", "standalone_ss",
                "sif", "solar", "utils.timing", "utils.quadrature")

#: A TOML scene with a canopy: section (two sublayers over an RPV soil).
CANOPY_TOML = """
[radiative_transfer]
spec_bands = ["[13300.0 13900.0]"]
surface = ["rpvSurfaceScalar(0.1, 0.1, 0.75, -0.1)"]
polarization_type = "Stokes_I()"
nstreams = 2
float_type = "Float64"
[canopy]
LAI = 2.0
n_layers = 2
leaf_reflectance = 0.4
leaf_transmittance = 0.05
clumping = "no-clumping"
[geometry]
sza = 30.0
vza = [0.0, 30.0]
vaz = [0.0, 0.0]
obs_alt = 1000.0
[atmospheric_profile]
T = [250.0, 270.0, 285.0]
p = [100.0, 500.0, 800.0, 1000.0]
"""


@pytest.fixture(scope="module")
def land_imports(tmp_path_factory):
    """In a fresh interpreter with PyYAML, jsonschema and h5py blocked:
    each land-slice module's import error (None if it imported) and the
    forbidden modules it loaded; then ``canopy_model``'s construction at 4
    points and a TOML scene with a ``canopy:`` section through
    ``parameters_from_file`` (no schema validation) and a canopy build on
    the CPU ("ok" or the error)."""
    scene = tmp_path_factory.mktemp("canopy") / "canopy.toml"
    scene.write_text(CANOPY_TOML)
    code = ("import sys, json\n"
            "for name in %r:\n"
            "    sys.modules[name] = None\n"
            "out = {}\n"
            "for m in %r:\n"
            "    try:\n"
            "        __import__('vsmartmom_tpu_torch.' + m)\n"
            "        err = None\n"
            "    except Exception as e:\n"
            "        err = repr(e)\n"
            "    out[m] = [err, [k for k in %r if k in sys.modules]]\n"
            "import numpy as np\n"
            "from vsmartmom_tpu_torch import (canopy_model,\n"
            "    model_from_parameters, parameters_from_file)\n"
            "try:\n"
            "    canopy_model(4, np.float64, device='cpu')\n"
            "    p = parameters_from_file(%r, validate=False)\n"
            "    assert p.surfaces[0].kind == 'CanopySurface'\n"
            "    m = model_from_parameters(p, device='cpu')\n"
            "    inputs, _ = m.build_band(0, device='cpu')\n"
            "    assert inputs.surf_r.dim() == 3\n"
            "    out['scene'] = 'ok'\n"
            "except Exception as e:\n"
            "    out['scene'] = repr(e)\n"
            "print(json.dumps(out))\n" % (OPTIONAL, LAND_MODULES, FORBIDDEN,
                                           str(scene)))
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    import json
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", LAND_MODULES)
def test_land_modules_import_without_jax_or_yaml(land_imports, module):
    path = ROOT / "vsmartmom_tpu_torch" / (module.replace(".", "/") + ".py")
    assert path in _port_files()
    assert land_imports[module] == [None, []]


def test_canopy_scenes_build_without_yaml(land_imports):
    assert land_imports["scene"] == "ok"


@pytest.mark.parametrize("entry", ["rt_run_ss", "run_exact_ss"])
def test_single_scatter_needs_cuda_or_an_explicit_device(monkeypatch,
                                                         entry):
    from vsmartmom_tpu_torch import flagship
    from vsmartmom_tpu_torch import rt_run_ss, run_exact_ss
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "rt_run_ss":
            rt_run_ss(flagship.flagship_model(n_spec=2, nstreams=2))
        else:
            run_exact_ss(flagship.exact_ss_config(2, nz=3)[0])
