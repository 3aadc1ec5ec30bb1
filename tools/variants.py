"""Where a hand-written kernel's time goes: one launch at a main-path shape,
timed for the kernels as built and for variants compiled from patched
copies of their sources (``vsmartmom_tpu_torch/csrc``). Two groups:

``mt``: K2 / K1′ (``fused_lin.cu``), moment 0 of a Jacobian scene (scenes
``aerosol`` and ``thermal``); variants

* ``c<n>``: clusters of at most n blocks (``VSM_CLUSTER``; the host plan
  follows), a kernel that computes the same outputs;
* ``local``: primal results stored into this block's copy only (no
  distributed-shared-memory stores), for timing only;
* ``nomac``: no product loop (everything else of the kernel), for timing
  only;
* ``empty``: phases that run no job at all (the barriers, the elementwise
  passes and the calls remain), for timing only.

``tile``: K1 (``fused_band.cu``) at the flagship's moment 0 (nSpec points),
K5 (``fused_rt.cu``) at moments 0 and m_max (every layer of nSpec points)
and K4 (``fused_rt.cu``) on the middle layer of moment 0, all on
``fp32_tile.cuh``; each variant also reads each kernel's largest relative
difference from its plain version, and whether K1's outputs equal the
first variant's bit for bit (``built``, or ``parent=DIR`` listed first);
variants

* ``t<n>``: n threads a block (both kernels), two blocks an SM;
* ``t<n>x<b>``: n threads, the register budget of b blocks an SM;
* ``wide``: one-product phases in 4 x 8 tiles too (not 4 x 4);
* ``nomac``, ``empty``: as above, for timing only;
* ``epist``: every tile stored without its epilogue, for timing only;
* ``novec``: no vector job, for timing only;
* ``bcasta`` / ``bcastb``: every tile reads the A rows / B columns of the
  first tile (one address a warp), for timing only;
* ``inline``: the phase function inlined at its call sites;
* ``u1`` / ``u4``: the product loop not unrolled / unrolled 4 times.

``rrs``: K3 (``fused_rrs.cu``, on ``fp32_tile.cuh``) at moment 0 of the
RRS+SIF scene (nSpec points), both launches and each alone, and the
largest relative difference from the dense plain version; variants

* ``nomac``: no product loop in either launch, for timing only;
* ``empty``: phases that run no job at all (the staging copies, saves,
  rides, barriers and assembly remain), for timing only;
* ``narrow2``: the pair launch's (2,1) phases in 4 x 4 tiles wherever
  they fit the block's lanes (two-product phases too, not only
  one-product ones);
* ``p<n>``: the pair launch's pool capped at n slots (the plan splits
  phases and loads after the previous phase where it must);
* ``onestore``: every staging copy of the pair launch reads the first
  entry of its target point's store (the product loop and the copies'
  count stay, their L2 traffic goes), for timing only.

In every group variants join with ``+`` (``t256+wide``), and
``parent=DIR`` builds the sources under DIR/vsmartmom_tpu_torch/csrc (an
unpacked older checkout, e.g. ``git archive`` of the parent commit; its
C interface must be the current one, which the wrappers call).

Run on a machine with an NVIDIA GPU, from the repo root:
``python3 -m tools.variants GROUP [n_spec] [variants] [scenes]``
(comma-separated; defaults 1024 (256 for ``rrs``),
``c2,c4,c8,local,nomac,empty`` for ``mt``, ``t256,wide,nomac,empty`` for
``tile`` and ``nomac,empty,onestore`` for ``rrs``, scenes
``aerosol,thermal``). Builds go to ``vsmartmom_tpu_torch/_build/variants/``,
all started together; a patch that no longer matches its source stops the
run. Prints the card, each build's ptxas registers and spills, and one
JSON line a (scene,) variant: kernel ms (CUDA events, mean of 3 after a
warm-up)."""

import contextlib
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import cuda_time_ms, rel

#: Seconds one variant's nvcc may take before the variant is dropped.
BUILD_TIMEOUT = 300

#: Each group's sources (one library each) and named patches: (file, old,
#: new) edits of the sources or of a header they include.
SOURCES = {"mt": ("fused_lin.cu",), "tile": ("fused_band.cu", "fused_rt.cu")}
PATCHES = {
    "mt": {
        "local": [("fused_lin.cu", "  if (!shared) return;\n  for (int r = 0;",
                   "  return;\n  for (int r = 0;")],
        "nomac": [("fused_lin.cu",
                   "    mac(A, B, i0, j0, min(j0 + x.h, x.LD - 4), k0, k1, "
                   "x.n, x.LD, acc);", "")],
        "empty": [("fused_lin.cu",
                   "for (int w = threadIdx.x >> 5; w < mw + vw;",
                   "for (int w = threadIdx.x >> 5; w < 0;")],
    },
    "tile": {
        "wide": [("fp32_tile.cuh",
                  "const bool narrow = nm == 1 && x.tiles4 <= lanes;",
                  "const bool narrow = false;")],
        "nomac": [("fp32_tile.cuh",
                   "  mac<W>(mat_slot(x, slot(code, 0)), "
                   "mat_slot(x, slot(code, 1)), i0, j0,\n"
                   "         min(jh, x.LD - 4), x.n, x.LD, acc);", "")],
        "empty": [("fp32_tile.cuh",
                   "for (int w = threadIdx.x >> 5; w < mw + vw;",
                   "for (int w = threadIdx.x >> 5; w < 0;")],
        "epist": [("fp32_tile.cuh",
                   "st4(C + idx, epi4<OFF>(EPI, C, E, v, idx, i, j, d));",
                   "st4(C + idx, v);")],
        "novec": [("fp32_tile.cuh", "if (t < nv * nvo)", "if (t < 0)")],
        "bcasta": [("fp32_tile.cuh", "mat_slot(x, slot(code, 1)), i0, j0,",
                    "mat_slot(x, slot(code, 1)), 0, j0,")],
        "bcastb": [("fp32_tile.cuh",
                    "i0, j0,\n         min(jh, x.LD - 4), x.n",
                    "i0, 0,\n         0, x.n")],
        "inline": [("fp32_tile.cuh", "__device__ __noinline__ void phase(",
                    "__device__ __forceinline__ void phase(")],
        "u1": [("fp32_tile.cuh", "#pragma unroll 2\n  for (; k < n4; k += 4)",
                "#pragma unroll 1\n  for (; k < n4; k += 4)")],
        "u4": [("fp32_tile.cuh", "#pragma unroll 2\n  for (; k < n4; k += 4)",
                "#pragma unroll 4\n  for (; k < n4; k += 4)")],
    },
}
PATCHES["rrs"] = {
    "nomac": PATCHES["tile"]["nomac"] + [
        ("fp32_tile.cuh",
         "  mac<W>(mat_slot(x, slot(code, 0)), mat_slot(x, slot(code2, 1)), "
         "i0, j0,\n         min(jh, x.LD - 4), x.n, x.LD, acc);\n"
         "  mac<W>(mat_slot(x, slot(code2, 0)), mat_slot(x, slot(code, 1)), "
         "i0, j0,\n         min(jh, x.LD - 4), x.n, x.LD, acc);", "")],
    "empty": PATCHES["tile"]["empty"],
    "narrow2": [("fp32_tile.cuh",
                 "const bool narrow = x.tiles4 <= lanes && nm == 1;",
                 "const bool narrow = nm * x.tiles4 <= lanes;")],
    "onestore": [
        ("fused_rrs.cu", "from = (src ? vs_src : vs_tgt) + e * x.LD;",
         "from = vs_tgt;"),
        ("fused_rrs.cu", "from = (src ? ms_src : ms_tgt) + e * x.MS;",
         "from = ms_tgt;")],
}
SOURCES["rrs"] = ("fused_rrs.cu",)
DEFAULTS = {"mt": "c2,c4,c8,local,nomac,empty",
            "tile": "t256,wide,nomac,empty",
            "rrs": "nomac,empty,onestore"}


def cluster_of(name, default):
    """The cluster limit of an ``mt`` variant (``c<n>``), else default."""
    for part in name.split("+"):
        if re.fullmatch(r"c\d+", part):
            return int(part[1:])
    return default


def patches(group, name):
    """The (file, old, new) edits of a variant."""
    edits = []
    for part in name.split("+"):
        cluster = re.fullmatch(r"c(\d+)", part)
        threads = re.fullmatch(r"t(\d+)(?:x(\d))?", part)
        if part == "built" or (group == "rrs" and re.fullmatch(r"p\d+",
                                                                part)):
            continue
        if group == "mt" and cluster:
            edits.append(("fused_lin.cu", "#define VSM_CLUSTER ",
                          f"#define VSM_CLUSTER {cluster.group(1)} //"))
        elif group == "tile" and threads:
            n, blocks = threads.group(1), threads.group(2) or "2"
            for src, define in (("fused_band.cu", "VSM_THREADS"),
                                ("fused_rt.cu", "VSM_K5_THREADS")):
                edits.append((src, f"#define {define} ",
                              f"#define {define} {n} //"))
                edits.append((src, f"__launch_bounds__({define}, 2)",
                              f"__launch_bounds__({define}, {blocks})"))
        else:
            edits += PATCHES[group][part]
    return edits


def variant_files(group, name, src_dir):
    """{file: patched text} of a variant: the group's sources and every
    header; stops the run on a patch that no longer matches."""
    files = {f: (src_dir / f).read_text() for f in SOURCES[group]}
    files.update({p.name: p.read_text() for p in src_dir.glob("*.cuh")})
    if not name.startswith("parent="):
        for f, old, new in patches(group, name):
            if old not in files[f]:
                sys.exit(f"variant {name}: its patch no longer matches {f}: "
                         f"{old!r}")
            files[f] = files[f].replace(old, new)
    return files


def build_variant(group, name, files, out_dir):
    """nvcc of every source of a variant, started together: {source: (proc,
    library)}."""
    from vsmartmom_tpu_torch.ops import cuda_build
    vdir = out_dir / name.replace("/", "_").replace("=", "_")
    vdir.mkdir(parents=True, exist_ok=True)
    for f, text in files.items():
        (vdir / f).write_text(text)
    procs = {}
    for src in SOURCES[group]:
        so = vdir / f"lib{Path(src).stem}.so"
        procs[src] = (subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", str(vdir),
             "-o", str(so), str(vdir / src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    return procs


def load_variant(name, procs):
    """{library name: CDLL} of a built variant, or None if a build ran past
    BUILD_TIMEOUT; prints each build's registers and spills."""
    libs = {}
    for src, (proc, so) in procs.items():
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            for other, _ in procs.values():
                other.kill()
                other.communicate()
            print(f"  {name} {src}: nvcc past {BUILD_TIMEOUT} s, variant "
                  "dropped", flush=True)
            return None
        if proc.returncode != 0:
            sys.exit(f"variant {name} did not build {src}:\n{log}")
        (so.parent / f"{Path(src).stem}.ptxas.log").write_text(log)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name} {src}: {line.strip()}", flush=True)
        libs[Path(src).stem] = ctypes.CDLL(str(so))
    return libs


@contextlib.contextmanager
def variant(libs, cluster=None):
    """The wrappers launch the variant's libraries inside the block (and
    fused_lin plans for cluster limit `cluster`, where given)."""
    from vsmartmom_tpu_torch.ops import cuda_build, fused_lin
    old = {k: cuda_build._LIBS.get(k) for k in libs}, fused_lin.KERNEL_CLUSTER
    cuda_build._LIBS.update(libs)
    if cluster is not None:
        fused_lin.KERNEL_CLUSTER = cluster
    try:
        yield
    finally:
        cuda_build._LIBS.update(old[0])
        fused_lin.KERNEL_CLUSTER = old[1]


def time_mt(libs, n_spec, scenes):
    """One JSON line a (scene, variant): K2 / K1′ at moment 0, its plan,
    the clusters resident at once, waves and ms per wave."""
    from vsmartmom_tpu_torch import (default_layout, flagship_model,
                                     thermal_lin_model)
    from vsmartmom_tpu_torch.core.linearization import build_tangent_inputs
    from vsmartmom_tpu_torch.ops import fused_lin
    dev = torch.device("cuda")
    default = fused_lin.KERNEL_CLUSTER
    models = {"aerosol": lambda: flagship_model(n_spec=n_spec, aerosol=True),
              "thermal": lambda: thermal_lin_model(n_spec)}
    for scene in scenes:
        model = models[scene]()
        inputs, config, tans = build_tangent_inputs(
            model, 0, default_layout(model), device=dev)
        args = fused_lin.multitangent_args(inputs, tans, config, 0, dev)
        K = config.n_sources
        for name, lib in libs.items():
            with variant(lib, cluster_of(name, default)):
                ms = cuda_time_ms(lambda: fused_lin._launch_kernel(*args),
                                  reps=3)
                info = fused_lin.mt_launch_info(config.N, K, len(tans))
            waves = -(-n_spec * info["groups"] // info["max_clusters"])
            print(json.dumps({"scene": scene, "variant": name,
                              "n_spec": n_spec, "K": K, "P": len(tans),
                              "kernel_ms": ms, "plan": info, "waves": waves,
                              "ms_per_wave": ms / waves}), flush=True)


def time_tile(libs, n_spec):
    """One JSON line a variant: K1 at the flagship's moment 0 and K5 at
    moments 0 and m_max, each kernel's ms and largest relative difference
    from its plain version."""
    from vsmartmom_tpu_torch import flagship_model
    from vsmartmom_tpu_torch.core import multisensor
    from vsmartmom_tpu_torch.core.kernels import identity_composite
    from vsmartmom_tpu_torch.core.solver import band_moment_args, layer_batch
    from vsmartmom_tpu_torch.core.types import SolverInputs
    from vsmartmom_tpu_torch.ops import fused_band, fused_rt
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    inputs, config = flagship_model(n_spec=n_spec, nstreams=8).build_band(
        0, device=dev)
    args, kw = band_moment_args(inputs, config, 0, dev)
    sched = fused_rt.norm_sched(config.ns_sched or None, config.ndoubl)
    inp = SolverInputs(*(x.to(torch.float32) for x in inputs))
    k5_ops = {}
    for m in (0, config.m_max):
        layer_data, kw5 = multisensor.layer_batch_args(inp, config, m)
        dvec = kw5.pop("d_vec")
        d = dvec[:, None]
        r, t, jp, jm, ek = layer_batch(layer_data, **kw5)
        k5_ops[m] = (r * d, t, jp, jm * d, ek)
    k1_ref = fused_band.moment_reference(*args, **kw)
    k5_ref = {m: fused_rt.doubling_reference(*o, config.ndoubl, sched)
              for m, o in k5_ops.items()}
    # K4: layer nz // 2 of moment 0 onto the plain composite of the layers
    # above it.
    nz, d = config.nz, dvec
    lay = [x.reshape(nz, n_spec, *x.shape[1:]) for x in k5_ops[0]]
    comp = identity_composite(n_spec, config.N, torch.float32, dev,
                              config.n_sources)
    for z in range(nz // 2):
        comp = fused_rt.layer_step_reference(
            comp, *(x[z] for x in lay), d, config.ndoubl, sched,
            config.ns_inter)
    k4_ops = (comp, *(x[nz // 2] for x in lay), d)
    k4_ref = fused_rt.layer_step_reference(*k4_ops, config.ndoubl, sched,
                                           config.ns_inter)
    first = {}
    for name, lib in libs.items():
        with variant(lib):
            out = fused_band.fused_moment(*args, **kw)
            torch.cuda.synchronize()
            first.setdefault("k1", out)
            row = {"variant": name, "n_spec": n_spec, "k1_ms": cuda_time_ms(
                lambda: fused_band.fused_moment(*args, **kw), reps=3),
                "k1_err": max(rel(a, b) for a, b in zip(out, k1_ref)),
                "k1_same_as_first": all(torch.equal(a, b) for a, b in
                                        zip(out, first["k1"]))}
            for m, o in k5_ops.items():
                out = fused_rt._launch_doubling(*o, sched)
                torch.cuda.synchronize()
                row[f"k5_m{m}_ms"] = cuda_time_ms(
                    lambda: fused_rt._launch_doubling(*o, sched), reps=3)
                row[f"k5_m{m}_err"] = max(rel(a, b)
                                          for a, b in zip(out, k5_ref[m]))
            out = fused_rt._launch_layer_step(*k4_ops, sched,
                                              config.ns_inter)
            torch.cuda.synchronize()
            row["k4_ms"] = cuda_time_ms(lambda: fused_rt._launch_layer_step(
                *k4_ops, sched, config.ns_inter), reps=3)
            row["k4_err"] = max(rel(a, b) for a, b in zip(out, k4_ref))
        print(json.dumps(row), flush=True)


def pool_of(name):
    """The pool cap of an ``rrs`` variant (``p<n>``), else None."""
    for part in name.split("+"):
        if re.fullmatch(r"p\d+", part):
            return int(part[1:])
    return None


def time_rrs(libs, n_spec):
    """One JSON line a variant: K3 at moment 0 of the RRS+SIF scene (nSpec
    points, 58 shifts at 256), both launches and each alone, and the
    largest relative difference from the dense plain version."""
    from vsmartmom_tpu_torch import rrs_sif_model
    from vsmartmom_tpu_torch.core.inelastic import (inelastic_setup,
                                                    rrs_moment_args)
    from vsmartmom_tpu_torch.ops import fused_rrs
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    inputs, config, *rrs = inelastic_setup(rrs_sif_model(n_spec), device=dev)
    args, kw = rrs_moment_args(inputs, config, *rrs, 0, dev)
    ops = fused_rrs.rrs_operands(*args, **{
        k: v for k, v in kw.items() if k not in ("ns_sched", "ns_inter")})
    sched = fused_rrs.norm_sched(kw["ns_sched"], kw["ndoubl"])
    ref = fused_rrs.moment_rrs_body_reference(ops, sched, kw["ns_inter"])
    shape = fused_rrs.pair_shape
    for name, lib in libs.items():
        cap = pool_of(name) or 32
        fused_rrs.pair_shape = lambda *a: (shape(*a)[0],
                                           min(cap, shape(*a)[1]))
        plan, pairs, threads = fused_rrs.kernel_plan(ops, args[11], sched,
                                                     kw["ns_inter"])
        with variant(lib):
            out = fused_rrs._launch_kernel(ops, args[11], sched,
                                           kw["ns_inter"])
            torch.cuda.synchronize()
            store = fused_rrs._launch_diagonal(ops, plan)
            row = {"variant": name, "n_spec": n_spec, "N": config.N,
                   "pairs_on_grid": int(pairs.shape[0]),
                   "k3_ms": cuda_time_ms(lambda: fused_rrs._launch_kernel(
                       ops, args[11], sched, kw["ns_inter"]), reps=3),
                   "diag_ms": cuda_time_ms(
                       lambda: fused_rrs._launch_diagonal(ops, plan),
                       reps=3),
                   "pair_ms": cuda_time_ms(lambda: fused_rrs._launch_pairs(
                       ops, plan, pairs, threads, store), reps=3),
                   "err": max(rel(a, b) for a, b in zip(out, ref)),
                   "threads": threads, "pool": plan.pool,
                   "prefetched": plan.n_prefetched, "phases": plan.n_phases}
        fused_rrs.pair_shape = shape
        print(json.dumps(row), flush=True)


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in SOURCES:
        sys.exit(f"usage: python3 -m tools.variants {{{'|'.join(SOURCES)}}} "
                 "[n_spec] [variants] [scenes]")
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    from vsmartmom_tpu_torch.ops import cuda_build
    group = sys.argv[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    n_spec = int(sys.argv[2]) if len(sys.argv) > 2 else (
        256 if group == "rrs" else 1024)
    names = ["built"] + (sys.argv[3] if len(sys.argv) > 3
                         else DEFAULTS[group]).split(",")
    out_dir = cuda_build.BUILD_DIR / "variants" / group
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {}
    for name in names:
        src_dir = (Path(name.split("=", 1)[1]) / "vsmartmom_tpu_torch"
                   / "csrc" if name.startswith("parent=")
                   else cuda_build.SRC_DIR)
        builds[name] = build_variant(
            group, name, variant_files(group, name, src_dir), out_dir)
    libs = {}
    for name, procs in builds.items():
        loaded = load_variant(name, procs)
        if loaded is not None:
            libs[name] = loaded
    if group == "mt":
        time_mt(libs, n_spec, (sys.argv[4] if len(sys.argv) > 4
                               else "aerosol,thermal").split(","))
    elif group == "rrs":
        time_rrs(libs, n_spec)
    else:
        time_tile(libs, n_spec)


if __name__ == "__main__":
    main()
