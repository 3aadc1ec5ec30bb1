"""Where the multitangent kernel K2's time goes, and which cluster size
it should be built with: one launch of moment 0 of a Jacobian scene, timed
for the kernel as built and for variants compiled from patched copies of
``vsmartmom_tpu_torch/csrc/fused_lin.cu``:

* ``c<n>``: clusters of at most n blocks (``VSM_CLUSTER``; the host plan
  follows), a kernel that computes the same outputs;
* ``local``: primal results stored into this block's copy only (no
  distributed-shared-memory stores), for timing only;
* ``nomac``: no product loop (everything else of the kernel), for timing
  only;
* ``empty``: phases that run no job at all (the barriers, the elementwise
  passes and the calls remain), for timing only.

Run on a machine with an NVIDIA GPU, from the repo root:
``python3 -m tools.mt_variants [n_spec] [variants] [scenes]`` (variants
and scenes comma-separated; defaults 1024, ``c2,c4,c8,local,nomac,empty``
and ``aerosol,thermal``). A patch that no longer matches the source stops
the run. Prints the card and one JSON line a (scene, variant): kernel ms
(CUDA events, mean of 3 after a warm-up), the plan, the clusters resident
at once, waves and ms per wave."""

import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import cuda_time_ms

ROOT = Path(__file__).resolve().parents[1]

PATCHES = {
    "local": [("  if (!shared) return;\n  for (int r = 0;",
               "  return;\n  for (int r = 0;")],
    "nomac": [("    mac(A, B, i0, j0, min(j0 + x.h, x.LD - 4), k0, k1, x.n, "
               "x.LD, acc);", "")],
    "empty": [("for (int w = threadIdx.x >> 5; w < mw + vw;",
               "for (int w = threadIdx.x >> 5; w < 0;")],
}


def patches(name, default):
    """(source patches, cluster limit) of a variant."""
    if name[0] == "c" and name[1:].isdigit():
        return [(f"#define VSM_CLUSTER {default}",
                 f"#define VSM_CLUSTER {name[1:]}")], int(name[1:])
    return PATCHES[name], default


def build_variant(name, edits, out_dir):
    """A patched copy of fused_lin.cu compiled with the port's nvcc flags."""
    from vsmartmom_tpu_torch.ops import cuda_build
    src = (cuda_build.SRC_DIR / "fused_lin.cu").read_text()
    for a, b in edits:
        if a not in src:
            sys.exit(f"variant {name}: its patch no longer matches "
                     f"fused_lin.cu: {a!r}")
        src = src.replace(a, b)
    cu = out_dir / f"fused_lin_{name}.cu"
    cu.write_text(src)
    so = out_dir / f"libfused_lin_{name}.so"
    return subprocess.Popen([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                             "-I", str(cuda_build.SRC_DIR), "-o", str(so),
                             str(cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


@contextlib.contextmanager
def variant(lib, limit):
    """fused_lin launches `lib` with a host plan of cluster limit `limit`
    inside the block."""
    from vsmartmom_tpu_torch.ops import cuda_build, fused_lin
    old = cuda_build._LIBS.get("fused_lin"), fused_lin.KERNEL_CLUSTER
    cuda_build._LIBS["fused_lin"], fused_lin.KERNEL_CLUSTER = lib, limit
    try:
        yield
    finally:
        cuda_build._LIBS["fused_lin"], fused_lin.KERNEL_CLUSTER = old


def main():
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    from vsmartmom_tpu_torch import (default_layout, flagship_model,
                                     thermal_lin_model)
    from vsmartmom_tpu_torch.core.linearization import build_tangent_inputs
    from vsmartmom_tpu_torch.ops import cuda_build, fused_lin
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    n_spec = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    names = (sys.argv[2] if len(sys.argv) > 2
             else "c2,c4,c8,local,nomac,empty").split(",")
    scenes = (sys.argv[3] if len(sys.argv) > 3
              else "aerosol,thermal").split(",")
    out_dir = ROOT / "chiprun_out" / "mt_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    default = fused_lin.KERNEL_CLUSTER
    cuda_build.load("fused_lin")
    builds = {}
    for name in names:
        edits, limit = patches(name, default)
        builds[name] = (*build_variant(name, edits, out_dir), limit)
    libs = {}
    for name, (proc, so, limit) in builds.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            sys.exit(f"variant {name} did not build:\n{log}")
        libs[name] = (ctypes.CDLL(str(so)), limit)
    dev = torch.device("cuda")
    models = {"aerosol": lambda: flagship_model(n_spec=n_spec, aerosol=True),
              "thermal": lambda: thermal_lin_model(n_spec)}
    for scene in scenes:
        model = models[scene]()
        inputs, config, tans = build_tangent_inputs(
            model, 0, default_layout(model), device=dev)
        args = fused_lin.multitangent_args(inputs, tans, config, 0, dev)
        K = config.n_sources
        for name, (lib, limit) in libs.items():
            with variant(lib, limit):
                ms = cuda_time_ms(lambda: fused_lin._launch_kernel(*args),
                                  reps=3)
                info = fused_lin.mt_launch_info(config.N, K, len(tans))
            waves = -(-n_spec * info["groups"] // info["max_clusters"])
            print(json.dumps({"scene": scene, "variant": name,
                              "n_spec": n_spec, "K": K, "P": len(tans),
                              "kernel_ms": ms, "plan": info, "waves": waves,
                              "ms_per_wave": ms / waves}), flush=True)


if __name__ == "__main__":
    main()
