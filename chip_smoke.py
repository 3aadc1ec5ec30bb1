"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each of
which fails the run (non-zero exit) on a miss:

1. setup — the card's name and power limit; every CUDA kernel of the port
   built from ``vsmartmom_tpu_torch/csrc`` (one nvcc per source, in parallel);
2. kernel vs plain — each kernel's wrapper against its plain PyTorch version
   on the card at the main path's shapes (flagship: N = 52, nz = 33,
   ndoubl = 8, the probed Newton-Schulz schedule, nSpec = 1024, moments
   m = 0..2) and a small K = 2 (thermal source) case; gate
   max|d| / max|ref| <= 1e-4 on every output;
3. main path — ``rt_run`` of the flagship scene (nSpec = 4096, f32, solved in
   4 chunks of 1024) with every launch counter set to 0 just before and read
   just after; R and T finite; the kernel path against the port's plain path
   on the first chunk (<= 1e-4 of max|R|); launches = chunks x (m_scat + 1);
   the flagship at nSpec = 16 against the stored JAX CPU f64 reference
   (``vsmartmom_tpu_torch/data/flagship_ref_f64.npz``, <= 1e-4 of max|R|);
4. timing — the flagship forward's points/s (best of 3 after warm-up, synced
   with ``torch.cuda.synchronize``), and per kernel launch its time, its plain
   version's time and its bound: max(FLOPs / FP32 peak, bytes / HBM rate).

The last line is ``{"ok": true, "device": {...}}``; the line before it lists
each kernel. Without CUDA it exits non-zero and prints no result.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: H100 SXM peaks (NVIDIA data sheet, dense): FP32 outside the tensor cores,
#: and HBM3 bandwidth. The bound of a kernel is stated against these.
FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
GATE = 1e-4
N_CHUNK, N_CHUNKS = 1024, 4
N_SPEC_TOTAL = N_CHUNK * N_CHUNKS


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def rel(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def cuda_time_ms(fn, reps=5):
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def moment_flops(config, n_spec):
    """FP32 operations of one fused_moment launch: the band kernel's matrix
    products for this run's Newton-Schulz schedule (the bench.py count at
    one spectral point per operator), 2 N^2 per product column."""
    N, K = config.N, config.n_sources
    cols = 0
    for k in config.ns_sched or (6,) * config.ndoubl:
        cols += (2 * k + 5) * N + 4 * K          # NS, r r, t gp, X, Y
    k = config.ns_inter
    cols += (2 * k + 3) * N + (N + K) + 2 * (2 * N + K) + (2 * N + K) + N
    return 2.0 * N * N * cols * config.nz * n_spec


def moment_bytes(args, out):
    """Bytes one launch must move: its operands read once (the plain prep's
    compact row tables) and the composite written once."""
    from vsmartmom_tpu_torch.ops.fused_band import band_operands
    ops = band_operands(*args[0], **{k: v for k, v in args[1].items()
                                     if k not in ("ns_sched", "ns_inter")})
    return sum(x.numel() * x.element_size() for x in (*ops, *out))


def main():
    if not torch.cuda.is_available():
        fail("CUDA is not available: the chip smoke test runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False    # exact f32 products
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")

    from vsmartmom_tpu_torch import flagship_model, rt_run
    from vsmartmom_tpu_torch.core.solver import (band_moment_args, rt_solve,
                                                 spectral_slice)
    from vsmartmom_tpu_torch.ops import cuda_build, fused_band

    # ---- 1. setup: build every kernel (one nvcc per source, together) ----
    sources = sorted(p.stem for p in cuda_build.SRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    cuda_build.build_all(sources)
    print(f"build: {sources} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, (_, log) in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- 2. kernel vs plain at the main path's shapes ----
    model = flagship_model(n_spec=N_SPEC_TOTAL, nstreams=8)
    inputs, config = model.build_band(0, device=dev)
    if not config.fused:
        fail("the flagship f32 model on CUDA did not pick the band kernel")
    print(f"config: N={config.N} nz={config.nz} ndoubl={config.ndoubl} "
          f"ns_sched={config.ns_sched} ns_inter={config.ns_inter} "
          f"m_scat={config.m_scat} m_max={config.m_max}", flush=True)
    chunk0 = spectral_slice(inputs, config, 0, N_CHUNK)
    names = ("R_mp", "R_pm", "T_pp", "T_mm", "J0_p", "J0_m")
    max_abs_err = 0.0
    moment_args = []
    for m in range(config.m_scat + 1):
        args = band_moment_args(*chunk0, m, dev)
        moment_args.append(args)
        out = fused_band.fused_moment(*args[0], **args[1])
        torch.cuda.synchronize()
        ref = fused_band.moment_reference(*args[0], **args[1])
        errs = {n: rel(a, b) for n, a, b in zip(names, out, ref)}
        max_abs_err = max([max_abs_err] + [float((a - b).abs().max())
                                           for a, b in zip(out, ref)])
        print(f"kernel vs plain m={m}: " + " ".join(
            f"{n}={e:.2e}" for n, e in errs.items()), flush=True)
        if not all(np.isfinite(e) and e <= GATE for e in errs.values()):
            fail(f"fused_moment vs moment_reference at m={m}: {errs}")
    m2 = flagship_model(n_spec=64, nstreams=8)
    m2.bands[0].thermal_b = np.random.default_rng(0).uniform(
        0.1, 1.0, (m2.profile.nz, 64))
    inp2, cfg2 = m2.build_band(0, device=dev)
    for m in range(cfg2.m_scat + 1):
        args = band_moment_args(inp2, cfg2, m, dev)
        out = fused_band.fused_moment(*args[0], **args[1])
        torch.cuda.synchronize()
        ref = fused_band.moment_reference(*args[0], **args[1])
        errs = {n: rel(a, b) for n, a, b in zip(names, out, ref)}
        print(f"kernel vs plain K=2 m={m}: " + " ".join(
            f"{n}={e:.2e}" for n, e in errs.items()), flush=True)
        if not all(np.isfinite(e) and e <= GATE for e in errs.values()):
            fail(f"K=2 fused_moment vs moment_reference at m={m}: {errs}")

    # ---- 3. the main path, counted ----
    fused_band.fused_moment.launches = 0
    R, T = rt_run(model, device=dev, spectral_chunk=N_CHUNK)
    torch.cuda.synchronize()
    launches = fused_band.fused_moment.launches
    want = N_CHUNKS * (config.m_scat + 1)
    print(f"main path: rt_run nSpec={N_SPEC_TOTAL} in {N_CHUNKS} chunks, "
          f"fused_moment launches={launches} (want {want})", flush=True)
    if launches != want:
        fail(f"fused_moment launched {launches} times, want {want}")
    if R.shape != (9, 4, N_SPEC_TOTAL) or not (np.isfinite(R).all()
                                               and np.isfinite(T).all()):
        fail(f"R/T not finite or of the wrong shape {R.shape}")
    cfg_plain = dataclasses.replace(chunk0[1], fused=False, m_scat=-1,
                                    ns_sched=(), ns_inter=6)
    plain = rt_solve(chunk0[0], cfg_plain, dev)
    kern = rt_solve(*chunk0, dev)
    e_plain = {k: rel(kern[k], plain[k]) for k in ("R", "T")}
    print(f"kernel path vs plain path (chunk 0): R={e_plain['R']:.2e} "
          f"T={e_plain['T']:.2e}", flush=True)
    if not all(e <= GATE for e in e_plain.values()):
        fail(f"kernel path vs plain path: {e_plain}")
    ref = np.load(Path(__file__).resolve().parent / "vsmartmom_tpu_torch"
                  / "data" / "flagship_ref_f64.npz")
    R16, T16 = rt_run(flagship_model(n_spec=ref["R"].shape[-1], nstreams=8),
                      device=dev)
    e_ref = {"R": rel(R16, ref["R"]), "T": rel(T16, ref["T"])}
    print(f"kernel path vs JAX f64 reference (nSpec={ref['R'].shape[-1]}): "
          f"R={e_ref['R']:.2e} T={e_ref['T']:.2e}", flush=True)
    if not all(e <= GATE for e in e_ref.values()):
        fail(f"port vs stored JAX reference: {e_ref}")

    # ---- 4. timing ----
    chunks = [spectral_slice(inputs, config, a, a + N_CHUNK)
              for a in range(0, N_SPEC_TOTAL, N_CHUNK)]
    times = []
    for rep in range(4):                           # 1 warm-up + best of 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [rt_solve(i, c, dev)["R"] for i, c in chunks]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            fail("non-finite R in the timed solve")
    pts_per_s = N_SPEC_TOTAL / min(times[1:])
    t0 = time.perf_counter()
    rt_run(model, device=dev, spectral_chunk=N_CHUNK)
    e2e_s = time.perf_counter() - t0

    args = moment_args[0]
    k_ms = cuda_time_ms(lambda: fused_band.fused_moment(*args[0], **args[1]))
    p_ms = cuda_time_ms(
        lambda: fused_band.moment_reference(*args[0], **args[1]), reps=3)
    out = fused_band.fused_moment(*args[0], **args[1])
    flops = moment_flops(config, N_CHUNK)
    nbytes = moment_bytes(args, out)
    t_ops, t_bytes = flops / FP32_PEAK_FLOPS * 1e3, \
        nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(json.dumps({
        "card": smi, "pts_per_s": pts_per_s, "solve_s": min(times[1:]),
        "rt_run_e2e_s": e2e_s, "n_spec": N_SPEC_TOTAL,
        "moment_launch": {"n_spec": N_CHUNK, "kernel_ms": k_ms,
                          "plain_ms": p_ms, "bound_ms": bound_ms,
                          "flops": flops, "bytes": nbytes,
                          "achieved_tflops": flops / k_ms / 1e9}}),
        flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_moment", "route": "cuda",
        "source": "vsmartmom_tpu_torch/csrc/fused_band.cu",
        "replaces": "vsmartmom_tpu/ops/fused_band.py:469",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
