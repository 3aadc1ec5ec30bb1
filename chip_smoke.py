"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Seven paths
are driven: the flagship forward ``rt_run`` (band kernel K1), the
rotational-Raman forward ``rt_run_inelastic`` (K1 for the elastic half, the
block-bichromatic RRS kernel K3 for the inelastic one), the aerosol
Jacobian run ``rt_run_lin`` (the multitangent kernel K2), the thermal
(K = 2, solar + Planck) Jacobian run ``rt_run_lin`` (K1', the same kernel
at two source columns), the multisensor
forward ``rt_run_ms`` (the per-layer doubling kernel K5, one launch per
moment for all layers), the flagship chain of per-layer steps of
``scripts/probe_fused2.py`` (the layer-step kernel K4) and the nine Pallas
probes P1-P9 of ``scripts/`` through their Hopper counterparts
(``vsmartmom_tpu_torch/probes``: the dot_chain, lane_dot_chain, layout and
band-stage kernels). Phases, each of which fails the run (non-zero exit) on
a miss:

1. setup — the card's name and power limit; every CUDA kernel of the port
   built from ``vsmartmom_tpu_torch/csrc`` (one nvcc per source, in parallel);
2. kernel vs plain — each kernel's wrapper against its plain PyTorch version
   on the card at its main path's shapes, gate max|d| / max|ref| <= 1e-4 on
   every output: K1 at the flagship's (N = 52, nz = 33, ndoubl = 8, the
   probed Newton-Schulz schedule, nSpec = 1024, moments m = 0..2) and a
   small K = 2 (thermal source) case; K3 (its diagonal and pair launches)
   at the RRS+SIF scene's (N = 36, nz = 8, 58 Raman shifts x nSpec 256 =
   14,848 pairs, the coarse ie ladder, m = 0..2) and a small I-only case
   (N = 6) whose shifts run off the band edge for most pairs, which must
   come out exactly zero, against the dense plain version and the split
   one (``moment_rrs_split_reference``, the launches' own algebra), and
   within ``F64_RATIO`` of the f32 plain version's distance from the plain
   version in f64; its launch shapes (threads, shared memory, pool,
   resident blocks an SM of each launch); K2 at
   the aerosol flagship's (N = 52, nz = 33, C = 2, ndoubl = 11, the probed
   schedule, all P = 8 tangents, a 64-point slice, m = 0, 1, 15): primal
   <= 1e-4 of max|ref| per output, each parameter's tangent outputs
   <= 2e-4 of that parameter's max|ref| over the three moments; the
   kernel's and the f32 plain version's primal against the plain version
   in f64 on the same operands are printed beside it (no gate for K2;
   K1's composite from f64 must be within ``F64_RATIO`` = 2x of the f32
   plain version's, at every flagship moment and the K = 2 case); K1's
   launch shape as the C side reports it (threads, dynamic shared memory,
   blocks an SM by shared memory);
3. main paths, each with every launch counter set to 0 just before and read
   just after:
   * ``rt_run`` of the flagship (nSpec = 4096, f32, 4 chunks of 1024): R and
     T finite; the kernel path against the port's plain path on the first
     chunk (<= 1e-4 of max|R|); launches = chunks x (m_scat + 1); the
     flagship at nSpec = 16 against the stored JAX CPU f64 reference
     (``vsmartmom_tpu_torch/data/flagship_ref_f64.npz``, <= 1e-4);
   * ``rt_run_inelastic`` of the RRS+SIF scene (nSpec = 256): K1 and K3
     (a call, and its diagonal launch) once per moment; R, T, ieR, ieT
     finite; the kernel path
     against the port's plain ``rt_solve_rrs``, R <= 1e-4 and ieR <= 5e-3
     of max (the JAX bench's gate: the coarse ie ladder is by design), the
     total R + ieR <= 1e-4 of max|R|, and with ``ie_fullres=True``
     ieR <= 1e-4; a small RRS scene against the
     stored JAX CPU f64 reference (``data/rrs_ref_f64.npz``), R and ieR
     <= 1e-4 with ``ie_fullres=True``;
   * ``rt_run_lin`` of the aerosol flagship (nSpec = 1024, f32, 7 aerosol
     parameters + wind): K2 launched m_scat + 1 = 16 times (one per moment
     for all 8 tangents), K1 and K3 not at all; R, T, dR, dT finite, dR
     (9, 4, 1024, 8); on a 64-point slice the K2 route against the plain
     jvp route, R <= 1e-4 and each parameter's dR <= 2e-4 of its max;
     ``rt_run`` of the same scene (16 K1 launches) equal to rt_run_lin's R
     within 1e-4; the small aerosol scene against the stored JAX CPU f64
     reference (``data/lin_ref_f64.npz``), R <= 1e-4 and each parameter's
     dR <= 2e-4 of its own max, the aerosol height's (p0, sigma_p)
     <= ``HEIGHT_GATE`` = 5e-3, with a control: those two Jacobians
     scaled by 1.01 must exceed it;
4. timing — the flagship's and the RRS+SIF solve's points/s (best of 3
   after a warm-up, synced with ``torch.cuda.synchronize``), and per kernel
   launch its time, its plain version's time and its bound:
   max(FLOPs / FP32 peak, bytes / HBM rate), K3's at the least work that
   gives its outputs (``rrs_flops``: off-grid pairs need none), for the
   call and for each of its two launches, with the former one-launch
   kernel's block count and the
   dense one printed beside it, the store's bytes and the diagonal
   launch's store against its plain version (``diagonal_store``); the
   Jacobian solve's points/s and tangent
   points/s (best of 2 after a warm-up, tangents prebuilt), the host
   seconds of the scene and tangent builds, and K2's time against its bound
   at the least work (the primal once, two products per tangent product),
   with the kernel's own count beside it: groups + 2P primal moments a
   point, the primal once per cluster of up to 4 tangents (P = 8: two
   groups of 4, 18 against the least 17); K2's launch plan (cluster size,
   groups, shared memory, resident clusters from
   ``cudaOccupancyMaxActiveClusters``, ptxas registers and spills of each
   K instance, which must agree with ``fused_lin.mt_plan``) and the cluster
   barriers a block passes per launch;

5. multisensor (``ms_phase``) — K5 against ``doubling_reference`` on the
   flagship's stash of one moment (33 layers x nSpec 1024 points): moment 0
   (every layer scatters: the dense ladder) <= 1e-4 per output and within
   2x of the f32 plain version's distance from the plain version in f64;
   moment 15 (Z = 0 above m_scat: the O(N) path) bit for bit with r
   exactly zero; ``rt_run_ms`` of the flagship (nSpec 1024, levels 0, 16, 33)
   and of the MS bench scene (``rrs_sif_model`` at nSpec 256, levels 0, 4,
   8; scripts/bench_ms.py), each counted: K5 launched m_max + 1 times and
   no other kernel, each launch's blocks that vote for the O(N) path
   counted on its operands and its device time read (a launch whose every
   block does must run in under a quarter of the fastest dense one); per
   level the kernel route against the plain (LU) route
   <= 1e-4 of max, and level 0 against the band path's rt_solve R and T
   <= 1e-4; ``ms_pts_per_s`` (best of 3 after a warm-up, synchronised), a
   device-time split of one more solve (CUDA events around the stash, K5,
   the interactions and the interface solves), and K5's time per launch
   against its plain version and its bound at moment 0 (operations) and at
   moment 15 (bytes: the O(N) path), each on its own line and in K5's
   kernels entry (``z0``) with the launches of its path in the counted
   run, and K5's resident blocks per SM from the C side;
6. layer chain (``layer_chain_phase``) — the flagship's elemental operators
   of moments 0..m_scat at nSpec 1024 chained through K4 over all 33
   layers from the vacuum composite, counted (3 x 33 launches), against the
   plain chain <= 1e-4 per output and against K1's composite of the same
   moment <= 1e-4 of max per output; the chain's time beside K1's for the
   same moments, and K4's time per launch against its plain version and
   its bound, and its resident blocks an SM. K4 runs K5's ladder and K1's
   adding on ``csrc/fp32_tile.cuh``: its chain's matrices must equal the
   plain chain's bit for bit, its sources (four partial sums a row) be
   within ``F64_RATIO`` of the f32 plain chain's distance from the plain
   chain in f64;
7. probes (``probes_phase``) — each probe module's ``run()`` at its
   script's own shapes with every launch counter set to 0 just before and
   read just after (it must equal the wrapper calls the cases report: one
   warm-up, ``probes.common.REPS`` timed calls per try and the checks),
   one JSON line per call site with each case's device time (the timed
   calls queued behind a sleeping kernel, ``probes.common.time_ms``),
   bound, plain and library times, its error against the plain version and
   against the f64 product; one line per dot and lane case with its launch
   plan (grid, threads, dynamic shared memory, resident blocks per SM from
   ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, slabs or points in
   flight per SM) and its kernel's ptxas registers and spills; one line per
   band-stage case with each of its launches (grid, threads, shared bytes,
   its entry's registers and spills) and its scratch. Gates: every
   kernel time the device's work alone; each host plan the launch the C
   side makes of it; dot and lane chains against their plain versions <= 1e-5 of
   max|plain| at lengths 1, 8 and the whole chain (a TF32 chain at length
   1 only: its drift is recorded), each chain's last step <= 1e-5 and
   equal bit for bit to the kernel's own chain; the layout cases exact;
   the band stages NaN where the plain version is NaN and <= 1e-5 of
   max|plain| where it is finite, the full stage finite throughout at one
   layer and on the thin inputs over four (the chain of adding steps), and
   one chain launch after each full call;
8. thermal Jacobian (``thermal_lin_phase``) on ``thermal_lin_model`` (the
   aerosol flagship at 2500 cm^-1 with each layer's Planck source; N = 52,
   nz = 33, C = 2, K = 2, P = 8) — K1' against its plain version on a
   64-point slice at m = 0, 1 and m_max (primal <= 1e-4, each parameter's
   tangents <= 2e-4 of its max; the thermal column of J0_p and J0_m
   non-zero at m = 0 and exactly zero, tangents too, above it; the primal
   against the f64 plain version printed, as for K2); the K = 2
   shared memory inside the 232,448 B opt-in; ``rt_run_lin`` at nSpec 1024
   counted (K2 launched m_scat + 1 times at K = 2, no other kernel), R, T,
   dR, dT finite, dR (9, 4, 1024, 8); on the slice the kernel route
   against the jvp route (R <= 1e-4, each dR <= 2e-4 of its max) and the
   additivity of the sources (dR and R of solar + thermal against the sum
   of the solar-only and the thermal-only runs, ``include_solar=False``,
   2e-4 and 1e-4); ``rt_run`` of the scene (K1 at K = 2) against R
   (1e-4); the small thermal scene against the stored JAX CPU f64
   reference (``data/lin_thermal_ref_f64.npz``, the K = 1 phase's gates
   with its 1.01 control); timing: a warm-up on the slice, then one timed
   solve at nSpec 1024 (one, not the best of 2), K1''s time per launch,
   its plain version's and its bound at the least work (the K2 count with
   the second source column), its plan and barrier count as K2's.

The last line is ``{"ok": true, "device": {...}}``; the line before it lists
each kernel. Without CUDA it exits non-zero and prints no result.
"""

import ctypes
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
#: A kernel's distance from the plain version run in f64 on the same
#: operands may be at most this many times the f32 plain version's (K1 and
#: K5's dense ladder sum their products in another order than the plain
#: version's matmuls).
F64_RATIO = 2.0
IE_GATE = 5e-3
TAN_GATE = 2e-4
#: The aerosol-height parameters of the small Jacobian scene: their f32 dR
#: is ~1e-6 of the others' and lands within ~1.3e-3 of its own scale of
#: the f64 reference on every route; HEIGHT_GATE still fails a 1% error.
HEIGHT_PARAMS = ("_p0", "_sigma_p")
HEIGHT_GATE = 5e-3
N_CHUNK, N_CHUNKS = 1024, 4
N_SPEC_TOTAL = N_CHUNK * N_CHUNKS
RRS_N_SPEC = 256
LIN_N_SPEC, LIN_SLICE = 1024, 64
#: The thermal Jacobian scene's width and its checked slice.
THERMAL_N_SPEC, THERMAL_SLICE = 1024, 64
#: Shared memory one block may opt in to on an H100 (bytes).
SMEM_OPT_IN = 232448
#: Multisensor scenes: the flagship at nSpec 1024 with an airborne sensor
#: mid-column, and the JAX package's MS bench scene (scripts/bench_ms.py).
MS_N_SPEC, MS_LEVELS = 1024, (0, 16, 33)
MS_RRS_N_SPEC, MS_RRS_LEVELS = 256, (0, 4, 8)


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


def rrs_flops(ops, n_points, n_pairs, ns_sched, ns_inter, count="least"):
    """FP32 operations (an FMA is two) of one fused_moment_rrs call over
    P = nR x n_points (shift, point) pairs, n_pairs of them on the grid:
    the matrix and vector products of the ladder and the adding (the
    moment_flops count) on the (2N, 2N) block-lower-triangular pair
    operators, counted four ways:

    * "least", the bound's and the kernels': the least work giving the
      same outputs. Only the (2,1) block is a pair's own, 2 N^3 FMAs per
      product and 2 N^2 per product column, and an off-grid pair's is
      exactly zero (no work). The diagonal blocks are elastic ladders and
      composites of one grid point (l1 = i, l0 = i + shift), needed once
      per point: N^3 and N^2 per point;
    * "pairs" and "points": its two parts, the pair launch's and the
      diagonal launch's;
    * "block", the former one-launch kernel's: every pair's three blocks,
      4 N^3 and 3 N^2;
    * "dense": 8 N^3 and 4 N^2 per pair."""
    nz, P, Np = ops.Em1.shape
    N = Np // 2
    mat, vec = {
        "least": (2 * N ** 3 * n_pairs + N ** 3 * n_points,
                  2 * N ** 2 * n_pairs + N ** 2 * n_points),
        "pairs": (2 * N ** 3 * n_pairs, 2 * N ** 2 * n_pairs),
        "points": (N ** 3 * n_points, N ** 2 * n_points),
        "block": (4 * N ** 3 * P, 3 * N ** 2 * P),
        "dense": (Np ** 3 * P, Np ** 2 * P)}[count]
    n_mat = sum(2 * k + 5 for k in ns_sched) + 2 * ns_inter + 11
    n_vec = 4 * len(ns_sched) + 4
    return 2.0 * (n_mat * mat + n_vec * vec) * nz


def mt_errors(outs, refs):
    """K2 against its plain version over several moments: (the primal's
    max|d| / max|ref| over outputs, [per parameter: max|d| over every
    tangent output and moment / that parameter's max|ref| over the same],
    max|d| of all)."""
    e_prim = max(rel(a, b) for (p, _), (r, _) in zip(outs, refs)
                 for a, b in zip(p, r))
    e_tan = []
    for q in range(refs[0][1][0].shape[0]):
        d = max(float((a[q] - b[q]).abs().max())
                for (_, t), (_, r) in zip(outs, refs) for a, b in zip(t, r))
        scale = max(float(b[q].abs().max()) for _, r in refs for b in r)
        e_tan.append(d / scale if scale > 0 else d)
    e_abs = max(float((a - b).abs().max()) for o, r in zip(outs, refs)
                for a, b in zip((*o[0], *o[1]), (*r[0], *r[1])))
    return e_prim, e_tan, e_abs


def f64_errors(ops, sched, inter, kernel, plain):
    """One moment's composite against the plain version run in f64 on the
    same operands (``BandOperands``): (the kernel's max|d| / max|ref| over
    outputs, the f32 plain version's), to tell rounding from a less
    accurate route."""
    from vsmartmom_tpu_torch.ops import fused_band
    ref = fused_band.moment_body_reference(
        ops._replace(**{f: getattr(ops, f).double() for f in ops._fields}),
        sched, inter)
    return (max(rel(a.double(), b) for a, b in zip(kernel, ref)),
            max(rel(a.double(), b) for a, b in zip(plain, ref)))


def primal_f64_errors(args, kernel, plain):
    """``f64_errors`` of K2's primal (``multitangent_args``)."""
    ops, _, sched, inter = args
    return f64_errors(ops, sched, inter, kernel, plain)


def band_f64_errors(args, kw, kernel, plain):
    """``f64_errors`` of one K1 launch (``band_moment_args``)."""
    from vsmartmom_tpu_torch.ops import fused_band
    ops = fused_band.band_operands(*args, **{
        k: kw[k] for k in ("ndoubl", "n_stokes", "i_mu0_start",
                           "n_sources")})
    sched = fused_band.norm_sched(kw["ns_sched"] or None, kw["ndoubl"])
    return f64_errors(ops, sched, kw["ns_inter"], kernel, plain)


def layer_flops(N, K, ns_sched, ns_inter=None):
    """FP32 operations per point of one doubling ladder (K5) or, with
    ``ns_inter``, one whole layer step (K4): per ladder step with k NS
    iterations (2k + 5) N x N products and 4 K vector columns, per adding
    step (2 ns_inter + 11) N x N products and 4 K columns; 2 N^2 per
    product column."""
    cols = sum((2 * k + 5) * N + 4 * K for k in ns_sched)
    if ns_inter is not None:
        cols += (2 * ns_inter + 11) * N + 4 * K
    return 2.0 * N * N * cols


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


class DeviceSplit:
    """Device time of chosen functions inside one solve: each wrapped call
    is bracketed by CUDA events (nested calls count in both)."""

    def __init__(self):
        self.spans = {}

    def wrap(self, name, fn):
        def timed(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            self.spans.setdefault(name, []).append((e0, e1))
            return out
        return timed

    def ms(self):
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self.spans.items()}


class K5Paths:
    """Which ladder each K5 launch of a run took. Per launch: its points (one
    block each), how many of them the kernel's vote sends down the O(N)
    path (r all zero and t diagonal, counted on the launch's operands on
    the device) and the launch's device time (CUDA events around
    ``fused_rt._launch_doubling``)."""

    def __init__(self):
        self.spans = []

    def wrap(self, fn):
        def traced(r, t, *rest):
            nonzero = (t != 0).sum((1, 2))
            diag = (t.diagonal(dim1=1, dim2=2) != 0).sum(1)
            z0 = ((r == 0).flatten(1).all(1) & (nonzero == diag)).sum()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(r, t, *rest)
            e1.record()
            self.spans.append((r.shape[0], z0, e0, e1))
            return out
        return traced

    def summary(self):
        """Launches whose every block took the O(N) path, whose none did,
        and the rest, each with its device times (ms)."""
        torch.cuda.synchronize()
        out = {"z0": [], "dense": [], "mixed": []}
        for points, z0, e0, e1 in self.spans:
            z0 = int(z0)
            kind = ("z0" if z0 == points else "dense" if z0 == 0
                    else "mixed")
            out[kind].append(e0.elapsed_time(e1))
        return out


def best_of_3(fn):
    """Host seconds of fn() (synchronised): (best of 3 after a warm-up,
    all four)."""
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times[1:]), times


def launch_counted():
    """Every kernel wrapper of the port by name; each carries its launch
    count in ``.launches``."""
    from vsmartmom_tpu_torch.ops import band_stages, fused_band, fused_lin, \
        fused_rrs, fused_rt, probe_dots, probe_layout
    return {"fused_moment": fused_band.fused_moment,
            "fused_moment_rrs": fused_rrs.fused_moment_rrs,
            "rrs_diagonal": fused_rrs._launch_diagonal,
            "fused_moment_multitangent": fused_lin.fused_moment_multitangent,
            "fused_doubling": fused_rt.fused_doubling,
            "fused_layer_step": fused_rt.fused_layer_step,
            "dot_chain": probe_dots.dot_chain,
            "lane_dot_chain": probe_dots.lane_dot_chain,
            "layout_op": probe_layout.layout_op,
            "band_stages": band_stages.band_stages,
            "band_chain": band_stages._launch_chain}


def ms_phase(dev, smi):
    """The multisensor path: K5 against its plain version at the flagship's
    stash shape, ``rt_run_ms`` of the flagship (nSpec 1024, levels 0, 16,
    33) and of the MS bench scene (nSpec 256, levels 0, 4, 8) with every
    launch counter set to 0 just before and read just after, the kernel
    route against the plain (LU) route per level and level 0 against the
    band path's rt_solve, then timing. Returns K5's kernels-line entry."""
    from vsmartmom_tpu_torch import flagship_model, rrs_sif_model, rt_run_ms
    from vsmartmom_tpu_torch.core import multisensor, solver
    from vsmartmom_tpu_torch.core.types import SolverInputs
    from vsmartmom_tpu_torch.ops import cuda_build, fused_rt
    counted = launch_counted()

    scenes = {"flagship": (flagship_model(n_spec=MS_N_SPEC), MS_LEVELS),
              "rrs_sif": (rrs_sif_model(n_spec=MS_RRS_N_SPEC),
                          MS_RRS_LEVELS)}
    built = {k: m.build_band(0, device=dev) for k, (m, _) in scenes.items()}
    inputs, config = built["flagship"]
    if not config.fused:
        fail("the flagship f32 model on CUDA did not pick the kernel route")
    sched = fused_rt.norm_sched(config.ns_sched or None, config.ndoubl)
    inp = SolverInputs(*(x.to(torch.float32) for x in inputs))

    # K5 against its plain version at moment 0 (every layer scatters: the
    # dense ladder, <= 1e-4 and the f64 gate) and at moment m_max (Z = 0
    # above m_scat: the O(N) path, bit for bit, r exactly zero).
    k5_abs_err, k5_ops, k5_f64 = 0.0, {}, None
    for m in (0, config.m_max):
        layer_data, kw = multisensor.layer_batch_args(inp, config, m)
        d = kw.pop("d_vec")[:, None]
        r_mp, t_pp, jp, jm, expk = solver.layer_batch(layer_data, **kw)
        ops = (r_mp * d, t_pp, jp, jm * d, expk)
        out = fused_rt.fused_doubling(*ops, config.ndoubl, ns_sched=sched)
        torch.cuda.synchronize()
        ref = fused_rt.doubling_reference(*ops, config.ndoubl, sched)
        errs = {n: rel(a, b) for n, a, b in zip(("r", "t", "jp", "jm"),
                                                out, ref)}
        k5_abs_err = max([k5_abs_err] + [float((a - b).abs().max())
                                         for a, b in zip(out, ref)])
        line = f"K5 vs plain m={m} ({r_mp.shape[0]} points): " + " ".join(
            f"{n}={e:.2e}" for n, e in errs.items())
        if m <= config.m_scat:
            ref64 = fused_rt.doubling_reference(
                *(x.double() for x in ops), config.ndoubl, sched)
            k5_f64 = (max(rel(a.double(), b) for a, b in zip(out, ref64)),
                      max(rel(a.double(), b) for a, b in zip(ref, ref64)))
            line += (f"; vs f64 plain: kernel {k5_f64[0]:.2e}, f32 plain "
                     f"{k5_f64[1]:.2e}")
        else:
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            line += f"; bit for bit {same}"
        print(line, flush=True)
        if not all(np.isfinite(e) and e <= GATE for e in errs.values()):
            fail(f"fused_doubling vs doubling_reference at m={m}: {errs}")
        if m <= config.m_scat and not k5_f64[0] <= F64_RATIO * k5_f64[1]:
            fail(f"fused_doubling at m={m} is {k5_f64[0]} from f64, over "
                 f"{F64_RATIO}x the f32 plain version's {k5_f64[1]}")
        if m > config.m_scat and not (same and bool((out[0] == 0).all())):
            fail(f"K5 at m={m} (Z = 0) not bit-identical to plain, or r "
                 "not exactly zero")
        k5_ops[m] = ops
        del out, ref

    result = {}
    for name, (model, levels) in scenes.items():
        inputs, config = built[name]
        paths = K5Paths()
        launch_doubling = fused_rt._launch_doubling
        fused_rt._launch_doubling = paths.wrap(launch_doubling)
        try:
            for fn in counted.values():
                fn.launches = 0
            t0 = time.perf_counter()
            uwJ, dwJ = rt_run_ms(model, levels, device=dev)
            torch.cuda.synchronize()
            e2e_s = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counted.items()}
        finally:
            fused_rt._launch_doubling = launch_doubling
        k5_paths = paths.summary()
        want = {k: 0 for k in counted}
        want["fused_doubling"] = config.m_max + 1
        print(f"main path: rt_run_ms {name} nSpec={config.n_spec} levels "
              f"{levels}, launches {launches} (want {want}), {e2e_s:.1f} s",
              flush=True)
        if launches != want:
            fail(f"rt_run_ms {name} launches {launches}, want {want}")
        # The O(N) path shows in the device time: a launch whose every
        # block voted for it runs in well under a quarter of a dense one.
        print("K5 paths in that run (by the operands' vote): " + " ".join(
            f"{k} {len(v)} launches ({', '.join(f'{x:.3f}' for x in v)} "
            "ms)" for k, v in k5_paths.items()), flush=True)
        if sum(map(len, k5_paths.values())) != launches["fused_doubling"]:
            fail(f"rt_run_ms {name}: K5 spans {k5_paths} do not match "
                 f"{launches['fused_doubling']} launches")
        if k5_paths["z0"] and k5_paths["dense"] and \
                max(k5_paths["z0"]) > 0.25 * min(k5_paths["dense"]):
            fail(f"rt_run_ms {name}: a Z = 0 launch took "
                 f"{max(k5_paths['z0'])} ms against a dense launch's "
                 f"{min(k5_paths['dense'])} ms: not the O(N) path")
        shape = (len(levels), len(config.vza_idx), config.n_stokes,
                 config.n_spec)
        if uwJ.shape != shape or not (np.isfinite(uwJ).all()
                                      and np.isfinite(dwJ).all()):
            fail(f"rt_run_ms {name}: not finite or shape {uwJ.shape}")
        plain = multisensor.rt_solve_ms(
            inputs, dataclasses.replace(config, fused=False), levels, dev)
        e_route = {f"{k}[{L}]": rel(v[i], plain[k][i].cpu())
                   for k, v in (("uwJ", uwJ), ("dwJ", dwJ))
                   for i, L in enumerate(levels)}
        band = solver.rt_solve(inputs, config, dev)
        e_band = {"uwJ[0]-R": rel(uwJ[0], band["R"].cpu()),
                  "dwJ[0]-T": rel(dwJ[0], band["T"].cpu())}
        print(f"MS {name}: kernel route vs plain route " + " ".join(
            f"{k}={e:.2e}" for k, e in e_route.items()) + "; level 0 vs "
            "band rt_solve " + " ".join(f"{k}={e:.2e}"
                                        for k, e in e_band.items()),
            flush=True)
        if not all(e <= GATE for e in (*e_route.values(),
                                       *e_band.values())):
            fail(f"MS {name} gates: {e_route} {e_band}")

        solve_s, times = best_of_3(lambda: multisensor.rt_solve_ms(
            inputs, config, levels, dev))
        split = DeviceSplit()
        patched = [(solver, "fused_doubling"),
                   (multisensor, "_make_added_layer"),
                   (multisensor, "interaction"),
                   (multisensor, "interlayer_flux")]
        saved = [getattr(mod, attr) for mod, attr in patched]
        for mod, attr in patched:
            setattr(mod, attr, split.wrap(attr, getattr(mod, attr)))
        try:
            t0 = time.perf_counter()
            multisensor.rt_solve_ms(inputs, config, levels, dev)
            split_ms = split.ms()
            split_ms["solve"] = (time.perf_counter() - t0) * 1e3
        finally:
            for (mod, attr), fn in zip(patched, saved):
                setattr(mod, attr, fn)
        result[name] = {
            "ms_pts_per_s": config.n_spec / solve_s, "ms_solve_s": solve_s,
            "ms_solve_all_s": times, "rt_run_ms_e2e_s": e2e_s,
            "n_spec": config.n_spec, "levels": levels, "launches": launches,
            "k5_paths_ms": k5_paths,
            "device_split_ms": {
                "stash (elemental + K5)": split_ms["_make_added_layer"],
                "K5": split_ms["fused_doubling"],
                "interactions": split_ms["interaction"],
                "interlayer_flux": split_ms.get("interlayer_flux", 0.0),
                "solve (host clock)": split_ms["solve"]}}

    inputs, config = built["flagship"]
    # K5 per launch at moment 0 (the dense ladder, bound by operations:
    # layer_flops) and at m_max (Z = 0: the O(N) ladder, 7 K + 1 operations
    # a row and step, bound by the bytes of its operands and outputs).
    k5 = {}
    for m, ops in k5_ops.items():
        ms = cuda_time_ms(lambda: fused_rt._launch_doubling(*ops, sched),
                          reps=3)
        plain_ms = cuda_time_ms(lambda: fused_rt.doubling_reference(
            *ops, config.ndoubl, sched), reps=2)
        out = fused_rt._launch_doubling(*ops, sched)
        n_pts = ops[0].shape[0]
        if m <= config.m_scat:
            flops = layer_flops(config.N, config.n_sources, sched) * n_pts
        else:
            flops = (7.0 * config.n_sources + 1) * config.N \
                * config.ndoubl * n_pts
        nb = nbytes(*ops, *out)
        ops_ms = flops / FP32_PEAK_FLOPS * 1e3
        mem_ms = nb / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, mem_ms)
        k5[m] = {"m": m, "points": n_pts, "kernel_ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound,
                 "bound_by": "operations" if ops_ms >= mem_ms else "bytes",
                 "bound_share": bound / ms, "flops": flops, "bytes": nb,
                 "launches": len(result["flagship"]["k5_paths_ms"][
                     "dense" if m <= config.m_scat else "z0"])}
        del out
    dense, z0 = k5[0], k5[config.m_max]
    dense["f64_kernel_plain"] = k5_f64
    lib = cuda_build.load("fused_rt")
    blocks_per_sm = {K: lib.vsm_fused_doubling_blocks_per_sm(config.N, K)
                     for K in (1, 2)}
    print(json.dumps({"card": smi, "ms": result,
                      "k5_launch": {"dense": dense, "z0": z0,
                                    "blocks_per_sm": blocks_per_sm}}),
          flush=True)
    return {"name": "fused_doubling", "route": "cuda",
            "source": "vsmartmom_tpu_torch/csrc/fused_rt.cu",
            "replaces": "vsmartmom_tpu/ops/fused_rt.py:425",
            "launches": result["flagship"]["launches"]["fused_doubling"],
            "max_abs_err": k5_abs_err, "ms": dense["kernel_ms"],
            "plain_ms": dense["plain_ms"], "bound_ms": dense["bound_ms"],
            "bound_by": dense["bound_by"], "library_ms": None,
            "z0": {k: z0[k] for k in ("m", "launches", "kernel_ms",
                                      "plain_ms", "bound_ms", "bound_by")}}


def layer_chain_phase(dev, smi, inputs, config):
    """K4 on the flagship chain of scripts/probe_fused2.py: the flagship's
    own elemental operators of moments 0..m_scat at nSpec 1024 chained
    through ``fused_layer_step`` over all layers from the vacuum composite
    (launch counters set to 0 just before, read just after), held against
    the plain chain and K1's composite of the same moment; timing of the
    chain beside K1's launches for the same moments. Returns K4's
    kernels-line entry."""
    from vsmartmom_tpu_torch.core import multisensor, solver
    from vsmartmom_tpu_torch.core.kernels import identity_composite
    from vsmartmom_tpu_torch.core.types import SolverInputs
    from vsmartmom_tpu_torch.ops import fused_band, fused_rt
    counted = launch_counted()
    inputs, config = solver.spectral_slice(inputs, config, 0, N_CHUNK)
    inp = SolverInputs(*(x.to(torch.float32) for x in inputs))
    nz, s, N, K = config.nz, N_CHUNK, config.N, config.n_sources
    sched = fused_rt.norm_sched(config.ns_sched or None, config.ndoubl)
    layers = []
    for m in range(config.m_scat + 1):
        layer_data, kw = multisensor.layer_batch_args(inp, config, m)
        d = kw.pop("d_vec")
        r_mp, t_pp, jp, jm, expk = (
            x.reshape(nz, s, *x.shape[1:])
            for x in solver.layer_batch(layer_data, **kw))
        layers.append((r_mp * d[:, None], t_pp, jp, jm * d[:, None], expk,
                       d))

    def chain(step, dtype=torch.float32):
        comps = []
        for lay in layers:
            r, t, jp, jm, ek, d = (x.to(dtype) for x in lay)
            comp = identity_composite(s, N, dtype, dev, K)
            for z in range(nz):
                comp = step(comp, r[z], t[z], jp[z], jm[z], ek[z], d,
                            config.ndoubl, sched, config.ns_inter)
            comps.append(comp)
        return comps

    for fn in counted.values():
        fn.launches = 0
    out = chain(fused_rt.fused_layer_step)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    want = {k: 0 for k in counted}
    want["fused_layer_step"] = len(layers) * nz
    print(f"layer chain: moments 0..{config.m_scat} x {nz} layers at "
          f"nSpec={s}, launches {launches} (want {want})", flush=True)
    if launches != want:
        fail(f"layer chain launches {launches}, want {want}")
    plain = chain(fused_rt.layer_step_reference)
    plain64 = chain(fused_rt.layer_step_reference, torch.float64)
    names = ("R_mp", "R_pm", "T_pp", "T_mm", "J0_p", "J0_m")
    k4_abs_err = 0.0
    k4_f64 = []
    k1_args = [solver.band_moment_args(inputs, config, m, dev)
               for m in range(len(layers))]
    for m, (o, p, q, a) in enumerate(zip(out, plain, plain64, k1_args)):
        k1 = fused_band.fused_moment(*a[0], **a[1])
        e_p = {n: rel(x, y) for n, x, y in zip(names, o, p)}
        e_k1 = {n: rel(x, y) for n, x, y in zip(names, o, k1)}
        k4_abs_err = max([k4_abs_err] + [float((x - y).abs().max())
                                         for x, y in zip(o, p)])
        # The matrices round as the plain chain's; the sources (four
        # partial sums a row) within 2x of its distance from f64.
        same = [bool(torch.equal(x, y)) for x, y in zip(o[:4], p[:4])]
        e64 = (max(rel(x.double(), z) for x, z in zip(o[4:], q[4:])),
               max(rel(y.double(), z) for y, z in zip(p[4:], q[4:])))
        k4_f64.append(e64)
        print(f"K4 chain m={m} vs plain chain: " + " ".join(
            f"{n}={e:.2e}" for n, e in e_p.items()) + "; vs K1: " + " ".join(
            f"{n}={e:.2e}" for n, e in e_k1.items()) + "; matrices "
            f"bit-identical: {all(same)}; J vs f64 plain chain: kernel "
            f"{e64[0]:.2e}, f32 plain {e64[1]:.2e}", flush=True)
        if not all(np.isfinite(e) and e <= GATE
                   for e in (*e_p.values(), *e_k1.values())):
            fail(f"K4 chain at m={m}: vs plain {e_p}, vs K1 {e_k1}")
        if not all(same):
            fail(f"K4 chain's matrices at m={m} are not the plain chain's "
                 f"bit for bit: {dict(zip(names, same))}")
        if not e64[0] <= F64_RATIO * e64[1]:
            fail(f"K4 chain's sources at m={m} are {e64[0]} from f64, over "
                 f"{F64_RATIO}x the f32 plain chain's {e64[1]}")

    chain_ms = cuda_time_ms(lambda: chain(fused_rt.fused_layer_step),
                            reps=3)
    k1_ms = cuda_time_ms(lambda: [fused_band.fused_moment(*a[0], **a[1])
                                  for a in k1_args], reps=3)
    r, t, jp, jm, ek, d = layers[0]
    z = nz // 2
    comp = out[0]
    k4_ms = chain_ms / want["fused_layer_step"]
    k4_plain_ms = cuda_time_ms(lambda: fused_rt.layer_step_reference(
        comp, r[z], t[z], jp[z], jm[z], ek[z], d, config.ndoubl, sched,
        config.ns_inter), reps=3)
    one = fused_rt._launch_layer_step(comp, r[z], t[z], jp[z], jm[z], ek[z],
                                      d, sched, config.ns_inter)
    k4_flops = layer_flops(N, K, sched, config.ns_inter) * s
    k4_bytes = nbytes(*comp, r[z], t[z], jp[z], jm[z], ek[z], d, *one)
    k4_ops_ms = k4_flops / FP32_PEAK_FLOPS * 1e3
    k4_mem_ms = k4_bytes / HBM_BYTES_PER_S * 1e3
    k4_bound = max(k4_ops_ms, k4_mem_ms)
    print(json.dumps({
        "card": smi, "layer_chain": {
            "moments": len(layers), "layers": nz, "n_spec": s,
            "k4_chain_ms": chain_ms, "k1_same_moments_ms": k1_ms,
            "k4_blocks_per_sm": fused_rt.layer_step_blocks_per_sm(N, K),
            "f64_kernel_plain_sources": k4_f64,
            "k4_launch": {"kernel_ms": k4_ms, "plain_ms": k4_plain_ms,
                          "bound_ms": k4_bound,
                          "bound_share": k4_bound / k4_ms,
                          "flops": k4_flops, "bytes": k4_bytes,
                          "achieved_tflops": k4_flops / k4_ms / 1e9}}}),
        flush=True)
    return {"name": "fused_layer_step", "route": "cuda",
            "source": "vsmartmom_tpu_torch/csrc/fused_rt.cu",
            "replaces": "vsmartmom_tpu/ops/fused_rt.py:493",
            "launches": launches["fused_layer_step"],
            "max_abs_err": k4_abs_err, "ms": k4_ms, "plain_ms": k4_plain_ms,
            "bound_ms": k4_bound,
            "bound_by": "operations" if k4_ops_ms >= k4_mem_ms else "bytes",
            "library_ms": None}


#: The wrapper each probe call site launches, and the source of its kernel.
PROBE_KERNELS = {
    "P1": "dot_chain", "P2": "dot_chain", "P3": "dot_chain",
    "P6": "dot_chain", "P8": "dot_chain", "P4": "lane_dot_chain",
    "P9": "lane_dot_chain", "P5": "layout_op", "P7": "band_stages"}
PROBE_SOURCES = {"dot_chain": "probe_dots.cu",
                 "lane_dot_chain": "probe_dots.cu",
                 "layout_op": "probe_layout.cu",
                 "band_stages": "band_stages.cu"}


def probe_failures(site, case):
    """The gates one probe case misses (``probes.common.chain_failures``
    for the dot and lane chains); every kernel time must be the device's
    work alone."""
    from vsmartmom_tpu_torch.probes import common
    bad = [] if case["device_only"]["kernel"] else [
        f"{case['case']}: the host did not queue the timed calls ahead"]
    if site == "P5":
        return bad + ([] if case["exact"] else [f"{case['case']}: not exact"])
    if site == "P7":
        if case["must_be_finite"] and case["finite_share"] != 1.0:
            bad.append(f"{case['case']}: plain version not finite "
                       f"({case['finite_share']})")
        if not (case["nan_match"] and case["err_plain"] <= common.GATE):
            bad.append(f"{case['case']}: NaN pattern {case['nan_match']}, "
                       f"{case['err_plain']} where finite")
        return bad
    return bad + common.chain_failures(case)


def mt_plan_report(config, n_par):
    """K2's launch plan at a Jacobian scene's (N, K, P), printed and
    returned: the host plan (``fused_lin.mt_plan``), which must be the C
    side's, the clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``, at least 1), ptxas's registers and
    spills of the K instance, the kernel's own work (groups + 2P primal
    moments a point) and the cluster barriers a block passes a launch (one
    a product phase: per layer 3 a doubling step, 2 a Newton-Schulz
    iteration, 6 + 2 ns_inter for the adding; one before the first remote
    store and one after the last)."""
    from vsmartmom_tpu_torch.ops import cuda_build, fused_lin
    from vsmartmom_tpu_torch.ops.fused_rt import norm_sched
    K = config.n_sources
    plan = fused_lin.mt_plan(config.N, K, n_par)
    info = fused_lin.mt_launch_info(config.N, K, n_par)
    report = ptxas_report(cuda_build.BUILD_LOG.get("fused_lin", (0, ""))[1])
    regs = [v for k, v in report.items() if f"mt_kernelILi{K}E" in k]
    regs, st, ld = regs[0] if regs else (None, None, None)
    sched = norm_sched(config.ns_sched or None, config.ndoubl)
    barriers = config.nz * (3 * config.ndoubl + 2 * sum(sched)
                            + 2 * config.ns_inter + 6) + 2
    out = {k: plan[k] for k in ("cluster", "groups", "threads", "smem",
                                "tiles", "work")}
    out.update(max_clusters=info["max_clusters"], registers=regs,
               spill_stores=st, spill_loads=ld, cluster_barriers=barriers)
    print(f"  plan K2 N={config.N} K={K} P={n_par}: {plan['groups']} "
          f"cluster(s) of {plan['cluster']} blocks a point, "
          f"{plan['threads']} threads, {plan['smem']} B shared, "
          f"{info['max_clusters']} clusters resident, {plan['tiles']} tiles "
          f"a product; mt_kernel<{K}>: {regs} registers, spills {st} / {ld} "
          f"B; {plan['work']} primal moments a point; {barriers} cluster "
          f"barriers a block", flush=True)
    bad = [k for k in ("cluster", "groups", "threads", "smem", "tiles")
           if info[k] != plan[k]]
    if bad or not info["max_clusters"] >= 1:
        fail(f"K2 plan {plan} against the C side's {info}")
    return out


def ptxas_report(log):
    """{kernel entry: (registers, spill store bytes, spill load bytes)} from
    nvcc's ``-Xptxas -v`` report of one library (the entry's own function
    properties, not those of a device function it calls)."""
    import re
    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = props = m.group(1)
            out[entry] = [None, None, None]
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry and props == entry:
            out[entry][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry][0] = int(m.group(1))
    return out


def case_kernel(case):
    """The kernel entry a dot or lane case launches (its mangled-name
    fragment in ptxas's report)."""
    plan = case["plan"]
    if case["form"] == "lane":
        return "lane_chain_kernel"
    if case["mode"] == "fp32":
        return "simt_chain_kernel"
    from vsmartmom_tpu_torch.ops.probe_dots import tf32_depth
    mode = {"tf32": 1, "3xtf32": 2}[case["mode"]]
    return (f"wg_chain_kernelILi{mode}ELi{plan['cols']}"
            f"ELi{tf32_depth(case['shape'][1])}ELi{plan['rows'] // 64}E")


def plan_line(site, case, report):
    """One printed line of a case's launch plan, and the misses: the host
    plan must be the launch the C side makes of it."""
    plan = case["plan"]
    regs = [v for k, v in report.items() if case_kernel(case) in k]
    regs, st, ld = regs[0] if regs else (None, None, None)
    per_block = (plan["threads"] // 128 if case["mode"] != "fp32"
                 and case["form"] != "lane" else max(plan["points"], 1))
    slabs = (plan["blocks_per_sm"] * per_block
             if plan.get("blocks_per_sm") is not None else None)
    line = (f"  plan {site} {case['case']}: grid {tuple(plan['grid'])} "
            f"({plan['blocks']} blocks), {plan['threads']} threads, "
            f"{plan['smem']} B shared, {plan.get('blocks_per_sm')} "
            f"blocks/SM, {slabs} "
            f"{'points' if case['form'] == 'lane' else 'slabs'} in flight/SM; rows x cols {plan['rows']} x {plan['cols']}; "
            f"{case_kernel(case)}: {regs} registers, spills {st} / {ld} B")
    same = (plan.get("c_grid") == plan["grid"]
            and plan.get("c_threads") == plan["threads"]
            and plan.get("c_smem") == plan["smem"])
    bad = [] if same else [f"{case['case']}: host plan {plan} is not the "
                           f"C launch"]
    return line, bad


def band_plan_lines(cases):
    """The band-stage kernels' plan lines, one a P7 case: each launch's
    grid, threads and shared bytes (the C side's plan,
    ``band_stages.band_plan``) and its entry's ptxas registers and
    spills."""
    from vsmartmom_tpu_torch.ops import band_stages, cuda_build
    from vsmartmom_tpu_torch.probes import band_bisect
    report = ptxas_report(cuda_build.BUILD_LOG.get("band_stages",
                                                   (0, ""))[1])
    lines = []
    for case in cases:
        plan = band_stages.band_plan(case["stage"], case["nz"],
                                     band_bisect.S, band_bisect.N)
        parts = []
        for x in plan["launches"]:
            regs = [v for k, v in report.items() if x["kernel"] in k]
            regs, st, ld = regs[0] if regs else (None, None, None)
            parts.append(f"{x['kernel']} grid {x['grid']}, {x['threads']} "
                         f"threads, {x['smem']} B shared, {regs} registers, "
                         f"spills {st} / {ld} B")
        lines.append(f"  plan P7 {case['case']}: " + "; ".join(parts)
                     + f"; scratch {4 * plan['scratch']} B")
    return lines


def probe_entry(site, replaces, cases, launches):
    """The kernels-line entry of one probe call site: its headline case
    (the first fp32 case; P5 one pass over its sixteen cases; P7 the full
    stage where it is finite) and the largest kernel-vs-plain difference
    over all its cases."""
    if site == "P5":
        head = {k: sum(c[k] for c in cases)
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        head.update(case="16 cases, one launch each", bound_by="bytes")
    elif site == "P7":
        head = next(c for c in cases if c["must_be_finite"])
    else:
        head = next(c for c in cases if c["mode"] == "fp32")
    wrapper = PROBE_KERNELS[site]
    return {"name": f"{wrapper}[{site}]", "route": "cuda",
            "source": "vsmartmom_tpu_torch/csrc/" + PROBE_SOURCES[wrapper],
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "case": head["case"]}


def probes_phase(smi):
    """P1-P9: each probe module run on the card at its script's shapes,
    every launch counter set to 0 just before and read just after (it
    must equal the wrapper calls each case made: one warm-up, REPS timed
    calls per try, its checks), its gates held, one JSON line per call
    site. Returns the nine kernels-line entries."""
    import importlib

    from vsmartmom_tpu_torch.ops import cuda_build
    from vsmartmom_tpu_torch.probes import SITES
    counted = launch_counted()
    report = ptxas_report(cuda_build.BUILD_LOG.get("probe_dots", (0, ""))[1])
    entries = []
    for module, sites in SITES.items():
        mod = importlib.import_module(f"vsmartmom_tpu_torch.probes.{module}")
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        result = mod.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counted.items()}
        want = {k: 0 for k in counted}
        for site in sites:
            want[PROBE_KERNELS[site]] += sum(c["kernel_calls"]
                                             for c in result[site])
        # P7's full stage: a chain launch after each of its layer launches.
        want["band_chain"] = sum(c["kernel_calls"]
                                 for c in result.get("P7", [])
                                 if c["stage"] == "full")
        print(f"probes: {module} in {seconds:.1f} s, launches "
              f"{ {k: v for k, v in launches.items() if v} } (want "
              f"{ {k: v for k, v in want.items() if v} })", flush=True)
        if launches != want:
            fail(f"probe {module} launches {launches}, want {want}")
        for site, replaces in sites.items():
            cases = result[site]
            print(json.dumps({"card": smi, "probe": site,
                              "replaces": replaces, "device": result["device"],
                              "cases": cases}), flush=True)
            bad = [m for c in cases for m in probe_failures(site, c)]
            for case in cases:
                if PROBE_KERNELS[site] in ("dot_chain", "lane_dot_chain"):
                    line, miss = plan_line(site, case, report)
                    print(line, flush=True)
                    bad += miss
            if site == "P7":
                print("\n".join(band_plan_lines(cases)), flush=True)
            if bad:
                fail(f"probe {site}: " + "; ".join(bad))
            entries.append(probe_entry(site, replaces, cases,
                                       launches[PROBE_KERNELS[site]]))
            if site == "P7":
                entries[-1]["chain_launches"] = launches["band_chain"]
    return entries


def lin_ref_gates(out, ref, names):
    """A Jacobian run against a stored JAX f64 reference: ({R, T, dR, dT}
    errors, each parameter's dR error on its own scale, the height
    parameters' 1.01 control, whether the gates hold): R <= 1e-4, each dR
    <= 2e-4 of its own max (HEIGHT_GATE for the aerosol height), and the
    height Jacobians 1% off must fail their gate."""
    e = {k: rel(out[k], ref[k]) for k in ("R", "T", "dR", "dT")}
    own = [rel(out["dR"][..., q], ref["dR"][..., q])
           for q in range(len(names))]
    gates = [HEIGHT_GATE if n.endswith(HEIGHT_PARAMS) else TAN_GATE
             for n in names]
    control = [rel(1.01 * out["dR"][..., q], ref["dR"][..., q])
               for q, n in enumerate(names) if n.endswith(HEIGHT_PARAMS)]
    ok = (e["R"] <= GATE and all(x <= g for x, g in zip(own, gates))
          and all(x > HEIGHT_GATE for x in control))
    return e, own, control, ok


def thermal_lin_phase(dev, smi):
    """The thermal (K = 2) Jacobian path through K1' (see the module
    docstring, phase 8). Returns K1''s kernels-line entry."""
    import ctypes

    from vsmartmom_tpu_torch import (default_layout, rt_run, rt_run_lin,
                                     thermal_lin_model)
    from vsmartmom_tpu_torch.core.linearization import (build_tangent_inputs,
                                                        rt_solve_jvp)
    from vsmartmom_tpu_torch.core.solver import spectral_slice
    from vsmartmom_tpu_torch.flagship import lin_thermal_model
    from vsmartmom_tpu_torch.ops import cuda_build, fused_band, fused_lin
    counted = launch_counted()
    phase_t0 = time.perf_counter()

    smem_fn = cuda_build.load("fused_lin").vsm_fused_moment_mt_smem_bytes
    smem_fn.restype = ctypes.c_size_t
    smem_fn.argtypes = [ctypes.c_int, ctypes.c_int]
    smem = {k: smem_fn(fused_lin.KERNEL_MAX_N, k) for k in (1, 2)}
    print(f"K2 shared memory at N={fused_lin.KERNEL_MAX_N}: K=1 {smem[1]} B,"
          f" K=2 {smem[2]} B (opt-in limit {SMEM_OPT_IN} B)", flush=True)
    if smem[2] > SMEM_OPT_IN:
        fail(f"K2 at K = 2 needs {smem[2]} B of shared memory")

    t0 = time.perf_counter()
    model = thermal_lin_model(THERMAL_N_SPEC)
    scene_s = time.perf_counter() - t0
    layout = default_layout(model)
    t0 = time.perf_counter()
    inputs, config, tans = build_tangent_inputs(model, 0, layout, device=dev)
    torch.cuda.synchronize()
    tangent_s = time.perf_counter() - t0
    n_par = len(tans)
    if not (config.fused and config.n_sources == 2 and config.N == 52
            and n_par == 8):
        fail(f"the thermal scene on CUDA: fused={config.fused}, "
             f"K={config.n_sources}, N={config.N}, P={n_par}")
    print(f"thermal Jacobian config: N={config.N} nz={config.nz} "
          f"C={inputs.Z_pp.shape[1]} K={config.n_sources} "
          f"ndoubl={config.ndoubl} ns_sched={config.ns_sched} "
          f"ns_inter={config.ns_inter} m_max={config.m_max} "
          f"m_scat={config.m_scat} params={layout.names()}; "
          f"max B={model.bands[0].thermal_b.max():.4g}; host build "
          f"{scene_s:.1f} s, tangents {tangent_s:.1f} s", flush=True)
    sl = spectral_slice(inputs, config, 0, THERMAL_SLICE)
    sl_tans = [spectral_slice(t, config, 0, THERMAL_SLICE)[0] for t in tans]

    # K1' against its plain version; the thermal column at m > 0 is zero.
    outs, refs, th_max, f64_errs = [], [], 0.0, []
    for m in (0, 1, config.m_max):
        args = fused_lin.multitangent_args(sl[0], sl_tans, sl[1], m, dev)
        outs.append(fused_lin.fused_moment_multitangent(*args))
        torch.cuda.synchronize()
        refs.append(fused_lin.moment_multitangent_reference(*args))
        f64_errs.append(primal_f64_errors(args, outs[-1][0], refs[-1][0]))
        (*_, Jp, Jm), (*_, dJp, dJm) = outs[-1]
        th = [x[..., 1] for x in (Jp, Jm, dJp, dJm)]
        if m == 0:
            th_max = max(float(th[0].abs().max()), float(th[1].abs().max()))
            if not th_max > 0:
                fail("K1' gave no thermal signal at m = 0")
        elif not all(bool((x == 0).all()) for x in th):
            fail(f"K1' gave a non-zero thermal column at m = {m}")
    k1p_prim, k1p_tan, k1p_abs_err = mt_errors(outs, refs)
    del outs, refs
    print(f"K1' vs plain (nSpec={THERMAL_SLICE}, m=0,1,{config.m_max}): "
          f"primal={k1p_prim:.2e} tangents per parameter "
          + " ".join(f"{e:.2e}" for e in k1p_tan)
          + f"; thermal column max at m=0 {th_max:.4g}, exactly 0 above"
          f"; primal vs f64 plain: kernel {max(e[0] for e in f64_errs):.2e},"
          f" f32 plain {max(e[1] for e in f64_errs):.2e}", flush=True)
    if not (np.isfinite(k1p_prim) and k1p_prim <= GATE
            and all(np.isfinite(e) and e <= TAN_GATE for e in k1p_tan)):
        fail(f"K1' vs moment_multitangent_reference: primal {k1p_prim}, "
             f"tangents {k1p_tan}")

    # The main path, counted.
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    R, T, dR, dT = rt_run_lin(model, layout=layout, device=dev)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    want = {k: 0 for k in counted}
    want["fused_moment_multitangent"] = config.m_scat + 1
    print(f"main path: thermal rt_run_lin nSpec={THERMAL_N_SPEC}, K=2, "
          f"{n_par} parameters, launches {launches} (want {want}), "
          f"{e2e_s:.1f} s", flush=True)
    if launches != want:
        fail(f"thermal Jacobian path launches {launches}, want {want}")
    if dR.shape != (9, 4, THERMAL_N_SPEC, n_par) or not all(
            np.isfinite(x).all() for x in (R, T, dR, dT)):
        fail(f"thermal rt_run_lin not finite or dR of shape {dR.shape}")
    kern = fused_lin.rt_solve_multitangent(sl[0], sl_tans, sl[1], dev)
    plain = rt_solve_jvp(sl[0], sl_tans,
                         dataclasses.replace(sl[1], fused=False), dev)
    e_route = [rel(kern[0], plain[0])] + [rel(kern[2][q], plain[2][q])
                                          for q in range(n_par)]
    print(f"thermal kernel route vs jvp route (nSpec={THERMAL_SLICE}): "
          f"R={e_route[0]:.2e} dR per parameter "
          + " ".join(f"{e:.2e}" for e in e_route[1:])
          + f"; dT={rel(kern[3], plain[3]):.2e}", flush=True)
    if not (e_route[0] <= GATE and all(e <= TAN_GATE for e in e_route[1:])):
        fail(f"thermal kernel route vs jvp route: {e_route}")
    del plain
    fused_band.fused_moment.launches = 0
    R_fwd, _ = rt_run(model, device=dev, spectral_chunk=THERMAL_N_SPEC)
    e_fwd = rel(R, R_fwd)
    print(f"rt_run of the thermal scene: fused_moment launches="
          f"{fused_band.fused_moment.launches} (want {config.m_scat + 1}, "
          f"K=2), R vs rt_run_lin's R {e_fwd:.2e}", flush=True)
    if fused_band.fused_moment.launches != config.m_scat + 1 \
            or not e_fwd <= GATE:
        fail(f"rt_run vs rt_run_lin on the thermal scene: {e_fwd}")

    # Additivity: the RT is linear in its sources. The solar-only and the
    # thermal-only (include_solar=False) bands of the same scene, with the
    # same tangents (they carry none of F0 or thermal_b).
    band, th_b = model.bands[0], model.bands[0].thermal_b
    band.thermal_b = None
    sol = model.build_band(0, device=dev)
    band.thermal_b = th_b
    model.params.include_solar = False
    therm = model.build_band(0, device=dev)
    model.params.include_solar = True
    if not (sol[1].n_sources == 1 and therm[1].n_sources == 2
            and not bool(therm[0].F0.any())
            and sol[1].ns_sched == therm[1].ns_sched == config.ns_sched):
        fail("the solar-only and thermal-only builds of the thermal scene")
    parts = []
    for b in (sol, therm):
        b_inputs, b_config = spectral_slice(*b, 0, THERMAL_SLICE)
        parts.append(fused_lin.rt_solve_multitangent(b_inputs, sl_tans,
                                                     b_config, dev))
    e_add = [rel(parts[0][0] + parts[1][0], kern[0])] + [
        rel(parts[0][2][q] + parts[1][2][q], kern[2][q])
        for q in range(n_par)]
    share = float(parts[1][0].abs().max() / kern[0].abs().max())
    print(f"additivity (nSpec={THERMAL_SLICE}): R={e_add[0]:.2e} dR per "
          "parameter " + " ".join(f"{e:.2e}" for e in e_add[1:])
          + f"; thermal-only max R / total {share:.3f}", flush=True)
    if not (e_add[0] <= GATE and all(e <= TAN_GATE for e in e_add[1:])
            and share > 1e-3):
        fail(f"additivity of the sources: {e_add}, thermal share {share}")
    del kern, parts

    # Against the JAX package: the small thermal scene's stored f64 run.
    ref = np.load(Path(__file__).resolve().parent / "vsmartmom_tpu_torch"
                  / "data" / "lin_thermal_ref_f64.npz")
    small_model = lin_thermal_model()
    small = dict(zip(("R", "T", "dR", "dT"),
                     rt_run_lin(small_model, device=dev)))
    names = default_layout(small_model).names()
    e_ref, own, control, ok = lin_ref_gates(small, ref, names)
    print("thermal Jacobian kernel path vs JAX f64 reference (small thermal "
          "scene): " + " ".join(f"{k}={e:.2e}" for k, e in e_ref.items())
          + "; dR per parameter on its own scale "
          + " ".join(f"{n}={e:.2e}" for n, e in zip(names, own))
          + "; height dR 1% off " + " ".join(f"{e:.2e}" for e in control),
          flush=True)
    if not ok:
        fail(f"thermal Jacobian port vs stored JAX reference: {e_ref}, per "
             f"parameter {own}, control {control}")

    # Timing: a warm-up on the slice, then one solve at full width.
    fused_lin.rt_solve_multitangent(sl[0], sl_tans, sl[1], dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o = fused_lin.rt_solve_multitangent(inputs, tans, config, dev)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    if not bool(torch.isfinite(o[2]).all()):
        fail("non-finite dR in the timed thermal Jacobian solve")
    del o
    args = fused_lin.multitangent_args(inputs, tans, config, 0, dev)
    k_ms = cuda_time_ms(lambda: fused_lin._launch_kernel(*args), reps=3)
    p_ms = cuda_time_ms(
        lambda: fused_lin.moment_multitangent_reference(*args), reps=2)
    out = fused_lin._launch_kernel(*args)
    plan = mt_plan_report(config, n_par)
    primal_flops = moment_flops(config, THERMAL_N_SPEC)
    flops = (1 + 2 * n_par) * primal_flops
    n_bytes = nbytes(*args[0], *args[1], *out[0], *out[1])
    t_ops, t_bytes = flops / FP32_PEAK_FLOPS * 1e3, \
        n_bytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    print(json.dumps({
        "card": smi, "lin_thermal_pts_per_s": THERMAL_N_SPEC / solve_s,
        "lin_thermal_tangent_pts_per_s": THERMAL_N_SPEC * n_par / solve_s,
        "lin_thermal_solve_s": solve_s,
        "rt_run_lin_thermal_e2e_s": e2e_s, "scene_build_s": scene_s,
        "tangent_build_s": tangent_s, "n_spec": THERMAL_N_SPEC,
        "n_params": n_par, "launches": launches,
        "smem_bytes_k2": smem[2], "phase_s": time.perf_counter() - phase_t0,
        "k1prime_launch": {"n_spec": THERMAL_N_SPEC, "kernel_ms": k_ms,
                           "plain_ms": p_ms, "bound_ms": bound,
                           "bound_share": bound / k_ms, "flops": flops,
                           "flops_kernel": plan["work"] * primal_flops,
                           "bytes": n_bytes,
                           "achieved_tflops": flops / k_ms / 1e9,
                           "achieved_tflops_kernel": plan["work"]
                           * primal_flops / k_ms / 1e9,
                           "plan": plan}}), flush=True)
    return {"name": "fused_moment_multitangent[K1']", "route": "cuda",
            "source": "vsmartmom_tpu_torch/csrc/fused_lin.cu",
            "replaces": "vsmartmom_tpu/ops/fused_band.py:469",
            "launches": launches["fused_moment_multitangent"],
            "max_abs_err": k1p_abs_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def moment_bytes(args, out):
    """Bytes one launch must move: its operands read once (the plain prep's
    compact row tables) and the composite written once."""
    from vsmartmom_tpu_torch.ops.fused_band import band_operands
    ops = band_operands(*args[0], **{k: v for k, v in args[1].items()
                                     if k not in ("ns_sched", "ns_inter")})
    return sum(x.numel() * x.element_size() for x in (*ops, *out))


def main():
    script_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        fail("CUDA is not available: the chip smoke test runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False    # exact f32 products
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")

    from vsmartmom_tpu_torch import (flagship_model, rrs_sif_model, rt_run,
                                     rt_run_inelastic)
    from vsmartmom_tpu_torch.core.inelastic import (inelastic_setup,
                                                    rrs_moment_args,
                                                    rt_solve_rrs,
                                                    rt_solve_rrs_fused)
    from vsmartmom_tpu_torch.core.solver import (band_moment_args, rt_solve,
                                                 spectral_slice)
    from vsmartmom_tpu_torch.flagship import lin_ref_model, rrs_ref_model
    from vsmartmom_tpu_torch.ops import (cuda_build, fused_band, fused_lin,
                                         fused_rrs)
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_I

    # ---- 1. setup: build every kernel (one nvcc per source, together) ----
    sources = sorted(p.stem for p in cuda_build.SRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    cuda_build.build_all(sources)
    print(f"build: {sources} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, (_, log) in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            # probe_dots' 26 kernels are reported case by case (probes).
            if ("wgmma" in line or "Performance" in line or (
                    name != "probe_dots"
                    and ("registers" in line or "spill" in line))):
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
    lib = cuda_build.load("fused_band")
    lib.vsm_fused_moment_smem_bytes.restype = ctypes.c_size_t
    k1_plan = {"threads": lib.vsm_fused_moment_threads(),
               "smem_bytes": {K: lib.vsm_fused_moment_smem_bytes(config.N, K)
                              for K in (1, 2)},
               "blocks_per_sm": {
                   K: lib.vsm_fused_moment_blocks_per_sm(config.N, K)
                   for K in (1, 2)}}
    print(f"K1 launch at N={config.N}: {json.dumps(k1_plan)}", flush=True)
    k1_f64 = []
    for m in range(config.m_scat + 1):
        args = band_moment_args(*chunk0, m, dev)
        moment_args.append(args)
        out = fused_band.fused_moment(*args[0], **args[1])
        torch.cuda.synchronize()
        ref = fused_band.moment_reference(*args[0], **args[1])
        errs = {n: rel(a, b) for n, a, b in zip(names, out, ref)}
        max_abs_err = max([max_abs_err] + [float((a - b).abs().max())
                                           for a, b in zip(out, ref)])
        k1_f64.append(band_f64_errors(*args, out, ref))
        print(f"kernel vs plain m={m}: " + " ".join(
            f"{n}={e:.2e}" for n, e in errs.items()) + "; vs f64 plain: "
            f"kernel {k1_f64[-1][0]:.2e}, f32 plain {k1_f64[-1][1]:.2e}",
            flush=True)
        if not all(np.isfinite(e) and e <= GATE for e in errs.values()):
            fail(f"fused_moment vs moment_reference at m={m}: {errs}")
        if not k1_f64[-1][0] <= F64_RATIO * k1_f64[-1][1]:
            fail(f"fused_moment at m={m} is {k1_f64[-1][0]} from f64, over "
                 f"{F64_RATIO}x the f32 plain version's {k1_f64[-1][1]}")
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
        e64 = band_f64_errors(*args, out, ref)
        print(f"kernel vs plain K=2 m={m}: " + " ".join(
            f"{n}={e:.2e}" for n, e in errs.items()) + "; vs f64 plain: "
            f"kernel {e64[0]:.2e}, f32 plain {e64[1]:.2e}", flush=True)
        if not all(np.isfinite(e) and e <= GATE for e in errs.values()):
            fail(f"K=2 fused_moment vs moment_reference at m={m}: {errs}")
        if not e64[0] <= F64_RATIO * e64[1]:
            fail(f"K=2 fused_moment at m={m} is {e64[0]} from f64, over "
                 f"{F64_RATIO}x the f32 plain version's {e64[1]}")

    rrs_model = rrs_sif_model(n_spec=RRS_N_SPEC)
    rrs_inputs, rrs_config, *rrs = inelastic_setup(rrs_model, device=dev)
    if not rrs_config.fused:
        fail("the RRS f32 model on CUDA did not pick the kernel path")
    n_shifts = len(rrs[0])
    rrs_args = [rrs_moment_args(rrs_inputs, rrs_config, *rrs, m, dev)
                for m in range(rrs_config.m_max + 1)]
    kw0 = rrs_args[0][1]
    print(f"RRS config: N={rrs_config.N} nz={rrs_config.nz} "
          f"ndoubl={rrs_config.ndoubl} ns_sched={rrs_config.ns_sched} "
          f"ns_inter={rrs_config.ns_inter} shifts={n_shifts} "
          f"pairs={n_shifts * RRS_N_SPEC}; ie ladder ndoubl={kw0['ndoubl']} "
          f"ns_sched={kw0['ns_sched']} ns_inter={kw0['ns_inter']}",
          flush=True)
    names_ie = ("ieR_mp", "ieR_pm", "ieT_pp", "ieT_mm", "ieJ_p", "ieJ_m")
    rrs_abs_err = 0.0
    edge_model = rrs_sif_model(n_spec=64, nstreams=3, polarization=STOKES_I)
    edge_inputs, edge_config, *edge = inelastic_setup(edge_model, device=dev)
    off = torch.as_tensor([[not 0 <= i + sh < 64 for i in range(64)]
                           for sh in edge[0]], device=dev)
    cases = [("RRS", m, a) for m, a in enumerate(rrs_args)] + [
        ("edge N=6", m, rrs_moment_args(edge_inputs, edge_config, *edge, m,
                                        dev))
        for m in range(edge_config.m_max + 1)]
    k3_plan = fused_rrs.launch_info(
        rrs_config.N, rrs_config.nz,
        fused_rrs.norm_sched(kw0["ns_sched"], kw0["ndoubl"]),
        kw0["ns_inter"])
    print(f"K3 launches at N={rrs_config.N}: {json.dumps(k3_plan)}",
          flush=True)
    k3_f64 = []
    for label, m, (args, kw) in cases:
        out = fused_rrs.fused_moment_rrs(*args, **kw)
        torch.cuda.synchronize()
        ref = fused_rrs.moment_rrs_reference(*args, **kw)
        ops = fused_rrs.rrs_operands(*args, **{
            k: v for k, v in kw.items() if k not in ("ns_sched", "ns_inter")})
        sched = fused_rrs.norm_sched(kw["ns_sched"], kw["ndoubl"])
        nR, n_pts = len(args[11]), args[4].shape[1]
        split = [x.reshape(nR, n_pts, *x.shape[1:]) for x in
                 fused_rrs.moment_rrs_split_reference(
                     ops, args[11], sched, kw["ns_inter"],
                     fused_rrs.pair_shape(ops.d_vec.shape[0],
                                          ops.Em1.shape[0], sched,
                                          kw["ns_inter"])[1])]
        ref64 = fused_rrs._ie_layout(fused_rrs.moment_rrs_body_reference(
            ops._replace(**{f: getattr(ops, f).double()
                            for f in ops._fields}), sched, kw["ns_inter"]),
            nR, n_pts)
        errs = {n: rel(a, b) for n, a, b in zip(names_ie, out, ref)}
        e_split = max(rel(a, b) for a, b in zip(out, split))
        rrs_abs_err = max([rrs_abs_err] + [float((a - b).abs().max())
                                           for a, b in zip(out, ref)])
        e64 = (max(rel(a.double(), b) for a, b in zip(out, ref64)),
               max(rel(a.double(), b) for a, b in zip(ref, ref64)))
        k3_f64.append(e64)
        print(f"K3 vs plain {label} m={m}: " + " ".join(
            f"{n}={e:.2e}" for n, e in errs.items()) + f"; vs split plain "
            f"{e_split:.2e}; vs f64 plain: kernel {e64[0]:.2e}, f32 plain "
            f"{e64[1]:.2e}", flush=True)
        if not all(np.isfinite(e) and e <= GATE
                   for e in (*errs.values(), e_split)):
            fail(f"fused_moment_rrs vs moment_rrs_reference {label} m={m}: "
                 f"{errs}, vs moment_rrs_split_reference {e_split}")
        if not e64[0] <= F64_RATIO * e64[1]:
            fail(f"fused_moment_rrs {label} m={m} is {e64[0]} from f64, over "
                 f"{F64_RATIO}x the f32 plain version's {e64[1]}")
        if label.startswith("edge") and not all(
                bool((a[off] == 0).all()) for a in out):
            fail("off-grid RRS pairs did not come out exactly zero")

    from vsmartmom_tpu_torch import default_layout, rt_run_lin
    from vsmartmom_tpu_torch.core.linearization import (build_tangent_inputs,
                                                        rt_solve_jvp)
    t0 = time.perf_counter()
    lin_model = flagship_model(n_spec=LIN_N_SPEC, aerosol=True)
    lin_scene_s = time.perf_counter() - t0
    layout = default_layout(lin_model)
    t0 = time.perf_counter()
    lin_inputs, lin_config, lin_tans = build_tangent_inputs(
        lin_model, 0, layout, device=dev)
    torch.cuda.synchronize()
    lin_tangent_s = time.perf_counter() - t0
    n_par = len(lin_tans)
    if not lin_config.fused or n_par != 8:
        fail("the aerosol flagship on CUDA did not pick the kernel path "
             "with 8 Jacobian parameters")
    print(f"Jacobian config: N={lin_config.N} nz={lin_config.nz} "
          f"C={lin_inputs.Z_pp.shape[1]} ndoubl={lin_config.ndoubl} "
          f"ns_sched={lin_config.ns_sched} ns_inter={lin_config.ns_inter} "
          f"m_max={lin_config.m_max} m_scat={lin_config.m_scat} "
          f"params={layout.names()}; host build {lin_scene_s:.1f} s, "
          f"tangents {lin_tangent_s:.1f} s", flush=True)
    lin_slice = spectral_slice(lin_inputs, lin_config, 0, LIN_SLICE)
    slice_tans = [spectral_slice(t, lin_config, 0, LIN_SLICE)[0]
                  for t in lin_tans]
    outs, refs, f64_errs = [], [], []
    for m in (0, 1, lin_config.m_max):
        args = fused_lin.multitangent_args(lin_slice[0], slice_tans,
                                           lin_slice[1], m, dev)
        outs.append(fused_lin.fused_moment_multitangent(*args))
        torch.cuda.synchronize()
        refs.append(fused_lin.moment_multitangent_reference(*args))
        f64_errs.append(primal_f64_errors(args, outs[-1][0], refs[-1][0]))
    k2_prim, k2_tan, k2_abs_err = mt_errors(outs, refs)
    print(f"K2 vs plain (nSpec={LIN_SLICE}, m=0,1,{lin_config.m_max}): "
          f"primal={k2_prim:.2e} tangents per parameter "
          + " ".join(f"{e:.2e}" for e in k2_tan)
          + f"; primal vs f64 plain: kernel "
          f"{max(e[0] for e in f64_errs):.2e}, f32 plain "
          f"{max(e[1] for e in f64_errs):.2e}", flush=True)
    if not (np.isfinite(k2_prim) and k2_prim <= GATE
            and all(np.isfinite(e) and e <= TAN_GATE for e in k2_tan)):
        fail(f"fused_moment_multitangent vs moment_multitangent_reference: "
             f"primal {k2_prim}, tangents {k2_tan}")

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

    rrs_counted = {"fused_moment": fused_band.fused_moment,
                   "fused_moment_rrs": fused_rrs.fused_moment_rrs,
                   "rrs_diagonal": fused_rrs._launch_diagonal}
    for fn in rrs_counted.values():
        fn.launches = 0
    ie_out = dict(zip(("R", "T", "ieR", "ieT"),
                      rt_run_inelastic(rrs_model, device=dev)))
    torch.cuda.synchronize()
    rrs_launches = {k: fn.launches for k, fn in rrs_counted.items()}
    n_rc = min(n_shifts, 32768 // RRS_N_SPEC)
    want_rrs = {"fused_moment": rrs_config.m_max + 1,
                "fused_moment_rrs": (rrs_config.m_max + 1)
                * -(-n_shifts // n_rc)}
    want_rrs["rrs_diagonal"] = want_rrs["fused_moment_rrs"]
    print(f"main path: rt_run_inelastic nSpec={RRS_N_SPEC}, launches "
          f"{rrs_launches} (want {want_rrs})", flush=True)
    if rrs_launches != want_rrs:
        fail(f"RRS path launches {rrs_launches}, want {want_rrs}")
    for k, v in ie_out.items():
        if v.shape != (3, 3, RRS_N_SPEC) or not np.isfinite(v).all():
            fail(f"RRS {k} not finite or of the wrong shape {v.shape}")
    if not np.abs(ie_out["ieR"]).max() > 0:
        fail("the RRS path returned no inelastic signal")
    plain = rt_solve_rrs(rrs_inputs, dataclasses.replace(rrs_config,
                                                         fused=False),
                         *rrs, device=dev)
    plain = {k: v.cpu().numpy() for k, v in plain.items()}
    full = rt_solve_rrs_fused(rrs_inputs, rrs_config, *rrs, device=dev,
                              ie_fullres=True)
    e_rrs = {k: rel(ie_out[k], plain[k]) for k in ie_out}
    # Total radiance R + ieR against max|R|, the signal a retrieval reads.
    e_rrs["R+ieR"] = float(np.abs(ie_out["R"] + ie_out["ieR"] - plain["R"]
                                  - plain["ieR"]).max()
                           / np.abs(plain["R"]).max())
    e_full = {k: rel(full[k].cpu(), plain[k]) for k in ie_out}
    print("RRS kernel path vs plain path: " + " ".join(
        f"{k}={e:.2e}" for k, e in e_rrs.items()) + "; ie_fullres: " +
        " ".join(f"{k}={e:.2e}" for k, e in e_full.items()), flush=True)
    if not (e_rrs["R"] <= GATE and e_rrs["ieR"] <= IE_GATE
            and e_rrs["R+ieR"] <= GATE
            and e_full["R"] <= GATE and e_full["ieR"] <= GATE):
        fail(f"RRS kernel path vs plain path: {e_rrs}, fullres {e_full}")
    ref = np.load(Path(__file__).resolve().parent / "vsmartmom_tpu_torch"
                  / "data" / "rrs_ref_f64.npz")
    small = rrs_ref_model(ref["R"].shape[-1])
    e_sref = {k: rel(v, ref[k]) for k, v in zip(
        ("R", "T", "ieR", "ieT"),
        rt_run_inelastic(small, device=dev, ie_fullres=True))}
    print("RRS kernel path (ie_fullres) vs JAX f64 reference (nSpec=16): "
          + " ".join(f"{k}={e:.2e}" for k, e in e_sref.items()), flush=True)
    if not (e_sref["R"] <= GATE and e_sref["ieR"] <= GATE):
        fail(f"RRS port vs stored JAX reference: {e_sref}")

    counted = {"fused_moment": fused_band.fused_moment,
               "fused_moment_rrs": fused_rrs.fused_moment_rrs,
               "rrs_diagonal": fused_rrs._launch_diagonal,
               "fused_moment_multitangent":
                   fused_lin.fused_moment_multitangent}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    R, T, dR, dT = rt_run_lin(lin_model, layout=layout, device=dev)
    torch.cuda.synchronize()
    lin_e2e_s = time.perf_counter() - t0
    lin_launches = {k: fn.launches for k, fn in counted.items()}
    want_lin = {"fused_moment": 0, "fused_moment_rrs": 0, "rrs_diagonal": 0,
                "fused_moment_multitangent": lin_config.m_scat + 1}
    print(f"main path: rt_run_lin nSpec={LIN_N_SPEC}, {n_par} parameters, "
          f"launches {lin_launches} (want {want_lin}), {lin_e2e_s:.1f} s",
          flush=True)
    if lin_launches != want_lin:
        fail(f"Jacobian path launches {lin_launches}, want {want_lin}")
    if dR.shape != (9, 4, LIN_N_SPEC, n_par) or not all(
            np.isfinite(x).all() for x in (R, T, dR, dT)):
        fail(f"rt_run_lin outputs not finite or dR of shape {dR.shape}")
    kern = fused_lin.rt_solve_multitangent(*lin_slice[:1], slice_tans,
                                           lin_slice[1], dev)
    plain = rt_solve_jvp(lin_slice[0], slice_tans,
                         dataclasses.replace(lin_slice[1], fused=False), dev)
    e_route = [rel(kern[0], plain[0])] + [rel(kern[2][q], plain[2][q])
                                          for q in range(n_par)]
    print(f"Jacobian kernel route vs plain jvp route (nSpec={LIN_SLICE}): "
          f"R={e_route[0]:.2e} dR per parameter "
          + " ".join(f"{e:.2e}" for e in e_route[1:])
          + f"; dT={rel(kern[3], plain[3]):.2e}", flush=True)
    if not (e_route[0] <= GATE and all(e <= TAN_GATE for e in e_route[1:])):
        fail(f"Jacobian kernel route vs plain route: {e_route}")
    fused_band.fused_moment.launches = 0
    R_fwd, _ = rt_run(lin_model, device=dev, spectral_chunk=LIN_N_SPEC)
    e_fwd = rel(R, R_fwd)
    print(f"rt_run of the aerosol flagship: fused_moment launches="
          f"{fused_band.fused_moment.launches} (want "
          f"{lin_config.m_scat + 1}), R vs rt_run_lin's R {e_fwd:.2e}",
          flush=True)
    if fused_band.fused_moment.launches != lin_config.m_scat + 1 \
            or not e_fwd <= GATE:
        fail(f"rt_run vs rt_run_lin on the aerosol flagship: {e_fwd}")
    ref = np.load(Path(__file__).resolve().parent / "vsmartmom_tpu_torch"
                  / "data" / "lin_ref_f64.npz")
    small_model = lin_ref_model()
    small = dict(zip(("R", "T", "dR", "dT"),
                     rt_run_lin(small_model, device=dev)))
    names = default_layout(small_model).names()
    e_lref, own, control, ok = lin_ref_gates(small, ref, names)
    print("Jacobian kernel path vs JAX f64 reference (small aerosol scene): "
          + " ".join(f"{k}={e:.2e}" for k, e in e_lref.items())
          + "; dR per parameter on its own scale "
          + " ".join(f"{n}={e:.2e}" for n, e in zip(names, own))
          + "; height dR 1% off " + " ".join(f"{e:.2e}" for e in control),
          flush=True)
    if not ok:
        fail(f"Jacobian port vs stored JAX reference: {e_lref}, per "
             f"parameter {own}, control {control}")

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
    k1_bytes = moment_bytes(args, out)
    t_ops, t_bytes = flops / FP32_PEAK_FLOPS * 1e3, \
        k1_bytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(json.dumps({
        "card": smi, "pts_per_s": pts_per_s, "solve_s": min(times[1:]),
        "rt_run_e2e_s": e2e_s, "n_spec": N_SPEC_TOTAL,
        "moment_launch": {"n_spec": N_CHUNK, "kernel_ms": k_ms,
                          "plain_ms": p_ms, "bound_ms": bound_ms,
                          "bound_share": bound_ms / k_ms,
                          "flops": flops, "bytes": k1_bytes,
                          "achieved_tflops": flops / k_ms / 1e9,
                          "plan": k1_plan, "f64_kernel_plain": k1_f64}}),
        flush=True)

    times = []
    for _ in range(4):                           # 1 warm-up + best of 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = rt_solve_rrs_fused(rrs_inputs, rrs_config, *rrs, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(o["ieR"]).all()):
            fail("non-finite ieR in the timed RRS solve")
    rrs_pts_per_s = RRS_N_SPEC / min(times[1:])
    t0 = time.perf_counter()
    rt_run_inelastic(rrs_model, device=dev)
    rrs_e2e_s = time.perf_counter() - t0

    args, kw = rrs_args[0]
    ops = fused_rrs.rrs_operands(*args, **{k: v for k, v in kw.items()
                                          if k not in ("ns_sched",
                                                       "ns_inter")})
    sched = fused_rrs.norm_sched(kw["ns_sched"], kw["ndoubl"])
    k3_pl, k3_pairs, k3_threads = fused_rrs.kernel_plan(
        ops, args[11], sched, kw["ns_inter"])
    k3_ms = cuda_time_ms(lambda: fused_rrs._launch_kernel(
        ops, args[11], sched, kw["ns_inter"]), reps=3)
    store = fused_rrs._launch_diagonal(ops, k3_pl)
    k3_diag_ms = cuda_time_ms(lambda: fused_rrs._launch_diagonal(ops, k3_pl),
                              reps=3)
    k3_pair_ms = cuda_time_ms(lambda: fused_rrs._launch_pairs(
        ops, k3_pl, k3_pairs, k3_threads, store), reps=3)
    k3_plain_ms = cuda_time_ms(lambda: fused_rrs.moment_rrs_body_reference(
        ops, sched, kw["ns_inter"]), reps=3)
    # The split plain version's two halves (the kernels' plain versions).
    ref_store = fused_rrs.diagonal_store(ops, k3_pl)
    k3_diag_plain_ms = cuda_time_ms(
        lambda: fused_rrs.diagonal_store(ops, k3_pl), reps=2)
    k3_pair_plain_ms = cuda_time_ms(lambda: fused_rrs.pair_recurrence(
        ops, k3_pl, k3_pairs, ref_store), reps=2)
    N3, LD3 = rrs_config.N, (rrs_config.N + 3) & ~3
    kern_m = store[0].reshape(*store[0].shape[:2], N3, LD3)[..., :N3]
    diag_abs_err = float((kern_m - ref_store[0]).abs().max())
    diag_rel = rel(kern_m, ref_store[0])
    if not (np.isfinite(diag_rel) and diag_rel <= GATE):
        fail(f"K3's diagonal store vs diagonal_store: {diag_rel}")
    out = fused_rrs._launch_pairs(ops, k3_pl, k3_pairs, k3_threads, store)
    n_on = int(k3_pairs.shape[0])
    k3_flops = {c: rrs_flops(ops, RRS_N_SPEC, n_on, sched, kw["ns_inter"],
                             c)
                for c in ("least", "pairs", "points", "block", "dense")}
    in_bytes = nbytes(*ops)
    k3_bytes = in_bytes + nbytes(*out)
    store_bytes = nbytes(*store)
    # The diagonal launch reads the points' l1 row tables (pairs 0..s-1).
    diag_in = nbytes(ops.Z_pp, ops.Z_mp, ops.geom, ops.d_vec, ops.src_jp,
                     ops.src_jm, ops.src_ek, ops.w_over[:, :, :RRS_N_SPEC, 1],
                     ops.Em1[:, :RRS_N_SPEC, N3:],
                     ops.dtau[:, :RRS_N_SPEC, 1])
    bounds = {}
    for part, flops, nb in (("all", k3_flops["least"], k3_bytes),
                            ("pairs", k3_flops["pairs"],
                             in_bytes + nbytes(*out) + store_bytes),
                            ("points", k3_flops["points"],
                             diag_in + store_bytes)):
        t_ops, t_mem = flops / FP32_PEAK_FLOPS * 1e3, nb / HBM_BYTES_PER_S * 1e3
        bounds[part] = (max(t_ops, t_mem),
                        "operations" if t_ops >= t_mem else "bytes", nb)
    k3_bound = bounds["all"][0]
    print(json.dumps({
        "card": smi, "rrs_pts_per_s": rrs_pts_per_s,
        "rrs_solve_s": min(times[1:]), "rrs_solve_all_s": times,
        "rt_run_inelastic_e2e_s": rrs_e2e_s, "n_spec": RRS_N_SPEC,
        "n_shifts": n_shifts, "launches": rrs_launches,
        "rrs_launch": {"pairs": n_shifts * RRS_N_SPEC, "pairs_on_grid": n_on,
                       "kernel_ms": k3_ms, "diag_ms": k3_diag_ms,
                       "pair_ms": k3_pair_ms, "plain_ms": k3_plain_ms,
                       "diag_plain_ms": k3_diag_plain_ms,
                       "pair_plain_ms": k3_pair_plain_ms,
                       "bound_ms": k3_bound,
                       "bound_share": k3_bound / k3_ms,
                       "diag_bound_ms": bounds["points"][0],
                       "pair_bound_ms": bounds["pairs"][0],
                       "flops": k3_flops["least"],
                       "flops_pairs": k3_flops["pairs"],
                       "flops_points": k3_flops["points"],
                       "flops_block": k3_flops["block"],
                       "flops_dense": k3_flops["dense"],
                       "bytes": k3_bytes, "store_bytes": store_bytes,
                       "diag_store_err": diag_rel,
                       "achieved_tflops": k3_flops["least"] / k3_ms / 1e9,
                       "achieved_tflops_pairs": k3_flops["pairs"]
                       / k3_pair_ms / 1e9,
                       "plan": {**k3_plan, "records": len(k3_pl.table),
                                "phases": k3_pl.n_phases,
                                "prefetched": k3_pl.n_prefetched,
                                "staged_matrices_a_pair": k3_pl.n_stage_mats,
                                "store_entries": [k3_pl.n_mat_entries,
                                                  k3_pl.n_vec_entries]},
                       "f64_kernel_plain": k3_f64}}),
        flush=True)
    times = []
    for _ in range(3):                           # 1 warm-up + best of 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fused_lin.rt_solve_multitangent(lin_inputs, lin_tans, lin_config,
                                            dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(o[2]).all()):
            fail("non-finite dR in the timed Jacobian solve")
    lin_solve_s = min(times[1:])
    args = fused_lin.multitangent_args(lin_inputs, lin_tans, lin_config, 0,
                                       dev)
    k2_ms = cuda_time_ms(lambda: fused_lin._launch_kernel(*args), reps=3)
    k2_plain_ms = cuda_time_ms(
        lambda: fused_lin.moment_multitangent_reference(*args), reps=2)
    out = fused_lin._launch_kernel(*args)
    k2_plan = mt_plan_report(lin_config, n_par)
    primal_flops = moment_flops(lin_config, LIN_N_SPEC)
    k2_flops = (1 + 2 * n_par) * primal_flops
    k2_bytes = sum(x.numel() * x.element_size()
                   for x in (*args[0], *args[1], *out[0], *out[1]))
    k2_ops, k2_mem = k2_flops / FP32_PEAK_FLOPS * 1e3, \
        k2_bytes / HBM_BYTES_PER_S * 1e3
    k2_bound = max(k2_ops, k2_mem)
    print(json.dumps({
        "card": smi, "lin_pts_per_s": LIN_N_SPEC / lin_solve_s,
        "lin_tangent_pts_per_s": LIN_N_SPEC * n_par / lin_solve_s,
        "lin_solve_s": lin_solve_s, "lin_solve_all_s": times,
        "rt_run_lin_e2e_s": lin_e2e_s, "scene_build_s": lin_scene_s,
        "tangent_build_s": lin_tangent_s, "n_spec": LIN_N_SPEC,
        "n_params": n_par, "launches": lin_launches,
        "mt_launch": {"n_spec": LIN_N_SPEC, "kernel_ms": k2_ms,
                      "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
                      "bound_share": k2_bound / k2_ms, "flops": k2_flops,
                      "flops_kernel": k2_plan["work"] * primal_flops,
                      "bytes": k2_bytes,
                      "achieved_tflops": k2_flops / k2_ms / 1e9,
                      "achieved_tflops_kernel": k2_plan["work"]
                      * primal_flops / k2_ms / 1e9,
                      "plan": k2_plan}}), flush=True)
    k5_entry = ms_phase(dev, smi)
    k4_entry = layer_chain_phase(dev, smi, inputs, config)
    probe_entries = probes_phase(smi)
    k1p_entry = thermal_lin_phase(dev, smi)
    print(f"chip_smoke.py: {time.perf_counter() - script_t0:.1f} s, the "
          "kernels' build included", flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_moment", "route": "cuda",
        "source": "vsmartmom_tpu_torch/csrc/fused_band.cu",
        "replaces": "vsmartmom_tpu/ops/fused_band.py:469",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None}, {
        "name": "fused_moment_rrs", "route": "cuda",
        "source": "vsmartmom_tpu_torch/csrc/fused_rrs.cu",
        "replaces": "vsmartmom_tpu/ops/fused_rrs.py:366",
        "launches": rrs_launches["fused_moment_rrs"],
        "max_abs_err": rrs_abs_err, "ms": k3_pair_ms,
        "plain_ms": k3_pair_plain_ms, "bound_ms": bounds["pairs"][0],
        "bound_by": bounds["pairs"][1], "library_ms": None}, {
        "name": "rrs_diagonal", "route": "cuda",
        "source": "vsmartmom_tpu_torch/csrc/fused_rrs.cu",
        "replaces": "vsmartmom_tpu/ops/fused_rrs.py:366",
        "launches": rrs_launches["rrs_diagonal"],
        "max_abs_err": diag_abs_err, "ms": k3_diag_ms,
        "plain_ms": k3_diag_plain_ms, "bound_ms": bounds["points"][0],
        "bound_by": bounds["points"][1], "library_ms": None}, {
        "name": "fused_moment_multitangent", "route": "cuda",
        "source": "vsmartmom_tpu_torch/csrc/fused_lin.cu",
        "replaces": "vsmartmom_tpu/ops/fused_lin.py:214",
        "launches": lin_launches["fused_moment_multitangent"],
        "max_abs_err": k2_abs_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound,
        "bound_by": "operations" if k2_ops >= k2_mem else "bytes",
        "library_ms": None}, k1p_entry, k5_entry, k4_entry,
        *probe_entries]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
