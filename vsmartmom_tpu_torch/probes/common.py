"""What the Hopper probes share: timing on the card, errors, bounds, the
library yardstick and the checks of a dot chain against its plain version.

A probe runs on CUDA unless it is given a device; on the CPU its kernels'
wrappers run their plain versions and no time is taken (``ms`` and the
other times are None: a CPU time is no device metric).
"""

import dataclasses
import json
import time

import torch

from ..ops.probe_dots import (MODE_OF_PRECISION, dot_chain,
                              dot_chain_plan, dot_chain_reference,
                              lane_dot_chain, lane_dot_chain_plan,
                              lane_dot_chain_reference, launch_info,
                              matmul_tf32)

#: H100 SXM peaks (NVIDIA data sheet, dense): FP32 outside the tensor cores,
#: TF32 on them (3xtf32 does three TF32 products per useful one), and HBM3.
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "3xtf32": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
#: Timed launches per case after one warm-up.
REPS = 3
#: Chain lengths besides 1 and the whole chain at which a chain is checked.
CHECK_AT = 8
#: Gate of a kernel against its plain version, of max|plain|.
GATE = 1e-5


@dataclasses.dataclass
class Timed:
    """What ``time_ms`` measured of a function."""
    ms: float | None    # device ms per call (None on the CPU)
    out: object         # the last call's output
    calls: int          # calls of the function made
    #: Whether the device ran the timed calls back to back: the host had
    #: queued them all before the device reached the first (None on the CPU).
    device_only: bool | None = None


#: Cycles of ``torch.cuda._sleep`` per device ms, by device (measured once).
_SLEEP_CYCLES_PER_MS = {}
#: The longest lead (ms) the device sleeps ahead of the timed calls.
MAX_LEAD_MS = 200.0


def _sleep_cycles_per_ms(dev):
    if dev not in _SLEEP_CYCLES_PER_MS:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        e0.record()
        torch.cuda._sleep(10 ** 6)
        e1.record()
        torch.cuda.synchronize(dev)
        _SLEEP_CYCLES_PER_MS[dev] = 1e6 / e0.elapsed_time(e1)
    return _SLEEP_CYCLES_PER_MS[dev]


def time_ms(fn, dev):
    """The mean device time of fn() over REPS calls after one warm-up.

    A small kernel takes less device time than its wrapper's host work, so
    back-to-back calls would time the host. Here the device first sleeps
    (``torch.cuda._sleep``) while the host queues the REPS calls, and CUDA
    events bracket them: the events time the device's work alone, provided
    the host queued every call before the device woke. That is checked (the
    first event not yet reached when the last call returns), and the lead
    is made four times longer and the calls retried, up to MAX_LEAD_MS,
    where it was not. ``device_only`` says whether the last try was clean
    (a function that synchronises never is). On the CPU one call and no
    time."""
    if dev.type != "cuda":
        return Timed(None, fn(), 1)
    with torch.cuda.device(dev):
        t0 = time.perf_counter()
        out = fn()
        host_ms = (time.perf_counter() - t0) * 1e3   # to queue one call
        torch.cuda.synchronize(dev)
        calls = 1
        lead = min(1.0 + 2 * REPS * host_ms, MAX_LEAD_MS)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        while True:
            torch.cuda._sleep(int(lead * _sleep_cycles_per_ms(dev)))
            e0.record()
            for _ in range(REPS):
                out = fn()
            calls += REPS
            ahead = not e0.query()
            e1.record()
            torch.cuda.synchronize(dev)
            if ahead or lead >= MAX_LEAD_MS:
                return Timed(e0.elapsed_time(e1) / REPS, out, calls, ahead)
            lead = min(4 * lead, MAX_LEAD_MS)


def rel(got, want):
    """max|got - want| / max|want| in f64 (0 when both are all zero)."""
    got, want = got.double(), want.double()
    d = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return d / scale if scale > 0 else d


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def bound(flops, n_bytes, peak):
    """(bound ms, what bounds it): the larger of the operations over the
    peak rate and the bytes over the HBM rate."""
    t_ops = flops / peak * 1e3
    t_mem = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes"


def timing(ms, flops, n_bytes, peak):
    """The timing fields of one case."""
    b_ms, by = bound(flops, n_bytes, peak)
    return {"ms": ms, "flops": flops, "bytes": n_bytes, "bound_ms": b_ms,
            "bound_by": by,
            "tflops": flops / ms / 1e9 if ms else None,
            "bound_share": b_ms / ms if ms else None}


def library_chain(x, y, form, tf32, chain=1, scale=1.0, ndot=1):
    """The library yardstick of a dot chain: the same chain as torch.bmm
    calls with TF32 tensor cores allowed or not (the XLA variants of
    scripts/probe_batched_dot.py)."""
    with matmul_tf32(tf32):
        if form in ("right", "single"):
            for _ in range(chain):
                x = torch.bmm(x, y) * scale
            return x
        if form == "left":
            acc = y
            for _ in range(chain):
                acc = torch.bmm(x, acc)
            return acc
        acc = torch.zeros_like(y)
        for k in range(ndot):
            acc = acc + torch.bmm(x + float(k), y)
        return acc


def library_lane_chain(x, a, chain, scale):
    """The library yardstick of the lane chain: the points moved to the
    batch axis once, torch.bmm in FP32, moved back."""
    with matmul_tf32(False):
        xs = x.permute(2, 0, 1).contiguous()
        As = a.permute(2, 0, 1).contiguous()
        for _ in range(chain):
            xs = torch.bmm(xs, As) * scale
        return xs.permute(1, 2, 0).contiguous()


def plan_fields(plan, dev, kind, *args):
    """A case's launch plan: the host plan's rows and columns (or points)
    per block, grid, threads and dynamic shared bytes, and on the card what
    the C side makes of it (``c_grid``, ``c_threads``, ``c_smem``, which
    must agree) with its resident blocks per SM."""
    out = {"rows": plan.rows, "cols": plan.cols, "points": plan.points,
           "grid": list(plan.grid), "threads": plan.threads,
           "smem": plan.smem, "blocks": plan.blocks}
    if dev.type == "cuda":
        grid, threads, smem, per_sm = launch_info(kind, *args, plan)
        out.update(c_grid=list(grid), c_threads=threads, c_smem=smem,
                   blocks_per_sm=per_sm)
    return out


def _lengths(form, chain):
    if form in ("sum", "single") or chain == 1:
        return [chain]
    return sorted({1, min(CHECK_AT, chain), chain})


def _chain_checks(out, ref, lengths, kernel, plain, exact, step):
    """The checks of a chain whose whole-length kernel and plain results
    are ``out`` and ``ref``: at each length L kernel(L) against plain(L) and
    against exact(L) (f64), and for L > 1 the kernel's last step from its
    own result at L - 1, ``step(prev)`` = (kernel step, plain step), against
    the plain step and, bit for bit, against kernel(L)."""
    chain = lengths[-1]
    err_plain, err_f64, err_step, bitwise = {}, {}, {}, {}
    max_abs = 0.0
    for L in lengths:
        k_L = out if L == chain else kernel(L)
        p_L = ref if L == chain else plain(L)
        err_plain[L] = rel(k_L, p_L)
        err_f64[L] = rel(k_L, exact(L))
        max_abs = max(max_abs, float((k_L - p_L).abs().max()))
        if L > 1:
            k_one, p_one = step(kernel(L - 1))
            bitwise[L] = bool(torch.equal(k_one, k_L))
            err_step[L] = rel(k_one, p_one)
    return {"err_plain": err_plain, "err_step": err_step,
            "step_bitwise": bitwise, "err_f64": err_f64,
            "max_abs_err": max_abs,
            "underflow": bool(out.abs().max() == 0)}


def timed_fields(kernel, plain, library=None, check_calls=0):
    """The fields a case takes from its Timed kernel, plain and library
    runs: the plain and library times, whether each was timed on the
    device alone, and how many times it called the kernel's wrapper (timed
    calls and ``check_calls`` more for its checks)."""
    runs = {"kernel": kernel, "plain": plain, "library": library}
    return {"plain_ms": plain.ms,
            "library_ms": library.ms if library else None,
            "device_only": {k: t.device_only for k, t in runs.items() if t},
            "kernel_calls": kernel.calls + check_calls}


def dot_case(label, precision, x, y, form, chain=1, scale=1.0, ndot=1,
             f64=None):
    """One case of a dot probe: dot_chain at ``precision``'s mode on
    (x, y), timed, against its plain version, the f64 chain and the
    library yardstick. Chains are checked at length 1, CHECK_AT and the
    whole chain: the kernel's and the plain chain's results, and the
    kernel's last step from the kernel's own result one step earlier
    against the plain step from the same operands (the kernel's chain must
    equal its own steps bit for bit). A TF32 chain's drift from the plain
    chain is recorded, not gated: one FP32 ulp of a different summation
    order can move an operand to the neighbouring TF32 value, 2^-11 apart,
    and the chain carries that on. ``f64`` caches the f64 chains by length
    across the modes of one input."""
    mode = MODE_OF_PRECISION[precision]
    dev = x.device
    kw = dict(form=form, mode=mode, chain=chain, scale=scale, ndot=ndot)
    run = time_ms(lambda: dot_chain(x, y, **kw), dev)
    plain = time_ms(lambda: dot_chain_reference(x, y, **kw), dev)
    library = time_ms(lambda: library_chain(
        x, y, form, mode == "tf32", chain, scale, ndot), dev)
    f64 = {} if f64 is None else f64
    check_calls = 0

    def kernel(L, a=x, b=y):
        nonlocal check_calls
        check_calls += 1
        return dot_chain(a, b, **dict(kw, chain=L))

    def exact(L):
        if L not in f64:
            f64[L] = dot_chain_reference(x.double(), y.double(),
                                         **dict(kw, chain=L, mode="fp32"))
        return f64[L]

    def step(prev):
        a, b = (prev, y) if form == "right" else (x, prev)
        return kernel(1, a, b), dot_chain_reference(a, b, **dict(kw, chain=1))

    checks = _chain_checks(
        run.out, plain.out, _lengths(form, chain), kernel,
        lambda L: dot_chain_reference(x, y, **dict(kw, chain=L)), exact,
        step)
    batch, n, c = x.shape[0], x.shape[1], y.shape[-1]
    flops = 2.0 * batch * n * n * c * (ndot if form == "sum" else chain)
    plan = dot_chain_plan(batch, n, c, form, mode)
    return {"case": label, "precision": str(precision), "mode": mode,
            "form": form, "shape": list(y.shape), "chain": chain,
            "ndot": ndot, **timing(run.ms, flops, nbytes(x, y, run.out),
                                   PEAK_FLOPS[mode]),
            **timed_fields(run, plain, library, check_calls), **checks,
            "plan": plan_fields(plan, dev, "dot", batch, n, c, form, mode)}


def lane_case(label, x, a, chain, scale):
    """One case of a lane probe: lane_dot_chain (FP32) timed, against its
    plain version, the f64 chain and the library yardstick, checked as
    ``dot_case`` checks an fp32 chain."""
    dev = x.device
    run = time_ms(lambda: lane_dot_chain(x, a, chain, scale), dev)
    plain = time_ms(lambda: lane_dot_chain_reference(x, a, chain, scale),
                    dev)
    library = time_ms(lambda: library_lane_chain(x, a, chain, scale), dev)
    check_calls = 0

    def kernel(L, x0=x):
        nonlocal check_calls
        check_calls += 1
        return lane_dot_chain(x0, a, L, scale)

    checks = _chain_checks(
        run.out, plain.out, _lengths("right", chain), kernel,
        lambda L: lane_dot_chain_reference(x, a, L, scale),
        lambda L: lane_dot_chain_reference(x.double(), a.double(), L, scale),
        lambda prev: (kernel(1, prev),
                      lane_dot_chain_reference(prev, a, 1, scale)))
    n, s = x.shape[0], x.shape[2]
    flops = 2.0 * n ** 3 * s * chain
    plan = lane_dot_chain_plan(n, s)
    return {"case": label, "precision": "highest", "mode": "fp32",
            "form": "lane", "shape": list(x.shape), "chain": chain,
            **timing(run.ms, flops, nbytes(x, a, run.out),
                     PEAK_FLOPS["fp32"]),
            **timed_fields(run, plain, library, check_calls), **checks,
            "plan": plan_fields(plan, dev, "lane", n, s)}


def chain_failures(case, gate=GATE):
    """The gates a dot or lane case misses: kernel vs plain <= gate at every
    checked length (a TF32 chain at length 1 only), every last step <= gate
    and equal bit for bit to the kernel's own chain."""
    bad = []
    for L, e in case["err_plain"].items():
        if (case["mode"] != "tf32" or L == 1) and not e <= gate:
            bad.append(f"{case['case']}: kernel vs plain at length {L} {e}")
    for L, e in case["err_step"].items():
        if not e <= gate:
            bad.append(f"{case['case']}: last step at length {L} {e}")
        if not case["step_bitwise"][L]:
            bad.append(f"{case['case']}: chain of {L} is not its own steps")
    return bad


def device_name(dev):
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def print_result(result):
    print(json.dumps(result, default=str), flush=True)
