"""Per-stage timing table (the reference's TimerOutputs equivalent).

Counterpart of ``vsmartmom_tpu/utils/timing.py``. The reference wraps each
solver stage in ``TimerOutputs.@timeit`` and prints the table when
``numerics.verbose`` is set (rt_run.jl:294-528, print_timer at l.528).
Here the model build (``rayleigh[i]``, ``absorption[i]``, ``mie[i]``,
``surface[i]``) and ``rt_run_full`` (``build_band[i]``, ``rt_solve[i]``)
run their stages under ``stage``, nested names joined by "/", into one
registry; ``report()`` renders it and ``reset()`` clears it.

A stage that launches work on a CUDA device passes
``sync=torch.cuda.synchronize``, which runs when the stage ends, so its
time is the device's as well as the host's. The sync is made only while
timing is on (``Parameters(verbose=True)`` or the environment variable
``VSM_TIMING``, which ``enabled()`` reads: the port's one environment
switch); off, a stage costs two clock reads and no sync.
"""

import os
import time
from collections import OrderedDict
from contextlib import contextmanager

_REGISTRY: "OrderedDict[str, list]" = OrderedDict()
_STACK: list = []


def enabled() -> bool:
    """Whether ``VSM_TIMING`` asks for the table."""
    return bool(os.environ.get("VSM_TIMING"))


def reset() -> None:
    _REGISTRY.clear()


@contextmanager
def stage(name: str, sync=None, on: bool = None):
    """Time the block as stage ``name`` (nested under any open stage).
    ``sync`` (e.g. ``torch.cuda.synchronize``) runs before the clock stops,
    but only while timing is on (``on``, default ``enabled()``), so a hot
    loop with timing off never waits on the device."""
    _STACK.append(name)
    full = "/".join(_STACK)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None and (enabled() if on is None else on):
            sync()
        _REGISTRY.setdefault(full, []).append(time.perf_counter() - t0)
        _STACK.pop()


def record(name: str, seconds: float) -> None:
    _REGISTRY.setdefault(name, []).append(seconds)


def report(min_ms: float = 0.01) -> str:
    """The timing table (the reference's print_timer layout: stage, calls,
    total time, share of the top-level stages)."""
    if not _REGISTRY:
        return "(no stages recorded)"
    total = sum(sum(v) for k, v in _REGISTRY.items() if "/" not in k)
    lines = [f"{'stage':<42s} {'ncalls':>6s} {'time':>10s} {'%tot':>6s}",
             "-" * 68]
    for name, vals in _REGISTRY.items():
        t = sum(vals)
        if t * 1e3 < min_ms:
            continue
        indent = "  " * name.count("/")
        short = indent + name.rsplit("/", 1)[-1]
        share = 100.0 * t / total if total else 0.0
        lines.append(f"{short:<42s} {len(vals):>6d} {t*1e3:>8.1f}ms "
                     f"{share:>5.1f}%")
    lines.append("-" * 68)
    lines.append(f"{'total (top-level)':<42s} {'':>6s} {total*1e3:>8.1f}ms")
    return "\n".join(lines)
