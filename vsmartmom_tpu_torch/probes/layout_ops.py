"""P5 (scripts/probe_mosaic_casts.py): the sixteen shape casts, broadcasts,
concatenations, dots and reductions the band kernels use, each at the
script's widths (B = 32, N = 24) through the layout kernel against its
torch expression. On the TPU the question was which ones Mosaic lowers;
here every case must write exactly what the JAX lambda writes. The inputs
sit on a 1/256 grid in [0, 1), so every sum of the dot and reduce cases is
exact in f32 whatever its order and the match is exact. Each case moves a
few KB and is bound by its launch. The library yardstick times the same
work as the kernel: the case's torch expression written out to a new
contiguous tensor (``written_out``; 7 of the 16 expressions are views of
their input and copy nothing by themselves). The plain version is the
expression made contiguous.
"""

import numpy as np
import torch

from ..ops.probe_dots import matmul_tf32
from ..ops.probe_layout import B, CASES, N, layout_op, layout_op_reference
from ..core.types import resolve_device
from . import common


def inputs(case, dev, b=B, n=N):
    rng = np.random.default_rng(case)
    return [torch.from_numpy((rng.integers(0, 256, s) / 256).astype(
        np.float32)).to(dev) for s in CASES[case].in_shapes(b, n)]


def shares_input(out, ins):
    """Whether ``out`` is a view of one of ``ins`` (writes nothing)."""
    return any(out.untyped_storage().data_ptr()
               == x.untyped_storage().data_ptr() for x in ins)


def written_out(case, ins):
    """The library yardstick of ``case``: one call of its torch expression
    that writes the result, as the kernel does, to a new contiguous tensor
    (a view is copied out)."""
    if shares_input(case.plain(*ins), ins):
        return lambda: case.plain(*ins).clone(
            memory_format=torch.contiguous_format)
    return lambda: case.plain(*ins)


def run(device=None):
    dev = resolve_device(device)
    cases = []
    for i, case in enumerate(CASES):
        ins = inputs(i, dev)
        kern = common.time_ms(lambda: layout_op(i, *ins), dev)
        plain = common.time_ms(lambda: layout_op_reference(i, *ins), dev)
        with matmul_tf32(False):
            library = common.time_ms(written_out(case, ins), dev)
        out, ref = kern.out, plain.out
        ref64 = layout_op_reference(i, *(x.double() for x in ins))
        cases.append({
            "case": case.name, "shape": list(out.shape),
            **common.timing(kern.ms, 0.0, common.nbytes(*ins, out),
                            common.PEAK_FLOPS["fp32"]),
            **common.timed_fields(kern, plain, library),
            "view": shares_input(case.plain(*ins), ins),
            "exact": bool(torch.equal(out, ref)),
            "max_abs_err": float((out - ref).abs().max()),
            "err_f64": common.rel(out, ref64)})
    return {"probe": "layout_ops", "device": common.device_name(dev),
            "P5": cases}


def main():
    common.print_result(run())


if __name__ == "__main__":
    main()
