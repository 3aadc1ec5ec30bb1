"""P3 (scripts/probe_dot_prec_speed2.py): the product rate with NDOT
independent products per pair instead of a chain, acc = sum_k (x + k) @ y,
on (B, N, N) @ (B, N, C) for GRID x B pairs, C = N and 3N (the band
kernel's ladder shapes), at "highest" and None. At C = 312 one pair's
operands exceed a block's shared memory, so the kernel tiles the columns.
"""

import numpy as np
import torch

from ..core.types import resolve_device
from . import common

B, N, GRID = 8, 104, 64
NDOT = 16
PRECISIONS = ("highest", None)


def run(device=None, grid=GRID, ndot=NDOT):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    cases = []
    for C in (N, 3 * N):
        x = rng.standard_normal((grid, B, N, N)).astype(np.float32)
        y = rng.standard_normal((grid, B, N, C)).astype(np.float32)
        x = torch.from_numpy(x.reshape(grid * B, N, N)).to(dev)
        y = torch.from_numpy(y.reshape(grid * B, N, C)).to(dev)
        f64 = {}
        cases += [common.dot_case(f"C={C} {p}", p, x, y, "sum", ndot=ndot,
                                  f64=f64) for p in PRECISIONS]
    return {"probe": "dot_prec_speed2", "device": common.device_name(dev),
            "P3": cases}


def main():
    common.print_result(run())


if __name__ == "__main__":
    main()
