"""P2 (scripts/probe_dot_prec_speed.py): does the product rate depend on
the precision, and what is the ceiling of the (B = 8, N = 104) batched
products? A chain acc <- x @ acc of CHAIN products from acc = y, for GRID
x B independent pairs, at "highest", "high", None and "float32". With
x = 0.01 N(0, 1) the chain shrinks ~10x a step and underflows f32 before
its 64th, so it is also checked at 8 steps (``common.CHECK_AT``).
"""

import numpy as np
import torch

from ..core.types import resolve_device
from . import common

B, N, CHAIN, GRID = 8, 104, 64, 64
PRECISIONS = ("highest", "high", None, "float32")


def run(device=None, grid=GRID, chain=CHAIN):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = 0.01 * rng.standard_normal((grid, B, N, N)).astype(np.float32)
    y = rng.standard_normal((grid, B, N, N)).astype(np.float32)
    x, y = (torch.from_numpy(a.reshape(grid * B, N, N)).to(dev)
            for a in (x, y))
    f64 = {}
    cases = [common.dot_case(f"N={N} {p}", p, x, y, "left", chain,
                             f64=f64) for p in PRECISIONS]
    return {"probe": "dot_prec_speed", "device": common.device_name(dev),
            "P2": cases}


def main():
    common.print_result(run())


if __name__ == "__main__":
    main()
