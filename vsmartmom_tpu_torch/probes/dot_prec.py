"""P6 (scripts/probe_mosaic_dot_prec.py): does each dot precision do what
it says? One batched product (B, N, N) @ (B, N, N) of standard normals
against the f64 product, at the script's precisions ("highest" and
"float32" -> fp32, None -> tf32) and "high" (3xtf32), which the script
does not try, so that one input answers for every mode.
"""

import numpy as np
import torch

from ..core.types import resolve_device
from . import common

B, N = 8, 104
PRECISIONS = ("highest", "float32", "high", None)


def run(device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, N, N)).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal((B, N, N)).astype(
        np.float32)).to(dev)
    f64 = {}
    cases = [common.dot_case(f"N={N} {p}", p, x, y, "single",
                             f64=f64) for p in PRECISIONS]
    return {"probe": "dot_prec", "device": common.device_name(dev),
            "P6": cases}


def main():
    common.print_result(run())


if __name__ == "__main__":
    main()
