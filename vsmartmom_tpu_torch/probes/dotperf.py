"""P8 and P9 (scripts/probe_dotperf.py): the per-point small-product rate
at N = 52, as a chain of CHAIN products per point scaled by 0.25, in two
formulations: row-major (s, N, N) products in shared-memory tiles at each
dot mode (P8, ``mxu_kernel``) and the spectral-axis-last (N, N, s) lane
chain (P9, ``vpu_kernel``). On the TPU this was the compute ceiling of the
fused RT kernels; here the fp32 case is the product loop of K1, K4 and K5
in isolation (4 x 8 register tiles, A k-major), the tf32 and 3xtf32 cases
the wgmma tile of ``csrc/hopper_mma.cuh`` that their redesigns would take,
and P9 the same fp32 loop behind the lane layout's loads (the chain kept
on chip, P8 fp32 its yardstick).
Both chains underflow f32 to zero before their 64th step (each step scales
by ~0.125), so they are also checked at 8 steps (``common.CHECK_AT``).
"""

import numpy as np
import torch

from ..core.types import resolve_device
from . import common

N = 52
CHAIN = 64
S = 2048
SCALE = 0.25
#: The script's precisions, in its order.
PRECISIONS = ("default", "high", "highest")


def run(device=None, s=S, chain=CHAIN):
    dev = resolve_device(device)
    a = torch.from_numpy((np.random.default_rng(0).random((s, N, N)) / N)
                         .astype(np.float32)).to(dev)
    f64 = {}
    p8 = [common.dot_case(f"N={N} {p}", p, a, a, "right", chain, SCALE,
                          f64=f64) for p in PRECISIONS]
    del f64
    lanes = torch.from_numpy((np.random.default_rng(0).random((N, N, s)) / N)
                             .astype(np.float32)).to(dev)
    p9 = [common.lane_case(f"N={N} lanes", lanes, lanes, chain, SCALE)]
    return {"probe": "dotperf", "device": common.device_name(dev),
            "P8": p8, "P9": p9}


def main():
    common.print_result(run())


if __name__ == "__main__":
    main()
