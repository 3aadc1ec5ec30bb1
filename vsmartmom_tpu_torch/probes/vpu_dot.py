"""P4 (scripts/probe_vpu_dot.py): the lane-batched small product, spectral
axis last: (N, N, S) operands, C[i,j,s] = sum_k x[i,k,s] a[k,j,s], chained
NREP times with a scale of 1.0000001, in true FP32. The layout of the
reference's batched products (vSmartMOM.jl's gpu_batched_cuda.jl); on the
TPU it ran on the VPU, each lane block's whole chain kept in VMEM. Here it
asks what the spectral-axis-last layout costs once the chain stays on chip:
``lane_dot_chain`` stages a few neighbouring points' x and a in shared
memory, runs every step there with dot_chain's fp32 product loop and writes
once, so the layout's price is its strided loads and stores, to be read
against ``dotperf``'s P8 fp32 case at the same N and S.
"""

import numpy as np
import torch

from ..core.types import resolve_device
from . import common

S, NREP = 2048, 100
N = 52
SCALE = 1.0000001


def run(device=None, s=S, chain=NREP):
    dev = resolve_device(device)
    a = torch.from_numpy((np.random.default_rng(0).random((N, N, s)) / N)
                         .astype(np.float32)).to(dev)
    cases = [common.lane_case(f"N={N} lanes", a, a, chain, SCALE)]
    return {"probe": "vpu_dot", "device": common.device_name(dev),
            "P4": cases}


def main():
    common.print_result(run())


if __name__ == "__main__":
    main()
