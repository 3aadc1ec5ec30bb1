"""P1 (scripts/probe_batched_dot.py): the fastest formulation of the
batched small product, a chain of NREP products x <- (x @ a) 1.0000001 on
(S, N, N) at N = 52 and 104, at the Pallas precisions "highest" (fp32) and
"default" (tf32). The script's XLA variants are the library yardstick of
each case (torch.bmm with TF32 off for fp32, on for tf32); its Pallas block
sizes are the TPU's and do not carry over.
"""

import numpy as np
import torch

from ..core.types import resolve_device
from . import common

S, NREP = 2048, 40
NS = (52, 104)
SCALE = 1.0000001
PRECISIONS = ("highest", "default")


def run(device=None, s=S, chain=NREP, ns=NS):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    cases = []
    for n in ns:
        a = torch.from_numpy((rng.random((s, n, n)) / n).astype(
            np.float32)).to(dev)
        f64 = {}
        cases += [common.dot_case(f"N={n} {p}", p, a, a, "right", chain,
                                  SCALE, f64=f64)
                  for p in PRECISIONS]
        del a, f64
    return {"probe": "batched_dot", "device": common.device_name(dev),
            "P1": cases}


def main():
    common.print_result(run())


if __name__ == "__main__":
    main()
