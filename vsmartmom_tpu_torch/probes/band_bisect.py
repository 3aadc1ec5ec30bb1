"""P7 (scripts/probe_band_bisect.py): the band kernel's body in six stages
(acc, elem, src, pack, dbl, full; ``ops/band_stages.STAGES``) over a
sequential z grid with a carry, at the script's shapes (N = 12, S = 32,
NZ = 4, 2-point packing). On the TPU it bisected a compiler crash; here
each stage runs through the band-stage kernel against its plain version,
on the script's own inputs and on bounded ones (Gauss nodes and weights,
tau in [1e-3, 1e-2], Em1 = expm1(-tau / 16 / mu)). The script's random
operators have row sums above 1: its dbl and full stages overflow to NaN,
and full does on the bounded inputs too (its T is all ones), in the JAX
probe as here, so NaN must meet NaN and values are compared where the
plain version is finite. The full stage is also run on the bounded inputs
at one layer, where it is finite throughout (``FINITE_CASE``), and on thin
ones (the bounded inputs with tau in [1e-6, 1e-5]) at the script's NZ,
where the chain of adding steps stays finite, so that every layer's
record shows in the output (``CHAIN_CASE``).
"""

import numpy as np
import torch

from ..ops.band_stages import (NS_INTER, PACK, SCHED, STAGES, band_stages,
                               band_stages_reference)
from ..core.types import resolve_device
from . import common

N, S, NZ = 12, 32, 4
#: The case whose output is finite (and must be): the full stage on the
#: bounded inputs at one layer, where the composite starts at R = 0 (from
#: the second layer on its all-ones T overflows it).
FINITE_CASE = ("full", "bounded", 1)
#: The full stage over NZ layers whose output is finite (and must be): the
#: thin inputs, on which every stage is finite at every width.
CHAIN_CASE = ("full", "thin", NZ)
#: (stage, inputs, layers): every stage on the script's inputs and on the
#: bounded ones at the script's NZ, then FINITE_CASE and CHAIN_CASE.
CASES = [(stage, kind, NZ) for kind in ("probe", "bounded")
         for stage in STAGES] + [FINITE_CASE, CHAIN_CASE]


def inputs(kind, dev, nz=NZ, s=S, n=N):
    """The script's inputs (``kind="probe"``, its main()'s draws), the
    bounded ones or the thin ones (``"thin"``: tau in [1e-6, 1e-5]), as f32
    tensors (tau, Em1, aux)."""
    rng = np.random.default_rng(0)
    if kind == "probe":
        tau = rng.uniform(0.01, 0.5, (nz, 1, s))
        Em1 = np.expm1(-rng.uniform(0, 1, (nz, s, n)))
        aux = rng.uniform(0.2, 1.0, (8, n))
    else:
        x, w = np.polynomial.legendre.leggauss(n)
        mu = (x + 1) / 2
        aux = rng.uniform(0.2, 1.0, (8, n))
        aux[0], aux[1] = mu, w / 2
        lo, hi = (1e-3, 1e-2) if kind == "bounded" else (1e-6, 1e-5)
        tau = rng.uniform(lo, hi, (nz, 1, s))
        Em1 = np.expm1(-tau[:, 0, :, None] / 16 / mu)
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (tau, Em1, aux)]


def stage_flops(stage, nz, s, n):
    """FP32 operations of a stage: the ladder's and the adding step's
    matrix products on the (2N, 2N) packed operators (2 N^2 per product
    column, as chip_smoke.layer_flops); the elementwise stages count 0."""
    if stage not in ("dbl", "full"):
        return 0.0
    Np, K = PACK * n, 1
    cols = sum((2 * k + 5) * Np + 4 * K for k in SCHED)
    if stage == "full":
        cols += (2 * NS_INTER + 11) * Np + 4 * K
    return 2.0 * Np * Np * cols * (s // PACK) * nz


def compare(out, ref):
    """(NaN where ref is NaN and finite where it is finite, max|d| / max|ref|
    over the finite entries, max|d| there)."""
    fin = torch.isfinite(ref)
    same = bool(torch.equal(torch.isnan(out), torch.isnan(ref))
                and torch.equal(torch.isfinite(out), fin))
    if not fin.any():
        return same, 0.0, 0.0
    return same, common.rel(out[fin], ref[fin]), \
        float((out[fin] - ref[fin]).abs().max())


def run(device=None):
    dev = resolve_device(device)
    cases = []
    for stage, kind, nz in CASES:
        tau, Em1, aux = inputs(kind, dev, nz=nz)
        kern = common.time_ms(lambda: band_stages(stage, tau, Em1, aux), dev)
        plain = common.time_ms(
            lambda: band_stages_reference(stage, tau, Em1, aux), dev)
        out, ref = kern.out, plain.out
        ref64 = band_stages_reference(stage, tau.double(), Em1.double(),
                                      aux.double())
        nan_match, err, max_abs = compare(out, ref)
        f64_same, err_f64, _ = compare(out, ref64)
        cases.append({
            "case": f"{stage} {kind}" + (f" nz={nz}" if nz != NZ else ""),
            "stage": stage, "inputs": kind, "nz": nz,
            **common.timing(kern.ms, stage_flops(stage, nz, S, N),
                            common.nbytes(tau, Em1, aux, out),
                            common.PEAK_FLOPS["fp32"]),
            **common.timed_fields(kern, plain),
            "nan_match": nan_match, "err_plain": err,
            "max_abs_err": max_abs,
            "finite_share": float(torch.isfinite(ref).double().mean()),
            "must_be_finite": (stage, kind, nz) in (FINITE_CASE,
                                                    CHAIN_CASE),
            "f64_nan_match": f64_same, "err_f64": err_f64})
    return {"probe": "band_bisect", "device": common.device_name(dev),
            "P7": cases}


def main():
    common.print_result(run())


if __name__ == "__main__":
    main()
