"""The launch plan of the multitangent kernel K2 (``ops/fused_lin.mt_plan``):
pure host arithmetic, pinned on the CPU. The kernel runs the plan's primal
slabs; its C side makes the same cluster, groups and shared memory and
refuses another (``tests/test_torch_cuda.py`` holds the two equal on the
card)."""

import re
from pathlib import Path

import pytest

from vsmartmom_tpu_torch.ops.fused_lin import (KERNEL_CLUSTER,
                                               KERNEL_THREADS, SMEM_OPT_IN,
                                               mt_plan)

P_CASES = [*range(1, 25), 32, 40]
SOURCE = (Path(__file__).resolve().parents[1] / "vsmartmom_tpu_torch"
          / "csrc" / "fused_lin.cu")


def _define(name):
    return int(re.search(rf"^#define {name} (\d+)$", SOURCE.read_text(),
                         re.M).group(1))


def test_constants_are_the_kernel_s():
    """The host's cluster limit and block size are the ones the kernel is
    built with, and a cluster fits the portable limit of 8 blocks."""
    assert KERNEL_CLUSTER == _define("VSM_CLUSTER")
    assert KERNEL_THREADS == _define("VSM_THREADS")
    assert 1 <= KERNEL_CLUSTER <= 8


@pytest.mark.parametrize("P", P_CASES)
def test_every_tangent_in_exactly_one_block(P):
    """Rank r of group g owns tangent g * cluster + r: every tangent once,
    clusters of at most the limit, as few groups as the limit allows, and
    the idle ranks (past P) fewer than one a group."""
    plan = mt_plan(52, 1, P)
    c, g = plan["cluster"], plan["groups"]
    owned = [q for grp in range(g) for r in range(c)
             if (q := grp * c + r) < P]
    assert owned == list(range(P))
    assert c <= KERNEL_CLUSTER and g == -(-P // KERNEL_CLUSTER)
    assert 0 <= g * c - P < g
    assert plan["work"] == g + 2 * P


@pytest.mark.parametrize("N", [1, 3, 4, 21, 36, 52])
@pytest.mark.parametrize("P", [1, 3, 8, 11])
@pytest.mark.parametrize("K", [1, 2])
def test_every_primal_tile_and_row_owned_once(N, P, K):
    """Every tile of a primal product, every element of a primal source
    product and every output row is one rank's, once per cluster."""
    plan = mt_plan(N, K, P)
    c = plan["cluster"]
    for key, total in (("tile_slab", plan["tiles"]),
                       ("vec_slab", N * K), ("row_slab", N)):
        bounds = plan[key]
        assert len(bounds) == c + 1 and bounds[0] == 0
        assert bounds[-1] == total
        owners = [r for r in range(c)
                  for _ in range(bounds[r], bounds[r + 1])]
        assert len(owners) == total and owners == sorted(owners), key


@pytest.mark.parametrize("K,widest", [(1, 219856), (2, 222768)])
def test_shared_memory_fits_every_width(K, widest):
    for N in range(1, 53):
        assert mt_plan(N, K, 8)["smem"] <= SMEM_OPT_IN, N
    assert mt_plan(52, K, 8)["smem"] == widest


@pytest.mark.parametrize("N,K,P,match", [
    (53, 1, 8, "N <= 52"), (52, 3, 8, "K <= 2"),
    (52, 0, 8, "K <= 2"), (52, 1, 0, "P >= 1")])
def test_plan_refuses(N, K, P, match):
    with pytest.raises(ValueError, match=match):
        mt_plan(N, K, P)
