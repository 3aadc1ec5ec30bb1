"""The launch plan of the multitangent kernel K2 (``ops/fused_lin.mt_plan``):
pure host arithmetic, pinned on the CPU. The kernel runs the plan's primal
slabs; its C side makes the same cluster, groups and shared memory and
refuses another (``tests/test_torch_cuda.py`` holds the two equal on the
card). At N <= 52 the narrow plan (one primal a group of up to 4
tangents); at 53 <= N <= 128 the wide one (a cluster of 2, 4 or 8 blocks a
tangent, each rank a band of rows)."""

import re
from pathlib import Path

import pytest

from vsmartmom_tpu_torch.ops.fused_band import (SMEM_BUDGET, band_rows,
                                                cluster_smem_bytes)
from vsmartmom_tpu_torch.ops.fused_lin import (KERNEL_CLUSTER,
                                               KERNEL_THREADS, SMEM_OPT_IN,
                                               mt_plan)

from port_threads import _one_thread  # noqa: F401  (autouse)

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


@pytest.mark.parametrize("P", P_CASES)
def test_wide_plan_one_cluster_a_tangent(P):
    """Above N = 52 every tangent has a cluster of its own (groups = P),
    of the smallest size whose row bands fit, and the work is the primal
    once per tangent and two products per tangent product (3P)."""
    for N in (53, 84, 128):
        plan = mt_plan(N, 1, P)
        c = plan["cluster"]
        assert plan["wide"] and plan["groups"] == P and plan["work"] == 3 * P
        assert c in (2, 4, 8) and plan["band"] == band_rows(N, c)
        assert plan["threads"] == 256 and plan["smem"] <= SMEM_BUDGET
        assert c == 2 or cluster_smem_bytes(N, 1, c // 2, True) > \
            SMEM_BUDGET


@pytest.mark.parametrize("N", [1, 3, 4, 21, 36, 52, 53, 68, 84, 100, 128])
@pytest.mark.parametrize("P", [1, 3, 8, 11])
@pytest.mark.parametrize("K", [1, 2])
def test_every_primal_tile_and_row_owned_once(N, P, K):
    """Every tile of a primal product, every element of a primal source
    product and every output row is one rank's, once per cluster (a wide
    plan's ranks own row bands: every row once)."""
    plan = mt_plan(N, K, P)
    c = plan["cluster"]
    slabs = (("tile_slab", plan["tiles"]), ("vec_slab", N * K),
             ("row_slab", N))
    for key, total in slabs[2:] if plan["wide"] else slabs:
        bounds = plan[key]
        assert len(bounds) == c + 1 and bounds[0] == 0
        assert bounds[-1] == total
        owners = [r for r in range(c)
                  for _ in range(bounds[r], bounds[r + 1])]
        assert len(owners) == total and owners == sorted(owners), key


@pytest.mark.parametrize("K,widest", [(1, 219856), (2, 222768)])
def test_shared_memory_fits_every_width(K, widest):
    for N in range(1, 129):
        assert mt_plan(N, K, 8)["smem"] <= SMEM_OPT_IN, N
    assert mt_plan(52, K, 8)["smem"] == widest


@pytest.mark.parametrize("N,K,P,match", [
    (129, 1, 8, "N <= 128"), (52, 3, 8, "K <= 2"),
    (52, 0, 8, "K <= 2"), (52, 1, 0, "P >= 1")])
def test_plan_refuses(N, K, P, match):
    with pytest.raises(ValueError, match=match):
        mt_plan(N, K, P)
