"""K3's split form on the CPU: ``moment_rrs_split_reference`` (each grid
point's diagonal ladder once, then each on-grid pair's (2,1) blocks through
the store entries and pool slots of ``ops/rrs_program.py``'s table, in the
order the CUDA launches read them) against the dense plain body
``moment_rrs_body_reference``, and the host plan the launches take.

Scenes: the RRS+SIF scene at nSpec 64, I only (N = 6, 8 shifts, most pairs
off the grid), and the small IQU RRS scene (N = 21, 6 shifts). Tolerances,
relative to max|ref|: 1e-12 in f64 (the same algebra in another order) and
2e-5 in f32 (f32 rounding of two orders of the same products); off-grid
pairs exactly zero."""

import numpy as np
import pytest
import torch

from vsmartmom_tpu_torch.ops import fused_rrs
from vsmartmom_tpu_torch.ops import rrs_program as rp

from port_threads import _one_thread  # noqa: F401  (autouse)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@pytest.fixture(scope="module")
def scenes():
    """(operands at moment 1, shifts) of the two scenes, f32 on the CPU."""
    from vsmartmom_tpu_torch import rrs_sif_model
    from vsmartmom_tpu_torch.core.inelastic import (inelastic_setup,
                                                    rrs_moment_args)
    from vsmartmom_tpu_torch.flagship import rrs_ref_model
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_I
    out = {}
    for name, model in (("I6", rrs_sif_model(64, nstreams=3,
                                             polarization=STOKES_I)),
                        ("IQU21", rrs_ref_model())):
        inputs, config, *rrs = inelastic_setup(model, device="cpu")
        args, kw = rrs_moment_args(inputs, config, *rrs, 1, "cpu")
        kw = {k: v for k, v in kw.items() if k not in ("ns_sched",
                                                       "ns_inter")}
        out[name] = (fused_rrs.rrs_operands(*args, **kw), tuple(args[11]))
    return out


CASES = [  # scene, NS schedule (its length the doubling count), ns_inter,
    # pool (None: every phase's loads overlap the previous phase)
    ("I6", (0, 0, 1), 1, None),
    ("I6", (0, 1, 2, 3, 4), 3, 3),
    ("IQU21", (0, 0, 1), 1, 2),
    ("IQU21", (), 2, None),
]


@pytest.mark.parametrize("scene,sched,ns_inter,pool", CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_split_reference_matches_the_dense_body(scenes, scene, sched,
                                                ns_inter, pool, dtype):
    """The split form against the dense body at the main path's coarse
    ie schedule, a longer one, none (no doubling: the layer enters
    unstarred) and pools that split phases and load after the previous
    phase; off-grid pairs exactly zero in both."""
    ops, shifts = scenes[scene]
    ops = ops._replace(**{f: getattr(ops, f).to(dtype) for f in ops._fields})
    ref = fused_rrs.moment_rrs_body_reference(ops, sched, ns_inter)
    out = fused_rrs.moment_rrs_split_reference(ops, shifts, sched, ns_inter,
                                               pool)
    s = ops.src_ek.shape[1]
    off = torch.as_tensor([[not 0 <= i + sh < s for i in range(s)]
                           for sh in shifts]).reshape(-1)
    assert off.any() and not off.all()
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    for a, b in zip(out, ref):
        assert a.shape == b.shape and a.dtype == dtype
        assert _rel(a, b) <= tol
        assert (a[off] == 0).all() and (b[off] == 0).all()
    assert max(float(b.abs().max()) for b in ref) > 0


def test_pair_plan_is_target_major_on_the_grid():
    """The pair launch's grid: on-grid pairs only, target-major with the
    shifts inner, (pair index r s + i, target i, source i + shift)."""
    plan = rp.pair_plan((-2, 1, 3), 4)
    assert plan.dtype == np.int32
    assert plan.tolist() == [
        [4, 0, 1], [8, 0, 3],
        [5, 1, 2],
        [2, 2, 0], [6, 2, 3],
        [3, 3, 1]]


def test_main_path_plan_is_pinned():
    """The RRS+SIF scene's coarse ie ladder (nz 8, schedule (0, 0, 1), one
    interaction iteration): 33 store matrices and 16 vectors a layer; an
    11-slot pool lets every phase's loads overlap the previous phase, and
    a pair then stages 48 matrices a layer; at N = 36 the pair launch runs
    three blocks of 128 threads an SM with a 4-slot pool (phases split,
    most loaded after the one before), at N = 64 one block of 384 threads
    with a 3-slot pool."""
    plan = rp.build_plan(8, (0, 0, 1), 1)
    assert (plan.n_mat_entries, plan.n_vec_entries) == (264, 128)
    assert plan.layer_entries == tuple(range(0, 265, 33))
    assert (plan.pool, plan.n_phases, plan.n_prefetched) == (11, 144, 144)
    assert plan.n_stage_mats == 384
    assert plan.outs == (rp.RMP, rp.RPM, rp.TPP0, rp.TMM, rp.VJP, rp.VJM)
    assert fused_rrs.pair_shape(36, 8, (0, 0, 1), 1) == (128, 4)
    assert fused_rrs.pair_smem_bytes(36, 4) == 74448
    assert 3 * (74448 + fused_rrs.BLOCK_RESERVED) <= fused_rrs.SM_SMEM < \
        3 * (fused_rrs.pair_smem_bytes(36, 5) + fused_rrs.BLOCK_RESERVED)
    small = rp.build_plan(8, (0, 0, 1), 1, 4)
    assert (small.n_phases, small.n_prefetched) == (160, 33)
    assert fused_rrs.pair_shape(21, 8, (0, 0, 1), 1) == (128, 11)
    assert fused_rrs.pair_shape(64, 8, (0, 0, 1), 1) == (384, 3)
    assert fused_rrs.pair_smem_bytes(64, 3) <= fused_rrs.SMEM_LIMIT < \
        fused_rrs.pair_smem_bytes(64, 4)


@pytest.mark.parametrize("sched,ns_inter,pool", [
    ((0, 0, 1), 1, None), ((0, 1, 2, 3, 4), 3, 3), ((0, 0, 1), 1, 2),
    ((), 2, None)])
def test_plan_table_keeps_its_invariants(sched, ns_inter, pool):
    """What the kernels rely on: every value a (2,1) job reads from the
    pool was saved by the diagonal launch at or before its phase and
    staged into that slot at or before it (prefetched or kept from the
    previous phase); a prefetched phase's loads land in slots the phase
    before it does not read; the record fields stay in bounds."""
    plan = rp.build_plan(4, sched, ns_inter, pool)
    table = plan.table
    saved, slot_of = {}, {}
    prev_read = set()
    phases = [r for r in table if r[rp.F_OP] == rp.OP_PHASE]
    for k, rec in enumerate(phases):
        assert rec[rp.F_NSAVE] <= rp.MAX_SAVE
        assert rec[rp.F_NSTAGE] <= rp.MAX_STAGE
        assert rec[rp.F_NM] <= 3 and rec[rp.F_NV] <= 2
        for q in range(rec[rp.F_NSAVE]):
            is_vec, _, _, e = rp.decode_stage(int(rec[rp.F_SAVE + q]))
            saved.setdefault((is_vec, e), k)
        stages = [rp.decode_stage(int(rec[rp.F_STAGE + q]))
                  for q in range(rec[rp.F_NSTAGE])]
        for is_vec, role, slot, e in stages:
            assert saved[(is_vec, e)] <= k
            limit = (rp.N_VEC + rp.VPOOL) if is_vec else (rp.N_MAT
                                                          + plan.pool)
            assert (rp.N_VEC if is_vec else rp.N_MAT) <= slot < limit
            if rec[rp.F_PREFETCH] and k > 0:
                assert (is_vec, slot) not in prev_read
            slot_of[(is_vec, slot)] = (e, role)
        read = set()
        for q in range(rec[rp.F_NM]):
            code = int(rec[rp.F_M2 + q])
            a22, b11 = code & 31, (code >> 5) & 31
            assert slot_of[(0, a22)][1] == rp.ROLE_A
            assert slot_of[(0, b11)][1] == rp.ROLE_B
            read |= {(0, a22), (0, b11)}
        for q in range(rec[rp.F_NV]):
            code = int(rec[rp.F_V2 + q])
            a22, x1 = code & 31, (code >> 5) & 31
            assert slot_of[(0, a22)][1] == rp.ROLE_A
            assert slot_of[(1, x1)][1] == rp.ROLE_B
            read |= {(0, a22), (1, x1)}
        prev_read = read
    assert len(saved) == plan.n_mat_entries + plan.n_vec_entries
