"""The per-layer kernels' plain versions (vsmartmom_tpu_torch/ops/fused_rt.py)
against the JAX package's Pallas kernels.

``doubling_reference`` (the plain K5) and ``layer_step_reference`` (the plain
K4) are held against the JAX ``fused_doubling`` / ``fused_layer_step`` run
the way tests/test_fused_rt.py runs them (Pallas interpret mode on the CPU),
on the same seeded numpy inputs in the shape of that file's ``_inputs``
(s = 8, N = 12 with the IQUV D signs), at its tolerance: 2e-6 absolute in
f32. The cases cover K = 1 and 2, ndoubl 0, 1, 3 and 4, per-point and
per-row expk, and the default, int and tuple Newton-Schulz schedules.
"""

import numpy as np
import pytest
import torch

from port_threads import _one_thread  # noqa: F401  (autouse)

S, N = 8, 12
ATOL = 2e-6


def _inputs(K, ek_form, seed, scale=0.3):
    """Starred layer operands (r*, t, jp, jm*, expk, d_vec) as f32 numpy:
    reflection row sums <= scale, so the ladder keeps rho(r r) < 1."""
    rng = np.random.default_rng(seed)
    r = scale * rng.random((S, N, N)) / N
    t = np.eye(N)[None] * 0.8 + scale * rng.random((S, N, N)) / N
    jp = 0.1 * rng.random((S, N, K))
    jm = 0.1 * rng.random((S, N, K))
    shape = (S, K) if ek_form == "point" else (S, N, K)
    ek = np.exp(-rng.random(shape))
    d_vec = np.tile([1.0, 1.0, -1.0, -1.0], N // 4)
    r_star = r * d_vec[None, :, None]
    jm_star = jm * d_vec[None, :, None]
    return [np.asarray(a, np.float32)
            for a in (r_star, t, jp, jm_star, ek, d_vec)]


def _composite(K, seed):
    """A physical composite (R small, T near 0.8 I), f32 numpy."""
    rng = np.random.default_rng(seed)
    R = [0.2 * rng.random((S, N, N)) / N for _ in range(2)]
    T = [np.eye(N)[None] * 0.8 + 0.2 * rng.random((S, N, N)) / N
         for _ in range(2)]
    J = [0.1 * rng.random((S, N, K)) for _ in range(2)]
    return [np.asarray(a, np.float32) for a in (*R, *T, *J)]


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


CASES = [  # K, ndoubl, expk form, NS schedule
    (1, 0, "point", None),
    (1, 1, "row", 2),
    (1, 3, "point", (0, 1, 2)),
    (1, 4, "point", None),
    (2, 3, "point", 1),
    (2, 4, "row", (0, 1, 2, 3)),
]


@pytest.mark.parametrize("K,ndoubl,ek_form,sched", CASES)
def test_doubling_reference_matches_jax(K, ndoubl, ek_form, sched):
    import jax.numpy as jnp
    from vsmartmom_tpu.ops import fused_rt as jax_rt
    from vsmartmom_tpu_torch.ops.fused_rt import doubling_reference
    r, t, jp, jm, ek, _ = _inputs(K, ek_form, seed=ndoubl + 10 * K)
    ref = [np.asarray(x) for x in jax_rt.fused_doubling(
        *(jnp.asarray(a) for a in (r, t, jp, jm, ek)), ndoubl,
        ns_sched=sched, block=4, interpret=True)]
    out = doubling_reference(*_torch((r, t, jp, jm, ek)), ndoubl, sched)
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("K,ndoubl,ek_form,sched", [
    (1, 0, "point", None),
    (1, 3, "row", (0, 1, 2)),
    (2, 4, "point", 2),
    (2, 1, "row", None),
])
def test_layer_step_reference_matches_jax(K, ndoubl, ek_form, sched):
    import jax.numpy as jnp
    from vsmartmom_tpu.ops import fused_rt as jax_rt
    from vsmartmom_tpu_torch.ops.fused_rt import layer_step_reference
    r, t, jp, jm, ek, d = _inputs(K, ek_form, seed=1 + ndoubl + 10 * K)
    comp = _composite(K, seed=ndoubl)
    ref = [np.asarray(x) for x in jax_rt.fused_layer_step(
        tuple(jnp.asarray(a) for a in comp),
        *(jnp.asarray(a) for a in (r, t, jp, jm, ek, d)), ndoubl,
        ns_sched=sched, ns_inter=3, block=4, interpret=True)]
    out = layer_step_reference(_torch(comp), *_torch((r, t, jp, jm, ek, d)),
                               ndoubl, sched, ns_inter=3)
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("sched,ndoubl", [
    (None, 4), ((), 3), (2, 4), (0, 3), ((0, 1, 2, 3), 4), (5, 0),
    (None, 0)])
def test_norm_sched_matches_jax(sched, ndoubl):
    """None/() -> NS_ITERS per step; an int -> that count per step; a tuple
    of ndoubl counts as it is."""
    from vsmartmom_tpu.ops.fused_rt import _norm_sched
    from vsmartmom_tpu_torch.ops.fused_rt import norm_sched
    assert norm_sched(sched, ndoubl) == _norm_sched(sched, ndoubl)


def test_norm_sched_refuses_a_schedule_that_does_not_fit():
    from vsmartmom_tpu_torch.ops.fused_rt import norm_sched
    with pytest.raises(ValueError, match="does not fit"):
        norm_sched((1, 2), 3)
    with pytest.raises(ValueError, match="does not fit"):
        norm_sched(-1, 2)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers return their plain versions' outputs and
    count no launch; a TPU-only dot mode is refused."""
    from vsmartmom_tpu_torch.ops import fused_rt
    r, t, jp, jm, ek, d = _torch(_inputs(2, "point", seed=3))
    comp = _torch(_composite(2, seed=3))
    n5 = fused_rt.fused_doubling.launches
    n4 = fused_rt.fused_layer_step.launches
    out = fused_rt.fused_doubling(r, t, jp, jm, ek, 3, ns_sched=1)
    ref = fused_rt.doubling_reference(r, t, jp, jm, ek, 3, (1, 1, 1))
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    out = fused_rt.fused_layer_step(comp, r, t, jp, jm, ek, d, 3, ns_inter=2)
    ref = fused_rt.layer_step_reference(comp, r, t, jp, jm, ek, d, 3,
                                        ns_inter=2)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert fused_rt.fused_doubling.launches == n5
    assert fused_rt.fused_layer_step.launches == n4
    with pytest.raises(NotImplementedError, match="split3"):
        fused_rt.fused_doubling(r, t, jp, jm, ek, 3, dot_mode="split3")
    with pytest.raises(NotImplementedError, match="default"):
        fused_rt.fused_layer_step(comp, r, t, jp, jm, ek, d, 3,
                                  dot_mode="default")


def test_build_name_hashes_the_shared_headers(monkeypatch, tmp_path):
    """A library's name carries a hash of its source and of every
    csrc/*.cuh, so an edited shared header (csrc/fp32_tile.cuh) rebuilds
    every source that may include it instead of reusing a stale library."""
    from vsmartmom_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "SRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// one\n")
    first = cuda_build._target("k")
    assert cuda_build._target("k") == first
    (tmp_path / "shared.cuh").write_text("// two\n")
    second = cuda_build._target("k")
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "other.cuh").write_text("// a new header\n")
    assert cuda_build._target("k") not in (first, second)
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert cuda_build._target("k") not in (first, second)


def _diagonal_ladder(r, t, jp, jm, ek, ndoubl):
    """The doubling ladder of a purely absorbing layer (r = 0, t diagonal),
    the O(N) closed form K5 runs there: S = r r = 0, so the NS inverse is
    I at any schedule, tt_gp = t and X = 0; per step, each product rounded
    on its own, t_ii <- t_ii^2, jm <- jm + t_ii (jm ek),
    jp <- jp ek + t_ii jp, ek <- ek^2, and r stays 0."""
    tii = torch.diagonal(t, dim1=-2, dim2=-1)
    for _ in range(ndoubl):
        tt = tii[..., None]
        jm = jm + tt * (jm * ek)
        jp = jp * ek + tt * jp
        ek = ek * ek
        tii = tii * tii
    return torch.zeros_like(r), torch.diag_embed(tii), jp, jm


def test_absorbing_layer_ladder_is_the_diagonal_closed_form():
    """The flagship's layers at m = m_max (above m_scat, Z = 0) through
    ``doubling_reference`` equal the diagonal closed form bit for bit in
    f32, at a schedule with and without NS iterations; in f64 the closed
    form matches the JAX package's ``_doubling_math`` within 1e-12."""
    import jax.numpy as jnp
    from vsmartmom_tpu.ops.fused_rt import _doubling_math
    from vsmartmom_tpu_torch.core.multisensor import layer_batch_args
    from vsmartmom_tpu_torch.core.solver import layer_batch
    from vsmartmom_tpu_torch.core.types import SolverInputs
    from vsmartmom_tpu_torch.flagship import flagship_model
    from vsmartmom_tpu_torch.ops.fused_rt import doubling_reference, ek_to_rows
    inputs, config = flagship_model(n_spec=2, nstreams=8).build_band(
        0, device="cpu")
    assert config.N == 52 and config.m_scat < config.m_max
    inp = SolverInputs(*(torch.as_tensor(x).float() for x in inputs))
    layer_data, kw = layer_batch_args(inp, config, config.m_max)
    d = kw.pop("d_vec")[:, None]
    r, t, jp, jm, ek = layer_batch(layer_data, **kw)
    ops = [x.float().contiguous() for x in
           (r * d, t, jp, jm * d, ek_to_rows(ek, config.N))]
    off = ~torch.eye(config.N, dtype=torch.bool)
    assert (ops[0] == 0).all() and (ops[1][:, off] == 0).all()
    n = config.ndoubl
    closed = _diagonal_ladder(*ops, n)
    for sched in ((0,) * n, (0, 1, 2, 0, 3, 0, 1, 2)[:n]):
        ref = doubling_reference(*ops, n, sched)
        for a, b in zip(closed, ref):
            assert torch.equal(a, b)
    ops64 = [x.double() for x in ops]
    closed = _diagonal_ladder(*ops64, n)
    ref = [np.asarray(x) for x in _doubling_math(
        *(jnp.asarray(x.numpy()) for x in ops64), (0, 2) + (0,) * (n - 2))]
    for a, b in zip(closed, ref):
        scale = max(float(np.abs(b).max()), 1e-300)
        assert float(np.abs(a.numpy() - b).max()) <= 1e-12 * scale


@pytest.mark.parametrize("group,names,changed", [
    ("tile", ("nomac", "empty", "epist", "novec", "bcasta", "bcastb"),
     ["fp32_tile.cuh"]),
    ("rrs", ("nomac", "empty", "narrow2"), ["fp32_tile.cuh"]),
    ("rrs", ("onestore",), ["fused_rrs.cu"]),
    ("band", ("nomac", "empty", "novec"), ["fp32_tile.cuh"]),
    ("band", ("t64",), ["band_stages.cu"])],
    ids=["tile", "rrs", "rrs-store", "band", "band-src"])
def test_tile_variant_patches_match_the_sources(group, names, changed):
    """The patches of tools/variants.py behind PERF.md's splits of K1's,
    K3's and P7's time (no product loop, empty phases, no epilogues, no
    vector jobs, one A / B address a warp; K3's staging copies from one
    store entry; P7's thread cap) still
    apply to csrc/ and change what they name: K3's no-loop patch both
    launches' tiles (K1's and the (2,1) one), its copy patch both the
    matrix and the vector copies."""
    from tools import variants
    from vsmartmom_tpu_torch.ops.cuda_build import SRC_DIR
    built = variants.variant_files(group, "built", SRC_DIR)
    for name in names:
        files = variants.variant_files(group, name, SRC_DIR)
        assert set(files) == set(built)
        assert [f for f in files if files[f] != built[f]] == changed, name
        if group == "rrs" and name != "empty":
            for f, old, _ in variants.patches(group, name):
                assert built[f].count(old) == 1 and old not in files[f]
