"""The CUDA kernels on the card (``-m cuda``): they need an NVIDIA GPU and
the CUDA toolkit, and skip without them. Run on the GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.

Gate, as in chip_smoke.py and the JAX package's bench: max|d| / max|ref|
<= 1e-4 between a kernel and its plain torch version on the same card
(the kernel sums its FP32 products in its own order); the RRS kernel path
against the plain RRS path 1e-4 on R and, with the coarse production ie
ladder, 5e-3 on ieR (the JAX bench's gate, scripts/bench_rrs.py:90)."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from port_threads import _one_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.cuda
GATE = 1e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the band kernel has no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _model(n_spec, thermal=False, nstreams=4):
    from vsmartmom_tpu_torch import flagship_model
    model = flagship_model(n_spec=n_spec, nstreams=nstreams)
    if thermal:
        model.bands[0].thermal_b = np.random.default_rng(5).uniform(
            0.05, 0.5, (model.profile.nz, n_spec))
    return model


def _band_f64_errors(args, kw, out, ref):
    """K1's composite and its f32 plain version's against the plain version
    run in f64 on the same operands (max over outputs of max|d| / max|ref|)."""
    from vsmartmom_tpu_torch.ops import fused_band
    ops = fused_band.band_operands(*args, **{
        k: kw[k] for k in ("ndoubl", "n_stokes", "i_mu0_start",
                           "n_sources")})
    ref64 = fused_band.moment_body_reference(
        ops._replace(**{f: getattr(ops, f).double() for f in ops._fields}),
        fused_band.norm_sched(kw["ns_sched"] or None, kw["ndoubl"]),
        kw["ns_inter"])
    return (max(_rel(a.double(), b) for a, b in zip(out, ref64)),
            max(_rel(a.double(), b) for a, b in zip(ref, ref64)))


@pytest.mark.parametrize("thermal", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("nstreams,N", [(4, 36), (8, 52)])
def test_kernel_matches_plain_version(cuda, thermal, nstreams, N):
    """K1 against its plain version at every scattering moment; at the
    flagship's N = 52 its distance from the plain version run in f64 is at
    most twice the f32 plain version's (chip_smoke.py's F64_RATIO)."""
    from vsmartmom_tpu_torch.core.solver import band_moment_args
    from vsmartmom_tpu_torch.ops.fused_band import (fused_moment,
                                                    moment_reference)
    inputs, config = _model(37, thermal, nstreams).build_band(0, device=cuda)
    assert config.fused and config.n_sources == (2 if thermal else 1)
    assert config.N == N
    for m in range(config.m_scat + 1):
        args, kw = band_moment_args(inputs, config, m, cuda)
        out = fused_moment(*args, **kw)
        torch.cuda.synchronize()
        ref = moment_reference(*args, **kw)
        for a, b in zip(out, ref):
            assert torch.isfinite(a).all() and _rel(a, b) <= GATE
        if N == 52:
            kernel, plain = _band_f64_errors(args, kw, out, ref)
            assert kernel <= 2.0 * plain, (m, kernel, plain)


@pytest.mark.parametrize("thermal", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("pol,nstreams,n_vza,N", [("STOKES_I", 4, 6, 10),
                                                  ("STOKES_IQU", 2, 5, 21),
                                                  ("STOKES_IQU", 4, 6, 30),
                                                  ("STOKES_IQUV", 11, 6, 64)])
def test_kernel_takes_any_width(cuda, pol, nstreams, n_vza, N, thermal):
    """Stream counts that are no multiple of 4 (the kernel's float4 rows
    pad only its shared-memory stride; N = 21 is odd) and the largest N it
    takes, with one and two source columns."""
    from vsmartmom_tpu_torch import (Parameters, SurfaceDescriptor,
                                     model_from_parameters)
    from vsmartmom_tpu_torch.core.solver import band_moment_args
    from vsmartmom_tpu_torch.flagship import FLAGSHIP_P, FLAGSHIP_T
    from vsmartmom_tpu_torch.ops.fused_band import (fused_moment,
                                                    moment_reference)
    from vsmartmom_tpu_torch.scattering import stokes
    vza = [75.0, 60.0, 45.0, 30.0, 15.0, 0.0]
    vza = vza[:n_vza - 1] + vza[-1:]
    model = model_from_parameters(Parameters(
        spec_bands=[19417.0 + 0.05 * np.arange(21)],
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar", [0.05])],
        nstreams=nstreams, polarization=getattr(stokes, pol), sza=30.0,
        vza=vza, vaz=[0.0] * len(vza), obs_alt=1000.0,
        T=FLAGSHIP_T, p=FLAGSHIP_P, float_type=np.float32))
    if thermal:
        model.bands[0].thermal_b = np.random.default_rng(7).uniform(
            0.05, 0.5, (model.profile.nz, 21))
    inputs, config = model.build_band(0, device=cuda)
    assert config.N == N and config.fused
    assert config.n_sources == (2 if thermal else 1)
    for m in range(config.m_scat + 1):
        args, kw = band_moment_args(inputs, config, m, cuda)
        out = fused_moment(*args, **kw)
        torch.cuda.synchronize()
        ref = moment_reference(*args, **kw)
        for a, b in zip(out, ref):
            assert torch.isfinite(a).all() and _rel(a, b) <= GATE


@pytest.mark.parametrize("N", [21, 52, 64])
def test_band_kernel_launch_shape_is_the_c_side_s(cuda, N):
    """The launch shape the C side reports (csrc/fused_band.cu): whole warps
    and shared memory of ten N x N matrices at a float4-aligned row stride,
    eight (N, K) vectors and the D diagonal; the resident blocks per SM
    from the CUDA occupancy calculator for K1 and K5 (csrc/fused_rt.cu):
    at the flagship's N = 52 two blocks of each share an SM at K = 1 and
    2, and at least one fits at every width."""
    from vsmartmom_tpu_torch.ops import cuda_build
    lib = cuda_build.load("fused_band")
    k5 = cuda_build.load("fused_rt")
    lib.vsm_fused_moment_smem_bytes.restype = ctypes.c_size_t
    assert lib.vsm_fused_moment_threads() % 32 == 0
    LD = (N + 3) // 4 * 4
    for K in (1, 2):
        VS = (N * K + 3) // 4 * 4
        smem = lib.vsm_fused_moment_smem_bytes(N, K)
        assert smem == 4 * (10 * N * LD + 8 * VS + LD)
        blocks = (lib.vsm_fused_moment_blocks_per_sm(N, K),
                  k5.vsm_fused_doubling_blocks_per_sm(N, K))
        assert min(blocks) >= 1, blocks
        if N == 52:
            assert blocks == (2, 2), blocks
    assert lib.vsm_fused_moment_blocks_per_sm(65, 1) < 0
    assert k5.vsm_fused_doubling_blocks_per_sm(52, 3) < 0


#: SHA-256 of K1's six outputs on ``k1_flagship_digest``'s inputs as the
#: build of csrc/fused_band.cu before its adding moved into
#: csrc/fp32_tile.cuh (shared with K4) computed them on an H100: the move
#: changed no bit. A deliberate change of K1's arithmetic records a new one.
K1_FLAGSHIP_SHA256 = ("77001a131d5d84c27771484360c3394491e07ebb1d46a3c370"
                      "99e34d8f85f3c3")


def k1_flagship_digest(cuda):
    """SHA-256 of K1's outputs (R_mp, R_pm, T_pp, T_mm, J0_p, J0_m) at
    moment 0 of the flagship at nSpec 16, its operands built on the CPU (so
    they do not depend on the card's math libraries), launched on
    ``cuda``."""
    import hashlib
    from vsmartmom_tpu_torch import flagship_model
    from vsmartmom_tpu_torch.core.solver import band_moment_args
    from vsmartmom_tpu_torch.ops.fused_band import fused_moment
    inputs, config = flagship_model(n_spec=16, nstreams=8).build_band(
        0, device="cpu")
    args, kw = band_moment_args(inputs, config, 0, "cpu")
    out = fused_moment(*(x.to(cuda) if torch.is_tensor(x) else x
                         for x in args), **kw)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for x in out:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()


def test_band_kernel_is_bit_identical_to_its_previous_build(cuda):
    """K1 computes every bit as its build before the shared adding did, on
    one flagship moment."""
    assert k1_flagship_digest(cuda) == K1_FLAGSHIP_SHA256


def test_kernel_path_matches_plain_path(cuda):
    from vsmartmom_tpu_torch.core.solver import rt_solve
    from vsmartmom_tpu_torch.ops.fused_band import fused_moment
    inputs, config = _model(16).build_band(0, device=cuda)
    before = fused_moment.launches
    out = rt_solve(inputs, config, cuda)
    assert fused_moment.launches - before == config.m_scat + 1
    plain = rt_solve(inputs, dataclasses.replace(config, fused=False), cuda)
    for k in ("R", "T", "hdr", "bhr_uw", "bhr_dw"):
        assert _rel(out[k], plain[k]) <= GATE, k


def test_kernel_refuses_f64(cuda):
    from vsmartmom_tpu_torch.core.solver import band_moment_args
    from vsmartmom_tpu_torch.ops.fused_band import fused_moment
    inputs, config = _model(4).build_band(0, device=cuda)
    args, kw = band_moment_args(
        inputs, dataclasses.replace(config, dtype=np.float64), 0, cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_moment(*args, **kw)


def _rrs_setup(cuda, n_spec, pol="STOKES_IQU", nstreams=8):
    from vsmartmom_tpu_torch import rrs_sif_model
    from vsmartmom_tpu_torch.core.inelastic import inelastic_setup
    from vsmartmom_tpu_torch.scattering import stokes
    return inelastic_setup(rrs_sif_model(
        n_spec, nstreams=nstreams, polarization=getattr(stokes, pol)),
        device=cuda)


def _rrs_model(n_spec, pol, nstreams, vza):
    """The RRS+SIF scene (``rrs_sif_model``) with its own viewing zenith
    angles (their count sets the quadrature's node count)."""
    from vsmartmom_tpu_torch import (Parameters, SurfaceDescriptor,
                                     model_from_parameters)
    from vsmartmom_tpu_torch.scattering import stokes
    model = model_from_parameters(Parameters(
        spec_bands=[12950.0 + 0.6 * np.arange(n_spec)],
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar", [0.05])],
        nstreams=nstreams, polarization=getattr(stokes, pol), sza=45.0,
        vza=vza, vaz=[0.0] * len(vza), obs_alt=0.0,
        T=np.linspace(230.0, 290.0, 8), p=np.linspace(50.0, 1013.0, 9),
        depol=-1.0, float_type=np.float32))
    model.bands[0].sif_spec = 1e-3 * np.ones(n_spec)
    return model


@pytest.mark.parametrize("pol,nstreams,vza,n_spec,N", [
    ("STOKES_IQU", 8, [0.0, 30.0, 60.0], 64, 36),
    ("STOKES_I", 3, [0.0, 30.0, 60.0], 96, 6),
    ("STOKES_IQU", 2, [75.0, 60.0, 45.0, 30.0, 0.0], 64, 21),
    ("STOKES_IQUV", 12, [0.0, 30.0, 60.0], 64, 64)],
    ids=["IQU36", "I6", "IQU21", "IQUV64"])
def test_rrs_kernel_matches_plain_version(cuda, pol, nstreams, vza, n_spec,
                                          N):
    """K3 at the RRS+SIF scene's width (N = 36), at a narrow I-only one, at
    an odd one (N = 21: the tiles' ragged edges) and at the widest it takes
    (N = 64, where the pair launch's pool shrinks to what fits and the plan
    splits phases), every moment, at the coarse ie ladder and the full
    resolution: <= 1e-4 of max|ref| against the dense plain version and the
    split one (``moment_rrs_split_reference``, the kernels' own algebra);
    the shifts reach off the band edge for many pairs, whose ie blocks must
    come out exactly zero. Each call is one counted call and one counted
    diagonal launch; both launches' residency is read back from the C
    side."""
    from vsmartmom_tpu_torch.core.inelastic import (inelastic_setup,
                                                    rrs_moment_args)
    from vsmartmom_tpu_torch.ops import fused_rrs
    inputs, config, *rrs = inelastic_setup(
        _rrs_model(n_spec, pol, nstreams, vza), device=cuda)
    assert config.N == N and config.fused
    shifts = rrs[0]
    off = np.array([[not 0 <= i + sh < n_spec for i in range(n_spec)]
                    for sh in shifts])
    assert off.any() and not off.all()
    off = torch.as_tensor(off, device=cuda)
    for m in range(config.m_max + 1):
        for full in (False, True):
            args, kw = rrs_moment_args(inputs, config, *rrs, m, cuda, full)
            calls = fused_rrs.fused_moment_rrs.launches
            diag = fused_rrs._launch_diagonal.launches
            out = fused_rrs.fused_moment_rrs(*args, **kw)
            torch.cuda.synchronize()
            assert fused_rrs.fused_moment_rrs.launches == calls + 1
            assert fused_rrs._launch_diagonal.launches == diag + 1
            ref = fused_rrs.moment_rrs_reference(*args, **kw)
            ops = fused_rrs.rrs_operands(*args, **{
                k: v for k, v in kw.items()
                if k not in ("ns_sched", "ns_inter")})
            split = fused_rrs.moment_rrs_split_reference(
                ops, shifts, fused_rrs.norm_sched(kw["ns_sched"],
                                                  kw["ndoubl"]),
                kw["ns_inter"], fused_rrs.pair_shape(
                    N, config.nz, fused_rrs.norm_sched(kw["ns_sched"],
                                                       kw["ndoubl"]),
                    kw["ns_inter"])[1])
            for a, b, c in zip(out, ref, split):
                a = a.reshape(b.shape)
                assert torch.isfinite(a).all() and _rel(a, b) <= GATE
                assert _rel(a.reshape(c.shape), c) <= GATE
                assert (a[off] == 0).all()
    sched = fused_rrs.norm_sched(kw["ns_sched"], kw["ndoubl"])
    info = fused_rrs.launch_info(N, config.nz, sched, kw["ns_inter"])
    assert info["diag_threads"] == 192
    assert info["pair_smem_bytes"] == fused_rrs.pair_smem_bytes(
        N, info["pool"]) <= fused_rrs.SMEM_LIMIT
    assert info["diag_blocks_per_sm"] >= 1
    assert (info["pair_threads"], info["pair_blocks_per_sm"]) == (
        (128, 3) if N <= 36 else (384, 1))


def test_rrs_kernel_path_matches_plain_path(cuda):
    from vsmartmom_tpu_torch.core.inelastic import (rt_solve_rrs,
                                                    rt_solve_rrs_fused)
    from vsmartmom_tpu_torch.ops.fused_band import fused_moment
    from vsmartmom_tpu_torch.ops.fused_rrs import fused_moment_rrs
    inputs, config, *rrs = _rrs_setup(cuda, 64)
    plain = rt_solve_rrs(inputs, dataclasses.replace(config, fused=False),
                         *rrs, device=cuda)
    for full, ie_gate in ((False, 5e-3), (True, GATE)):
        k1, k3 = fused_moment.launches, fused_moment_rrs.launches
        out = rt_solve_rrs_fused(inputs, config, *rrs, device=cuda,
                                 ie_fullres=full)
        assert fused_moment.launches - k1 == config.m_max + 1
        assert fused_moment_rrs.launches - k3 == config.m_max + 1
        for k, gate in (("R", GATE), ("T", GATE), ("ieR", ie_gate),
                        ("ieT", ie_gate)):
            assert torch.isfinite(out[k]).all()
            assert _rel(out[k], plain[k]) <= gate, (k, full)


def test_rrs_wrapper_refuses_wide_streams_before_building(cuda, monkeypatch):
    """N = 65 is above the RRS kernels' shared-memory limit: the wrapper
    raises before any nvcc run or launch."""
    from vsmartmom_tpu_torch.core.inelastic import rrs_moment_args
    from vsmartmom_tpu_torch.ops import cuda_build, fused_rrs
    inputs, config, *rrs = _rrs_setup(cuda, 64, "STOKES_I", 3)
    ops = fused_rrs.rrs_operands(*rrs_moment_args(
        inputs, config, *rrs, 0, cuda)[0], ndoubl=config.ndoubl, n_stokes=1,
        i_mu0_start=config.i_mu0_start)
    wide = ops._replace(Em1=torch.zeros((config.nz, ops.Em1.shape[1], 130),
                                        device=cuda))

    def no_build(name):
        raise AssertionError("the wrapper tried to build a kernel")
    monkeypatch.setattr(cuda_build, "load", no_build)
    with pytest.raises(ValueError, match="N <= 64"):
        fused_rrs._launch_kernel(wide, rrs[0], (1,) * config.ndoubl, 2)


def _lin_setup(cuda, scene):
    """(inputs, config, tangents) of a Jacobian scene on the card: the small
    aerosol scene (N = 21, 2 points), the aerosol flagship (N = 52) at 16
    points, or their thermal (K = 2) twins, the small scene with its seeded
    thermal source and the thermal Jacobian scene at 16 points; 7 aerosol
    parameters and wind speed."""
    from vsmartmom_tpu_torch.core.linearization import (build_tangent_inputs,
                                                        default_layout)
    from vsmartmom_tpu_torch.flagship import (flagship_model, lin_ref_model,
                                              lin_thermal_model,
                                              thermal_lin_model)
    model = {"small": lin_ref_model, "small_thermal": lin_thermal_model,
             "flagship": lambda: flagship_model(n_spec=16, aerosol=True),
             "thermal": lambda: thermal_lin_model(16)}[scene]()
    return build_tangent_inputs(model, 0, default_layout(model), device=cuda)


def _mt_errors(outs, refs):
    """K2 against its plain version over several moments: the primal's
    max|d| / max|ref| per output, and each parameter's tangent max|d| over
    every output and moment against that parameter's max|ref| over the same
    (an output whose tangent cancels to rounding noise at one moment, as
    the profile-shape parameters' transmission does above m_scat, is judged
    on the parameter's scale)."""
    e_prim = max(_rel(a, b) for (p, _), (r, _) in zip(outs, refs)
                 for a, b in zip(p, r))
    e_tan = []
    for q in range(refs[0][1][0].shape[0]):
        d = max(float((a[q] - b[q]).abs().max())
                for (_, t), (_, r) in zip(outs, refs) for a, b in zip(t, r))
        scale = max(float(b[q].abs().max()) for _, r in refs for b in r)
        e_tan.append(d / scale if scale > 0 else d)
    return e_prim, e_tan


@pytest.mark.parametrize("scene,N", [("small", 21), ("flagship", 52),
                                     ("small_thermal", 21), ("thermal", 52)])
def test_mt_kernel_matches_plain_version(cuda, scene, N):
    """K2 (K1' for the thermal scenes, K = 2) against its plain version
    (forward-mode AD of the plain moment body) at moments 0, 1 and m_max,
    all 8 tangents: primal <= 1e-4 and each parameter's tangent outputs
    <= 2e-4 of that parameter's max|ref|. At K = 2 the thermal column of
    J0_p and J0_m is non-zero at m = 0 and exactly zero, tangents too,
    above it."""
    from vsmartmom_tpu_torch.ops.fused_lin import (
        fused_moment_multitangent, moment_multitangent_reference,
        multitangent_args)
    inputs, config, tangents = _lin_setup(cuda, scene)
    assert config.fused and config.N == N and len(tangents) == 8
    outs, refs = [], []
    for m in (0, 1, config.m_max):
        args = multitangent_args(inputs, tangents, config, m, cuda)
        before = fused_moment_multitangent.launches
        outs.append(fused_moment_multitangent(*args))
        torch.cuda.synchronize()
        assert fused_moment_multitangent.launches == before + 1
        refs.append(moment_multitangent_reference(*args))
        assert all(torch.isfinite(x).all() for x in (*outs[-1][0],
                                                      *outs[-1][1]))
        if config.n_sources == 2:
            (*_, Jp, Jm), (*_, dJp, dJm) = outs[-1]
            th = [x[..., 1] for x in (Jp, Jm, dJp, dJm)]
            if m == 0:
                assert all(bool((x != 0).any()) for x in th)
            else:
                assert all(bool((x == 0).all()) for x in th)
    e_prim, e_tan = _mt_errors(outs, refs)
    assert e_prim <= GATE and max(e_tan) <= 2e-4, (e_prim, e_tan)


def test_mt_kernel_shared_memory_fits_at_k2(cuda):
    """The C side's shared memory of a block is the host plan's at every
    width and source count the kernel takes, and the K = 2 layout at the
    widest N stays inside the 232,448 B a block may opt in to."""
    from vsmartmom_tpu_torch.ops import cuda_build
    from vsmartmom_tpu_torch.ops.fused_lin import mt_plan
    fn = cuda_build.load("fused_lin").vsm_fused_moment_mt_smem_bytes
    fn.restype = ctypes.c_size_t
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    for N in range(1, 53):
        for K in (1, 2):
            assert fn(N, K) == mt_plan(N, K, 8)["smem"] <= 232448, (N, K)
    assert fn(52, 2) == 222768


@pytest.mark.parametrize("P", [1, 3, 8, 11])
@pytest.mark.parametrize("K", [1, 2])
def test_mt_plan_is_the_c_launch(cuda, P, K):
    """The host plan is the C side's, and the card can hold its
    clusters."""
    from vsmartmom_tpu_torch.ops import fused_lin
    plan = fused_lin.mt_plan(52, K, P)
    info = fused_lin.mt_launch_info(52, K, P)
    for key in ("cluster", "groups", "threads", "smem", "tiles"):
        assert info[key] == plan[key], key
    assert info["max_clusters"] >= 1


@pytest.mark.parametrize("P", [1, 3, 8, 11],
                         ids=["P1", "P3", "P8", "P11"])
@pytest.mark.parametrize("scene,N", [("small", 21), ("flagship", 52),
                                     ("small_thermal", 21), ("thermal", 52)])
def test_mt_kernel_at_every_cluster_size(cuda, scene, N, P):
    """K2 / K1' with P tangents against its plain version at moments 0 and
    1: primal <= 1e-4, each parameter's tangents <= 2e-4 of its own max.
    Clusters of 1 and 3, two groups of 4 at P = 8 and three at P = 11
    (one rank idle). The scene's 8 tangents are sliced, or repeated at
    P = 11; a repeated tangent, computed in another group, comes out bit
    for bit as its original, and the primal is the same bits at every P
    (each primal element is computed by one block of a cluster and copied
    to the others)."""
    from vsmartmom_tpu_torch.ops.fused_lin import (
        fused_moment_multitangent, moment_multitangent_reference,
        multitangent_args)
    inputs, config, tangents = _lin_setup(cuda, scene)
    assert config.N == N
    tans = (tangents + tangents)[:P]
    outs, refs = [], []
    for m in (0, 1):
        args = multitangent_args(inputs, tans, config, m, cuda)
        outs.append(fused_moment_multitangent(*args))
        torch.cuda.synchronize()
        refs.append(moment_multitangent_reference(*args))
        assert all(torch.isfinite(x).all() for x in (*outs[-1][0],
                                                      *outs[-1][1]))
        if P == 11:
            for a in outs[-1][1]:
                assert torch.equal(a[8:], a[:3])
        one = fused_moment_multitangent(*multitangent_args(
            inputs, tans[:1], config, m, cuda))
        for a, b in zip(outs[-1][0], one[0]):
            assert torch.equal(a, b)
    e_prim, e_tan = _mt_errors(outs, refs)
    assert e_prim <= GATE and max(e_tan) <= 2e-4, (e_prim, e_tan)


@pytest.mark.parametrize("case", ["cluster", "groups", "smem", "tile_gap",
                                  "vec_short", "row_down"])
def test_mt_launch_refuses_a_foreign_plan(cuda, monkeypatch, case):
    """The C side launches only its own cluster size, group count and
    shared memory, and primal slabs that cut each output into consecutive
    slabs from 0 to its end."""
    from vsmartmom_tpu_torch.ops import fused_lin
    inputs, config, tangents = _lin_setup(cuda, "small")
    args = fused_lin.multitangent_args(inputs, tangents, config, 0, cuda)
    plan = fused_lin.mt_plan(config.N, 1, len(tangents))
    if case == "cluster":
        c = 2 * plan["cluster"] if plan["cluster"] < 8 else 4
        plan.update(cluster=c, groups=-(-len(tangents) // c), **{
            k: fused_lin._slabs(plan[k][-1], c)
            for k in ("tile_slab", "vec_slab", "row_slab")})
    elif case == "groups":
        plan["groups"] = 3
    elif case == "smem":
        plan["smem"] += 16
    elif case == "tile_gap":
        plan["tile_slab"][-1] += 1
    elif case == "vec_short":
        plan["vec_slab"][-1] -= 1
    else:
        plan["row_slab"][2] = plan["row_slab"][1] - 1
    monkeypatch.setattr(fused_lin, "mt_plan", lambda *a: plan)
    with pytest.raises(RuntimeError, match="launch failed"):
        fused_lin._launch_kernel(*args)


@pytest.mark.parametrize("case,match", [
    ("shape", "shape"), ("K3", "K <= 2"), ("wide", "N <= 52")])
def test_mt_wrapper_refuses_before_building(cuda, monkeypatch, case, match):
    from vsmartmom_tpu_torch.ops import cuda_build, fused_lin
    inputs, config, tangents = _lin_setup(cuda, "small")
    ops, dops, sched, ns_inter = fused_lin.multitangent_args(
        inputs, tangents, config, 0, cuda)
    if case == "shape":
        dops = dops._replace(Em1=dops.Em1[:, :, :1].contiguous())
    elif case == "K3":
        ops = ops._replace(j0_p=torch.cat([ops.j0_p] * 3, dim=-1))
    else:
        ops = ops._replace(Em1=torch.zeros(ops.Em1.shape[:2] + (56,),
                                           device=cuda))

    def no_build(name):
        raise AssertionError("the wrapper tried to build a kernel")
    monkeypatch.setattr(cuda_build, "load", no_build)
    with pytest.raises(ValueError, match=match):
        fused_lin.fused_moment_multitangent(ops, dops, sched, ns_inter)


def test_mt_kernel_path_matches_jvp_path(cuda):
    """rt_run_lin through K2 against the plain jvp route on the card: R
    1e-4, each parameter's dR 2e-4 of its max, dT 2e-4 of the stack's max
    (the profile-shape parameters' dT is ~1e-7 of the others' here, below
    what f32 resolves on its own scale)."""
    from vsmartmom_tpu_torch.core.linearization import rt_run_lin
    from vsmartmom_tpu_torch.flagship import lin_ref_model
    from vsmartmom_tpu_torch.ops.fused_lin import fused_moment_multitangent
    model = lin_ref_model()
    before = fused_moment_multitangent.launches
    R, _, dR, dT = rt_run_lin(model, device=cuda)
    # m = 0..m_scat = 6; m = 7 takes the Beer-law shortcut.
    assert fused_moment_multitangent.launches - before == 7
    model.params.fused = False
    R0, _, dR0, dT0 = rt_run_lin(model, device=cuda)
    assert np.abs(R - R0).max() <= GATE * np.abs(R0).max()
    assert np.abs(dT - dT0).max() <= 2e-4 * np.abs(dT0).max()
    for q in range(dR.shape[-1]):
        assert np.abs(dR[..., q] - dR0[..., q]).max() <= \
            2e-4 * np.abs(dR0[..., q]).max(), q


def test_fused_thermal_rt_run_lin_matches_jvp_path(cuda):
    """rt_run_lin of the small thermal scene (K = 2) through K1', counted:
    m_scat + 1 = 7 launches and no other kernel; R 1e-4, each parameter's
    dR 2e-4 of its max and dT 2e-4 of the stack's max against the plain
    jvp route on the card."""
    from vsmartmom_tpu_torch.core.linearization import rt_run_lin
    from vsmartmom_tpu_torch.flagship import lin_thermal_model
    from vsmartmom_tpu_torch.ops import fused_band, fused_lin
    model = lin_thermal_model()
    before = (fused_lin.fused_moment_multitangent.launches,
              fused_band.fused_moment.launches)
    R, _, dR, dT = rt_run_lin(model, device=cuda)
    assert (fused_lin.fused_moment_multitangent.launches - before[0],
            fused_band.fused_moment.launches - before[1]) == (7, 0)
    model.params.fused = False
    R0, _, dR0, dT0 = rt_run_lin(model, device=cuda)
    assert np.abs(R - R0).max() <= GATE * np.abs(R0).max()
    assert np.abs(dT - dT0).max() <= 2e-4 * np.abs(dT0).max()
    for q in range(dR.shape[-1]):
        assert np.abs(dR[..., q] - dR0[..., q]).max() <= \
            2e-4 * np.abs(dR0[..., q]).max(), q


def test_wide_scene_takes_the_jvp_route_on_the_card(cuda):
    """A scene wider than K2 takes (N = 60: K1 takes it, so build_band
    picks the band path) with the strategy left automatic: rt_run_lin
    warns, launches no kernel, and equals the jvp route (the same
    operations on the same card: 1e-6)."""
    from vsmartmom_tpu_torch import (Parameters, SurfaceDescriptor,
                                     model_from_parameters)
    from vsmartmom_tpu_torch.core.linearization import (build_tangent_inputs,
                                                        default_layout,
                                                        rt_run_lin,
                                                        rt_solve_jvp)
    from vsmartmom_tpu_torch.ops import fused_band, fused_lin
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_IQUV
    model = model_from_parameters(Parameters(
        spec_bands=[np.array([13000.0, 13000.5])],
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar", [0.1])],
        nstreams=12, polarization=STOKES_IQUV, sza=40.0, vza=[10.0, 45.0],
        vaz=[30.0, 150.0], obs_alt=0.0, T=np.array([250.0, 280.0]),
        p=np.array([300.0, 700.0, 1013.0]), depol=0.0,
        float_type=np.float32))
    before = (fused_lin.fused_moment_multitangent.launches,
              fused_band.fused_moment.launches)
    with pytest.warns(UserWarning, match="N = 60"):
        R, _, dR, _ = rt_run_lin(model, device=cuda)
    assert (fused_lin.fused_moment_multitangent.launches,
            fused_band.fused_moment.launches) == before
    inputs, config, tangents = build_tangent_inputs(
        model, 0, default_layout(model), device=cuda)
    assert config.fused and config.N == 60
    R0, _, dR0, _ = rt_solve_jvp(inputs, tangents,
                                 dataclasses.replace(config, fused=False),
                                 cuda)
    R0, dR0 = R0.cpu().numpy(), np.moveaxis(dR0.cpu().numpy(), 0, -1)
    assert np.abs(R - R0).max() <= 1e-6 * np.abs(R0).max()
    assert np.abs(dR - dR0).max() <= 1e-6 * np.abs(dR0).max()


def _layer_inputs(cuda, K, m=0, ek_form="point"):
    """K5's operands on the card for one moment of the flagship (N = 52,
    33 layers x 8 points, its probed schedule), from the port's own
    elemental operators: (r*, t, jp, jm*, expk, d_vec), config. K = 2 adds
    a seeded thermal source; m above m_scat is a purely absorbing moment
    (Z = 0: r = 0, t diagonal). The per-row expk form scales each row's
    attenuation by its own factor in [0.99, 1]."""
    from vsmartmom_tpu_torch.core.multisensor import layer_batch_args
    from vsmartmom_tpu_torch.core.solver import layer_batch
    from vsmartmom_tpu_torch.core.types import SolverInputs
    from vsmartmom_tpu_torch.flagship import flagship_model
    model = flagship_model(n_spec=8, nstreams=8)
    if K == 2:
        model.bands[0].thermal_b = np.random.default_rng(5).uniform(
            0.05, 0.5, (model.profile.nz, 8))
    inputs, config = model.build_band(0, device=cuda)
    assert config.N == 52 and config.n_sources == K and config.fused
    inp = SolverInputs(*(x.float() for x in inputs))
    layer_data, kw = layer_batch_args(inp, config, m)
    d = kw.pop("d_vec")
    r, t, jp, jm, ek = layer_batch(layer_data, **kw)
    if ek_form == "row":
        g = torch.Generator(device=cuda).manual_seed(0)
        ek = ek[:, None, :] * (1.0 - 0.01 * torch.rand(
            jp.shape, generator=g, device=cuda))
    return (r * d[:, None], t, jp, jm * d[:, None], ek, d), config


@pytest.mark.parametrize("K,ndoubl,ek_form", [
    (1, 0, "point"), (1, 8, "point"), (2, 8, "row"), (2, 0, "row")])
def test_doubling_kernel_matches_plain_version(cuda, K, ndoubl, ek_form):
    """K5 at N = 52 against ``doubling_reference`` on the card, on the
    flagship's elemental operators and probed NS schedule."""
    from vsmartmom_tpu_torch.ops.fused_rt import (doubling_reference,
                                                  fused_doubling)
    (r, t, jp, jm, ek, _), config = _layer_inputs(cuda, K, ek_form=ek_form)
    sched = config.ns_sched[:ndoubl]
    assert len(config.ns_sched) == 8
    before = fused_doubling.launches
    out = fused_doubling(r, t, jp, jm, ek, ndoubl, ns_sched=sched)
    torch.cuda.synchronize()
    assert fused_doubling.launches == before + 1
    ref = doubling_reference(r, t, jp, jm, ek, ndoubl, sched)
    for a, b in zip(out, ref):
        assert torch.isfinite(a).all() and _rel(a, b) <= GATE


def test_doubling_kernel_keeps_an_absorbing_layer_exact(cuda):
    """Moment 15 of the flagship (above m_scat, Z = 0): r = 0 and t
    diagonal, the kernel's O(N) path; with the seed I + 0 or with NS
    iterations every output equals the plain version's bit for bit (r
    exactly zero, t exactly diagonal), with no NaN from a zero row."""
    from vsmartmom_tpu_torch.ops.fused_rt import (doubling_reference,
                                                  fused_doubling)
    (r, t, jp, jm, ek, _), config = _layer_inputs(cuda, 2, m=15)
    assert config.m_scat < 15 <= config.m_max and (r == 0).all()
    off = ~torch.eye(52, dtype=torch.bool, device=cuda)
    for sched in ((0,) * 8, (3,) * 8):
        out = fused_doubling(r, t, jp, jm, ek, 8, ns_sched=sched)
        torch.cuda.synchronize()
        assert (out[0] == 0).all() and (out[1][:, off] == 0).all()
        ref = doubling_reference(r, t, jp, jm, ek, 8, sched)
        for a, b in zip(out, ref):
            assert torch.isfinite(a).all() and torch.equal(a, b)


def _misaligned(x):
    """x's values in a tensor whose data starts 4 bytes past a 16-byte
    boundary (contiguous, so the wrapper passes it on as it is)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("layout", ["N52", "N21", "N52-misaligned"])
@pytest.mark.parametrize("K", [1, 2])
def test_doubling_kernel_mixes_absorbing_and_scattering_blocks(cuda, K,
                                                               layout):
    """One launch over scattering layers (moment 0), absorbing ones (moment
    15: r = 0, t diagonal) and layers with r = 0 but t not diagonal (moment
    0's t): each block picks its own path on the device. Each block matches
    the plain version; the absorbing ones bit for bit; the r = 0 blocks
    with off-diagonal t took the dense ladder (the O(N) path would zero
    their off-diagonal t). At N = 52 the kernel loads, votes and stores by
    float4; N = 21 (the leading 21 x 21 block of each operator: odd, so
    N N % 4 != 0) and operands 4 bytes off a 16-byte boundary take its
    scalar load-and-vote and diagonal-store code."""
    from vsmartmom_tpu_torch.ops.fused_rt import (doubling_reference,
                                                  fused_doubling)
    (r0, t0, jp0, jm0, ek0, _), config = _layer_inputs(cuda, K, m=0)
    (r1, t1, jp1, jm1, ek1, _), _ = _layer_inputs(cuda, K, m=15)
    n = 40                                  # points of each kind
    ops = [torch.cat([a[:n], b[:n], c[n:2 * n]]).contiguous()
           for a, b, c in zip((r0, t0, jp0, jm0, ek0),
                              (r1, t1, jp1, jm1, ek1),
                              (torch.zeros_like(r0), t0, jp0, jm0, ek0))]
    N = 21 if layout == "N21" else 52
    if N != 52:
        ops = [x[:, :N, :N].contiguous() for x in ops[:2]] + \
            [x[:, :N].contiguous() for x in ops[2:4]] + [ops[4]]
    if layout.endswith("misaligned"):
        ops = [_misaligned(x) for x in ops]
    off = ~torch.eye(N, dtype=torch.bool, device=cuda)
    assert (ops[1][2 * n:][:, off] != 0).any()
    assert (ops[0][n:] == 0).all() and (ops[1][n:2 * n][:, off] == 0).all()
    sched = config.ns_sched
    out = fused_doubling(*ops, 8, ns_sched=sched)
    torch.cuda.synchronize()
    ref = doubling_reference(*ops, 8, sched)
    for a, b in zip(out, ref):
        assert torch.isfinite(a).all()
        assert _rel(a[:n], b[:n]) <= GATE
        assert torch.equal(a[n:2 * n], b[n:2 * n])
        assert _rel(a[2 * n:], b[2 * n:]) <= GATE
    assert (out[0][n:2 * n] == 0).all()
    assert (out[1][2 * n:][:, off] != 0).any()


@pytest.mark.parametrize("N", [52, 21])
@pytest.mark.parametrize("K,ndoubl,ek_form", [
    (1, 0, "point"), (1, 8, "row"), (2, 8, "point"), (2, 0, "row")])
def test_layer_step_kernel_matches_plain_version(cuda, K, ndoubl, ek_form,
                                                 N):
    """K4 against ``layer_step_reference``: layer 1 of the flagship added
    onto the composite of layer 0, at N = 52 and at N = 21 (the leading
    21 x 21 block of each operator: odd, the tiles' ragged edges). K4 runs
    K5's ladder and K1's adding on csrc/fp32_tile.cuh: its matrices round
    as the plain matmuls do, bit for bit; its source vectors sum four
    partial sums a row, so J0_p and J0_m are held to K1's gate, <= 1e-4 of
    max|ref| and no farther from the plain step in f64 than twice the f32
    plain step."""
    from vsmartmom_tpu_torch.core.kernels import identity_composite
    from vsmartmom_tpu_torch.ops.fused_rt import (fused_layer_step,
                                                  layer_step_blocks_per_sm,
                                                  layer_step_reference)
    ops, config = _layer_inputs(cuda, K, ek_form=ek_form)
    r, t, jp, jm, ek, d = ops
    sched = config.ns_sched[:ndoubl]
    lay = [tuple(x.reshape(33, 8, *x.shape[1:])[z] for x in ops[:5])
           for z in (0, 1)]
    if N != 52:
        lay = [(r[:, :N, :N], t[:, :N, :N], jp[:, :N], jm[:, :N],
                ek if ek.dim() == 2 else ek[:, :N])
               for r, t, jp, jm, ek in lay]
        lay = [tuple(x.contiguous() for x in z) for z in lay]
        d = d[:N].contiguous()
    comp = layer_step_reference(
        identity_composite(8, N, torch.float32, cuda, K), *lay[0], d,
        ndoubl, sched, config.ns_inter)
    before = fused_layer_step.launches
    out = fused_layer_step(comp, *lay[1], d, ndoubl, ns_sched=sched,
                           ns_inter=config.ns_inter)
    torch.cuda.synchronize()
    assert fused_layer_step.launches == before + 1
    ref = layer_step_reference(comp, *lay[1], d, ndoubl, sched,
                               config.ns_inter)
    ref64 = layer_step_reference(
        [x.double() for x in comp], *(x.double() for x in lay[1]),
        d.double(), ndoubl, sched, config.ns_inter)
    for k, (a, b, c) in enumerate(zip(out, ref, ref64)):
        assert torch.isfinite(a).all()
        if k < 4:
            assert torch.equal(a, b), k
        else:
            assert _rel(a, b) <= GATE
            assert _rel(a.double(), c) <= 2.0 * _rel(b.double(), c), k
    assert layer_step_blocks_per_sm(N, K) == 2


def test_ms_kernel_route_matches_plain_route(cuda):
    """rt_solve_ms through K5 (one launch per moment) against the plain
    (LU) route on the card, per level; level 0 against the band path's
    rt_solve R and T."""
    from vsmartmom_tpu_torch.core.multisensor import rt_solve_ms
    from vsmartmom_tpu_torch.core.solver import rt_solve
    from vsmartmom_tpu_torch.ops.fused_rt import fused_doubling
    inputs, config = _model(16).build_band(0, device=cuda)
    assert config.fused
    levels = (0, 5, 16, config.nz)
    before = fused_doubling.launches
    out = rt_solve_ms(inputs, config, levels, cuda)
    assert fused_doubling.launches - before == config.m_max + 1
    plain = rt_solve_ms(inputs, dataclasses.replace(config, fused=False),
                        levels, cuda)
    for k in ("uwJ", "dwJ"):
        assert torch.isfinite(out[k]).all()
        for i in range(len(levels)):
            assert _rel(out[k][i], plain[k][i]) <= GATE, (k, levels[i])
    band = rt_solve(inputs, config, cuda)
    assert _rel(out["uwJ"][0], band["R"]) <= GATE
    assert _rel(out["dwJ"][0], band["T"]) <= GATE


# ---- the probe kernels (dot_chain, lane_dot_chain, layout, band stages) ----
# Gate 1e-5 of max|plain|: the kernels repeat their plain versions' FP32
# arithmetic (TF32 modes on the same rounded operands) in another order of
# sums. A TF32 chain is held step by step: one FP32 ulp of that order can
# move an operand to the neighbouring TF32 value, and the chain carries it.
PROBE_GATE = 1e-5


def _probe_pair(cuda, form, n, seed, batch=4):
    """x (batch, n, n) and y (batch, n, c), c = 3n + 5 for sum and single
    (not a multiple of any column slab)."""
    g = np.random.default_rng(seed)
    c = 3 * n + 5 if form in ("sum", "single") else n
    x = g.random((batch, n, n)) / n
    y = g.standard_normal((batch, n, c))
    if form == "left":
        x = 0.2 * g.standard_normal((batch, n, n)) / np.sqrt(n)
    return (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (x, y))


@pytest.mark.parametrize("batch", [1, 2048])
@pytest.mark.parametrize("n", [1, 13, 52, 100, 104, 128])
@pytest.mark.parametrize("mode", ["fp32", "tf32", "3xtf32"])
@pytest.mark.parametrize("form", ["right", "left", "sum", "single"])
def test_dot_chain_matches_plain_version(cuda, form, mode, n, batch):
    """Every form and mode at ragged widths, batch 1 and 2048, against the
    plain version (a TF32 chain at its last step, from the kernel's own
    step before: its drift is not gated); each chain equals its own last
    step from its result one step shorter, bit for bit."""
    from vsmartmom_tpu_torch.ops.probe_dots import (dot_chain,
                                                    dot_chain_reference)
    x, y = _probe_pair(cuda, form, n, seed=n, batch=batch)
    kw = dict(form=form, mode=mode, scale=0.5 if form == "right" else 1.0)
    if form in ("right", "left"):
        kw["chain"] = 3
    if form == "sum":
        kw["ndot"] = 3
    before = dot_chain.launches
    out = dot_chain(x, y, **kw)
    torch.cuda.synchronize()
    assert dot_chain.launches == before + 1
    assert torch.isfinite(out).all()
    if form in ("right", "left"):
        prev = dot_chain(x, y, **dict(kw, chain=2))
        a, b = (prev, y) if form == "right" else (x, prev)
        one = dot_chain(a, b, **dict(kw, chain=1))
        assert torch.equal(one, out)
    if mode == "tf32" and form in ("right", "left"):
        ref = dot_chain_reference(a, b, **dict(kw, chain=1))
    else:
        ref = dot_chain_reference(x, y, **kw)
    assert _rel(out, ref) <= PROBE_GATE


@pytest.mark.parametrize("n,s,chain", [
    (52, 100, 1), (52, 100, 3), (52, 2048, 2), (52, 101, 3), (52, 1, 2),
    (13, 6, 3), (13, 2, 1), (64, 7, 2)])
def test_lane_dot_chain_matches_plain_version(cuda, n, s, chain):
    """The (n, n, s) chain with s a multiple of the block's points and not,
    s below them, chain 1 and longer; a chain equals its own last step bit
    for bit."""
    from vsmartmom_tpu_torch.ops.probe_dots import (lane_dot_chain,
                                                    lane_dot_chain_reference)
    a = torch.from_numpy((np.random.default_rng(s).random((n, n, s)) / n)
                         .astype(np.float32)).to(cuda)
    out = lane_dot_chain(a, a, chain, 0.25)
    torch.cuda.synchronize()
    ref = lane_dot_chain_reference(a, a, chain, 0.25)
    assert torch.isfinite(out).all() and _rel(out, ref) <= PROBE_GATE
    if chain > 1:
        prev = lane_dot_chain(a, a, chain - 1, 0.25)
        assert torch.equal(lane_dot_chain(prev, a, 1, 0.25), out)


@pytest.mark.parametrize("mode", ["fp32", "tf32", "3xtf32"])
def test_dot_chain_plan_is_the_c_launch(cuda, mode):
    """The host plan is the launch the C side makes of it, and at least one
    block of it is resident on an SM."""
    from vsmartmom_tpu_torch.ops.probe_dots import (dot_chain_plan,
                                                    lane_dot_chain_plan,
                                                    launch_info)
    for batch, n, c, form in [(2048, 52, 52, "right"), (2048, 104, 104,
                                                         "right"),
                              (512, 104, 104, "left"), (512, 104, 312, "sum"),
                              (8, 104, 104, "single"), (3, 13, 44, "sum")]:
        plan = dot_chain_plan(batch, n, c, form, mode)
        grid, threads, smem, per_sm = launch_info("dot", batch, n, c, form,
                                                  mode, plan)
        assert (grid, threads, smem) == (plan.grid, plan.threads, plan.smem)
        assert per_sm >= 1
    plan = lane_dot_chain_plan(52, 2048)
    assert launch_info("lane", 52, 2048, plan)[:3] == (
        plan.grid, plan.threads, plan.smem)


@pytest.mark.parametrize("case", range(16))
def test_layout_cases_are_exact(cuda, case):
    """Each of the layout probe's sixteen cases equals its torch expression
    exactly (inputs on a 1/256 grid: every sum is exact)."""
    from vsmartmom_tpu_torch.ops.probe_layout import (layout_op,
                                                      layout_op_reference)
    from vsmartmom_tpu_torch.probes.layout_ops import inputs
    ins = inputs(case, cuda)
    out = layout_op(case, *ins)
    torch.cuda.synchronize()
    assert torch.equal(out, layout_op_reference(case, *ins))


@pytest.mark.parametrize("n", [21, 24])
@pytest.mark.parametrize("case", [0, 6, 7, 8])
def test_layout_copy_cases_are_exact_at_any_width(cuda, case, n):
    """The copy cases (squeeze, reshape merge and split, minor concat) on
    their float4 path (N = 24) and their float path (N = 21)."""
    from vsmartmom_tpu_torch.ops.probe_layout import (layout_op,
                                                      layout_op_reference)
    from vsmartmom_tpu_torch.probes.layout_ops import inputs
    ins = inputs(case, cuda, b=6, n=n)
    out = layout_op(case, *ins)
    torch.cuda.synchronize()
    assert torch.equal(out, layout_op_reference(case, *ins))


#: (nz, S, N) of the band-stage card tests: the probe's own shape, then
#: every mix of nz 1, 4, 7, S 2, 34 and N 5, 12, 32 (2N <= 64).
BAND_SHAPES = [(4, 32, 12)] + [(nz, S, N) for nz in (1, 4, 7)
                               for S in (2, 34) for N in (5, 12, 32)]
BAND_STAGES = ["acc", "elem", "src", "pack", "dbl", "full"]
#: The probe's inputs, the bounded ones and the thin ones (on which every
#: stage stays finite at every shape, full's chain of adding steps too).
BAND_KINDS = ["probe", "bounded", "thin"]


def _bits(x):
    return x.contiguous().view(torch.int32)


def _band_ids(s):
    return "nz{}-S{}-N{}".format(*s)


@pytest.mark.parametrize("shape", BAND_SHAPES, ids=_band_ids)
@pytest.mark.parametrize("kind", BAND_KINDS)
@pytest.mark.parametrize("stage", BAND_STAGES)
def test_band_stages_match_plain_version(cuda, stage, kind, shape):
    """NaN where the plain version is NaN, 1e-5 of max|plain| where it is
    finite, on the band probe's own, bounded and thin inputs, at the
    probe's shape and at the other widths, strip counts and depths; on the
    thin inputs the plain version is finite throughout (so full's chain,
    every layer's record read after the one before, is compared value for
    value at every depth); pack (the elemental operators, each operation
    rounded as the plain version's) is the plain version's bits."""
    from vsmartmom_tpu_torch.ops.band_stages import (band_stages,
                                                     band_stages_reference)
    from vsmartmom_tpu_torch.probes.band_bisect import compare, inputs
    nz, S, N = shape
    tau, Em1, aux = inputs(kind, cuda, nz=nz, s=S, n=N)
    out = band_stages(stage, tau, Em1, aux)
    torch.cuda.synchronize()
    ref = band_stages_reference(stage, tau, Em1, aux)
    same, err, _ = compare(out, ref)
    assert same and err <= PROBE_GATE
    if kind == "thin":
        assert bool(torch.isfinite(ref).all())
    if stage == "pack":
        assert torch.equal(out, ref)


def _band_f64_finite(kind, stage, shape):
    """Whether the plain version, in f32 and in f64, is finite throughout:
    everywhere on the thin inputs; on the bounded ones in the elementwise
    stages, and for N < 32 in dbl and in full at one layer (its all-ones T
    overflows the composite from the second layer on, and at N = 32 the
    bounded operators overflow the ladder)."""
    nz, _, N = shape
    return (kind == "thin" or stage in ("acc", "elem", "src", "pack")
            or (N < 32 and (stage == "dbl" or nz == 1)))


@pytest.mark.parametrize("kind,stage,shape", [
    (kind, stage, shape) for kind in ("bounded", "thin")
    for stage in BAND_STAGES for shape in BAND_SHAPES
    if _band_f64_finite(kind, stage, shape)],
    ids=lambda v: _band_ids(v) if isinstance(v, tuple) else v)
def test_band_stages_as_close_to_f64_as_the_plain_version(cuda, kind, stage,
                                                          shape):
    """Where the f32 plain version and the plain version run in f64 are
    both finite throughout (``_band_f64_finite``, asserted), the kernel is
    at most twice as far from the f64 values as the f32 plain version
    (max|d| / max|f64|). The f32 output's own rounding is up to 2^-24 of
    max|f64|, so the ratio is taken against at least 2^-23. On the thin
    inputs full's chain sums hundreds of products into each output: there
    the f32 plain version is also run on the CPU, whose small products sum
    in depth order as the kernel's tile does (the card's matmul orders
    them otherwise), and its larger distance is the yardstick."""
    from vsmartmom_tpu_torch.ops.band_stages import (band_stages,
                                                     band_stages_reference)
    from vsmartmom_tpu_torch.probes.band_bisect import inputs
    nz, S, N = shape
    tau, Em1, aux = inputs(kind, cuda, nz=nz, s=S, n=N)
    out = band_stages(stage, tau, Em1, aux)
    torch.cuda.synchronize()
    ref = band_stages_reference(stage, tau, Em1, aux)
    ref64 = band_stages_reference(stage, tau.double(), Em1.double(),
                                  aux.double())
    assert bool((torch.isfinite(ref) & torch.isfinite(ref64)).all())
    kernel = _rel(out.double(), ref64)
    plain = _rel(ref.double(), ref64)
    if kind == "thin":
        cpu = band_stages_reference(stage, tau.cpu(), Em1.cpu(), aux.cpu())
        plain = max(plain, _rel(cpu.double(), ref64.cpu()))
    assert kernel <= 2.0 * max(plain, 2.0 ** -23), (kernel, plain)


@pytest.mark.parametrize("shape", [(4, 32, 12), (7, 34, 32)], ids=_band_ids)
@pytest.mark.parametrize("kind", BAND_KINDS)
@pytest.mark.parametrize("stage", BAND_STAGES)
def test_band_stages_same_bits_every_run_and_block(cuda, stage, kind, shape):
    """Three calls give the same bits, NaNs included; a summing stage holds
    one value in every block (each block sums every layer in one fixed
    order, with no atomics)."""
    from vsmartmom_tpu_torch.ops.band_stages import band_stages
    from vsmartmom_tpu_torch.probes.band_bisect import inputs
    nz, S, N = shape
    tau, Em1, aux = inputs(kind, cuda, nz=nz, s=S, n=N)
    runs = [_bits(band_stages(stage, tau, Em1, aux)) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    if stage in ("acc", "elem", "src"):
        assert bool((runs[0] == runs[0].flatten()[0]).all())


@pytest.mark.parametrize("stage", BAND_STAGES)
def test_band_plan_fits_every_width(cuda, stage):
    """The C side's plan (``band_plan``) for every 2N <= 64, nz <= 8 and S
    2, 34: every block within the 232,448 B of shared memory a block may
    opt in to and within 1024 threads in whole warps; the summing stages
    one launch of S / 2 blocks, pack and dbl one of S / 2 x nz blocks, full
    that one and a chain of S / 2 blocks; the scratch one (r, t, jp, jm)
    record a pair and layer."""
    from vsmartmom_tpu_torch.ops.band_stages import (KERNEL_MAX_NP, PACK,
                                                     band_plan)
    for N in range(1, KERNEL_MAX_NP // PACK + 1):
        Np = PACK * N
        LD = -(-Np // 4) * 4
        for nz in range(1, 9):
            for S in (2, 34):
                plan = band_plan(stage, nz, S, N)
                for x in plan["launches"]:
                    assert x["smem"] <= 232448, (N, nz, x)
                    assert 32 <= x["threads"] <= 1024
                    assert x["threads"] % 32 == 0
                kernels = [x["kernel"] for x in plan["launches"]]
                grids = [x["grid"] for x in plan["launches"]]
                if stage in ("acc", "elem", "src"):
                    assert kernels == ["sum_kernel"]
                    assert grids == [(S // 2, 1)]
                    assert plan["scratch"] == 0
                elif stage == "full":
                    assert kernels == ["layer_kernel", "chain_kernel"]
                    assert grids == [(S // 2, nz), (S // 2, 1)]
                else:
                    assert kernels == ["layer_kernel"]
                    assert grids == [(S // 2, nz)]
                if stage in ("pack", "dbl", "full"):
                    assert plan["scratch"] == nz * (S // 2) * 2 * (Np + 1) * LD


@pytest.mark.parametrize("stage", BAND_STAGES)
def test_band_chain_launch_is_counted_for_full_alone(cuda, stage):
    """A full call launches the chain kernel once after its layer launch
    (``_launch_chain.launches``); no other stage launches it. Either way
    the wrapper call counts once in ``band_stages.launches``."""
    from vsmartmom_tpu_torch.ops.band_stages import _launch_chain, band_stages
    from vsmartmom_tpu_torch.probes.band_bisect import inputs
    tau, Em1, aux = inputs("thin", cuda)
    band_stages.launches = _launch_chain.launches = 0
    band_stages(stage, tau, Em1, aux)
    torch.cuda.synchronize()
    assert band_stages.launches == 1
    assert _launch_chain.launches == (stage == "full")


def test_band_full_stage_is_finite_at_one_layer(cuda):
    """The full stage on the bounded inputs at one layer is finite
    throughout, in the kernel and in the plain version, and within 1e-5 of
    max|plain|."""
    from vsmartmom_tpu_torch.ops.band_stages import (band_stages,
                                                     band_stages_reference)
    from vsmartmom_tpu_torch.probes.band_bisect import FINITE_CASE, inputs
    stage, kind, nz = FINITE_CASE
    tau, Em1, aux = inputs(kind, cuda, nz=nz)
    out = band_stages(stage, tau, Em1, aux)
    torch.cuda.synchronize()
    ref = band_stages_reference(stage, tau, Em1, aux)
    assert torch.isfinite(ref).all() and torch.isfinite(out).all()
    assert _rel(out, ref) <= PROBE_GATE


def test_probe_wrappers_refuse_before_building(cuda, monkeypatch):
    """On the card too, operands the kernels do not take are refused before
    any build."""
    from vsmartmom_tpu_torch.ops import cuda_build, probe_dots

    def no_build(name):
        raise AssertionError("the wrapper tried to build a kernel")
    monkeypatch.setattr(cuda_build, "load", no_build)
    x = torch.zeros((2, 130, 130), device=cuda)
    with pytest.raises(ValueError, match="n <= 128"):
        probe_dots.dot_chain(x, x, "right")
    with pytest.raises(ValueError, match="float32"):
        probe_dots.dot_chain(x[:, :8, :8].double().contiguous(),
                             x[:, :8, :8].contiguous(), "right")
