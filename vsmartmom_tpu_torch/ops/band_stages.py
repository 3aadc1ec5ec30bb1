"""The band-body probe's six stages (scripts/probe_band_bisect.py), with
their plain version.

``band_stages(stage, tau, Em1, aux)`` computes what the probe's Pallas
kernel writes for that stage: tau (nz, 1, S), Em1 (nz, S, N), aux (8, N)
(row 0 the stream nodes, row 1 their weights) in, (S / 2, 2N, 2N) out, the
z grid run in order with a carry (see ``STAGES``). CUDA tensors launch the
hand-written kernels of ``csrc/band_stages.cu`` (each wrapper call counted
once in ``band_stages.launches``, full's second launch in
``_launch_chain.launches``; ``band_plan`` reads the C side's launch plan);
CPU tensors run ``band_stages_reference``, which calls the port's ladder and
adding algebra (``ops/fused_rt.doubling_math`` and ``interaction_math``,
the counterparts of the JAX package's ``_doubling_math`` and
``_interaction_math``).
"""

import ctypes

import torch

from .fused_rt import doubling_math, interaction_math
from .probe_dots import _check_tensors

#: The probe's stages in order; each adds one part of the band body.
STAGES = ("acc", "elem", "src", "pack", "dbl", "full")
#: The probe's packing (points per block-diagonal operator), NS schedule
#: of the ladder and NS count of the adding step.
PACK = 2
SCHED = (1, 1, 2, 2)
NS_INTER = 3
#: Largest packed width 2N the kernel takes (as K5; VSM_BAND_MAX_NP of
#: csrc/band_stages.cu): the wrapper refuses wider operands before any
#: build.
KERNEL_MAX_NP = 64


def _load_lib():
    from .cuda_build import load
    lib = load("band_stages")
    lib.vsm_band_stage_f32.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                              ctypes.c_void_p]
    lib.vsm_band_stage_f32.restype = ctypes.c_int
    lib.vsm_band_chain_f32.argtypes = [ctypes.c_void_p] * 2 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.vsm_band_chain_f32.restype = ctypes.c_int
    lib.vsm_band_plan.argtypes = [ctypes.c_int] * 4 + \
        [ctypes.POINTER(ctypes.c_int)]
    lib.vsm_band_plan.restype = ctypes.c_int
    lib.vsm_band_error_string.argtypes = [ctypes.c_int]
    lib.vsm_band_error_string.restype = ctypes.c_char_p
    return lib


def band_plan(stage, nz, S, N):
    """The launches of one stage at (nz, S, N), as csrc/band_stages.cu makes
    them (``vsm_band_plan``; builds the kernel): a list of {kernel, grid,
    threads, smem} (smem the block's shared bytes, static for sum_kernel,
    dynamic for the others) and ``scratch``, the floats of the per-layer
    records the packed stages keep in device memory.

    acc, elem, src: one sum_kernel launch, S / 2 blocks (one an output
    pair). pack, dbl: one layer_kernel launch, S / 2 x nz blocks (one a
    pair and layer). full: that launch, then chain_kernel, S / 2 blocks
    that walk the nz adding steps."""
    lib = _load_lib()
    info = (ctypes.c_int * 9)()
    rc = lib.vsm_band_plan(STAGES.index(stage), nz, S, N, info)
    if rc != 0:
        raise RuntimeError("band_stages plan query failed: "
                           + lib.vsm_band_error_string(rc).decode())
    names = (["sum_kernel"] if STAGES.index(stage) < STAGES.index("pack")
             else ["layer_kernel", "chain_kernel"])
    launches = [{"kernel": names[0], "grid": (info[1], info[4]),
                 "threads": info[2], "smem": info[3]}]
    if info[0] == 2:
        launches.append({"kernel": names[1], "grid": (info[5], 1),
                         "threads": info[6], "smem": info[7]})
    return {"launches": launches, "scratch": info[8]}


def elemental(tau, Em1, aux):
    """The probe's elemental stand-ins of one layer: r-+ and t++ (b, N, N)
    from tau (b,), Em1 (b, N) and the nodes and weights in aux rows 0, 1."""
    N = Em1.shape[-1]
    mu_i, mu_j = aux[0][:, None], aux[0][None, :]
    wct = aux[1]
    r_geom = (mu_j / (mu_i + mu_j)) * wct[None, :]
    one_m_EE = -(Em1[:, :, None] + Em1[:, None, :]
                 + Em1[:, :, None] * Em1[:, None, :])
    r_mp = r_geom[None] * one_m_EE
    same_mu = (mu_i - mu_j).abs() <= 1e-9 * torch.maximum(mu_i, mu_j)
    delta = torch.where(same_mu, torch.ones_like(mu_i - mu_j), mu_i - mu_j)
    series = (tau / 16.0)[:, None, None] * (delta / (mu_i * mu_j))[None]
    ratio = (torch.exp(series) - 1.0) / delta[None]
    t_off = (mu_j * wct[None, :])[None] * (1.0 + Em1[:, None, :]) * ratio
    eye = torch.eye(N, dtype=Em1.dtype, device=Em1.device)
    beer = (1.0 + Em1[:, :, None]) * eye[None]
    t_pp = torch.where(same_mu[None], t_off + beer, t_off)
    return r_mp, t_pp


def blockdiag(x, pack=PACK):
    """(b, N, N) -> (b / pack, pack N, pack N), each group of ``pack``
    points on the diagonal."""
    b, N = x.shape[0], x.shape[-1]
    out = x.new_zeros(b // pack, pack * N, pack * N)
    for q in range(pack):
        out[:, q * N:(q + 1) * N, q * N:(q + 1) * N] = x[q::pack]
    return out


def band_stages_reference(stage, tau, Em1, aux):
    """The plain version of ``band_stages``: the probe's body, layer by
    layer, with the carry (S / 2, 2N, 2N) starting at zero."""
    nz, S, N = Em1.shape
    bp, Np = S // PACK, PACK * N
    acc = tau.new_zeros(bp, Np, Np)
    for z in range(nz):
        t_z, em = tau[z, 0], Em1[z]
        if stage == "acc":
            val = t_z[:, None, None].expand(S, N, N) + 0.0 * em[:, :, None]
            acc = acc * 0.0 + val.sum()
            continue
        r_mp, t_pp = elemental(t_z, em, aux)
        if stage in ("elem", "src"):
            acc = acc * 0.0 + r_mp.sum()
            continue
        rp, tp = blockdiag(r_mp), blockdiag(t_pp)
        jpp = r_mp[:, :, :1].reshape(bp, Np, 1)
        ekp = t_z[:, None, None].expand(S, N, 1).reshape(bp, Np, 1)
        if stage == "pack":
            acc = rp
            continue
        r, t, jp, jm = doubling_math(rp, tp, jpp, jpp, ekp, SCHED)
        if stage == "dbl":
            acc = r
            continue
        one = acc * 0 + 1.0
        acc = interaction_math(acc, acc, one, one, acc[:, :, :1],
                               acc[:, :, :1], r, r, t, t, jp, jm,
                               NS_INTER)[0]
    return acc


def _launch_band(stage, tau, Em1, aux):
    """Check the operands, then one call of the band-stage kernels: one
    launch, and for full ``_launch_chain`` after it."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} not in {STAGES}")
    if Em1.dim() != 3:
        raise ValueError(f"Em1 must be (nz, S, N), got {tuple(Em1.shape)}")
    nz, S, N = Em1.shape
    if S % PACK or PACK * N > KERNEL_MAX_NP:
        raise ValueError(f"the kernel takes an even S and 2N <= "
                         f"{KERNEL_MAX_NP}, got S={S}, N={N}")
    _check_tensors([("tau", tau, (nz, 1, S)), ("Em1", Em1, (nz, S, N)),
                    ("aux", aux, (8, N))])
    dev = Em1.device
    lib = _load_lib()
    out = torch.empty((S // PACK, PACK * N, PACK * N), dtype=torch.float32,
                      device=dev)
    scratch = torch.empty((band_plan(stage, nz, S, N)["scratch"],),
                          dtype=torch.float32, device=dev)
    c_sched = (ctypes.c_int * len(SCHED))(*SCHED)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vsm_band_stage_f32(
            tau.data_ptr(), Em1.data_ptr(), aux.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), nz, S, N, STAGES.index(stage), len(SCHED),
            c_sched, NS_INTER, stream)
    if rc != 0:
        raise RuntimeError("band_stages launch failed: "
                           + lib.vsm_band_error_string(rc).decode())
    if stage == "full":
        _launch_chain(lib, out, scratch, nz, S, N)
    return out


def _launch_chain(lib, out, scratch, nz, S, N):
    """full's second launch (chain_kernel) on the current stream: each
    pair's nz adding steps from the scratch the layer launch wrote, into
    out. Counted in ``_launch_chain.launches``."""
    dev = out.device
    with torch.cuda.device(dev):
        rc = lib.vsm_band_chain_f32(
            out.data_ptr(), scratch.data_ptr(), nz, S, N, NS_INTER,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("band_stages chain launch failed: "
                           + lib.vsm_band_error_string(rc).decode())
    _launch_chain.launches += 1


_launch_chain.launches = 0


def band_stages(stage, tau, Em1, aux):
    """One stage of the band-body probe (``STAGES``) on tau (nz, 1, S),
    Em1 (nz, S, N) and aux (8, N); returns the carry after the last layer,
    (S / 2, 2N, 2N).

    CUDA tensors launch the kernels of ``csrc/band_stages.cu`` (each call
    counted once in ``band_stages.launches``; full makes two CUDA
    launches, the second counted in ``_launch_chain.launches``), which
    replace the Pallas kernel of
    scripts/probe_band_bisect.py:113: every layer's elemental operators
    and ladder at once, then, for full, the adding steps as a chain.
    Latency-bound at the probe's shapes. CPU tensors run
    ``band_stages_reference``.
    """
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} not in {STAGES}")
    if Em1.device.type == "cpu":
        return band_stages_reference(stage, tau, Em1, aux)
    out = _launch_band(stage, tau, Em1, aux)
    band_stages.launches += 1
    return out


band_stages.launches = 0
