"""Shared ladder algebra of the band path, as plain torch.

Counterpart of the algebra in ``vsmartmom_tpu/ops/fused_rt.py`` that the
whole-moment band kernel runs (``_ns_inverse`` :111-127, ``_doubling_math``
:241-290, ``_interaction_math`` :327-360), in its exact-f32 ("highest")
mode only. ``moment_reference`` (ops/fused_band.py) runs it batched over the
spectral axis; ``csrc/fused_band.cu`` runs the same algebra per spectral
point in shared memory. What it keeps from the JAX package:

* the geometric-series factor (I - S)^-1 is a Newton-Schulz iteration from
  the Neumann seed I + S on a scene-probed per-doubling-step schedule, where
  0 iterations means the seed alone (ops/ns_schedule.py);
* the interaction's second inverse comes from the push-through identity
  (I - B A)^-1 = I + B (I - A B)^-1 A, so each layer costs one inverse;
* the thin source-vector products ride the matrix products by column
  concatenation.

It also holds the per-layer kernels' wrappers: ``fused_doubling`` (K5, the
doubling ladder on starred operators, which the multisensor driver runs for
every layer of a moment in one launch) and ``fused_layer_step`` (K4, the
ladder plus the adding step for one layer), each beside its plain version
(``doubling_reference``, ``layer_step_reference``). Left behind from the TPU
kernels: ``block``/``pick_block``, ``interpret``, block-diagonal packing,
``use_fused`` and every ``dot_mode`` but "highest".
"""

import ctypes

import torch

#: Newton-Schulz iterations when no scene schedule is given:
#: error rho^(2^(k+1)); k = 6 reaches rho^128.
NS_ITERS = 6


def norm_sched(ns_sched, ndoubl):
    """Per-doubling-step NS schedule as a tuple of length ndoubl
    (None/() -> NS_ITERS everywhere; an int -> that count everywhere)."""
    if ns_sched is None or ns_sched == ():
        return (NS_ITERS,) * ndoubl
    if isinstance(ns_sched, int):
        ns_sched = (ns_sched,) * ndoubl
    ns_sched = tuple(int(k) for k in ns_sched)
    if len(ns_sched) != ndoubl or min(ns_sched, default=0) < 0:
        raise ValueError(f"NS schedule {ns_sched} does not fit {ndoubl} "
                         "doubling steps")
    return ns_sched


def _eye_like(S):
    return torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)


def ns_inverse(S, ns_iters: int):
    """(I - S)^-1 by Newton-Schulz from the Neumann seed I + S:
    m <- m (2I - m + S m); error ||I - m (I - S)|| = rho(S)^(2^(k+1))."""
    eye = _eye_like(S)
    m = eye + S
    for _ in range(ns_iters):
        m = m @ (2.0 * eye - m + S @ m)
    return m


def doubling_math(r, t, jp, jm, ek, ns_sched):
    """The doubling ladder on starred operators: r, t (b, N, N); jp, jm
    (b, N, K); ek (b, 1, K) per-point beam attenuation, squared every step."""
    N = r.shape[-1]
    K = jp.shape[-1]
    for ns_iters in ns_sched:
        gp = ns_inverse(r @ r, ns_iters)
        tt_gp = t @ gp
        jm_e = jm * ek
        X = r @ torch.cat([t, jp, jm_e], dim=-1)
        rt, r_jp, r_jme = X[..., :N], X[..., N:N + K], X[..., N + K:]
        Y = tt_gp @ torch.cat([t, rt, jm_e + r_jp, jp + r_jme], dim=-1)
        t_new = Y[..., :N]
        r = r + Y[..., N:2 * N]
        jm = jm + Y[..., 2 * N:2 * N + K]
        jp = jp * ek + Y[..., 2 * N + K:]
        t = t_new
        ek = ek * ek
    return r, t, jp, jm


def interaction_math(R_mp, R_pm, T_pp, T_mm, J0_p, J0_m,
                     r_mp, r_pm, t_pp, t_mm, j0_p, j0_m, ns_iters: int):
    """Adding step (Sanghavi 2014 Eqs. 23-28) with a single Newton-Schulz
    inverse: (I - R+- r-+)^-1 = I + R+- (I - r-+ R+-)^-1 r-+."""
    N = R_mp.shape[-1]
    inv1 = ns_inverse(r_mp @ R_pm, ns_iters)
    T01_inv = T_mm @ inv1

    X = r_mp @ torch.cat([T_pp, J0_p], dim=-1)
    rT, rJ = X[..., :N], X[..., N:]
    Y1 = T01_inv @ torch.cat([t_mm, rT, rJ + j0_m], dim=-1)
    T_mm_new = Y1[..., :N]
    R_mp_new = R_mp + Y1[..., N:2 * N]
    J0_m_new = J0_m + Y1[..., 2 * N:]

    # T21_inv = t++ (I - R+- r-+)^-1 = t++ + t++ R+- inv1 r-+
    u = inv1 @ r_mp
    Z = R_pm @ torch.cat([u, t_mm, j0_m], dim=-1)
    Ru, Rt, Rj = Z[..., :N], Z[..., N:2 * N], Z[..., 2 * N:]
    T21_inv = t_pp + t_pp @ Ru

    Y2 = T21_inv @ torch.cat([T_pp, Rt, J0_p + Rj], dim=-1)
    T_pp_new = Y2[..., :N]
    R_pm_new = r_pm + Y2[..., N:2 * N]
    J0_p_new = j0_p + Y2[..., 2 * N:]
    return R_mp_new, R_pm_new, T_pp_new, T_mm_new, J0_p_new, J0_m_new


# ---------------------------------------------------------------------------
# Per-layer kernels: the doubling ladder (K5) and the whole layer step (K4)
# ---------------------------------------------------------------------------

#: Largest stream count N, source count K and doubling count the per-layer
#: kernels of ``csrc/fused_rt.cu`` take.
KERNEL_MAX_N = 64
KERNEL_MAX_K = 2
KERNEL_MAX_DOUBL = 32


def ek_to_rows(expk, N):
    """(s, K) per-point beam attenuation -> (s, N, K) per row; a per-row
    (s, N, K) tensor passes through."""
    if expk.dim() == 3:
        return expk
    return expk[:, None, :].expand(expk.shape[0], N, expk.shape[1])


def doubling_reference(r, t, jp, jm, expk, ndoubl, ns_sched=None):
    """The plain version of ``fused_doubling``: ``doubling_math`` on the
    starred operators r* = D r-+ (s, N, N), t++, j0+ and D j0- (s, N, K),
    expk (s, K) or (s, N, K). Returns (r*, t, jp, jm*)."""
    return doubling_math(r, t, jp, jm, ek_to_rows(expk, r.shape[-1]),
                         norm_sched(ns_sched, ndoubl))


def unstar(r, t, jp, jm, d_vec):
    """Unstar a doubled layer and rebuild its reverse operators by parity
    (doubling.jl:178-216): (r-+, r+-, t++, t--, j0+, j0-)."""
    sgn = d_vec[:, None] * d_vec[None, :]
    r_mp = r * d_vec[:, None]
    return r_mp, sgn * r_mp, t, sgn * t, jp, jm * d_vec[:, None]


def layer_step_reference(comp, r_star, t_pp, jp, jm_star, expk, d_vec,
                         ndoubl, ns_sched=None, ns_inter=NS_ITERS):
    """The plain version of ``fused_layer_step``: the doubling ladder, the
    unstar and parity step, then the adding step onto ``comp`` (R_mp, R_pm,
    T_pp, T_mm, J0_p, J0_m). Returns the new composite tuple."""
    layer = doubling_reference(r_star, t_pp, jp, jm_star, expk, ndoubl,
                               ns_sched)
    return interaction_math(*comp, *unstar(*layer, d_vec), ns_inter)


def _check_layer_operands(mats, vecs, ek, d_vec, ns_sched):
    """Refuse what the per-layer kernels do not take, before any build:
    N <= 64, K <= 2, at most 32 doubling steps, and float32 tensors of one
    CUDA device with matrices (s, N, N), source stacks (s, N, K), per-row
    expk (s, N, K) and d_vec (N,)."""
    s, N = mats[0].shape[0], mats[0].shape[-1]
    K = vecs[0].shape[-1]
    if N > KERNEL_MAX_N or K > KERNEL_MAX_K:
        raise ValueError(f"the kernel takes N <= {KERNEL_MAX_N} and "
                         f"K <= {KERNEL_MAX_K}, got N={N}, K={K}")
    if len(ns_sched) > KERNEL_MAX_DOUBL:
        raise ValueError(f"the kernel takes at most {KERNEL_MAX_DOUBL} "
                         f"doubling steps, got {len(ns_sched)}")
    named = [("matrix", x, (s, N, N)) for x in mats] + \
        [("source stack", x, (s, N, K)) for x in vecs] + \
        [("expk", ek, (s, N, K))] + \
        ([("d_vec", d_vec, (N,))] if d_vec is not None else [])
    for name, x, _ in named:
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes float32, got "
                             f"{x.dtype}")
    for name, x, want in named:
        if tuple(x.shape) != want:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {want}")
    for name, x, _ in named:
        if x.device.type != "cuda" or x.device != mats[0].device:
            raise ValueError(f"{name}: the kernel takes tensors on one CUDA "
                             f"device, got {x.device}")


def _launch(fn_name, ins, outs, s, N, K, ns_sched, *extra):
    """One launch of a ``csrc/fused_rt.cu`` entry on the current stream."""
    from .cuda_build import load
    lib = load("fused_rt")
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * (len(ins) + len(outs)) + \
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] + \
        [ctypes.c_int] * len(extra) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.vsm_rt_error_string.argtypes = [ctypes.c_int]
    lib.vsm_rt_error_string.restype = ctypes.c_char_p
    sched = (ctypes.c_int * max(len(ns_sched), 1))(*ns_sched)
    dev = ins[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(x.data_ptr() for x in (*ins, *outs)), s, N, K,
                len(ns_sched), sched, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: "
                           + lib.vsm_rt_error_string(rc).decode())


def _launch_doubling(r, t, jp, jm, expk, ns_sched):
    """Check the operands, then one launch of K5; returns (r*, t, jp, jm*)."""
    mats = [x.contiguous() for x in (r, t)]
    vecs = [x.contiguous() for x in (jp, jm)]
    ek = ek_to_rows(expk, r.shape[-1]).contiguous()
    _check_layer_operands(mats, vecs, ek, None, ns_sched)
    s, N, K = r.shape[0], r.shape[-1], jp.shape[-1]
    outs = [torch.empty_like(x) for x in (*mats, *vecs)]
    _launch("vsm_fused_doubling_f32", (*mats, *vecs, ek), outs, s, N, K,
            ns_sched)
    return tuple(outs)


def _launch_layer_step(comp, r_star, t_pp, jp, jm_star, expk, d_vec,
                       ns_sched, ns_inter):
    """Check the operands, then one launch of K4; returns the composite."""
    N = r_star.shape[-1]
    mats = [x.contiguous() for x in (*comp[:4], r_star, t_pp)]
    vecs = [x.contiguous() for x in (*comp[4:], jp, jm_star)]
    ek = ek_to_rows(expk, N).contiguous()
    d = d_vec.contiguous()
    _check_layer_operands(mats, vecs, ek, d, ns_sched)
    if ns_inter < 0:
        raise ValueError(f"ns_inter must be >= 0, got {ns_inter}")
    s, K = r_star.shape[0], jp.shape[-1]
    outs = [torch.empty_like(x) for x in (*mats[:4], *vecs[:2])]
    _launch("vsm_fused_layer_step_f32", (*mats, *vecs, ek, d), outs, s, N, K,
            ns_sched, int(ns_inter))
    return tuple(outs)


def layer_step_blocks_per_sm(N, K):
    """K4's blocks at (N, K) resident on one SM, as the C side reads them
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    from .cuda_build import load
    return load("fused_rt").vsm_fused_layer_step_blocks_per_sm(N, K)


def _refuse_tpu_modes(dot_mode):
    if dot_mode != "highest":
        raise NotImplementedError(f"dot_mode {dot_mode!r}: the port runs "
                                  "exact-f32 products only")


def fused_doubling(r, t, jp, jm, expk, ndoubl, ns_sched=None,
                   dot_mode="highest"):
    """The doubling ladder on starred operators, ``ndoubl`` steps on the NS
    schedule ``ns_sched`` (None/() -> NS_ITERS per step, an int -> that
    count per step, or a tuple of ndoubl counts).

    r, t (s, N, N); jp, jm (s, N, K); expk (s, K) per point or (s, N, K) per
    row, squared every step. Returns (r*, t, jp, jm*); the arguments of the
    JAX package's ``fused_doubling`` without its TPU-only ``block`` and
    ``interpret``.

    CUDA tensors launch K5 of ``csrc/fused_rt.cu`` (counted in
    ``fused_doubling.launches``), which replaces the TPU kernel
    ``vsmartmom_tpu/ops/fused_rt.py::fused_doubling`` -> ``_doubling_kernel``.
    A scattering layer is bound by FP32 operations, (2k + 5) N^3 FMAs per
    point and step against O(N^2) bytes per point; its design keeps r, t,
    the sources and the NS and product temporaries (six N x N matrices,
    67 KB at N = 52) in shared memory for the whole ladder, one block per
    point, with K1's register-tiled FP32 products (``csrc/fp32_tile.cuh``).
    A purely absorbing layer (r = 0 and t diagonal, every moment above
    m_scat) is found on the device after the load and runs the ladder's
    O(N) closed form, the plain version's values bit for bit; it is bound
    by the bytes of r and t. CPU tensors run ``doubling_reference``.
    """
    _refuse_tpu_modes(dot_mode)
    ns_sched = norm_sched(ns_sched, ndoubl)
    if r.device.type == "cpu":
        return doubling_reference(r, t, jp, jm, expk, ndoubl, ns_sched)
    out = _launch_doubling(r, t, jp, jm, expk, ns_sched)
    fused_doubling.launches += 1
    return out


fused_doubling.launches = 0


def fused_layer_step(comp, r_star, t_pp, jp, jm_star, expk, d_vec, ndoubl,
                     ns_sched=None, ns_inter=NS_ITERS, dot_mode="highest"):
    """One whole layer step: the doubling ladder on the starred elemental
    operators, the unstar and parity step, and the adding step onto the
    composite ``comp`` = (R_mp, R_pm, T_pp, T_mm, J0_p, J0_m) (matrices
    (s, N, N), sources (s, N, K)) with ``ns_inter`` NS iterations. expk is
    (s, K) or (s, N, K); d_vec (N,) the D diagonal. Returns the new
    composite tuple.

    CUDA tensors launch K4 of ``csrc/fused_rt.cu`` (counted in
    ``fused_layer_step.launches``), which replaces the TPU kernel
    ``vsmartmom_tpu/ops/fused_rt.py::fused_layer_step`` -> ``_layer_kernel``.
    Bound by FP32 operations like K5 (the ladder plus (2 ns_inter + 11) N^3
    FMAs of adding per point); the six composite operands come from and go
    back to global memory once per layer, which the whole-moment K1 avoids.
    It runs K5's ladder and K1's adding on ``csrc/fp32_tile.cuh``, in K1's
    shared-memory layout: ten N x N matrices, 110 KB at N = 52, two blocks
    of 192 threads an SM. Its matrix outputs round as the plain version's
    matmuls; its source vectors (J0_p, J0_m) sum four partial sums a row.
    CPU tensors run ``layer_step_reference``.
    """
    _refuse_tpu_modes(dot_mode)
    ns_sched = norm_sched(ns_sched, ndoubl)
    if r_star.device.type == "cpu":
        return layer_step_reference(comp, r_star, t_pp, jp, jm_star, expk,
                                    d_vec, ndoubl, ns_sched, ns_inter)
    out = _launch_layer_step(comp, r_star, t_pp, jp, jm_star, expk, d_vec,
                             ns_sched, ns_inter)
    fused_layer_step.launches += 1
    return out


fused_layer_step.launches = 0
