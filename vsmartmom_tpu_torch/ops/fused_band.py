"""Whole-moment band path: elemental assembly, doubling ladder and adding for
all layers of one Fourier moment.

Counterpart of ``vsmartmom_tpu/ops/fused_band.py``. The plain torch prep
(``geom_tables``, ``solar_source_vectors``, ``band_operands``) builds the
kernel's operands: per-layer ROW TABLES of O(s N K) — (w_c/tau), the
f64-accurate expm1(-dtau/mu) precursor, dtau, the elemental sources and the
per-source beam attenuation — plus the (C, N, N) phase matrices and
(4, N, N) geometry tables. Then ``fused_moment`` launches the hand-written
CUDA kernel ``csrc/fused_band.cu`` on CUDA tensors and runs
``moment_body_reference``, the plain torch version of the same algebra, on
CPU tensors. ``moment_reference`` is that plain version behind the
wrapper's own signature.

Widths: one block holds a point's chain while its shared memory fits the
opt-in (N <= 74 at K = 2, 75 at K = 1); wider scenes, up to N = 128, run
the cluster kernel of ``csrc/cluster_band.cuh``, each operator cut by rows
across a cluster of 2, 4 or 8 blocks (``band_cluster_plan``).

Left behind from the TPU kernel: the zflag operand and output-ref
accumulator (the Pallas auto-JVP contract), the K = 1 squeezed HBM layout,
vacuum-point padding to the sublane rule, pre-broadcast row tables and the
128-lane block-diagonal packing: the port runs one spectral point per
operator (pack = 1).
"""

import ctypes
from typing import NamedTuple

import torch

from ..core.kernels import _e_expm1, _expm1
from .fused_rt import doubling_math, interaction_math, norm_sched

#: Largest stream count N and source count K the CUDA kernel takes.
KERNEL_MAX_N = 128
KERNEL_MAX_K = 2
KERNEL_MAX_DOUBL = 32
#: Threads of a block: the single-block launch's and the cluster launch's
#: (``VSM_THREADS`` of csrc/fused_band.cu, ``VSM_CB_THREADS`` of
#: csrc/cluster_band.cuh).
KERNEL_THREADS = 192
CLUSTER_THREADS = 256
#: Shared memory one block may opt in to on an H100 (bytes), and what a
#: plan gives a block's dynamic shared memory: 1 KB less, room for the
#: kernels' static shared tables (``VSM_CB_SMEM_BUDGET``).
SMEM_OPT_IN = 232448
SMEM_BUDGET = SMEM_OPT_IN - 1024


def _ceil4(n: int) -> int:
    return -(-n // 4) * 4


def single_smem_bytes(N: int, K: int) -> int:
    """Dynamic shared bytes of the single-block launch: ten N x N operators
    with rows padded to a float4, eight (N, K) vectors and the D diagonal
    (csrc/fused_band.cu, smem_floats)."""
    return 4 * (10 * N * _ceil4(N) + 8 * _ceil4(N * K) + _ceil4(N))


def band_rows(N: int, c: int) -> int:
    """Rows of a rank's band in a c-block cluster: a multiple of 4, so the
    bands cut the row tiles whole (the last band may be short or empty)."""
    return 4 * -(-N // (4 * c))


def cluster_smem_bytes(N: int, K: int, c: int, tangents: bool = False) -> int:
    """Dynamic shared bytes of a block of a c-block cluster
    (csrc/cluster_band.cuh, smem_bytes): its band of ten operators (twenty
    with a tangent chain), seven (fourteen) whole (N, K) vectors and two
    (three) rows."""
    return 4 * ((20 if tangents else 10) * band_rows(N, c) * _ceil4(N)
                + (14 if tangents else 7) * _ceil4(N * K)
                + (3 if tangents else 2) * _ceil4(N))


def cluster_size(N: int, K: int, tangents: bool, first: int = 2) -> int:
    """The smallest cluster in first, .., 8 (powers of 2) whose block fits
    ``SMEM_BUDGET``, or 0."""
    c = first
    while c <= 8:
        if cluster_smem_bytes(N, K, c, tangents) <= SMEM_BUDGET:
            return c
        c *= 2
    return 0


def band_cluster_plan(N: int, K: int) -> dict:
    """K1's launch plan at width N and K source columns: ``cluster`` 1 (one
    block a point, ``KERNEL_THREADS``) while the single block's shared
    memory fits ``SMEM_BUDGET``, else the smallest cluster of 2, 4 or 8
    blocks whose row bands fit (``CLUSTER_THREADS`` each); ``band`` rows a
    rank, ``row_slab`` the bounds of each rank's rows, ``smem`` dynamic
    bytes a block. csrc/fused_band.cu's ``band_plan`` makes the same
    (``band_cluster_info``, which the card tests hold against this), and
    the launch runs that one. Raises ValueError outside N 1..128, K
    1..2."""
    if not (1 <= N <= KERNEL_MAX_N and 1 <= K <= KERNEL_MAX_K):
        raise ValueError(f"the kernel takes N <= {KERNEL_MAX_N} and "
                         f"K <= {KERNEL_MAX_K}, got N={N}, K={K}")
    one = single_smem_bytes(N, K)
    if one <= SMEM_BUDGET:
        c, band, threads, smem = 1, N, KERNEL_THREADS, one
    else:
        c = cluster_size(N, K, False)
        band, threads = band_rows(N, c), CLUSTER_THREADS
        smem = cluster_smem_bytes(N, K, c)
    return {"cluster": c, "band": band, "threads": threads, "smem": smem,
            "row_slab": [min(r * band, N) for r in range(c + 1)]}


def band_cluster_info(N: int, K: int) -> dict:
    """The C side's plan of (N, K) on the current card (builds the kernel):
    cluster, band, threads, smem and ``resident``: blocks an SM for the
    single block, clusters on the card at once
    (``cudaOccupancyMaxActiveClusters``) for a cluster."""
    from .cuda_build import load
    lib = _bind(load("fused_band"))
    info = (ctypes.c_int * 5)()
    rc = lib.vsm_band_cluster_plan(N, K, info)
    if rc != 0:
        raise RuntimeError("fused_band plan query failed: "
                           + lib.vsm_error_string(rc).decode())
    return dict(zip(("cluster", "band", "threads", "smem", "resident"),
                    info))


class BandOperands(NamedTuple):
    """Operands of one moment (s points, nz layers, C components, K sources)."""
    Z_pp: torch.Tensor     # (C, N, N)
    Z_mp: torch.Tensor     # (C, N, N)
    geom: torch.Tensor     # (4, N, N) RG, A, TO, TS
    d_vec: torch.Tensor    # (N,)
    w_over: torch.Tensor   # (nz, C, s) scattering weight / tau
    Em1: torch.Tensor      # (nz, s, N) expm1(-dtau/mu_i)
    dtau: torch.Tensor     # (nz, s) elemental optical depth
    j0_p: torch.Tensor     # (nz, s, N, K)
    jm_star: torch.Tensor  # (nz, s, N, K) D j0-
    ek: torch.Tensor       # (nz, s, K) beam attenuation per doubling


def geom_tables(qp_mu_N, wct):
    """(4, N, N) static geometry of the elemental operators, in the dtype of
    ``qp_mu_N``: RG = mu_j/(mu_i+mu_j) w_j; A = delta/(mu_i mu_j) (the t_off
    expm1 argument per unit dtau); TO = (1-same) mu_j w_j/delta and
    TS = same w_j/mu_i (the same-mu masks and 1/delta folded in)."""
    mu_i = qp_mu_N[:, None]
    mu_j = qp_mu_N[None, :]
    same = (torch.abs(mu_i - mu_j)
            <= 1e-9 * torch.maximum(mu_i, mu_j)).to(qp_mu_N.dtype)
    delta = torch.where(same > 0, torch.ones_like(same), mu_i - mu_j)
    wt = wct[None, :]
    return torch.stack([
        (mu_j / (mu_i + mu_j)) * wt,
        delta / (mu_i * mu_j),
        (1.0 - same) * mu_j * wt / delta,
        same * wt / mu_i,
    ])


def solar_source_vectors(Z_pp_m, Z_mp_m, w_over, F0_m, Em1, Em1_0, att,
                         dtau, qp_mu_N, in_blk, i_mu0_start, n_stokes):
    """(nz, s, N) solar elemental source vectors (kernels.elemental algebra
    on the f64-accurate precursors): the Z columns of the solar block dotted
    with F0, attenuation above the layer folded in."""
    sl0 = i_mu0_start
    Zp_blk = Z_pp_m[:, :, sl0:sl0 + n_stokes]                # (C, N, ns)
    Zm_blk = Z_mp_m[:, :, sl0:sl0 + n_stokes]
    Zp_I0 = torch.einsum("zcs,ks,cnk->zsn", w_over, F0_m, Zp_blk)
    Zm_I0 = torch.einsum("zcs,ks,cnk->zsn", w_over, F0_m, Zm_blk)

    mu0 = qp_mu_N[sl0]
    mu = qp_mu_N[None, None, :]
    E = 1.0 + Em1                                            # (nz, s, N)
    E_0 = (1.0 + Em1_0)[:, :, None]
    dt3 = dtau[:, :, None]
    jp_in = Zp_I0 * (dt3 / mu) * E
    delta_s = torch.where(in_blk > 0.5, torch.ones_like(qp_mu_N),
                          qp_mu_N - mu0)[None, None, :]
    jp_out = Zp_I0 * (mu0 / delta_s) * E_0 * \
        _expm1(dt3 * delta_s / (mu * mu0))
    j_sol_p = torch.where(in_blk[None, None, :] > 0.5, jp_in, jp_out)
    one_m_EE0 = -(Em1 + Em1_0[:, :, None] + Em1 * Em1_0[:, :, None])
    j_sol_m = Zm_I0 * (mu0 / (mu + mu0)) * one_m_EE0
    att3 = att[:, :, None]
    return j_sol_p * att3, j_sol_m * att3


def band_operands(Z_pp_m, Z_mp_m, tau, scat_w, Em1, Em1_0, att, ek_sol,
                  thermal, F0_m, qp_mu_N, wct, d_vec, is_I, in_blk,
                  *, ndoubl, n_stokes, i_mu0_start, n_sources):
    """Plain torch prep of the band operands (see ``BandOperands``); every
    tensor contiguous, in the dtype of ``Z_pp_m``."""
    dtype = Z_pp_m.dtype
    safe_tau = torch.where(tau > 0, tau, torch.ones_like(tau))
    w_over = scat_w / safe_tau[:, None, :]                   # (nz, C, s)
    dtau = tau / (2.0 ** ndoubl)
    j_sol_p, j_sol_m = solar_source_vectors(
        Z_pp_m, Z_mp_m, w_over, F0_m, Em1, Em1_0, att, dtau, qp_mu_N,
        in_blk, i_mu0_start, n_stokes)
    if n_sources == 1:
        j0_p = j_sol_p[..., None]
        j0_m = j_sol_m[..., None]
        ek = ek_sol[..., None]
    elif n_sources == 2:
        j_th = thermal[:, :, None] * (-Em1) * is_I[None, None, :]
        j0_p = torch.stack([j_sol_p, j_th], dim=-1)
        j0_m = torch.stack([j_sol_m, j_th], dim=-1)
        ek = torch.stack([ek_sol, torch.ones_like(ek_sol)], dim=-1)
    else:
        raise ValueError(f"n_sources must be 1 or 2, got {n_sources}")
    jm_star = j0_m * d_vec[None, None, :, None]

    def c(x):
        return x.to(dtype).contiguous()
    return BandOperands(c(Z_pp_m), c(Z_mp_m), c(geom_tables(qp_mu_N, wct)),
                        c(d_vec), c(w_over), c(Em1), c(dtau), c(j0_p),
                        c(jm_star), c(ek))


def assemble_elemental(Z_pp, Z_mp, geom, w, Em1, dtau):
    """Elemental (r-+, t++), (s, N, N), from phase matrices (C, N, N), the
    geometry tables, weights w (C, s), Em1 (s, N) and dtau (s,)."""
    E_j = 1.0 + Em1[:, None, :]
    E_i = 1.0 + Em1[:, :, None]
    wZ_pp = torch.einsum("cs,cij->sij", w, Z_pp)
    wZ_mp = torch.einsum("cs,cij->sij", w, Z_mp)
    RG, A, TO, TS = geom
    one_m_EE = -(Em1[:, :, None] + Em1[:, None, :]
                 + Em1[:, :, None] * Em1[:, None, :])
    r_mp = wZ_mp * RG * one_m_EE
    dt = dtau[:, None, None]
    eye = torch.eye(Em1.shape[-1], dtype=Em1.dtype, device=Em1.device)
    # E_j expm1(x), x = dt A = dt/mu_j - dt/mu_i, split as the kernels
    # split it (``core.kernels._e_expm1``: Em1_i - Em1_j in thick layers).
    num = _e_expm1(dt * A, E_j, Em1[:, :, None] - Em1[:, None, :])
    t_pp = wZ_pp * (num * TO + (dt * TS) * E_j) + E_i * eye
    return r_mp, t_pp


def moment_body_reference(ops: BandOperands, ns_sched, ns_inter: int):
    """The kernel's algebra in plain torch, batched over the spectral axis:
    for each layer elemental assembly, the doubling ladder on starred
    operators and the adding step onto the composite (starting from the
    vacuum composite). Returns (R_mp, R_pm, T_pp, T_mm, J0_p, J0_m)."""
    s, N = ops.Em1.shape[1], ops.Em1.shape[2]
    K = ops.j0_p.shape[-1]
    dtype, dev = ops.Em1.dtype, ops.Em1.device
    d = ops.d_vec
    sgn = d[:, None] * d[None, :]
    eye = torch.eye(N, dtype=dtype, device=dev).expand(s, N, N)
    zero_m = torch.zeros((s, N, N), dtype=dtype, device=dev)
    zero_v = torch.zeros((s, N, K), dtype=dtype, device=dev)
    comp = (zero_m, zero_m, eye, eye, zero_v, zero_v)
    for z in range(ops.Em1.shape[0]):
        r_mp, t_pp = assemble_elemental(ops.Z_pp, ops.Z_mp, ops.geom,
                                        ops.w_over[z], ops.Em1[z],
                                        ops.dtau[z])
        r, t, jp, jm = doubling_math(r_mp * d[:, None], t_pp, ops.j0_p[z],
                                     ops.jm_star[z], ops.ek[z][:, None, :],
                                     ns_sched)
        r_mp_l = r * d[:, None]                 # unstar the rows
        comp = interaction_math(*comp, r_mp_l, sgn * r_mp_l, t, sgn * t,
                                jp, jm * d[:, None], ns_inter)
    return comp


def _check_kernel_operands(ops: BandOperands, ns_sched):
    s, N = ops.Em1.shape[1], ops.Em1.shape[2]
    nz, C, K = ops.Em1.shape[0], ops.Z_pp.shape[0], ops.j0_p.shape[-1]
    want = {"Z_pp": (C, N, N), "Z_mp": (C, N, N), "geom": (4, N, N),
            "d_vec": (N,), "w_over": (nz, C, s), "Em1": (nz, s, N),
            "dtau": (nz, s), "j0_p": (nz, s, N, K), "jm_star": (nz, s, N, K),
            "ek": (nz, s, K)}
    tensors = [(name, getattr(ops, name)) for name in want]
    for name, x in tensors:
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes float32, got {x.dtype}")
    for name, x in tensors:
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {want[name]}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in tensors:
        if x.device.type != "cuda" or x.device != ops.Em1.device:
            raise ValueError(f"{name}: the kernel takes tensors on one CUDA "
                             f"device, got {x.device}")
    band_cluster_plan(N, K)
    if len(ns_sched) > KERNEL_MAX_DOUBL:
        raise ValueError(f"the kernel takes at most {KERNEL_MAX_DOUBL} "
                         f"doubling steps, got {len(ns_sched)}")


def _bind(lib):
    """The C interface of csrc/fused_band.cu, typed."""
    common = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + \
        [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.vsm_fused_moment_f32.argtypes = common + [ctypes.c_void_p]
    lib.vsm_fused_moment_cluster_f32.argtypes = common + [ctypes.c_void_p]
    lib.vsm_band_cluster_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.vsm_fused_moment_f32, lib.vsm_fused_moment_cluster_f32,
               lib.vsm_band_cluster_plan):
        fn.restype = ctypes.c_int
    lib.vsm_error_string.argtypes = [ctypes.c_int]
    lib.vsm_error_string.restype = ctypes.c_char_p
    return lib


def _launch_kernel(ops: BandOperands, ns_sched, ns_inter: int):
    """One launch of csrc/fused_band.cu on the current stream: the
    single-block kernel, or the cluster kernel where ``band_cluster_plan``
    gives a cluster (``_launch_cluster``). A launch that fails raises with
    the CUDA error named."""
    from .cuda_build import load
    _check_kernel_operands(ops, ns_sched)
    s, N = ops.Em1.shape[1], ops.Em1.shape[2]
    nz, C, K = ops.Em1.shape[0], ops.Z_pp.shape[0], ops.j0_p.shape[-1]
    plan = band_cluster_plan(N, K)
    lib = _bind(load("fused_band"))
    dev = ops.Em1.device
    mat = [torch.empty((s, N, N), dtype=torch.float32, device=dev)
           for _ in range(4)]
    vec = [torch.empty((s, N, K), dtype=torch.float32, device=dev)
           for _ in range(2)]
    sched = (ctypes.c_int * max(len(ns_sched), 1))(*ns_sched)
    args = [*(x.data_ptr() for x in ops), *(x.data_ptr() for x in mat),
            *(x.data_ptr() for x in vec), s, N, C, K, nz, len(ns_sched),
            sched, int(ns_inter)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan["cluster"] == 1:
            rc = lib.vsm_fused_moment_f32(*args, stream)
        else:
            rc = _launch_cluster(lib, args, stream)
    if rc != 0:
        raise RuntimeError("fused_band kernel launch failed: "
                           + lib.vsm_error_string(rc).decode())
    return (*mat, *vec)


def _launch_cluster(lib, args, stream) -> int:
    """The cluster launch (``cluster_band::cluster_kernel<K, false>``, a
    cluster of 2 or more blocks a point, on the C side's plan): the C
    side's return code. Counted in ``_launch_cluster.launches`` when it
    launched."""
    rc = lib.vsm_fused_moment_cluster_f32(*args, stream)
    if rc == 0:
        _launch_cluster.launches += 1
    return rc


_launch_cluster.launches = 0


def fused_moment(Z_pp_m, Z_mp_m, tau, scat_w, Em1, Em1_0, att, ek_sol,
                 thermal, F0_m, qp_mu_N, wct, d_vec, is_I, in_blk,
                 *, ndoubl, ns_sched=None, ns_inter=6, pack=1,
                 n_stokes, i_mu0_start, n_sources=1, dot_mode="highest"):
    """All nz layers of one Fourier moment; the arguments of the JAX
    package's ``fused_moment`` without its TPU-only ``block``/``interpret``.

    Shapes: Z (C, N, N); tau/Em1_0/att/ek_sol/thermal (nz, s); scat_w
    (nz, C, s); Em1 (nz, s, N); F0_m (ns, s); vectors (N,). wct and F0_m
    carry the moment's Fourier weight. Returns the composite
    (R_mp, R_pm, T_pp, T_mm, J0_p, J0_m): (s, N, N) x 4, (s, N, K) x 2.

    CUDA tensors launch ``csrc/fused_band.cu`` (counted in
    ``fused_moment.launches``), which replaces the TPU kernel
    ``vsmartmom_tpu/ops/fused_band.py::fused_moment`` -> ``_moment_kernel``.
    It is bound by FP32 operations, O(ndoubl N^3) per point and layer
    against O(N K) bytes of row tables; its design keeps the composite and
    the ladder temporaries in shared memory for the whole moment, one block
    per spectral point, and runs the products on the register-tiled FP32
    loops of ``csrc/fp32_tile.cuh`` (shared with K5). Past the single
    block's shared memory (N > 74 or 75) a cluster of blocks holds the
    chain cut by rows (``band_cluster_plan``; those launches also count in
    ``_launch_cluster.launches``). CPU tensors run
    ``moment_body_reference``.
    """
    if pack != 1:
        raise ValueError("the port runs one spectral point per operator "
                         "(pack = 1)")
    if dot_mode != "highest":
        raise NotImplementedError(f"dot_mode {dot_mode!r}: the port runs "
                                  "exact-f32 products only")
    ns_sched = norm_sched(ns_sched, ndoubl)
    ops = band_operands(Z_pp_m, Z_mp_m, tau, scat_w, Em1, Em1_0, att, ek_sol,
                        thermal, F0_m, qp_mu_N, wct, d_vec, is_I, in_blk,
                        ndoubl=ndoubl, n_stokes=n_stokes,
                        i_mu0_start=i_mu0_start, n_sources=n_sources)
    if Em1.device.type == "cpu":
        return moment_body_reference(ops, ns_sched, ns_inter)
    out = _launch_kernel(ops, ns_sched, ns_inter)
    fused_moment.launches += 1
    return out


fused_moment.launches = 0


def moment_reference(Z_pp_m, Z_mp_m, tau, scat_w, Em1, Em1_0, att, ek_sol,
                     thermal, F0_m, qp_mu_N, wct, d_vec, is_I, in_blk,
                     *, ndoubl, ns_sched=None, ns_inter=6,
                     n_stokes, i_mu0_start, n_sources=1):
    """The plain torch version of ``fused_moment`` on any device: the same
    operands through ``moment_body_reference``."""
    ops = band_operands(Z_pp_m, Z_mp_m, tau, scat_w, Em1, Em1_0, att, ek_sol,
                        thermal, F0_m, qp_mu_N, wct, d_vec, is_I, in_blk,
                        ndoubl=ndoubl, n_stokes=n_stokes,
                        i_mu0_start=i_mu0_start, n_sources=n_sources)
    return moment_body_reference(ops, norm_sched(ns_sched, ndoubl), ns_inter)
