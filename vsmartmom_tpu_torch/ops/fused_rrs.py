"""Block-bichromatic band path for rotational-Raman (RRS) transport.

Counterpart of ``vsmartmom_tpu/ops/fused_rrs.py``. For one Raman shift the
coupled two-wavelength transport operator is block-lower-triangular,

    X_blk = [[X(l0),  0   ],
             [ieX,    X(l1)]],      l0 = source, l1 = target wavelength,

and every step of the adding-doubling algebra (products, the Newton-Schulz
inverse, the push-through interaction) keeps that form; the (2,1) block of
each result is exactly the first-order bichromatic product rule that
``core/inelastic.py`` writes out per operator. So each (shift, spectral
point) pair is one band-path problem on (2N, 2N) operators:

* the diagonal blocks are the elastic elementals at l0 (source-wavelength
  row tables, zero-padded where ``i + shift`` lies off the grid) and l1;
* the (2,1) block holds the ie elemental (mixed-optical-depth single
  scatter, elemental_inelastic.jl:117-206);
* the block source vector is [j_sol(l0); iej], both halves attenuated by
  the source-wavelength beam factor ek(l0), so the second half of the
  composite source is the ie source.

An off-grid pair enters with d0 = 0, Em1(l0) = 0 and pref = 0: its l0 block
is an exact identity transport and its ie block is zero.

The plain torch prep (``rrs_operands``) builds the per-pair row tables.
``fused_moment_rrs`` launches the hand-written CUDA kernel
``csrc/fused_rrs.cu`` on CUDA tensors and runs
``moment_rrs_body_reference`` (the same algebra on dense (2N, 2N) torch
operators) on CPU tensors; ``moment_rrs_reference`` is that plain version
behind the wrapper's own signature. Pairs are flattened shift-major:
pair index = r * s + i.
"""

import ctypes
from typing import NamedTuple

import torch

from .fused_band import (assemble_elemental, geom_tables,
                         solar_source_vectors)
from .fused_rt import doubling_math, interaction_math, norm_sched

#: Largest stream count N the CUDA kernel takes: ten dense (2N, 2N) f32
#: operators must fit one block's 227 KB of shared memory.
KERNEL_MAX_N = 36
KERNEL_MAX_DOUBL = 32


class RRSOperands(NamedTuple):
    """Operands of one moment for P = nR * s (shift, point) pairs."""
    Z_pp: torch.Tensor     # (C, N, N) elastic (Cabannes) phase matrices
    Z_mp: torch.Tensor     # (C, N, N)
    Zr_pp: torch.Tensor    # (N, N) Raman phase x wct_j: the (2,1) block
    Zr_mp: torch.Tensor    # (N, N)
    geom: torch.Tensor     # (4, N, N) RG, A, TO, TS
    geom_ie: torch.Tensor  # (4, N, N) MUI, MUJ, IMI, IMJ
    d_vec: torch.Tensor    # (N,)
    w_over: torch.Tensor   # (nz, C, P, 2) scattering weight / tau at [l0, l1]
    Em1: torch.Tensor      # (nz, P, 2N) [l0; l1] expm1(-dtau/mu_i)
    dtau: torch.Tensor     # (nz, P, 2) [d0, d1]
    pref: torch.Tensor     # (nz, P) w_shift * fscatt(l0), 0 off the grid
    jp: torch.Tensor       # (nz, P, 2N) [j_sol+(l0); iej+]
    jm_star: torch.Tensor  # (nz, P, 2N) D [j_sol-(l0); iej-]
    ek: torch.Tensor       # (nz, P) beam attenuation per doubling at l0


def roll_stack(arrays, shifts, axis):
    """Per-shift source-wavelength views: ``axis`` shifted by +shift with
    zero padding (slices of one padded copy), stacked on a new leading
    nR axis: out[r][..., i, ...] = a[..., i + shifts[r], ...] or 0."""
    M = max(max(abs(int(sh)) for sh in shifts), 1)
    outs = []
    for a in arrays:
        S = a.shape[axis]
        pad_shape = list(a.shape)
        pad_shape[axis] = M
        pad = a.new_zeros(pad_shape)
        ap = torch.cat([pad, a, pad], dim=axis)
        outs.append(torch.stack([ap.narrow(axis, M + int(sh), S)
                                 for sh in shifts]))
    return tuple(outs)


def ie_ladder_resolution(ndoubl, ns_sched, ns_inter=6):
    """ie-specific (ndoubl, ns_sched, ns_inter): the ie field is a ~1%
    additive correction gated at ~5e-3 of its own scale, so its ladder
    runs two doublings coarser, keeps the last entries of the elastic NS
    schedule minus one iteration each, and one interaction iteration
    fewer (the JAX package's rule, ops/fused_rrs.py:174-192)."""
    ie_nd = max(ndoubl - 2, min(ndoubl, 2))
    sched = norm_sched(ns_sched, ndoubl)
    sched_ie = tuple(max(k - 1, 0) for k in sched[ndoubl - ie_nd:])
    return ie_nd, sched_ie, max(ns_inter - 1, 1)


def ie_geom_tables(qp_mu_N):
    """(4, N, N) geometry of the ie (2,1)-block elemental: mu_i, mu_j,
    1/mu_i, 1/mu_j per entry (the JAX ``_geom_tables(ie=True)`` rows)."""
    mu_i = qp_mu_N[:, None].expand(-1, qp_mu_N.shape[0])
    mu_j = mu_i.T
    return torch.stack([mu_i, mu_j, 1.0 / mu_i, 1.0 / mu_j])


def _expm1_ratio_series(x):
    """expm1(x)/x as a 6-term Horner chain (rel. error < 1e-7, |x| < 0.3)."""
    return 1.0 + x * (0.5 + x * (1.0 / 6.0 + x * (
        1.0 / 24.0 + x * (1.0 / 120.0 + x * (1.0 / 720.0)))))


def rrs_operands(Z_pp_m, Z_mp_m, Zr_pp_m, Zr_mp_m, tau, scat_w, Em1, Em1_0,
                 att, ek_sol, fscatt, shifts, w_shifts, F0_m, qp_mu_N, wct,
                 d_vec, in_blk, *, ndoubl, n_stokes, i_mu0_start):
    """Plain torch prep of the pair operands (see ``RRSOperands``): the l1
    row tables, their rolled l0 views, the ie elemental SFI sources and
    the [l0; l1] pair tables; every tensor contiguous, in the dtype of
    ``Z_pp_m``."""
    dtype = Z_pp_m.dtype
    nz, s = tau.shape
    C = Z_pp_m.shape[0]
    nR = len(shifts)
    P = nR * s
    ns = n_stokes
    safe_tau = torch.where(tau > 0, tau, torch.ones_like(tau))
    w_over = scat_w / safe_tau[:, None, :]                   # (nz, C, s)
    dtau = tau / (2.0 ** ndoubl)
    j_sol_p, j_sol_m = solar_source_vectors(
        Z_pp_m, Z_mp_m, w_over, F0_m, Em1, Em1_0, att, dtau, qp_mu_N,
        in_blk, i_mu0_start, ns)

    (w_over0,) = roll_stack((w_over,), shifts, axis=2)       # (nR, nz, C, s)
    Em10, jp0, jm0 = roll_stack((Em1, j_sol_p, j_sol_m), shifts, axis=1)
    dt0, ek0, fsc0, Em1_00, att0 = roll_stack(
        (dtau, ek_sol, fscatt, Em1_0, att), shifts, axis=1)  # (nR, nz, s)
    (F0_0,) = roll_stack((F0_m,), shifts, axis=1)            # (nR, ns, s)

    # ie elemental SFI sources (core/inelastic.ie_elemental's source
    # algebra, vectorized over (shift, layer)).
    mu0 = qp_mu_N[i_mu0_start]
    sl = slice(i_mu0_start, i_mu0_start + ns)
    Zp_I0 = torch.einsum("ik,rks->rsi", Zr_pp_m[:, sl], F0_0)  # (nR, s, N)
    Zm_I0 = torch.einsum("ik,rks->rsi", Zr_mp_m[:, sl], F0_0)
    prefv = w_shifts[:, None, None] * fsc0                   # (nR, nz, s)
    mu_v = qp_mu_N
    d1v = dtau[None, :, :, None]
    d0v = dt0[..., None]
    in_b = in_blk > 0.5
    mu_s = torch.where(in_b, mu_v, mu0)
    E_0s = torch.where(in_b, 1.0 + Em10, (1.0 + Em1_00)[..., None])
    y = d0v / mu_s - d1v / mu_v
    y_safe = torch.where(y == 0.0, torch.ones_like(y), y)
    yr = torch.where(y == 0.0, torch.ones_like(y), torch.expm1(y) / y_safe)
    iejp = prefv[..., None] * Zp_I0[:, None] * (d0v / mu_v) * E_0s * yr
    safe_d0 = torch.where(dt0 > 0, dt0, torch.ones_like(dt0))[..., None]
    one_m_EE0 = -(Em1[None] + Em1_00[..., None]
                  + Em1[None] * Em1_00[..., None])
    iejm = prefv[..., None] * Zm_I0[:, None] \
        * (1.0 / (mu_v / mu0 + d1v / safe_d0)) * one_m_EE0
    iejp = iejp * att0[..., None]
    iejm = iejm * att0[..., None]

    def pair(a0, a1):
        """(nR, nz, s, X) source and (nz, s, X) or (nR, nz, s, X) target
        tables -> (nz, P, 2X), shift-major pairs."""
        cat = torch.cat([a0, a1.expand_as(a0)], dim=-1)
        return cat.transpose(0, 1).reshape(nz, P, cat.shape[-1])

    def per_pair(a):
        """(nR, nz, s) -> (nz, P)."""
        return a.transpose(0, 1).reshape(nz, P)

    w_pair = torch.stack([w_over0, w_over.expand_as(w_over0)], dim=-1)
    w_pair = w_pair.permute(1, 2, 0, 3, 4).reshape(nz, C, P, 2)
    d2 = d_vec.repeat(2)

    def c(x):
        return x.to(dtype).contiguous()
    return RRSOperands(
        c(Z_pp_m), c(Z_mp_m), c(Zr_pp_m * wct[None, :]),
        c(Zr_mp_m * wct[None, :]), c(geom_tables(qp_mu_N, wct)),
        c(ie_geom_tables(qp_mu_N)), c(d_vec), c(w_pair),
        c(pair(Em10, Em1)), c(pair(dt0[..., None], dtau[..., None])),
        c(per_pair(prefv)), c(pair(jp0, iejp)),
        c(pair(jm0, iejm) * d2), c(per_pair(ek0)))


def assemble_pair_elemental(ops: RRSOperands, z: int):
    """Dense (P, 2N, 2N) elemental (r-+, t++) of layer z: the elastic
    blocks at l0 and l1 and the ie (2,1) block (the JAX ``_rrs_kernel``
    assembly, :101-133)."""
    Em1, dt, w = ops.Em1[z], ops.dtau[z], ops.w_over[z]
    P, N = Em1.shape[0], Em1.shape[1] // 2
    r = Em1.new_zeros((P, 2 * N, 2 * N))
    t = torch.zeros_like(r)
    for h in (0, 1):
        blk = slice(h * N, (h + 1) * N)
        r[:, blk, blk], t[:, blk, blk] = assemble_elemental(
            ops.Z_pp, ops.Z_mp, ops.geom, w[..., h], Em1[:, blk], dt[:, h])
    Em1_0, Em1_1 = Em1[:, None, :N], Em1[:, N:, None]
    d0, d1 = dt[:, 0, None, None], dt[:, 1, None, None]
    MUI, MUJ, IMI, IMJ = ops.geom_ie
    pref = ops.pref[z][:, None, None]
    # r_ie: 1/(mu_i/mu_j + d1/d0) = mu_j d0 / (mu_i d0 + mu_j d1) times
    # 1 - E1_i E0_j.
    one_m_EE = -(Em1_1 + Em1_0 + Em1_1 * Em1_0)
    denom = MUI * d0 + MUJ * d1
    fac_r = (MUJ * d0) / torch.where(denom > 0, denom, torch.ones_like(denom))
    r[:, N:, :N] = ops.Zr_mp * (pref * fac_r * one_m_EE)
    # t_ie: (d0/mu_i) E0_j expm1(x)/x with x = d0/mu_j - d1/mu_i; above
    # |x| = 0.3, E0_j expm1(x) = Em1_1_i - Em1_0_j (no cancellation).
    x = d0 * IMJ - d1 * IMI
    small = torch.abs(x) < 0.3
    ratio = torch.where(small, (1.0 + Em1_0) * _expm1_ratio_series(x),
                        (Em1_1 - Em1_0)
                        / torch.where(small, torch.ones_like(x), x))
    t[:, N:, :N] = ops.Zr_pp * (pref * (d0 * IMI) * ratio)
    return r, t


def moment_rrs_body_reference(ops: RRSOperands, ns_sched, ns_inter: int):
    """The kernel's algebra in plain torch on dense (P, 2N, 2N) operators:
    per layer the pair elemental, the doubling ladder on starred operators
    and the adding step onto the composite (from the vacuum composite).
    Returns the (2,1) ie blocks (ieR_mp, ieR_pm, ieT_pp, ieT_mm) (P, N, N)
    and (ieJ_p, ieJ_m) (P, N)."""
    nz, P, Np = ops.Em1.shape
    N = Np // 2
    dtype, dev = ops.Em1.dtype, ops.Em1.device
    d = ops.d_vec.repeat(2)
    sgn = d[:, None] * d[None, :]
    eye = torch.eye(Np, dtype=dtype, device=dev).expand(P, Np, Np)
    zero_m = torch.zeros((P, Np, Np), dtype=dtype, device=dev)
    zero_v = torch.zeros((P, Np, 1), dtype=dtype, device=dev)
    comp = (zero_m, zero_m, eye, eye, zero_v, zero_v)
    for z in range(nz):
        r_mp, t_pp = assemble_pair_elemental(ops, z)
        r, t, jp, jm = doubling_math(r_mp * d[:, None], t_pp,
                                     ops.jp[z][..., None],
                                     ops.jm_star[z][..., None],
                                     ops.ek[z][:, None, None], ns_sched)
        r_mp_l = r * d[:, None]
        comp = interaction_math(*comp, r_mp_l, sgn * r_mp_l, t, sgn * t,
                                jp, jm * d[:, None], ns_inter)
    return tuple(x[:, N:, :N] for x in comp[:4]) + \
        tuple(x[:, N:, 0] for x in comp[4:])


def _check_kernel_operands(ops: RRSOperands, ns_sched):
    nz, P, Np = ops.Em1.shape
    N, C = Np // 2, ops.Z_pp.shape[0]
    if N > KERNEL_MAX_N:
        raise ValueError(f"the RRS kernel takes N <= {KERNEL_MAX_N}, "
                         f"got N={N}")
    if len(ns_sched) > KERNEL_MAX_DOUBL:
        raise ValueError(f"the RRS kernel takes at most {KERNEL_MAX_DOUBL} "
                         f"doubling steps, got {len(ns_sched)}")
    want = {"Z_pp": (C, N, N), "Z_mp": (C, N, N), "Zr_pp": (N, N),
            "Zr_mp": (N, N), "geom": (4, N, N), "geom_ie": (4, N, N),
            "d_vec": (N,), "w_over": (nz, C, P, 2), "Em1": (nz, P, Np),
            "dtau": (nz, P, 2), "pref": (nz, P), "jp": (nz, P, Np),
            "jm_star": (nz, P, Np), "ek": (nz, P)}
    tensors = [(name, getattr(ops, name)) for name in want]
    for name, x in tensors:
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes float32, got {x.dtype}")
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {want[name]}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device.type != "cuda" or x.device != ops.Em1.device:
            raise ValueError(f"{name}: the kernel takes tensors on one CUDA "
                             f"device, got {x.device}")


def _launch_kernel(ops: RRSOperands, ns_sched, ns_inter: int):
    """One launch of csrc/fused_rrs.cu on the current stream."""
    from .cuda_build import load
    _check_kernel_operands(ops, ns_sched)
    nz, P, Np = ops.Em1.shape
    N, C = Np // 2, ops.Z_pp.shape[0]
    lib = load("fused_rrs")
    fn = lib.vsm_fused_moment_rrs_f32
    fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 5 + \
        [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.vsm_rrs_error_string.argtypes = [ctypes.c_int]
    lib.vsm_rrs_error_string.restype = ctypes.c_char_p
    dev = ops.Em1.device
    mat = [torch.empty((P, N, N), dtype=torch.float32, device=dev)
           for _ in range(4)]
    vec = [torch.empty((P, N), dtype=torch.float32, device=dev)
           for _ in range(2)]
    sched = (ctypes.c_int * max(len(ns_sched), 1))(*ns_sched)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(x.data_ptr() for x in ops), *(x.data_ptr() for x in mat),
                *(x.data_ptr() for x in vec), P, N, C, nz, len(ns_sched),
                sched, int(ns_inter), stream)
    if rc != 0:
        raise RuntimeError("fused_rrs kernel launch failed: "
                           + lib.vsm_rrs_error_string(rc).decode())
    return (*mat, *vec)


def _ie_layout(out, nR, s):
    """(P, N, N) x 4, (P, N) x 2 -> the IEComposite layout (nR, s, ...)."""
    return tuple(x.reshape(nR, s, *x.shape[1:]) for x in out)


def fused_moment_rrs(Z_pp_m, Z_mp_m, Zr_pp_m, Zr_mp_m, tau, scat_w, Em1,
                     Em1_0, att, ek_sol, fscatt, shifts, w_shifts, F0_m,
                     qp_mu_N, wct, d_vec, in_blk, *, ndoubl, ns_sched=None,
                     ns_inter=6, n_stokes, i_mu0_start):
    """All nz layers of one Fourier moment for every (Raman shift, spectral
    point) pair; the arguments of the JAX package's ``fused_moment_rrs``
    without its TPU-only ``block``/``interpret``/``dot_mode``.

    Args mirror ``fused_band.fused_moment`` (F0_m and wct carry the
    moment's Fourier weight; Em1 / Em1_0 / att / ek_sol are the l1
    precursors at this ladder's resolution) plus Zr_pp_m/Zr_mp_m (N, N)
    Raman phase matrices, fscatt (nz, s) Rayleigh fraction of layer
    scattering, shifts a tuple of nR index offsets (l0 = l1 + shift) and
    w_shifts (nR,) Raman weights. Returns the pre-surface ie composite
    (ieR_mp, ieR_pm, ieT_pp, ieT_mm) (nR, s, N, N) and (ieJp, ieJm)
    (nR, s, N), the ``IEComposite`` layout of ``core/inelastic.py``.

    CUDA tensors launch ``csrc/fused_rrs.cu`` (counted in
    ``fused_moment_rrs.launches``), which replaces the TPU kernel
    ``vsmartmom_tpu/ops/fused_rrs.py::fused_moment_rrs`` -> ``_rrs_kernel``;
    it is bound by FP32 operations (O(N^3) FMAs per product against O(N)
    bytes of row tables per pair and layer). It computes all three blocks
    of every pair, 4 N^3 FMAs per product, though the diagonal blocks
    depend only on a grid point; the least work giving the same outputs
    is 2 N^3 per pair and N^3 per point. CPU tensors run
    ``moment_rrs_body_reference``.
    """
    ns_sched = norm_sched(ns_sched, ndoubl)
    ops = rrs_operands(Z_pp_m, Z_mp_m, Zr_pp_m, Zr_mp_m, tau, scat_w, Em1,
                       Em1_0, att, ek_sol, fscatt, shifts, w_shifts, F0_m,
                       qp_mu_N, wct, d_vec, in_blk, ndoubl=ndoubl,
                       n_stokes=n_stokes, i_mu0_start=i_mu0_start)
    if Em1.device.type == "cpu":
        out = moment_rrs_body_reference(ops, ns_sched, ns_inter)
    else:
        out = _launch_kernel(ops, ns_sched, ns_inter)
        fused_moment_rrs.launches += 1
    return _ie_layout(out, len(shifts), tau.shape[1])


fused_moment_rrs.launches = 0


def moment_rrs_reference(Z_pp_m, Z_mp_m, Zr_pp_m, Zr_mp_m, tau, scat_w,
                         Em1, Em1_0, att, ek_sol, fscatt, shifts, w_shifts,
                         F0_m, qp_mu_N, wct, d_vec, in_blk, *, ndoubl,
                         ns_sched=None, ns_inter=6, n_stokes, i_mu0_start):
    """The plain torch version of ``fused_moment_rrs`` on any device: the
    same operands through ``moment_rrs_body_reference``."""
    ops = rrs_operands(Z_pp_m, Z_mp_m, Zr_pp_m, Zr_mp_m, tau, scat_w, Em1,
                       Em1_0, att, ek_sol, fscatt, shifts, w_shifts, F0_m,
                       qp_mu_N, wct, d_vec, in_blk, ndoubl=ndoubl,
                       n_stokes=n_stokes, i_mu0_start=i_mu0_start)
    out = moment_rrs_body_reference(ops, norm_sched(ns_sched, ndoubl),
                                    ns_inter)
    return _ie_layout(out, len(shifts), tau.shape[1])
