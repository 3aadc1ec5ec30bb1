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

The diagonal blocks of every product are those of the elastic problem of
one grid point (X(l0) of point i + shift, X(l1) of point i) and the (2,1)
block of a product is A21 B11 + A22 B21, so the kernels split the work:
each grid point's diagonal ladder and adding once, then only the (2,1)
blocks per on-grid pair (``rrs_program``).

The plain torch prep (``rrs_operands``) builds the per-pair row tables and
each grid point's own solar sources. ``fused_moment_rrs`` launches the
hand-written CUDA kernels ``csrc/fused_rrs.cu`` on CUDA tensors and runs
``moment_rrs_body_reference`` (the same algebra on dense (2N, 2N) torch
operators) on CPU tensors; ``moment_rrs_reference`` is that plain version
behind the wrapper's own signature, ``moment_rrs_split_reference`` the
kernels' split algebra in plain torch (``diagonal_store`` and
``pair_recurrence``, the plain versions of the two launches). Pairs are
flattened shift-major: pair index = r * s + i.
"""

import ctypes
from typing import NamedTuple

import torch

from .fused_band import (assemble_elemental, geom_tables,
                         solar_source_vectors)
from . import rrs_program as rp
from .fused_rt import doubling_math, interaction_math, norm_sched

#: Largest stream count N the CUDA kernels take, K1's (the RRS path runs
#: K1 for its elastic half): a pair block keeps the (2,1) blocks of ten
#: N x N operators and a pool of staged diagonal factors, three of them in
#: 216 KB at N = 64 (``pair_smem_bytes``; two would fit up to N = 68).
KERNEL_MAX_N = 64
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
    src_jp: torch.Tensor   # (nz, s, N) j_sol+ of each grid point (unrolled)
    src_jm: torch.Tensor   # (nz, s, N) D j_sol- of each grid point
    src_ek: torch.Tensor   # (nz, s) beam attenuation of each grid point


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
        c(pair(jm0, iejm) * d2), c(per_pair(ek0)), c(j_sol_p),
        c(j_sol_m * d_vec), c(ek_sol))


def assemble_ie_block(ops: RRSOperands, z: int, idx=None):
    """The ie (2,1) block (r-+, t++) of layer z, (P, N, N), for the pairs
    ``idx`` (all by default): the mixed-optical-depth single scatter of the
    JAX ``_rrs_kernel`` (:110-133)."""
    Em1, dt, pref = ops.Em1[z], ops.dtau[z], ops.pref[z]
    if idx is not None:
        Em1, dt, pref = Em1[idx], dt[idx], pref[idx]
    N = Em1.shape[1] // 2
    Em1_0, Em1_1 = Em1[:, None, :N], Em1[:, N:, None]
    d0, d1 = dt[:, 0, None, None], dt[:, 1, None, None]
    MUI, MUJ, IMI, IMJ = ops.geom_ie
    pref = pref[:, None, None]
    # r_ie: 1/(mu_i/mu_j + d1/d0) = mu_j d0 / (mu_i d0 + mu_j d1) times
    # 1 - E1_i E0_j.
    one_m_EE = -(Em1_1 + Em1_0 + Em1_1 * Em1_0)
    denom = MUI * d0 + MUJ * d1
    fac_r = (MUJ * d0) / torch.where(denom > 0, denom, torch.ones_like(denom))
    r = ops.Zr_mp * (pref * fac_r * one_m_EE)
    # t_ie: (d0/mu_i) E0_j expm1(x)/x with x = d0/mu_j - d1/mu_i; above
    # |x| = 0.3, E0_j expm1(x) = Em1_1_i - Em1_0_j (no cancellation).
    x = d0 * IMJ - d1 * IMI
    small = torch.abs(x) < 0.3
    ratio = torch.where(small, (1.0 + Em1_0) * _expm1_ratio_series(x),
                        (Em1_1 - Em1_0)
                        / torch.where(small, torch.ones_like(x), x))
    t = ops.Zr_pp * (pref * (d0 * IMI) * ratio)
    return r, t


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
    r[:, N:, :N], t[:, N:, :N] = assemble_ie_block(ops, z)
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


# ---------------------------------------------------------------------------
# The split form: per-point diagonal ladders once, then (2,1) blocks per pair
# ---------------------------------------------------------------------------

def _epilogue(epi, acc, C, E, d, ek, off):
    """The epilogue ``epi`` of csrc/fp32_tile.cuh on batched torch operands
    (d the D diagonal; ``off``: a (2,1) block, which has no identity
    terms). Returns (C, the new E of E_SEED or None)."""
    di = d[:, None]
    eye = 0.0 if off else torch.eye(acc.shape[-1], dtype=acc.dtype,
                                    device=acc.device)
    if epi == rp.E_ST:
        return acc, None
    if epi == rp.E_ACC:
        return C + acc, None
    if epi == rp.E_NS:
        return (2.0 * eye - E) + acc, None
    if epi == rp.E_ADD:
        return E + acc, None
    if epi == rp.E_SGN:
        return (di * d[None, :]) * E + acc, None
    if epi == rp.E_EK:
        return C * ek + acc, None
    if epi == rp.E_SEED:
        return acc, acc + eye
    if epi == rp.E_ACCD:
        return di * (C + acc), None
    if epi == rp.E_ROWD:
        return di * acc, None
    return di * (d[None, :] * E + acc), None


def _fields(code):
    return (code & 31, (code >> 5) & 31, (code >> 10) & 31,
            (code >> 15) & 31, code >> 20)


def _run_record(rec, mats, vecs, d, pair):
    """The rides and jobs of one phase record on batched slots; ``pair``
    runs each job on (2,1) blocks: A21 B11 + A22 B21 with A22, B11 (x1 for
    a vector job) from the pool slots of the record's second codes."""
    flags = int(rec[rp.F_ARG])
    if flags & rp.RIDE_EK:
        vecs[rp.VEK] = vecs[rp.VEK] * vecs[rp.VEK]
    if flags & rp.RIDE_VA:
        vecs[int(rec[rp.F_S1])] = vecs[int(rec[rp.F_S2])] * vecs[rp.VEK]
    if flags & rp.RIDE_FLIP:
        t = int(rec[rp.F_S0])
        mats[t] = (d[:, None] * d[None, :]) * mats[t]
    for q in range(int(rec[rp.F_NM])):
        A, B, C, E, epi = _fields(int(rec[rp.F_M + q]))
        if pair:
            a22, b11 = _fields(int(rec[rp.F_M2 + q]))[:2]
            acc = mats[A] @ mats[b11] + mats[a22] @ mats[B]
        else:
            acc = mats[A] @ mats[B]
        mats[C], seed = _epilogue(epi, acc, mats[C], mats[E], d, None, pair)
        if seed is not None:
            mats[E] = seed
    for q in range(int(rec[rp.F_NV])):
        A, B, C, E, epi = _fields(int(rec[rp.F_V + q]))
        if pair:
            a22, x1 = _fields(int(rec[rp.F_V2 + q]))[:2]
            acc = mats[A] @ vecs[x1] + mats[a22] @ vecs[B]
        else:
            acc = mats[A] @ vecs[B]
        vecs[C], _ = _epilogue(epi, acc, vecs[C], vecs[E], d, vecs[rp.VEK],
                               pair)


def diagonal_store(ops: RRSOperands, plan: "rp.Plan"):
    """The diagonal half of the split form in plain torch: every grid
    point's elastic problem (its ladder and adding at this ladder's
    resolution, from the unrolled l1 row tables and the point's own solar
    sources) run through ``plan``'s phases, saving the values the (2,1)
    recurrence reads. Returns the store: matrices (s, entries, N, N) and
    vectors (s, entries, N, 1)."""
    s = ops.src_ek.shape[1]
    N = ops.d_vec.shape[0]
    dtype, dev = ops.Em1.dtype, ops.Em1.device
    d = ops.d_vec
    eye = torch.eye(N, dtype=dtype, device=dev).expand(s, N, N)
    mats = [torch.zeros((s, N, N), dtype=dtype, device=dev)
            for _ in range(rp.N_MAT)]
    vecs = [torch.zeros((s, N, 1), dtype=dtype, device=dev)
            for _ in range(rp.N_VEC)]
    mats[rp.TPP0], mats[rp.TMM] = eye, eye
    mstore = torch.zeros((s, plan.n_mat_entries, N, N), dtype=dtype,
                         device=dev)
    vstore = torch.zeros((s, plan.n_vec_entries, N, 1), dtype=dtype,
                         device=dev)
    for rec in plan.table:
        if rec[rp.F_OP] == rp.OP_ASSEMBLE:
            z, starred = int(rec[rp.F_ARG]), bool(rec[rp.F_S2])
            r, t = assemble_elemental(
                ops.Z_pp, ops.Z_mp, ops.geom, ops.w_over[z][:, :s, 1],
                ops.Em1[z][:s, N:], ops.dtau[z][:s, 1])
            mats[int(rec[rp.F_S0])] = r * d[:, None] if starred else r
            mats[int(rec[rp.F_S1])] = t
            vecs[rp.Vjp] = ops.src_jp[z][..., None]
            jm = ops.src_jm[z][..., None]
            vecs[rp.Vjm] = jm if starred else jm * d[:, None]
            vecs[rp.VEK] = ops.src_ek[z][:, None, None].expand(s, N, 1)
            continue
        for q in range(int(rec[rp.F_NSAVE])):
            is_vec, _, slot, e = rp.decode_stage(int(rec[rp.F_SAVE + q]))
            if is_vec:
                vstore[:, e] = vecs[slot]
            else:
                mstore[:, e] = mats[slot]
        _run_record(rec, mats, vecs, d, False)
    return mstore, vstore


def _stage(rec, mats, vecs, store, tgt, src):
    """A record's loads from the store into its pool slots: role A from the
    target points, role B from the source points."""
    for q in range(int(rec[rp.F_NSTAGE])):
        is_vec, role, slot, e = rp.decode_stage(int(rec[rp.F_STAGE + q]))
        pts = src if role == rp.ROLE_B else tgt
        if is_vec:
            vecs[slot] = store[1][pts, e]
        else:
            mats[slot] = store[0][pts, e]


def pair_recurrence(ops: RRSOperands, plan: "rp.Plan", pairs, store):
    """The (2,1) half of the split form in plain torch, for the on-grid
    pairs ``pairs`` ((P_on, 3): pair, target, source; ``rp.pair_plan``):
    ``plan``'s phases on (2,1) blocks, each phase's diagonal factors
    loaded from ``store`` into the pool slots in the kernel's order (the
    next phase's loads before the current phase's jobs where the plan
    prefetches them). Returns the six (2,1) outputs of the on-grid pairs."""
    n_on = pairs.shape[0]
    N = ops.d_vec.shape[0]
    dtype, dev = ops.Em1.dtype, ops.Em1.device
    d = ops.d_vec
    idx, tgt, src = (torch.as_tensor(pairs[:, k], dtype=torch.long,
                                     device=dev) for k in range(3))
    mats = [torch.zeros((n_on, N, N), dtype=dtype, device=dev)
            for _ in range(rp.N_MAT + plan.pool)]
    vecs = [torch.zeros((n_on, N, 1), dtype=dtype, device=dev)
            for _ in range(rp.N_VEC + rp.VPOOL)]
    table = plan.table
    first = next(i for i, r in enumerate(table) if r[rp.F_OP] == rp.OP_PHASE)
    _stage(table[first], mats, vecs, store, tgt, src)
    for rec in table:
        if rec[rp.F_OP] == rp.OP_ASSEMBLE:
            z, starred = int(rec[rp.F_ARG]), bool(rec[rp.F_S2])
            r, t = assemble_ie_block(ops, z, idx)
            mats[int(rec[rp.F_S0])] = r * d[:, None] if starred else r
            mats[int(rec[rp.F_S1])] = t
            vecs[rp.Vjp] = ops.jp[z][idx, N:, None]
            jm = ops.jm_star[z][idx, N:, None]
            vecs[rp.Vjm] = jm if starred else jm * d[:, None]
            vecs[rp.VEK] = ops.ek[z][idx, None, None].expand(n_on, N, 1)
            continue
        nxt = int(rec[rp.F_NEXT])
        if nxt >= 0 and table[nxt][rp.F_PREFETCH]:
            _stage(table[nxt], mats, vecs, store, tgt, src)
        _run_record(rec, mats, vecs, d, True)
        if nxt >= 0 and not table[nxt][rp.F_PREFETCH]:
            _stage(table[nxt], mats, vecs, store, tgt, src)
    m = plan.outs
    return (*(mats[k] for k in m[:4]), *(vecs[k][..., 0] for k in m[4:]))


def moment_rrs_split_reference(ops: RRSOperands, shifts, ns_sched,
                               ns_inter: int, pool=None):
    """The kernel's split algebra in plain torch: ``diagonal_store`` (each
    grid point's elastic ladder and adding once) then ``pair_recurrence``
    (the (2,1) blocks of every on-grid pair through the same store
    entries and pool slots as the CUDA launches, ``rp.build_plan``);
    off-grid pairs come out exactly zero. The same returns as
    ``moment_rrs_body_reference``."""
    nz, P, Np = ops.Em1.shape
    N = Np // 2
    s = ops.src_ek.shape[1]
    plan = rp.build_plan(nz, tuple(ns_sched), int(ns_inter), pool)
    pairs = rp.pair_plan(shifts, s)
    store = diagonal_store(ops, plan)
    on = pair_recurrence(ops, plan, pairs, store)
    idx = torch.as_tensor(pairs[:, 0], dtype=torch.long, device=ops.Em1.device)
    out = []
    for x in on:
        full = x.new_zeros((P, *x.shape[1:]))
        full[idx] = x
        out.append(full)
    return tuple(out)


# ---------------------------------------------------------------------------
# The CUDA launches
# ---------------------------------------------------------------------------

#: Shared memory one block may opt in to on an H100, less the kernels'
#: static shared memory (bytes).
SMEM_LIMIT = 232448 - 256


#: Shared memory of one H100 SM and what each resident block reserves of
#: it (bytes).
SM_SMEM, BLOCK_RESERVED = 233472, 1024


def pair_smem_bytes(N, pool):
    """Dynamic shared memory of a pair block: the (2,1) blocks of ten
    matrices and eight vectors, the pool's matrices and vectors, the D
    diagonal (rows of LD = N rounded up to 4 floats)."""
    LD = (N + 3) & ~3
    return 4 * ((rp.N_MAT + pool) * N * LD + (rp.N_VEC + rp.VPOOL) * LD + LD)


def pair_shape(N, nz, ns_sched, ns_inter):
    """(threads, pool slots) of the pair launch at width N: 128 threads
    three blocks an SM with the largest pool (at least 4 slots) that lets
    three blocks fit an SM, else 384 threads one block an SM with the
    largest pool that fits a block; never more slots than every phase
    needs to load during the previous one. (On an H100 at N = 36, three
    blocks of 128 threads with 4 slots read 15% faster than two of 192
    with 11, PERF.md.)"""
    need = rp.build_plan(nz, tuple(ns_sched), int(ns_inter)).pool

    def fits(pool, blocks, limit):
        return blocks * (pair_smem_bytes(N, pool) + BLOCK_RESERVED) <= limit
    three = max((p for p in range(2, need + 1)
                 if fits(p, 3, SM_SMEM)), default=0)
    if three >= 4 or three == need:
        return 128, three
    one = max((p for p in range(2, need + 1) if fits(p, 1, SMEM_LIMIT)),
              default=2)
    return 384, one


def _check_kernel_operands(ops: RRSOperands, ns_sched):
    nz, P, Np = ops.Em1.shape
    N, C = Np // 2, ops.Z_pp.shape[0]
    if N > KERNEL_MAX_N:
        raise ValueError(f"the RRS kernel takes N <= {KERNEL_MAX_N}, "
                         f"got N={N}")
    if len(ns_sched) > KERNEL_MAX_DOUBL:
        raise ValueError(f"the RRS kernel takes at most {KERNEL_MAX_DOUBL} "
                         f"doubling steps, got {len(ns_sched)}")
    s = ops.src_ek.shape[-1]
    want = {"Z_pp": (C, N, N), "Z_mp": (C, N, N), "Zr_pp": (N, N),
            "Zr_mp": (N, N), "geom": (4, N, N), "geom_ie": (4, N, N),
            "d_vec": (N,), "w_over": (nz, C, P, 2), "Em1": (nz, P, Np),
            "dtau": (nz, P, 2), "pref": (nz, P), "jp": (nz, P, Np),
            "jm_star": (nz, P, Np), "ek": (nz, P), "src_jp": (nz, s, N),
            "src_jm": (nz, s, N), "src_ek": (nz, s)}
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
    if P % s:
        raise ValueError(f"{P} pairs are not whole shifts of {s} points")


def _lib():
    """The loaded csrc/fused_rrs.cu with its C signatures."""
    from .cuda_build import load
    lib = load("fused_rrs")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.vsm_rrs_diag_f32.argtypes = [P] * 13 + [I] * 7 + [P]
    lib.vsm_rrs_pair_f32.argtypes = [P] * 20 + [I] * 9 + [P]
    for fn in (lib.vsm_rrs_diag_f32, lib.vsm_rrs_pair_f32):
        fn.restype = I
    lib.vsm_rrs_blocks_per_sm.argtypes = [I, I, I, I]
    lib.vsm_rrs_smem_bytes.argtypes = [I, I, I]
    lib.vsm_rrs_smem_bytes.restype = ctypes.c_size_t
    lib.vsm_rrs_error_string.argtypes = [I]
    lib.vsm_rrs_error_string.restype = ctypes.c_char_p
    return lib


def launch_info(N, nz, ns_sched, ns_inter):
    """The two launches' shape at width N as the C side reports it:
    threads, dynamic shared memory and resident blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) of the diagonal
    and the pair kernel, and the pair kernel's pool."""
    lib = _lib()
    threads, pool = pair_shape(N, nz, ns_sched, ns_inter)
    return {"diag_threads": lib.vsm_rrs_threads(), "pair_threads": threads,
            "pool": pool,
            "diag_smem_bytes": lib.vsm_rrs_smem_bytes(0, N, pool),
            "pair_smem_bytes": lib.vsm_rrs_smem_bytes(1, N, pool),
            "diag_blocks_per_sm": lib.vsm_rrs_blocks_per_sm(0, N, pool,
                                                            threads),
            "pair_blocks_per_sm": lib.vsm_rrs_blocks_per_sm(1, N, pool,
                                                            threads)}


def _raise(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"fused_rrs {what} launch failed: "
                           + lib.vsm_rrs_error_string(rc).decode())


def kernel_plan(ops: RRSOperands, shifts, ns_sched, ns_inter: int):
    """The launches' program (``rp.build_plan`` for the pool of
    ``pair_shape``), pair plan (``rp.pair_plan``) and pair-launch threads
    for these operands."""
    nz, _, Np = ops.Em1.shape
    threads, pool = pair_shape(Np // 2, nz, ns_sched, ns_inter)
    return (rp.build_plan(nz, tuple(ns_sched), int(ns_inter), pool),
            rp.pair_plan(shifts, ops.src_ek.shape[-1]), threads)


def _launch_diagonal(ops: RRSOperands, plan):
    """The diagonal launch of csrc/fused_rrs.cu on the current stream, one
    block per grid point: returns the store, matrices (s, entries, N LD)
    and vectors (s, entries, LD) (LD = N rounded up to 4). Counted in
    ``_launch_diagonal.launches``."""
    nz, P, Np = ops.Em1.shape
    N, C = Np // 2, ops.Z_pp.shape[0]
    s = ops.src_ek.shape[-1]
    LD = (N + 3) & ~3
    dev = ops.Em1.device
    lib = _lib()
    table = torch.as_tensor(plan.table, device=dev)
    mstore = torch.empty((s, plan.n_mat_entries, N * LD),
                         dtype=torch.float32, device=dev)
    vstore = torch.empty((s, plan.n_vec_entries, LD), dtype=torch.float32,
                         device=dev)
    with torch.cuda.device(dev):
        rc = lib.vsm_rrs_diag_f32(
            *(x.data_ptr() for x in (ops.Z_pp, ops.Z_mp, ops.geom, ops.d_vec,
                                     ops.w_over, ops.Em1, ops.dtau,
                                     ops.src_jp, ops.src_jm, ops.src_ek,
                                     table, mstore, vstore)),
            s, P, N, C, len(plan.table), plan.n_mat_entries,
            plan.n_vec_entries, torch.cuda.current_stream(dev).cuda_stream)
    _raise(lib, rc, "diagonal")
    _launch_diagonal.launches += 1
    return mstore, vstore


_launch_diagonal.launches = 0


def _launch_pairs(ops: RRSOperands, plan, pairs, threads, store):
    """The pair launch of csrc/fused_rrs.cu on the current stream, one block
    of ``threads`` per on-grid pair (``pairs``), from the diagonal launch's
    ``store``; off-grid pairs' outputs are zero-filled. Returns the six
    (2,1) outputs, (P, N, N) x 4 and (P, N) x 2."""
    nz, P, Np = ops.Em1.shape
    N = Np // 2
    dev = ops.Em1.device
    lib = _lib()
    table = torch.as_tensor(plan.table, device=dev)
    pair_t = torch.as_tensor(pairs, device=dev)
    mat = [torch.zeros((P, N, N), dtype=torch.float32, device=dev)
           for _ in range(4)]
    vec = [torch.zeros((P, N), dtype=torch.float32, device=dev)
           for _ in range(2)]
    outs = 0
    for k, slot in enumerate(plan.outs):
        outs |= slot << (5 * k)
    with torch.cuda.device(dev):
        rc = lib.vsm_rrs_pair_f32(
            *(x.data_ptr() for x in (ops.Zr_pp, ops.Zr_mp, ops.geom_ie,
                                     ops.d_vec, ops.Em1, ops.dtau, ops.pref,
                                     ops.jp, ops.jm_star, ops.ek, table,
                                     pair_t, *store, *mat, *vec)),
            pairs.shape[0], P, N, len(plan.table), plan.n_mat_entries,
            plan.n_vec_entries, plan.pool, outs, threads,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise(lib, rc, "pair")
    return (*mat, *vec)


def _launch_kernel(ops: RRSOperands, shifts, ns_sched, ns_inter: int):
    """Check the operands, then K3's two launches on the current stream:
    the diagonal launch into the store, the pair launch from it."""
    _check_kernel_operands(ops, ns_sched)
    plan, pairs, threads = kernel_plan(ops, shifts, ns_sched, ns_inter)
    return _launch_pairs(ops, plan, pairs, threads,
                         _launch_diagonal(ops, plan))


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

    CUDA tensors launch ``csrc/fused_rrs.cu`` (the call, whose second
    launch is the pair kernel, counted in ``fused_moment_rrs.launches``, its
    diagonal launch in ``_launch_diagonal.launches``), which replaces the
    TPU kernel
    ``vsmartmom_tpu/ops/fused_rrs.py::fused_moment_rrs`` -> ``_rrs_kernel``:
    one launch runs each grid point's elastic ladder and adding once, the
    second each on-grid pair's (2,1) blocks (``rrs_program``). Bound by
    FP32 operations: the least work, 2 N^3 FMAs per pair and N^3 per point
    a product, against O(N) bytes of row tables per pair and layer. CPU
    tensors run ``moment_rrs_body_reference``.
    """
    ns_sched = norm_sched(ns_sched, ndoubl)
    ops = rrs_operands(Z_pp_m, Z_mp_m, Zr_pp_m, Zr_mp_m, tau, scat_w, Em1,
                       Em1_0, att, ek_sol, fscatt, shifts, w_shifts, F0_m,
                       qp_mu_N, wct, d_vec, in_blk, ndoubl=ndoubl,
                       n_stokes=n_stokes, i_mu0_start=i_mu0_start)
    if Em1.device.type == "cpu":
        out = moment_rrs_body_reference(ops, ns_sched, ns_inter)
    else:
        out = _launch_kernel(ops, shifts, ns_sched, ns_inter)
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
