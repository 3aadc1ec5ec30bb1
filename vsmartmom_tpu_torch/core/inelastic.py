"""Inelastic (rotational and vibrational Raman) transport.

Counterpart of ``vsmartmom_tpu/core/inelastic.py``. Behavioral reference:
vSmartMOM.jl src/CoreRT/CoreKernel/{elemental_inelastic.jl,
doubling_inelastic.jl, interaction_inelastic.jl} and
Inelastic/raman_atmo_prop.jl.

The inelastic field is first-order in the Raman coupling: for each discrete
Raman shift, light at the source wavelength n0 = n1 + shift scatters once
inelastically and is otherwise transported elastically. The coupled
two-wavelength problem is block-triangular,

    X(eps) = [[X(n0), 0], [eps*ieX, X(n1)]],

and every adding/doubling composition keeps that form, so the ieX blocks
evolve by the product rule: in every operator product exactly one factor
is replaced by its ie counterpart, factors to its LEFT evaluate at n1 and
to its RIGHT at n0 (doubling_inelastic.jl:74-143). The n0 role of an
elastic array comes from a source map: for rotational Raman (RRS) a
zero-padded slice along the spectral axis (``_roll0``,
``ops/fused_rrs.roll_stack``), for vibrational Raman (VS) the incident
grid point 0 for every target (``_src_fixed0``, the reference's VS
convention, elemental_inelastic.jl:279). The Raman shifts are a leading
batch axis of the ie arrays; VS has one slot whose weight is a vector over
the targets.

Two solves: ``rt_solve_rrs``, the plain path (a Python loop over moments
and layers with ``torch.linalg.solve``), and ``rt_solve_rrs_fused``, whose
elastic composite comes from the band kernel (``ops/fused_band.py``) and
whose whole ie ladder and per-layer adding run in the block-bichromatic
RRS kernel (``ops/fused_rrs.py``); only the surface step runs the plain
``ie_interaction``. RRS takes the kernel route where it can; VS runs the
plain solve on any device, as in the JAX package. Entry points run on
CUDA unless the caller passes ``device``.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops.fused_band import fused_moment
from ..ops.fused_rrs import (KERNEL_MAX_N, fused_moment_rrs,
                             ie_ladder_resolution, roll_stack)
from .kernels import (AddedLayer, CompositeLayer, _exp, _expm1,
                      identity_composite, interaction)
from .solver import _elemental_and_sources, _surface_layer, band_moment_args
from .types import (SolverInputs, kernel_takes_width, resolve_device,
                    rrs_setup_from_numpy, stokes_d_vector)


class IEAdded(NamedTuple):
    """Per-shift homogeneous-layer ie operators, leading shift axis."""
    ier_mp: torch.Tensor   # (nR, s, N, N)
    ier_pm: torch.Tensor
    iet_pp: torch.Tensor
    iet_mm: torch.Tensor
    iejp: torch.Tensor     # (nR, s, N)
    iejm: torch.Tensor


class IEComposite(NamedTuple):
    ieR_mp: torch.Tensor
    ieR_pm: torch.Tensor
    ieT_pp: torch.Tensor
    ieT_mm: torch.Tensor
    ieJp: torch.Tensor
    ieJm: torch.Tensor


def zero_ie_composite(n_r, n_spec, N, dtype, device) -> IEComposite:
    zm = torch.zeros((n_r, n_spec, N, N), dtype=dtype, device=device)
    zv = torch.zeros((n_r, n_spec, N), dtype=dtype, device=device)
    return IEComposite(zm, zm, zm, zm, zv, zv)


def ie_added_zero(n_r, n_spec, N, dtype, device) -> IEAdded:
    return IEAdded(*zero_ie_composite(n_r, n_spec, N, dtype, device))


def _roll0(x, shift: int):
    """Value at the source wavelength n0 = n1 + shift along axis 0, zero
    outside the band."""
    return roll_stack((x,), (shift,), axis=0)[0][0]


def _src_fixed0(x, shift: int):
    """Fixed-source map of vibrational Raman: the incident wavelength is
    grid point 0 (get_elem_rt_VS!, elemental_inelastic.jl:279) and every
    target receives from it; ``shift`` is ignored."""
    return x[0:1].expand(x.shape)


def source_map(mode: str):
    """The source map of an inelastic mode: ``_roll0`` for "RRS" (and the
    stellar "sol_RRS"), ``_src_fixed0`` for the vibrational modes."""
    if mode in ("RRS", "sol_RRS"):
        return _roll0
    if mode in ("VS_0to1", "VS_1to0", "sol_VS_0to1", "sol_VS_1to0"):
        return _src_fixed0
    raise ValueError(f"unknown inelastic mode {mode!r}")


def _roll_all(src_fn, shifts, *arrays):
    """Per-shift source-wavelength views (nR, ...) of elastic arrays: slices
    of one zero-padded copy for the RRS roll, the source map per shift
    otherwise."""
    if src_fn is _roll0:
        return roll_stack(arrays, shifts, axis=0)
    return tuple(torch.stack([src_fn(a, sh) for sh in shifts])
                 for a in arrays)


def _mv(a, v):
    return torch.einsum("sij,sj->si", a, v)


def _L(a, X):
    """Elastic-left product a (s, N, N) @ X (nR, s, N, N)."""
    return torch.matmul(a, X)


def _Lv(a, x):
    return torch.einsum("snm,rsm->rsn", a, x)


def _B(X, Y):
    """Per-shift product (both operands carry the shift axis)."""
    return torch.matmul(X, Y)


def _Bv(X, y):
    return torch.einsum("rsnm,rsm->rsn", X, y)


def ie_elemental(shift, w_rr, fscatt, dtau, tau_sum, Z_pp_r, Z_mp_r,
                 qp_mu_N, wct, mu0, i_mu0_start, n_stokes, F0, fourier_w,
                 src_fn=_roll0):
    """Inelastic elemental operators for ONE Raman shift (get_elem_rt_RRS!,
    elemental_inelastic.jl:117-206; SFI kernel l.480-598).

    shift int, w_rr the Raman weight: a scalar (RRS, one a shift) or a
    per-target vector (s,) (VS, weights over the output grid); fscatt (s,)
    Rayleigh scattering fraction, dtau (s,) elemental depth, tau_sum (s,),
    Z_pp_r/Z_mp_r (N, N) Raman phase matrices, wct (N,) scaled weights,
    src_fn the source map. Returns (ier_mp, iet_pp, iejp, iejm); the
    reverse operators come from the D symmetry after doubling."""
    d1 = dtau                                     # target wavelength n1
    d0 = src_fn(dtau, shift)                      # source wavelength n0
    fsc0 = src_fn(fscatt, shift)
    valid = (d0 > 0).to(dtau.dtype)
    mu_i = qp_mu_N[:, None]
    mu_j = qp_mu_N[None, :]
    safe_d0 = torch.where(d0 > 0, d0, torch.ones_like(d0))
    ratio = (d1 / safe_d0)[:, None, None]
    pref = (w_rr * fsc0 * valid)[:, None, None]

    Em1_1 = _expm1(-d1[:, None] / qp_mu_N[None, :])       # (s, N)
    Em1_0 = _expm1(-d0[:, None] / qp_mu_N[None, :])
    E_0 = 1.0 + Em1_0

    # 1 - E1_i E0_j = -(Em1_1_i + Em1_0_j + Em1_1_i Em1_0_j)
    one_m_EE = -(Em1_1[:, :, None] + Em1_0[:, None, :]
                 + Em1_1[:, :, None] * Em1_0[:, None, :])
    ier = (pref * Z_mp_r[None] * wct[None, None, :]
           * (1.0 / (mu_i / mu_j + ratio)) * one_m_EE)

    # Transmission: ediff / gen = E0_j (d0/mu_i) expm1(x)/x with
    # x = d0/mu_j - d1/mu_i, which covers every degenerate limit.
    base = pref * Z_pp_r[None] * wct[None, None, :]
    x = d0[:, None, None] / mu_j - d1[:, None, None] / mu_i
    one = torch.ones_like(x)
    xr = torch.where(x == 0.0, one, torch.expm1(x) / torch.where(x == 0.0,
                                                                 one, x))
    iet = base * (d0[:, None, None] / mu_i) * E_0[:, None, :] * xr

    # SFI sources: incident-wavelength quantities at n0.
    ns = n_stokes
    sl = slice(i_mu0_start, i_mu0_start + ns)
    F0_0 = src_fn(F0.T, shift)                    # (s, ns)
    Zp_I0 = torch.einsum("ik,sk->si", Z_pp_r[:, sl], F0_0)
    Zm_I0 = torch.einsum("ik,sk->si", Z_mp_r[:, sl], F0_0)

    prefv = fourier_w * (w_rr * fsc0 * valid)[:, None]       # (s, 1)
    mu_v = qp_mu_N[None, :]
    d1v, d0v = d1[:, None], d0[:, None]
    idx = torch.arange(qp_mu_N.shape[0], device=qp_mu_N.device)
    in_block = ((idx >= i_mu0_start) & (idx < i_mu0_start + ns)) | \
        (torch.abs(qp_mu_N - mu0) <= 1e-9 * mu0)

    # Beam source: direction mu_v inside the solar block, mu0 outside.
    Em1_00 = _expm1(-d0 / mu0)                    # (s,)
    mu_s = torch.where(in_block, qp_mu_N, mu0)[None, :]
    E0_s = torch.where(in_block[None, :], E_0, (1.0 + Em1_00)[:, None])
    y = d0v / mu_s - d1v / mu_v
    one = torch.ones_like(y)
    yr = torch.where(y == 0.0, one, torch.expm1(y) / torch.where(y == 0.0,
                                                                 one, y))
    iejp = prefv * Zp_I0 * (d0v / mu_v) * E0_s * yr

    one_m_EE0 = -(Em1_1 + Em1_00[:, None] + Em1_1 * Em1_00[:, None])
    iejm = prefv * Zm_I0 * (1.0 / (mu_v / mu0 + d1v / safe_d0[:, None])) \
        * one_m_EE0

    att0 = _exp(-src_fn(tau_sum, shift) / mu0)[:, None]
    return ier, iet, iejp * att0, iejm * att0


def ie_doubling_step(r, t, jp, jm, ek, gp, tt_gp, ie_carry, shifts,
                     src_fn=_roll0):
    """One doubling step of the (starred) ie quantities given the elastic
    starred state of the same step (doubling_inelastic.jl:74-143).

    ie_carry = (ier*, iet, iejp, iejm*) with leading shift axis; r/jm are
    the starred elastic quantities, jp/jm the solar source (s, N). Rolled
    per-shift elastic products are built by rolling the pre-multiplied
    elastic arrays (the roll commutes with pointwise-in-s products)."""
    ier, iet, iejp, iejm = ie_carry
    j1m = jm * ek[:, None]
    tmp1 = _mv(gp, jp + _mv(r, j1m))
    tmp2 = _mv(gp, j1m + _mv(r, jp))
    gp_t = gp @ t
    gp_r = gp @ r
    gp_r_t = gp_r @ t

    r0, t0, G_t0, G_rt0, G_r0 = _roll_all(src_fn, shifts, r, t, gp_t,
                                          gp_r_t, gp_r)
    ek0, j1m0, jp0, tmp1_0, tmp2_0 = _roll_all(src_fn, shifts, ek, j1m, jp,
                                               tmp1, tmp2)

    iej1p = iejp * ek0[:, :, None]
    iej1m = iejm * ek0[:, :, None]
    mix = _L(r, ier) + _B(ier, r0)               # (r r)_ie

    iejp_new = iej1p + _Lv(tt_gp, iejp + _Lv(r, iej1m) + _Bv(ier, j1m0)
                           + _Bv(mix, tmp1_0)) + _Bv(iet, tmp1_0)
    iejm_new = iejm + _Lv(tt_gp, iej1m + _Bv(ier, jp0) + _Lv(r, iejp)
                          + _Bv(mix, tmp2_0)) + _Bv(iet, tmp2_0)

    iet_new = _L(tt_gp, iet + _B(mix, G_t0)) + _B(iet, G_t0)
    ier_new = ier + _B(iet, G_rt0) + \
        _L(tt_gp, _L(r, iet) + _B(ier + _B(mix, G_r0), t0))
    return ier_new, iet_new, iejp_new, iejm_new


def _solve_eye(A):
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve(A, eye.expand_as(A))


def ie_interaction(comp, add, comp_ie: IEComposite, add_ie: IEAdded,
                   shifts, src_fn=_roll0) -> IEComposite:
    """ie part of the adding step, by the bichromatic product rule on
    ``kernels.interaction`` (interaction_inelastic.jl). ``comp``
    (CompositeLayer) and ``add`` (AddedLayer) are the elastic PRE-interaction
    states; their solar source slot 0 is used."""
    N = comp.T_pp.shape[-1]
    eye = torch.eye(N, dtype=comp.T_pp.dtype, device=comp.T_pp.device)
    r_a, tpp_a, tmm_a = add.r_mp, add.t_pp, add.t_mm
    jm_a = add.j0_m[..., 0]
    Rpm_c, Tpp_c, Tmm_c = comp.R_pm, comp.T_pp, comp.T_mm
    Jp_c = comp.J0_p[..., 0]

    inv1 = _solve_eye(eye - r_a @ Rpm_c)
    T01 = Tmm_c @ inv1
    inv2 = _solve_eye(eye - Rpm_c @ r_a)
    T21 = tpp_a @ inv2

    rT = r_a @ Tpp_c
    Rt = Rpm_c @ tmm_a
    u1 = _mv(r_a, Jp_c) + jm_a
    u2 = Jp_c + _mv(Rpm_c, jm_a)

    (Rpm0, inv1_0, rT0, tmm0, ra0, inv2_0, Tpp0, Rt0) = _roll_all(
        src_fn, shifts, Rpm_c, inv1, rT, tmm_a, r_a, inv2, Tpp_c, Rt)
    (u1_0, Jp0, u2_0, jm0) = _roll_all(src_fn, shifts, u1, Jp_c, u2, jm_a)

    (ieR_mp, ieR_pm, ieT_pp, ieT_mm, ieJp, ieJm) = comp_ie
    (ier_mp, ier_pm, iet_pp, iet_mm, iejp, iejm) = add_ie

    dinv1 = _L(inv1, _B(_B(ier_mp, Rpm0) + _L(r_a, ieR_pm), inv1_0))
    dT01 = _B(ieT_mm, inv1_0) + _L(Tmm_c, dinv1)

    ieJm_new = ieJm + _Bv(dT01, u1_0) + \
        _Lv(T01, _Bv(ier_mp, Jp0) + _Lv(r_a, ieJp) + iejm)
    ieR_mp_new = ieR_mp + _B(dT01, rT0) + \
        _L(T01, _B(ier_mp, Tpp0) + _L(r_a, ieT_pp))
    ieT_mm_new = _B(dT01, tmm0) + _L(T01, iet_mm)

    dinv2 = _L(inv2, _B(_B(ieR_pm, ra0) + _L(Rpm_c, ier_mp), inv2_0))
    dT21 = _B(iet_pp, inv2_0) + _L(tpp_a, dinv2)

    ieJp_new = iejp + _Bv(dT21, u2_0) + \
        _Lv(T21, ieJp + _Bv(ieR_pm, jm0) + _Lv(Rpm_c, iejm))
    ieT_pp_new = _B(dT21, Tpp0) + _L(T21, ieT_pp)
    ieR_pm_new = ier_pm + _B(dT21, Rt0) + \
        _L(T21, _B(ieR_pm, tmm0) + _L(Rpm_c, iet_mm))

    return IEComposite(ieR_mp_new, ieR_pm_new, ieT_pp_new, ieT_mm_new,
                       ieJp_new, ieJm_new)


def ie_star(ie_fields, d_vec):
    """Star ier and iejm before doubling (apply_D_elemental_RRS!): rows with
    Stokes parity > 2 negate."""
    ier, iet, iejp, iejm = ie_fields
    return (ier * d_vec[None, None, :, None], iet, iejp,
            iejm * d_vec[None, None, :])


def ie_unstar(ie_fields, d_vec) -> IEAdded:
    """Unstar and rebuild the reverse ie operators by parity
    (apply_D_matrix_IE!, doubling_inelastic.jl:159)."""
    ier, iet, iejp, iejm = ie_fields
    sgn = d_vec[:, None] * d_vec[None, :]
    ier_mp = ier * d_vec[None, None, :, None]
    return IEAdded(ier_mp, sgn * ier_mp, iet, sgn * iet, iejp,
                   iejm * d_vec[None, None, :])


def doubling_rs(r_mp, t_pp, j0_p, j0_m, expk, ie_fields, ndoubl: int,
                d_vec, shifts, src_fn=_roll0):
    """Elastic + inelastic doubling (doubling_helper! RRS,
    doubling_inelastic.jl:13-164); elastic sources are (s, N) solar
    vectors. Returns (AddedLayer with K = 1 sources, IEAdded)."""
    sgn = d_vec[:, None] * d_vec[None, :]
    ie = ie_star(ie_fields, d_vec)
    if ndoubl == 0:
        add = AddedLayer(r_mp, sgn * r_mp, t_pp, sgn * t_pp,
                         j0_p[..., None], j0_m[..., None])
        return add, ie_unstar(ie, d_vec)
    eye = torch.eye(r_mp.shape[-1], dtype=r_mp.dtype, device=r_mp.device)
    r = r_mp * d_vec[None, :, None]
    jm = j0_m * d_vec[None, :]
    jp, t, ek = j0_p, t_pp, expk
    for _ in range(ndoubl):
        gp = _solve_eye(eye - r @ r)
        tt_gp = t @ gp
        # ie update first: it reads the pre-update elastic state.
        ie = ie_doubling_step(r, t, jp, jm, ek, gp, tt_gp, ie, shifts,
                              src_fn)
        j1p = jp * ek[:, None]
        j1m = jm * ek[:, None]
        jm_new = jm + _mv(tt_gp, j1m + _mv(r, jp))
        jp_new = j1p + _mv(tt_gp, jp + _mv(r, j1m))
        r = r + tt_gp @ (r @ t)
        t = tt_gp @ t
        jp, jm, ek = jp_new, jm_new, ek * ek
    r_out = r * d_vec[None, :, None]
    add = AddedLayer(r_out, sgn * r_out, t, sgn * t, jp[..., None],
                     (jm * d_vec[None, :])[..., None])
    return add, ie_unstar(ie, d_vec)


def _cast_inputs(inputs, config, dev, *rrs):
    """The inputs and Raman arrays on ``dev`` in the solve's dtype, cast
    before the move (a spectrally resolved surface arrives as a host f64
    tensor and crosses whole)."""
    dtype = config.torch_dtype
    return tuple(type(x)(*(torch.as_tensor(v).to(dtype=dtype).to(device=dev)
                           for v in x)) if isinstance(x, SolverInputs)
                 else torch.as_tensor(x).to(dtype=dtype).to(device=dev)
                 for x in (inputs, *rrs))


def _vza_rows(config, dev):
    ns = config.n_stokes
    return torch.as_tensor([[v * ns + k for k in range(ns)]
                            for v in config.vza_idx], device=dev)


def _weigh(J, vza_rows, vza_w_m):
    """J (s, N) at each VZA's Stokes rows, times the moment's azimuthal
    weights -> (nVZA, n_stokes, s)."""
    return J[:, vza_rows].permute(1, 2, 0) * vza_w_m[:, :, None]


class _RSColumn(NamedTuple):
    """The inputs of an inelastic solve on its device in ``config.dtype``,
    with the quantities every layer and moment reads."""
    inp: SolverInputs
    w_shifts: torch.Tensor
    Z_r_pp: torch.Tensor
    Z_r_mp: torch.Tensor
    fscatt: torch.Tensor
    mu0: torch.Tensor
    d_vec: torch.Tensor
    tau_sum: torch.Tensor    # (nz + 1, nSpec): optical depth above each level
    vza_rows: torch.Tensor


def _rs_column(inputs, config, dev, w_shifts, Z_r_pp, Z_r_mp, fscatt):
    inp, *rrs = _cast_inputs(inputs, config, dev, w_shifts, Z_r_pp, Z_r_mp,
                             fscatt)
    dtype = config.torch_dtype
    return _RSColumn(
        inp, *rrs, inp.qp_mu_N[config.i_mu0_start],
        torch.as_tensor(stokes_d_vector(config.n_stokes, config.nquad),
                        dtype=dtype, device=dev),
        torch.cat([torch.zeros((1, config.n_spec), dtype=dtype, device=dev),
                   torch.cumsum(inp.tau, dim=0)], dim=0),
        _vza_rows(config, dev))


def _added_layer_rs(col: _RSColumn, config, m: int, z: int, shifts,
                    src_fn):
    """Layer z's elastic and ie added operators at moment m: (AddedLayer
    with K = 1 sources, IEAdded), every shift's elemental ie operators
    doubled with the elastic ladder (``doubling_rs``)."""
    inp = col.inp
    fw = 0.5 if m == 0 else 0.25
    dtau = inp.tau[z] / (2 ** config.ndoubl)
    r_mp, t_pp, j_p, j_m, expk = _elemental_and_sources(
        inp.tau[z], inp.scat_w[z], col.tau_sum[z], inp.thermal_b[z],
        Z_pp_m=inp.Z_pp[m], Z_mp_m=inp.Z_mp[m], qp_mu_N=inp.qp_mu_N,
        wt_mu_N=inp.wt_mu_N, mu0=col.mu0, config=config, F0=inp.F0,
        fourier_w=fw, is_m0=m == 0)
    ie_el = [ie_elemental(sh, col.w_shifts[k], col.fscatt[z], dtau,
                          col.tau_sum[z], col.Z_r_pp[m], col.Z_r_mp[m],
                          inp.qp_mu_N, fw * inp.wt_mu_N, col.mu0,
                          config.i_mu0_start, config.n_stokes, inp.F0, fw,
                          src_fn)
             for k, sh in enumerate(shifts)]
    ie_el = tuple(torch.stack(f) for f in zip(*ie_el))
    return doubling_rs(r_mp, t_pp, j_p[..., 0], j_m[..., 0], expk[:, 0],
                       ie_el, config.ndoubl, col.d_vec, shifts, src_fn)


def _surface_rs(col: _RSColumn, config, m: int):
    inp = col.inp
    return _surface_layer(inp.surf_r[m], inp.surf_j_m[m],
                          inp.surf_direct_m[m], inp.surf_spec, inp.F0,
                          col.tau_sum[config.nz], col.mu0, inp.sif_spec,
                          m == 0, config)


def rt_solve_rrs(inputs, config, shifts, w_shifts, Z_r_pp, Z_r_mp, fscatt,
                 device=None, src_fn=_roll0):
    """Full inelastic solve on the plain path (rt_run(RRS(), model),
    rt_run.jl:238-539 with the inelastic kernels). Returns a dict with the
    elastic R/T and the inelastic ieR/ieT, each (nVZA, n_stokes, nSpec).

    shifts: tuple of nR int index offsets; w_shifts (nR,) normalized Raman
    weights, or (nR, nSpec) per-target weights (VS: one slot, shifts
    (0,)); Z_r_pp/Z_r_mp (n_m, N, N) Raman phase matrices; fscatt (Nz,
    nSpec) Rayleigh fraction of layer scattering; src_fn the source map
    (``_roll0`` for RRS, ``_src_fixed0`` for VS)."""
    dev = resolve_device(device)
    dtype = config.torch_dtype
    n_spec, N, ns = config.n_spec, config.N, config.n_stokes
    n_r = len(shifts)
    col = _rs_column(inputs, config, dev, w_shifts, Z_r_pp, Z_r_mp, fscatt)
    inp = col.inp
    R = torch.zeros((len(config.vza_idx), ns, n_spec), dtype=dtype,
                    device=dev)
    T, ieR, ieT = torch.zeros_like(R), torch.zeros_like(R), \
        torch.zeros_like(R)

    for m in range(config.m_max + 1):
        comp = identity_composite(n_spec, N, dtype, dev, 1)
        comp_ie = zero_ie_composite(n_r, n_spec, N, dtype, dev)
        for z in range(config.nz):
            add, add_ie = _added_layer_rs(col, config, m, z, shifts, src_fn)
            comp_ie = ie_interaction(comp, add, comp_ie, add_ie, shifts,
                                     src_fn)
            comp = interaction(comp, add)

        surf = _surface_rs(col, config, m)
        comp_ie = ie_interaction(comp, surf, comp_ie,
                                 ie_added_zero(n_r, n_spec, N, dtype, dev),
                                 shifts, src_fn)
        comp = interaction(comp, surf)
        R = R + _weigh(comp.J0_m[..., 0], col.vza_rows, inp.vza_w[m])
        T = T + _weigh(comp.J0_p[..., 0], col.vza_rows, inp.vza_w[m])
        ieR = ieR + _weigh(comp_ie.ieJm.sum(dim=0), col.vza_rows,
                           inp.vza_w[m])
        ieT = ieT + _weigh(comp_ie.ieJp.sum(dim=0), col.vza_rows,
                           inp.vza_w[m])
    return {"R": R, "T": T, "ieR": ieR, "ieT": ieT}


def rrs_moment_args(inputs, config, shifts, w_shifts, Z_r_pp, Z_r_mp,
                    fscatt, m: int, device=None, ie_fullres=False):
    """(args, kwargs) of ``ops.fused_rrs.fused_moment_rrs`` for moment ``m``
    and all shifts: the inputs on ``device`` in ``config.dtype``, the ie
    ladder's resolution (``ie_ladder_resolution``, or the elastic one with
    ``ie_fullres``) and its f64-accurate precursors Em1 / Em1_0 / ek, with
    the elastic beam attenuation above each layer."""
    dev = resolve_device(device)
    inp, *rrs = _cast_inputs(inputs, config, dev, w_shifts, Z_r_pp, Z_r_mp,
                             fscatt)
    return _ie_moment_args(band_moment_args(inp, config, m, dev)[0], config,
                           shifts, *rrs, m, ie_fullres)


def _ie_moment_args(band_args, config, shifts, w_shifts, Z_r_pp, Z_r_mp,
                    fscatt, m, ie_fullres):
    """``rrs_moment_args`` from the moment's ``band_moment_args`` and the
    Raman inputs already cast to ``config.dtype`` on the device."""
    (Z_pp_m, Z_mp_m, tau, scat_w, _, _, att, _, _, F0_m, qp_mu_N, wct,
     d_vec, _, in_blk) = band_args
    if ie_fullres:
        ie_nd, ie_sched, ie_inter = (config.ndoubl, config.ns_sched or None,
                                     config.ns_inter)
    else:
        ie_nd, ie_sched, ie_inter = ie_ladder_resolution(
            config.ndoubl, config.ns_sched or None, config.ns_inter)
    mu0 = qp_mu_N[config.i_mu0_start]
    dtau_ie = tau / (2.0 ** ie_nd)
    args = (Z_pp_m, Z_mp_m, Z_r_pp[m], Z_r_mp[m], tau, scat_w,
            _expm1(-dtau_ie[:, :, None] / qp_mu_N[None, None, :]),
            _expm1(-dtau_ie / mu0), att, _exp(-dtau_ie / mu0), fscatt,
            tuple(shifts), w_shifts, F0_m, qp_mu_N, wct, d_vec, in_blk)
    kw = dict(ndoubl=ie_nd, ns_sched=ie_sched, ns_inter=ie_inter,
              n_stokes=config.n_stokes, i_mu0_start=config.i_mu0_start)
    return args, kw


def rt_solve_rrs_fused(inputs, config, shifts, w_shifts, Z_r_pp, Z_r_mp,
                       fscatt, device=None, ie_fullres=False):
    """Band-kernel RRS solve: per moment one band-kernel launch for the
    elastic composite (``fused_moment``) and the whole ie ladder and
    per-layer adding in the block-bichromatic RRS kernel
    (``fused_moment_rrs``, shifts in chunks of min(nR, 32768 // nSpec));
    only the surface step runs the plain ``ie_interaction``. The ie ladder
    runs at ``ie_ladder_resolution`` (two doublings coarser, a shorter NS
    schedule) with its own precursors; ``ie_fullres=True`` runs it at the
    elastic resolution. Same returns as ``rt_solve_rrs``. The kernels take
    the RRS roll only: per-target (VS) weights are refused."""
    if torch.as_tensor(w_shifts).ndim != 1:
        raise ValueError("rt_solve_rrs_fused takes the RRS roll (one weight "
                         "a shift); a VS setup runs rt_solve_rrs")
    dev = resolve_device(device)
    dtype = config.torch_dtype
    n_spec, N, ns = config.n_spec, config.N, config.n_stokes
    n_r = len(shifts)
    inp, *rrs = _cast_inputs(inputs, config, dev, w_shifts, Z_r_pp, Z_r_mp,
                             fscatt)
    mu0 = inp.qp_mu_N[config.i_mu0_start]
    tau_boa = torch.cumsum(inp.tau, dim=0)[-1]
    vza_rows = _vza_rows(config, dev)
    R = torch.zeros((len(config.vza_idx), ns, n_spec), dtype=dtype,
                    device=dev)
    T, ieR, ieT = torch.zeros_like(R), torch.zeros_like(R), \
        torch.zeros_like(R)
    n_rc = max(1, min(n_r, 32768 // max(n_spec, 1)))

    for m in range(config.m_max + 1):
        args, kw = band_moment_args(inp, config, m, dev)
        comp = CompositeLayer(*fused_moment(*args, **kw))
        surf = _surface_layer(inp.surf_r[m], inp.surf_j_m[m],
                              inp.surf_direct_m[m], inp.surf_spec, inp.F0,
                              tau_boa, mu0, inp.sif_spec, m == 0, config)
        ie_args, ie_kw = _ie_moment_args(args, config, shifts, *rrs, m,
                                         ie_fullres)
        ieJm = torch.zeros((n_spec, N), dtype=dtype, device=dev)
        ieJp = torch.zeros_like(ieJm)
        for a in range(0, n_r, n_rc):
            sh_c = tuple(shifts[a:a + n_rc])
            comp_ie = IEComposite(*fused_moment_rrs(
                *ie_args[:11], sh_c, ie_args[12][a:a + n_rc], *ie_args[13:],
                **ie_kw))
            comp_ie = ie_interaction(
                comp, surf, comp_ie,
                ie_added_zero(len(sh_c), n_spec, N, dtype, dev), sh_c)
            ieJm = ieJm + comp_ie.ieJm.sum(dim=0)
            ieJp = ieJp + comp_ie.ieJp.sum(dim=0)
        comp = interaction(comp, surf)
        R = R + _weigh(comp.J0_m[..., 0], vza_rows, inp.vza_w[m])
        T = T + _weigh(comp.J0_p[..., 0], vza_rows, inp.vza_w[m])
        ieR = ieR + _weigh(ieJm, vza_rows, inp.vza_w[m])
        ieT = ieT + _weigh(ieJp, vza_rows, inp.vza_w[m])
    return {"R": R, "T": T, "ieR": ieR, "ieT": ieT}


def refuse_thermal(band):
    """The inelastic solves carry the solar source only: a band with a
    Planck source is refused. (The JAX package's RRS and VS solvers never
    read ``thermal_b`` and return the solar-only answer for such a scene;
    the port does not copy that.)"""
    if band.thermal_b is not None:
        raise NotImplementedError(
            "the inelastic solves carry the solar source only; a scene with "
            "thermal emission is refused")


def rayleigh_fraction(band) -> np.ndarray:
    """(Nz, nSpec) Rayleigh fraction of layer scattering (fScattRayleigh,
    compEffectiveLayerProperties.jl:56): tau_rayl / (tau_rayl + tau_aer)."""
    tau_scat_mix = band.tau_rayl.T.copy()          # (Nz, s)
    for aer in band.aerosols:
        prof = np.asarray(aer.tau_profile)
        tau_scat_mix = tau_scat_mix + (prof[:, None] if prof.ndim == 1
                                       else prof.T)
    return band.tau_rayl.T / np.where(tau_scat_mix > 0, tau_scat_mix, 1.0)


def raman_z_stack(model, config, greek):
    """(n_m, N, N) Raman phase matrices (Z++, Z-+) of one Greek set."""
    from .model import z_moment_stack
    Z_pp, Z_mp = (z[:, 0] for z in z_moment_stack(
        model.params.polarization, model.quad.qp_mu, [greek],
        config.m_max + 1))
    return Z_pp, Z_mp


def inelastic_setup(model, i_band: int = 0, mode: str = "RRS", device=None):
    """Setup of the inelastic solves: (inputs, config, shifts, w_shifts,
    Z_r_pp, Z_r_mp, fscatt), tensors on ``device`` as float64. "RRS":
    every rotational shift with its weight (nR,); "VS_0to1" / "VS_1to0":
    one fixed-source slot, shifts (0,), with the per-target weights
    (1, nSpec) (the grid's first point is the incident wavelength;
    ``inelastic.vs_setup.vs_band_grid``). The source map of the mode is
    ``source_map(mode)``."""
    from ..inelastic.rrs_setup import greek_raman, rrs_redistribution

    src_fn = source_map(mode)
    dev = resolve_device(device)
    band = model.bands[i_band]
    refuse_thermal(band)
    inputs, config = model.build_band(i_band, device=dev, rrs=True)
    if src_fn is _roll0:
        shifts, w_shifts, _ = rrs_redistribution(band.nu_grid)
        if len(shifts) == 0:
            raise ValueError("spectral grid too narrow/coarse for any "
                             "rotational-Raman shift (lines span ~ +-200 "
                             "cm^-1)")
        # The band's Cabannes fraction normalizes the weights, so the
        # elastic + inelastic split matches the elastic path.
        w_shifts = w_shifts * (1.0 - band.pi_cabannes) / w_shifts.sum()
    else:
        from ..inelastic.vs_setup import vs_redistribution
        w_targets, _, _ = vs_redistribution(band.nu_grid, mode)
        if not np.any(w_targets > 0):
            raise ValueError(
                f"no {mode} Raman line lands on the scattered band; build "
                "the grid with vs_setup.vs_band_grid (first point = "
                "incident wavelength)")
        shifts = np.zeros(1, dtype=np.int32)      # one fixed-source slot
        w_shifts = w_targets[None, :]             # (1, nSpec) target weights

    Z_r_pp, Z_r_mp = raman_z_stack(model, config, greek_raman())
    return (inputs, config, *rrs_setup_from_numpy(
        shifts, w_shifts, Z_r_pp, Z_r_mp, rayleigh_fraction(band), dev))


def solve_rrs_route(model, inputs, config, rrs, dev, ie_fullres=False):
    """The RRS solve of a set-up scene (``rrs`` = (shifts, w_shifts, Z_r_pp,
    Z_r_mp, fscatt)) by its route: an f32 model on CUDA runs the kernel
    path (``rt_solve_rrs_fused``), anything else the plain path; so does a
    scene wider than K3 takes (N > ``ops.fused_rrs.KERNEL_MAX_N``), with
    one warning, when ``model.params.fused`` was left at None."""
    if config.fused and model.params.fused is None and not \
            kernel_takes_width("K3 (csrc/fused_rrs.cu)", KERNEL_MAX_N,
                               config.N):
        config = dataclasses.replace(config, fused=False)
    if config.fused:
        return rt_solve_rrs_fused(inputs, config, *rrs, dev,
                                  ie_fullres=ie_fullres)
    return rt_solve_rrs(inputs, config, *rrs, dev)


def rt_run_inelastic(model, i_band: int = 0, mode: str = "RRS", device=None,
                     ie_fullres=False):
    """User-facing inelastic forward run (reference rt_run(RS_type, model)
    for RS_type in RRS / VS_0to1 / VS_1to0).

    mode="RRS": rotational Raman, every spectral point exchanges with its
    rotational-line neighbourhood; ``solve_rrs_route`` picks the kernel or
    the plain path. mode="VS_0to1" / "VS_1to0": vibrational Raman, the
    FIRST grid point is the incident wavelength and the rest of the grid
    the scattered band (elemental_inelastic.jl:279-294; build such grids
    with ``inelastic.vs_setup.vs_band_grid``); it runs the plain
    fixed-source solve on any device, as in the JAX package. Returns numpy
    (R, T, ieR, ieT): the elastic radiance factors and the inelastic
    contributions, each (nVZA, n_stokes, nSpec). Total = R + ieR."""
    dev = resolve_device(device)
    inputs, config, *rrs = inelastic_setup(model, i_band, mode, dev)
    src_fn = source_map(mode)
    if src_fn is _roll0:
        out = solve_rrs_route(model, inputs, config, rrs, dev, ie_fullres)
    else:
        out = rt_solve_rrs(inputs, config, *rrs, dev, src_fn=src_fn)
    return tuple(out[k].cpu().numpy() for k in ("R", "T", "ieR", "ieT"))
