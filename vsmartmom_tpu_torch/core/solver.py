"""The RT solve: the Fourier-azimuth loop around the layer chain.

Counterpart of ``vsmartmom_tpu/core/solver.py``. ``rt_solve`` loops over
Fourier moments in Python; each moment up to ``m_scat`` runs either

* the band path — ``ops.fused_band.fused_moment``, one launch of the CUDA
  band kernel for all layers of the moment (``config.fused``), or
* the plain path — a Python loop over layers of elemental -> doubling ->
  interaction (``core/kernels.py``),

then the surface layer, its interaction, and the azimuthal weighting.
Moments above ``m_scat`` see a purely absorbing column and take the exact
Beer-law shortcut, also under a spectrally resolved surface (a canopy with
spectral leaf optics: surf_r (n_m, nSpec, N, N), surf_j_m (n_m, nSpec, N,
n_stokes)), where the JAX package sends every moment down the full path
(its tail takes (N, N) surfaces only; with no scattering above ``m_scat``
both are the same arithmetic). Outputs follow the reference convention:
``R``/``T`` are the radiance factors (I/F0) at TOA (up) and BOA (down),
(nVZA, n_stokes, nSpec).

Entry points run on CUDA unless the caller passes ``device`` (the tests pass
``device="cpu"``); without CUDA and without a device they raise.
"""

import dataclasses

import numpy as np
import torch

from ..ops.fused_band import fused_moment
from ..ops.fused_rt import fused_doubling, unstar
from ..utils import timing
from .kernels import (AddedLayer, CompositeLayer, _exp, _expm1, doubling,
                      elemental, identity_composite, interaction)
from .types import (SPECTRAL_SURFACE, SolverConfig, SolverInputs,
                    resolve_device, stokes_d_vector)


def _elemental_and_sources(tau_z, scat_w_z, tau_sum_z, thermal_b_z, *,
                           Z_pp_m, Z_mp_m, qp_mu_N, wt_mu_N, mu0,
                           config: SolverConfig, F0, fourier_w, is_m0):
    """Elemental slab operators + stacked per-source j vectors: slot 0 the
    solar beam, slot 1 (n_sources == 2) the isotropic per-layer Planck
    thermal source (m = 0, Stokes-I rows), which doubles with expk = 1.
    Returns (r_mp, t_pp, j0_p, j0_m, expk), sources (s, N, K), expk (s, K)."""
    dtau = tau_z / (2 ** config.ndoubl)
    safe_tau = torch.where(tau_z > 0, tau_z, torch.ones_like(tau_z))
    wZ_pp = torch.einsum("cs,cij->sij", scat_w_z, Z_pp_m) \
        / safe_tau[:, None, None]
    wZ_mp = torch.einsum("cs,cij->sij", scat_w_z, Z_mp_m) \
        / safe_tau[:, None, None]
    r_mp, t_pp, j_sol_p, j_sol_m = elemental(
        wZ_pp, wZ_mp, dtau, tau_sum_z, qp_mu_N, wt_mu_N, mu0,
        config.i_mu0_start, config.n_stokes, F0, fourier_w)
    expk_sol = _exp(-dtau / mu0)
    if config.n_sources == 1:
        return r_mp, t_pp, j_sol_p[..., None], j_sol_m[..., None], \
            expk_sol[:, None]
    # Exact finite-dtau isothermal thermal source, Stokes-I rows:
    # j = 2 pi (1 - ssa) B (1 - e^{-dtau/mu_i}); the 2 pi undoes the 0.5/pi
    # postprocessing weight.
    ssa = scat_w_z.sum(dim=0) / safe_tau
    is_I = ((torch.arange(config.N, device=tau_z.device) % config.n_stokes)
            == 0).to(tau_z.dtype)
    j_th = (2.0 * np.pi * (1.0 - ssa)[:, None] * thermal_b_z[:, None]
            * (-_expm1(-dtau[:, None] / qp_mu_N[None, :]))
            * is_I[None, :]) * float(is_m0)
    j0_p = torch.stack([j_sol_p, j_th], dim=-1)
    j0_m = torch.stack([j_sol_m, j_th], dim=-1)
    expk = torch.stack([expk_sol, torch.ones_like(expk_sol)], dim=-1)
    return r_mp, t_pp, j0_p, j0_m, expk


def layer_batch(layer_data, *, config: SolverConfig, F0, **kw):
    """Elemental operators and sources of every layer of one moment as one
    batch of nz * s points (layer-major): ``_elemental_and_sources`` on
    ``layer_data`` = (tau, scat_w, tau_sum, thermal_b) with a leading layer
    axis, (nz, s), (nz, C, s), (nz, s), (nz, s). Returns (r_mp, t_pp, j0_p,
    j0_m, expk) with a leading nz * s axis."""
    tau, scat_w, tau_sum, thermal_b = layer_data
    return _elemental_and_sources(
        tau.reshape(-1), scat_w.transpose(0, 1).reshape(scat_w.shape[1], -1),
        tau_sum.reshape(-1), thermal_b.reshape(-1), config=config,
        F0=F0.repeat(1, tau.shape[0]), **kw)


def _make_added_layer(layer_data, *, d_vec, config: SolverConfig,
                      **kw) -> AddedLayer:
    """Homogeneous-layer operators (elemental -> doubling) of every layer
    of one moment at once, for the multisensor driver, which stashes them.
    The layers are independent, so they run as one batch (``layer_batch``).
    Returns an AddedLayer of (nz, s, N, N) operators and (nz, s, N, K)
    sources.

    With ``config.fused`` the ladder is ``ops.fused_rt.fused_doubling`` on
    the starred operators (one launch of K5 on CUDA tensors, its plain NS
    version on CPU tensors), then unstarred with the reverse operators
    rebuilt by parity; otherwise it is ``kernels.doubling`` (LU)."""
    nz, s = layer_data[0].shape
    r_mp, t_pp, j0_p, j0_m, expk = layer_batch(layer_data, config=config,
                                               **kw)
    if config.fused:
        d = d_vec[:, None]
        add = AddedLayer(*unstar(*fused_doubling(
            r_mp * d, t_pp, j0_p, j0_m * d, expk, config.ndoubl,
            ns_sched=config.ns_sched or None), d_vec))
    else:
        add = doubling(r_mp, t_pp, j0_p, j0_m, expk, config.ndoubl, d_vec)
    return AddedLayer(*(x.reshape(nz, s, *x.shape[1:]) for x in add))


def _solar_block(x, N: int, i_mu0_start: int):
    """(s, N) zeros with ``x`` (s, n_stokes) in the solar stream's columns;
    out of place, so forward-mode AD and vmap pass through it."""
    return torch.nn.functional.pad(
        x, (i_mu0_start, N - i_mu0_start - x.shape[-1]))


def beer_moment(tau_boa, F0, surf_spec, surf_j_m_m, surf_direct_m_m, qp_mu_N,
                config: SolverConfig):
    """One moment above ``m_scat``, where the layer chain reduces exactly to
    diagonal Beer-law transmission (ScatteringInterface_00,
    interaction.jl:52-120), from the column's optical depth tau_boa (s,):
    (j0m, Jtoa, j0p), each (s, N): the surface's upwelling source, that
    source at TOA, and the direct beam reaching the surface."""
    mu0 = qp_mu_N[config.i_mu0_start]
    att = _exp(-tau_boa / mu0)
    Tdiag = _exp(-tau_boa[:, None] / qp_mu_N[None, :])       # (s, N)
    j0m = _surface_source(surf_j_m_m, F0) * (att * surf_spec)[:, None]
    j0p = _solar_block((F0 * att[None, :]).T, config.N,
                       config.i_mu0_start) * surf_direct_m_m
    return j0m, Tdiag * j0m, j0p


def _surface_source(surf_j_m, F0):
    """(s, N) upwelling surface source per unit attenuation, sum_k
    surf_j_m[i, k] F0[k]: ``surf_j_m`` (N, n_stokes), or (s, N, n_stokes)
    for a spectrally resolved surface."""
    if surf_j_m.dim() == 3:
        return torch.einsum("sik,ks->si", surf_j_m, F0)
    return torch.einsum("ik,ks->si", surf_j_m, F0)


def _surface_layer(surf_r_m, surf_j_m, surf_direct_m, surf_spec, F0,
                   tau_sum_boa, mu0, sif_spec, is_m0,
                   config: SolverConfig) -> AddedLayer:
    """Surface as an AddedLayer (Surfaces/*.jl create_surface_layer!):
    ``surf_r_m`` (N, N) includes the quadrature factor, ``surf_j_m``
    (N, n_stokes) is mu0 * R_raw[:, solar block]; both scale by surf_spec
    and the solar attenuation; ``surf_direct_m`` masks the direct-beam j0+.
    A spectrally resolved surface (a canopy with spectral leaf optics)
    gives them as (s, N, N) and (s, N, n_stokes)."""
    n_spec, N, ns = config.n_spec, config.N, config.n_stokes
    dtype, dev = F0.dtype, F0.device
    att = _exp(-tau_sum_boa / mu0)                           # (s,)
    r_mp = (surf_r_m if surf_r_m.dim() == 3 else surf_r_m[None]) \
        * surf_spec[:, None, None]
    eye = torch.eye(N, dtype=dtype, device=dev).expand(n_spec, N, N)
    zero_m = torch.zeros((n_spec, N, N), dtype=dtype, device=dev)
    j0_p = _solar_block((F0 * att[None, :]).T * surf_direct_m, N,
                        config.i_mu0_start)
    j0_m = _surface_source(surf_j_m, F0) * (att * surf_spec)[:, None]
    # Surface SIF: isotropic Lambertian emission into the upwelling source,
    # m = 0 only (surface_sif.jl:24-34,177).
    is_I = ((torch.arange(N, device=dev) % ns) == 0).to(dtype)
    j0_m = j0_m + 2.0 * sif_spec[:, None] * is_I[None, :] * float(is_m0)
    K = config.n_sources
    zeros_v = torch.zeros((n_spec, N, K - 1), dtype=dtype, device=dev)
    j0_p = torch.cat([j0_p[..., None], zeros_v], dim=-1)
    j0_m = torch.cat([j0_m[..., None], zeros_v], dim=-1)
    return AddedLayer(r_mp, zero_m, eye, eye, j0_p, j0_m)


def band_moment_args(inputs: SolverInputs, config: SolverConfig, m: int,
                     device=None):
    """(args, kwargs) of ``ops.fused_band.fused_moment`` for moment ``m``:
    the inputs on ``device`` in ``config.dtype`` plus the f64-accurate
    transcendental precursors (Em1, Em1_0, att, ek) the kernel consumes, so
    its numerics match ``kernels.elemental``."""
    dev = resolve_device(device)
    dtype = config.torch_dtype
    inp = SolverInputs(*(torch.as_tensor(x).to(device=dev, dtype=dtype)
                         for x in inputs))
    return moment_args(inp.Z_pp[m], inp.Z_mp[m], inp.tau, inp.scat_w, inp.F0,
                       inp.thermal_b, inp.qp_mu_N, inp.wt_mu_N, config, m)


def moment_args(Z_pp_m, Z_mp_m, tau, scat_w, F0, thermal_b, qp_mu_N, wt_mu_N,
                config: SolverConfig, m: int):
    """``band_moment_args`` on tensors already on their device: a pure
    function of its tensor arguments, so forward-mode AD passes through it
    (``ops/fused_lin.py`` takes the operands' tangents this way)."""
    N, ns = config.N, config.n_stokes
    dtype, dev = tau.dtype, tau.device
    mu0 = qp_mu_N[config.i_mu0_start]
    fw = 0.5 if m == 0 else 0.25
    dtau_z = tau / (2.0 ** config.ndoubl)
    tau_sum = torch.cat([torch.zeros_like(tau[:1]),          # above each layer
                         torch.cumsum(tau, dim=0)[:-1]], dim=0)
    safe_tau = torch.where(tau > 0, tau, torch.ones_like(tau))
    th_base = 2.0 * np.pi * (1.0 - scat_w.sum(dim=1) / safe_tau) * thermal_b
    idx = torch.arange(N, device=dev)
    is_I = ((idx % ns) == 0).to(dtype)
    in_blk = (((idx >= config.i_mu0_start)
               & (idx < config.i_mu0_start + ns))
              | (torch.abs(qp_mu_N - mu0) <= 1e-9 * mu0)).to(dtype)
    d_vec = torch.as_tensor(stokes_d_vector(ns, config.nquad), dtype=dtype,
                            device=dev)
    args = (Z_pp_m, Z_mp_m, tau, scat_w,
            _expm1(-dtau_z[:, :, None] / qp_mu_N[None, None, :]),
            _expm1(-dtau_z / mu0), _exp(-tau_sum / mu0),
            _exp(-dtau_z / mu0), th_base * float(m == 0), F0 * fw,
            qp_mu_N, fw * wt_mu_N, d_vec, is_I, in_blk)
    kw = dict(ndoubl=config.ndoubl, ns_sched=config.ns_sched or None,
              ns_inter=config.ns_inter, n_stokes=ns,
              i_mu0_start=config.i_mu0_start, n_sources=config.n_sources)
    return args, kw


def rt_solve(inputs: SolverInputs, config: SolverConfig, device=None):
    """Full multi-moment solve on ``device``. Returns a dict of tensors:
    R, T, hdr (nVZA, n_stokes, nSpec); bhr_uw, bhr_dw (nSpec,); the m = 0
    stream vectors J0_up_toa, J0_dn_boa (nSpec, N); with
    ``config.save_streams`` also J_up_per_m, J_dn_per_m (n_m, nSpec, N)."""
    dev = resolve_device(device)
    dtype = config.torch_dtype
    n_spec, N, nz = config.n_spec, config.N, config.nz
    ns = config.n_stokes
    # Cast before the move: a spectrally resolved surface arrives as a
    # host f64 chunk, and crosses to the device in the solver's dtype.
    inp = SolverInputs(*(torch.as_tensor(x).to(dtype=dtype).to(device=dev)
                         for x in inputs))

    qp_mu_N, wt_mu_N = inp.qp_mu_N, inp.wt_mu_N
    mu0 = qp_mu_N[config.i_mu0_start]
    d_vec = torch.as_tensor(stokes_d_vector(ns, config.nquad), dtype=dtype,
                            device=dev)
    tau, scat_w, F0, surf_spec = inp.tau, inp.scat_w, inp.F0, inp.surf_spec
    # Cumulative optical depth above each layer
    # (compEffectiveLayerProperties.jl:84-91).
    tau_sum = torch.cat([torch.zeros((1, n_spec), dtype=dtype, device=dev),
                         torch.cumsum(tau, dim=0)], dim=0)

    vza_rows = torch.as_tensor(
        [[v * ns + k for k in range(ns)] for v in config.vza_idx],
        device=dev)                                          # (nvza, ns)
    n_m = config.m_max + 1
    fourier_w = [0.5] + [0.25] * (n_m - 1)

    use_band = config.fused and nz >= 1
    R = torch.zeros((len(config.vza_idx), ns, n_spec), dtype=dtype, device=dev)
    T = torch.zeros_like(R)
    hdr = torch.zeros_like(R)
    bhr_uw = torch.zeros((n_spec,), dtype=dtype, device=dev)
    bhr_dw = torch.zeros_like(bhr_uw)
    Jup0 = Jdn0 = None
    J_up, J_dn = [], []
    wq_I = wt_mu_N * qp_mu_N * ((torch.arange(N, device=dev) % ns) == 0)

    def weigh(J, m):
        """J (s, N) at each VZA's Stokes rows, times the moment's azimuthal
        weights -> (nvza, ns, s)."""
        return J[:, vza_rows].permute(1, 2, 0) * inp.vza_w[m][:, :, None]

    n_full = n_m if config.m_scat < 0 else min(config.m_scat + 1, n_m)
    for m in range(n_full):
        fw, is_m0 = fourier_w[m], m == 0
        Z_pp_m, Z_mp_m = inp.Z_pp[m], inp.Z_mp[m]
        if use_band:
            args, kw = band_moment_args(inp, config, m, dev)
            comp = CompositeLayer(*fused_moment(*args, **kw))
        else:
            comp = identity_composite(n_spec, N, dtype, dev, config.n_sources)
            for z in range(nz):
                r_mp, t_pp, j0_p, j0_m, expk = _elemental_and_sources(
                    tau[z], scat_w[z], tau_sum[z], inp.thermal_b[z],
                    Z_pp_m=Z_pp_m, Z_mp_m=Z_mp_m, qp_mu_N=qp_mu_N,
                    wt_mu_N=wt_mu_N, mu0=mu0, config=config, F0=F0,
                    fourier_w=fw, is_m0=is_m0)
                comp = interaction(comp, doubling(
                    r_mp, t_pp, j0_p, j0_m, expk, config.ndoubl, d_vec))

        surf = _surface_layer(inp.surf_r[m], inp.surf_j_m[m],
                              inp.surf_direct_m[m], surf_spec, F0,
                              tau_sum[nz], mu0, inp.sif_spec, is_m0, config)
        comp_out = interaction(comp, surf)

        # Azimuthal weighting (postprocessing_vza.jl:50-94): every source
        # slot adds into the same output.
        J0_m = comp_out.J0_m.sum(dim=-1)                     # (s, N)
        J0_p = comp_out.J0_p.sum(dim=-1)
        R = R + weigh(J0_m, m)
        T = T + weigh(J0_p, m)
        # HDRF / BHR (interaction_hdrf.jl:1-42): surface-leaving radiance
        # r_surf J0+ + j_surf-; fluxes at m = 0 with the direct term.
        hdr_J = (torch.matmul(surf.r_mp, comp_out.J0_p).sum(dim=-1)
                 + surf.j0_m.sum(dim=-1))
        hdr = hdr + weigh(hdr_J, m)
        if is_m0:
            bhr_uw = bhr_uw + (hdr_J * wq_I[None, :]).sum(dim=1)
            bhr_dw = bhr_dw + ((J0_p * wq_I[None, :]).sum(dim=1)
                               + surf.j0_p[:, config.i_mu0_start, 0]
                               * qp_mu_N[config.i_mu0_start])
            Jup0, Jdn0 = J0_m, J0_p
        if config.save_streams:
            J_up.append(J0_m)
            J_dn.append(J0_p)

    # Moments above m_scat: the exact Beer-law shortcut.
    for m in range(n_full, n_m):
        j0m, Jtoa, j0p_m = beer_moment(tau_sum[nz], F0, surf_spec,
                                       inp.surf_j_m[m], inp.surf_direct_m[m],
                                       qp_mu_N, config)
        R = R + weigh(Jtoa, m)
        T = T + weigh(j0p_m, m)
        surf_r_m = inp.surf_r[m]
        hdr_J = (torch.einsum("sij,sj->si", surf_r_m, j0p_m)
                 if surf_r_m.dim() == 3 else torch.matmul(j0p_m, surf_r_m.T)) \
            * surf_spec[:, None] + j0m
        hdr = hdr + weigh(hdr_J, m)
        if config.save_streams:
            J_up.append(Jtoa)
            J_dn.append(j0p_m)

    out = {"R": R, "T": T, "hdr": hdr, "bhr_uw": bhr_uw, "bhr_dw": bhr_dw,
           "J0_up_toa": Jup0, "J0_dn_boa": Jdn0}
    if config.save_streams:
        out["J_up_per_m"] = torch.stack(J_up)
        out["J_dn_per_m"] = torch.stack(J_dn)
    return out


#: Spectral axis of each SolverInputs field that has one; surf_r and
#: surf_j_m have one only when 4-D (a spectrally resolved surface).
SPECTRAL_AXIS = {"tau": 1, "scat_w": 2, "F0": 1, "surf_spec": 0,
                 "thermal_b": 1, "sif_spec": 0, "surf_r": 1, "surf_j_m": 1}


def spectral_fields(inputs: SolverInputs = None) -> dict:
    """{field: spectral axis} of the SolverInputs fields that carry one:
    every field of ``SPECTRAL_AXIS``, but surf_r and surf_j_m only when
    ``inputs`` has them 4-D (without ``inputs``, a surface that is not
    spectrally resolved)."""
    return {f: ax for f, ax in SPECTRAL_AXIS.items()
            if f not in SPECTRAL_SURFACE
            or (inputs is not None and getattr(inputs, f).dim() == 4)}


def spectral_take(inputs: SolverInputs, config: SolverConfig, idx):
    """(inputs, config) of the spectral points ``idx`` (a 1-D index
    tensor, in any order) of a band."""
    idx = torch.as_tensor(idx)
    cut = {f: getattr(inputs, f).index_select(
        ax, idx.to(getattr(inputs, f).device))
        for f, ax in spectral_fields(inputs).items()}
    return inputs._replace(**cut), dataclasses.replace(config,
                                                       n_spec=len(idx))


def spectral_slice(inputs: SolverInputs, config: SolverConfig, start: int,
                   stop: int):
    """(inputs, config) of the spectral points [start, stop) of a band."""
    cut = {f: getattr(inputs, f).narrow(ax, start, stop - start)
           for f, ax in spectral_fields(inputs).items()}
    return inputs._replace(**cut), dataclasses.replace(config,
                                                       n_spec=stop - start)


def timing_on(model) -> bool:
    """Whether a run records and prints the stage table:
    ``Parameters.verbose`` or ``VSM_TIMING``."""
    return bool(getattr(model.params, "verbose", False)) or timing.enabled()


def rt_run_full(model, device=None, spectral_chunk=None):
    """Forward run returning R, T, hdr, bhr_uw, bhr_dw as numpy arrays
    concatenated over bands. ``spectral_chunk`` solves each band in chunks of
    that many spectral points (bounding device memory; None = whole band).
    Cox-Munk surfaces get the TMS single-scatter glint correction on the
    host after the Fourier sum (rt_run.jl:519-524).

    A canopy scene's T and bhr_dw are the fields at canopy top, the
    direct beam there (attenuated by the atmosphere alone) in the direct
    slot, as in the JAX package; the reference zeroes that slot
    (canopy_surface.jl:459). LAI -> 0
    reduces to the bare-soil scene and a conservative surface keeps
    bhr_uw == bhr_dw, but those two outputs differ from the reference's
    even where R agrees.

    Its stages (``build_band[i]``, ``rt_solve[i]``) go into
    ``utils.timing``'s table, synchronised on CUDA while timing is on."""
    dev = resolve_device(device)
    on = timing_on(model)
    sync = torch.cuda.synchronize if dev.type == "cuda" else None
    keys = ("R", "T", "hdr", "bhr_uw", "bhr_dw")
    acc = {k: [] for k in keys}
    for i_band, band in enumerate(model.bands):
        with timing.stage(f"build_band[{i_band}]", sync, on):
            inputs, config = model.build_band(i_band, device=dev)
        step = spectral_chunk or config.n_spec
        parts = []
        with timing.stage(f"rt_solve[{i_band}]", sync, on):
            for a in range(0, config.n_spec, step):
                o = rt_solve(*spectral_slice(inputs, config, a,
                                             min(a + step, config.n_spec)),
                             dev)
                parts.append({k: o[k].cpu().numpy() for k in keys})
        out = {k: np.concatenate([p[k] for p in parts], axis=-1)
               for k in keys}
        if band.surface.kind == "CoxMunkSurface":
            from ..surfaces.coxmunk import CoxMunkSurface, tms_correction
            surf = CoxMunkSurface(**{k: v for k, v in
                                     band.surface.kwargs.items()
                                     if not k.startswith("_")})
            tau_total = inputs.tau.sum(dim=0).cpu().numpy()  # (nSpec,)
            out["R"] = out["R"] + tms_correction(
                surf, config.n_stokes, model.params.vza, model.params.vaz,
                model.quad.mu0, tau_total, config.m_max)
        for k in keys:
            acc[k].append(out[k])
    return {k: np.concatenate(v, axis=-1) for k, v in acc.items()}


def rt_run(model, device=None, spectral_chunk=None):
    """User-facing forward run (rt_run.jl:53): (R, T) numpy arrays of shape
    (nVZA, n_stokes, nSpec_total), radiance factors I/F0. With
    ``Parameters.verbose`` or ``VSM_TIMING`` it prints the stage table."""
    out = rt_run_full(model, device, spectral_chunk)
    if timing_on(model):
        print(timing.report())
    return out["R"], out["T"]


def rt_run_streams(model, i_band: int = 0, device=None):
    """Per-Fourier-moment stream export (rt_run.jl:107-193): the per-moment
    J vectors at every quadrature stream plus the reconstruction weights."""
    dev = resolve_device(device)
    inputs, config = model.build_band(i_band, device=dev)
    config = dataclasses.replace(config, save_streams=True)
    out = rt_solve(inputs, config, dev)
    n_m = config.m_max + 1
    band = model.bands[i_band]
    return {
        "J_up_per_m": out["J_up_per_m"].cpu().numpy(),
        "J_dn_per_m": out["J_dn_per_m"].cpu().numpy(),
        "weights": np.asarray([0.5 / np.pi] + [1.0 / np.pi] * (n_m - 1)),
        "qp_mu": model.quad.qp_mu,
        "wt_mu": model.quad.wt_mu,
        "pol_n": config.n_stokes,
        "tau_rayl": band.tau_rayl,
        "tau_abs": band.tau_abs,
        "tau_total": inputs.tau.T.cpu().numpy(),
        "R": out["R"].cpu().numpy(),
    }
