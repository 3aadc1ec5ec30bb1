"""Multi-sensor RT: up- and downwelling radiances at arbitrary sensor levels.

Counterpart of ``vsmartmom_tpu/core/multisensor.py`` (reference
rt_run_multisensor.jl ``rt_run_test_ms``, rt_kernel_multisensor.jl,
interaction_multisensor.jl and interlayer_flux.jl). A sensor level L in [0, Nz] is the interface below
layer L (0 = TOA, Nz = BOA, between = airborne, balloon or tower). For each
sensor the column splits into a *top* stack (layers 1..L) and a *bot* stack
(layers L+1..Nz plus the surface), and the field at the interface follows
from the two-stack coupling:

    dwJ = (I - topR+- botR-+)^-1 (topJ0+ + topR+- botJ0-)
    uwJ = (I - botR-+ topR+-)^-1 (botJ0- + botR-+ topJ0+)

Per Fourier moment the driver stashes every layer's added operators in one
batch (``solver._make_added_layer``: one launch of the doubling kernel K5 on
the kernel route), then per sensor builds the top stack by a forward adding
loop and the bot stack by a reverse *prepend* loop (the adding equations are
a symmetric two-stack composition, so prepending is ``interaction`` with the
container roles swapped). Every moment takes this full path; there is no
Beer-law split above m_scat, as in the JAX driver.

The inelastic twin ``rt_solve_ms_rrs`` (``rt_run_ms_rrs``, RRS and VS)
carries the ie counterparts of both stacks (the reference's
CompositeLayerMS(RS), types.jl:339-422): per moment it stashes every
layer's (AddedLayer, IEAdded) from the plain ``doubling_rs``, builds each
sensor's top stack by forward ie adding and its bot stack by reverse ie
prepending (``ie_interaction`` with the container roles swapped), and
couples the two by the bichromatic product rule (``ie_interlayer_flux``).
It runs plain torch on the device, as the JAX package runs XLA.
"""

from dataclasses import replace as dc_replace

import numpy as np
import torch

from ..ops import fused_rt
from .inelastic import (IEAdded, IEComposite, _B, _Bv, _L, _Lv,
                        _added_layer_rs, _mv, _roll0, _roll_all, _rs_column,
                        _solve_eye, _surface_rs, _weigh, ie_interaction,
                        inelastic_setup, source_map, zero_ie_composite)
from .kernels import (AddedLayer, CompositeLayer, identity_composite,
                      interaction)
from .solver import _make_added_layer, _surface_layer
from .types import (SolverConfig, SolverInputs, kernel_takes_width,
                    resolve_device, stokes_d_vector)


def interaction_prepend(add: AddedLayer, comp: CompositeLayer
                        ) -> CompositeLayer:
    """Compose ``add`` (above) with ``comp`` (below): ``interaction`` with
    the upper and lower container roles swapped."""
    upper = CompositeLayer(*add)
    lower = AddedLayer(*comp)
    return interaction(upper, lower)


def _composite_from_added(add: AddedLayer) -> CompositeLayer:
    return CompositeLayer(*add)


def interlayer_flux(top: CompositeLayer, bot: CompositeLayer):
    """(dwJ, uwJ) stream vectors (s, N, K) at the top/bot interface
    (interlayer_flux_helper!, interlayer_flux.jl:185-202)."""
    N = top.T_pp.shape[-1]
    eye = torch.eye(N, dtype=top.T_pp.dtype, device=top.T_pp.device)
    dwJ = torch.linalg.solve(eye - top.R_pm @ bot.R_mp,
                             top.J0_p + top.R_pm @ bot.J0_m)
    uwJ = torch.linalg.solve(eye - bot.R_mp @ top.R_pm,
                             bot.J0_m + bot.R_mp @ top.J0_p)
    return dwJ, uwJ


def layer_batch_args(inp: SolverInputs, config: SolverConfig, m: int):
    """(layer_data, kwargs) of ``solver._make_added_layer`` for moment m,
    from inputs already on their device in the solver's dtype: the layer
    tables with the optical depth above each layer, and the moment's phase
    matrices, geometry, Fourier weight and D diagonal."""
    mu0 = inp.qp_mu_N[config.i_mu0_start]
    tau_sum = torch.cat([torch.zeros_like(inp.tau[:1]),
                         torch.cumsum(inp.tau, dim=0)[:-1]], dim=0)
    d_vec = torch.as_tensor(stokes_d_vector(config.n_stokes, config.nquad),
                            dtype=inp.tau.dtype, device=inp.tau.device)
    kw = dict(Z_pp_m=inp.Z_pp[m], Z_mp_m=inp.Z_mp[m], qp_mu_N=inp.qp_mu_N,
              wt_mu_N=inp.wt_mu_N, mu0=mu0, config=config, F0=inp.F0,
              fourier_w=0.5 if m == 0 else 0.25, is_m0=m == 0, d_vec=d_vec)
    return (inp.tau, inp.scat_w, tau_sum, inp.thermal_b), kw


def rt_solve_ms(inputs: SolverInputs, config: SolverConfig, sensor_levels,
                device=None):
    """Multi-sensor solve on ``device``. Returns a dict with uwJ and dwJ,
    each (n_sensors, nVZA, n_stokes, nSpec): the up- and downwelling
    radiance at each sensor level.

    As in the reference, sensor level 0 (TOA) reports (TOA upwelling, BOA
    downwelling), rt_solve's (R, T) (postprocessing_vza_ms.jl:31-41)."""
    dev = resolve_device(device)
    dtype = config.torch_dtype
    n_spec, N, nz = config.n_spec, config.N, config.nz
    ns = config.n_stokes
    levels = tuple(int(v) for v in sensor_levels)
    # Cast before the move: a spectrally resolved surface arrives as a
    # host f64 tensor and crosses whole, in the solver's dtype.
    inp = SolverInputs(*(torch.as_tensor(x).to(dtype=dtype).to(device=dev)
                         for x in inputs))
    mu0 = inp.qp_mu_N[config.i_mu0_start]
    tau_boa = torch.cumsum(inp.tau, dim=0)[-1]
    vza_rows = torch.as_tensor(
        [[v * ns + k for k in range(ns)] for v in config.vza_idx],
        device=dev)
    uwJ = torch.zeros((len(levels), len(config.vza_idx), ns, n_spec),
                      dtype=dtype, device=dev)
    dwJ = torch.zeros_like(uwJ)

    for m in range(config.m_max + 1):
        layer_data, kw = layer_batch_args(inp, config, m)
        adds = _make_added_layer(layer_data, **kw)
        surf = _surface_layer(inp.surf_r[m], inp.surf_j_m[m],
                              inp.surf_direct_m[m], inp.surf_spec, inp.F0,
                              tau_boa, mu0, inp.sif_spec, m == 0, config)
        for i_s, L in enumerate(levels):
            top = identity_composite(n_spec, N, dtype, dev, config.n_sources)
            for z in range(L):
                top = interaction(top, AddedLayer(*(x[z] for x in adds)))
            bot = _composite_from_added(surf)
            for z in reversed(range(L, nz)):
                bot = interaction_prepend(AddedLayer(*(x[z] for x in adds)),
                                          bot)
            if L == 0:
                # TOA: (TOA up, BOA down) from the full-column composite
                # (postprocessing_vza_ms.jl:32-34).
                uw, dw = bot.J0_m, bot.J0_p
            else:
                dw, uw = interlayer_flux(top, bot)
            w3 = inp.vza_w[m][:, :, None]
            uwJ[i_s] += uw.sum(dim=-1)[:, vza_rows].permute(1, 2, 0) * w3
            dwJ[i_s] += dw.sum(dim=-1)[:, vza_rows].permute(1, 2, 0) * w3
        del adds                      # free the moment's stash before the next
    return {"uwJ": uwJ, "dwJ": dwJ}


def rt_run_ms(model, sensor_levels, i_band: int = 0, device=None):
    """User-facing multi-sensor run (reference ``rt_run_test_ms``).

    sensor_levels: ints in [0, Nz], the number of layers above each sensor
    (0 = TOA, Nz = BOA). Returns (uwJ, dwJ) numpy arrays, each (n_sensors,
    nVZA, n_stokes, nSpec). Runs on CUDA unless ``device`` is given; an f32
    model on CUDA takes the kernel route (K5 for each moment's layers). A
    scene that K1 takes but K5 does not (N > ``ops.fused_rt.KERNEL_MAX_N``)
    runs the LU ladder instead, with one warning, when
    ``model.params.fused`` was left at None (an explicit True still
    launches, and K5 refuses)."""
    dev = resolve_device(device)
    inputs, config = model.build_band(i_band, device=dev)
    if config.fused and model.params.fused is None and not \
            kernel_takes_width("K5 (csrc/fused_rt.cu)",
                               fused_rt.KERNEL_MAX_N, config.N):
        config = dc_replace(config, fused=False)
    levels = tuple(int(v) for v in sensor_levels)
    for v in levels:
        if not 0 <= v <= config.nz:
            raise ValueError(f"sensor level {v} outside [0, {config.nz}]")
    out = rt_solve_ms(inputs, config, levels, dev)
    return out["uwJ"].cpu().numpy(), out["dwJ"].cpu().numpy()


def ie_interlayer_flux(top, bot, top_ie: IEComposite, bot_ie: IEComposite,
                       shifts, src_fn=_roll0):
    """(dwJ, uwJ, iedwJ, ieuwJ) at the top/bot interface: the elastic
    fields summed over source slots (s, N) and the ie fields summed over
    shifts (s, N), by the bichromatic product rule applied to
    ``interlayer_flux`` (interlayer_flux.jl:185-202; the ie pattern of
    interaction_multisensor.jl):

        dwJ = G1 u,  G1 = (I - topR+- botR-+)^-1, u = topJ0+ + topR+- botJ0-
        ie(G1) = G1 (ieTopR+- R0(botR-+) + topR+- ieBotR-+) R0(G1)

    with R0 the source map (the value at the source wavelength)."""
    eye = torch.eye(top.T_pp.shape[-1], dtype=top.T_pp.dtype,
                    device=top.T_pp.device)
    topJp = top.J0_p.sum(dim=-1)
    botJm = bot.J0_m.sum(dim=-1)
    G1 = _solve_eye(eye - top.R_pm @ bot.R_mp)
    u1 = topJp + _mv(top.R_pm, botJm)
    G2 = _solve_eye(eye - bot.R_mp @ top.R_pm)
    u2 = botJm + _mv(bot.R_mp, topJp)
    bRmp0, G1_0, tRpm0, G2_0 = _roll_all(src_fn, shifts, bot.R_mp, G1,
                                         top.R_pm, G2)
    u1_0, botJm0, u2_0, topJp0 = _roll_all(src_fn, shifts, u1, botJm, u2,
                                           topJp)
    tRpm, tJp = top_ie.ieR_pm, top_ie.ieJp
    bRmp, bJm = bot_ie.ieR_mp, bot_ie.ieJm
    ieG1 = _L(G1, _B(_B(tRpm, bRmp0) + _L(top.R_pm, bRmp), G1_0))
    iedw = _Bv(ieG1, u1_0) + _Lv(G1, tJp + _Bv(tRpm, botJm0)
                                 + _Lv(top.R_pm, bJm))
    ieG2 = _L(G2, _B(_B(bRmp, tRpm0) + _L(bot.R_mp, tRpm), G2_0))
    ieuw = _Bv(ieG2, u2_0) + _Lv(G2, bJm + _Bv(bRmp, topJp0)
                                 + _Lv(bot.R_mp, tJp))
    dwJ, uwJ = interlayer_flux(top, bot)
    return dwJ.sum(dim=-1), uwJ.sum(dim=-1), iedw.sum(dim=0), \
        ieuw.sum(dim=0)


def rt_solve_ms_rrs(inputs: SolverInputs, config: SolverConfig,
                    sensor_levels, shifts, w_shifts, Z_r_pp, Z_r_mp, fscatt,
                    device=None, src_fn=_roll0):
    """Multi-sensor solve with the inelastic (RRS or VS) fields on
    ``device``: a dict with uwJ, dwJ, ieuwJ and iedwJ at every sensor
    level, each (n_sensors, nVZA, n_stokes, nSpec). The Raman arguments
    are ``core.inelastic.rt_solve_rrs``'s. As in ``rt_solve_ms``, level 0
    reports (TOA up, BOA down)."""
    dev = resolve_device(device)
    dtype = config.torch_dtype
    n_spec, N, nz = config.n_spec, config.N, config.nz
    n_r = len(shifts)
    levels = tuple(int(v) for v in sensor_levels)
    col = _rs_column(inputs, config, dev, w_shifts, Z_r_pp, Z_r_mp, fscatt)
    out = {k: torch.zeros((len(levels), len(config.vza_idx),
                           config.n_stokes, n_spec), dtype=dtype, device=dev)
           for k in ("uwJ", "dwJ", "ieuwJ", "iedwJ")}

    for m in range(config.m_max + 1):
        stash = [_added_layer_rs(col, config, m, z, shifts, src_fn)
                 for z in range(nz)]
        surf = _surface_rs(col, config, m)
        for i_s, L in enumerate(levels):
            top = identity_composite(n_spec, N, dtype, dev, 1)
            top_ie = zero_ie_composite(n_r, n_spec, N, dtype, dev)
            for add, add_ie in stash[:L]:
                top_ie = ie_interaction(top, add, top_ie, add_ie, shifts,
                                        src_fn)
                top = interaction(top, add)
            bot = _composite_from_added(surf)
            bot_ie = zero_ie_composite(n_r, n_spec, N, dtype, dev)
            for add, add_ie in reversed(stash[L:]):
                # prepend: the layer lies ABOVE the stack, the same
                # two-stack composition with the container roles swapped.
                bot_ie = ie_interaction(CompositeLayer(*add),
                                        AddedLayer(*bot),
                                        IEComposite(*add_ie),
                                        IEAdded(*bot_ie), shifts, src_fn)
                bot = interaction_prepend(add, bot)
            if L == 0:
                fields = (bot.J0_m.sum(dim=-1), bot.J0_p.sum(dim=-1),
                          bot_ie.ieJm.sum(dim=0), bot_ie.ieJp.sum(dim=0))
            else:
                dw, uw, iedw, ieuw = ie_interlayer_flux(
                    top, bot, top_ie, bot_ie, shifts, src_fn)
                fields = (uw, dw, ieuw, iedw)
            for k, J in zip(("uwJ", "dwJ", "ieuwJ", "iedwJ"), fields):
                out[k][i_s] += _weigh(J, col.vza_rows, col.inp.vza_w[m])
        del stash                     # free the moment's stash before the next
    return out


def ie_stash_bytes(config, n_shifts) -> int:
    """Bytes of one moment's stash of per-layer ie operators in
    ``rt_solve_ms_rrs``: four (nz, nR, nSpec, N, N) matrix fields and two
    (nz, nR, nSpec, N) source fields in ``config.dtype``."""
    N, per = config.N, config.nz * n_shifts * config.n_spec
    return (4 * N * N + 2 * N) * per * np.dtype(config.dtype).itemsize


def rt_run_ms_rrs(model, sensor_levels, i_band: int = 0, mode: str = "RRS",
                  device=None):
    """User-facing multisensor + inelastic run (reference
    rt_run_test_ms(RS_type, ...) with CompositeLayerMSRS containers), for
    mode "RRS", "VS_0to1" or "VS_1to0" (``core.inelastic.inelastic_setup``).
    Plain torch on CUDA unless ``device`` is given. Returns numpy (uwJ,
    dwJ, ieuwJ, iedwJ), each (n_sensors, nVZA, n_stokes, nSpec); the total
    radiance at a sensor is uwJ + ieuwJ (up) and dwJ + iedwJ (down)."""
    dev = resolve_device(device)
    inputs, config, *rrs = inelastic_setup(model, i_band, mode, dev)
    levels = tuple(int(v) for v in sensor_levels)
    for v in levels:
        if not 0 <= v <= config.nz:
            raise ValueError(f"sensor level {v} outside [0, {config.nz}]")
    out = rt_solve_ms_rrs(inputs, config, levels, *rrs, dev,
                          src_fn=source_map(mode))
    return tuple(out[k].cpu().numpy()
                 for k in ("uwJ", "dwJ", "ieuwJ", "iedwJ"))
