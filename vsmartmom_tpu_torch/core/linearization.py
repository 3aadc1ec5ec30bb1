"""Linearized RT: Jacobians dR/dx, dT/dx with respect to aerosol, gas and
surface parameters.

Counterpart of ``vsmartmom_tpu/core/linearization.py``. The solver is
differentiated in forward mode and chained with host-side tangents of the
model build:

* linear inputs (tau_ref, Lambertian albedo): analytic;
* the vertical profile (p0, sigma_p): central differences of the cheap
  profile function;
* Mie microphysics (n_r, n_i, r_mode, sigma_g): exact forward-mode tangents
  of the NAI-2 -> delta-BGE -> delta-M pipeline (``scattering/mie_lin.py``;
  ``_aerosol_tangents(..., mie_method="fd")`` keeps central differences of
  the host build, which the tests hold the exact route against);
* a gas's VMR scale (vmr -> vmr (1 + x)): tau_abs_by_mol[gas], a pure
  tau tangent;
* Cox-Munk wind speed: the analytic sigma^2-chain tangent of the surface
  operators and of the TMS correction.

``rt_run_lin`` routes by configuration: the band path (``config.fused``)
runs the multitangent kernel K2 (``ops/fused_lin.py``) for solar (K = 1)
and thermal (K = 2, solar + Planck) scenes alike; the plain path runs
``torch.func.jvp`` through ``rt_solve``, vmapped over the tangents, which
is the Jacobian baseline. A scene too wide for K2 whose strategy was left
automatic (``Parameters.fused`` None) takes the plain path with a warning.

The band is built once per call and its inputs are handed to every tangent
build; nothing is cached on the model.

Parameter layout mirrors the reference ParameterLayout
(CoreRT/parameter_layout.jl:20-66): 7 per aerosol [tau_ref, n_r, n_i,
r_mode, sigma_g, p0, sigma_p], one per gas (VMR scale), then surface
parameters (albedo | wind speed).
"""

from dataclasses import dataclass, replace as dc_replace

import numpy as np
import torch

from .solver import rt_solve
from .types import SolverInputs, kernel_takes_width, resolve_device

AEROSOL_PARAMS = ("tau_ref", "n_r", "n_i", "r_mode", "sigma_g", "p0",
                  "sigma_p")
GREEK_FIELDS = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta")


@dataclass(frozen=True)
class ParameterLayout:
    """Jacobian index arithmetic (reference parameter_layout.jl:20-66)."""
    n_aer: int
    gas_names: tuple
    surface_params: tuple      # e.g. ("albedo",) or ("wind_speed",)

    @property
    def n_total(self) -> int:
        return 7 * self.n_aer + len(self.gas_names) + len(self.surface_params)

    def aerosol_slice(self, i):
        return slice(7 * i, 7 * (i + 1))

    def gas_index(self, j):
        return 7 * self.n_aer + j

    def surface_index(self, j=0):
        return 7 * self.n_aer + len(self.gas_names) + j

    def names(self):
        out = []
        for i in range(self.n_aer):
            out += [f"aer{i}_{p}" for p in AEROSOL_PARAMS]
        out += [f"vmr_{g}" for g in self.gas_names]
        out += list(self.surface_params)
        return out


def default_layout(model, i_band: int = 0) -> ParameterLayout:
    """Every aerosol's 7 parameters, each line-list gas's VMR scale and the
    surface's."""
    band = model.bands[i_band]
    kind = band.surface.kind
    if kind == "CoxMunkSurface":
        surf = ("wind_speed",)
    elif kind == "LambertianSurfaceScalar":
        surf = ("albedo",)
    else:
        surf = ()
    return ParameterLayout(n_aer=len(band.aerosols),
                           gas_names=tuple(band.tau_abs_by_mol),
                           surface_params=surf)


def _zero_like(inputs: SolverInputs) -> SolverInputs:
    """A zero tangent of every field that takes no memory: a zero scalar
    expanded to the field's shape (stride 0), which ``is_zero_field``
    recognises, so a field no parameter moves is held fixed rather than
    stacked P times (a 4-D canopy surface is ~0.35 GB a copy in f64 at the
    canopy column's full width)."""
    return SolverInputs(*(
        torch.zeros((), dtype=x.dtype, device=x.device).expand(x.shape)
        for x in inputs))


def is_zero_field(x) -> bool:
    """Whether a tangent field is a structural zero of ``_zero_like``."""
    return isinstance(x, torch.Tensor) and x.dim() > 0 and \
        x.numel() > 0 and all(st == 0 for st in x.stride()) and \
        not bool(x[(0,) * x.dim()])


def live_fields(tangents) -> tuple:
    """The SolverInputs fields that some tangent moves (not every one a
    structural zero), in field order."""
    return tuple(f for f in SolverInputs._fields
                 if not all(is_zero_field(getattr(t, f)) for t in tangents))


def refuse_empty(tangents, entry: str) -> None:
    """A Jacobian solve needs at least one tangent."""
    if len(tangents) == 0:
        raise ValueError(f"{entry} was given no tangent: the Jacobian "
                         "layout holds no parameter")


def _like(x, ref):
    return torch.as_tensor(np.array(x), dtype=ref.dtype, device=ref.device)


def _component_tangent_inputs(model, i_band, inputs: SolverInputs,
                              comp_index, d_comp, tables, zero):
    """SolverInputs tangent from a ScatteringComponent tangent (d_greek,
    d_tau_profile, d_ssa) of aerosol ``comp_index``, holding everything
    else of the band's ``inputs`` fixed (``zero``, the shared zero tangent
    of ``_zero_like``); the Z moments are linear in the Greek coefficients
    and come from the build's Legendre ``tables``."""
    from ..scattering.zmatrix import compute_Z_moments
    comp = model.bands[i_band].aerosols[comp_index]
    c = comp_index + 1                 # component axis: 0 = Rayleigh
    nz, _, n_spec = inputs.scat_w.shape
    d_tau_prof = np.asarray(d_comp["tau_profile"])          # (Nz,)
    d_ssa = float(d_comp.get("ssa", 0.0))
    d_scat = torch.zeros_like(inputs.scat_w)
    d_scat[:, c, :] = _like(d_tau_prof[:, None] * comp.ssa
                            + comp.tau_profile[:, None] * d_ssa,
                            inputs.scat_w)
    d_tau = _like(np.broadcast_to(d_tau_prof[:, None], (nz, n_spec)),
                  inputs.tau)
    d_inputs = zero._replace(scat_w=d_scat, tau=d_tau)
    d_greek = d_comp.get("greek")
    if d_greek is not None:
        pol = model.params.polarization
        dZ_pp = torch.zeros_like(inputs.Z_pp)
        dZ_mp = torch.zeros_like(inputs.Z_mp)
        for m in range(inputs.Z_pp.shape[0]):
            zp, zm = compute_Z_moments(pol, model.quad.qp_mu, d_greek, m,
                                       tables)
            dZ_pp[m, c] = _like(zp, dZ_pp)
            dZ_mp[m, c] = _like(zm, dZ_mp)
        d_inputs = d_inputs._replace(Z_pp=dZ_pp, Z_mp=dZ_mp)
    return d_inputs


def _aerosol_tangents(model, i_band, i_aer, fd_rel=1e-3,
                      mie_method: str = "exact"):
    """Tangents of aerosol ``i_aer``'s ScatteringComponent for its 7
    parameters: dicts of tau_profile, ssa and (Mie parameters) greek."""
    from ..scattering.greek import GreekCoefs
    from .atmosphere import aerosol_profile_shape
    from .model import band_lambda_um, build_one_aerosol, uses_delta_bge

    band = model.bands[i_band]
    comp = band.aerosols[i_aer]
    aer = comp.aer
    params = model.params
    lam_band = band_lambda_um(band.nu_grid)
    tangents = {"tau_ref": {"tau_profile": comp.tau_profile / aer.tau_ref,
                            "ssa": 0.0}}

    # Profile-shape parameters (p0/sigma_p or z0/sigma_z): only the
    # normalized vertical profile changes — central differences of the
    # cheap profile function. Slots 5/6 carry whichever form the aerosol uses.
    scale = comp.tau_profile.sum() / max(
        aerosol_profile_shape(aer, model.profile).sum(), 1e-300)
    prof_attrs = ("p0", "sigma_p") if aer.p0 is not None else ("z0", "sigma_z")
    for name, attr in zip(("p0", "sigma_p"), prof_attrs):
        x = getattr(aer, attr)
        h = max(abs(x) * fd_rel, 1e-6)
        hi = aerosol_profile_shape(dc_replace(aer, **{attr: x + h}),
                                   model.profile)
        lo = aerosol_profile_shape(dc_replace(aer, **{attr: x - h}),
                                   model.profile)
        tangents[name] = {"tau_profile": scale * (hi - lo) / (2 * h),
                          "ssa": 0.0}

    mie_params = {"n_r": 0, "n_i": 1, "r_mode": 2, "sigma_g": 3}
    if aer.phase_function_g is not None:
        for pname in mie_params:
            tangents[pname] = {"tau_profile": np.zeros_like(comp.tau_profile),
                               "ssa": 0.0}
        return tangents

    if mie_method == "exact":
        from ..scattering.mie_lin import (exact_aerosol_mie_tangents,
                                          greek_tangent_as_coefs)
        _, jac = exact_aerosol_mie_tangents(
            aer, params.scattering_params, lam_band,
            aerosol_profile_shape(aer, model.profile), uses_delta_bge(params),
            params.stream_l_cap)
        for pname, ip in mie_params.items():
            tangents[pname] = {
                "tau_profile": np.asarray(jac["tau_profile"][:, ip]),
                "ssa": float(jac["ssa"][ip]),
                "greek": greek_tangent_as_coefs(jac["greek"], ip)}
        return tangents
    if mie_method != "fd":
        raise ValueError(f"mie_method must be 'exact' or 'fd', got "
                         f"{mie_method!r}")

    fd_attr = {"n_r": "n_r", "n_i": "n_i", "r_mode": "mu_log",
               "sigma_g": "sigma_log"}
    for pname, attr in fd_attr.items():
        x = getattr(aer, attr)
        h = max(abs(x) * fd_rel, 1e-5)
        hi = build_one_aerosol(params, model.profile,
                               dc_replace(aer, **{attr: x + h}), lam_band)
        lo = build_one_aerosol(params, model.profile,
                               dc_replace(aer, **{attr: x - h}), lam_band)
        inv2h = 1.0 / (2 * h)
        tangents[pname] = {
            "tau_profile": (hi.tau_profile - lo.tau_profile) * inv2h,
            "ssa": (hi.ssa - lo.ssa) * inv2h,
            "greek": GreekCoefs(*[
                (getattr(hi.greek, f) - getattr(lo.greek, f)) * inv2h
                for f in GREEK_FIELDS])}
    return tangents


def build_tangent_inputs(model, i_band, layout: ParameterLayout, fd_rel=1e-3,
                         device=None):
    """(inputs, config, tangents): the band's SolverInputs and SolverConfig
    from one ``build_band`` on ``device``, and one SolverInputs-shaped
    tangent per layout parameter (float64 tensors on ``device``). Every
    field a parameter does not move is one shared zero of no memory
    (``_zero_like``); a spectrally resolved surface (4-D surf_r, surf_j_m)
    stays where ``build_band`` left it."""
    from ..scattering.zmatrix import legendre_tables
    dev = resolve_device(device)
    band = model.bands[i_band]
    inputs, config = model.build_band(i_band, device=dev)
    zero = _zero_like(inputs)
    tangents = []

    if layout.n_aer:
        n_m = inputs.Z_pp.shape[0]
        tables = legendre_tables(model.quad.qp_mu,
                                 max(a.greek.l_max for a in band.aerosols),
                                 n_m)
    for i in range(layout.n_aer):
        per_aer = _aerosol_tangents(model, i_band, i, fd_rel)
        for pname in AEROSOL_PARAMS:
            tangents.append(_component_tangent_inputs(
                model, i_band, inputs, i, per_aer[pname], tables, zero))

    for gas in layout.gas_names:
        # parameter = multiplicative scale on the VMR profile: d tau = tau_mol
        tangents.append(zero._replace(
            tau=_like(band.tau_abs_by_mol[gas].T, inputs.tau)))

    for sp in layout.surface_params:
        if sp == "albedo":
            albedo = band.surface.args[0]
            d_spec = inputs.surf_spec / albedo if albedo != 0 \
                else torch.ones_like(inputs.surf_spec)
            tangents.append(zero._replace(surf_spec=d_spec))
        elif sp == "wind_speed":
            from ..surfaces.coxmunk import (CoxMunkSurface,
                                            coxmunk_surface_operator_arrays)
            surf = CoxMunkSurface(**{k: v for k, v in
                                     band.surface.kwargs.items()
                                     if not k.startswith("_")})
            _, _, d_r, d_j = coxmunk_surface_operator_arrays(
                surf, model.quad, config.n_stokes, inputs.surf_r.shape[0],
                wind_tangent=True)
            tangents.append(zero._replace(
                surf_r=_like(d_r, inputs.surf_r),
                surf_j_m=_like(d_j, inputs.surf_j_m)))
        else:
            raise NotImplementedError(sp)
    return inputs, config, tangents


def jvp_over(fn, primals: dict, tangents: dict, P: int):
    """vmap over P of ``torch.func.jvp`` of ``fn(**primals)``: ``tangents``
    maps the names of the arguments that move to their stacked (P, ...)
    tangents; every other argument is held fixed (closed over), so a field
    no parameter moves is never stacked. With no argument moving, zeros."""
    live = tuple(tangents)
    if not live:
        return tuple(torch.zeros((P,) + y.shape, dtype=y.dtype,
                                 device=y.device) for y in fn(**primals))

    def part(*xs):
        return fn(**{**primals, **dict(zip(live, xs))})
    prim = tuple(primals[k] for k in live)
    return torch.func.vmap(lambda *d: torch.func.jvp(part, prim, d)[1])(
        *(tangents[k] for k in live))


def rt_solve_jvp(inputs, tangents, config, device=None):
    """(R, T, dR, dT) tensors by forward-mode AD through ``rt_solve`` (the
    Jacobian baseline), vmapped over all P tangents at once; dR/dT
    (P, nVZA, ns, s). Fields that no tangent moves are held fixed."""
    refuse_empty(tangents, "rt_solve_jvp")
    dev = resolve_device(device)
    dtype = config.torch_dtype
    inp = SolverInputs(*(x.to(dtype) for x in inputs))

    def fn(**x):
        out = rt_solve(SolverInputs(**x), config, dev)
        return out["R"], out["T"]
    R, T = fn(**inp._asdict())
    d = {f: torch.stack([getattr(t, f).to(device=getattr(inp, f).device,
                                          dtype=dtype) for t in tangents])
         for f in live_fields(tangents)}
    dR, dT = jvp_over(fn, inp._asdict(), d, len(tangents))
    return R, T, dR, dT


def tms_tau_term(base, tangents, mu0):
    """(..., nSpec, P): the derivative of the Cox-Munk TMS term ``base``
    (..., nSpec), which the column attenuates by mu0 exp(-tau_total /
    mu0), along each of the P tangents' tau summed over the layers:
    -base sum_z dtau_q / mu0."""
    d_tau = np.stack([t.tau.sum(dim=0).double().cpu().numpy()
                      for t in tangents], axis=-1)            # (nSpec, P)
    return -np.asarray(base)[..., None] * d_tau / mu0


def rt_run_lin(model, i_band: int = 0, layout: ParameterLayout = None,
               fd_rel: float = 1e-3, device=None):
    """Forward + Jacobian run (reference rt_run(model, lin_model, ...),
    rt_run_lin.jl:102-326) on ``device`` (CUDA unless given).

    Returns numpy (R, T, dR, dT): R/T (nVZA, nStokes, nSpec), dR/dT
    (nVZA, nStokes, nSpec, Nparams). The wind-speed Jacobian includes the
    TMS glint-correction derivative.

    Over Cox-Munk every parameter's dR carries the TMS term's dependence on
    the column's optical depth (``tms_tau_term`` through its tangent's tau;
    the JAX package's tangents leave it out), the wind's also the term's
    analytic wind derivative.

    The band path (``config.fused``) runs K2 at the band's K = 1 or 2; a
    scene wider than K2 takes (N > ``ops.fused_lin.KERNEL_MAX_N``) runs
    ``rt_solve_jvp`` instead, with one warning, when ``model.params.fused``
    was left at None (an explicit True still launches, and K2 refuses).
    A layout with no parameter (e.g. a scene over RPV, Ross-Li or a canopy
    without aerosol or line-list gas) is refused before any build."""
    from ..ops import fused_lin
    dev = resolve_device(device)
    if layout is None:
        layout = default_layout(model, i_band)
    if layout.n_total == 0:
        raise ValueError(f"rt_run_lin: the Jacobian layout {layout} holds no "
                         "parameter (no aerosol, no line-list gas, no "
                         "surface parameter)")
    inputs, config, tangents = build_tangent_inputs(
        model, i_band, layout, fd_rel, dev)
    if config.fused and model.params.fused is None and not \
            kernel_takes_width("K2 (csrc/fused_lin.cu)",
                               fused_lin.KERNEL_MAX_N, config.N):
        config = dc_replace(config, fused=False)
    if config.fused:
        R, T, dR, dT = fused_lin.rt_solve_multitangent(inputs, tangents,
                                                       config, dev)
    else:
        R, T, dR, dT = rt_solve_jvp(inputs, tangents, config, dev)
    R, T = R.cpu().numpy(), T.cpu().numpy()
    dR = np.moveaxis(dR.cpu().numpy(), 0, -1)    # (nVZA, ns, nSpec, Nparams)
    dT = np.moveaxis(dT.cpu().numpy(), 0, -1)

    band = model.bands[i_band]
    if band.surface.kind == "CoxMunkSurface":
        # TMS correction, its derivative through each tangent's optical
        # depth and its analytic wind derivative (the correction is linear
        # in the Mueller grid).
        from ..surfaces.coxmunk import CoxMunkSurface, tms_correction
        surf = CoxMunkSurface(**{k: v for k, v in band.surface.kwargs.items()
                                 if not k.startswith("_")})
        tau_total = inputs.tau.sum(dim=0).cpu().numpy()
        base, d_tms = tms_correction(
            surf, config.n_stokes, model.params.vza, model.params.vaz,
            model.quad.mu0, tau_total, config.m_max, wind_tangent=True)
        R = R + base
        dR = dR + tms_tau_term(base, tangents, model.quad.mu0)
        if "wind_speed" in layout.surface_params:
            dR[..., layout.surface_index()] += d_tms
    return R, T, dR, dT
