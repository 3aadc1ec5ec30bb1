"""Truncated-MOM single-scatter solve (reference rt_run_ss, rt_run.jl:
574-755, CoreKernel/rt_kernel_ss.jl and interaction_ss.jl).

Counterpart of ``vsmartmom_tpu/core/singlescatter.py``. The exact
finite-dtau elemental operators (Fell 1997) taken at the FULL layer optical
depth are the exact single-scatter layer operators, with no doubling
ladder, and the composite carry reduces to the two source vectors with
Beer-law path attenuation (interaction_ss.jl:14-18):

    J0+ <- J0+ * exp(-tau_layer / mu_i) + j0+          (downwelling)
    J0- <- J0- + j0- * exp(-tau_above / mu_i)          (upwelling)

The surface adds its sources with ``tau_surf = 0``; the m = 0
hemispherical integrals hem_R / hem_T are the weighted sums over the
streams (rt_run.jl:737-748). The layer and moment loops are plain torch on
the device: the JAX package has no kernel here, and neither has the port.
Every Fourier moment runs (the JAX package's solve has no ``m_scat``
split either), and any surface the model builds is taken, a spectrally
resolved canopy's too.
"""

import torch

from .kernels import _exp, elemental
from .solver import _surface_layer
from .types import SolverConfig, SolverInputs, resolve_device


def rt_solve_ss(inputs: SolverInputs, config: SolverConfig, device=None):
    """Single-scatter-only solve on ``device``. Returns a dict of tensors:
    R, T (nVZA, n_stokes, nSpec) and hem_R, hem_T (nSpec,)."""
    dev = resolve_device(device)
    dtype = config.torch_dtype
    n_spec, N, nz = config.n_spec, config.N, config.nz
    ns = config.n_stokes
    inp = SolverInputs(*(torch.as_tensor(x).to(dtype=dtype).to(device=dev)
                         for x in inputs))
    qp_mu_N, wt_mu_N = inp.qp_mu_N, inp.wt_mu_N
    mu0 = qp_mu_N[config.i_mu0_start]
    tau, scat_w, F0 = inp.tau, inp.scat_w, inp.F0
    tau_sum = torch.cat([torch.zeros((1, n_spec), dtype=dtype, device=dev),
                         torch.cumsum(tau, dim=0)], dim=0)
    safe_tau = torch.where(tau > 0, tau, torch.ones_like(tau))
    vza_rows = torch.as_tensor(
        [[v * ns + k for k in range(ns)] for v in config.vza_idx],
        device=dev)
    wq_I = wt_mu_N * qp_mu_N * ((torch.arange(N, device=dev) % ns) == 0)
    att_boa = _exp(-tau_sum[nz][:, None] / qp_mu_N[None, :])

    R = torch.zeros((len(config.vza_idx), ns, n_spec), dtype=dtype,
                    device=dev)
    T = torch.zeros_like(R)
    hem_R = torch.zeros((n_spec,), dtype=dtype, device=dev)
    hem_T = torch.zeros_like(hem_R)
    for m in range(config.m_max + 1):
        fw, is_m0 = (0.5 if m == 0 else 0.25), m == 0
        J0_p = torch.zeros((n_spec, N), dtype=dtype, device=dev)
        J0_m = torch.zeros_like(J0_p)
        for z in range(nz):
            wZ_pp = torch.einsum("cs,cij->sij", scat_w[z], inp.Z_pp[m]) \
                / safe_tau[z][:, None, None]
            wZ_mp = torch.einsum("cs,cij->sij", scat_w[z], inp.Z_mp[m]) \
                / safe_tau[z][:, None, None]
            # The exact single-scatter layer: the elemental at the FULL
            # layer tau (no doubling).
            _, _, j0_p, j0_m = elemental(
                wZ_pp, wZ_mp, tau[z], tau_sum[z], qp_mu_N, wt_mu_N, mu0,
                config.i_mu0_start, ns, F0, fw)
            J0_p = J0_p * _exp(-tau[z][:, None] / qp_mu_N[None, :]) + j0_p
            J0_m = J0_m + j0_m * _exp(-tau_sum[z][:, None]
                                      / qp_mu_N[None, :])
        # Surface: its j vectors only, the upwelling one attenuated through
        # the whole column (interaction_ss with tau_surf = 0).
        surf = _surface_layer(inp.surf_r[m], inp.surf_j_m[m],
                              inp.surf_direct_m[m], inp.surf_spec, F0,
                              tau_sum[nz], mu0, inp.sif_spec, is_m0, config)
        J0_p = J0_p + surf.j0_p.sum(dim=-1)
        J0_m = J0_m + surf.j0_m.sum(dim=-1) * att_boa
        R = R + J0_m[:, vza_rows].permute(1, 2, 0) * inp.vza_w[m][:, :, None]
        T = T + J0_p[:, vza_rows].permute(1, 2, 0) * inp.vza_w[m][:, :, None]
        if is_m0:
            # m = 0 hemispherical integrals over the weighted streams (the
            # raw sum: the (0.5/pi) x 2 pi weights cancel).
            hem_R = hem_R + (J0_m * wq_I[None, :]).sum(dim=1)
            hem_T = hem_T + (J0_p * wq_I[None, :]).sum(dim=1)
    return {"R": R, "T": T, "hem_R": hem_R, "hem_T": hem_T}


def rt_run_ss(model, i_band: int = 0, device=None):
    """User-facing single-scatter run (reference rt_run_ss, rt_run.jl:574):
    a dict of numpy arrays R, T (nVZA, n_stokes, nSpec) and the m = 0
    hemispherical integrals hem_R, hem_T (nSpec,). Runs on CUDA unless
    ``device`` is given."""
    dev = resolve_device(device)
    inputs, config = model.build_band(i_band, device=dev)
    out = rt_solve_ss(inputs, config, dev)
    return {k: v.cpu().numpy() for k, v in out.items()}

