"""The plain adding-doubling core: elemental -> doubling -> interaction.

Counterpart of ``vsmartmom_tpu/core/kernels.py`` (the JAX package's XLA
path, which runs outside any Pallas kernel), on batch-leading
``(nSpec, N, N)`` tensors with batched ``@`` products (exact f32 on CUDA
while TF32 stays off, PyTorch's default) and ``torch.linalg.solve`` for
the geometric-series factors. The JAX package's
Newton-Schulz solve existed only because LU was slow on the TPU.

The D-matrix polarization symmetry (Sanghavi 2014 Eqs. 29-32) is applied as
elementwise +-1 row/column scalings; ``1 - exp(-x)`` is ``-expm1(-x)`` and
the elemental transmission uses the cancellation-free expm1 form, split as
the kernels split it (``_e_expm1``) so that no layer overflows.
"""

from typing import NamedTuple

import torch


class AddedLayer(NamedTuple):
    """Homogeneous-layer operators (lowercase r/t/j of the reference).

    Source stacks carry a trailing source axis K: slot 0 is the solar beam,
    slot 1 (when present) the thermal volume source."""
    r_mp: torch.Tensor   # r-+  (nSpec, N, N)
    r_pm: torch.Tensor   # r+-
    t_pp: torch.Tensor   # t++
    t_mm: torch.Tensor   # t--
    j0_p: torch.Tensor   # j0+  (nSpec, N, K)
    j0_m: torch.Tensor   # j0-


class CompositeLayer(NamedTuple):
    """Accumulated column operators (uppercase R/T/J of the reference)."""
    R_mp: torch.Tensor
    R_pm: torch.Tensor
    T_pp: torch.Tensor
    T_mm: torch.Tensor
    J0_p: torch.Tensor   # (nSpec, N, K)
    J0_m: torch.Tensor


def identity_composite(n_spec: int, N: int, dtype, device,
                       n_sources: int = 1) -> CompositeLayer:
    """Vacuum composite (R = 0, T = I, J = 0): interacting it with the first
    layer reproduces the reference's TOA copy step (rt_kernel.jl:243-245)."""
    eye = torch.eye(N, dtype=dtype, device=device).expand(n_spec, N, N)
    zero_m = torch.zeros((n_spec, N, N), dtype=dtype, device=device)
    zero_v = torch.zeros((n_spec, N, n_sources), dtype=dtype, device=device)
    return CompositeLayer(zero_m, zero_m, eye, eye, zero_v, zero_v)


def _exp(x):
    """exp evaluated in f64 and cast back to x.dtype: the doubling ladder
    amplifies a transcendental's error ~2^ndoubl, so the O(s N) precursors
    are computed at full accuracy whatever the working dtype."""
    return torch.exp(x.to(torch.float64)).to(x.dtype)


def _expm1(x):
    """expm1 evaluated in f64 (see _exp)."""
    return torch.expm1(x.to(torch.float64)).to(x.dtype)


#: |x| below which ``_e_expm1`` takes E expm1(x) directly, above which the
#: difference of the two exponentials (``csrc/fused_band.cu``,
#: ``fused_lin.cu`` and ``fused_rrs.cu`` split at the same 0.3).
EXPM1_SPLIT = 0.3


def _e_expm1(x, E, diff):
    """E expm1(x), where E e^x is a second exponential and ``diff`` is that
    exponential less E (a difference of two exponentials): E expm1(x)
    below |x| = EXPM1_SPLIT, ``diff`` above it, where expm1(x) would
    overflow in an optically thick layer while E underflows. The branch not
    taken sees a clamped argument (the double ``where``), so forward-mode
    AD and vmap never meet inf * 0."""
    small = x.abs() < EXPM1_SPLIT
    xs = torch.where(small, x, torch.zeros_like(x))
    return torch.where(small, torch.expm1(xs) * E, diff)


def elemental(omega_Z_pp, omega_Z_mp, dtau, tau_sum, qp_mu_N, wt_mu_N,
              mu0, i_mu0_start, n_stokes, F0, fourier_w):
    """Exact finite-dtau single-scatter operators for one thin slab (Fell
    1997 Eqs. 1.52-1.56; elemental.jl:289-392).

    omega_Z_pp/mp: (nSpec, N, N) premixed ``pi * Z``; dtau, tau_sum (nSpec,);
    qp_mu_N/wt_mu_N (N,); mu0 scalar tensor; F0 (n_stokes, nSpec);
    fourier_w scalar (0.5 for m = 0 else 0.25). Returns (r_mp, t_pp, j0_p,
    j0_m) with sources (nSpec, N).
    """
    dtype = omega_Z_pp.dtype
    mu_i = qp_mu_N[:, None]
    mu_j = qp_mu_N[None, :]
    wct = fourier_w * wt_mu_N[None, :]

    Em1 = _expm1(-dtau[:, None] / qp_mu_N[None, :])        # (s, N)
    # E itself, not 1 + Em1: in a thick layer E is small and 1 + Em1 would
    # keep only its absolute accuracy.
    E = _exp(-dtau[:, None] / qp_mu_N[None, :])
    d = dtau[:, None, None]

    # r-+ = wZ-+ (mu_j/(mu_i+mu_j)) w_j (1 - E_i E_j); 1 - E_i E_j summed
    # from same-sign terms.
    r_geom = (mu_j / (mu_i + mu_j)) * wct
    one_m_EE = -(Em1[:, :, None] + Em1[:, None, :]
                 + Em1[:, :, None] * Em1[:, None, :])
    r_mp = omega_Z_mp * r_geom[None] * one_m_EE

    # t++ off-diagonal = (mu_j/delta) E_j expm1(x) w_j with x = d delta /
    # (mu_i mu_j) = d (1/mu_j - 1/mu_i): the expm1 argument is proportional
    # to delta, so no cancellation; above |x| = EXPM1_SPLIT the identity
    # E_j expm1(x) = E_i - E_j (the kernels' split: no overflow in thick
    # layers).
    same_mu = torch.abs(mu_i - mu_j) <= 1e-9 * torch.maximum(mu_i, mu_j)
    delta = torch.where(same_mu, torch.ones_like(mu_i - mu_j), mu_i - mu_j)
    x = d * (delta / (mu_i * mu_j))[None]
    t_off = omega_Z_pp * (mu_j * wct)[None] * _e_expm1(
        x, E[:, None, :], E[:, :, None] - E[:, None, :]) / delta[None]
    t_same = E[:, None, :] * omega_Z_pp * (d / mu_i) * wct[None]
    eye = torch.eye(omega_Z_pp.shape[-1], dtype=dtype,
                    device=omega_Z_pp.device)
    beer = E[:, :, None] * eye[None]
    t_pp = torch.where(same_mu[None], t_same + beer, t_off)

    # Solar source vectors (get_elem_rt_SFI!, elemental.jl:348-392).
    sl = slice(i_mu0_start, i_mu0_start + n_stokes)
    Zp_I0 = torch.einsum("sik,ks->si", omega_Z_pp[:, :, sl], F0)
    Zm_I0 = torch.einsum("sik,ks->si", omega_Z_mp[:, :, sl], F0)

    dt = dtau[:, None]
    mu_v = qp_mu_N[None, :]
    Em1_0 = _expm1(-dtau / mu0)
    E_0 = _exp(-dtau / mu0)[:, None]
    idx = torch.arange(qp_mu_N.shape[0], device=qp_mu_N.device)
    in_block = ((idx >= i_mu0_start) & (idx < i_mu0_start + n_stokes)) | \
        (torch.abs(qp_mu_N - mu0) <= 1e-9 * mu0)
    jp_in = fourier_w * Zp_I0 * (dt / mu_v) * E
    delta_s = torch.where(in_block, torch.ones_like(qp_mu_N),
                          qp_mu_N - mu0)[None, :]
    # E_0 expm1(dt (1/mu0 - 1/mu_v)) = E_v - E_0 above the split.
    jp_out = fourier_w * Zp_I0 * (mu0 / delta_s) * _e_expm1(
        dt * delta_s / (mu_v * mu0), E_0, E - E_0)
    j0_p = torch.where(in_block[None, :], jp_in, jp_out)
    one_m_EE0 = -(Em1 + Em1_0[:, None] + Em1 * Em1_0[:, None])
    j0_m = fourier_w * Zm_I0 * (mu0 / (mu_v + mu0)) * one_m_EE0

    att = _exp(-tau_sum / mu0)[:, None]           # beam attenuation above
    return r_mp, t_pp, j0_p * att, j0_m * att


def doubling(r_mp, t_pp, j0_p, j0_m, expk, ndoubl: int, d_vec):
    """Double the elemental slab ``ndoubl`` times (doubling.jl:38-99) on
    the starred reflection r* = D r and source D j0-, then unstar and rebuild
    the reverse operators by parity (Eqs. 29-30).

    j0_p/j0_m (nSpec, N, K); expk (nSpec, K) per-source beam attenuation,
    squared every step; d_vec (N,) +-1 D diagonal."""
    N = r_mp.shape[-1]
    sgn = d_vec[:, None] * d_vec[None, :]
    if ndoubl == 0:
        return AddedLayer(r_mp, sgn * r_mp, t_pp, sgn * t_pp, j0_p, j0_m)
    eye = torch.eye(N, dtype=r_mp.dtype, device=r_mp.device)
    ek = expk[:, None, :]
    r = r_mp * d_vec[None, :, None]
    jm = j0_m * d_vec[None, :, None]
    jp, t = j0_p, t_pp
    for _ in range(ndoubl):
        # tt_gp = t (I - r r)^-1   [solve form, rt_helpers.jl:102-107]
        gp = torch.linalg.solve(eye - r @ r, eye.expand_as(r))
        tt_gp = t @ gp
        # Source cascade (rt_helpers.jl:130-136)
        j1p = jp * ek
        j1m = jm * ek
        jm_new = jm + tt_gp @ (j1m + r @ jp)
        jp_new = j1p + tt_gp @ (jp + r @ j1m)
        # R/T update (rt_helpers.jl:161-166)
        r = r + tt_gp @ (r @ t)
        t = tt_gp @ t
        jp, jm, ek = jp_new, jm_new, ek * ek
    r_mp_out = r * d_vec[None, :, None]
    return AddedLayer(r_mp_out, sgn * r_mp_out, t, sgn * t, jp,
                      jm * d_vec[None, :, None])


def interaction(comp: CompositeLayer, add: AddedLayer) -> CompositeLayer:
    """Adding step: glue the accumulated column (above) to a new layer
    (below); Sanghavi et al. 2014 Eqs. 23-28, interaction.jl:207-266."""
    N = comp.T_pp.shape[-1]
    eye = torch.eye(N, dtype=comp.T_pp.dtype, device=comp.T_pp.device)
    eye_b = eye.expand_as(comp.T_pp)

    # T01_inv = T-- (I - r-+ R+-)^-1
    inv1 = torch.linalg.solve(eye - add.r_mp @ comp.R_pm, eye_b)
    T01_inv = comp.T_mm @ inv1
    J0_m = comp.J0_m + T01_inv @ (add.r_mp @ comp.J0_p + add.j0_m)
    R_mp = comp.R_mp + T01_inv @ (add.r_mp @ comp.T_pp)
    T_mm = T01_inv @ add.t_mm

    # T21_inv = t++ (I - R+- r-+)^-1
    inv2 = torch.linalg.solve(eye - comp.R_pm @ add.r_mp, eye_b)
    T21_inv = add.t_pp @ inv2
    J0_p = add.j0_p + T21_inv @ (comp.J0_p + comp.R_pm @ add.j0_m)
    T_pp = T21_inv @ comp.T_pp
    R_pm = add.r_pm + T21_inv @ (comp.R_pm @ add.t_mm)
    return CompositeLayer(R_mp, R_pm, T_pp, T_mm, J0_p, J0_m)
