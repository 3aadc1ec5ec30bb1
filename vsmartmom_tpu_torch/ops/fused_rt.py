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
"""

import torch

#: Newton-Schulz iterations when no scene schedule is given:
#: error rho^(2^(k+1)); k = 6 reaches rho^128.
NS_ITERS = 6


def norm_sched(ns_sched, ndoubl):
    """Per-doubling-step NS schedule as a tuple of length ndoubl
    (None/() -> NS_ITERS everywhere)."""
    if ns_sched is None or ns_sched == ():
        return (NS_ITERS,) * ndoubl
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
