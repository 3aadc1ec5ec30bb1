"""Line-by-line absorption cross sections, the line sum on a torch device.

Counterpart of the JAX package's ``absorption/cross_section.py``. Line
pre-processing (pressure shift, Lorentz and Doppler widths, the TIPS
intensity correction) runs on the host in float64 NumPy, for every layer
at once; the per-line mass and partition-sum lookups are table gathers
(``hitran.mol_weights``, ``hitran.qoft_ratios``) with the same numbers.
The line sum runs in float64 (complex128 line shapes) on ``device``:

* on a uniform grid whose per-line window W is narrower than half the
  grid, each line's profile on the W grid points of [nu - cutoff,
  nu + cutoff], scatter-added into the spectrum with ``index_add_``
  (O(lines x W); the JAX package's windowed ``lax.scan``);
* otherwise each line against the whole grid, wing-cutoff masked and
  summed (the JAX package's dense masked scan).

Both take every layer of a profile in one call and chunk the lines so that
one chunk's (layers, lines, W) block holds at most ``WORK_ELEMS`` points.
The JAX package pads the lines to its 256-line chunk with zero-strength
lines at grid[0]; they add exact zeros, so the port does not pad. Only the
order of the sums differs (and, on CUDA, the scatter's atomics reorder
them): the two packages agree to rounding.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.types import resolve_device
from .hitran import HitranTable, mol_weights, qoft_ratios
from .voigt import CEFS

C2 = 1.4387769               # second radiation constant [cm K]
P_REF = 1013.25              # [hPa]
T_REF = 296.0                # [K]
MASS_MOL = 1.66053873e-27    # [kg per unit molar mass molecule]
C_LIGHT = 2.99792458e8       # [m/s]
K_BOLTZ = 1.3806503e-23      # [J/K]
SQRT_LN2 = float(np.sqrt(np.log(2.0)))
SQRT2_LN2 = float(np.sqrt(2.0 * np.log(2.0)))
SQRT_LN2_PI = float(np.sqrt(np.log(2.0) / np.pi))

#: Grid points of one chunk's (layers, lines, W or nGrid) block: 128 MiB
#: of complex128 a temporary.
WORK_ELEMS = 1 << 23


@dataclass
class HitranModel:
    """Reference Absorption/types.jl:168-189."""
    hitran: HitranTable
    broadening: str = "Voigt"            # Voigt | Lorentz | Doppler
    wing_cutoff: float = 40.0            # [cm^-1]
    cef: str = "HumlicekWeidemann32SDErrorFunction"
    vmr: float = 0.0                     # self-broadening VMR


def preprocess_layers(model: HitranModel, grid, pressure, temperature):
    """Active-line parameters at each (p, T) of two (L,) arrays
    (compute_absorption_cross_section.jl:77-154): (nu, gamma_d, gamma_l,
    y, S), each (L, n_active) float64, the JAX package's arithmetic
    broadcast over layers."""
    h = model.hitran
    grid = np.asarray(grid)
    p = np.atleast_1d(np.asarray(pressure, dtype=np.float64))[:, None]
    T = np.atleast_1d(np.asarray(temperature, dtype=np.float64))[:, None]
    lo, hi = grid.min() - model.wing_cutoff, grid.max() + model.wing_cutoff
    active = (h.nu > lo) & (h.nu < hi)
    if not active.any():
        return tuple(np.zeros((len(p), 0)) for _ in range(5))

    nu0 = h.nu[active]
    nu = nu0 + p / P_REF * h.delta_air[active]
    gamma_l = ((h.gamma_air[active] * (1 - model.vmr) * p / P_REF
                + h.gamma_self[active] * model.vmr * p / P_REF)
               * (T_REF / T) ** h.n_air[active])
    masses = mol_weights(h.mol[active], h.iso[active])
    gamma_d = (SQRT2_LN2 / C_LIGHT * np.sqrt(K_BOLTZ / MASS_MOL)
               * np.sqrt(T) * nu0 / np.sqrt(masses))
    y = SQRT_LN2 * gamma_l / gamma_d

    S = np.broadcast_to(h.sw[active], gamma_l.shape).copy()
    e_low = h.e_lower[active]
    has_e = e_low != -1
    if has_e.any():
        q_ratio = qoft_ratios(h.mol[active], h.iso[active], T[:, 0], T_REF)
        corr = (q_ratio * np.exp(C2 * e_low * (1 / T_REF - 1 / T))
                * (-np.expm1(-C2 * nu0 / T))
                / (-np.expm1(-C2 * nu0 / T_REF)))
        S = np.where(has_e, S * corr, S)
    return nu, gamma_d, gamma_l, y, S


def _profile(dx, gd, gl, y, S, broadening, cef_fn):
    """Line-shape values S * phi(dx) of a block of lines (the JAX
    package's ``_profile``)."""
    if broadening == "Voigt":
        z = SQRT_LN2 / gd * dx + 1j * y
        return S * SQRT_LN2_PI / gd * cef_fn(z).real
    if broadening == "Lorentz":
        return S * gl / (np.pi * (gl ** 2 + dx ** 2))
    return S * SQRT_LN2_PI / gd * torch.exp(-np.log(2.0) * (dx / gd) ** 2)


def _line_chunk(n_layers: int, width: int) -> int:
    return max(1, WORK_ELEMS // max(1, n_layers * width))


def line_sum_dense(grid, lines, wing_cutoff, broadening, cef):
    """(L, nGrid) sigma: every line against the whole ``grid`` tensor,
    masked beyond ``wing_cutoff`` and summed; ``lines`` the five (L, n)
    float64 tensors of ``preprocess_layers`` on the grid's device."""
    L, n = lines[0].shape
    acc = torch.zeros((L, grid.shape[0]), dtype=torch.float64,
                      device=grid.device)
    step = _line_chunk(L, grid.shape[0])
    for a in range(0, n, step):
        nu, gd, gl, y, S = (x[:, a:a + step, None] for x in lines)
        dx = grid - nu                                  # (L, c, nGrid)
        prof = _profile(dx, gd, gl, y, S, broadening, CEFS[cef])
        acc += torch.where(dx.abs() <= wing_cutoff, prof, 0.0).sum(dim=1)
    return acc


def line_sum_windowed(grid0, dnu, n_grid, lines, wing_cutoff, broadening,
                      cef, W):
    """(L, n_grid) sigma on the uniform grid grid0 + k dnu: each line's
    profile on the W points from floor((nu - cutoff - grid0) / dnu), masked
    off the grid and beyond ``wing_cutoff``, scatter-added with
    ``index_add_``."""
    L, n = lines[0].shape
    dev = lines[0].device
    acc = torch.zeros(L * n_grid, dtype=torch.float64, device=dev)
    offs = torch.arange(W, device=dev)
    base = (torch.arange(L, device=dev) * n_grid)[:, None, None]
    step = _line_chunk(L, W)
    for a in range(0, n, step):
        nu, gd, gl, y, S = (x[:, a:a + step, None] for x in lines)
        start = torch.floor((nu - wing_cutoff - grid0) / dnu).long()
        idx = start + offs                              # (L, c, W)
        in_grid = (idx >= 0) & (idx < n_grid)
        idx_c = idx.clamp(0, n_grid - 1)
        dx = grid0 + idx_c.double() * dnu - nu
        prof = _profile(dx, gd, gl, y, S, broadening, CEFS[cef])
        prof = torch.where(in_grid & (dx.abs() <= wing_cutoff), prof, 0.0)
        acc.index_add_(0, (base + idx_c).reshape(-1), prof.reshape(-1))
    return acc.reshape(L, n_grid)


def _uniform_spacing(grid) -> Optional[float]:
    """Grid spacing if uniform (to 1e-9 relative), else None."""
    if len(grid) < 2:
        return None
    d = np.diff(grid)
    d0 = d[0]
    if d0 <= 0 or np.abs(d - d0).max() > 1e-9 * abs(d0) + 1e-12:
        return None
    return float(d0)


def cross_sections(model: HitranModel, grid, pressure, temperature,
                   force_dense: bool = False, device=None) -> torch.Tensor:
    """(L, nGrid) float64 tensor on ``device`` (CUDA unless given) of the
    cross sections [cm^2/molecule] on ``grid`` [cm^-1] at each (p [hPa],
    T [K]) of two (L,) arrays, by the JAX package's path choice: the
    windowed sum on a uniform grid (to 1e-9) whose window W =
    ceil(2 cutoff / dnu) + 2 is under half the grid, the dense one
    otherwise."""
    dev = resolve_device(device)
    grid = np.asarray(grid, dtype=np.float64)
    lines = preprocess_layers(model, grid, pressure, temperature)
    L, n = lines[0].shape
    if n == 0:
        return torch.zeros((L, len(grid)), dtype=torch.float64, device=dev)
    lines = tuple(torch.as_tensor(x, dtype=torch.float64, device=dev)
                  for x in lines)
    dnu = _uniform_spacing(grid)
    if dnu is not None and not force_dense:
        W = int(np.ceil(2.0 * model.wing_cutoff / dnu)) + 2
        if W < len(grid) // 2:
            return line_sum_windowed(float(grid[0]), dnu, len(grid), lines,
                                     model.wing_cutoff, model.broadening,
                                     model.cef, W)
    return line_sum_dense(torch.as_tensor(grid, device=dev), lines,
                          model.wing_cutoff, model.broadening, model.cef)


def compute_absorption_cross_section(model: HitranModel, grid, pressure,
                                     temperature, force_dense: bool = False,
                                     device=None) -> np.ndarray:
    """Cross section [cm^2/molecule] on ``grid`` [cm^-1] at (p [hPa], T [K])
    as a numpy array, the line sum on ``device`` (CUDA unless given)."""
    return cross_sections(model, grid, [pressure], [temperature],
                          force_dense, device)[0].cpu().numpy()


def absorption_profile(model: HitranModel, grid, vmr, profile,
                       device=None) -> torch.Tensor:
    """tau_abs (nSpec, Nz) float64 on ``device``: sigma(p, T) * vcd_dry *
    vmr per layer (atmo_prof.jl:464-486), every layer in one line sum."""
    nz = profile.nz
    vmr_arr = np.broadcast_to(np.asarray(vmr, dtype=np.float64), (nz,)) \
        if np.ndim(vmr) > 0 else np.full(nz, float(vmr))
    sigma = cross_sections(model, grid, profile.p_full[:nz],
                           profile.T[:nz], device=device)
    col = torch.as_tensor(np.asarray(profile.vcd_dry[:nz], dtype=np.float64),
                          device=sigma.device)[:, None]
    vmr_t = torch.as_tensor(vmr_arr, device=sigma.device)[:, None]
    return (sigma * col * vmr_t).T


def compute_absorption_profile(model: HitranModel, grid, vmr, profile,
                               device=None) -> np.ndarray:
    """``absorption_profile`` as a numpy array."""
    return absorption_profile(model, grid, vmr, profile,
                              device).cpu().numpy()


@dataclass
class InterpolationModel:
    """Precomputed sigma LUT over (nu, p, T).

    Interpolation order matches the reference's scaled cubic BSpline
    (compute_absorption_cross_section.jl:198-231) when every axis has
    >= 4 samples; smaller axes fall back to linear per axis. Points
    outside the nu table clamp to zero, p/T clamp to the table edge —
    the reference's extrapolation behavior. Host scipy.
    """
    sigma: np.ndarray            # (n_nu, n_p, n_t)
    nu_grid: np.ndarray
    p_grid: np.ndarray
    t_grid: np.ndarray
    order: str = "cubic"         # "cubic" (reference default) or "linear"

    def _method(self):
        if self.order == "linear":
            return "linear"
        n = (len(self.nu_grid), len(self.p_grid), len(self.t_grid))
        return "cubic" if min(n) >= 4 else "linear"

    def interpolate(self, grid, pressure, temperature):
        from scipy.interpolate import RegularGridInterpolator
        # Normalize: scipy's cubic prefilter flushes data at cross-section
        # magnitudes (~1e-23 cm^2) to zero.
        scale = self.sigma.max() or 1.0
        itp = RegularGridInterpolator(
            (self.nu_grid, self.p_grid, self.t_grid), self.sigma / scale,
            method=self._method(), bounds_error=False, fill_value=None)
        grid = np.asarray(grid, dtype=np.float64)
        pts = np.stack([
            np.clip(grid, self.nu_grid[0], self.nu_grid[-1]),
            np.full_like(grid, np.clip(pressure, self.p_grid[0],
                                       self.p_grid[-1])),
            np.full_like(grid, np.clip(temperature, self.t_grid[0],
                                       self.t_grid[-1]))], axis=-1)
        out = itp(pts) * scale
        out[(grid < self.nu_grid[0]) | (grid > self.nu_grid[-1])] = 0.0
        return np.clip(out, 0.0, None)    # cubic overshoot guard

    def save(self, path: str) -> None:
        """Persist the LUT as a compressed .npz (reference JLD2 save,
        make_model_helpers.jl:113-119)."""
        np.savez_compressed(path, sigma=self.sigma, nu_grid=self.nu_grid,
                            p_grid=self.p_grid, t_grid=self.t_grid,
                            order=np.array(self.order))

    @classmethod
    def load(cls, path: str) -> "InterpolationModel":
        with np.load(path, allow_pickle=False) as d:
            return interpolation_model_from_numpy(d)


def interpolation_model_from_numpy(fields) -> InterpolationModel:
    """``InterpolationModel`` from a dict of its arrays (``sigma``,
    ``nu_grid``, ``p_grid``, ``t_grid``, ``order``) or any object with
    them as attributes (e.g. the JAX package's LUT), copied."""
    get = fields.__getitem__ if hasattr(fields, "__getitem__") else \
        (lambda k: getattr(fields, k))
    return InterpolationModel(
        **{k: np.array(get(k), dtype=np.float64)
           for k in ("sigma", "nu_grid", "p_grid", "t_grid")},
        order=str(get("order")))


def make_interpolation_model(model: HitranModel, nu_grid, p_grid, t_grid,
                             order: str = "cubic",
                             device=None) -> InterpolationModel:
    """Precompute the sigma LUT (make_model_helpers.jl:25-119): every
    (p, T) node of the table in one line sum on ``device``."""
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    p_grid = np.asarray(p_grid, dtype=np.float64)
    t_grid = np.asarray(t_grid, dtype=np.float64)
    P, T = np.meshgrid(p_grid, t_grid, indexing="ij")
    sigma = cross_sections(model, nu_grid, P.ravel(), T.ravel(),
                           device=device).cpu().numpy()
    return InterpolationModel(
        sigma=np.moveaxis(sigma.reshape(len(p_grid), len(t_grid), -1), -1, 0),
        nu_grid=nu_grid, p_grid=p_grid, t_grid=t_grid, order=order)
