"""Solver configuration, input container and device rule of the port.

Counterpart of ``vsmartmom_tpu/core/types.py``. The solver is a plain
function of

* ``SolverConfig`` — static facts (shapes, loop trip counts, stream
  indices, the Newton-Schulz schedule), and
* ``SolverInputs`` — torch tensors, batch-leading ``(nSpec, ...)``.

Operators are ``(nSpec, N, N)`` with ``N = Nquad * n_stokes``, source stacks
``(nSpec, N, K)``, the layout of the JAX package, so both packages can be
compared array for array.

``solver_inputs_from_numpy``, ``solver_config_from_dict`` and
``rrs_setup_from_numpy`` carry state across: they take the JAX package's
``build_band`` and ``inelastic_setup`` outputs as plain numpy arrays and a
field dict, so the two packages run on identical inputs.

``auto_kernel`` and ``kernel_takes_width`` are the automatic choice of
route (``Parameters.fused`` None): the hand-written kernels for a float32
model on CUDA, where the scene's width fits the kernel.
"""

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Without CUDA and without an explicit device this raises — the port
    never falls back to the CPU quietly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def auto_kernel(dev: torch.device, float_type) -> bool:
    """The automatic strategy: the kernel routes for a float32 model on
    CUDA, the plain routes otherwise (an f64 model stays plain, as in the
    JAX package)."""
    return dev.type == "cuda" and np.dtype(float_type) == np.float32


def kernel_takes_width(kernel: str, limit: int, N: int) -> bool:
    """Whether an automatically chosen kernel route takes a scene of N
    streams: True for N <= ``limit``; otherwise one warning that names the
    kernel, its limit and N, and the caller takes its plain route. A choice
    made from the shape before any launch, as the JAX package chooses its
    routes."""
    if N <= limit:
        return True
    warnings.warn(f"{kernel} takes N <= {limit}; this scene has N = {N}, "
                  "so it runs the plain route", stacklevel=3)
    return False


@dataclass(frozen=True)
class SolverConfig:
    """Static solver facts (the JAX package's ``SolverConfig`` minus its
    TPU-only knobs: the port always runs pack = 1 and exact-f32 products)."""

    n_stokes: int        # Stokes components (1, 2, 3, 4)
    nquad: int           # quadrature nodes (incl. zero-weight outputs)
    n_spec: int          # spectral points
    nz: int              # atmospheric layers (TOA -> BOA)
    m_max: int           # Fourier loop runs m = 0 .. m_max (inclusive)
    ndoubl: int          # uniform doubling count per layer
    i_mu0: int           # solar stream node index (0-based)
    vza_idx: tuple       # per-VZA nearest stream node index (0-based)
    dtype: Any           # solver dtype (np.float32 / np.float64)
    n_sources: int = 1   # stacked source slots (1 = solar; 2 = +thermal)
    save_streams: bool = False   # emit per-moment stream vectors
    fused: bool = False  # whole-moment band kernel (ops/fused_band.py)
    ns_sched: tuple = () # per-doubling-step Newton-Schulz iteration counts
                         # (() = worst-case default; see ops/ns_schedule.py)
    ns_inter: int = 6    # NS iterations for the interaction inverse
    m_scat: int = -1     # highest Fourier moment with atmospheric scattering
                         # (< 0: every moment runs the full layer chain)

    @property
    def N(self) -> int:
        return self.nquad * self.n_stokes

    @property
    def i_mu0_start(self) -> int:
        return self.i_mu0 * self.n_stokes

    @property
    def torch_dtype(self) -> torch.dtype:
        return {np.float32: torch.float32,
                np.float64: torch.float64}[np.dtype(self.dtype).type]


class SolverInputs(NamedTuple):
    """Tensors consumed by the solver (one band); shapes as in the JAX
    package (C scattering components, M = m_max + 1 moments):

      qp_mu_N, wt_mu_N (N,); tau (Nz, nSpec); scat_w (Nz, C, nSpec);
      Z_pp, Z_mp (M, C, N, N); F0 (n_stokes, nSpec); surf_r (M, N, N);
      surf_j_m (M, N, n_stokes); surf_spec (nSpec,); surf_direct_m (M,);
      vza_w (M, nVZA, n_stokes); thermal_b (Nz, nSpec); sif_spec (nSpec,)
    """

    qp_mu_N: torch.Tensor
    wt_mu_N: torch.Tensor
    tau: torch.Tensor
    scat_w: torch.Tensor
    Z_pp: torch.Tensor
    Z_mp: torch.Tensor
    F0: torch.Tensor
    surf_r: torch.Tensor
    surf_j_m: torch.Tensor
    surf_spec: torch.Tensor
    surf_direct_m: torch.Tensor
    vza_w: torch.Tensor
    thermal_b: torch.Tensor
    sif_spec: torch.Tensor


#: The SolverInputs fields a spectrally resolved surface makes 4-D.
SPECTRAL_SURFACE = ("surf_r", "surf_j_m")


def solver_inputs_from_numpy(fields: dict, device, dtype=torch.float64):
    """``SolverInputs`` from a dict of arrays (e.g. the fields of the JAX
    package's ``build_band`` inputs), copied to ``device`` as ``dtype``.
    F0 is taken as given: a band's ``f0_spec`` has already scaled it."""
    dev = torch.device(device)
    return SolverInputs(**{
        f: torch.as_tensor(np.asarray(fields[f]), dtype=dtype, device=dev)
        for f in SolverInputs._fields})


def solver_config_from_dict(d: dict) -> SolverConfig:
    """``SolverConfig`` from a field dict (e.g. ``dataclasses.asdict`` of the
    JAX package's config). TPU-only keys are dropped; a packed layout is
    refused because the port has none."""
    if int(d.get("pack", 1)) != 1:
        raise ValueError(f"the port runs pack = 1 only, got {d['pack']}")
    names = {f.name for f in dataclasses.fields(SolverConfig)}
    kw = {k: v for k, v in d.items() if k in names}
    kw["vza_idx"] = tuple(int(v) for v in kw["vza_idx"])
    kw["ns_sched"] = tuple(int(v) for v in kw.get("ns_sched", ()))
    kw["dtype"] = np.dtype(kw["dtype"]).type
    return SolverConfig(**kw)


def rrs_setup_from_numpy(shifts, w_shifts, Z_r_pp, Z_r_mp, fscatt, device,
                         dtype=torch.float64):
    """The Raman part of an inelastic setup (e.g. the JAX package's
    ``inelastic_setup`` outputs as numpy): (shifts as a tuple of ints,
    w_shifts, Z_r_pp / Z_r_mp (n_m, N, N), fscatt (Nz, nSpec)) with the
    arrays copied to ``device`` as ``dtype``. w_shifts is (nR,), one
    weight a shift (RRS), or (nR, nSpec), per-target weights (VS: shifts
    (0,) and one row); any other shape is refused."""
    dev = torch.device(device)
    shifts = tuple(int(v) for v in np.asarray(shifts).reshape(-1))
    w = np.asarray(w_shifts)
    n_spec = np.asarray(fscatt).shape[-1]
    if w.shape not in ((len(shifts),), (len(shifts), n_spec)):
        raise ValueError(f"w_shifts of shape {w.shape} for {len(shifts)} "
                         f"shifts and {n_spec} points: want ({len(shifts)},)"
                         f" or ({len(shifts)}, {n_spec})")
    return (shifts, *(torch.as_tensor(np.array(x), dtype=dtype, device=dev)
                      for x in (w, Z_r_pp, Z_r_mp, fscatt)))


def mu0_value(inputs: SolverInputs, config: SolverConfig):
    """Solar cosine as stored on the stream vector (exact node value)."""
    return inputs.qp_mu_N[config.i_mu0_start]


def stokes_d_vector(n_stokes: int, nquad: int, dtype=np.float64) -> np.ndarray:
    """The D-matrix diagonal tiled over streams (types.jl D = [1,1,-1,-1])."""
    d = np.ones(n_stokes)
    if n_stokes >= 3:
        d[2:] = -1.0
    return np.tile(d, nquad).astype(dtype)
