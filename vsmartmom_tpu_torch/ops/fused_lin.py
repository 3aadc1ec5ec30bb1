"""Multitangent band path for Jacobian runs: one Fourier moment's composite
plus the forward-mode tangents of that composite for P parameters.

Counterpart of ``vsmartmom_tpu/ops/fused_lin.py`` (K = 1, solar) and of
the tangent kernel K1' that Pallas's JVP rule builds from
``vsmartmom_tpu/ops/fused_band.py::fused_moment`` for thermal scenes
(K = 2, solar + Planck; ``vsmartmom_tpu/core/linearization.py`` dispatches
it once per parameter). The JAX package gets both tangent kernels from AD
of the forward body traced inside the Pallas kernel; here the tangent
algebra is written out by hand in ``csrc/fused_lin.cu`` (kernel K2, one
cluster launch per moment for all P parameters and K <= 2 source columns:
at N <= 52 each cluster of up to 4 blocks computes one spectral point's
primal once and one tangent per block; at 53 <= N <= 128 each cluster of
2, 4 or 8 blocks computes one point's primal and one tangent, every
operator cut by rows across it (``csrc/cluster_band.cuh``); laid out by
``mt_plan``) and its plain version is
forward-mode AD
(``torch.func.jvp``) of ``fused_band.moment_body_reference`` on the same
operands, so the two can never describe different derivatives:

* ``multitangent_args`` builds one moment's ``BandOperands`` from the
  differentiable inputs (Z, tau, scat_w, F0) through the band path's own
  prep (``core.solver.moment_args``, ``fused_band.band_operands``) and
  pushes P input tangents through it with ``torch.func.jvp``
  (``operand_tangents``; the JAX package's ``jax.linearize`` of
  ``band_operands``);
* ``moment_multitangent_reference`` is the plain K2: the primal composite
  and P tangent composites;
* ``fused_moment_multitangent`` launches K2 on CUDA tensors (counted in
  ``fused_moment_multitangent.launches``) and runs the plain version on CPU
  tensors;
* ``rt_solve_multitangent`` is the Jacobian solve around it: the moment
  loop (one launch per moment up to ``m_scat`` for all P tangents, the
  Beer-law shortcut above it) and the surface tail with its tangent.

The thermal source ``thermal_b`` carries no tangent (the layout has no
temperature parameter, as in the JAX package): the thermal column's
tangent comes through tau and scat_w by way of ``moment_args``'s
``th_base`` and ``band_operands``' ``j_th``.

Kept from the TPU kernel: one primal for all P tangents (the JAX kernel
replays its tangents against one ``jax.linearize``; here a cluster shares
the primal's products). Left behind: the tangent chunks (padded to equal
size for one Mosaic compile per shape), the in-kernel dot-mode switch and
the one-dispatch-per-parameter loop of the thermal route; K2 runs
exact-f32 products, K <= 2.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core.kernels import CompositeLayer, interaction
from ..core.linearization import jvp_over, live_fields, refuse_empty
from ..core.solver import _surface_layer, beer_moment, moment_args
from ..core.types import SolverConfig, SolverInputs, resolve_device
from .fused_band import (CLUSTER_THREADS, BandOperands, band_operands,
                         band_rows, cluster_size, cluster_smem_bytes,
                         moment_body_reference)
from .fused_rt import norm_sched

#: Largest stream count N and source count K the CUDA kernel takes.
KERNEL_MAX_N = 128
#: Widest N of the narrow plan: each block of a cluster holds a copy of the
#: primal chain and its own tangent chain, twenty N x N f32 operators and
#: fourteen (N, K) vectors in shared memory (222,768 B at N = 52, K = 2,
#: inside the 232,448 B a block may opt in to). Wider scenes take the wide
#: plan, their chains cut by rows across a cluster.
NARROW_MAX_N = 52
KERNEL_MAX_K = 2
KERNEL_MAX_DOUBL = 32
#: Blocks of one cluster at most: ``VSM_CLUSTER`` of csrc/fused_lin.cu,
#: fixed when it is built (on an H100 clusters of 2, 4 and 8 read within 2%
#: of each other; PERF.md).
KERNEL_CLUSTER = 4
KERNEL_THREADS = 384
#: Shared memory one block may opt in to on an H100 (bytes).
SMEM_OPT_IN = 232448


def smem_bytes(N: int, K: int) -> int:
    """A block's dynamic shared memory: twenty N x N operators with rows
    padded to a float4, fourteen (N, K) vectors padded to a float4 and
    three rows (csrc/fused_lin.cu, smem_floats)."""
    LD = -(-N // 4) * 4
    VS = -(-(N * K) // 4) * 4
    return 4 * (20 * N * LD + 14 * VS + 3 * LD)


def _slabs(total: int, parts: int):
    """[r total // parts for r in 0..parts]: the bounds of rank r's slab."""
    return [r * total // parts for r in range(parts + 1)]


def mt_plan(N: int, K: int, P: int) -> dict:
    """The launch plan of K2 for width N, K source columns and P tangents.
    At N <= ``NARROW_MAX_N`` (``wide`` False):

    * ``groups`` = ceil(P / KERNEL_CLUSTER) clusters per spectral point,
      each of ``cluster`` = ceil(P / groups) blocks; the kernel gives block
      rank r of group g tangent g * cluster + r (a rank past P repeats
      tangent P - 1 and writes nothing of it);
    * every N x N product is cut into ``tiles`` 4 x 8 tiles; rank r
      computes tiles ``tile_slab[r]:tile_slab[r + 1]`` of every primal
      product, elements ``vec_slab[r]:vec_slab[r + 1]`` of every primal
      (N, K) source product, and writes rows ``row_slab[r]:row_slab[r + 1]``
      of the primal outputs (group 0 only);
    * ``threads`` a block and ``smem`` bytes of dynamic shared memory;
    * ``work``: primal moments of work per point, groups + 2P (the primal
      once per group, two products per tangent product).

    At 53 <= N <= 128 (``wide`` True) twenty operators outgrow a block:

    * ``groups`` = P clusters per spectral point, one a tangent, each of
      ``cluster`` = the smallest of 2, 4, 8 blocks whose row bands fit
      (``fused_band.cluster_size``); each computes the primal and its
      tangent, rank r the rows ``row_slab[r]:row_slab[r + 1]`` (bands of
      ``band`` rows) of every operator;
    * ``work``: 3P primal moments a point (the primal once per tangent).

    A narrow launch refuses a cluster, group count or shared-memory size
    that ``csrc/fused_lin.cu``'s own plan does not give, and runs these
    slabs; a wide launch runs the C side's own plan, which the card tests
    hold against this one (``mt_launch_info``). Raises ValueError for
    N > 128, K outside 1..2 or P < 1."""
    if not (1 <= N <= KERNEL_MAX_N and 1 <= K <= KERNEL_MAX_K and P >= 1):
        raise ValueError(f"the multitangent kernel takes N <= {KERNEL_MAX_N},"
                         f" K <= {KERNEL_MAX_K} and P >= 1, got N={N}, K={K},"
                         f" P={P}")
    tiles = -(-N // 4) * -(-N // 8)
    if N > NARROW_MAX_N:
        c = cluster_size(N, K, True, 1)
        band = band_rows(N, c)
        rows = [min(r * band, N) for r in range(c + 1)]
        return {"cluster": c, "groups": P, "threads": CLUSTER_THREADS,
                "smem": cluster_smem_bytes(N, K, c, True), "tiles": tiles,
                "work": 3 * P, "wide": True, "band": band,
                "row_slab": rows}
    groups = -(-P // KERNEL_CLUSTER)
    cluster = -(-P // groups)
    return {"cluster": cluster, "groups": groups, "threads": KERNEL_THREADS,
            "smem": smem_bytes(N, K), "tiles": tiles,
            "work": groups + 2 * P, "wide": False,
            "tile_slab": _slabs(tiles, cluster),
            "vec_slab": _slabs(N * K, cluster),
            "row_slab": _slabs(N, cluster)}


def mt_launch_info(N: int, K: int, P: int) -> dict:
    """The C side's plan of (N, K, P) on the current card (builds the
    kernel): cluster, groups, threads, smem, tiles and ``max_clusters``,
    the clusters that can be resident at once
    (``cudaOccupancyMaxActiveClusters``)."""
    from .cuda_build import load
    lib = load("fused_lin")
    fn = lib.vsm_fused_moment_mt_info
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 6)()
    rc = fn(N, K, P, info)
    if rc != 0:
        lib.vsm_error_string.argtypes = [ctypes.c_int]
        lib.vsm_error_string.restype = ctypes.c_char_p
        raise RuntimeError("fused_lin plan query failed: "
                           + lib.vsm_error_string(rc).decode())
    return dict(zip(("cluster", "groups", "threads", "smem", "tiles",
                     "max_clusters"), info))


class TangentOperands(NamedTuple):
    """Tangents of the differentiable ``BandOperands`` fields for P
    parameters, each with a leading P axis (geom and d_vec are constants)."""
    Z_pp: torch.Tensor     # (P, C, N, N)
    Z_mp: torch.Tensor     # (P, C, N, N)
    w_over: torch.Tensor   # (P, nz, C, s)
    Em1: torch.Tensor      # (P, nz, s, N)
    dtau: torch.Tensor     # (P, nz, s)
    j0_p: torch.Tensor     # (P, nz, s, N, K)
    jm_star: torch.Tensor  # (P, nz, s, N, K)
    ek: torch.Tensor       # (P, nz, s, K)


def operand_tangents(fn, primals, tangents) -> TangentOperands:
    """Push P stacked input tangents (each with a leading P axis) through
    ``fn`` (primals -> BandOperands) by forward-mode AD; the result is
    contiguous, ready for the kernel."""
    def one(*d):
        out = torch.func.jvp(fn, primals, d)[1]
        return tuple(getattr(out, f) for f in TangentOperands._fields)
    return TangentOperands(*(x.contiguous()
                             for x in torch.func.vmap(one)(*tangents)))


def moment_multitangent_reference(ops: BandOperands, dops: TangentOperands,
                                  ns_sched, ns_inter: int):
    """The plain version of K2 on any device: (primal composite, tangent
    composite), the primal (R_mp, R_pm, T_pp, T_mm, J0_p, J0_m) of
    ``moment_body_reference`` and the same six with a leading P axis, its
    forward-mode derivatives along each parameter's operand tangents."""
    fields = TangentOperands._fields
    primals = tuple(getattr(ops, f) for f in fields)

    def body(*x):
        return moment_body_reference(ops._replace(**dict(zip(fields, x))),
                                     ns_sched, ns_inter)

    def one(*d):
        return torch.func.jvp(body, primals, d)[1]
    return body(*primals), torch.func.vmap(one)(*dops)


def _check_kernel_operands(ops: BandOperands, dops: TangentOperands,
                           ns_sched):
    s, N = ops.Em1.shape[1], ops.Em1.shape[2]
    nz, C, K = ops.Em1.shape[0], ops.Z_pp.shape[0], ops.j0_p.shape[-1]
    P = dops.Z_pp.shape[0]
    want = {"Z_pp": (C, N, N), "Z_mp": (C, N, N), "geom": (4, N, N),
            "d_vec": (N,), "w_over": (nz, C, s), "Em1": (nz, s, N),
            "dtau": (nz, s), "j0_p": (nz, s, N, K), "jm_star": (nz, s, N, K),
            "ek": (nz, s, K)}
    tensors = [(name, getattr(ops, name), want[name]) for name in want]
    tensors += [(f"d{name}", getattr(dops, name), (P,) + want[name])
                for name in TangentOperands._fields]
    mt_plan(N, K, P)
    if len(ns_sched) > KERNEL_MAX_DOUBL:
        raise ValueError(f"the kernel takes at most {KERNEL_MAX_DOUBL} "
                         f"doubling steps, got {len(ns_sched)}")
    for name, x, _ in tensors:
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes float32, got "
                             f"{x.dtype}")
    for name, x, shape in tensors:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x, _ in tensors:
        if x.device.type != "cuda" or x.device != ops.Em1.device:
            raise ValueError(f"{name}: the kernel takes tensors on one CUDA "
                             f"device, got {x.device}")


def _launch_kernel(ops: BandOperands, dops: TangentOperands, ns_sched,
                   ns_inter: int):
    """One cluster launch of csrc/fused_lin.cu on the current stream: a
    narrow plan on the words ``mt_plan`` makes (its cluster, groups,
    shared memory and primal slabs), which the C side checks against its
    own; a wide plan on the C side's own plan."""
    _check_kernel_operands(ops, dops, ns_sched)
    from .cuda_build import load
    s, N = ops.Em1.shape[1], ops.Em1.shape[2]
    nz, C, P = ops.Em1.shape[0], ops.Z_pp.shape[0], dops.Z_pp.shape[0]
    K = ops.j0_p.shape[-1]
    plan = mt_plan(N, K, P)
    lib = load("fused_lin")
    fn = lib.vsm_fused_moment_mt_f32
    fn.argtypes = [ctypes.c_void_p] * 30 + [ctypes.c_int] * 7 + \
        [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
         ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.vsm_error_string.argtypes = [ctypes.c_int]
    lib.vsm_error_string.restype = ctypes.c_char_p
    dev = ops.Em1.device
    f32 = torch.float32
    mat = [torch.empty((s, N, N), dtype=f32, device=dev) for _ in range(4)]
    vec = [torch.empty((s, N, K), dtype=f32, device=dev) for _ in range(2)]
    tmat = [torch.empty((P, s, N, N), dtype=f32, device=dev)
            for _ in range(4)]
    tvec = [torch.empty((P, s, N, K), dtype=f32, device=dev)
            for _ in range(2)]
    sched = (ctypes.c_int * max(len(ns_sched), 1))(*ns_sched)
    c_plan = None
    if not plan["wide"]:
        words = [plan["cluster"], plan["groups"], plan["smem"],
                 *plan["tile_slab"], *plan["vec_slab"], *plan["row_slab"]]
        c_plan = (ctypes.c_int * len(words))(*words)
    args = [*(x.data_ptr() for x in ops), *(x.data_ptr() for x in dops),
            *(x.data_ptr() for x in (*mat, *vec, *tmat, *tvec)),
            s, N, C, K, nz, P, len(ns_sched), sched, int(ns_inter), c_plan]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _launch_wide(fn, args, stream) if plan["wide"] \
            else fn(*args, stream)
    if rc != 0:
        raise RuntimeError("fused_lin kernel launch failed: "
                           + lib.vsm_error_string(rc).decode())
    return (*mat, *vec), (*tmat, *tvec)


def _launch_wide(fn, args, stream) -> int:
    """The launch of a wide plan (``cluster_band::cluster_kernel<K,
    true>``, one cluster a (point, tangent)): the C side's return code.
    Counted in ``_launch_wide.launches`` when it launched."""
    rc = fn(*args, stream)
    if rc == 0:
        _launch_wide.launches += 1
    return rc


_launch_wide.launches = 0


def fused_moment_multitangent(ops: BandOperands, dops: TangentOperands,
                              ns_sched, ns_inter: int):
    """One Fourier moment, the primal composite plus P tangent composites
    (see ``moment_multitangent_reference``), in one launch.

    CUDA tensors launch ``csrc/fused_lin.cu`` (counted in
    ``fused_moment_multitangent.launches``), which replaces the TPU kernel
    ``vsmartmom_tpu/ops/fused_lin.py::fused_moment_multitangent`` ->
    ``_mt_kernel`` at K = 1 and, at K = 2, K1' (the JVP of
    ``vsmartmom_tpu/ops/fused_band.py::fused_moment``). Its design is one
    thread-block cluster per (spectral point, group of up to 4 tangents),
    as ``mt_plan`` lays it out: each block runs K1's layer loop on a copy of
    the primal chain and on its own tangent chain in shared memory, and the
    cluster computes each primal product once, every block a slab of it
    stored into all the copies through distributed shared memory, so a
    point costs groups + 2P primal moments of work (18 at P = 8, against
    the least 1 + 2P = 17). Above N = 52 the plan is wide: a cluster per
    (point, tangent) holds the primal and that tangent chain cut by rows
    (3P primal moments a point; those launches also count in
    ``_launch_wide.launches``). It is bound by FP32 operations. CPU tensors
    run the plain version."""
    ns_sched = tuple(ns_sched)
    if ops.Em1.device.type == "cpu":
        return moment_multitangent_reference(ops, dops, ns_sched, ns_inter)
    out = _launch_kernel(ops, dops, ns_sched, ns_inter)
    fused_moment_multitangent.launches += 1
    return out


fused_moment_multitangent.launches = 0


def _stack(tangents, field, dtype, dev, index=None):
    return torch.stack([
        torch.as_tensor(getattr(t, field) if index is None
                        else getattr(t, field)[index]).to(device=dev,
                                                          dtype=dtype)
        for t in tangents])


def _cast(inputs: SolverInputs, dtype, dev) -> SolverInputs:
    """The inputs on ``dev`` in ``dtype``, cast before the move (a 4-D
    surface arrives as a host f64 tensor and crosses in the solve's
    dtype)."""
    return SolverInputs(*(torch.as_tensor(x).to(dtype=dtype).to(device=dev)
                          for x in inputs))


def multitangent_args(inputs: SolverInputs, tangents, config: SolverConfig,
                      m: int, device=None):
    """(ops, dops, ns_sched, ns_inter): the arguments of
    ``fused_moment_multitangent`` for moment ``m`` of a band with
    ``config.n_sources`` source columns and the given list of
    SolverInputs-shaped tangents, in ``config.dtype``."""
    dev = resolve_device(device)
    dtype = config.torch_dtype
    inp = _cast(inputs, dtype, dev)

    def prep(Zp, Zm, tau, scat_w, F0):
        args, kw = moment_args(Zp, Zm, tau, scat_w, F0, inp.thermal_b,
                               inp.qp_mu_N, inp.wt_mu_N, config, m)
        del kw["ns_sched"], kw["ns_inter"]
        return band_operands(*args, **kw)
    primals = (inp.Z_pp[m], inp.Z_mp[m], inp.tau, inp.scat_w, inp.F0)
    d_in = tuple(_stack(tangents, f, dtype, dev, i) for f, i in (
        ("Z_pp", m), ("Z_mp", m), ("tau", None), ("scat_w", None),
        ("F0", None)))
    return (prep(*primals), operand_tangents(prep, primals, d_in),
            norm_sched(config.ns_sched or None, config.ndoubl),
            config.ns_inter)


def rt_solve_multitangent(inputs: SolverInputs, tangents, config: SolverConfig,
                          device=None):
    """Forward solve plus P parameter tangents through the multitangent
    band path (K = 1 or K = 2 configurations). ``tangents`` is a list of P
    ``SolverInputs``-shaped tangents. Each Fourier moment up to ``m_scat``
    is one launch for all P tangents; the moments above it take
    ``rt_solve``'s Beer-law shortcut and its jvp. Returns (R, T, dR, dT)
    tensors: R/T (nVZA, ns, s), dR/dT (P, nVZA, ns, s)."""
    refuse_empty(tangents, "rt_solve_multitangent")
    dev = resolve_device(device)
    dtype = config.torch_dtype
    inp = _cast(inputs, dtype, dev)
    live = live_fields(tangents)
    P, n_spec, ns = len(tangents), config.n_spec, config.n_stokes
    n_m = config.m_max + 1
    n_full = n_m if config.m_scat < 0 else min(config.m_scat + 1, n_m)
    mu0 = inp.qp_mu_N[config.i_mu0_start]
    vza_rows = torch.as_tensor(
        [[v * ns + k for k in range(ns)] for v in config.vza_idx],
        device=dev)

    def stack(field, m=None):
        return _stack(tangents, field, dtype, dev, m) if field in live \
            else None

    def weigh(J, m):
        return J[:, vza_rows].permute(1, 2, 0) * inp.vza_w[m][:, :, None]

    def tail(R_mp, R_pm, T_pp, T_mm, J0_p, J0_m, surf_r, surf_j_m,
             surf_spec, F0, tau, sif_spec, m):
        surf = _surface_layer(surf_r, surf_j_m, inp.surf_direct_m[m],
                              surf_spec, F0, tau.sum(dim=0), mu0, sif_spec,
                              m == 0, config)
        out = interaction(CompositeLayer(R_mp, R_pm, T_pp, T_mm, J0_p,
                                         J0_m), surf)
        return weigh(out.J0_m.sum(dim=-1), m), weigh(out.J0_p.sum(dim=-1), m)

    def beer(surf_j_m, surf_spec, F0, tau, m):
        _, Jtoa, j0p = beer_moment(torch.cumsum(tau, dim=0)[-1], F0,
                                   surf_spec, surf_j_m, inp.surf_direct_m[m],
                                   inp.qp_mu_N, config)
        return weigh(Jtoa, m), weigh(j0p, m)

    whole = {f: stack(f) for f in ("surf_spec", "F0", "tau", "sif_spec")}
    R = torch.zeros((len(config.vza_idx), ns, n_spec), dtype=dtype,
                    device=dev)
    T = torch.zeros_like(R)
    dR = torch.zeros((P,) + R.shape, dtype=dtype, device=dev)
    dT = torch.zeros_like(dR)
    for m in range(n_m):
        primals = {"surf_j_m": inp.surf_j_m[m], "surf_spec": inp.surf_spec,
                   "F0": inp.F0, "tau": inp.tau}
        d_in = {"surf_j_m": stack("surf_j_m", m), **whole}
        if m < n_full:
            fn = functools.partial(tail, m=m)
            comp, dcomp = fused_moment_multitangent(*multitangent_args(
                inp, tangents, config, m, dev))
            primals.update(zip(CompositeLayer._fields, comp),
                           surf_r=inp.surf_r[m], sif_spec=inp.sif_spec)
            d_in.update(zip(CompositeLayer._fields, dcomp),
                        surf_r=stack("surf_r", m))
        else:
            fn = functools.partial(beer, m=m)
            d_in.pop("sif_spec")
        Rm, Tm = fn(**primals)
        dRm, dTm = jvp_over(fn, primals, {k: v for k, v in d_in.items()
                                          if v is not None}, P)
        R, T, dR, dT = R + Rm, T + Tm, dR + dRm, dT + dTm
    return R, T, dR, dT
