"""Spectral-domain decomposition over ``torch.distributed``.

Counterpart of ``vsmartmom_tpu/parallel/sharding.py``. Every RT operator is
batch-leading over nSpec and spectral points are independent through the
whole layer-adding chain, so the strategy is a 1-D mesh over a
``spectral`` axis: each rank takes a contiguous slice of the spectral
points (``shard_inputs``, through ``core.solver.spectral_slice``), runs
the ordinary solve on it, and the outputs are gathered along their
spectral axis (``gather_outputs``). The JAX package compiles the sharded
solve with ``jit`` and lets XLA place the slices; here each rank is a
process of its own, started by ``run_ranks`` (NCCL with one GPU a rank,
gloo on the CPU, or gloo for ranks that share one GPU and gather on the
host). Only the gathers touch the interconnect.

The one cross-shard coupling is Raman redistribution. The JAX package
lowers its spectral rolls to a collective permute; the port gives each
rank a halo and computes it again (``shard_raman``): every roll in
``core.inelastic`` reads elastic quantities only, at the source
wavelength, so the rank solves its slice widened by max|shift| points on
each side (fewer at the band's edges, where the roll reads zeros in both
runs) and trims the halo from its outputs; the halo's own values, which
read zeros past the widened slice, are thrown away. The vibrational
fixed-source map reads grid point 0 only, so there the halo is that one
point. Nothing is exchanged but the gathers, and the sharded result is
the unsharded one in exact arithmetic: on the plain route the same up to
rounding, and on the kernel route the same up to the summation order of
a rank's different shift chunking (ieR 3.2e-7 of its max on an H100,
RRS + SIF over two ranks; R and T bit-equal).
"""

import socket
import traceback

import numpy as np
import torch

from ..core.solver import spectral_fields, spectral_slice, spectral_take
from ..core.types import SolverConfig, SolverInputs

SPECTRAL_AXIS = "spectral"

#: Spectral axis of each output of the solves (rt_solve, rt_solve_jvp's
#: and rt_solve_multitangent's dR / dT, the inelastic and multisensor
#: solves): the axis ``gather_outputs`` concatenates the ranks' slices on.
OUTPUT_AXIS = {"R": -1, "T": -1, "hdr": -1, "bhr_uw": -1, "bhr_dw": -1,
               "J0_up_toa": 0, "J0_dn_boa": 0, "J_up_per_m": 1,
               "J_dn_per_m": 1, "dR": -1, "dT": -1, "ieR": -1, "ieT": -1,
               "uwJ": -1, "dwJ": -1, "ieuwJ": -1, "iedwJ": -1}


def spectral_mesh():
    """1-D ``DeviceMesh`` named ``"spectral"`` over the default process
    group (``torch.distributed.device_mesh.init_device_mesh``): on "cuda"
    under NCCL, on "cpu" under gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("spectral_mesh needs an initialised default "
                           "process group (run_ranks starts one)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(SPECTRAL_AXIS,))


def pad_to_multiple(n_spec: int, n_dev: int) -> int:
    """Spectral points must tile evenly across ranks; callers pad the
    wavenumber grid with replicated tail points."""
    return ((n_spec + n_dev - 1) // n_dev) * n_dev


def input_shardings(mesh, inputs: SolverInputs = None) -> SolverInputs:
    """Placements of every SolverInputs field on ``mesh``: ``Shard`` on
    the spectral axis of each field that ``core.solver.spectral_fields``
    gives one, ``Replicate`` for the small angular operators. surf_r and
    surf_j_m have a spectral axis only when 4-D (a spectrally resolved
    surface, known from ``inputs``): then they are sharded on it, where
    the JAX package replicates them. The numbers are the same either way;
    only the layout differs."""
    from torch.distributed.tensor import Replicate, Shard
    if mesh.ndim != 1:
        raise ValueError(f"a spectral mesh is 1-D, got {mesh.ndim} dims")
    axes = spectral_fields(inputs)
    return SolverInputs(**{
        f: (Shard(axes[f]),) if f in axes else (Replicate(),)
        for f in SolverInputs._fields})


def _rank_slice(config: SolverConfig, mesh):
    n = mesh.size()
    if config.n_spec % n:
        raise ValueError(f"{config.n_spec} spectral points do not tile "
                         f"{n} ranks; pad the grid to "
                         f"{pad_to_multiple(config.n_spec, n)} "
                         "(pad_to_multiple)")
    local = config.n_spec // n
    start = mesh.get_local_rank(SPECTRAL_AXIS) * local
    return start, start + local


def shard_inputs(inputs: SolverInputs, config: SolverConfig, mesh):
    """(inputs, config) of this rank's contiguous slice of the spectral
    points: every ``Shard`` field of ``input_shardings`` cut by
    ``core.solver.spectral_slice``, the rest whole."""
    return spectral_slice(inputs, config, *_rank_slice(config, mesh))


def shard_raman(inputs: SolverInputs, config: SolverConfig, rrs, mesh):
    """This rank's slice of an inelastic setup with its halo: (inputs,
    config, rrs, keep), ``rrs`` = (shifts, w_shifts, Z_r_pp, Z_r_mp,
    fscatt) as ``core.inelastic.inelastic_setup`` gives them, and ``keep``
    the slice of the local outputs' spectral points that are the rank's
    own (its halo trimmed). The setup says which map it is for: weights
    per shift (nR,) are the rotational roll, and the slice is widened by
    max|shift| points on each side, within the band; weights per target
    (1, nSpec) are the vibrational fixed-source map, and grid point 0 is
    put in front of a slice that does not start there."""
    shifts, w_shifts, Z_r_pp, Z_r_mp, fscatt = rrs
    start, stop = _rank_slice(config, mesh)
    w = torch.as_tensor(w_shifts)
    if w.dim() == 2:
        lo = 0 if start == 0 else 1
        idx = torch.cat([torch.zeros(lo, dtype=torch.long),
                         torch.arange(start, stop)])
        inputs, config = spectral_take(inputs, config, idx)
        fscatt = torch.as_tensor(fscatt)
        w, fscatt = (x.index_select(1, idx.to(x.device))
                     for x in (w, fscatt))
    else:
        halo = max((abs(int(s)) for s in shifts), default=0)
        a, b = max(0, start - halo), min(config.n_spec, stop + halo)
        lo = start - a
        inputs, config = spectral_slice(inputs, config, a, b)
        fscatt = torch.as_tensor(fscatt).narrow(1, a, b - a)
    return (inputs, config, (shifts, w, Z_r_pp, Z_r_mp, fscatt),
            slice(lo, lo + stop - start))


def trim(out: dict, keep: slice) -> dict:
    """The outputs of a rank's widened slice cut back to its own points
    (``shard_raman``'s ``keep``) along each output's spectral axis."""
    res = {}
    for k, v in out.items():
        if v is None or k not in OUTPUT_AXIS:
            res[k] = v
            continue
        ax = OUTPUT_AXIS[k] % v.dim()
        res[k] = v.narrow(ax, keep.start, keep.stop - keep.start)
    return res


def gather_spectral(x: torch.Tensor, mesh, axis: int = -1) -> torch.Tensor:
    """The ranks' slices of ``x`` concatenated in rank order along
    ``axis``, on every rank: an all-gather over the mesh's group on the
    mesh's device type (the host under gloo, ``x``'s GPU under NCCL);
    the result lies on ``x``'s device."""
    import torch.distributed as dist
    group = mesh.get_group(SPECTRAL_AXIS)
    comm = x.contiguous()
    if mesh.device_type == "cpu":
        comm = comm.cpu()
    parts = [torch.empty_like(comm) for _ in range(mesh.size())]
    dist.all_gather(parts, comm, group=group)
    return torch.cat(parts, dim=axis % x.dim()).to(x.device)


def gather_outputs(out: dict, mesh) -> dict:
    """``gather_spectral`` of every output a solve returns with a spectral
    axis (``OUTPUT_AXIS``); other entries are passed through."""
    return {k: gather_spectral(v, mesh, OUTPUT_AXIS[k])
            if v is not None and k in OUTPUT_AXIS else v
            for k, v in out.items()}


# ---- ranks as processes ----------------------------------------------------

def _free_port() -> int:
    """A free TCP port on localhost for the process group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, backend, port, queue, args, threads):
    import torch.distributed as dist
    try:
        if threads is not None:
            torch.set_num_threads(threads)
            try:
                import threadpoolctl
                threadpoolctl.threadpool_limits(limits=threads)
            except ImportError:
                pass
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        try:
            value = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, value))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world_size: int, *args, backend: str = "gloo",
              threads=None, timeout: float = 600.0):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes, each a rank of a default process group (``backend``: NCCL
    with GPU ``rank`` a rank, or gloo; the rendezvous on a free localhost
    port). ``fn`` must be importable (a module-level function) and return
    something picklable. Returns the ranks' values in rank order; raises
    with a failed rank's traceback, and stops every process it started.
    ``threads`` pins each rank's torch and BLAS pools."""
    import multiprocessing as mp
    import queue as queue_mod
    if backend == "nccl" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"NCCL takes one GPU a rank: {world_size} ranks, "
                           f"{torch.cuda.device_count()} GPUs")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, port, q, args,
                               threads))
             for r in range(world_size)]
    values, failed = {}, []
    try:
        for p in procs:
            p.start()
        for _ in range(world_size):
            try:
                rank, ok, value = q.get(timeout=timeout)
            except queue_mod.Empty:
                raise RuntimeError(f"a rank gave no result in {timeout} s")
            if ok:
                values[rank] = value
            else:
                failed.append(f"rank {rank}:\n{value}")
                break
        if failed:
            raise RuntimeError("\n".join(failed))
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [values[r] for r in range(world_size)]


def numpy_outputs(out: dict) -> dict:
    """The tensors of a result dict as numpy arrays (for a rank's return
    value)."""
    return {k: (np.asarray(v.detach().cpu()) if isinstance(v, torch.Tensor)
                else v) for k, v in out.items()}
