"""The port's spectral sharding (``vsmartmom_tpu_torch/parallel``) on gloo
ranks on the CPU, mirroring tests/test_sharding.py: each case runs
unsharded in this process and sharded over ``W`` ranks (``run_ranks``:
spawned once for the module, one torch and one BLAS thread each), every
rank solving its slice of the spectral points with the ordinary solve and
gathering the outputs along their spectral axis.

* the forward solve's R (the flagship at nSpec 4 W, 2 layers, nstreams
  4, f64): sharded vs unsharded rtol 1e-12;
* all five outputs (R, T, hdr, bhr_uw, bhr_dw) at nSpec 2 W, 1 layer:
  1e-12;
* ``pad_to_multiple``;
* ``rt_solve_jvp`` along a tau tangent of ones on that scene: R 1e-12, dR
  1e-11;
* the plain rotational-Raman solve with ``_roll0`` on the JAX test's own
  scene (125 points from 12950 cm^-1, padded to a multiple of W, the 12
  strongest shifts) with each rank's halo of max|shift| points: R, T,
  ieR, ieT 5e-6, the JAX test's gate (the halo makes it exact: the
  distance is printed);
* the plain vibrational-Raman solve with ``_src_fixed0`` (VS_0to1 on the
  grid of ``flagship.vs_ref_params``: 102 points, the first the incident
  wavelength, the strongest target on the last rank; its Rayleigh depth
  left to vary with wavelength, so the source point matters), each
  rank's slice led by grid point 0: R, T, ieR, ieT 1e-12 of
  max|unsharded|;
* ``flagship.dryrun_multichip(2)`` on the CPU.

Every case runs on the JAX package's own band build (numpy, carried
across by ``solver_inputs_from_numpy``), and the port's unsharded result
is held against the JAX package's unsharded one on those inputs: 1e-9 of
max|ref| (f64; the JAX jvp and RRS solves as tests/test_sharding.py
runs them; the VS solve on the JAX package's own setup).
"""

import dataclasses

import numpy as np
import pytest

from port_threads import _one_thread  # noqa: F401  (autouse)

W = 3
OUT5 = ("R", "T", "hdr", "bhr_uw", "bhr_dw")
RRS_KEYS = ("R", "T", "ieR", "ieT")
JAX_TOL = 1e-9
VS_MODE = "VS_0to1"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _port_inputs(case):
    """(SolverInputs, SolverConfig) on the CPU in f64 of a case's numpy
    band build."""
    from vsmartmom_tpu_torch.core.types import (solver_config_from_dict,
                                                solver_inputs_from_numpy)
    return (solver_inputs_from_numpy(case["inputs"], "cpu"),
            solver_config_from_dict(case["config"]))


def _rrs(case):
    from vsmartmom_tpu_torch.core.types import rrs_setup_from_numpy
    return rrs_setup_from_numpy(*case["rrs"], "cpu")


def _tau_tangent(inputs):
    from vsmartmom_tpu_torch.core.linearization import _zero_like
    import torch
    return _zero_like(inputs)._replace(tau=torch.ones_like(inputs.tau))


def port_runs(case_name, case, mesh=None):
    """The port's solve of one case, unsharded (``mesh`` None) or this
    rank's slice gathered over ``mesh``: a dict of numpy outputs."""
    from vsmartmom_tpu_torch.core.inelastic import (_roll0, _src_fixed0,
                                                    rt_solve_rrs)
    from vsmartmom_tpu_torch.core.linearization import rt_solve_jvp
    from vsmartmom_tpu_torch.core.solver import rt_solve
    from vsmartmom_tpu_torch.parallel.sharding import (
        gather_outputs, numpy_outputs, shard_inputs, shard_raman, trim)
    inputs, config = _port_inputs(case)
    if case_name in ("rrs", "vs"):
        rrs, keep = _rrs(case), None
        if mesh is not None:
            inputs, config, rrs, keep = shard_raman(inputs, config, rrs,
                                                    mesh)
        out = rt_solve_rrs(inputs, config, *rrs, "cpu",
                           src_fn=_roll0 if case_name == "rrs"
                           else _src_fixed0)
        if mesh is not None:
            out = gather_outputs(trim(out, keep), mesh)
        return numpy_outputs(out)
    if case_name == "jvp":
        tangent = _tau_tangent(inputs)
        if mesh is not None:
            tangent, _ = shard_inputs(tangent, config, mesh)
            inputs, config = shard_inputs(inputs, config, mesh)
        R, _, dR, _ = rt_solve_jvp(inputs, [tangent], config, "cpu")
        out = {"R": R, "dR": dR[0]}
    else:
        if mesh is not None:
            inputs, config = shard_inputs(inputs, config, mesh)
        o = rt_solve(inputs, config, "cpu")
        out = {k: o[k] for k in OUT5}
    if mesh is not None:
        out = gather_outputs(out, mesh)
    return numpy_outputs(out)


def _rank_work(rank, world, cases):
    """One rank's part of every case: its slice solved and the outputs
    gathered; also the rank's own point count in each case."""
    from vsmartmom_tpu_torch.parallel.sharding import (shard_raman,
                                                       spectral_mesh)
    mesh = spectral_mesh()
    out = {name: port_runs(name, case, mesh) for name, case in cases.items()}
    for name in ("rrs", "vs"):
        inputs, config = _port_inputs(cases[name])
        _, local, _, keep = shard_raman(inputs, config, _rrs(cases[name]),
                                        mesh)
        out[f"{name}_halo"] = (local.n_spec, keep.start, keep.stop)
    return out


def _jax_flagship_case(n_spec, nz):
    from __graft_entry__ import _flagship_model
    model = _flagship_model(n_spec=n_spec, nstreams=4, nz=nz,
                            dtype=np.float64)
    inputs, config = model.build_band(0)
    return inputs, config, {
        "inputs": {f: np.asarray(getattr(inputs, f))
                   for f in inputs._fields},
        "config": dataclasses.asdict(config)}


def _jax_rrs_case():
    """tests/test_sharding.py's RRS scene and setup, as numpy, and a
    function that runs the JAX package's plain solve of it."""
    import jax
    from vsmartmom_tpu import model_from_parameters
    from vsmartmom_tpu.core.inelastic import _roll0, rt_solve_rrs
    from vsmartmom_tpu.core.model import Parameters, SurfaceDescriptor
    from vsmartmom_tpu.inelastic.rrs_setup import (greek_raman,
                                                   rrs_redistribution)
    from vsmartmom_tpu.parallel.sharding import pad_to_multiple
    from vsmartmom_tpu.scattering.stokes import STOKES_I
    from vsmartmom_tpu.scattering.zmatrix import compute_Z_moments
    nu = np.arange(12950.0, 13200.0, 2.0)            # 125 points -> 126
    n_pad = pad_to_multiple(len(nu), W)
    nu = np.concatenate([nu, nu[-1] + 2.0 * np.arange(1, n_pad - len(nu)
                                                      + 1)])
    model = model_from_parameters(Parameters(
        spec_bands=[nu],
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar", [0.2])],
        nstreams=4, polarization=STOKES_I,
        sza=45.0, vza=[0.0, 40.0], vaz=[0.0, 90.0], obs_alt=0.0,
        T=np.array([250.0, 275.0]), p=np.array([100.0, 500.0, 1013.0]),
        depol=-1.0))
    band = model.bands[0]
    inputs, config = model.build_band(0, rrs=True)
    shifts, w_shifts, _ = rrs_redistribution(band.nu_grid)
    w_shifts = w_shifts * (1.0 - band.pi_cabannes) / w_shifts.sum()
    top = np.argsort(w_shifts)[-12:]
    shifts, w_shifts = shifts[top], w_shifts[top]
    Z_r = [compute_Z_moments(model.params.polarization, model.quad.qp_mu,
                             greek_raman(), m)
           for m in range(config.m_max + 1)]
    Z_r_pp = np.stack([z[0] for z in Z_r])
    Z_r_mp = np.stack([z[1] for z in Z_r])
    fscatt = band.tau_rayl.T / np.maximum(np.asarray(inputs.tau), 1e-300)
    rrs = (tuple(int(v) for v in shifts), np.asarray(w_shifts), Z_r_pp,
           Z_r_mp, fscatt)

    def jax_solve():
        out = rt_solve_rrs(inputs, config, rrs[0],
                           *(jax.numpy.asarray(x) for x in rrs[1:]),
                           src_fn=_roll0)
        return {k: np.asarray(out[k]) for k in RRS_KEYS}
    return {"inputs": {f: np.asarray(getattr(inputs, f))
                       for f in inputs._fields},
            "config": dataclasses.asdict(config), "rrs": rrs}, jax_solve


def _jax_vs_case():
    """The VS_0to1 scene of ``flagship.vs_ref_params`` (intensity only,
    its f32 configuration solved in f64) and the JAX package's setup of
    it, as numpy, and a function that runs the JAX package's plain
    fixed-source solve of it."""
    import jax
    from raman_inputs import solved_in_f64
    from vsmartmom_tpu import model_from_parameters
    from vsmartmom_tpu.core.inelastic import (_src_fixed0, inelastic_setup,
                                              rt_solve_rrs)
    from vsmartmom_tpu.core.model import Parameters, SurfaceDescriptor
    from vsmartmom_tpu.scattering.stokes import STOKES_I
    from vsmartmom_tpu_torch.flagship import vs_ref_params
    model = solved_in_f64(model_from_parameters(Parameters(
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar", [0.2])],
        polarization=STOKES_I, **vs_ref_params(VS_MODE))))
    inputs, config, *rrs, src_fn = inelastic_setup(model, mode=VS_MODE)
    assert src_fn is _src_fixed0 and np.ndim(rrs[1]) == 2
    rrs = (tuple(int(v) for v in rrs[0]),
           *(np.asarray(x) for x in rrs[1:]))

    def jax_solve():
        out = rt_solve_rrs(inputs, config, rrs[0],
                           *(jax.numpy.asarray(x) for x in rrs[1:]),
                           src_fn=_src_fixed0)
        return {k: np.asarray(out[k]) for k in RRS_KEYS}
    return {"inputs": {f: np.asarray(getattr(inputs, f))
                       for f in inputs._fields},
            "config": dataclasses.asdict(config), "rrs": rrs}, jax_solve


@pytest.fixture(scope="module")
def runs():
    """({case: (JAX unsharded, port unsharded, port sharded on every
    rank)}, the ranks' RRS slices (points, own start, own stop), the RRS
    shifts). The ranks run while this process runs the JAX package."""
    from concurrent.futures import ThreadPoolExecutor
    import jax
    import jax.numpy as jnp
    from vsmartmom_tpu.core.solver import rt_solve as jax_rt_solve
    from vsmartmom_tpu_torch.parallel.sharding import run_ranks
    cases, ref = {}, {}
    f_inputs, f_config, cases["forward"] = _jax_flagship_case(4 * W, 2)
    inputs, config, cases["outputs"] = _jax_flagship_case(2 * W, 1)
    cases["jvp"] = cases["outputs"]
    cases["rrs"], jax_rrs = _jax_rrs_case()
    cases["vs"], jax_vs = _jax_vs_case()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, _rank_work, W, cases, threads=1,
                            timeout=300)
        ref["forward"] = {"R": np.asarray(jax_rt_solve(f_inputs,
                                                       f_config)["R"])}
        o = jax_rt_solve(inputs, config)
        ref["outputs"] = {k: np.asarray(o[k]) for k in OUT5}

        def f(tau):
            return jax_rt_solve(dataclasses.replace(inputs, tau=tau),
                                config)["R"]
        R, dR = jax.jvp(f, (inputs.tau,), (jnp.ones_like(inputs.tau),))
        ref["jvp"] = {"R": np.asarray(R), "dR": np.asarray(dR)}
        ref["rrs"] = jax_rrs()
        ref["vs"] = jax_vs()
        plain = {name: port_runs(name, case) for name, case in cases.items()}
        ranks = ranks.result()
    return {name: (ref[name], plain[name], [r[name] for r in ranks])
            for name in cases}, {name: [r[f"{name}_halo"] for r in ranks]
                                 for name in ("rrs", "vs")}, \
        cases["rrs"]["rrs"][0]


def _check(run, keys, tol_shard, rtol=True):
    ref, plain, ranks = run
    for k in keys:
        assert _rel(plain[k], ref[k]) <= JAX_TOL, k
        for sharded in ranks:
            assert sharded[k].shape == plain[k].shape, k
            if rtol:
                np.testing.assert_allclose(sharded[k], plain[k],
                                           rtol=tol_shard, atol=1e-14,
                                           err_msg=k)
            else:
                assert _rel(sharded[k], plain[k]) <= tol_shard, k


def test_forward_sharded_equals_unsharded(runs):
    _check(runs[0]["forward"], ("R",), 1e-12)


def test_all_outputs_sharded(runs):
    _check(runs[0]["outputs"], OUT5, 1e-12)


def test_pad_to_multiple():
    from vsmartmom_tpu_torch.parallel.sharding import pad_to_multiple
    assert pad_to_multiple(17, 8) == 24
    assert pad_to_multiple(16, 8) == 16
    assert pad_to_multiple(125, 3) == 126


def test_jvp_sharded_equals_unsharded(runs):
    _check(runs[0]["jvp"], ("R",), 1e-12)
    _check(runs[0]["jvp"], ("dR",), 1e-11)


def test_rrs_sharded_equals_unsharded(runs):
    """The roll crosses the shard boundaries: each rank solves its 42
    points widened by the halo (max|shift| a side, inside the band) and
    trims it."""
    from vsmartmom_tpu_torch.parallel.sharding import pad_to_multiple
    ref, plain, ranks = runs[0]["rrs"]
    _check((ref, plain, ranks), RRS_KEYS, 5e-6, rtol=False)
    dist = max(_rel(r[k], plain[k]) for r in ranks for k in RRS_KEYS)
    print(f"sharded RRS vs unsharded: {dist:.2e}")
    halo = max(abs(s) for s in runs[2])
    n_spec = pad_to_multiple(125, W)
    n_local = n_spec // W
    assert halo > 0
    for rank, (n, a, b) in enumerate(runs[1]["rrs"]):
        lo = min(halo, rank * n_local)
        hi = min(halo, n_spec - (rank + 1) * n_local)
        assert (n, a, b) == (n_local + lo + hi, lo, lo + n_local)


def test_vs_sharded_equals_unsharded(runs):
    """The vibrational fixed-source map reads grid point 0 for every
    target: a rank whose slice does not start there solves its 34 points
    led by point 0 (known from the setup's per-target weights) and trims
    it. The strongest target is the grid's last point, on the last
    rank."""
    ref, plain, ranks = runs[0]["vs"]
    _check((ref, plain, ranks), RRS_KEYS, 1e-12, rtol=False)
    ieR = np.abs(plain["ieR"]).max(axis=(0, 1))
    assert ieR.argmax() >= 2 * 102 // W and ieR.max() > 0
    n_local = 102 // W
    for rank, (n, a, b) in enumerate(runs[1]["vs"]):
        lo = 0 if rank == 0 else 1
        assert (n, a, b) == (n_local + lo, lo, lo + n_local)


def test_sharding_placements():
    """``input_shardings``: Shard on each field's spectral axis, Replicate
    for the angular operators; a 4-D surface sharded on its axis 1."""
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from vsmartmom_tpu_torch.core.types import SolverInputs
    from vsmartmom_tpu_torch.parallel.sharding import input_shardings

    class Mesh:
        ndim = 1
    p = input_shardings(Mesh())
    assert p.tau == (Shard(1),) and p.scat_w == (Shard(2),)
    assert p.surf_spec == (Shard(0),) and p.Z_pp == (Replicate(),)
    assert p.surf_r == p.surf_j_m == (Replicate(),)
    four_d = SolverInputs(**{f: torch.zeros((1,) * (4 if f in (
        "surf_r", "surf_j_m") else 1)) for f in SolverInputs._fields})
    p = input_shardings(Mesh(), four_d)
    assert p.surf_r == p.surf_j_m == (Shard(1),)


def test_dryrun_multichip_on_the_cpu(capsys):
    from vsmartmom_tpu_torch.flagship import dryrun_multichip
    R = dryrun_multichip(2, device="cpu")
    assert R.shape == (9, 4, 16) and np.isfinite(R).all()
    assert "dryrun_multichip OK: 2-rank spectral mesh (gloo), nSpec=16" \
        in capsys.readouterr().out
