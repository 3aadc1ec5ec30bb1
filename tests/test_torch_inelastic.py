"""The port's rotational-Raman (RRS + SIF) path against the JAX package.

Scene: tests/test_fused_rrs.py's (Rayleigh column of 3 layers over a
Lambertian surface with SIF, nstreams = 4, 2.4 cm^-1 spacing) cut to
nSpec = 16, which keeps 6 Raman shifts (-7..6), every one of them reaching
off the band edge for some points; the cut keeps the JAX compiles and
Pallas interpret runs of the file to ~25 s. Both packages run on the JAX setup's
outputs, handed across as numpy (``solver_inputs_from_numpy``,
``solver_config_from_dict``, ``rrs_setup_from_numpy``); JAX outputs are
converted with ``np.asarray`` before the torch side runs. Tolerances,
relative to max|ref|: 1e-12 for the host setup; for the plain path against
the JAX f64 solve 1e-9 in f64 and 2e-5 in f32 (f32 rounding, and the
frameworks sum products in another order); 2e-5 for
the plain K3 and the fused solve against the JAX Pallas kernel in
interpret mode.

Also holds the stored cross-framework reference
``vsmartmom_tpu_torch/data/rrs_ref_f64.npz`` (the IQU scene's f32 model
solved in f64 by the JAX plain ``rt_solve_rrs``), which the chip smoke test
compares the port's kernel path against: a test recomputes it so it
cannot go stale. ``python tests/test_torch_inelastic.py`` rewrites it.
"""

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from vsmartmom_tpu_torch.flagship import (RRS_REF_ALBEDO, RRS_REF_N_SPEC,
                                          RRS_REF_SIF, rrs_ref_model,
                                          rrs_ref_params)

from port_threads import _one_thread  # noqa: F401  (autouse)

N_SPEC = RRS_REF_N_SPEC
KEYS = ("R", "T", "ieR", "ieT")
REF_PATH = (Path(__file__).resolve().parents[1] / "vsmartmom_tpu_torch"
            / "data" / "rrs_ref_f64.npz")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def jax_model(pol_name, n_spec=N_SPEC):
    """The JAX package's model of the port's ``flagship.rrs_ref_model``
    scene, from the same keywords."""
    from vsmartmom_tpu import model_from_parameters
    from vsmartmom_tpu.core.model import Parameters, SurfaceDescriptor
    from vsmartmom_tpu.scattering import stokes
    model = model_from_parameters(Parameters(
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar",
                                    [RRS_REF_ALBEDO])],
        polarization=getattr(stokes, pol_name), **rrs_ref_params(n_spec)))
    model.bands[0].sif_spec = RRS_REF_SIF * np.ones(n_spec)
    return model


def port_model(pol_name, n_spec=N_SPEC):
    from vsmartmom_tpu_torch.scattering import stokes
    return rrs_ref_model(n_spec, getattr(stokes, pol_name))


@pytest.fixture(scope="module")
def setups():
    """JAX inelastic_setup of the I and the IQU scene, and the same state
    carried across to the port (CPU tensors)."""
    from vsmartmom_tpu.core.inelastic import inelastic_setup
    from vsmartmom_tpu_torch.core.types import (rrs_setup_from_numpy,
                                                solver_inputs_from_numpy)
    out = {}
    for pol in ("STOKES_I", "STOKES_IQU"):
        (inputs, config, shifts, w, Zp, Zm, fsc,
         _) = inelastic_setup(jax_model(pol))
        port_inp = solver_inputs_from_numpy(
            {f: np.asarray(getattr(inputs, f)) for f in inputs._fields},
            "cpu")
        port_rrs = rrs_setup_from_numpy(shifts, np.asarray(w),
                                        np.asarray(Zp), np.asarray(Zm),
                                        np.asarray(fsc), "cpu")
        out[pol] = dict(jax=(inputs, config, shifts, w, Zp, Zm, fsc),
                        port=(port_inp, port_rrs))
    return out


def _port_config(jax_config, **replace):
    from vsmartmom_tpu_torch.core.types import solver_config_from_dict
    return solver_config_from_dict(
        dataclasses.asdict(dataclasses.replace(jax_config, **replace)))


def _jax_plain(setup, **replace):
    from vsmartmom_tpu.core.inelastic import rt_solve_rrs
    inputs, config, shifts, w, Zp, Zm, fsc = setup["jax"]
    out = rt_solve_rrs(inputs, dataclasses.replace(config, **replace),
                       shifts, w, Zp, Zm, fsc)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_plain_f64(setups):
    """JAX plain rt_solve_rrs of the IQU scene in f64 (also the stored
    reference's recipe)."""
    return _jax_plain(setups["STOKES_IQU"], dtype=np.float64)


def test_rrs_redistribution_and_greek_raman_match_jax():
    from vsmartmom_tpu.inelastic import rrs_setup as jax_rrs
    from vsmartmom_tpu_torch.inelastic import rrs_setup
    for n_spec, step in ((16, 2.4), (256, 0.6)):
        nu = 12950.0 + step * np.arange(n_spec)
        sh, w, pi = rrs_setup.rrs_redistribution(nu)
        sh_j, w_j, pi_j = jax_rrs.rrs_redistribution(nu)
        assert np.array_equal(sh, sh_j) and len(sh) > 0
        assert _rel(w, w_j) <= 1e-12 and abs(pi - pi_j) <= 1e-12
    g, g_j = rrs_setup.greek_raman(), jax_rrs.greek_raman()
    for f in ("alpha", "beta", "gamma", "delta", "epsilon", "zeta"):
        assert np.max(np.abs(getattr(g, f) - getattr(g_j, f))) <= 1e-12, f


@pytest.mark.parametrize("pol", ["STOKES_I", "STOKES_IQU"])
def test_inelastic_setup_matches_jax(setups, pol):
    """The port's own host build (build_band(rrs=True) + the Raman setup)
    against the JAX one: Cabannes phase matrices and weights, shifts,
    Raman weights and phase matrices, fscatt."""
    from vsmartmom_tpu_torch.core.inelastic import inelastic_setup
    inputs, config, shifts, w, Zp, Zm, fsc = setups[pol]["jax"]
    (p_inp, p_cfg, p_shifts, p_w, p_Zp, p_Zm,
     p_fsc) = inelastic_setup(port_model(pol), device="cpu")
    assert p_shifts == shifts and min(shifts) < 0 < max(shifts)
    assert (p_cfg.N, p_cfg.nz, p_cfg.ndoubl, p_cfg.m_max) == \
        (config.N, config.nz, config.ndoubl, config.m_max)
    for a, b in ((p_w, w), (p_Zp, Zp), (p_Zm, Zm), (p_fsc, fsc)):
        assert _rel(a.numpy(), b) <= 1e-12
    for f in ("tau", "scat_w", "Z_pp", "Z_mp", "sif_spec", "surf_r"):
        assert _rel(getattr(p_inp, f).numpy(), getattr(inputs, f)) <= 1e-12, f


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_plain_rrs_matches_jax(setups, jax_plain_f64, dtype):
    """The port's plain rt_solve_rrs in f64 and in f32 against the JAX plain
    rt_solve_rrs in f64 (1e-9 and 2e-5)."""
    from vsmartmom_tpu_torch.core.inelastic import rt_solve_rrs
    s = setups["STOKES_IQU"]
    config = _port_config(s["jax"][1], dtype=dtype)
    out = rt_solve_rrs(s["port"][0], config, *s["port"][1], device="cpu")
    tol = 1e-9 if dtype == np.float64 else 2e-5
    for k in KEYS:
        assert out[k].dtype == config.torch_dtype
        assert _rel(out[k].numpy(), jax_plain_f64[k]) <= tol, k
    assert np.max(np.abs(jax_plain_f64["ieR"])) > 0


@pytest.fixture(scope="module")
def jax_kernel_case(setups):
    """The fused solve's m = 1 operands of the I scene (seed-only and
    one-iteration NS steps included) and the JAX fused_moment_rrs in
    interpret mode on them: (args, kwargs, its outputs as numpy)."""
    import jax
    import jax.numpy as jnp
    from vsmartmom_tpu.ops.fused_rrs import \
        fused_moment_rrs as jax_fused_moment_rrs
    from vsmartmom_tpu_torch.core.solver import band_moment_args
    s = setups["STOKES_I"]
    inputs, (shifts, w, Zp, Zm, fsc) = s["port"]
    config = _port_config(s["jax"][1], dtype=np.float32)
    args, _ = band_moment_args(inputs, config, 1, "cpu")
    (Z_pp, Z_mp, tau, scat_w, Em1, Em1_0, att, ek, _, F0_m, qp, wct, d_vec,
     _, in_blk) = args
    f32 = torch.float32
    ie_args = (Z_pp, Z_mp, Zp[1].to(f32), Zm[1].to(f32), tau, scat_w, Em1,
               Em1_0, att, ek, fsc.to(f32), shifts, w.to(f32), F0_m, qp,
               wct, d_vec, in_blk)
    ie_kw = dict(ndoubl=config.ndoubl, ns_sched=(0, 0, 1, 1, 2, 3, 4),
                 ns_inter=4, n_stokes=config.n_stokes,
                 i_mu0_start=config.i_mu0_start)
    arrays = [jnp.asarray(a.numpy()) for a in ie_args if torch.is_tensor(a)]
    ref = jax.jit(lambda *a: jax_fused_moment_rrs(
        *a[:11], shifts, *a[11:], **ie_kw, block=128, interpret=True))(
            *arrays)
    return ie_args, ie_kw, [np.asarray(x) for x in ref]


def test_moment_rrs_reference_matches_jax_kernel(jax_kernel_case):
    """The plain K3 (moment_rrs_reference) against the JAX fused_moment_rrs
    in interpret mode on identical operands (the fused solve's m = 1
    arguments, seed-only and one-iteration NS steps included); pairs whose
    source point lies off the grid come out exactly zero in the ie block."""
    from vsmartmom_tpu_torch.ops.fused_rrs import (moment_rrs_reference,
                                                   rrs_operands)
    ie_args, ie_kw, ref = jax_kernel_case
    shifts = ie_args[11]
    out = moment_rrs_reference(*ie_args, **ie_kw)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b) <= 2e-5
    ops = rrs_operands(*ie_args, **{k: v for k, v in ie_kw.items()
                                    if k not in ("ns_sched", "ns_inter")})
    off = (ops.pref[0] == 0).reshape(len(shifts), -1)
    assert off.any() and not off.all()
    assert all(bool((x[off] == 0).all()) for x in out)


def test_moment_rrs_split_reference_matches_jax_kernel(jax_kernel_case):
    """The kernels' split form (each grid point's diagonal ladder once, the
    (2,1) blocks per on-grid pair through the store) against the same JAX
    interpret run, 2e-5 of max|ref|; off-grid pairs exactly zero."""
    from vsmartmom_tpu_torch.ops.fused_rrs import (
        moment_rrs_split_reference, norm_sched, rrs_operands)
    ie_args, ie_kw, ref = jax_kernel_case
    shifts = ie_args[11]
    ops = rrs_operands(*ie_args, **{k: v for k, v in ie_kw.items()
                                    if k not in ("ns_sched", "ns_inter")})
    out = moment_rrs_split_reference(
        ops, shifts, norm_sched(ie_kw["ns_sched"], ie_kw["ndoubl"]),
        ie_kw["ns_inter"])
    off = (ops.pref[0] == 0).reshape(-1)
    for a, b in zip(out, ref):
        assert _rel(a.reshape(b.shape).numpy(), b) <= 2e-5
        assert bool((a[off] == 0).all())


@pytest.mark.parametrize("fullres", [False, True], ids=["coarse", "fullres"])
def test_fused_solve_matches_jax_interpret(setups, fullres, monkeypatch):
    """rt_solve_rrs_fused on the CPU (plain K1 and K3) against the JAX
    rt_solve_rrs_fused with its Pallas kernels in interpret mode, at the
    coarse production ie ladder and at the elastic resolution."""
    import jax
    from vsmartmom_tpu.core.inelastic import \
        rt_solve_rrs_fused as jax_rt_solve_rrs_fused
    from vsmartmom_tpu_torch.core.inelastic import rt_solve_rrs_fused
    s = setups["STOKES_I"]
    inputs, config, shifts, w, Zp, Zm, fsc = s["jax"]
    config = dataclasses.replace(config, fused=True, pack=1,
                                 dot_mode="highest", band_block=128)
    # The JAX solve reads VSM_IE_FULLRES when it is traced, so a full-
    # resolution trace must neither reuse nor leave behind a cached one.
    monkeypatch.delenv("VSM_IE_FULLRES", raising=False)
    if fullres:
        monkeypatch.setenv("VSM_IE_FULLRES", "1")
        jax.clear_caches()
    ref = {k: np.asarray(v) for k, v in jax_rt_solve_rrs_fused(
        inputs, config, shifts, w, Zp, Zm, fsc).items()}
    if fullres:
        monkeypatch.delenv("VSM_IE_FULLRES")
        jax.clear_caches()
    out = rt_solve_rrs_fused(s["port"][0], _port_config(config),
                             *s["port"][1], device="cpu",
                             ie_fullres=fullres)
    for k in KEYS:
        assert _rel(out[k].numpy(), ref[k]) <= 2e-5, k


def test_rt_run_inelastic_on_the_cpu():
    """The entry point end to end on the port's own build: the f32 model on
    the CPU takes the plain path and lands on the stored JAX reference."""
    from vsmartmom_tpu_torch.core.inelastic import rt_run_inelastic
    stored = np.load(REF_PATH)
    out = dict(zip(KEYS, rt_run_inelastic(port_model("STOKES_IQU"),
                                          device="cpu")))
    for k in KEYS:
        assert out[k].shape == stored[k].shape
        assert _rel(out[k], stored[k]) <= 2e-5, k
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rt_run_inelastic(port_model("STOKES_I"), mode="VS_0to1",
                         device="cpu")


def test_fscatt_counts_aerosols():
    """The Rayleigh fraction of layer scattering divides by Rayleigh plus
    every aerosol's optical depth, as in JAX (1e-12), on the small RRS
    scene with the small Jacobian scene's Mie aerosol, delta-BGE truncated
    as there, where it falls to ~0.06 in the aerosol layer."""
    from vsmartmom_tpu.core import model as jm
    from vsmartmom_tpu.core.inelastic import inelastic_setup as jax_setup
    from vsmartmom_tpu.scattering.stokes import STOKES_IQU as J_IQU
    from vsmartmom_tpu_torch.core import model as pm
    from vsmartmom_tpu_torch.core.inelastic import inelastic_setup
    from vsmartmom_tpu_torch.flagship import LIN_REF_AEROSOL, LIN_REF_MIE
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_IQU
    ref = np.asarray(jax_setup(jm.model_from_parameters(jm.Parameters(
        surfaces=[jm.SurfaceDescriptor("LambertianSurfaceScalar",
                                       [RRS_REF_ALBEDO])],
        polarization=J_IQU, scattering_params=jm.ScatteringParams(
            rt_aerosols=[jm.RTAerosol(**LIN_REF_AEROSOL)], **LIN_REF_MIE),
        **rrs_ref_params(), truncation="deltaBGE")))[6])
    out = inelastic_setup(pm.model_from_parameters(pm.Parameters(
        surfaces=[pm.SurfaceDescriptor("LambertianSurfaceScalar",
                                       [RRS_REF_ALBEDO])],
        polarization=STOKES_IQU, scattering_params=pm.ScatteringParams(
            rt_aerosols=[pm.RTAerosol(**LIN_REF_AEROSOL)], **LIN_REF_MIE),
        **rrs_ref_params(), truncation="deltaBGE")), device="cpu")[6].numpy()
    assert out.shape == ref.shape == (3, N_SPEC)
    assert ref.min() < 0.1
    assert _rel(out, ref) <= 1e-12


def test_wide_scene_takes_the_plain_rrs_route(monkeypatch):
    """K3 takes K1's widths (N <= 64) with the strategy left automatic (the
    automatic choice made as on the card, ``types.auto_kernel``): a scene
    of N = 39 runs the kernel route with no warning, equal to an explicit
    fused=True run (on the CPU the route runs the plain K1 and K3); a
    scene of N = 66 warns, naming K1, its limit and N, and runs the plain
    rt_solve_rrs, equal to an explicit fused=False run. K3's own guard
    warns above 64 as K1's does."""
    import warnings
    from vsmartmom_tpu_torch.core import model as model_mod
    from vsmartmom_tpu_torch.core.inelastic import rt_run_inelastic
    from vsmartmom_tpu_torch.core.types import kernel_takes_width
    from vsmartmom_tpu_torch.ops.fused_rrs import KERNEL_MAX_N
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_IQU
    monkeypatch.setattr(model_mod, "auto_kernel", lambda dev, ft: True)

    def wide(nstreams, fused=None):
        model = model_mod.model_from_parameters(model_mod.Parameters(
            surfaces=[model_mod.SurfaceDescriptor("LambertianSurfaceScalar",
                                                  [RRS_REF_ALBEDO])],
            polarization=STOKES_IQU, fused=fused,
            **dict(rrs_ref_params(), nstreams=nstreams)))
        model.bands[0].sif_spec = RRS_REF_SIF * np.ones(N_SPEC)
        return model
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = rt_run_inelastic(wide(10), device="cpu")
    for a, b in zip(out, rt_run_inelastic(wide(10, fused=True),
                                          device="cpu")):
        assert np.array_equal(a, b)
    with pytest.warns(UserWarning, match=r"K1 .* N <= 64; this scene has "
                                         r"N = 66"):
        out = rt_run_inelastic(wide(19), device="cpu")
    for a, b in zip(out, rt_run_inelastic(wide(19, fused=False),
                                          device="cpu")):
        assert np.array_equal(a, b)
    assert KERNEL_MAX_N == 64
    assert kernel_takes_width("K3 (csrc/fused_rrs.cu)", KERNEL_MAX_N, 64)
    with pytest.warns(UserWarning, match=r"K3 .* N <= 64; this scene has "
                                         r"N = 65"):
        assert not kernel_takes_width("K3 (csrc/fused_rrs.cu)",
                                      KERNEL_MAX_N, 65)


def make_rrs_ref():
    """R, T, ieR, ieT of the IQU scene from the JAX package on the CPU: the
    f32 model's configuration solved in f64 by the plain rt_solve_rrs."""
    from vsmartmom_tpu.core.inelastic import inelastic_setup, rt_solve_rrs
    (inputs, config, shifts, w, Zp, Zm, fsc,
     _) = inelastic_setup(jax_model("STOKES_IQU"))
    out = rt_solve_rrs(inputs, dataclasses.replace(config, dtype=np.float64),
                       shifts, w, Zp, Zm, fsc)
    return {k: np.asarray(out[k]) for k in KEYS}


def test_stored_rrs_reference_is_current(jax_plain_f64):
    stored = np.load(REF_PATH)
    for k in KEYS:
        assert stored[k].shape == jax_plain_f64[k].shape
        assert _rel(stored[k], jax_plain_f64[k]) <= 1e-12, k


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax
    jax.config.update("jax_platforms", "cpu")
    os.environ.pop("VSM_IE_FULLRES", None)
    np.savez(REF_PATH, **make_rrs_ref())
    print(f"wrote {REF_PATH}")
