"""The port's Jacobian run (rt_run_lin, its tangent build and the plain
multitangent kernel K2) against the JAX package.

Scene: ``flagship.lin_ref_model``, the small aerosol scene of
tests/test_linearization.py (3 layers, nstreams 4, IQU, two points near
755 nm, wind 6 Cox-Munk ocean; 7 aerosol parameters + wind) with
delta-BGE truncation and 60 radius nodes, so that its Mie optics build in
seconds; its twin over a 0.2-albedo Lambertian floor (albedo parameter);
and ``flagship.lin_thermal_model``, the Cox-Munk scene with a seeded
per-layer thermal source (K = 2). All solve the f32 model's configuration
(its doubling count and schedule) in f64: that is the stored references'
recipe, and it runs the JAX package once per scene (the thermal scene
here, beside the others, shares their exact Mie tangent compiles). JAX
outputs are converted with ``np.asarray`` before the torch side runs.

Tolerances, relative to max|ref|: 1e-12 for the host build and the
tangents that do not come from the exact Mie tangents (same NumPy
arithmetic in both packages); 1e-9 for those that do (torch and JAX order
the complex Mie recursions' operations differently, and the upward
Riccati-Bessel recursion amplifies the rounding) and for R, T and each
parameter's dR/dT of the f64 plain route; 2e-5 for the plain K2 against the
JAX Pallas kernel in interpret mode at f32.

Also holds the stored cross-framework references
``vsmartmom_tpu_torch/data/lin_ref_f64.npz`` (R, T, dR, dT of the Cox-Munk
scene) and ``data/lin_thermal_ref_f64.npz`` (the thermal scene), which the
chip smoke test compares the port's kernel path against: tests recompute
them so they cannot go stale. ``python tests/test_torch_lin.py`` rewrites
the first, ``python tests/test_torch_thermal.py`` the second.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from port_threads import _one_thread  # noqa: F401  (autouse)

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from vsmartmom_tpu_torch.flagship import (LIN_REF_AEROSOL, LIN_REF_MIE,
                                          lin_ref_model, lin_ref_params,
                                          lin_thermal_b, lin_thermal_model)

KEYS = ("R", "T", "dR", "dT")
SURFACES = ("coxmunk", "lambertian")
#: The JAX runs: each surface, and the Cox-Munk scene with its thermal
#: source.
SCENES = SURFACES + ("thermal",)
DATA = Path(__file__).resolve().parents[1] / "vsmartmom_tpu_torch" / "data"
REF_PATH = DATA / "lin_ref_f64.npz"
THERMAL_REF_PATH = DATA / "lin_thermal_ref_f64.npz"
#: The aerosol-height parameters. Their f32 dR on this 3-layer scene is
#: ~1e-6 of the others' and lands within ~1.3e-3 of its own scale of the
#: f64 reference on every route; HEIGHT_GATE still fails a 1% error in it.
HEIGHT_PARAMS = ("_p0", "_sigma_p")
HEIGHT_GATE = 5e-3


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def solve_in_f64(model):
    """``model`` with its band build's solver dtype set to float64: the f32
    model's configuration solved in f64 (works on both packages' models)."""
    build = model.build_band

    def build_f64(*args, **kw):
        inputs, config = build(*args, **kw)
        return inputs, dataclasses.replace(config, dtype=np.float64)
    model.build_band = build_f64
    return model


def jax_model(surface="coxmunk"):
    """The JAX package's model of ``flagship.lin_ref_model``, from the same
    keywords."""
    from vsmartmom_tpu import model_from_parameters
    from vsmartmom_tpu.core.model import (Parameters, RTAerosol,
                                          ScatteringParams, SurfaceDescriptor)
    from vsmartmom_tpu.scattering.stokes import STOKES_IQU
    if surface == "coxmunk":
        surf = SurfaceDescriptor("CoxMunkSurface", [], {"wind_speed": 6.0})
    else:
        surf = SurfaceDescriptor("LambertianSurfaceScalar", [0.2])
    return model_from_parameters(Parameters(
        surfaces=[surf], polarization=STOKES_IQU,
        scattering_params=ScatteringParams(
            rt_aerosols=[RTAerosol(**LIN_REF_AEROSOL)], **LIN_REF_MIE),
        **lin_ref_params()))


def jax_rt_run_lin(surface, thermal=False):
    """JAX rt_run_lin (its plain jvp route on the CPU) of the scene, with
    the band build and tangents it ran on, as numpy; ``thermal`` adds the
    seeded thermal source of ``flagship.lin_thermal_model``."""
    from vsmartmom_tpu.core.linearization import (build_tangent_inputs,
                                                  default_layout, rt_run_lin)
    model = solve_in_f64(jax_model(surface))
    if thermal:
        model.bands[0].thermal_b = lin_thermal_b(model.profile.nz,
                                                 model.bands[0].n_spec)
    layout = default_layout(model)
    inputs, config, tangents = build_tangent_inputs(model, 0, layout)
    out = dict(zip(KEYS, (np.asarray(x) for x in rt_run_lin(model,
                                                             layout=layout))))
    out["inputs"] = {f: np.asarray(getattr(inputs, f))
                     for f in inputs._fields}
    out["config"] = config
    out["tangents"] = [{f: np.asarray(getattr(t, f)) for f in t._fields}
                       for t in tangents]
    return out


@pytest.fixture(scope="module")
def jax_lin():
    out = {s: jax_rt_run_lin(s) for s in SURFACES}
    out["thermal"] = jax_rt_run_lin("coxmunk", thermal=True)
    return out


@pytest.fixture(scope="module")
def port_build():
    """The port's band build and tangents of the Cox-Munk scene (CPU)."""
    from vsmartmom_tpu_torch.core.linearization import (build_tangent_inputs,
                                                        default_layout)
    model = lin_ref_model()
    return (model,) + build_tangent_inputs(model, 0, default_layout(model),
                                           device="cpu")


def test_layout():
    from vsmartmom_tpu_torch import ParameterLayout, default_layout
    layout = default_layout(lin_ref_model())
    assert layout == ParameterLayout(1, (), ("wind_speed",))
    assert layout.n_total == 8 and layout.surface_index() == 7
    assert layout.names()[:2] == ["aer0_tau_ref", "aer0_n_r"]
    assert default_layout(lin_ref_model(surface="lambertian")) \
        .surface_params == ("albedo",)


def test_build_band_matches_jax(jax_lin, port_build):
    """The port's band build of the aerosol scene (Mie optics, delta-BGE,
    delta-M, the Z moments from one set of Legendre tables) against the
    JAX one, field by field, and the configuration."""
    _, inputs, config, _ = port_build
    ref = jax_lin["coxmunk"]["inputs"]
    ref_config = jax_lin["coxmunk"]["config"]
    for f in inputs._fields:
        assert _rel(getattr(inputs, f).numpy(), ref[f]) <= 1e-12, f
    for f in ("N", "nz", "ndoubl", "m_max", "m_scat", "ns_sched", "ns_inter"):
        assert getattr(config, f) == getattr(ref_config, f), f
    assert inputs.Z_pp.shape[1] == 2 and config.m_scat < config.m_max


def test_tangent_inputs_match_jax(jax_lin, port_build):
    """One SolverInputs tangent per parameter: the exact-Mie ones
    (n_r, n_i, r_mode, sigma_g) within 1e-9, the others within 1e-12."""
    _, _, _, tangents = port_build
    ref = jax_lin["coxmunk"]["tangents"]
    assert len(tangents) == len(ref) == 8
    for q, (t, r) in enumerate(zip(tangents, ref)):
        tol = 1e-9 if q in (1, 2, 3, 4) else 1e-12
        for f in t._fields:
            a = getattr(t, f).numpy()
            if np.abs(r[f]).max() == 0:
                assert np.abs(a).max() == 0, (q, f)
            else:
                assert _rel(a, r[f]) <= tol, (q, f)


def test_fd_mie_tangents_match_jax(port_build):
    """The central-difference Mie route (mie_method="fd") of both packages
    on the same NumPy host build: 1e-12."""
    from vsmartmom_tpu.core.linearization import \
        _aerosol_tangents as jax_aerosol_tangents
    from vsmartmom_tpu_torch.core.linearization import _aerosol_tangents
    out = _aerosol_tangents(port_build[0], 0, 0, mie_method="fd")
    ref = jax_aerosol_tangents(jax_model(), 0, 0, mie_method="fd")
    for p in ("n_r", "n_i", "r_mode", "sigma_g", "p0", "sigma_p"):
        assert _rel(out[p]["tau_profile"], ref[p]["tau_profile"]) <= 1e-12
        assert abs(out[p]["ssa"] - ref[p]["ssa"]) <= 1e-12 * max(
            1.0, abs(ref[p]["ssa"]))
        if "greek" in ref[p]:
            for f in ("alpha", "beta", "gamma", "delta", "epsilon", "zeta"):
                assert _rel(getattr(out[p]["greek"], f),
                            getattr(ref[p]["greek"], f)) <= 1e-12, (p, f)


@pytest.mark.parametrize("surface", SCENES)
def test_rt_run_lin_matches_jax(jax_lin, surface):
    """The entry point on the plain jvp route in f64 against JAX's
    rt_run_lin: R, T and each parameter's dR, dT within 1e-9 (the thermal
    scene: a K = 2 solve, 20% of its R from the thermal source)."""
    from vsmartmom_tpu_torch import rt_run_lin
    model = solve_in_f64(lin_thermal_model() if surface == "thermal"
                         else lin_ref_model(surface=surface))
    out = dict(zip(KEYS, rt_run_lin(model, device="cpu")))
    ref = jax_lin[surface]
    assert ref["config"].n_sources == (2 if surface == "thermal" else 1)
    assert out["dR"].shape == ref["dR"].shape == (2, 3, 2, 8)
    for k in ("R", "T"):
        assert _rel(out[k], ref[k]) <= 1e-9, k
    for k in ("dR", "dT"):
        for q in range(8):
            assert _rel(out[k][..., q], ref[k][..., q]) <= 1e-9, (k, q)


def test_multitangent_route_matches_jvp_route(port_build):
    """rt_solve_multitangent (the plain K2 on the CPU) against the jvp route
    through rt_solve, both in f64, with converged Newton-Schulz inverses
    (the default schedule): 1e-9 per parameter."""
    from vsmartmom_tpu_torch.core.linearization import rt_solve_jvp
    from vsmartmom_tpu_torch.ops.fused_lin import (fused_moment_multitangent,
                                                   rt_solve_multitangent)
    _, inputs, config, tangents = port_build
    config = dataclasses.replace(config, dtype=np.float64, ns_sched=(),
                                 ns_inter=6)
    before = fused_moment_multitangent.launches
    out = rt_solve_multitangent(inputs, tangents, dataclasses.replace(
        config, fused=True), "cpu")
    assert fused_moment_multitangent.launches == before     # CPU: plain K2
    ref = rt_solve_jvp(inputs, tangents, config, "cpu")
    for k, a, b in zip(KEYS, out, ref):
        if k in ("R", "T"):
            assert _rel(a, b) <= 1e-9, k
        else:
            for q in range(8):
                assert _rel(a[q], b[q]) <= 1e-9, (k, q)


def test_moment_multitangent_reference_matches_jax_kernel():
    """The plain K2 (forward-mode AD of the plain moment body) against the
    JAX multitangent Pallas kernel in interpret mode on small synthetic
    operands (N = 6, nz = 2, C = 2, P = 2, a short schedule with a seed-only
    step), both fed by their own band_operands prep and its tangents: f32,
    2e-5 of max|ref| per output."""
    import jax
    import jax.numpy as jnp
    from vsmartmom_tpu.ops.fused_band import _geom_tables
    from vsmartmom_tpu.ops.fused_band import band_operands as jax_prep
    from vsmartmom_tpu.ops.fused_lin import fused_moment_multitangent as jax_mt
    from vsmartmom_tpu_torch.ops.fused_band import band_operands
    from vsmartmom_tpu_torch.ops.fused_lin import (
        moment_multitangent_reference, operand_tangents)

    rng = np.random.default_rng(7)
    nz, C, s, ns, nq, P = 2, 2, 3, 2, 3, 2
    N, ndoubl, sched, ns_inter = ns * nq, 3, (0, 1, 2), 2
    qp = np.tile(np.array([0.2, 0.55, 0.9])[:, None], (1, ns)).ravel()
    wct = np.tile(np.array([0.3, 0.4, 0.3])[:, None], (1, ns)).ravel()
    d_vec = np.tile(np.array([1.0, 1.0]), nq)
    is_I = (np.arange(N) % ns == 0).astype(float)
    in_blk = ((np.arange(N) >= 2) & (np.arange(N) < 4)).astype(float)
    prim = dict(Z_pp=rng.uniform(0.1, 1, (C, N, N)),
                Z_mp=rng.uniform(0.1, 1, (C, N, N)),
                tau=rng.uniform(0.05, 0.3, (nz, s)),
                scat_w=rng.uniform(0.01, 0.04, (nz, C, s)),
                F0=rng.uniform(0.5, 1, (ns, s)))
    tan = {k: rng.normal(size=(P,) + v.shape) * 0.1 * np.abs(v).mean()
           for k, v in prim.items()}
    mu0 = float(qp[2])

    def precursors(tau, qp_x, cat, cumsum, expm1, exp):
        dtau = tau / 2.0 ** ndoubl
        tau_sum = cat([tau[:1] * 0, cumsum(tau)[:-1]])
        return (expm1(-dtau[:, :, None] / qp_x[None, None, :]),
                expm1(-dtau / mu0), exp(-tau_sum / mu0), exp(-dtau / mu0))

    def jprep(Z_pp, Z_mp, tau, scat_w, F0):
        pre = precursors(tau, jnp.asarray(qp, jnp.float32), jnp.concatenate,
                         lambda x: jnp.cumsum(x, axis=0), jnp.expm1, jnp.exp)
        return jax_prep(Z_pp, Z_mp, tau, scat_w, *pre,
                        jnp.zeros_like(tau), F0, jnp.asarray(qp, jnp.float32),
                        jnp.asarray(d_vec, jnp.float32), jnp.asarray(is_I),
                        jnp.asarray(in_blk), ndoubl=ndoubl, pack=1,
                        n_stokes=ns, i_mu0_start=2, n_sources=1)
    f32 = jnp.float32
    jprim = [jnp.asarray(prim[k], f32) for k in prim]
    ops, lin = jax.linearize(jprep, *jprim)
    dops = [lin(*[jnp.asarray(tan[k][q], f32) for k in tan])
            for q in range(P)]
    geom = _geom_tables(jnp.asarray(qp, f32), jnp.asarray(wct, f32),
                        jnp.asarray(d_vec, f32), 1, f32)
    ref_p, ref_t = jax_mt(ops, dops, geom, jnp.asarray(qp, f32), nz=nz,
                          ns_sched=sched, ns_inter=ns_inter, ndoubl=ndoubl,
                          block=8, interpret=True)
    ref_p = [np.asarray(x) for x in ref_p]
    ref_t = [np.asarray(x) for x in ref_t]

    t32 = torch.float32

    def tprep(Z_pp, Z_mp, tau, scat_w, F0):
        th = [torch.as_tensor(x, dtype=t32) for x in (qp, wct, d_vec, is_I,
                                                      in_blk)]
        pre = precursors(tau, th[0], torch.cat,
                         lambda x: torch.cumsum(x, dim=0), torch.expm1,
                         torch.exp)
        return band_operands(Z_pp, Z_mp, tau, scat_w, *pre,
                             torch.zeros_like(tau),
                             F0, th[0], th[1], th[2], th[3], th[4],
                             ndoubl=ndoubl, n_stokes=ns, i_mu0_start=2,
                             n_sources=1)
    tprim = tuple(torch.as_tensor(prim[k], dtype=t32) for k in prim)
    t_ops = tprep(*tprim)
    t_dops = operand_tangents(tprep, tprim, tuple(
        torch.as_tensor(tan[k], dtype=t32) for k in tan))
    out_p, out_t = moment_multitangent_reference(t_ops, t_dops, sched,
                                                 ns_inter)
    for a, b in zip(out_p, ref_p):
        assert _rel(a.reshape(b.shape).numpy(), b) <= 2e-5
    for a, b in zip(out_t, ref_t):
        assert np.abs(b).max() > 0
        assert _rel(a.reshape(b.shape).numpy(), b) <= 2e-5


def test_rt_run_lin_on_the_cpu():
    """The entry point end to end on the port's own build: the f32 model on
    the CPU takes the plain jvp route and lands on the stored JAX
    reference (its configuration in f64): R 1e-4, each parameter's dR
    2e-4 of its own max, the aerosol height's HEIGHT_GATE, which a 1%
    error in it exceeds; the fused thermal scene (the plain K2 at K = 2 on
    the CPU) runs and matches the jvp route: R and each parameter's dR
    2e-5 of their max, dT 2e-5 of the stack's."""
    from vsmartmom_tpu_torch import default_layout, rt_run_lin
    stored = np.load(REF_PATH)
    out = dict(zip(KEYS, rt_run_lin(lin_ref_model(), device="cpu")))
    for k in KEYS:
        assert out[k].shape == stored[k].shape and np.isfinite(out[k]).all()
    assert _rel(out["R"], stored["R"]) <= 1e-4
    names = default_layout(lin_ref_model()).names()
    for q, name in enumerate(names):
        err = _rel(out["dR"][..., q], stored["dR"][..., q])
        if name.endswith(HEIGHT_PARAMS):
            assert err <= HEIGHT_GATE, name
            assert _rel(1.01 * out["dR"][..., q],
                        stored["dR"][..., q]) > HEIGHT_GATE, name
        else:
            assert err <= 2e-4, name
    model = lin_thermal_model()
    model.params.fused = True
    fused = dict(zip(KEYS, rt_run_lin(model, device="cpu")))
    model.params.fused = False
    plain = dict(zip(KEYS, rt_run_lin(model, device="cpu")))
    assert _rel(fused["R"], plain["R"]) <= 2e-5
    assert _rel(fused["dT"], plain["dT"]) <= 2e-5
    for q in range(len(names)):
        assert _rel(fused["dR"][..., q], plain["dR"][..., q]) <= 2e-5, q


def make_lin_ref():
    """R, T, dR, dT of the Cox-Munk scene from the JAX package on the CPU."""
    out = jax_rt_run_lin("coxmunk")
    return {k: out[k] for k in KEYS}


@pytest.mark.parametrize("scene,path", [("coxmunk", REF_PATH),
                                        ("thermal", THERMAL_REF_PATH)],
                         ids=["lin", "thermal"])
def test_stored_lin_reference_is_current(jax_lin, scene, path):
    stored = np.load(path)
    for k in KEYS:
        assert stored[k].shape == jax_lin[scene][k].shape
        assert _rel(stored[k], jax_lin[scene][k]) <= 1e-12, k


def test_wide_scene_takes_the_jvp_route(monkeypatch):
    """A scene wider than K2 takes (52 < N <= 64: K1 takes it, so the band
    path is picked) with the strategy left automatic: rt_run_lin warns,
    naming K2, its limit and N, and runs the jvp route, equal to an
    explicit fused=False run. The automatic choice is made as on the card
    (``types.auto_kernel``); on the CPU the kernel route would run the
    plain K2, which differs from the jvp route in rounding."""
    from vsmartmom_tpu_torch import rt_run_lin
    from vsmartmom_tpu_torch.core import model as model_mod
    model = _wide_model()
    monkeypatch.setattr(model_mod, "auto_kernel", lambda dev, ft: True)
    with pytest.warns(UserWarning, match=r"K2 .* N <= 52; this scene has "
                                         r"N = 60"):
        out = rt_run_lin(model, device="cpu")
    model.params.fused = False
    for a, b in zip(out, rt_run_lin(model, device="cpu")):
        assert np.array_equal(a, b)


def _wide_model():
    """A Rayleigh column over a 0.1-albedo floor, IQUV at nstreams 12
    (N = 60 with the sun's and view nodes), 2 layers, 2 points, f32: one
    Jacobian parameter (albedo)."""
    from vsmartmom_tpu_torch import Parameters, SurfaceDescriptor
    from vsmartmom_tpu_torch import model_from_parameters
    from vsmartmom_tpu_torch.scattering.stokes import STOKES_IQUV
    return model_from_parameters(Parameters(
        spec_bands=[np.array([13000.0, 13000.5])],
        surfaces=[SurfaceDescriptor("LambertianSurfaceScalar", [0.1])],
        nstreams=12, polarization=STOKES_IQUV, sza=40.0, vza=[10.0, 45.0],
        vaz=[30.0, 150.0], obs_alt=0.0, T=np.array([250.0, 280.0]),
        p=np.array([300.0, 700.0, 1013.0]), depol=0.0,
        float_type=np.float32))


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    np.savez(REF_PATH, **make_lin_ref())
    print(f"wrote {REF_PATH}")
