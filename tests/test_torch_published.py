"""Published-table suites through the port: Natraj & Hovenier (2009),
Siewert (2000) problem IIA, the VLIDORT 2.8.3 solar testers and 6SV1.

The scenes, truth tables (tests/data) and gates are the JAX package's own
suites' (tests/test_natraj.py, test_siewert.py, test_vlidort.py,
test_6sv1.py; the reasons for each gate are written there), run through
the port's plain float64 path on the CPU (``device="cpu"``). One f32 case
runs the VLIDORT vector scene (IQU, N = 36) through the band kernel K1 on
the card against the port's f64 CPU run, at tests/test_float32.py's gates:
3e-3 on I and 5e-3 on Q/U, relative to the I scale.
"""

import os

import numpy as np
import pytest
import torch

from vsmartmom_tpu_torch import (Parameters, SurfaceDescriptor,
                                 model_from_parameters, rt_run)
from vsmartmom_tpu_torch.core.model import ScatteringComponent
from vsmartmom_tpu_torch.scattering.greek import GreekCoefs
from vsmartmom_tpu_torch.scattering.stokes import (STOKES_I, STOKES_IQU,
                                                   STOKES_IQUV)

from port_threads import _one_thread  # noqa: F401  (autouse)

DATA = os.path.join(os.path.dirname(__file__), "data")
F64_EPS = np.finfo(np.float64).eps


def _run(device="cpu", **kw):
    """(model, R, T) of a one-band scene: a black Lambertian floor and the
    Rayleigh reference layer of the suites unless ``kw`` says otherwise;
    ``setup(model)`` injects optical depths before the solve."""
    setup = kw.pop("setup", None)
    args = dict(surfaces=[SurfaceDescriptor("LambertianSurfaceScalar",
                                            [0.0])],
                obs_alt=1000.0, T=np.array([231.62]),
                p=np.array([0.14, 0.22]), depol=0.0)
    args.update(kw)
    model = model_from_parameters(Parameters(**args))
    if setup is not None:
        setup(model)
    R, T = rt_run(model, device=device)
    return model, R, T


# ---- Natraj & Hovenier (2009), tau = 0.5 ----------------------------------

NATRAJ_MU = [0.02, 0.06, 0.10, 0.16, 0.20, 0.28, 0.32, 0.40, 0.52, 0.64,
             0.72, 0.84, 0.92, 0.96, 0.98, 1.00]
NATRAJ_GATES = {"I": 2.5e-4, "Q": 1.6e-3, "U": 1.5e-4}


@pytest.fixture(scope="module")
def natraj():
    def one(phi):
        def tau(model):
            model.tau_rayl[0][:] = 0.5
        _, R, _ = _run(spec_bands=[np.array([1e7 / 360.0,
                                             1e7 / 360.0 + 1.0])],
                       nstreams=11, polarization=STOKES_IQUV,
                       sza=np.rad2deg(np.arccos(0.2)),
                       vza=list(np.rad2deg(np.arccos(NATRAJ_MU))),
                       vaz=[phi] * len(NATRAJ_MU), setup=tau)
        return np.pi * R[:, :, 0]
    return np.stack([one(phi) for phi in np.arange(0.0, 181.0, 30.0)])


@pytest.mark.parametrize("comp", ["I", "Q", "U"])
def test_natraj(natraj, comp):
    """I against its truth; Q and U where |truth| >= 0.01."""
    k = "IQU".index(comp)
    truth = np.load(os.path.join(DATA, "natraj2009_tau05.npz"))[comp]
    m = natraj[:, :, k].T
    mask = np.ones_like(truth, dtype=bool) if comp == "I" \
        else np.abs(truth) >= 0.01
    rel = np.abs(m - truth)[mask] / np.abs(truth)[mask]
    assert rel.max() < NATRAJ_GATES[comp], f"{comp} {rel.max():.2e}"


# ---- Siewert (2000) problem IIA: tau = 1 aerosol slab, VLIDORT truth ------

SIEWERT = np.load(os.path.join(DATA, "siewert2000_IIA.npz"))
SIEWERT_VZA = [0.0001, 25.841932763, 36.869897646, 45.572995999,
               53.130102354, 60.0, 66.421821522, 72.542396876, 78.463040967,
               84.260829523, 89.9999]
SIEWERT_TABLES = [(0.0, 0, "table2", False), (0.0, 1, "table3", True),
                  (90.0, 0, "table4", False), (90.0, 1, "table5", True),
                  (90.0, 2, "table6", True), (90.0, 3, "table7", True),
                  (180.0, 0, "table8", False), (180.0, 1, "table9", True)]


@pytest.fixture(scope="module")
def siewert():
    greek = GreekCoefs(*(SIEWERT[f"greek_{f}"] for f in (
        "alpha", "beta", "gamma", "delta", "epsilon", "zeta")))

    def slab(model):
        model.tau_rayl[0][:] = 0.0
        model.bands[0].aerosols = [ScatteringComponent(
            greek=greek, tau_profile=np.array([1.0]), ssa=0.973527)]

    def one(az):
        _, R, _ = _run(spec_bands=[np.array([18867.92])], nstreams=16,
                       polarization=STOKES_IQUV, sza=53.130102354065,
                       vza=SIEWERT_VZA, vaz=[az] * len(SIEWERT_VZA),
                       setup=slab)
        return np.pi * R[:, :, 0]
    return {az: one(az) for az in (0.0, 90.0, 180.0)}


@pytest.mark.parametrize("az,comp,tname,flip", SIEWERT_TABLES)
def test_siewert_table(siewert, az, comp, tname, flip):
    """TOA upwelling against VLIDORT's table (Q/U/V sign-flipped into the
    Hovenier convention); regularised relative error, floor 1e-2 for Q
    (it crosses zero), 5e-4 otherwise."""
    table, cosines = SIEWERT[tname], SIEWERT["cosines"]
    truth = np.array([table[np.argmin(np.abs(
        cosines + abs(np.cos(np.deg2rad(v))))), 0] for v in SIEWERT_VZA])
    truth = -truth if flip else truth
    atol = 100 * F64_EPS * np.abs(truth).max()
    rel = np.abs(siewert[az][:, comp] - truth) / (np.abs(truth) + atol)
    assert rel.max() < (1e-2 if comp == 1 else 5e-4), f"{rel.max():.2e}"


# ---- VLIDORT 2.8.3 solar testers (cases B and C) --------------------------

VLIDORT = np.load(os.path.join(DATA, "vlidort_solar_tester.npz"))
VLIDORT_NZ, VLIDORT_TASK = 23, 0
VLIDORT_GATE = np.sqrt(1e-3 ** 2 + (300 * np.sqrt(F64_EPS)) ** 2)


def _vlidort_run(sza, raz, pol, greek, ssa, float_type=np.float64,
                 device="cpu"):
    """The 23-layer Rayleigh + gas column with its aerosol over the bottom 6
    layers (tau 0.5, by geometric thickness), VLIDORT's optical depths
    injected."""
    h = np.concatenate([[60.0], VLIDORT["height_km"]])
    n6 = VLIDORT_NZ - 6
    aer = np.zeros(VLIDORT_NZ)
    aer[n6:] = 0.5 / (h[n6] - h[-1]) * (h[n6:-1] - h[n6 + 1:])

    def inject(model):
        band = model.bands[0]
        ext, omg = VLIDORT["molext"], VLIDORT["molomg"]
        band.tau_rayl[:] = (omg * ext)[None, :]
        band.tau_abs[:] = ((1.0 - omg) * ext)[None, :]
        band.aerosols = [ScatteringComponent(greek=greek, tau_profile=aer,
                                             ssa=ssa)]
    _, R, T = _run(spec_bands=[np.array([18867.92, 18867.93])],
                   surfaces=[SurfaceDescriptor(
                       "LambertianSurfaceScalar",
                       [float(VLIDORT["albedo"])])],
                   nstreams=8, polarization=pol, sza=float(sza),
                   vza=[10.0, 20.0, 40.0], vaz=[float(raz)] * 3,
                   T=np.full(VLIDORT_NZ, 231.62),
                   p=np.linspace(0.001, 1013.25, VLIDORT_NZ + 1),
                   depol=0.01072, float_type=float_type, setup=inject,
                   device=device)
    return R, T


def _hg_greek(g=0.8, n_mom=15):
    L = np.arange(n_mom + 1)
    z = np.zeros(n_mom + 1)
    return GreekCoefs(alpha=z, beta=(2 * L + 1.0) * g ** L, gamma=z,
                      delta=z, epsilon=z, zeta=z)


def _p3_greek(n_mom=15):
    z, sl = VLIDORT, slice(0, n_mom + 1)
    return GreekCoefs(alpha=z["p3_a2"][sl], beta=z["p3_a1"][sl],
                      gamma=z["p3_b1"][sl], delta=z["p3_a4"][sl],
                      epsilon=-z["p3_b2"][sl], zeta=z["p3_a3"][sl])


def _vlidort_rel(modeled, truth, scale):
    return np.abs(modeled - truth) / (np.abs(truth) + 100 * F64_EPS * scale)


@pytest.mark.parametrize("i_sza,gate", [(0, VLIDORT_GATE), (1, 1e-2)],
                         ids=["sza35", "sza67"])
def test_vlidort_scalar(i_sza, gate):
    """Case B: Stokes I with an HG aerosol; TOA up and BOA down at three
    view angles, both points of the band equal."""
    R, T = _vlidort_run(VLIDORT["sza_deg"][i_sza], VLIDORT["raz_deg"][0],
                        STOKES_I, _hg_greek(), 0.95)
    truth = VLIDORT["scalar_stokes"]
    scale = max(np.abs(truth[:, 0, 0, VLIDORT_TASK]).max(),
                np.abs(truth[:, 4, 1, VLIDORT_TASK]).max())
    for i_vza in range(3):
        geom = i_sza * 9 + i_vza * 3
        assert _vlidort_rel(R[i_vza, 0, 0], truth[geom, 0, 0, VLIDORT_TASK],
                            scale) < gate
        assert _vlidort_rel(T[i_vza, 0, 0], truth[geom, 4, 1, VLIDORT_TASK],
                            scale) < gate
        assert np.isclose(R[i_vza, 0, 0], R[i_vza, 0, 1], rtol=1e-10)


def test_vlidort_vector():
    """Case C: IQU with the problem III aerosol (Q/U truth sign-flipped);
    U's gate 2.5e-3 (the reference's own published U maximum)."""
    R, T = _vlidort_run(VLIDORT["sza_deg"][0], VLIDORT["vec_raz_deg"][0],
                        STOKES_IQU, _p3_greek(), 0.99999)
    for name, k, sign, gate in (("I", 0, 1.0, VLIDORT_GATE),
                                ("Q", 1, -1.0, VLIDORT_GATE),
                                ("U", 2, -1.0, 2.5e-3)):
        truth = VLIDORT[f"vector_{name}"]
        scale = max(np.abs(truth[:, 0, 0, VLIDORT_TASK]).max(),
                    np.abs(truth[:, 4, 1, VLIDORT_TASK]).max())
        for i_vza in range(3):
            geom = i_vza * 3
            up = sign * truth[geom, 0, 0, VLIDORT_TASK]
            dn = sign * truth[geom, 4, 1, VLIDORT_TASK]
            assert _vlidort_rel(R[i_vza, k, 0], up, scale) < gate, name
            assert _vlidort_rel(T[i_vza, k, 0], dn, scale) < gate, name


# ---- 6SV1 Rayleigh + Lambertian ---------------------------------------------

SIXSV1_VZA = [0.0, 11.4783, 16.2602, 23.0739, 32.8599, 43.9455, 50.2082,
              58.6677, 66.4218, 71.3371, 73.7398, 78.463, 80.7931, 84.2608,
              86.5602, 88.854]
SIXSV1_CASES = [
    # (szas, lambda_nm, tau, albedo)
    ([23.0739, 53.1301, 78.4630], 530, 0.10, 0.0),
    ([0.0001, 36.8699, 66.4218], 530, 0.10, 0.25),
    ([0.0001, 36.8699, 66.4218], 440, 0.25, 0.0),
    ([23.0739, 53.1301, 78.4630], 440, 0.25, 0.25),
    ([23.0739, 53.1301, 78.4630], 360, 0.50, 0.0),
    ([0.0001, 36.8699, 66.4218], 360, 0.50, 0.25),
]


@pytest.mark.parametrize("case_i", range(6))
def test_6sv1_case(case_i):
    """R = pi L / mu0 (the model's ``mu0``) at three SZA, three relative
    azimuths and sixteen VZA against 6SV1: max relative error < 0.006."""
    truth = np.load(os.path.join(DATA, "sixsv1_R_trues.npy"))[case_i]
    szas, lam, tau, rho = SIXSV1_CASES[case_i]

    def set_tau(model):
        model.tau_rayl[0][:] = tau
    worst = 0.0
    for i_s, sza in enumerate(szas):
        for i_a, az in enumerate((180.0, 90.0, 0.0)):
            model, R, _ = _run(
                spec_bands=[np.array([1e7 / lam, 1e7 / lam + 1.0])],
                surfaces=[SurfaceDescriptor("LambertianSurfaceScalar",
                                            [rho])],
                nstreams=11, polarization=STOKES_IQUV, sza=sza,
                vza=SIXSV1_VZA, vaz=[az] * len(SIXSV1_VZA), setup=set_tau)
            refl = np.pi * R[:, 0, 0] / model.mu0
            worst = max(worst, (np.abs(truth[i_s, i_a] - refl)
                                / truth[i_s, i_a]).max())
    assert worst < 0.006, f"case {case_i + 1}: {worst:.4f}"


# ---- f32 through K1 on the card ---------------------------------------------

@pytest.mark.cuda
def test_vlidort_vector_f32_through_k1():
    """Case C's scene at f32 on the card takes the band kernel K1 (once per
    moment up to m_scat) and stays within tests/test_float32.py's gates of
    the port's f64 CPU run: 3e-3 on I (R and T), 5e-3 on Q and U against
    the I scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the band kernel has no CPU mode")
    from vsmartmom_tpu_torch.ops.fused_band import fused_moment
    args = (VLIDORT["sza_deg"][0], VLIDORT["vec_raz_deg"][0], STOKES_IQU,
            _p3_greek(), 0.99999)
    before = fused_moment.launches
    R32, T32 = _vlidort_run(*args, float_type=np.float32, device="cuda")
    assert fused_moment.launches > before
    R64, T64 = _vlidort_run(*args)
    scale = np.abs(R64[:, 0]).max()
    assert np.abs(R32[:, 0] - R64[:, 0]).max() / scale < 3e-3
    assert np.abs(T32[:, 0] - T64[:, 0]).max() / \
        np.abs(T64[:, 0]).max() < 3e-3
    for k in (1, 2):
        assert np.abs(R32[:, k] - R64[:, k]).max() / scale < 5e-3, k
