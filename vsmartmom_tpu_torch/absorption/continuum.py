"""Continuum absorption: HITRAN CIA and the MT_CKD H2O continuum.

Counterpart of the JAX package's ``absorption/continuum.py`` (reference
cia.jl, HITRAN collision-induced absorption, Eq. (3): alpha =
sigma_AB(nu, T) n_A n_B; mtckd.jl, the AER MT_CKD v4 water-vapour
self + foreign continuum with the LBLRTM radiation-term convention).

Both are model-build physics in host float64 NumPy, vectorized over the
spectral grid, as in the JAX package: sigma_CIA values are ~1e-44..1e-46
cm^5/molec^2, below f32's smallest normal, so everything stays f64 until
the final accumulation into tau_abs. ``load_mtckd`` reads NetCDF-3 with
``scipy.io.netcdf_file`` and imports ``h5py`` only for a NetCDF-4 (HDF5)
file.
"""

from dataclasses import dataclass

import numpy as np

K_B = 1.380649e-23          # J/K
VMR_O2_DEFAULT = 0.20946    # USS dry-air defaults (cia.jl:15-16)
VMR_N2_DEFAULT = 0.78084
MTCKD_C2 = 1.4388           # cm K, radiation constant 2 (mtckd.jl:23)


# ---------------------------------------------------------------------------
# CIA
# ---------------------------------------------------------------------------

@dataclass
class CIABlock:
    formula: str
    T: float
    nu: np.ndarray
    sigma: np.ndarray       # cm^5 / molec^2


@dataclass
class CIATable:
    """Pre-interpolated sigma(nu_model, T_block) table for one collision pair
    (cia.jl:26-39)."""
    pair: str
    species_a: str
    species_b: str
    Ts: np.ndarray          # ascending block temperatures
    sigma_nuT: np.ndarray   # (n_nu_grid, n_T)


def _split_pair(formula: str):
    parts = formula.strip().split("-")
    if len(parts) < 2:
        raise ValueError(f'CIA pair formula "{formula}" not recognised '
                         f'(expected "A-B")')
    return parts[0], parts[1]


def parse_cia_file(path: str) -> list:
    """Read a HITRAN .cia file: fixed-width header (formula cols 1-20,
    n_pts cols 41-47, T cols 48-54) followed by n_pts (nu sigma) lines
    (cia.jl:41-73)."""
    blocks = []
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        header = lines[i].rstrip("\n")
        i += 1
        if len(header) < 54 or not header.strip():
            continue
        formula = header[0:20].strip()
        n_pts = int(header[40:47].strip())
        T_K = float(header[47:54].strip())
        data = np.array([lines[i + k].split()[:2] for k in range(n_pts)],
                        dtype=np.float64)
        i += n_pts
        blocks.append(CIABlock(formula, T_K, data[:, 0], data[:, 1]))
    return blocks


def _interp_block(nu_grid: np.ndarray, nu_blk: np.ndarray,
                  sigma_blk: np.ndarray) -> np.ndarray:
    """Linear interpolation of one block onto the model grid, zero outside
    the block's range (cia.jl:100-121)."""
    out = np.interp(nu_grid, nu_blk, sigma_blk,
                    left=sigma_blk[0], right=sigma_blk[-1])
    inside = (nu_grid >= nu_blk[0]) & (nu_grid <= nu_blk[-1])
    return np.where(inside, out, 0.0)


def build_cia_table(blocks: list, nu_grid) -> CIATable:
    """Project all blocks onto nu_grid grouped by block temperature
    (cia.jl:75-97)."""
    if not blocks:
        raise ValueError("build_cia_table: no blocks")
    pair = blocks[0].formula
    a, b = _split_pair(pair)
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    Ts = np.array(sorted({blk.T for blk in blocks}))
    sigma = np.zeros((len(nu_grid), len(Ts)))
    for jt, T_pick in enumerate(Ts):
        for blk in blocks:
            if blk.T == T_pick:
                contrib = _interp_block(nu_grid, blk.nu, blk.sigma)
                sigma[:, jt] = np.where(contrib != 0.0, contrib,
                                        sigma[:, jt])
    return CIATable(pair, a, b, Ts, sigma)


def load_cia_table(path: str, nu_grid) -> CIATable:
    return build_cia_table(parse_cia_file(path), nu_grid)


def cia_sigma_at_T(table: CIATable, T_layer: float) -> np.ndarray:
    """sigma(nu_grid, T_layer) by linear interpolation in T with constant
    extrapolation (cia.jl:123-144)."""
    Ts = table.Ts
    if T_layer <= Ts[0]:
        return table.sigma_nuT[:, 0]
    if T_layer >= Ts[-1]:
        return table.sigma_nuT[:, -1]
    j = int(np.searchsorted(Ts, T_layer))
    w = (T_layer - Ts[j - 1]) / (Ts[j] - Ts[j - 1])
    return (1.0 - w) * table.sigma_nuT[:, j - 1] + w * table.sigma_nuT[:, j]


def _layer_vmr(species: str, vmr: dict, iz: int) -> float:
    if species in vmr:
        v = np.atleast_1d(np.asarray(vmr[species], dtype=np.float64))
        return float(v[min(iz, v.size - 1)])
    if species == "O2":
        return VMR_O2_DEFAULT
    if species == "N2":
        return VMR_N2_DEFAULT
    raise ValueError(f'CIA: no vmr for "{species}" and no default defined')


def compute_tau_cia(table: CIATable, profile, vmr: dict) -> np.ndarray:
    """CIA optical depth tau[nu, layer] = sigma(nu,T) n_A n_B dz
    (cia.jl:147-181). profile.p_full in hPa, dz in m."""
    nz = profile.nz
    n_nu = table.sigma_nuT.shape[0]
    tau = np.zeros((n_nu, nz))
    for iz in range(nz):
        T = float(profile.T[iz])
        sigma = cia_sigma_at_T(table, T)
        # molec/cm^3: hPa -> Pa (x100), m^-3 -> cm^-3 (x1e-6)
        n_air = float(profile.p_full[iz]) * 1e2 / (K_B * T) * 1e-6
        v_a = _layer_vmr(table.species_a, vmr, iz)
        v_b = _layer_vmr(table.species_b, vmr, iz)
        dz_cm = float(profile.dz[iz]) * 100.0
        tau[:, iz] = sigma * (v_a * v_b * n_air * n_air * dz_cm)
    return tau


# ---------------------------------------------------------------------------
# MT_CKD H2O continuum
# ---------------------------------------------------------------------------

@dataclass
class MTCKDTable:
    """AER absco-ref_wv-mt-ckd.nc reference table (mtckd.jl:25-40)."""
    nu: np.ndarray          # cm^-1, ascending (uniform 10 cm^-1 native)
    C_self: np.ndarray      # cm^2/molec/cm^-1 at T_ref
    C_for: np.ndarray
    self_texp: np.ndarray
    p_ref: float            # hPa
    T_ref: float            # K


def load_mtckd(path: str) -> MTCKDTable:
    """Read the AER-distributed absco-ref_wv-mt-ckd.nc (mtckd.jl:57-71):
    NetCDF-3 through ``scipy.io.netcdf_file``, NetCDF-4 (an HDF5 file)
    through ``h5py``, chosen by the file's signature."""
    names = ["wavenumbers", "self_absco_ref", "for_absco_ref", "self_texp",
             "ref_press", "ref_temp"]
    with open(path, "rb") as f:
        netcdf3 = f.read(3) == b"CDF"
    if netcdf3:
        from scipy.io import netcdf_file
        with netcdf_file(path, "r", mmap=False) as nc:
            vals = {n: np.asarray(nc.variables[n][...], dtype=np.float64)
                    for n in names}
    else:
        import h5py
        with h5py.File(path, "r") as f:
            vals = {n: np.asarray(f[n][...], dtype=np.float64)
                    for n in names}
    return MTCKDTable(vals["wavenumbers"], vals["self_absco_ref"],
                      vals["for_absco_ref"], vals["self_texp"],
                      float(np.ravel(vals["ref_press"])[0]),
                      float(np.ravel(vals["ref_temp"])[0]))


@dataclass
class MTCKDBand:
    """Per-band cache of coefficients on the model grid (mtckd.jl:42-53)."""
    C_self: np.ndarray
    C_for: np.ndarray
    texp: np.ndarray
    p_ref: float
    T_ref: float


def build_mtckd_band(table: MTCKDTable, nu_grid) -> MTCKDBand:
    """Interpolate onto nu_grid; zero outside the table's range
    (mtckd.jl:73-103)."""
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    inside = (nu_grid >= table.nu[0]) & (nu_grid <= table.nu[-1])

    def interp(y):
        return np.where(inside, np.interp(nu_grid, table.nu, y), 0.0)

    return MTCKDBand(interp(table.C_self), interp(table.C_for),
                     interp(table.self_texp), table.p_ref, table.T_ref)


def compute_tau_h2o_continuum(band, nu_grid, profile,
                              vmr_h2o) -> np.ndarray:
    """MT_CKD self+foreign continuum tau[nu, layer] (mtckd.jl:105-146):

        sigma_self = C_self(nu) radterm (p_h2o/p_ref) (T_ref/T)^texp(nu)
        sigma_for  = C_for(nu)  radterm (p_dry/p_ref)
        radterm    = nu tanh(c2 nu / 2T)
        tau        = (sigma_self + sigma_for) n_h2o dz
    """
    if isinstance(band, MTCKDTable):
        band = build_mtckd_band(band, nu_grid)
    nu = np.asarray(nu_grid, dtype=np.float64)
    nz = profile.nz
    tau = np.zeros((len(nu), nz))
    v = np.atleast_1d(np.asarray(vmr_h2o, dtype=np.float64))
    for iz in range(nz):
        T = float(profile.T[iz])
        P = float(profile.p_full[iz])
        v_h = float(v[min(iz, v.size - 1)])
        n_air = P * 1e2 / (K_B * T) * 1e-6
        n_h2o = v_h * n_air
        p_h2o = v_h * P
        p_dry = P - p_h2o
        dz_cm = float(profile.dz[iz]) * 100.0
        radterm = nu * np.tanh(MTCKD_C2 * nu / (2.0 * T))
        sigma_self = (band.C_self * radterm * (p_h2o / band.p_ref)
                      * (band.T_ref / T) ** band.texp)
        sigma_for = band.C_for * radterm * (p_dry / band.p_ref)
        tau[:, iz] = (sigma_self + sigma_for) * n_h2o * dz_cm
    return tau
