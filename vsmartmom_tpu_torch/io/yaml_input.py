"""YAML / TOML / JSON configuration parser, compatible with the reference
scene files.

Counterpart of the JAX package's ``io/yaml_input.py``: parses the layout
of the reference's scene files (vSmartMOM.jl config/*.yaml; schema
schemas/vsmartmom-parameters.schema.json; constructor maps
src/IO/Parameters.jl:59-345) into the port's ``Parameters`` dataclass.
The value syntax (Julia constructor strings like
``LambertianSurfaceScalar(0.15)``, band strings like ``"[12987.0]"`` /
``"nu_start:nu_step:nu_end"``) is accepted verbatim. ``yaml`` is imported
only where a YAML file is read. A ``canopy:`` section wraps each band's
surface as the soil of a ``surfaces.canopy.CanopySurface`` (clumping as a
number, a string or a table; ``lai_fractions``; ``include_atm`` with
``canopy_dp``); ``quadrature_type`` ``RadauQuad()`` selects Gauss-Radau
streams.
"""

import ast
import os
import re

import numpy as np

from ..core.model import (AbsorptionParams, Parameters, RTAerosol,
                          ScatteringParams, SurfaceDescriptor)
from ..scattering.stokes import polarization_from_name

_FLOAT_TYPES = {"Float64": np.float64, "Float32": np.float32}


def _eval_ast(node):
    """Recursively evaluate a whitelisted arithmetic AST — no eval()."""
    if isinstance(node, ast.Expression):
        return _eval_ast(node.body)
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return float(node.value)
    if isinstance(node, ast.UnaryOp):
        v = _eval_ast(node.operand)
        if isinstance(node.op, ast.USub):
            return -v
        if isinstance(node.op, ast.UAdd):
            return v
    if isinstance(node, ast.BinOp):
        a, b = _eval_ast(node.left), _eval_ast(node.right)
        if isinstance(node.op, ast.Add):
            return a + b
        if isinstance(node.op, ast.Sub):
            return a - b
        if isinstance(node.op, ast.Mult):
            return a * b
        if isinstance(node.op, ast.Div):
            return a / b
        if isinstance(node.op, ast.Pow):
            return a ** b
    raise ValueError(f"disallowed syntax in numeric expression: "
                     f"{ast.dump(node)[:80]}")


def _eval_number(tok: str) -> float:
    """Evaluate a numeric token that may be a Julia-style arithmetic
    expression like '(1e7/770)' (IO band syntax) — parsed through a
    whitelisted AST walk, never eval()."""
    tok = tok.strip()
    try:
        return float(tok)
    except ValueError:
        pass
    try:
        return float(_eval_ast(ast.parse(tok, mode="eval")))
    except (SyntaxError, ZeroDivisionError) as e:
        raise ValueError(f"not a numeric expression: {tok!r}") from e


def _split_band_range(s: str):
    """Split 'a:b:c' at top-level colons (colons never nest in parens here)."""
    return [tok for tok in s.split(":")]


def _parse_band(spec) -> np.ndarray:
    """Spectral band: '[a b c]' literal, 'start:step:stop' range (numeric
    tokens may be arithmetic expressions), or list."""
    if isinstance(spec, (list, tuple)):
        return np.asarray(spec, dtype=np.float64)
    s = str(spec).strip()
    if s.startswith("["):
        body = s.strip("[]").replace(",", " ")
        return np.asarray([_eval_number(tok) for tok in body.split()],
                          dtype=np.float64)
    if ":" in s:
        parts = [_eval_number(tok) for tok in _split_band_range(s)]
        if len(parts) == 2:
            start, stop = parts
            step = 1.0
        else:
            start, step, stop = parts
        # inclusive endpoint, Julia range semantics
        n = int(np.floor((stop - start) / step + 1e-9)) + 1
        return start + step * np.arange(n)
    return np.asarray([float(s)], dtype=np.float64)


_CTOR_RE = re.compile(r"^\s*(\w+)\s*(?:\{[^}]*\})?\s*\((.*)\)\s*$")


def _parse_ctor(s: str):
    """'Name(a, key=b)' -> (name, [positional args], {kwargs})."""
    match = _CTOR_RE.match(str(s))
    if not match:
        return str(s).strip(), [], {}
    name, body = match.group(1), match.group(2).strip()
    args, kwargs = [], {}

    def parse_val(tok):
        tok = tok.strip()
        if tok in ("true", "false"):
            return tok == "true"
        try:
            return float(tok)
        except ValueError:
            return tok

    if body:
        for tok in body.split(","):
            if "=" in tok:
                key, val = tok.split("=", 1)
                kwargs[key.strip()] = parse_val(val)
            else:
                args.append(parse_val(tok))
    return name, args, kwargs


def _parse_surface(spec) -> SurfaceDescriptor:
    name, args, kwargs = _parse_ctor(spec)
    return SurfaceDescriptor(kind=name, args=args, kwargs=kwargs)


def _expand_env(path: str) -> str:
    """${ENV:VAR} expansion (IO/Parameters.jl:30-51)."""
    return re.sub(r"\$\{ENV:(\w+)\}", lambda m: os.environ.get(m.group(1), ""), path)


def _parse_scattering(sc: dict):
    """Parse the ``scattering:`` block (unicode keys per the reference schema;
    IO/Parameters.jl:496-566)."""
    if not sc:
        return None
    aerosols = []
    for a in sc.get("aerosols", []):
        kwargs = dict(tau_ref=float(a["τ_ref"]))
        has_p = "p₀" in a or "p0" in a
        has_z = "z₀" in a or "z0" in a
        if has_p and has_z:
            raise ValueError("aerosol must specify exactly one of (z₀, σ₀) "
                             "or (p₀, σp) — got both")
        if has_p:
            kwargs["p0"] = float(a.get("p₀", a.get("p0")))
            kwargs["sigma_p"] = float(a.get("σp", a.get("sigma_p")))
        elif has_z:
            # altitude form (reference-preferred, IO/Parameters.jl:495-556):
            # LogNormal(log z₀, σ₀) in height, integrated on the z grid.
            kwargs["z0"] = float(a.get("z₀", a.get("z0")))
            kwargs["sigma_z"] = float(a.get("σ₀", a.get("sigma0")))
        else:
            raise ValueError("aerosol must specify a vertical distribution: "
                             "(z₀, σ₀) altitude-form or (p₀, σp) "
                             "pressure-form")
        if "μ" in a:
            kwargs["mu_log"] = float(np.log(a["μ"]))
            kwargs["sigma_log"] = float(np.log(a["σ"]))
            kwargs["n_r"] = float(a["nᵣ"])
            kwargs["n_i"] = float(a["nᵢ"])
        pf = a.get("phase_function")
        if pf is not None:
            name, args, kw = _parse_ctor(pf)
            if name == "HenyeyGreensteinPhaseFunction":
                kwargs["phase_function_g"] = float(args[0] if args else kw["g"])
                kwargs["ssa"] = float(a.get("ssa", 1.0))
            else:
                raise NotImplementedError(f"phase function {name}")
        aerosols.append(RTAerosol(**kwargs))

    n_ref = sc.get("n_ref")
    if isinstance(n_ref, str):
        n_ref = complex(n_ref.replace("im", "j").replace(" ", ""))
    return ScatteringParams(
        rt_aerosols=aerosols,
        r_max=float(sc.get("r_max", 50.0)),
        nquad_radius=int(sc.get("nquad_radius", 2500)),
        lambda_ref=float(sc.get("λ_ref", 0.55)),
        n_ref=n_ref,
        decomp_type=_parse_ctor(sc.get("decomp_type", "NAI2()"))[0])


def _parse_absorption(ab: dict):
    """Parse the ``absorption:`` block (IO/Parameters.jl; molecules per band,
    vmr dict, broadening/CEF/wing_cutoff). ``par_paths`` is our extension for
    explicit local line files (no artifact downloads in this environment)."""
    if not ab:
        return None
    return AbsorptionParams(
        molecules=[list(m) for m in ab.get("molecules", [])],
        vmr=dict(ab.get("vmr", {})),
        broadening=_parse_ctor(ab.get("broadening", "Voigt()"))[0],
        cef=_parse_ctor(ab.get("CEF",
                               "HumlicekWeidemann32SDErrorFunction()"))[0],
        wing_cutoff=float(ab.get("wing_cutoff", 40.0)),
        par_paths={k: _expand_env(v)
                   for k, v in (ab.get("par_paths") or {}).items()},
        cia_files=[_expand_env(p) for p in (ab.get("cia_files") or [])],
        mtckd_file=_expand_env(ab["mtckd_file"])
        if ab.get("mtckd_file") else "")


def parameters_from_dict(d: dict) -> Parameters:
    rt = d["radiative_transfer"]
    geom = d["geometry"]
    prof = d["atmospheric_profile"]

    spec_bands = [_parse_band(b) for b in rt["spec_bands"]]
    surfaces = [_parse_surface(s) for s in rt["surface"]]

    # A canopy section wraps each per-band surface as soil inside a
    # CanopySurface (reference IO/Parameters.jl:175-220
    # _parse_canopy_section).
    if "canopy" in d:
        c = d["canopy"]
        from ..surfaces.canopy import CanopySurface
        clump = c.get("clumping", 1.0)
        if isinstance(clump, str):
            if clump.lower().replace("-", "_") in ("none", "no",
                                                   "no_clumping", "random"):
                clump = 1.0
            else:
                raise ValueError(f"Unknown canopy clumping string: {clump}")
        elif isinstance(clump, dict):
            kind = clump.get("type", "constant").lower().replace("-", "_")
            if kind in ("none", "no", "no_clumping", "random"):
                clump = 1.0
            elif kind in ("constant", "constant_clumping"):
                clump = float(clump.get("Omega", clump.get("Omega0",
                              clump.get("value", 1.0))))
            else:
                raise ValueError(f"Unsupported canopy clumping: {kind} "
                                 "(Chen-Leblanc clumping is not ported; "
                                 "see surfaces/canopy.py)")
        lg = c.get("leaf_optics_grid")
        soil_spec = c.get("soil", "from_surface")
        wrapped = []
        for surf in surfaces:
            soil = surf if soil_spec == "from_surface" \
                else _parse_surface(soil_spec)
            canopy = CanopySurface(
                soil=soil,
                LAI=float(c.get("LAI", 3.0)),
                n_layers=int(c.get("n_layers", 1)),
                leaf_reflectance=c.get("leaf_reflectance", 0.4),
                leaf_transmittance=c.get("leaf_transmittance", 0.05),
                leaf_optics_grid=None if lg is None else np.asarray(
                    lg, dtype=np.float64),
                grid_unit=str(c.get("grid_unit", "nm")),
                clumping_omega=float(clump),
                lad=str(c.get("LAD", c.get("lad", "spherical"))).lower(),
                lai_fractions=None if c.get("lai_fractions") is None
                else tuple(float(f) for f in c["lai_fractions"]),
                include_atm=bool(c.get("include_atm", False)),
                canopy_dp=None if c.get("canopy_dp") is None
                else float(c["canopy_dp"]))
            wrapped.append(SurfaceDescriptor(
                "CanopySurface", [], {"_surface_obj": canopy}))
        surfaces = wrapped

    pol_name, _, _ = _parse_ctor(rt.get("polarization_type", "Stokes_I()"))
    polarization = polarization_from_name(pol_name)

    if "nstreams" in rt:
        nstreams = int(rt["nstreams"])
    elif "l_trunc" in rt:
        # legacy schema: Ltrunc -> nstreams = (Ltrunc + 2) // 2
        nstreams = (int(rt["l_trunc"]) + 2) // 2
    else:
        raise KeyError("radiative_transfer.nstreams (or legacy l_trunc) required")

    trunc_name, _, _ = _parse_ctor(rt.get("truncation", "AutoTruncation()"))
    quad_name, _, _ = _parse_ctor(rt.get("quadrature_type", "GaussLegQuad()"))
    if quad_name not in ("GaussLegQuad", "RadauQuad"):
        raise ValueError(f"Unknown quadrature_type: {quad_name}")

    float_type = _FLOAT_TYPES[rt.get("float_type", "Float64")]

    vza = list(np.atleast_1d(geom["vza"]).astype(np.float64))
    vaz = list(np.atleast_1d(geom["vaz"]).astype(np.float64))

    q = prof.get("q")
    return Parameters(
        spec_bands=spec_bands,
        surfaces=surfaces,
        nstreams=nstreams,
        polarization=polarization,
        sza=float(geom["sza"]),
        vza=vza,
        vaz=vaz,
        obs_alt=float(geom.get("obs_alt", 0.0)),
        T=np.asarray(prof["T"], dtype=np.float64),
        p=np.asarray(prof["p"], dtype=np.float64),
        q=None if q is None else np.asarray(q, dtype=np.float64),
        profile_reduction=int(prof.get("profile_reduction", -1)),
        depol=float(rt.get("depol", -1)),
        float_type=float_type,
        truncation=trunc_name,
        quadrature=quad_name,
        absorption_params=_parse_absorption(d.get("absorption")),
        scattering_params=_parse_scattering(d.get("scattering")),
    )


def parameters_from_file(path: str, validate: bool = True) -> Parameters:
    """Parameters from a YAML/TOML/JSON scene file (reference
    parameters_from_file, IO/IO.jl:71-106), schema-validated by default
    against the port's copy of the reference JSON schema."""
    from .formats import load_config, validate_config
    d = load_config(_expand_env(path))
    if validate:
        validate_config(d)
    return parameters_from_dict(d)


def parameters_from_yaml(path: str, validate: bool = True) -> Parameters:
    import yaml
    with open(_expand_env(path)) as f:
        d = yaml.safe_load(f)
    if validate:
        from .formats import validate_config
        validate_config(d)
    return parameters_from_dict(d)


def parameters_from_toml(path: str, validate: bool = True) -> Parameters:
    return parameters_from_file(path, validate=validate)
