"""Configuration format registry + JSON-schema validation.

Counterpart of the JAX package's ``io/formats.py``; Python counterpart of
the reference's IO/Formats.jl (extension-keyed parser registry for
YAML/TOML) and of the schema gate in IO/Parameters.jl: a config dict is
validated against the reference schema, which the port carries as its own
copy (``vsmartmom_tpu_torch/data/vsmartmom-parameters.schema.json``, with
``additionalProperties: false``), before parsing, so typos in section or
key names fail loudly instead of being silently ignored. ``yaml`` and
``jsonschema`` are imported only where a YAML file is read or a dict
validated; ``tomllib`` is in the standard library.
"""

import functools
import json
import os

_SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "..", "data",
                            "vsmartmom-parameters.schema.json")

_format_registry = {}


def register_format(ext: str, parser) -> None:
    """Register ``parser(path) -> dict`` for a file extension ('.yaml')."""
    _format_registry[ext.lower()] = parser


def _load_yaml(path: str) -> dict:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def _load_toml(path: str) -> dict:
    import tomllib
    with open(path, "rb") as f:
        return tomllib.load(f)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


register_format(".yaml", _load_yaml)
register_format(".yml", _load_yaml)
register_format(".toml", _load_toml)
register_format(".json", _load_json)


def load_config(path: str) -> dict:
    """Load a configuration dict from a YAML/TOML/JSON file by extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in _format_registry:
        raise ValueError(f"No parser registered for extension: {ext!r} "
                         f"(known: {sorted(_format_registry)})")
    return _format_registry[ext](path)


@functools.lru_cache(maxsize=1)
def _schema():
    with open(os.path.normpath(_SCHEMA_PATH)) as f:
        return json.load(f)


def validate_config(d: dict) -> None:
    """Validate a config dict against the reference JSON schema.

    Raises ``ValueError`` with the schema error message on failure. The
    schema forbids unknown keys at every level (additionalProperties:false),
    the reference's defense against silently-ignored typos.
    """
    import jsonschema
    try:
        jsonschema.validate(d, _schema())
    except jsonschema.ValidationError as e:
        path = "/".join(str(p) for p in e.absolute_path) or "<root>"
        raise ValueError(
            f"config failed schema validation at {path}: {e.message}") from e
