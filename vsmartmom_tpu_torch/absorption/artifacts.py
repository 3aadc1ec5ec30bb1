"""HITRAN line files: a local registry with SHA-256 provenance.

Counterpart of the JAX package's ``absorption/artifacts.py`` (reference
Artifacts/{hitran_api,hitran_preferences,artifact_helper}.jl). The
reference fetches .par files from hitran.org and caches them with SHA-256
provenance; this registry adopts files the user supplies
(``register_par``) into its own scratch cache, and every lookup checks the
stored SHA-256, so a swapped or truncated line file fails loudly instead
of changing cross sections.

The cache is ``$VSM_TORCH_HITRAN_DIR/<edition>`` (default
``~/.cache/vsmartmom_tpu_torch/hitran/<edition>``), its own, apart from the
JAX package's.

API (the reference's names):
  set_hitran_edition / get_hitran_edition    edition switching
  register_par(molecule, path)               adopt a local .par into cache
  hitran_is_cached(molecule)                 cache probe
  artifact(molecule)                         path lookup (raises with a
                                             remediation hint if absent)
  hitran_provenance(molecule)                dict with path/sha256/size
"""

import hashlib
import json
import os
import shutil

_DEFAULT_EDITION = "local"
_state = {"edition": os.environ.get("VSM_HITRAN_EDITION", _DEFAULT_EDITION)}


def _scratch_dir() -> str:
    root = os.environ.get("VSM_TORCH_HITRAN_DIR",
                          os.path.join(os.path.expanduser("~"), ".cache",
                                       "vsmartmom_tpu_torch", "hitran"))
    path = os.path.join(root, _state["edition"])
    os.makedirs(path, exist_ok=True)
    return path


def set_hitran_edition(edition: str) -> None:
    """Switch the active HITRAN edition (reference hitran_preferences.jl:
    editions select independent cache subdirectories)."""
    _state["edition"] = str(edition)


def get_hitran_edition() -> str:
    return _state["edition"]


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _paths(molecule: str):
    d = _scratch_dir()
    return (os.path.join(d, f"{molecule}.par"),
            os.path.join(d, f"{molecule}.meta.json"))


def register_par(molecule: str, path: str, copy: bool = True) -> str:
    """Adopt a local .par file into the cache with SHA-256 provenance
    (the zero-egress analogue of the reference's fetch_hitran_data)."""
    par, meta = _paths(molecule)
    if copy:
        shutil.copyfile(path, par)
    else:
        par = os.path.abspath(path)
    record = {"molecule": molecule, "source": os.path.abspath(path),
              "path": par, "sha256": _sha256(par),
              "size": os.path.getsize(par),
              "edition": _state["edition"]}
    with open(meta, "w") as f:
        json.dump(record, f, indent=1)
    return par


def hitran_is_cached(molecule: str) -> bool:
    par, meta = _paths(molecule)
    return os.path.isfile(par) and os.path.isfile(meta)


def hitran_provenance(molecule: str) -> dict:
    _, meta = _paths(molecule)
    with open(meta) as f:
        return json.load(f)


def artifact(molecule: str, verify: bool = True) -> str:
    """Resolve the cached .par path for ``molecule``; verifies the stored
    SHA-256 on every lookup (artifact_helper.jl provenance contract).

    Raises FileNotFoundError with a remediation hint when absent — the
    reference would download here; this environment cannot.
    """
    par, meta = _paths(molecule)
    if not (os.path.isfile(par) and os.path.isfile(meta)):
        raise FileNotFoundError(
            f"No cached HITRAN data for {molecule!r} (edition "
            f"{_state['edition']!r}). This build is zero-egress: obtain the "
            f".par file and call register_par({molecule!r}, path), or point "
            f"VSM_TORCH_HITRAN_DIR at a pre-populated cache.")
    if verify:
        with open(meta) as f:
            rec = json.load(f)
        got = _sha256(par)
        if got != rec.get("sha256"):
            raise ValueError(
                f"HITRAN cache corruption for {molecule!r}: stored sha256 "
                f"{rec.get('sha256', '?')[:12]}… but file hashes "
                f"{got[:12]}… — re-register the source file.")
    return par
