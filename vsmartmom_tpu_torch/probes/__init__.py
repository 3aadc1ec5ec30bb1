"""Hopper counterparts of the JAX package's Pallas probes (scripts/probe_*.py).

One module per script, under the script's name without ``probe_``:
``dotperf`` (P8, P9), ``batched_dot`` (P1), ``dot_prec`` (P6),
``dot_prec_speed`` (P2), ``dot_prec_speed2`` (P3), ``vpu_dot`` (P4),
``layout_ops`` (P5) and ``band_bisect`` (P7). Each asks its script's
question on the card at the script's own shapes through a hand-written
kernel (``ops/probe_dots.py``, ``ops/probe_layout.py``,
``ops/band_stages.py``): ``run()`` returns a dict with each case's time,
TFLOP/s, share of its bound, error against its plain version and against
an f64 product, and the time of the library call of the same work
(``library_ms``); ``python -m vsmartmom_tpu_torch.probes.<name>`` prints
it. ``run(device="cpu", ...)`` runs the plain versions on the CPU at
shapes the caller may cut, and takes no time.
"""

#: Probe module -> the Pallas call sites it replaces (P-number, file:line).
SITES = {
    "dotperf": {"P8": "scripts/probe_dotperf.py:55",
                "P9": "scripts/probe_dotperf.py:82"},
    "batched_dot": {"P1": "scripts/probe_batched_dot.py:67"},
    "dot_prec": {"P6": "scripts/probe_mosaic_dot_prec.py:36"},
    "dot_prec_speed": {"P2": "scripts/probe_dot_prec_speed.py:36"},
    "dot_prec_speed2": {"P3": "scripts/probe_dot_prec_speed2.py:33"},
    "vpu_dot": {"P4": "scripts/probe_vpu_dot.py:59"},
    "layout_ops": {"P5": "scripts/probe_mosaic_casts.py:19"},
    "band_bisect": {"P7": "scripts/probe_band_bisect.py:113"},
}
