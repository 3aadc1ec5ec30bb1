"""Spectral sharding of the solves over ``torch.distributed``
(``sharding.py``)."""

from .sharding import (SPECTRAL_AXIS, gather_outputs, gather_spectral,
                       input_shardings, pad_to_multiple, run_ranks,
                       shard_inputs, shard_raman, spectral_mesh, trim)

__all__ = ["SPECTRAL_AXIS", "gather_outputs", "gather_spectral",
           "input_shardings", "pad_to_multiple", "run_ranks", "shard_inputs",
           "shard_raman", "spectral_mesh", "trim"]
