"""Masked fastest-k aggregation and int8 error-feedback compression
(single device; sharding waits)."""

from .collectives import check_worker_major, contributors, example_weights, masked_weighted_ce
from .compression import Int8Codec, ef_compress_tree

__all__ = ["Int8Codec", "check_worker_major", "contributors", "ef_compress_tree",
           "example_weights", "masked_weighted_ce"]
