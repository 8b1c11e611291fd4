"""Masked fastest-k aggregation (single device; sharding waits)."""

from .collectives import check_worker_major, contributors, example_weights, masked_weighted_ce

__all__ = ["check_worker_major", "contributors", "example_weights", "masked_weighted_ce"]
