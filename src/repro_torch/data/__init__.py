"""Synthetic token stream and beta-scaled worker-major batches."""

from .pipeline import StagedBatcher, TokenStream

__all__ = ["StagedBatcher", "TokenStream"]
