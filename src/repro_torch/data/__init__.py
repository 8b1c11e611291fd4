"""Synthetic token stream, the audio stub's frame stream and beta-scaled
worker-major batches."""

from .pipeline import StagedBatcher, TokenStream, make_frame_stream

__all__ = ["StagedBatcher", "TokenStream", "make_frame_stream"]
