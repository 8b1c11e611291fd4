"""Serving step functions of the port."""

from .steps import make_slot_decode_step, make_slot_prefill_step

__all__ = ["make_slot_decode_step", "make_slot_prefill_step"]
