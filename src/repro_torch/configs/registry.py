"""The dense GQA architectures the port serves (sources in brackets).

A copy of the reference registry's entries for the two dense GQA
decoders this slice of the port runs; the other families join the port
with their model code.
"""

from __future__ import annotations

from typing import Dict

from .base import ModelConfig

__all__ = ["ARCHS", "ALIASES", "get_config", "list_archs"]


def _llama32_1b() -> ModelConfig:
    # [dense] 16L d_model=2048 32H (kv=8) d_ff=8192 vocab=128256
    # [hf:meta-llama/Llama-3.2-1B]
    return ModelConfig(
        name="llama3.2-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=500000.0,
        tie_embeddings=True,
    )


def _smollm_135m() -> ModelConfig:
    # [dense] 30L d_model=576 9H (kv=3) d_ff=1536 vocab=49152
    # [hf:HuggingFaceTB/SmolLM-135M]
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        head_dim=64,
        d_ff=1536,
        vocab_size=49152,
        rope_theta=10000.0,
        tie_embeddings=True,
    )


ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [_llama32_1b(), _smollm_135m()]
}

# Short aliases for --arch.
ALIASES = {
    "llama3.2": "llama3.2-1b",
    "smollm": "smollm-135m",
}


def get_config(name: str) -> ModelConfig:
    key = ALIASES.get(name, name)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[key]


def list_archs():
    return sorted(ARCHS)
