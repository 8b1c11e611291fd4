"""The architectures the port runs (sources in brackets).

A copy of the reference registry's entries for the two dense GQA
decoders and the Mamba2 + shared-attention hybrid zamba2-1.2b; the other
families join the port with their model code.
"""

from __future__ import annotations

from typing import Dict

from .base import ModelConfig, SSMConfig

__all__ = ["ARCHS", "ALIASES", "get_config", "list_archs"]


def _zamba2_1p2b() -> ModelConfig:
    # [hybrid] 38L d_model=2048 32H d_ff=8192 vocab=32000 ssm_state=64
    # Mamba2 backbone + shared attention block [arXiv:2411.15242]
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,      # shared block runs at width 2*d_model / 32 heads
        d_ff=8192,
        vocab_size=32000,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
        attn_every=6,
        tie_embeddings=True,
        rope_theta=10000.0,
    )


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
    c.name: c for c in [_zamba2_1p2b(), _llama32_1b(), _smollm_135m()]
}

# Short aliases for --arch.
ALIASES = {
    "zamba2": "zamba2-1.2b",
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
