"""The architectures the port runs (sources in brackets).

A copy of the reference registry, all ten entries: the GQA decoders
(dense, the parallel-block command-r, the qk-norm chameleon and the top-k
MoE qwen3-moe), the MLA + MoE deepseek-v3, the Mamba2 + shared-attention
hybrid zamba2-1.2b, the mLSTM / sLSTM xlstm-125m and the bidirectional
audio encoder hubert-xlarge (frame inputs).
"""

from __future__ import annotations

from typing import Dict

from .base import MLAConfig, ModelConfig, MoEConfig, SSMConfig, XLSTMConfig

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


def _hubert_xlarge() -> ModelConfig:
    # [audio] 48L d_model=1280 16H d_ff=5120 vocab=504 encoder-only
    # [arXiv:2106.07447]; frontend is a stub: precomputed frame embeddings.
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        norm="layernorm",
        act="gelu",
        glu=False,
        rope_theta=0.0,    # conv positional embedding instead
        input_kind="frames",
        tie_embeddings=True,  # head = output embedding table
    )


def _qwen3_moe_30b() -> ModelConfig:
    # [moe] 48L d_model=2048 32H (kv=4) d_ff(expert)=768 vocab=151936
    # 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]; head_dim=128, qk-norm.
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1000000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_expert=768),
    )


def _deepseek_v3() -> ModelConfig:
    # [moe] 61L d_model=7168 128H d_ff(expert)=2048 vocab=129280
    # MLA, 1 shared + 256 routed top-8, first 3 dense (d_ff 18432), MTP
    # [arXiv:2412.19437]
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        head_dim=192,      # qk_nope(128) + qk_rope(64)
        d_ff=18432,        # dense layers
        vocab_size=129280,
        rope_theta=10000.0,
        moe=MoEConfig(
            n_experts=256,
            top_k=8,
            d_expert=2048,
            n_shared_experts=1,
            first_k_dense=3,
        ),
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        mla_absorb=True,   # latent-space decode = DeepSeek's own deployment
        mtp=True,
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


def _qwen25_3b() -> ModelConfig:
    # [dense] 36L d_model=2048 16H (kv=2) d_ff=11008 vocab=151936, QKV bias
    # [hf:Qwen/Qwen2.5-3B]
    return ModelConfig(
        name="qwen2.5-3b",
        family="dense",
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv_heads=2,
        head_dim=128,
        d_ff=11008,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1000000.0,
        tie_embeddings=True,
    )


def _command_r_35b() -> ModelConfig:
    # [dense] 40L d_model=8192 64H (kv=8) d_ff=22528 vocab=256000
    # parallel attn+FFN block, LayerNorm, logit scaling, tied embeddings
    # [hf:CohereForAI/c4ai-command-r-v01]
    return ModelConfig(
        name="command-r-35b",
        family="dense",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22528,
        vocab_size=256000,
        norm="layernorm",
        parallel_block=True,
        logit_scale=0.0625,
        rope_theta=8000000.0,
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


def _chameleon_34b() -> ModelConfig:
    # [vlm] 48L d_model=8192 64H (kv=8) d_ff=22016 vocab=65536
    # early-fusion VQ image tokens share the text vocab; qk-norm
    # [arXiv:2405.09818]. Frontend stub: fused token ids.
    return ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=65536,
        qk_norm=True,
        rope_theta=10000.0,
    )


def _xlstm_125m() -> ModelConfig:
    # [ssm] 12L d_model=768 4H d_ff=0 vocab=50304, sLSTM + mLSTM blocks
    # [arXiv:2405.04517] — xLSTM[7:1]-style mix; no separate FFN (d_ff=0,
    # the blocks carry their own up/down projections).
    return ModelConfig(
        name="xlstm-125m",
        family="xlstm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        head_dim=192,
        d_ff=0,
        vocab_size=50304,
        rope_theta=0.0,
        tie_embeddings=True,
        xlstm=XLSTMConfig(slstm_every=6),
    )


ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _zamba2_1p2b(),
        _hubert_xlarge(),
        _qwen3_moe_30b(),
        _deepseek_v3(),
        _llama32_1b(),
        _qwen25_3b(),
        _command_r_35b(),
        _smollm_135m(),
        _chameleon_34b(),
        _xlstm_125m(),
    ]
}

# Short aliases for --arch.
ALIASES = {
    "zamba2": "zamba2-1.2b",
    "hubert": "hubert-xlarge",
    "qwen3-moe": "qwen3-moe-30b-a3b",
    "deepseek-v3": "deepseek-v3-671b",
    "llama3.2": "llama3.2-1b",
    "qwen2.5": "qwen2.5-3b",
    "command-r": "command-r-35b",
    "smollm": "smollm-135m",
    "chameleon": "chameleon-34b",
    "xlstm": "xlstm-125m",
}


def get_config(name: str) -> ModelConfig:
    key = ALIASES.get(name, name)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[key]


def list_archs():
    return sorted(ARCHS)
