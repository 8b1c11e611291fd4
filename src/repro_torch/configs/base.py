"""Config system: one frozen dataclass tree per architecture.

A copy of the reference package's config dataclasses, kept field for
field so a configuration means the same model in both packages
(``tests/test_torch_package.py`` compares the two). ``reduced()`` derives
the tiny same-family variant the CPU tests run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = [
    "MoEConfig",
    "SSMConfig",
    "MLAConfig",
    "XLSTMConfig",
    "ModelConfig",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int              # per-expert FFN hidden size
    n_shared_experts: int = 0  # DeepSeek-style always-on shared expert(s)
    first_k_dense: int = 0     # leading layers that stay dense
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001  # load-balance loss weight
    d_shared: int = 0          # hidden size of the shared expert (0 = d_expert)
    dispatch: str = "data"     # dispatched-token sharding: data | model | grouped
    # Inference mode: capacity = the full token count, so no token is ever
    # dropped (token-local routing, hence chunk-invariant prefill).
    dropless: bool = False


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block parameters."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64         # SSD head dim (nheads = expand*d_model/head_dim)
    n_groups: int = 1
    chunk: int = 128           # SSD chunk length


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block mix: mLSTM (matrix memory) + sLSTM (scalar memory)."""

    slstm_every: int = 8       # 1 sLSTM per this many blocks (paper's [7:1])
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3333
    conv1d_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | encoder | xlstm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    causal: bool = True
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    logit_softcap: float = 0.0
    logit_scale: float = 1.0
    norm: str = "rmsnorm"      # rmsnorm | layernorm
    act: str = "silu"          # silu | gelu
    glu: bool = True           # gated FFN (SwiGLU/GeGLU); False = plain MLP
    tie_embeddings: bool = False
    parallel_block: bool = False  # attention and FFN in parallel (command-r)

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    attn_every: int = 0        # hybrid (zamba2): shared attn block period; 0 = off
    mtp: bool = False          # DeepSeek multi-token-prediction aux head
    mla_absorb: bool = False   # decode MLA in latent space (perf variant)

    input_kind: str = "tokens"  # tokens | frames (precomputed modality embeddings)
    max_seq_len: int = 8192

    # runtime knobs (overridable per experiment)
    dtype: str = "bfloat16"
    remat: str = "full"        # none | full | selective
    scan_layers: bool = True
    attn_chunk: int = 1024     # memory-efficient attention KV chunk
    # Kept for field parity with the reference. The port does not read it:
    # its kernels are chosen by the device a tensor lives on.
    use_pallas: bool = False

    def __post_init__(self) -> None:
        if self.family not in (
            "dense", "moe", "ssm", "hybrid", "encoder", "xlstm", "vlm", "audio"
        ):
            raise ValueError(f"unknown family {self.family}")
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be divisible by n_kv_heads")

    # -- derived -------------------------------------------------------------
    @property
    def is_encoder(self) -> bool:
        return self.family in ("encoder", "audio") or not self.causal

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the long_500k shape? (SSM/hybrid/linear recurrent)"""
        return self.family in ("ssm", "hybrid", "xlstm")

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2 if self.attn_every == 0 else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            max_seq_len=256,
            dtype="float32",
            remat="none",
            scan_layers=False,
            attn_chunk=64,
        )
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe,
                n_experts=8,
                top_k=2,
                d_expert=64,
                first_k_dense=min(self.moe.first_k_dense, 1),
                d_shared=64 if self.moe.n_shared_experts else 0,
            )
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk=32
            )
        if self.mla is not None:
            small["mla"] = MLAConfig(
                q_lora_rank=64,
                kv_lora_rank=32,
                qk_nope_head_dim=32,
                qk_rope_head_dim=16,
                v_head_dim=32,
            )
        if self.attn_every:
            small["attn_every"] = 2
        small.update(overrides)
        return dataclasses.replace(self, **small)

    # -- accounting ------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count from the port's spec tree."""
        from repro_torch.models.model import count_params_analytic  # lazy, avoids cycle

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        """Parameters a token meets: each MoE layer counted at its top_k
        (and shared) experts."""
        from repro_torch.models.model import count_params_analytic  # lazy, avoids cycle

        return count_params_analytic(self, active_only=True)
