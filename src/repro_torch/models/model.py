"""Top-level model (port of ``repro.models.model`` for the decoder stacks,
GQA (dense, parallel-block, MoE) and MLA (deepseek, with its MTP
parameters and its multi-token-prediction loss), the xLSTM stack, the
Mamba2 hybrids and the bidirectional audio encoder, whose inputs are
frames (B, S, d_model): a projection and a depthwise positional conv in
place of the token embedding, ``embed`` its output head): embeddings,
the block stack, the head (tied or not), the training entry points
``hidden``, ``train_loss`` and ``mtp_loss``, and the serving
entry points ``cache_specs`` / ``blank_caches``, ``prefill_with_cache``,
``decode_step`` and the speculative ``verify_with_cache``.

Parameters and caches are trees of tensors. For the segment stacks
``params["stack"]`` and the cache tree hold one list per segment with
one dict per layer (the reference stacks layers on a leading axis
instead); for ``ssm``/``hybrid`` the stack is ``zamba.zamba_specs``'s
tree and the cache ``zamba.zamba_cache_specs``'s, stacked as in the
reference. Every RMSNorm runs
through kernel K2 (its gradient through K2's backward), every GQA
training attention through K1 (forward and backward), every SSD scan
through K5 (forward and backward), and every GQA decode attention
through K3 (contiguous) or K4 (paged); the projections, LayerNorm, the
MLP, the MoE dispatch and its expert products, MLA's attention (f32, as
the reference), the xLSTM and serving SSM recurrences, the causal
convolutions (the encoder's positional one too) and the head are plain
PyTorch, as the reference leaves them to XLA.

The attention stacks' prefill and verify run the whole chunk at once.
Stacks with recurrent state (the hybrid, xLSTM) take the reference's
fallback: they scan the decode step over the chunk, one token at a
time, and mask each row's state past its length (the verify: past its
accepted prefix).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import masked_weighted_ce
from repro_torch.dist.sharding import constrain_batch
from repro_torch.dist.tensor_parallel import copy_to_tp, vocab_parallel_ce, vocab_parallel_embed
from . import attention as attn
from . import xlstm, zamba
from .layers import (
    DTYPES,
    ParamSpec,
    count_specs,
    init_from_specs,
    norm_apply,
    norm_specs,
    tree_leaves,
    tree_map,
)
from .transformer import (
    RECURRENT_KINDS,
    Segment,
    block_apply,
    block_ffn,
    block_specs,
    recurrent_block,
    run_segments,
    segment_plan,
)

__all__ = ["Model", "build_model", "count_params_analytic"]


def _block_decode(
    params: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    kind: str,
    *,
    positions: torch.Tensor,
    cache: Dict,
    cache_index,
    block_tables: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """One block's decode step. An xLSTM block updates its states in place,
    lanes where ``mask`` (B,) is False keeping theirs; attention blocks
    write their K/V (or latent) row and ignore ``mask``."""
    if kind in RECURRENT_KINDS:
        return recurrent_block(params, x, cfg, kind, cache, mask)
    h = norm_apply(params["attn_norm"], x, cfg.norm)
    if kind.startswith("mla"):
        a, new_cache = attn.mla_apply(
            params["attn"], h, cfg, positions=positions, cache=cache,
            cache_index=cache_index, absorb=cfg.mla_absorb, block_table=block_tables,
        )
    else:
        a, new_cache = attn.gqa_apply(
            params["attn"], h, cfg, positions=positions, cache=cache,
            cache_index=cache_index, block_table=block_tables,
        )
    # The router's aux loss is dropped, as the reference drops it serving.
    return block_ffn(params, x, h, a, cfg, kind)[0], new_cache


def _block_prefill(
    params: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    kind: str,
    *,
    positions: torch.Tensor,
    cache: Dict,
    start_index,
    block_tables: Optional[torch.Tensor] = None,
    n_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Multi-token block forward that also writes the block's cache rows
    (the serving prefill and verify; mirrors ``_block_decode`` with S > 1)."""
    h = norm_apply(params["attn_norm"], x, cfg.norm)
    prefill = attn.mla_prefill if kind.startswith("mla") else attn.gqa_prefill
    a, new_cache = prefill(
        params["attn"], h, cfg, positions=positions, cache=cache,
        start_index=start_index, block_table=block_tables, n_valid=n_valid,
    )
    # The router's aux loss is dropped, as the reference drops it serving.
    return block_ffn(params, x, h, a, cfg, kind)[0], new_cache


def _block_cache_spec(cfg: ModelConfig, kind: str, batch: int, max_len: int, page=None):
    if kind == "mlstm":
        return xlstm.mlstm_state_spec(cfg, batch)
    if kind == "slstm":
        return xlstm.slstm_state_spec(cfg, batch)
    if kind.startswith("mla"):
        return attn.mla_cache_spec(cfg, batch, max_len, page)
    return attn.gqa_cache_spec(cfg, batch, max_len, page)


def _zeros_from_specs(specs, device) -> Any:
    """Spec-initialized cache tree (zeros / ones fills) on ``device``."""
    def make(s: ParamSpec) -> torch.Tensor:
        fill = torch.ones if s.init == "ones" else torch.zeros
        return fill(s.shape, dtype=DTYPES[s.dtype], device=device)
    return tree_map(make, specs)


class Model:
    """A decoder stack (GQA or MLA), an xLSTM stack or a Mamba2 hybrid.
    Methods are functions of (params, inputs), like the reference's; cache
    writes happen in place on the given caches."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.segments: List[Segment] = (
            [] if self.is_hybrid else segment_plan(cfg)   # zamba path
        )

    @property
    def is_hybrid(self) -> bool:
        """Mamba2 backbone (family ``ssm`` or ``hybrid``): ``zamba`` runs it."""
        return self.cfg.family in ("ssm", "hybrid")

    @property
    def tensor_parallel(self) -> bool:
        """Whether the train, prefill and decode steps compute tensor-parallel
        over ``"model"`` on a mesh: the dense decoders (families ``dense``
        and ``vlm``, blocks ``dense`` and ``parallel``; decode over their
        contiguous caches, the only ones the reference runs on a mesh).
        The other families gather every parameter whole in every step."""
        return (self.cfg.family in ("dense", "vlm") and self.cfg.input_kind == "tokens"
                and all(seg.kind in ("dense", "parallel") for seg in self.segments))

    def tp_partial(self, params: Dict) -> List[bool]:
        """For each leaf of ``params`` (the rank's TP-only blocks, in
        ``tree_leaves`` order): whether its gradient is a partial sum over
        ``"model"``, a leaf replicated there but read by the rank's share
        of a split product (``attention.gqa_tp_partial``)."""
        flags = tree_map(lambda _: False, params, is_leaf=torch.is_tensor)
        for layers, flag_layers in zip(params["stack"], flags["stack"]):
            for layer, flag in zip(layers, flag_layers):
                for name in attn.gqa_tp_partial(layer["attn"], self.cfg):
                    flag["attn"][name] = tree_map(lambda _: True, layer["attn"][name],
                                                  is_leaf=torch.is_tensor)
        return tree_leaves(flags, is_leaf=lambda x: isinstance(x, bool))

    @property
    def recurrent(self) -> bool:
        """Whether some block carries recurrent state (the hybrid's Mamba2
        layers, xLSTM's mLSTM / sLSTM blocks), which cannot rewind."""
        return self.is_hybrid or any(seg.kind in RECURRENT_KINDS for seg in self.segments)

    @property
    def fused_prefill(self) -> bool:
        """True when every block has a multi-token cache-writing prefill
        (the attention stacks); stacks with recurrent state scan the
        decode step in ``prefill_with_cache`` and ``verify_with_cache``
        instead."""
        return not self.recurrent

    # -- specs ---------------------------------------------------------------
    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        dt = cfg.dtype
        specs: Dict[str, Any] = {}
        if cfg.input_kind != "tokens":
            # Frames (the audio stub): a projection and a depthwise
            # positional conv of width 16; ``embed`` is the output head of
            # the masked prediction.
            specs["frame_proj"] = ParamSpec((cfg.d_model, cfg.d_model), ("embed", "embed_out"),
                                            "scaled", dt)
            specs["pos_conv_w"] = ParamSpec((16, cfg.d_model), (None, "embed"), "scaled", dt)
            specs["pos_conv_b"] = ParamSpec((cfg.d_model,), ("embed",), "zeros", dt)
        specs.update({
            "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                               "normal", dt),
            "stack": (zamba.zamba_specs(cfg) if self.is_hybrid else
                      [[block_specs(cfg, seg.kind) for _ in range(seg.count)]
                       for seg in self.segments]),
            "final_norm": norm_specs(cfg.d_model, cfg.norm, dt),
        })
        if not cfg.tie_embeddings:
            specs["head"] = ParamSpec(
                (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), "scaled", dt
            )
        if cfg.mtp:
            # DeepSeek's multi-token-prediction head: ``mtp_loss`` trains
            # it; serving never reads it.
            specs["mtp"] = {
                "proj": ParamSpec((2 * cfg.d_model, cfg.d_model), ("embed", "embed_out"),
                                  "scaled", dt),
                "block": block_specs(cfg, self.mtp_kind),
                "norm": norm_specs(cfg.d_model, cfg.norm, dt),
            }
        return specs

    def init(self, seed: int = 0, *, device="cuda"):
        """Random parameters on ``device``, drawn from a ``torch.Generator``
        on that device seeded with ``seed``."""
        dev = resolve_device(device)
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed))
        return init_from_specs(self.param_specs(), generator, dev)

    # -- forward -------------------------------------------------------------
    def embed_inputs(self, params: Dict, inputs: torch.Tensor) -> torch.Tensor:
        """Token ids (B, S) -> their embedding rows; frames (B, S, D) -> the
        projection x plus its depthwise positional conv: x left-padded by
        W - 1 = 15 and summed over W shifted windows, each scaled by its
        row of ``pos_conv_w``, plus ``pos_conv_b`` (the reference's
        order of sums)."""
        if self.cfg.input_kind == "tokens":
            if params["embed"].shape[0] != self.cfg.vocab_size:
                # The rank's vocab rows (a tensor-parallel view).
                return vocab_parallel_embed(params["embed"], inputs)
            return params["embed"][inputs.long()]
        x = inputs.to(params["frame_proj"].dtype) @ params["frame_proj"]
        w = params["pos_conv_w"]
        W, S = w.shape[0], x.shape[1]
        x_pad = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
        pos = 0
        for i in range(W):
            pos = pos + x_pad[:, i:i + S, :] * w[i]
        return x + (pos + params["pos_conv_b"])

    def hidden(self, params: Dict, inputs: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward -> (final-norm hidden states (B, S, D), aux)."""
        cfg = self.cfg
        x = constrain_batch(self.embed_inputs(params, inputs))
        if self.is_hybrid:
            h, aux = zamba.zamba_apply(params["stack"], x, cfg, positions=positions)
        else:
            h, aux = run_segments(params["stack"], self.segments, x, cfg,
                                  positions=positions)
        return norm_apply(params["final_norm"], h, cfg.norm), aux

    def logits(self, params: Dict, h: torch.Tensor) -> torch.Tensor:
        """(B, S, V) logits of the final-normed ``h``; under a tensor-parallel
        view whose layout cuts ``vocab``, the rank's columns (B, S, V / m)
        of the tied table or the untied head, column-parallel on ``h``."""
        cfg = self.cfg
        tied = cfg.tie_embeddings or cfg.input_kind != "tokens"
        w = params["embed"].t() if tied else params["head"]
        if w.shape[-1] != cfg.vocab_size:
            h = copy_to_tp(h)
        out = h @ w
        if cfg.logit_scale != 1.0:
            out = out * cfg.logit_scale
        if cfg.logit_softcap > 0:
            out = cfg.logit_softcap * torch.tanh(out / cfg.logit_softcap)
        return out

    # -- training ------------------------------------------------------------
    @property
    def mtp_kind(self) -> str:
        return "mla_dense" if self.cfg.mla is not None else "dense"

    def train_loss(self, params: Dict, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: inputs (B, S) int or (B, S, D) frames, labels (B, S) int,
        optional mask (B, S)
        -> (loss, {"ce", "aux", ["mtp"], "loss"}): the masked cross-entropy
        plus, for an MoE, ``router_aux_weight`` times the router loss
        summed over its layers, plus, with ``cfg.mtp``, 0.3 times the
        multi-token-prediction loss (``mtp_loss``)."""
        cfg = self.cfg
        inputs, labels = batch["inputs"], batch["labels"]
        positions = torch.arange(labels.shape[1], device=labels.device)
        h, aux = self.hidden(params, inputs, positions)
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        ce, _ = vocab_parallel_ce(self.logits(params, h), labels, mask, vocab=cfg.vocab_size)
        loss = ce + cfg.moe.router_aux_weight * aux if cfg.moe is not None else ce
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp:
            mtp = self.mtp_loss(params, h, inputs, labels, mask, positions)
            loss = loss + 0.3 * mtp
            metrics["mtp"] = mtp
        metrics["loss"] = loss
        return loss, metrics

    def mtp_loss(self, params: Dict, h: torch.Tensor, inputs: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor, positions: torch.Tensor
                 ) -> torch.Tensor:
        """DeepSeek-V3's multi-token prediction: the final-normed ``h``
        beside the embedding of the next input goes through ``proj``, one
        block (not rematerialised, as the reference calls it directly),
        the MTP norm and the shared head, and predicts the label after
        next; the last position, which has none, is masked."""
        cfg = self.cfg
        mtp = params["mtp"]
        emb_next = params["embed"][torch.roll(inputs, -1, dims=1).long()]
        x = torch.cat([h, emb_next], dim=-1) @ mtp["proj"]
        x, _ = block_apply(mtp["block"], x, cfg, self.mtp_kind, positions=positions)
        x = norm_apply(mtp["norm"], x, cfg.norm)
        S = labels.shape[1]
        mask2 = mask * (torch.arange(S, device=labels.device) < S - 1)
        return masked_weighted_ce(self.logits(params, x), torch.roll(labels, -1, dims=1),
                                  mask2)[0]

    # -- serving ---------------------------------------------------------------
    def prefill(self, params: Dict, inputs: torch.Tensor) -> torch.Tensor:
        """Prefill forward -> logits for the last position (no cache
        writing: the dry run's prefill compute; serving uses
        ``prefill_with_cache``)."""
        positions = torch.arange(inputs.shape[1], device=inputs.device)
        h, _ = self.hidden(params, inputs, positions)
        return self.logits(params, h[:, -1:, :])

    def cache_specs(self, batch: int, max_len: int, *,
                    block_size: Optional[int] = None, num_blocks: int = 0):
        """Cache spec tree for ``batch`` sequences of up to ``max_len``
        tokens. The sequence axis is rounded up to ``attn.KV_SEQ_ALIGN``
        here, at allocation time. ``block_size`` switches every leaf to
        the paged arena layout (num_blocks + 1, block_size, ...) addressed
        through block tables; row 0 of an arena is the NULL sink. The
        recurrent states (the hybrid's, xLSTM's) have no sequence axis and
        stay contiguous per slot in both modes."""
        max_len = attn.round_kv_len(max_len)
        page = None if block_size is None else (num_blocks, block_size)
        if self.is_hybrid:
            return zamba.zamba_cache_specs(self.cfg, batch, max_len, page)
        return [[_block_cache_spec(self.cfg, seg.kind, batch, max_len, page)
                 for _ in range(seg.count)] for seg in self.segments]

    def blank_caches(self, batch: int, max_len: int, *,
                     block_size: Optional[int] = None, num_blocks: int = 0,
                     device="cuda"):
        """Freshly initialized caches on ``device``."""
        return _zeros_from_specs(
            self.cache_specs(batch, max_len, block_size=block_size,
                             num_blocks=num_blocks),
            resolve_device(device),
        )

    def prefill_with_cache(
        self,
        params: Dict,
        inputs: torch.Tensor,                      # (B, P) int, right-padded
        caches,
        length: Optional[torch.Tensor] = None,     # (B,) valid tokens per row
        start_index=0,                             # scalar: first write position
        block_tables: Optional[torch.Tensor] = None,  # (B, T) paged arenas
    ):
        """Batched cache-writing prefill -> (last-valid logits (B, 1, V),
        caches). ``inputs`` may be right-padded to a bucket; pad rows are
        causally inert and their cache rows are masked by decode's length.
        ``start_index > 0`` continues a partially prefilled cache. Stacks
        with recurrent state scan the decode step instead
        (``_scanned_prefill``)."""
        B, P = inputs.shape
        dev = inputs.device
        if length is None:
            length = torch.full((B,), P, dtype=torch.long, device=dev)
        if not self.fused_prefill:
            return self._scanned_prefill(params, inputs, caches, length.to(dev),
                                         start_index, block_tables)
        start = torch.as_tensor(start_index, dtype=torch.long, device=dev)
        positions = start + torch.arange(P, device=dev)
        h, new_caches = self._fused_prefill_stack(
            params, inputs, caches, positions=positions, start_index=start_index,
            block_tables=block_tables,
        )
        last = (length.to(dev).long() - 1).clamp(0, P - 1)
        h_last = h[torch.arange(B, device=dev), last][:, None]
        return self.logits(params, h_last), new_caches

    def _scanned_prefill(self, params: Dict, inputs: torch.Tensor, caches,
                         length: torch.Tensor, start_index, block_tables):
        """The reference's recurrent fallback: ``decode_step`` over the
        chunk's tokens from ``start_index``; row b's states and logits
        move only while t < length[b] (its K/V rows past its length are
        masked by every read). The scan stops at max(length): a step in
        which no row is valid changes nothing."""
        B = inputs.shape[0]
        last = torch.zeros((B, 1, self.cfg.vocab_size), dtype=params["embed"].dtype,
                           device=inputs.device)
        for t in range(int(length.max())):
            valid = t < length
            logits, caches = self.decode_step(
                params, inputs[:, t:t + 1], caches, start_index + t,
                block_tables=block_tables, mask=valid,
            )
            last = torch.where(valid[:, None, None], logits, last)
        return last, caches

    def _fused_prefill_stack(
        self,
        params: Dict,
        inputs: torch.Tensor,
        caches,
        *,
        positions: torch.Tensor,
        start_index,
        block_tables: Optional[torch.Tensor] = None,
        n_valid: Optional[torch.Tensor] = None,
    ):
        """Cache-writing stack walk of the fused path -> (final-norm hidden
        states (B, S, D), caches): the one walk of ``prefill_with_cache``
        and ``verify_with_cache``, whose streams must not part."""
        cfg = self.cfg
        h = self.embed_inputs(params, inputs)
        new_caches = []
        for seg_params, seg_cache, seg in zip(params["stack"], caches, self.segments):
            seg_new = []
            for layer, cache in zip(seg_params, seg_cache):
                h, nc = _block_prefill(
                    layer, h, cfg, seg.kind, positions=positions, cache=cache,
                    start_index=start_index, block_tables=block_tables,
                    n_valid=n_valid,
                )
                seg_new.append(nc)
            new_caches.append(seg_new)
        return norm_apply(params["final_norm"], h, cfg.norm), new_caches

    def verify_with_cache(
        self,
        params: Dict,
        inputs: torch.Tensor,                      # (B, S) int draft windows
        caches,
        n_input: torch.Tensor,                     # (B,) valid inputs a row
        start_indices: torch.Tensor,               # (B,) first write position
        block_tables: Optional[torch.Tensor] = None,
        greedy_commit: bool = True,
    ):
        """Batched multi-token verify of speculative decoding ->
        (all-position logits (B, S, V), caches).

        Row b scores ``inputs[b, :n_input[b]]`` (the pending token, then
        the draft's proposals) from its own cache position
        ``start_indices[b]``; positions past ``n_input`` are pad, and
        their logits are garbage the caller ignores. On return the caches
        hold a committed prefix of any length ``a + 1 <= n_input[b]`` that
        the caller derives from the logits by the exact-argmax rule:

          * dense stacks (fused path) write K/V rows for all ``n_input``
            inputs; rows past the accepted prefix are dead (every read
            masks by the caller's position), so rollback is a position
            rewind. Pad rows are dropped or sunk (``cache_rows_update``).
          * stacks with recurrent state (scanned path: the hybrid, xLSTM)
            cannot rewind it, so step t commits its state update only
            while the greedy chain holds, ``argmax(logits_{t-1}) ==
            inputs[t]``, decided on the card as the caller decides it on
            the host. ``greedy_commit`` False commits all ``n_input``
            tokens (the draft's replay). Where the reference selects the
            hybrid's K/V rows by the chain as well, the port writes them
            at every step, in place: a row at or past a lane's committed
            position is dead. A pad step's position is clamped onto the
            last row, which no lane reads (a lane's rows end at its
            budget minus 2): past it, a contiguous write would clamp
            there anyway, and a paged one would wrap onto a row of the
            lane's last block. xLSTM writes no row.
        """
        B, S = inputs.shape
        dev = inputs.device
        start = torch.as_tensor(start_indices, dtype=torch.long, device=dev)
        n_input = torch.as_tensor(n_input, dtype=torch.long, device=dev)
        if self.fused_prefill:
            positions = start[:, None] + torch.arange(S, device=dev)   # (B, S)
            h, new_caches = self._fused_prefill_stack(
                params, inputs, caches, positions=positions, start_index=start,
                block_tables=block_tables, n_valid=n_input,
            )
            return self.logits(params, h), new_caches
        # The chain stays on the card: no step reads a value back.
        nxt = torch.cat([inputs[:, 1:], torch.zeros_like(inputs[:, :1])], dim=1)
        pos = start[:, None] + torch.arange(S, device=dev)
        if self.is_hybrid:
            pos = pos.clamp(max=zamba.zamba_kv_rows(caches, block_tables) - 1)
        acc = torch.ones(B, dtype=torch.bool, device=dev)
        ys = []
        for t in range(S):
            commit = acc & (t < n_input)
            logits, caches = self.decode_step(
                params, inputs[:, t:t + 1], caches, pos[:, t],
                block_tables=block_tables, mask=commit,
            )
            if greedy_commit:
                g = torch.argmax(logits[:, -1], dim=-1)
                acc = acc & ((g == nxt[:, t].long()) | (t + 1 >= n_input))
            ys.append(logits[:, 0])
        return torch.stack(ys, dim=1), caches

    def decode_step(
        self,
        params: Dict,
        token: torch.Tensor,       # (B, 1) int
        caches,
        cache_index,               # current length: scalar or (B,)
        block_tables: Optional[torch.Tensor] = None,  # (B, T): paged KV arenas
        mask: Optional[torch.Tensor] = None,          # (B,) bool: lanes to update
    ):
        """One token per sequence -> (logits (B, 1, V), caches). ``mask``
        (None: every lane) marks the lanes whose recurrent states the step
        may change (the hybrid's, xLSTM's); the attention stacks have none
        and ignore it."""
        cfg = self.cfg
        x = self.embed_inputs(params, token)
        idx = torch.as_tensor(cache_index, dtype=torch.long, device=x.device)
        positions = idx.reshape(1) if idx.dim() == 0 else idx[:, None]
        if self.is_hybrid:
            h, caches = zamba.zamba_decode(
                params["stack"], x, cfg, caches, positions=positions, cache_index=idx,
                block_tables=block_tables, mask=mask,
            )
            return self.logits(params, norm_apply(params["final_norm"], h, cfg.norm)), caches
        new_caches = []
        h = x
        for seg_params, seg_cache, seg in zip(params["stack"], caches, self.segments):
            seg_new = []
            for layer, cache in zip(seg_params, seg_cache):
                h, nc = _block_decode(
                    layer, h, cfg, seg.kind, positions=positions, cache=cache,
                    cache_index=idx, block_tables=block_tables, mask=mask,
                )
                seg_new.append(nc)
            new_caches.append(seg_new)
        h = norm_apply(params["final_norm"], h, cfg.norm)
        return self.logits(params, h), new_caches


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count from the spec tree (exact). ``active_only``: each
    MoE layer counted at top_k (+ shared) experts, not all of them."""
    total = count_specs(Model(cfg).param_specs())
    if active_only and cfg.moe is not None:
        per_expert = 3 * cfg.d_model * cfg.moe.d_expert
        n_moe_layers = cfg.n_layers - cfg.moe.first_k_dense
        total -= (cfg.moe.n_experts - cfg.moe.top_k) * per_expert * n_moe_layers
    return total
