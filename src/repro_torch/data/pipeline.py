"""Synthetic data pipeline with per-stage beta-scaled batching (the
port's copy of ``repro.data.pipeline``, numpy only). The batches are the
reference's bit for bit, the audio stub's frame batches
(``make_frame_stream``) too.

``TokenStream`` produces deterministic synthetic LM batches (structured
enough that a ~100M model visibly learns: a periodic Markov-ish stream
with a learnable transition rule, not uniform noise).

``StagedBatcher`` is the bridge to the paper: given the controller's
current stage (k, beta), it emits batches whose per-worker share is
``beta * b_w`` sequences (b_w = global_batch / n_workers), laid out
worker-major so the masked fastest-k aggregation can weight examples by
worker (``repro_torch.dist.collectives.example_weights``). Changing beta changes
the batch SHAPE.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

__all__ = ["TokenStream", "StagedBatcher", "make_frame_stream"]


class TokenStream:
    """Deterministic synthetic token stream: next = (a*cur + b) % V with
    noise — learnable structure with controllable difficulty."""

    def __init__(self, vocab_size: int, seed: int = 0, noise: float = 0.1):
        self.vocab = vocab_size
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        self.a = 31
        self.b = 17

    def sequences(self, n: int, seq_len: int) -> np.ndarray:
        start = self.rng.integers(0, self.vocab, size=(n, 1))
        seqs = [start]
        cur = start
        for _ in range(seq_len):
            nxt = (self.a * cur + self.b) % self.vocab
            flip = self.rng.random(cur.shape) < self.noise
            rnd = self.rng.integers(0, self.vocab, size=cur.shape)
            cur = np.where(flip, rnd, nxt)
            seqs.append(cur)
        arr = np.concatenate(seqs, axis=1)  # (n, seq_len + 1)
        return arr.astype(np.int32)


def make_frame_stream(d_model: int, seed: int = 0):
    """Audio-stub stream: smooth random frame embeddings + kmeans-ish labels.

    Returns ``sample(n, seq_len, vocab)`` -> (frames (n, seq_len, d_model)
    f32, labels (n, seq_len) int32), all drawn from one seeded generator."""
    rng = np.random.default_rng(seed)

    def sample(n: int, seq_len: int, vocab: int):
        x = rng.standard_normal((n, seq_len, d_model)).astype(np.float32)
        # Smooth along time so there is learnable temporal structure.
        x = 0.5 * x + 0.5 * np.roll(x, 1, axis=1)
        labels = (np.abs(x[..., :8]).sum(-1) * 37).astype(np.int64) % vocab
        return x, labels.astype(np.int32)

    return sample


@dataclasses.dataclass
class StagedBatcher:
    stream: TokenStream
    n_workers: int           # fleet size at construction (beta=1 reference)
    global_batch: int        # at beta = 1
    seq_len: int

    def _per_worker(self, beta: float) -> int:
        b_w = self.global_batch // self.n_workers
        return max(int(round(beta * b_w)), 1)

    def batch_for_stage(
        self, beta: float, n_workers: Optional[int] = None
    ) -> Dict[str, np.ndarray]:
        """Worker-major batch for the stage's (beta, fleet size).

        ``n_workers`` overrides the construction-time fleet size so an
        elastic loop can keep the batch layout aligned with the
        controller's CURRENT n after failures/rejoins: the per-worker
        share stays the beta-scaled b_w (per-worker compute is the
        paper's knob) and the batch shrinks/grows with the fleet,
        keeping ``B % n == 0`` — the worker-major mask contract.
        """
        n = self.n_workers if n_workers is None else n_workers
        if n < 1:
            raise ValueError(f"need at least one worker, got {n}")
        B = self._per_worker(beta) * n
        arr = self.stream.sequences(B, self.seq_len)
        return {
            "inputs": arr[:, :-1],
            "labels": arr[:, 1:],
        }

    def batch_shape(self, beta: float, n_workers: Optional[int] = None):
        n = self.n_workers if n_workers is None else n_workers
        return (self._per_worker(beta) * n, self.seq_len)
