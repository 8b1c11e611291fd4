"""repro_torch — the PyTorch and CUDA port of ``repro``'s serving and
training paths.

A second package beside the JAX reference: the same configs, model math
(dense GQA decoders and the Mamba2 + shared-attention hybrid), slot pool,
scheduler and continuous-batching engine, which serves both, and the
paper's adaptive-(k, beta) training loop with its controller, masked
fastest-k step, optimizer and checkpoints, written for PyTorch. The
reference's Pallas TPU kernels on these paths (flash attention, RMSNorm,
flash decode, paged flash decode, the SSD chunked scan) are rewritten by
hand in CUDA C++ for Hopper (``csrc/``), with backward kernels for the
three that training differentiates. It imports ``torch`` and ``numpy``
and nothing of JAX or of the reference package.

Entry points run on the card by default (``device="cuda"``) and raise
when none is present; a caller that wants the CPU passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card
    (there is no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
