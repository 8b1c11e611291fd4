"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version and a launch counter.

============================  ==============================================
wrapper                       replaces (Pallas TPU kernel)
============================  ==============================================
``rms_norm``                  ``kernels/rmsnorm/kernel.py::rmsnorm_fwd``
``rms_norm_bwd``              (XLA's gradient of ``layers.rms_norm``)
``flash_attention``           ``kernels/flash_attention/kernel.py::flash_attention_fwd``
``flash_attention_bwd``       (XLA's gradient of the jnp attention)
``decode_attention``          ``kernels/decode_attention/kernel.py::decode_attention_fwd``
``decode_attention_partial``  (the same, on a rank's rows: K3's kernels)
``paged_decode_attention``    ``kernels/decode_attention/kernel.py::paged_decode_attention_fwd``
``ssd_scan``                  ``kernels/ssd_scan/kernel.py::ssd_scan_fwd``
``ssd_scan_bwd``              (XLA's gradient of ``mamba2.ssd_chunked``)
============================  ==============================================

``rms_norm``, ``flash_attention`` and ``ssd_scan`` are differentiable:
their backward passes are ``rms_norm_bwd``, ``flash_attention_bwd`` and
``ssd_scan_bwd``. The decode kernels have no backward and raise under
grad.

Each wrapper also takes meta tensors (the dry run's): it allocates the
outputs and scratch its CUDA path allocates and launches nothing. Each
module has a work formula per kernel, the (FLOPs, bytes) of one launch
(``WORK``): the bytes are each input read once and each output written
once (K3 / K4: the live K/V rows), the FLOPs the kernel's own products
(two a multiply-add; K1 causal: the (query, key) pairs the mask keeps).
While ``work_hook`` is set, each wrapper calls
``work_hook(name, flops, nbytes)`` where it launches its kernel and in
its meta branch alike (``repro_torch.analysis.op_cost`` sets it); unset,
the CUDA path reads the attribute and nothing more.
"""

from typing import Callable, Dict, Optional

#: ``work_hook(name, flops, nbytes)``: each kernel launch's work (and each
#: meta call's), while a counter is active; None otherwise.
work_hook: Optional[Callable[[str, float, float], None]] = None


def report_work(name: str, work) -> None:
    """Hand one launch's (flops, bytes) to ``work_hook``, if one is set."""
    if work_hook is not None:
        work_hook(name, *work)


from .decode_attention import (  # noqa: E402
    decode_attention,
    decode_attention_partial,
    decode_attention_partial_plain,
    decode_attention_partial_work,
    decode_attention_plain,
    decode_attention_work,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_decode_attention_work,
)
from .flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_bwd_work,
    flash_attention_fwd,
    flash_attention_plain,
    flash_attention_work,
)
from .rmsnorm import (  # noqa: E402
    rms_norm, rms_norm_bwd, rms_norm_bwd_plain, rms_norm_bwd_work, rms_norm_plain, rms_norm_work,
)
from .ssd_scan import (  # noqa: E402
    ssd_scan, ssd_scan_bwd, ssd_scan_bwd_plain, ssd_scan_bwd_work, ssd_scan_fwd, ssd_scan_plain,
    ssd_scan_work,
)

__all__ = [
    "KERNELS", "WORK", "launch_counts", "reset_launch_counts", "work_hook",
    "rms_norm", "rms_norm_plain", "rms_norm_bwd", "rms_norm_bwd_plain",
    "flash_attention", "flash_attention_fwd", "flash_attention_plain",
    "flash_attention_bwd", "flash_attention_bwd_plain",
    "decode_attention", "decode_attention_plain",
    "decode_attention_partial", "decode_attention_partial_plain",
    "paged_decode_attention", "paged_decode_attention_plain",
    "ssd_scan", "ssd_scan_fwd", "ssd_scan_plain", "ssd_scan_bwd", "ssd_scan_bwd_plain",
    "rms_norm_work", "rms_norm_bwd_work", "flash_attention_work", "flash_attention_bwd_work",
    "decode_attention_work", "decode_attention_partial_work", "paged_decode_attention_work",
    "ssd_scan_work",
    "ssd_scan_bwd_work",
]

#: name -> wrapper; each wrapper's ``launches`` counts kernel launches
#: (``decode_attention_partial`` counts on ``decode_attention``'s).
KERNELS = {
    "rmsnorm": rms_norm,
    "rmsnorm_bwd": rms_norm_bwd,
    "decode_attention": decode_attention,
    "paged_decode_attention": paged_decode_attention,
    "flash_attention": flash_attention,
    "flash_attention_bwd": flash_attention_bwd,
    "ssd_scan": ssd_scan,
    "ssd_scan_bwd": ssd_scan_bwd,
}

#: name -> its work formula, ``(*shape) -> (flops, bytes)`` of one launch.
WORK = {
    "rmsnorm": rms_norm_work,
    "rmsnorm_bwd": rms_norm_bwd_work,
    "decode_attention": decode_attention_work,
    "paged_decode_attention": paged_decode_attention_work,
    "flash_attention": flash_attention_work,
    "flash_attention_bwd": flash_attention_bwd_work,
    "ssd_scan": ssd_scan_work,
    "ssd_scan_bwd": ssd_scan_bwd_work,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
