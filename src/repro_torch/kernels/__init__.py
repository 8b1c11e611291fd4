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
``paged_decode_attention``    ``kernels/decode_attention/kernel.py::paged_decode_attention_fwd``
``ssd_scan``                  ``kernels/ssd_scan/kernel.py::ssd_scan_fwd``
``ssd_scan_bwd``              (XLA's gradient of ``mamba2.ssd_chunked``)
============================  ==============================================

``rms_norm``, ``flash_attention`` and ``ssd_scan`` are differentiable:
their backward passes are ``rms_norm_bwd``, ``flash_attention_bwd`` and
``ssd_scan_bwd``. The decode kernels have no backward and raise under
grad.
"""

from typing import Dict

from .decode_attention import (
    decode_attention,
    decode_attention_plain,
    paged_decode_attention,
    paged_decode_attention_plain,
)
from .flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
)
from .rmsnorm import rms_norm, rms_norm_bwd, rms_norm_bwd_plain, rms_norm_plain
from .ssd_scan import ssd_scan, ssd_scan_bwd, ssd_scan_bwd_plain, ssd_scan_fwd, ssd_scan_plain

__all__ = [
    "KERNELS", "launch_counts", "reset_launch_counts",
    "rms_norm", "rms_norm_plain", "rms_norm_bwd", "rms_norm_bwd_plain",
    "flash_attention", "flash_attention_fwd", "flash_attention_plain",
    "flash_attention_bwd", "flash_attention_bwd_plain",
    "decode_attention", "decode_attention_plain",
    "paged_decode_attention", "paged_decode_attention_plain",
    "ssd_scan", "ssd_scan_fwd", "ssd_scan_plain", "ssd_scan_bwd", "ssd_scan_bwd_plain",
]

#: name -> wrapper; each wrapper's ``launches`` counts kernel launches.
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


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
