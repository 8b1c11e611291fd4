"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version and a launch counter.

============================  ==============================================
wrapper                       replaces (Pallas TPU kernel)
============================  ==============================================
``rms_norm``                  ``kernels/rmsnorm/kernel.py::rmsnorm_fwd``
``decode_attention``          ``kernels/decode_attention/kernel.py::decode_attention_fwd``
``paged_decode_attention``    ``kernels/decode_attention/kernel.py::paged_decode_attention_fwd``
============================  ==============================================
"""

from typing import Dict

from .decode_attention import (
    decode_attention,
    decode_attention_plain,
    paged_decode_attention,
    paged_decode_attention_plain,
)
from .rmsnorm import rms_norm, rms_norm_plain

__all__ = [
    "KERNELS", "launch_counts", "reset_launch_counts",
    "rms_norm", "rms_norm_plain",
    "decode_attention", "decode_attention_plain",
    "paged_decode_attention", "paged_decode_attention_plain",
]

#: name -> wrapper; each wrapper's ``launches`` counts kernel launches.
KERNELS = {
    "rmsnorm": rms_norm,
    "decode_attention": decode_attention,
    "paged_decode_attention": paged_decode_attention,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
