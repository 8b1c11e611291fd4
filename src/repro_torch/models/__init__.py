"""Models of the port (PyTorch definitions): GQA decoders (dense,
parallel-block and top-k MoE), DeepSeek's MLA + MoE decoder, the xLSTM
stack (mLSTM and sLSTM blocks) and the Mamba2 + shared-attention hybrid."""

from .bridge import params_from_numpy
from .model import Model, build_model, count_params_analytic

__all__ = ["Model", "build_model", "count_params_analytic", "params_from_numpy"]
