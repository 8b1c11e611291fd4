"""Reference parameters whose zero and one leaves are made to count.

The reference's ``Model.init`` makes every bias zero and every norm scale
one, so a port that dropped ``qkv_bias``, LayerNorm's affine or the
qk-norm's scale would still agree with it. ``noisy_pair`` adds the same
seeded numpy noise to those leaves before both packages see them."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import build_model
from repro_torch.configs import get_config as port_config
from repro_torch.models import params_from_numpy

#: Leaves the reference initializes to zeros or ones: norm scales and
#: biases (LayerNorm's, the qk-norm's, the final norm's) and the q/k/v biases.
CONSTANT_LEAVES = ("scale", "bias", "bq", "bk", "bv")

#: The configs whose constant leaves carry arithmetic the port must repeat.
NOISY_ARCHS = ("qwen2.5-3b", "command-r-35b", "chameleon-34b", "qwen3-moe-30b-a3b")


def with_noise(tree, seed: int, scale: float = 0.1):
    """The numpy tree with ``scale`` x N(0, 1) (seeded) added to every
    ``CONSTANT_LEAVES`` leaf, each kept in its dtype."""
    rng = np.random.default_rng(seed)

    def walk(t, key):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, key) for v in t)
        a = np.asarray(t)
        if key in CONSTANT_LEAVES:
            a = (a.astype(np.float32) + scale * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return walk(tree, None)


@functools.lru_cache(maxsize=None)
def noisy_pair(arch: str, dropless: bool = False, seed: int = 0):
    """(reference model, reference params with noisy constant leaves, port
    config, the same params bridged to the port on the CPU) for ``arch``
    reduced; ``dropless`` sets an MoE's ``dropless`` in both."""
    def cut(cfg):
        cfg = cfg.reduced()
        if dropless:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dropless=True))
        return cfg

    ref = build_model(cut(get_config(arch)))
    tree = with_noise(jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0))), seed)
    cfg = cut(port_config(arch))
    return (ref, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_numpy(cfg, tree, device="cpu"))
