"""The port's int8 error-feedback codec (``repro_torch.dist.compression``)
against the reference's (``repro.dist.compression``), on the CPU.

1. Twins of the reference's six codec tests (``tests/test_runtime.py``
   and ``tests/test_dist_collectives.py``) on the port: the round trip
   within scale/2, int8 codes, an all-zero tensor, the residual as the
   exact quantization error, the tree structure kept, and error-feedback
   SGD on a quadratic converging below 1e-2.
2. Parity: numpy-seeded f32 and bf16 leaves, a nested tree, exact
   halves (round half to even) and an all-zero tensor through both
   packages give equal ``q`` and ``scale`` and equal decoded and residual
   trees, bit for bit. No input is subnormal: XLA's CPU flushes
   subnormal floats to zero, PyTorch's does not, so a tensor whose
   absmax / 127 is subnormal gets scale 0 from the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.compression import Int8Codec as RefCodec
from repro.dist.compression import ef_compress_tree as ref_ef
from repro_torch.dist import Int8Codec, ef_compress_tree


def _bits(x) -> np.ndarray:
    """The f32 bit patterns of a tensor or array of any float dtype."""
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(np.asarray(x, np.float32)).view(np.uint32)


def _leaf(x: np.ndarray, dtype: str):
    """(jax array, torch tensor) of the same values in ``dtype``."""
    j = jnp.asarray(x, jnp.float32).astype(getattr(jnp, dtype))
    return j, torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# 1. Twins of the reference's codec tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(256,), (64, 33)])
def test_int8_roundtrip_bounded_by_half_scale(shape):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32))
    q, scale = Int8Codec.encode(x)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32 and scale.dim() == 0
    err = (Int8Codec.decode(q, scale) - x).abs().max().item()
    assert err <= float(scale) * 0.5 + 1e-9


def test_int8_zero_tensor_is_exact():
    q, scale = Int8Codec.encode(torch.zeros(17))
    assert float(scale) == 0.0
    assert torch.equal(Int8Codec.decode(q, scale), torch.zeros(17))


def test_ef_residual_is_exactly_the_quantization_error():
    x = {"a": torch.from_numpy(np.random.default_rng(1).normal(size=(40,)).astype(np.float32))}
    dec, new_resid = ef_compress_tree(x, {"a": torch.zeros(40)})
    torch.testing.assert_close(dec["a"] + new_resid["a"], x["a"], rtol=1e-6, atol=0)


def test_error_feedback_converges():
    """SGD on a quadratic with int8-compressed gradients and error
    feedback still converges."""
    params = {"w": torch.tensor([5.0, -3.0, 2.0, -1.0])}
    resid = {"w": torch.zeros(4)}
    for _ in range(300):
        dec, resid = ef_compress_tree({"w": 2 * params["w"]}, resid)
        params = {"w": params["w"] - 0.05 * dec["w"]}
    assert params["w"].abs().max().item() < 1e-2


def test_ef_compress_tree_structure_and_convergence():
    """The nested structure is kept leaf for leaf, and EF-SGD reaches the
    uncompressed fixed point."""
    params = {"w": torch.tensor([4.0, -2.0]), "nest": {"b": torch.tensor([[1.0, -3.0]])}}
    resid = {"w": torch.zeros(2), "nest": {"b": torch.zeros(1, 2)}}
    for _ in range(400):
        grads = {"w": 2 * params["w"], "nest": {"b": 2 * params["nest"]["b"]}}
        dec, resid = ef_compress_tree(grads, resid)
        assert set(dec) == {"w", "nest"} and set(dec["nest"]) == {"b"}
        assert dec["nest"]["b"].shape == (1, 2) and resid["nest"]["b"].shape == (1, 2)
        params = {"w": params["w"] - 0.05 * dec["w"],
                  "nest": {"b": params["nest"]["b"] - 0.05 * dec["nest"]["b"]}}
    assert max(params["w"].abs().max().item(), params["nest"]["b"].abs().max().item()) < 1e-2


def test_ef_compress_tree_refuses_mismatched_structures():
    g = {"a": torch.ones(3), "b": [torch.ones(2), torch.ones(2)]}
    for r in ({"a": torch.zeros(3)}, {"a": torch.zeros(3), "c": [torch.zeros(2)] * 2},
              {"a": torch.zeros(3), "b": [torch.zeros(2)]},
              {"a": torch.zeros(3), "b": (torch.zeros(2), torch.zeros(2))}):
        with pytest.raises(ValueError, match="structures do not match"):
            ef_compress_tree(g, r)
    # dict key order is not structure (a jax treedef sorts the keys)
    dec, _ = ef_compress_tree(g, {"b": [torch.zeros(2)] * 2, "a": torch.zeros(3)})
    assert list(dec) == ["a", "b"]


# ---------------------------------------------------------------------------
# 2. Parity with the reference, bit for bit
# ---------------------------------------------------------------------------

def _inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "normal": rng.normal(size=(64, 33)),
        "wide": rng.normal(size=(3, 257)) * np.exp(rng.uniform(-12, 12, size=(3, 257))),
        "halves": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5, 64.5]),
        "negative_max": -np.abs(rng.normal(size=(50,))) * 3.0,
        "zeros": np.zeros((17,)),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(_inputs(0)))
def test_encode_decode_equal_to_reference(name, dtype):
    jx, tx = _leaf(_inputs(3)[name], dtype)
    jq, js = RefCodec.encode(jx)
    q, s = Int8Codec.encode(tx)
    assert np.array_equal(np.asarray(jq), q.numpy())
    assert _bits(js) == _bits(s)
    assert np.array_equal(_bits(RefCodec.decode(jq, js)), _bits(Int8Codec.decode(q, s)))


@pytest.mark.parametrize("rounds", [1, 3])
def test_ef_compress_tree_equal_to_reference(rounds):
    """A nested tree of f32 and bf16 leaves (and an all-zero leaf), fed its
    own residuals for ``rounds`` rounds: decoded and residual trees equal
    the reference's bit for bit, dtypes included."""
    rng = np.random.default_rng(11)
    spec = {"embed": ((32, 16), "bfloat16"), "zero": ((5,), "float32"),
            "layer": {"wq": ((16, 16), "bfloat16"), "scale": ((16,), "float32"),
                      "mlp": {"up": ((16, 40), "bfloat16"), "down": ((40, 16), "float32")}}}

    def tree(s, make):
        return {k: tree(v, make) for k, v in s.items()} if isinstance(s, dict) else make(*s)

    def split(pairs, i):
        return jax.tree.map(lambda p: p[i], pairs, is_leaf=lambda p: isinstance(p, tuple))

    def grad(shape, dtype):
        return _leaf(np.zeros(shape) if shape == (5,) else rng.normal(size=shape), dtype)

    zeros = tree(spec, lambda shape, _: (jnp.zeros(shape), torch.zeros(shape)))
    jr, tr = split(zeros, 0), split(zeros, 1)
    for _ in range(rounds):
        g = tree(spec, grad)
        jg, tg = split(g, 0), split(g, 1)
        jd, jr = ref_ef(jg, jr)
        td, tr = ef_compress_tree(tg, tr)
        jl, tl = jax.tree.leaves(jd), jax.tree.leaves(td)
        assert [str(x.dtype) for x in jl] == [str(x.dtype).replace("torch.", "") for x in tl]
        for a, b in zip(jl + jax.tree.leaves(jr), tl + jax.tree.leaves(tr)):
            assert np.array_equal(_bits(a), _bits(b))
        assert all(x.dtype == torch.float32 for x in jax.tree.leaves(tr))
