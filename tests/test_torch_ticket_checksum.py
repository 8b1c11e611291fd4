"""The port's ``ticket_checksum`` against the reference's, on the CPU.

Both hash the prompt, budget, emitted tokens, pending token, the
snapshot's position and block count, and every snapshot leaf (its shape
and numpy's dtype string, then its raw bytes) in the order
``jax.tree_util`` flattens the snapshot's tree: a dict's values sorted by
key (a 0-d leaf hashed as shape (1,), as ``np.ascontiguousarray`` makes
it). Tickets built from equal numpy leaves get equal digests, in f32,
int32 and bf16, with dict keys inserted out of order.

Engine-made snapshots hold the same cache rows in two layouts: the
reference stacks a segment's layers along a leading axis (one ``{"k",
"v"}`` a segment), the port keeps one ``{"k", "v"}`` a layer. Their
digests differ for that reason alone, so the engine-made case compares
a port ticket holding the reference snapshot's own leaves, in its
layout, with the reference's seal.
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import build_model
from repro.serve import ServeEngine as RefEngine
from repro.serve.engine import MigrationTicket as RefTicket
from repro.serve.engine import ticket_checksum as ref_checksum
from repro.serve.kv_pool import SlotSnapshot as RefSnapshot
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.serve import MigrationTicket, ServeEngine, SlotSnapshot, ticket_checksum

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "int32": (np.int32, jnp.int32, torch.int32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _leaves(rng, dtypes):
    """A nested tree of numpy leaves, its dict keys inserted out of
    sorted order; ``dtypes`` cycles over the leaves."""
    shapes = [(2, 3), (4,), (1, 2, 2), (), (3, 1)]
    arrs = []
    for i, shape in enumerate(shapes):
        np_dt = DTYPES[dtypes[i % len(dtypes)]][0]
        if np_dt == np.int32:
            arrs.append(rng.integers(-1000, 1000, size=shape).astype(np.int32))
        else:
            arrs.append(rng.standard_normal(shape).astype(np.float32))
    return {"v": arrs[0], "k": [arrs[1], {"z": arrs[2], "b": arrs[3]}], "a": (arrs[4],)}


def _convert(tree, dtypes, to, counter=None):
    """The same tree with each leaf made by ``to(array, dtype name)``."""
    counter = counter if counter is not None else [0]
    if isinstance(tree, dict):
        return {k: _convert(v, dtypes, to, counter) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, dtypes, to, counter) for v in tree)
    name = dtypes[counter[0] % len(dtypes)]
    counter[0] += 1
    return to(tree, name)


def _tickets(data_ref, data_port):
    fields = dict(prompt=np.array([5, 9, 2, 7], np.int32), max_new_tokens=12, arrival=0.25,
                  deadline=None, tokens=(3, 1, 4), pending=4)
    snap = dict(position=6, n_blocks=0, block_size=None, rows=32)
    return (RefTicket(snapshot=RefSnapshot(data=data_ref, **snap), **fields),
            MigrationTicket(snapshot=SlotSnapshot(data=data_port, **snap), **fields))


@pytest.mark.parametrize("dtypes", [("float32",), ("int32",), ("bfloat16",),
                                    ("bfloat16", "int32", "float32")])
def test_equal_leaves_give_the_reference_digest(dtypes):
    """Tickets from equal numpy leaves: the port's digest is the
    reference's; reinserting the port's dict keys in another order
    changes nothing; one changed byte of a leaf changes it."""
    rng = np.random.default_rng(len(dtypes))
    tree = _leaves(rng, dtypes)
    ref_tree = _convert(tree, dtypes, lambda a, n: jnp.asarray(a, DTYPES[n][1]))
    port_tree = _convert(tree, dtypes, lambda a, n: torch.from_numpy(a).to(DTYPES[n][2]))
    ref_t, port_t = _tickets(ref_tree, port_tree)
    want = ref_checksum(ref_t)
    assert ticket_checksum(port_t) == want
    reordered = {k: port_tree[k] for k in sorted(port_tree)}
    assert list(reordered) != list(port_tree)
    assert ticket_checksum(_tickets(ref_tree, reordered)[1]) == want
    port_tree["v"] = port_tree["v"].clone()
    port_tree["v"].view(-1)[0] = port_tree["v"].view(-1)[1] + 1
    assert ticket_checksum(_tickets(ref_tree, port_tree)[1]) != want


def test_engine_snapshot_layouts_and_the_reference_seal():
    """A request exported mid-decode by each engine (reduced smollm-135m,
    f32, contiguous): the reference's snapshot stacks the two layers
    ((2, 1, 32, 2, 32) a leaf), the port's holds one (1, 32, 2, 32) leaf a
    layer, so their digests are not comparable. A port ticket holding the
    reference snapshot's leaves in the reference's layout has the
    reference engine's seal."""
    ref = build_model(get_config("smollm-135m").reduced())
    jp = ref.init(jax.random.PRNGKey(0))
    cfg = port_config("smollm-135m").reduced()
    pp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    prompt = np.arange(3, 13, dtype=np.int32)
    tickets = []
    for eng in (RefEngine(ref, jp, n_slots=2, max_len=32),
                ServeEngine(Model(cfg), pp, n_slots=2, max_len=32)):
        rid = eng.submit(prompt, 8)
        for _ in range(4):
            eng.step()
        tickets.append(eng.export_request(rid))
    ref_t, port_t = tickets
    assert ref_t.tokens == port_t.tokens and ref_t.snapshot.position == port_t.snapshot.position
    ref_shapes = [tuple(l.shape) for l in jax.tree_util.tree_leaves(ref_t.snapshot.data)]
    port_shapes = [tuple(l.shape) for s in port_t.snapshot.data for layer in s
                   for l in (layer["k"], layer["v"])]
    assert ref_shapes == [(2, 1, 32, 2, 32)] * 2
    assert port_shapes == [(1, 32, 2, 32)] * 4
    assert ticket_checksum(port_t) == port_t.checksum != ref_t.checksum

    data = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref_t.snapshot.data)
    held = MigrationTicket(
        prompt=ref_t.prompt, max_new_tokens=ref_t.max_new_tokens, arrival=ref_t.arrival,
        deadline=ref_t.deadline, tokens=ref_t.tokens, pending=ref_t.pending,
        snapshot=SlotSnapshot(data=data, position=ref_t.snapshot.position,
                              n_blocks=ref_t.snapshot.n_blocks,
                              block_size=ref_t.snapshot.block_size,
                              rows=ref_t.snapshot.rows))
    assert ticket_checksum(held) == ref_t.checksum
