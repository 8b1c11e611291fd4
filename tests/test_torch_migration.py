"""Request migration in the port, against the reference, on the CPU.

``export_request`` snapshots a decoding request's slot into a checksummed
``MigrationTicket`` and frees the slot; ``import_request`` restores it
into another engine, which finishes the stream with no re-prefill. For
reduced smollm-135m and zamba2 (f32), over both pools: the stitched
stream equals the port's ``generate_offline`` and the reference engine's
stitched stream; the source is fully released; a full destination
returns None; a ticket whose prompt, budget, emitted tokens, pending
token, position or any snapshot leaf changed by one byte is refused
before anything is allocated, while a changed deadline is not; and a
ticket stays valid after its source slot is re-used and overwritten (the
port's caches change in place, so a snapshot must hold copies).
"""

import _torch_threads  # noqa: F401  (a pytest-xdist worker's torch threads)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import build_model
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.serve import (
    ServeEngine,
    SlotSnapshot,
    TicketIntegrityError,
    generate_offline,
    ticket_checksum,
)

MAX_LEN = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pairs():
    """arch -> (reference model, its params, port model, bridged params)."""
    out = {}
    for arch in ("smollm-135m", "zamba2"):
        ref = build_model(get_config(arch).reduced())
        jp = ref.init(jax.random.PRNGKey(0))
        cfg = port_config(arch).reduced()
        out[arch] = (ref, jp, Model(cfg),
                     params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def _decode_until(eng, rid, n_tokens):
    while len(eng.request(rid).tokens) < n_tokens:
        eng.step()


def _ticket(model, params, prompt, new=10, after=4, **kw):
    src = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, **kw)
    rid = src.submit(prompt, new)
    _decode_until(src, rid, after)
    return src, src.export_request(rid)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2"])
def test_migrated_stream_matches_offline_and_reference(pairs, arch, paged):
    """Export after 4 of 10 tokens, import into a second engine, finish
    there: the stream equals offline decode and the reference's stitched
    stream, and the source holds nothing."""
    ref, jp, model, params = pairs[arch]
    prompt = np.random.default_rng(0).integers(0, model.cfg.vocab_size, 12).astype(np.int32)
    kw = dict(block_size=8) if paged else {}
    streams = []
    for Engine, mp in ((ServeEngine, (model, params)), (RefEngine, (ref, jp))):
        src = Engine(*mp, n_slots=2, max_len=MAX_LEN, **kw)
        dst = Engine(*mp, n_slots=2, max_len=MAX_LEN, **kw)
        rid = src.submit(prompt, 10)
        _decode_until(src, rid, 4)
        ticket = src.export_request(rid)
        assert src.request(rid).cancel_reason == "migrated"
        assert src.pool.n_active == 0 and rid not in src.decoding_rids()
        assert src.live_rids() == []
        if paged:
            assert src.pool.manager.n_free_blocks == src.pool.manager.num_blocks
            src.pool.manager.check()
        new = dst.import_request(ticket)
        assert new is not None and dst.decoding_rids() == [new]
        streams.append(dst.run()[new].tokens)
        assert dst.stats.migrated_in == 1 and src.stats.migrated_out == 1
        assert src.events[-1][0] == "migrate_out" and dst.events[0][0] == "migrate_in"
    assert streams[0] == streams[1] == generate_offline(model, params, prompt, 10, MAX_LEN)


def test_full_destination_returns_none(pairs):
    """A full pool refuses the ticket (None) without touching anything;
    once the blocker is cancelled the ticket lands and finishes."""
    _, _, model, params = pairs["smollm-135m"]
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, model.cfg.vocab_size, 8).astype(np.int32)
    dst = ServeEngine(model, params, n_slots=1, max_len=MAX_LEN, block_size=8)
    blocker = dst.submit(rng.integers(0, model.cfg.vocab_size, 8).astype(np.int32), 20)
    _decode_until(dst, blocker, 1)
    _, ticket = _ticket(model, params, prompt, after=3, block_size=8)
    used = dst.pool.manager.n_used_blocks
    assert dst.import_request(ticket) is None
    assert dst.pool.manager.n_used_blocks == used and dst.stats.migrated_in == 0
    dst.cancel(blocker)
    rid = dst.import_request(ticket)
    assert rid is not None
    assert dst.run()[rid].tokens == generate_offline(model, params, prompt, 10, MAX_LEN)


def _flip(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with one bit of its first byte flipped."""
    out = t.clone()
    out.reshape(-1)[:1].view(torch.uint8)[0] ^= 1
    return out


def _corrupted(ticket, field, leaf=0):
    """The ticket with one field changed by one byte, its seal kept."""
    if field == "prompt":
        prompt = ticket.prompt.copy()
        prompt.view(np.uint8)[0] ^= 1
        return dataclasses.replace(ticket, prompt=prompt)
    if field == "tokens":
        return dataclasses.replace(ticket, tokens=(ticket.tokens[0] ^ 1,) + ticket.tokens[1:])
    if field in ("pending", "max_new_tokens"):
        return dataclasses.replace(ticket, **{field: getattr(ticket, field) ^ 1})
    snap = ticket.snapshot
    if field == "position":
        return dataclasses.replace(ticket, snapshot=dataclasses.replace(
            snap, position=snap.position ^ 1))
    seen = []

    def flip_one(t):
        seen.append(t)
        return _flip(t) if len(seen) - 1 == leaf else t
    return dataclasses.replace(ticket, snapshot=dataclasses.replace(
        snap, data=tree_map(flip_one, snap.data, is_leaf=torch.is_tensor)))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2"])
def test_corrupt_ticket_is_refused_before_allocation(pairs, arch, paged):
    """One byte of the prompt, the budget, an emitted token, the pending
    token, the snapshot's position or of ANY snapshot leaf: the import
    raises ``TicketIntegrityError`` and the destination is unchanged. The
    deadline is outside the seal, and a ticket with another deadline
    lands."""
    _, _, model, params = pairs[arch]
    prompt = np.random.default_rng(3).integers(0, model.cfg.vocab_size, 12).astype(np.int32)
    kw = dict(block_size=8) if paged else {}
    _, ticket = _ticket(model, params, prompt, **kw)
    assert ticket.checksum == ticket_checksum(ticket)
    dst = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, **kw)
    before = [t.clone() for t in tree_leaves(dst.pool.caches, is_leaf=torch.is_tensor)]
    n_leaves = len(tree_leaves(ticket.snapshot.data, is_leaf=torch.is_tensor))
    cases = [(f, 0) for f in ("prompt", "tokens", "pending", "max_new_tokens", "position")]
    cases += [("leaf", i) for i in range(n_leaves)]
    for field, leaf in cases:
        with pytest.raises(TicketIntegrityError):
            dst.import_request(_corrupted(ticket, field, leaf))
        assert dst.pool.n_active == 0 and dst._next_rid == 0, (field, leaf)
        if paged:
            assert dst.pool.manager.n_used_blocks == 0
    after = tree_leaves(dst.pool.caches, is_leaf=torch.is_tensor)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    rid = dst.import_request(dataclasses.replace(ticket, deadline=1e9))
    assert rid is not None
    assert dst.run()[rid].tokens == generate_offline(model, params, prompt, 10, MAX_LEN)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2"])
def test_ticket_survives_reuse_of_its_source_slot(pairs, arch, paged):
    """After the export the source engine serves another request in the
    same slot (and, paged, the same blocks), overwriting every row the
    ticket came from; the ticket still verifies and resumes the same
    stream. A snapshot holding views of the pool fails here."""
    _, _, model, params = pairs[arch]
    rng = np.random.default_rng(7)
    V = model.cfg.vocab_size
    prompt = rng.integers(0, V, 12).astype(np.int32)
    kw = dict(block_size=8) if paged else {}
    src, ticket = _ticket(model, params, prompt, **kw)
    snap = ticket.snapshot
    assert isinstance(snap, SlotSnapshot) and snap.position == 12 + 4 - 1
    held = [t.clone() for t in tree_leaves(snap.data, is_leaf=torch.is_tensor)]
    other = src.submit(rng.integers(0, V, 20).astype(np.int32), 12)
    assert src.run()[other].t_done is not None
    assert all(torch.equal(a, b)
               for a, b in zip(held, tree_leaves(snap.data, is_leaf=torch.is_tensor)))
    assert ticket_checksum(ticket) == ticket.checksum
    dst = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN, **kw)
    rid = dst.import_request(ticket)
    assert dst.run()[rid].tokens == generate_offline(model, params, prompt, 10, MAX_LEN)
