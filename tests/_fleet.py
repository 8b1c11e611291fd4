"""Shared set-up of the port's observability and fleet tests: the reduced
smollm-135m pair (the reference's model and parameters, the port's model
and the same parameters bridged), the reference's seeded traffic, and the
three-replica chaos fleet of ``tests/test_obs.py``, built from either
package's classes."""

import functools
import types

import jax
import numpy as np

import repro.core.delay_models as ref_delay
import repro.obs as ref_obs
import repro.runtime.faults as ref_faults
import repro.serve as ref_serve
from repro.configs import get_config
from repro.models import build_model
import repro_torch.core.delay_models as port_delay
import repro_torch.obs as port_obs
import repro_torch.runtime.faults as port_faults
import repro_torch.serve as port_serve
from repro_torch.configs import get_config as port_config
from repro_torch.models import Model, params_from_numpy

MAX_LEN = 64

#: Each package's classes under one set of names.
PKGS = {
    name: types.SimpleNamespace(serve=serve, obs=obs, FaultEvent=faults.FaultEvent,
                                Delay=delay.SimplifiedDelayModel)
    for name, serve, obs, faults, delay in (
        ("ref", ref_serve, ref_obs, ref_faults, ref_delay),
        ("port", port_serve, port_obs, port_faults, port_delay))
}


@functools.lru_cache(maxsize=None)
def pair(arch: str = "smollm-135m"):
    """(reference model, its params, port model, the same params on the
    CPU), reduced width, f32."""
    ref = build_model(get_config(arch).reduced())
    jp = ref.init(jax.random.PRNGKey(0))
    cfg = port_config(arch).reduced()
    return ref, jp, Model(cfg), params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                                  device="cpu")


def model_params(pkg: str, arch: str = "smollm-135m"):
    ref, jp, model, params = pair(arch)
    return (ref, jp) if pkg == "ref" else (model, params)


def prompts(vocab, n=8, seed=1):
    """The reference tests' traffic: prompts of 4-15 tokens, 6-13 new
    tokens, arrivals 2 ms apart."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = int(rng.integers(4, 16))
        m = int(rng.integers(6, 14))
        out.append((rng.integers(0, vocab, size=p).astype(np.int32), m, i * 0.002))
    return out


def fleet(pkg: str, n=3, n_slots=2, obs=None, **kw):
    """``n`` paged replicas (block 8) of the reduced smollm-135m over one
    params dict, from package ``pkg``."""
    ns = PKGS[pkg]
    return [ns.serve.Replica(i, *model_params(pkg), n_slots=n_slots, max_len=MAX_LEN,
                             block_size=8, obs=obs, **kw) for i in range(n)]


def chaos_run(pkg: str, obs, **fe_kw):
    """``tests/test_obs.py``'s ``_chaos_run``: a 3-replica plane, replica
    1 killed at tick 12 and rejoined at tick 60, deadline 0.5, retry
    budget 3. Returns (frontend, streams)."""
    ns = PKGS[pkg]
    reqs = prompts(pair()[2].cfg.vocab_size, n=8, seed=5)
    fe = ns.serve.Frontend(
        fleet(pkg, obs=obs), ns.Delay(lambda_y=2.0), cost_per_replica=0.001,
        events=[ns.FaultEvent(step=12, kind="fail", worker=1),
                ns.FaultEvent(step=60, kind="rejoin", worker=1)],
        deadline=0.5, retry_budget=3, obs=obs, **fe_kw)
    gids = [fe.submit(p, m, arrival=a) for p, m, a in reqs]
    out = fe.run()
    assert fe.summary()["dropped"] == 0
    return fe, [out[g].tokens for g in gids]
