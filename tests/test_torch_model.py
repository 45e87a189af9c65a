"""The port's ``Model.decode_step(commit=)`` against the JAX engine's
``_commit(old, model.decode_step(...), mask)``, on logits and caches.

A 16-token rollout in fp32 (atol 1e-4) over 4 slots that start at
different lengths, one of them past Smax, with a commit mask that leaves
one slot out each step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.models import build_model
from repro.serving import ServingEngine
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import Model

torch.set_num_threads(1)

B, SMAX, STEPS = 4, 16, 16


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(configs.get_smoke("granite-3-2b"),
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke("granite-3-2b"),
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = bridge.params_into(Model(tcfg, device="cpu"),
                                jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tmodel


def test_decode_step_commit_matches_jax_rollout(pair):
    jmodel, params, tmodel = pair
    rng = np.random.default_rng(0)
    spec = tmodel.cache_spec(B, SMAX)
    assert {n: s.shape for n, s in spec.items()} == \
        {n: s.shape for n, s in jmodel.cache_spec(B, SMAX).items()}
    cache = {n: rng.normal(0, 1, s.shape).astype(np.float32)
             for n, s in spec.items()}
    jcache = {n: jnp.asarray(a) for n, a in cache.items()}
    tcache = bridge.cache_to_torch(cache)
    lengths = np.array([0, 4, 12, SMAX + 1], np.int32)
    decode = jax.jit(jmodel.decode_step)
    for step in range(STEPS):
        tokens = rng.integers(0, 256, (B,)).astype(np.int32)
        mask = np.arange(B) != step % B
        logits, new = decode(params, jcache, jnp.asarray(tokens),
                             jnp.asarray(lengths))
        jcache = ServingEngine._commit(jcache, new, jnp.asarray(mask))
        tlogits, out_cache = tmodel.decode_step(
            torch.from_numpy(tokens).long(), torch.from_numpy(lengths),
            tcache, commit=torch.from_numpy(mask))
        assert out_cache is tcache          # updated in place
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits),
                                   atol=1e-4, rtol=0)
        for n in ("k", "v"):
            np.testing.assert_allclose(tcache[n].numpy(),
                                       np.asarray(jcache[n]), atol=1e-4,
                                       rtol=0)
        lengths = lengths + mask.astype(np.int32)
    assert lengths.max() >= SMAX + 1 and lengths.min() <= SMAX


def test_return_hidden_is_the_prefinal_norm_state(pair):
    jmodel, params, tmodel = pair
    cache = tmodel.init_cache(B, SMAX)
    tokens = torch.tensor([1, 2, 3, 4])
    lengths = torch.zeros(B, dtype=torch.int32)
    logits, _, hidden = tmodel.decode_step(tokens, lengths, cache,
                                           return_hidden=True)
    jl, _, jh = jmodel.decode_step(params, jmodel.init_cache(B, SMAX),
                                   jnp.asarray(tokens.numpy(), jnp.int32),
                                   jnp.zeros(B, jnp.int32),
                                   return_hidden=True)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-5)


def test_init_draws_from_the_generator():
    cfg = tconfigs.get_smoke("granite-3-2b")
    a = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    b = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    c = Model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    wq = [m.layers[1].mixer["wq"] for m in (a, b, c)]
    assert torch.equal(wq[0], wq[1]) and not torch.equal(wq[0], wq[2])
    assert wq[0].dtype == torch.bfloat16
    assert torch.equal(a.layers[0].mlp["ln"], torch.ones(64,
                                                         dtype=torch.bfloat16))
    n = sum(p.numel() for p in a.parameters())
    norms = (2 * cfg.n_layers + 1) * cfg.d_model   # param_count omits them
    assert n == cfg.param_count() + norms
