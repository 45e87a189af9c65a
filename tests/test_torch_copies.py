"""The port's copies of JAX-free reference modules give the reference's
answers: routing, batch pricing, retry backoff, and the slot moves of the
KV cache."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.models import build_model
from repro.runtime.batching import BatchCostModel
from repro.runtime.faults import RetryPolicy
from repro.serving import kv_cache as jkv
from repro.serving.adapters import AdapterStore
from repro.serving.sessions import Session, SessionRouter
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import Model
from repro_torch.runtime import BatchCostModel as TBatchCostModel
from repro_torch.runtime import RetryPolicy as TRetryPolicy
from repro_torch.serving import AdapterStore as TAdapterStore
from repro_torch.serving import Session as TSession
from repro_torch.serving import SessionRouter as TSessionRouter
from repro_torch.serving import apply_adapter, kv_cache, make_adapter

torch.set_num_threads(1)

POLICIES = ["affinity", "adapter_affinity", "random", "least_loaded"]


@pytest.mark.parametrize("policy", POLICIES)
def test_router_gives_the_reference_row_and_label(policy):
    ref, port = SessionRouter(4, policy=policy), TSessionRouter(4,
                                                                policy=policy)
    loads = [(1, 0.5, 3), (0, 0.2, 1), (0, 0.2, 0), (1, 0.0, 2)]
    for i in range(200):
        adapter = f"ad{i % 7}" if i % 3 else None
        js, ts = Session(f"s{i}", adapter=adapter), \
            TSession(f"s{i}", adapter=adapter)
        for turn in range(2):
            rid = f"s{i}:{turn}"
            assert port.route(ts, rid, row_loads=loads) == \
                ref.route(js, rid, row_loads=loads)
        assert port.label_of(ts) == ref.label_of(js)
    # a pinned group follows its pin in both
    ref.pin_group(ref.label_of(Session("s5")), 2)
    port.pin_group(port.label_of(TSession("s5")), 2)
    assert port.route(TSession("s5"), "s5:9") == \
        ref.route(Session("s5"), "s5:9")


def test_batch_cost_and_retry_backoff_match():
    for kw in ({}, {"fixed": 0.75, "marginal": 0.25, "max_batch": 32},
               {"fixed": 0.25, "marginal": 0.75, "max_batch": 4}):
        ref, port = BatchCostModel(**kw), TBatchCostModel(**kw)
        for n in range(0, 40):
            assert port.step_seconds(1.3e-3, n) == ref.step_seconds(1.3e-3, n)
            assert port.batch_seconds(0.7, n) == ref.batch_seconds(0.7, n)
        assert port.largest_within(1e-3, 5e-3, 1e-4) == \
            ref.largest_within(1e-3, 5e-3, 1e-4)
    for kw in ({}, {"max_attempts": 4, "backoff": 2e-3},
               {"backoff": 0.3, "multiplier": 3.0, "max_backoff": 2.0}):
        for attempt in range(1, 8):
            assert TRetryPolicy(**kw).backoff_of(attempt) == \
                RetryPolicy(**kw).backoff_of(attempt)


@pytest.fixture(scope="module")
def cache_pair():
    jcfg = dataclasses.replace(configs.get_smoke("granite-3-2b"),
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_smoke("granite-3-2b"),
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32)
    jmodel, tmodel = build_model(jcfg), Model(tcfg, device="cpu")
    rng = np.random.default_rng(0)
    cache = {n: rng.normal(0, 1, s.shape).astype(np.float32)
             for n, s in tmodel.cache_spec(4, 32).items()}
    return jmodel, tmodel, cache


def test_read_slot_is_a_copy_that_clear_slot_leaves_alone(cache_pair):
    _, _, cache = cache_pair
    tc = bridge.cache_to_torch(cache)
    snap = kv_cache.read_slot(tc, 2)
    assert snap["k"].shape == (2, 1, 32, 2, 16)
    kv_cache.clear_slot(tc, 2)
    assert torch.count_nonzero(tc["k"][:, 2]) == 0
    np.testing.assert_array_equal(snap["k"].numpy(), cache["k"][:, 2:3])
    np.testing.assert_array_equal(tc["v"][:, 1].numpy(), cache["v"][:, 1])


def test_slot_moves_and_bytes_match_the_reference(cache_pair):
    jmodel, tmodel, cache = cache_pair
    assert kv_cache.session_cache_bytes(tmodel, 32) == \
        jkv.session_cache_bytes(jmodel, 32)
    tc = bridge.cache_to_torch(cache)
    jc = {n: jnp.asarray(a) for n, a in cache.items()}
    assert kv_cache.tree_bytes(tc) == jkv.tree_bytes(jc)
    # a shorter sequence merges into the leading part of the slot
    short = {n: a[:, :1, :10] + 5.0 for n, a in cache.items()}
    kv_cache.write_slot(tc, bridge.cache_to_torch(short), 3)
    jc = jkv.write_slot(jc, {n: jnp.asarray(a) for n, a in short.items()}, 3)
    for n in ("k", "v"):
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))
    kv_cache.reset_cache(tc)
    assert all(torch.count_nonzero(t) == 0 for t in tc.values())


def test_adapters_price_and_apply_like_the_reference():
    ad = make_adapter(0, "a", 64, 256, device="cpu")
    assert ad.nbytes == (64 * 8 + 8 * 256) * 4
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(0, 1, (3, 256)).astype(np.float32))
    hidden = torch.from_numpy(rng.normal(0, 1, (3, 64)).astype(np.float32))
    torch.testing.assert_close(apply_adapter(logits, hidden, ad), logits)
    ref, port = AdapterStore(2), TAdapterStore(2)

    class _Ad:       # the reference store reads only name and nbytes
        name, nbytes = "a", ad.nbytes
    ref.register(_Ad())
    port.register(ad)
    for row, name in [(0, "a"), (0, "a"), (1, "a"), (1, None)]:
        assert port.peek_bytes(row, name) == ref.peek_bytes(row, name)
        assert port.ensure_resident(row, name) == \
            ref.ensure_resident(row, name)
    port.drop_row(0)
    ref.drop_row(0)
    assert port.peek_bytes(0, "a") == ref.peek_bytes(0, "a")
    assert (port.fetches, port.bytes_fetched) == (ref.fetches,
                                                  ref.bytes_fetched)


def test_bridge_carries_bf16_caches_both_ways():
    rng = np.random.default_rng(6)
    a = jnp.asarray(rng.normal(0, 1, (2, 3, 4, 2, 8)), jnp.bfloat16)
    cache = {"k": np.asarray(a), "v": np.asarray(a) * 2}
    assert cache["k"].dtype.name == "bfloat16"      # ml_dtypes, not torch's
    tc = bridge.cache_to_torch(cache)
    assert tc["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tc["v"].float().numpy(),
                                  cache["v"].astype(np.float32))
    back = bridge.cache_to_numpy(tc)
    for n in ("k", "v"):
        assert back[n].dtype == cache[n].dtype
        np.testing.assert_array_equal(back[n], cache[n])
