"""The port's mamba2 (SSM family) against the JAX package on the
mamba2-780m smoke config, with JAX's weights carried across by
``bridge.params_into``: the SSD block, ``Model.forward_train``,
``prefill`` and ``decode_step(commit=)``, and the fig12 serving drive.

fp32 throughout (blocks within 1e-5, the model within 1e-4, greedy
tokens identical), but for one bf16 case held within 2e-2 of each
tensor's largest magnitude (see its docstring).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.models import build_model
from repro.models import ssd as jssd
from repro.runtime import RetryPolicy
from repro.serving import ServingEngine
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.models import ssd as tssd
from repro_torch.runtime import RetryPolicy as TRetryPolicy
from repro_torch.serving import ServingEngine as TServingEngine
from repro_torch.serving import kv_cache

torch.set_num_threads(1)

ARCH = "mamba2-780m"
B, S = 2, 16
ATOL = 1e-4
LEAVES = ("state", "conv_x", "conv_B", "conv_C")


def _pair(dtype="float32"):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = dataclasses.replace(configs.get_smoke(ARCH), param_dtype=jdt,
                               compute_dtype=jdt)
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), param_dtype=tdt,
                               compute_dtype=tdt)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    npp = jax.tree_util.tree_map(np.asarray, params)
    # dt_bias and A_log start at 0 and Dskip at 1: give every head its own
    rng = np.random.default_rng(9)
    mixer = npp["layers"]["mixer"]
    for name, scale in (("dt_bias", 1.0), ("A_log", 0.5), ("Dskip", 1.0)):
        mixer[name] = rng.normal(0, scale, mixer[name].shape).astype(
            mixer[name].dtype)
    params = jax.tree_util.tree_map(jnp.asarray, npp)
    tmodel = bridge.params_into(Model(tcfg, device="cpu"), npp)
    return jmodel, params, npp, tmodel


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _tokens(seed, vocab, b=B, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _np(t):
    return bridge.to_numpy(t).astype(np.float32)


def test_model_has_ssd_blocks_without_mlp(pair):
    _, _, npp, tmodel = pair
    assert set(npp["layers"]) == {"mixer"}
    assert all(blk.kind == "ssd" and not hasattr(blk, "mlp")
               for blk in tmodel.layers)
    spec = tmodel.cache_spec(3, 64)
    cw = tmodel.cfg.conv_width
    assert spec["state"].shape == (2, 3, 16, 8, 16)
    assert spec["state"].dtype == torch.float32
    assert spec["conv_x"].shape == (2, 3, cw - 1, 128)
    assert spec["conv_B"].shape == spec["conv_C"].shape == (2, 3, cw - 1, 16)
    # a slot's payload is its state and conv history: no max_seq in it
    assert (kv_cache.session_cache_bytes(tmodel, 64)
            == kv_cache.session_cache_bytes(tmodel, 4096))


@pytest.mark.parametrize("change", [
    dict(family="moe", n_experts=4, moe_top_k=2),
    dict(family="dense", mla=True),
    dict(family="vlm", frontend="vision"),
    dict(family="encoder", frontend="audio"),
])
def test_unported_families_are_refused(change):
    cfg = dataclasses.replace(tconfigs.get_smoke(ARCH), **change)
    with pytest.raises(NotImplementedError, match="dense and ssm"):
        Model(cfg, device="cpu")


@pytest.mark.parametrize("seq", [16, 13])
def test_block_train_prefill_decode_match_jax(pair, seq):
    jmodel, _, npp, _ = pair
    jcfg = jmodel.cfg
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH),
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32)
    p = jax.tree_util.tree_map(lambda a: a[1], npp["layers"]["mixer"])
    tp = {n: bridge.to_torch(a) for n, a in p.items()}
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (B, seq, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tssd.ssd_train(tp, tcfg, torch.from_numpy(x)).numpy(),
        np.asarray(jssd.ssd_train(p, jcfg, jnp.asarray(x))), atol=1e-5)
    jx, jc = jssd.ssd_prefill(p, jcfg, jnp.asarray(x))
    tx, tc = tssd.ssd_prefill(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    assert set(tc) == set(jc) == set(LEAVES)
    for n in LEAVES:
        assert tuple(tc[n].shape) == jc[n].shape
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=1e-5)
    # one decode step from a random cache
    cache = {n: rng.normal(0, 1, s.shape).astype(np.float32)
             for n, s in tssd.ssd_cache_spec(tcfg, B, 32).items()}
    xt = rng.normal(0, 1, (B, 64)).astype(np.float32)
    lengths = np.array([3, 7], np.int32)
    jy, jnew = jssd.ssd_decode(p, jcfg, jnp.asarray(xt),
                               {n: jnp.asarray(a) for n, a in cache.items()},
                               jnp.asarray(lengths))
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    ty = tssd.ssd_decode(tp, tcfg, torch.from_numpy(xt), tcache,
                         torch.from_numpy(lengths))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    for n in LEAVES:                          # advanced in place
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jnew[n]),
                                   atol=1e-5)


@pytest.mark.parametrize("seq", [16, 13, 8, 2])
def test_prefill_and_forward_train_match_jax(pair, seq):
    """Full chunks, a ragged last chunk, one chunk, and a prompt shorter
    than the conv history (its conv caches keep its 2 rows, as the
    reference's do)."""
    jmodel, params, _, tmodel = pair
    toks = _tokens(2, tmodel.cfg.vocab_size, s=seq)
    jlogits, jcache = jax.jit(jmodel.prefill)(params,
                                              {"tokens": jnp.asarray(toks)})
    logits, cache = tmodel.prefill({"tokens": torch.from_numpy(toks)})
    assert logits.shape == (B, tmodel.cfg.vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL)
    assert set(cache) == set(jcache) == set(LEAVES)
    for n in LEAVES:
        assert tuple(cache[n].shape) == jcache[n].shape
        assert cache[n].dtype == torch.float32
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jcache[n]),
                                   atol=ATOL)
    assert cache["conv_x"].shape[2] == min(seq, tmodel.cfg.conv_width - 1)
    full = tmodel.forward_train({"tokens": torch.from_numpy(toks)})
    assert full.shape == (B, seq, tmodel.cfg.vocab_size)
    np.testing.assert_allclose(
        full.numpy(),
        np.asarray(jax.jit(jmodel.forward_train)(
            params, {"tokens": jnp.asarray(toks)})), atol=ATOL)


def test_decode_from_a_short_prompt_cache_fails_in_both(pair):
    """A reference fact the port follows: after a prompt shorter than
    cw-1 tokens the conv caches hold fewer rows than the cache spec, and
    a decode step straight from them fails in both packages."""
    jmodel, params, _, tmodel = pair
    toks = _tokens(3, tmodel.cfg.vocab_size, b=1, s=2)
    _, jcache = jmodel.prefill(params, {"tokens": jnp.asarray(toks)})
    _, cache = tmodel.prefill({"tokens": torch.from_numpy(toks)})
    with pytest.raises(ValueError):
        jmodel.decode_step(params, jcache, jnp.array([1], jnp.int32),
                           jnp.array([2], jnp.int32))
    with pytest.raises(RuntimeError):
        tmodel.decode_step(torch.tensor([1]), torch.tensor([2]), cache)


def test_prefill_then_decode_gives_jax_tokens(pair):
    """Prefill B=2 x 16, place each row in a serving slot of a 4-slot
    cache, then 4 greedy steps."""
    jmodel, params, _, tmodel = pair
    toks = _tokens(4, tmodel.cfg.vocab_size)
    slots = [3, 1]
    jlogits, jc = jax.jit(jmodel.prefill)(params,
                                          {"tokens": jnp.asarray(toks)})
    jcache = jmodel.init_cache(4, 32)
    jcache = {n: jcache[n].at[:, jnp.array(slots)].set(jc[n].astype(
        jcache[n].dtype)) for n in jcache}
    logits, pc = tmodel.prefill({"tokens": torch.from_numpy(toks)})
    cache = tmodel.init_cache(4, 32)
    for b, slot in enumerate(slots):
        kv_cache.write_slot(cache, {n: t[:, b:b + 1] for n, t in pc.items()},
                            slot)
    step = jax.jit(jmodel.decode_step)
    jtok = np.zeros(4, np.int32)
    jtok[slots] = np.asarray(jnp.argmax(jlogits, -1))
    tok = torch.zeros(4, dtype=torch.long)
    tok[slots] = logits.argmax(-1)
    lengths = np.zeros(4, np.int32)
    lengths[slots] = S
    for i in range(4):
        assert tok.tolist() == jtok.tolist()
        jlogits, jcache = step(params, jcache, jnp.asarray(jtok),
                               jnp.asarray(lengths + i))
        logits, cache = tmodel.decode_step(tok, torch.from_numpy(lengths + i),
                                           cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL)
        for n in LEAVES:
            np.testing.assert_allclose(cache[n].numpy(),
                                       np.asarray(jcache[n]), atol=ATOL)
        jtok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
        tok = logits.argmax(-1)
    assert tok.tolist() == jtok.tolist()


def test_decode_matches_forward_train(pair):
    """Teacher forcing: decode_step's logits at t == forward_train's."""
    tmodel = pair[3]
    toks = torch.from_numpy(_tokens(5, tmodel.cfg.vocab_size, 1, 12)).long()
    full = tmodel.forward_train({"tokens": toks})
    cache = tmodel.init_cache(1, 12)
    for t in range(12):
        logits, cache = tmodel.decode_step(
            toks[:, t], torch.full((1,), t, dtype=torch.int32), cache)
        torch.testing.assert_close(logits, full[:, t], atol=2e-4, rtol=2e-4)


def test_commit_keeps_uncommitted_slots_bit_for_bit(pair):
    """decode_step(commit=) against the JAX engine's _commit over 6 steps:
    committed slots advance as JAX's do, the others keep every bit."""
    jmodel, params, _, tmodel = pair
    rng = np.random.default_rng(6)
    cache = {n: rng.normal(0, 1, s.shape).astype(np.float32)
             for n, s in tmodel.cache_spec(4, 16).items()}
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    jcache = {n: jnp.asarray(a) for n, a in cache.items()}
    step = jax.jit(jmodel.decode_step)
    for i in range(6):
        toks = rng.integers(0, tmodel.cfg.vocab_size, 4).astype(np.int32)
        lengths = np.full(4, i, np.int32)
        mask = np.array([True, i % 2 == 0, False, i % 3 == 0])
        before = {n: t.clone() for n, t in tcache.items()}
        jlogits, jnew = step(params, jcache, jnp.asarray(toks),
                             jnp.asarray(lengths))
        jcache = ServingEngine._commit(jcache, jnew, jnp.asarray(mask))
        logits, out = tmodel.decode_step(
            torch.from_numpy(toks), torch.from_numpy(lengths), tcache,
            commit=torch.from_numpy(mask))
        assert out is tcache
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL)
        for n in LEAVES:
            assert torch.equal(tcache[n][:, ~torch.from_numpy(mask)],
                               before[n][:, ~torch.from_numpy(mask)])
            np.testing.assert_allclose(tcache[n].numpy(),
                                       np.asarray(jcache[n]), atol=ATOL)


def test_prefill_matches_jax_in_bf16():
    """bf16 mamba2.  The SSD block's silu gates and the conv round at
    other places in the two frameworks (XLA on the CPU rounds each step
    of the sigmoid to bf16; the port's fused ``silu`` rounds once), and
    one bf16 ulp of the largest activations reaches entries near 0, so
    logits and caches are held within 2e-2 of each tensor's largest
    magnitude."""
    jmodel, params, _, tmodel = _pair("bfloat16")
    toks = _tokens(7, tmodel.cfg.vocab_size)
    jlogits, jcache = jax.jit(jmodel.prefill)(params,
                                              {"tokens": jnp.asarray(toks)})
    logits, cache = tmodel.prefill({"tokens": torch.from_numpy(toks)})
    assert cache["conv_x"].dtype == torch.bfloat16
    assert cache["state"].dtype == torch.float32
    pairs = [(logits.numpy(), np.asarray(jlogits))]
    pairs += [(_np(cache[n]), np.asarray(jcache[n], np.float32))
              for n in LEAVES]
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


def test_prefill_launches_no_kernel_on_the_cpu(pair):
    tmodel = pair[3]
    before = ops.ssd.launches
    tmodel.prefill({"tokens": torch.from_numpy(_tokens(8, 256))})
    tmodel.forward_train({"tokens": torch.from_numpy(_tokens(8, 256))})
    assert ops.ssd.launches == before


# -- the fig12 drive (tests/test_torch_serving.py's schedule) on mamba2 -------

N_ROWS, MAX_SLOTS, MAX_SEQ = 3, 8, 128
N_SESSIONS, TURNS, GEN, CKPT_EVERY = 8, 6, 4, 2
SVC = {"decode_step": 1e-3, "prefill_per_tok": 1.25e-4}
DT = SVC["decode_step"]
CHAOS = {0: (), 2: ((0, 40, 30), (1, 55, 30))}   # (row, t_down, dur) in DT


def _engines(pair, policy, checkpoint_every):
    jmodel, params, _, tmodel = pair
    kw = dict(n_rows=N_ROWS, max_slots=MAX_SLOTS, max_seq=MAX_SEQ,
              policy=policy, checkpoint_every=checkpoint_every)
    jeng = ServingEngine(jmodel, params, **kw)
    teng = TServingEngine(tmodel, **kw)
    jeng.retry = RetryPolicy(max_attempts=4, backoff=2 * DT)
    teng.retry = TRetryPolicy(max_attempts=4, backoff=2 * DT)
    return jeng, teng


def drive(eng, intensity):
    eng._svc = dict(SVC)
    for row, t_down, dur in CHAOS[intensity]:
        eng.fail_row(row, at=t_down * DT, duration=dur * DT)
    for i in range(N_SESSIONS):
        eng.open_session(f"s{i}")
    t, outs = 0.0, {}
    for _ in range(TURNS):
        for i in range(N_SESSIONS):
            out, _ = eng.turn(f"s{i}", [1 + i, 2, 3], gen_tokens=GEN, now=t)
            outs.setdefault(f"s{i}", []).extend(out)
            t += 2 * DT
    return outs


@pytest.mark.parametrize("policy,intensity,ckpt", [
    ("affinity", 0, CKPT_EVERY), ("affinity", 2, CKPT_EVERY),
    ("random", 0, None)])
def test_fig12_drive_token_identical(pair, policy, intensity, ckpt):
    jeng, teng = _engines(pair, policy, ckpt)
    want = drive(jeng, intensity)
    got = drive(teng, intensity)
    assert got == want
    assert teng.summary() == jeng.summary()
    assert all(len(v) == TURNS * GEN for v in got.values())
    s = teng.summary()
    if intensity:
        assert s["recoveries_ckpt"] > 0 and s["sessions_displaced"] > 0
        assert s["checkpoint_bytes"] > 0
        assert s["shed_turns"] == 0 and s["dup_effects"] == 0
    if policy == "random":
        assert s["migrations"] > 0
