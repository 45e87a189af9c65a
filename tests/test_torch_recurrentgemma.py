"""The port's hybrid family (recurrentgemma: RG-LRU blocks and local
attention in a (rglru, rglru, attn) pattern) against the JAX package on
the recurrentgemma-9b smoke config, with JAX's weights carried across by
``bridge.params_into``: the RG-LRU block, the ring-window decode block,
``Model.forward_train``, ``prefill`` and ``decode_step(commit=)``.

fp32 throughout (blocks within 1e-5, the model within 1e-4, greedy tokens
identical), but for one bf16 case (see its docstring).  The smoke window
is 8, so prompts of 5, 8, 12 and 16 tokens sit below, at and above it.  Two reference facts are reproduced,
not corrected (ROADMAP queue 3): ``prefill`` attends over the whole
prompt where ``forward_train`` keeps the window, and a local-attention
layer's prefill cache is its last min(S, window) keys, so a decode from
a placed cache follows the ring only while S + 1 <= window.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.models import build_model
from repro.models import model as jmodel_mod
from repro.models import rglru as jrglru
from repro.serving import ServingEngine
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.models import model as tmodel_mod
from repro_torch.models import rglru as trglru
from repro_torch.serving import ServingEngine as TServingEngine

torch.set_num_threads(1)

ARCH = "recurrentgemma-9b"
B = 2
ATOL = 1e-4
WINDOW = 8


def _cfgs(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = dataclasses.replace(configs.get_smoke(ARCH), param_dtype=jdt,
                               compute_dtype=jdt)
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), param_dtype=tdt,
                               compute_dtype=tdt)
    return jcfg, tcfg


def _pair(dtype="float32"):
    jcfg, tcfg = _cfgs(dtype)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    npp = jax.tree_util.tree_map(np.asarray, params)
    # lam starts at 1 and the gate biases at 0: give every channel its own
    rng = np.random.default_rng(9)
    for sub in (npp["groups"]["b0"], npp["groups"]["b1"],
                npp["tail"]["t0"], npp["tail"]["t1"]):
        mixer = sub["mixer"]
        for name, scale in (("lam", 1.0), ("gate_a_b", 0.5),
                            ("gate_x_b", 0.5), ("conv_b", 0.5)):
            mixer[name] = rng.normal(0, scale, mixer[name].shape).astype(
                mixer[name].dtype)
    params = jax.tree_util.tree_map(jnp.asarray, npp)
    tmodel = bridge.params_into(Model(tcfg, device="cpu"), npp)
    return jmodel, params, npp, tmodel


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def jitted(pair):
    jmodel = pair[0]
    return (jax.jit(jmodel.prefill), jax.jit(jmodel.forward_train),
            jax.jit(jmodel.decode_step))


def _tokens(seed, vocab=256, b=B, s=12):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _flat(tree):
    return {n: np.asarray(a, np.float32)
            for n, a in bridge._flatten(jax.tree_util.tree_map(np.asarray,
                                                               tree))}


def _assert_cache_close(cache, jcache, atol=ATOL):
    want = _flat(jcache)
    assert set(cache) == set(want)
    for n, t in cache.items():
        assert tuple(t.shape) == want[n].shape, n
        np.testing.assert_allclose(t.float().numpy(), want[n], atol=atol,
                                   err_msg=n)


def _np_place(cache, prefill, row, slot):
    """The reference tests' merge of a prefill row into a decode cache
    (``.at[slot, :n].set``), on numpy leaves, by each leaf's slot axis."""
    out = {}
    for n, dst in cache.items():
        dst = np.array(dst)
        ax = 0 if n.startswith("tail/") else 1
        src = np.take(prefill[n], row, axis=ax)
        idx = (slice(None),) * ax + (slot,) + tuple(
            slice(0, k) for k in src.shape[ax:])
        dst[idx] = src
        out[n] = dst
    return out


def _nest(flat):
    out = {}
    for n, a in flat.items():
        *parents, leaf = n.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return out


# -- layout ---------------------------------------------------------------


def test_layout_follows_the_reference(pair):
    jmodel, _, npp, tmodel = pair
    assert tmodel.hybrid and tmodel.n_groups == jmodel.n_groups == 1
    assert tmodel.group_kinds == jmodel.group_kinds == ("rglru", "rglru",
                                                        "wattn")
    assert tmodel.tail_kinds == jmodel.tail_kinds == ("rglru", "rglru")
    assert [tmodel.tree_path(i) for i in range(5)] == [
        ("groups/b0", 0), ("groups/b1", 0), ("groups/b2", 0),
        ("tail/t0", None), ("tail/t1", None)]
    assert set(npp) == {"embed", "groups", "tail"}
    spec = tmodel.cache_spec(3, 64)
    jspec = dict(bridge._flatten(jmodel.cache_spec(3, 64)))
    assert set(spec) == set(jspec)
    for n, s in spec.items():
        assert s.shape == jspec[n].shape, n
    assert spec["groups/b2/k"].shape == (1, 3, WINDOW, 1, 16)
    assert spec["tail/t0/h"].shape == (3, 64)
    assert spec["tail/t1/conv"].shape == (3, 3, 64)
    # the full config: 12 groups of (rglru, rglru, wattn) and a tail of two
    full = Model(tconfigs.get_config(ARCH), device="meta")
    assert full.n_groups == 12 and full.tail_kinds == ("rglru", "rglru")
    assert sum(k == "rglru" for k in full.kinds) == 26
    assert full.cache_spec(8, 2560)["groups/b2/k"].shape == (12, 8, 2048, 1,
                                                             256)


# -- blocks ---------------------------------------------------------------


@pytest.mark.parametrize("seq", [12, 5])
def test_rglru_block_matches_jax(pair, seq):
    jmodel, _, npp, _ = pair
    jcfg, tcfg = _cfgs("float32")
    p = jax.tree_util.tree_map(lambda a: a[0], npp["groups"]["b1"]["mixer"])
    tp = {n: bridge.to_torch(a) for n, a in p.items()}
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (B, seq, 64)).astype(np.float32)
    np.testing.assert_allclose(
        trglru.rglru_train(tp, tcfg, torch.from_numpy(x)).numpy(),
        np.asarray(jrglru.rglru_train(p, jcfg, jnp.asarray(x))), atol=1e-5)
    jx, jc = jrglru.rglru_prefill(p, jcfg, jnp.asarray(x))
    tx, tc = trglru.rglru_prefill(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    assert set(tc) == set(jc) == {"h", "conv"}
    for n in tc:
        assert tuple(tc[n].shape) == jc[n].shape
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=1e-5)
    # one decode step from a random cache, advanced in place
    cache = {n: rng.normal(0, 1, s.shape).astype(np.float32)
             for n, s in trglru.rglru_cache_spec(tcfg, B, 32).items()}
    xt = rng.normal(0, 1, (B, 64)).astype(np.float32)
    lengths = np.array([3, 7], np.int32)
    jy, jnew = jrglru.rglru_decode(
        p, jcfg, jnp.asarray(xt), {n: jnp.asarray(a) for n, a in
                                   cache.items()}, jnp.asarray(lengths))
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    ty = trglru.rglru_decode(tp, tcfg, torch.from_numpy(xt), tcache,
                             torch.from_numpy(lengths))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    for n in tcache:
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jnew[n]),
                                   atol=1e-5)


def test_ring_attention_decode_matches_jax(pair):
    """The local-attention decode block over a ring of WINDOW slots: rows
    before, at and past a full ring (slot = length % ring)."""
    _, _, npp, _ = pair
    jcfg, tcfg = _cfgs("float32")
    p = jax.tree_util.tree_map(lambda a: a[0], npp["groups"]["b2"]["mixer"])
    tp = {n: bridge.to_torch(a) for n, a in p.items()}
    rng = np.random.default_rng(2)
    kv = {n: rng.normal(0, 1, (4, WINDOW, 1, 16)).astype(np.float32)
          for n in ("k", "v")}
    x = rng.normal(0, 1, (4, 64)).astype(np.float32)
    lengths = np.array([0, 5, 8, 21], np.int32)
    ring = jnp.int32(WINDOW)
    jl = jnp.asarray(lengths)
    jx, jc = jmodel_mod._ring_attention_decode(
        p, jcfg, jnp.asarray(x), {n: jnp.asarray(a) for n, a in kv.items()},
        jl, jl % ring, jnp.minimum(jl + 1, ring))
    tkv = {n: torch.from_numpy(a.copy()) for n, a in kv.items()}
    tx = tmodel_mod._ring_attention_decode(
        tp, tcfg, torch.from_numpy(x), tkv, torch.from_numpy(lengths), None)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(tkv[n].numpy(), np.asarray(jc[n]),
                                   atol=1e-5)


# -- the model ------------------------------------------------------------


@pytest.mark.parametrize("seq", [5, 8, 12, 16])
def test_prefill_and_forward_train_match_jax(pair, jitted, seq):
    _, params, _, tmodel = pair
    jprefill, jforward, _ = jitted
    toks = _tokens(seq, s=seq)
    jlogits, jcache = jprefill(params, {"tokens": jnp.asarray(toks)})
    logits, cache = tmodel.prefill({"tokens": torch.from_numpy(toks)})
    assert logits.shape == (B, 256) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL)
    _assert_cache_close(cache, jcache)
    assert cache["groups/b2/k"].shape[2] == min(seq, WINDOW)
    full = tmodel.forward_train({"tokens": torch.from_numpy(toks)})
    assert full.shape == (B, seq, 256)
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jforward(params,
                                          {"tokens": jnp.asarray(toks)})),
        atol=ATOL)


@pytest.mark.parametrize("seq,same", [(8, True), (12, False)])
def test_prefill_ignores_the_window_as_the_reference_does(pair, jitted, seq,
                                                         same):
    """Up to the window, prefill's last logits are forward_train's; past
    it they differ in both packages, by the same amount."""
    _, params, _, tmodel = pair
    jprefill, jforward, _ = jitted
    toks = _tokens(20 + seq, s=seq)
    last = tmodel.prefill({"tokens": torch.from_numpy(toks)})[0].numpy()
    full = tmodel.forward_train({"tokens": torch.from_numpy(toks)})[:, -1]
    jlast = np.asarray(jprefill(params, {"tokens": jnp.asarray(toks)})[0])
    jfull = np.asarray(jforward(params, {"tokens": jnp.asarray(toks)}))[:, -1]
    gap, jgap = np.abs(last - full.numpy()).max(), np.abs(jlast - jfull).max()
    if same:
        assert gap < ATOL and jgap < ATOL
    else:
        assert gap > 1e-2 and jgap > 1e-2
        assert abs(gap - jgap) < ATOL


@pytest.mark.parametrize("seq", [4, 7])
def test_prefill_then_decode_matches_a_longer_prefill(pair, jitted, seq):
    """prefill(S) placed into a spec-shaped cache, then one decode step,
    gives prefill(S+1)'s logits while S + 1 <= window, in both packages."""
    jmodel, params, _, tmodel = pair
    jprefill, _, jstep = jitted
    toks = _tokens(30 + seq, s=seq + 1)
    want = tmodel.prefill({"tokens": torch.from_numpy(toks)})[0]
    _, head = tmodel.prefill({"tokens": torch.from_numpy(toks[:, :-1])})
    cache = tmodel.init_cache(B, 32)
    for b in range(B):
        tmodel_mod.place_row(cache, head, b, b)
    lengths = torch.full((B,), seq, dtype=torch.int32)
    got, _ = tmodel.decode_step(torch.from_numpy(toks[:, -1]).long(),
                                lengths, cache)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    # the reference, merged the same way
    _, jhead = jprefill(params, {"tokens": jnp.asarray(toks[:, :-1])})
    jc = _flat(jmodel.init_cache(B, 32))
    for b in range(B):
        jc = _np_place(jc, _flat(jhead), b, b)
    jgot, _ = jstep(params, _nest(jc), jnp.asarray(toks[:, -1]),
                    jnp.full((B,), seq, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=ATOL)


def test_greedy_rollout_is_token_identical_to_jax(pair, jitted):
    """Prefill B=2 x 4, place each row in a slot of a 4-slot cache, then
    16 greedy steps: the ring of 8 wraps twice."""
    jmodel, params, _, tmodel = pair
    jprefill, _, jstep = jitted
    toks = _tokens(40, s=4)
    slots = [3, 1]
    jlogits, jhead = jprefill(params, {"tokens": jnp.asarray(toks)})
    jc = _flat(jmodel.init_cache(4, 32))
    for b, slot in enumerate(slots):
        jc = _np_place(jc, _flat(jhead), b, slot)
    jcache = _nest(jc)
    logits, head = tmodel.prefill({"tokens": torch.from_numpy(toks)})
    cache = tmodel.init_cache(4, 32)
    for b, slot in enumerate(slots):
        tmodel_mod.place_row(cache, head, b, slot)
    _assert_cache_close(cache, jcache)
    jtok = np.zeros(4, np.int32)
    jtok[slots] = np.asarray(jnp.argmax(jlogits, -1))
    tok = torch.zeros(4, dtype=torch.long)
    tok[slots] = logits.argmax(-1)
    lengths = np.zeros(4, np.int32)
    lengths[slots] = 4
    seen = []
    for i in range(16):
        assert tok.tolist() == jtok.tolist()
        seen.append(tok[slots].tolist())
        jlogits, jcache = jstep(params, jcache, jnp.asarray(jtok),
                                jnp.asarray(lengths + i))
        logits, cache = tmodel.decode_step(tok, torch.from_numpy(lengths + i),
                                           cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL)
        jtok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
        tok = logits.argmax(-1)
    assert tok.tolist() == jtok.tolist()
    _assert_cache_close(cache, jcache)
    assert len({tuple(s) for s in seen}) > 1     # not one token repeated


def test_decode_matches_forward_train(pair):
    """Teacher forcing over 12 tokens from an empty cache: decode_step's
    logits at t are forward_train's, past the window too (the ring holds
    the last 8 keys, as the window does)."""
    tmodel = pair[3]
    toks = torch.from_numpy(_tokens(5, b=1, s=12)).long()
    full = tmodel.forward_train({"tokens": toks})
    cache = tmodel.init_cache(1, 32)
    for t in range(12):
        logits, cache = tmodel.decode_step(
            toks[:, t], torch.full((1,), t, dtype=torch.int32), cache)
        torch.testing.assert_close(logits, full[:, t], atol=2e-4, rtol=2e-4)


def test_commit_keeps_uncommitted_slots_bit_for_bit(pair, jitted):
    """decode_step(commit=) against the reference's decode step merged by
    the mask on each leaf's slot axis, over 6 steps across the ring:
    committed slots advance as JAX's do, the others keep every bit."""
    _, params, _, tmodel = pair
    jstep = jitted[2]
    rng = np.random.default_rng(6)
    cache = {n: rng.normal(0, 1, s.shape).astype(np.float32)
             for n, s in tmodel.cache_spec(4, 16).items()}
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    jflat = dict(cache)
    for i in range(6):
        toks = rng.integers(0, 256, 4).astype(np.int32)
        lengths = np.array([i, 3 + i, 7 + i, 2 * i], np.int32)
        mask = np.array([True, i % 2 == 0, False, i % 3 == 0])
        before = {n: t.clone() for n, t in tcache.items()}
        jlogits, jnew = jstep(params, _nest(jflat), jnp.asarray(toks),
                              jnp.asarray(lengths))
        jnew = _flat(jnew)
        for n, old in jflat.items():
            ax = 0 if n.startswith("tail/") else 1
            m = mask.reshape((1,) * ax + (-1,) + (1,) * (old.ndim - ax - 1))
            jflat[n] = np.where(m, jnew[n], old)
        logits, out = tmodel.decode_step(
            torch.from_numpy(toks), torch.from_numpy(lengths), tcache,
            commit=torch.from_numpy(mask))
        assert out is tcache
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL)
        keep = torch.from_numpy(~mask)
        for n, t in tcache.items():
            ax = tmodel_mod.slot_axis(n)
            assert torch.equal(t.index_select(ax, keep.nonzero()[:, 0]),
                               before[n].index_select(ax,
                                                      keep.nonzero()[:, 0]))
            np.testing.assert_allclose(t.numpy(), jflat[n], atol=ATOL,
                                       err_msg=n)


def test_decode_from_a_short_prompt_cache_fails_in_both(pair):
    """A reference fact the port follows: after a prompt shorter than
    cw-1 tokens an RG-LRU layer's conv cache holds fewer rows than the
    cache spec, and a decode step straight from it fails in both
    packages."""
    jmodel, params, _, tmodel = pair
    toks = _tokens(3, b=1, s=2)
    _, jcache = jmodel.prefill(params, {"tokens": jnp.asarray(toks)})
    _, cache = tmodel.prefill({"tokens": torch.from_numpy(toks)})
    assert cache["groups/b0/conv"].shape == (1, 1, 2, 64)
    assert cache["tail/t1/conv"].shape == (1, 2, 64)
    with pytest.raises(ValueError):
        jmodel.decode_step(params, jcache, jnp.array([1], jnp.int32),
                           jnp.array([2], jnp.int32))
    with pytest.raises(RuntimeError):
        tmodel.decode_step(torch.tensor([1]), torch.tensor([2],
                                                           dtype=torch.int32),
                           cache)


def test_prefill_matches_jax_in_bf16():
    """bf16 recurrentgemma.  The sigmoid gates and the GeLU round at
    other places in the two frameworks (XLA on the CPU rounds each step
    to bf16; the port's fused ops round once, and its gates and GeLU lie
    as close to the fp32 block as JAX's or closer).  One RG-LRU block is
    held within 2e-2 of each tensor's largest magnitude.  Through the
    five layers the rounding compounds: JAX's own bf16 prefill lies up to
    3.9% of the largest magnitude from the fp32 model on the same bf16
    weights (seeds 7-14), and the port's as far, so the model is held
    within 5e-2 of each tensor's largest magnitude; each layer alone is
    held at 2e-2 below (ROADMAP queue 3)."""
    jmodel, params, npp, tmodel = _pair("bfloat16")
    jcfg, tcfg = _cfgs("bfloat16")
    p = jax.tree_util.tree_map(lambda a: a[0], npp["groups"]["b1"]["mixer"])
    tp = {n: bridge.to_torch(a) for n, a in p.items()}
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (B, 12, 64)).astype(np.float32)).bfloat16()
    jx, jc = jrglru.rglru_prefill(p, jcfg, jnp.asarray(bridge.to_numpy(x)))
    tx, tc = trglru.rglru_prefill(tp, tcfg, x)
    for got, want in [(tx, jx), (tc["h"], jc["h"]), (tc["conv"], jc["conv"])]:
        assert got.dtype == torch.bfloat16
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())

    toks = _tokens(7)
    jlogits, jcache = jax.jit(jmodel.prefill)(params,
                                              {"tokens": jnp.asarray(toks)})
    logits, cache = tmodel.prefill({"tokens": torch.from_numpy(toks)})
    assert all(t.dtype == torch.bfloat16 for t in cache.values())
    want = _flat(jcache)
    pairs = [(logits.numpy(), np.asarray(jlogits))]
    pairs += [(cache[n].float().numpy(), want[n]) for n in cache]
    for got, ref_ in pairs:
        np.testing.assert_allclose(got, ref_, rtol=0,
                                   atol=5e-2 * np.abs(ref_).max())


def test_each_layer_matches_jax_in_bf16():
    """Where the bf16 gap of the whole model comes from: each layer, fed
    the same input (JAX's stream at that layer), gives an output and a
    cache within 2e-2 of their largest magnitude, while the gap of the
    two streams grows layer by layer up to the 5e-2 the whole model is
    held to (ROADMAP queue 3)."""
    jmodel, params, _, tmodel = _pair("bfloat16")
    jcfg, tcfg = _cfgs("bfloat16")
    toks = _tokens(7)
    x = jmodel._embed_inputs(params, {"tokens": jnp.asarray(toks)})
    for i, blk in enumerate(tmodel.layers):
        path, idx = tmodel.tree_path(i)
        bp = params
        for part in path.split("/"):
            bp = bp[part]
        if idx is not None:
            bp = jax.tree_util.tree_map(lambda a: a[idx], bp)
        tx = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
        x, jc = jmodel_mod._block_prefill(bp, jcfg, x, tmodel.kinds[i])
        got, tc = tmodel_mod._block_prefill(blk, tcfg, tx)
        assert set(tc) == set(jc)
        pairs = [(got, x)] + [(tc[n], jc[n]) for n in tc]
        for g, w in pairs:
            w = np.asarray(w, np.float32)
            np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                       atol=2e-2 * np.abs(w).max(),
                                       err_msg=f"layer {i} {path}")


def test_prefill_launches_no_kernel_on_the_cpu(pair):
    tmodel = pair[3]
    before = (ops.rglru.launches, ops.mha.launches,
              ops.decode_attention.launches)
    _, cache = tmodel.prefill({"tokens": torch.from_numpy(_tokens(8))})
    tmodel.forward_train({"tokens": torch.from_numpy(_tokens(8))})
    row = tmodel.init_cache(B, 32)
    tmodel.decode_step(torch.zeros(B, dtype=torch.long),
                       torch.zeros(B, dtype=torch.int32), row)
    assert (ops.rglru.launches, ops.mha.launches,
            ops.decode_attention.launches) == before


def test_bridge_carries_the_cache_tree_both_ways(pair):
    jmodel, _, _, tmodel = pair
    rng = np.random.default_rng(12)
    tree = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 1, s.shape).astype(np.float32),
        jmodel.cache_spec(2, 16))
    flat = bridge.cache_to_torch(tree)
    assert set(flat) == set(tmodel.cache_spec(2, 16))
    back = bridge.cache_to_numpy(flat)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_engine_refuses_the_hybrid(pair):
    """The reference engine cannot serve recurrentgemma: its first turn
    raises in ``_commit`` (ROADMAP queue 3).  The port's engine refuses
    the model when it is built, so it never half-serves it."""
    jmodel, params, _, tmodel = pair
    with pytest.raises(NotImplementedError, match="hybrid"):
        TServingEngine(tmodel, n_rows=3, max_slots=8, max_seq=128)
    jeng = ServingEngine(jmodel, params, n_rows=3, max_slots=8, max_seq=128)
    jeng.open_session("s0")
    with pytest.raises(ValueError):
        jeng.turn("s0", [1, 2, 3], gen_tokens=4, now=0.0)
