"""The port's full-sequence attention, ``Model.prefill`` and
``Model.forward_train`` against the JAX package on the four dense smoke
configs, with JAX's weights carried across by ``bridge.params_into``.

fp32 throughout (atol 1e-4), as tests/test_torch_model.py holds the
decode step, but for one bf16 granite case (2e-2; see its docstring for
how the whole model is held).  Prefill then decode is
the counterpart of tests/test_models.py's prefill-then-decode test and
must give JAX's greedy tokens; teacher forcing is its decode-matches-
forward test, held inside the port (atol 2e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.models import build_model
from repro.models import layers as jl
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.models import layers as tl
from repro_torch.serving import kv_cache

torch.set_num_threads(1)

DENSE = ["granite-3-2b", "qwen2.5-32b", "nemotron-4-15b", "deepseek-7b"]
B, S = 2, 16
ATOL = 1e-4


def _pair(arch, dtype="float32"):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = dataclasses.replace(configs.get_smoke(arch), param_dtype=jdt,
                               compute_dtype=jdt)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), param_dtype=tdt,
                               compute_dtype=tdt)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    npp = jax.tree_util.tree_map(np.asarray, params)
    if tcfg.qkv_bias:        # zero-initialized: make the biases count
        rng = np.random.default_rng(9)
        mixer = npp["layers"]["mixer"]
        for name in ("bq", "bk", "bv"):
            mixer[name] = rng.normal(0, 0.5, mixer[name].shape).astype(
                mixer[name].dtype)
        params = jax.tree_util.tree_map(jnp.asarray, npp)
    tmodel = bridge.params_into(Model(tcfg, device="cpu"), npp)
    return jmodel, params, npp, tmodel


def _tokens(seed, vocab, b=B, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _np(t):
    return bridge.to_numpy(t).astype(np.float32)


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2.5-32b"])
def test_attention_prefill_and_train_match_jax(arch):
    jmodel, params, npp, tmodel = _pair(arch)
    jcfg, tcfg = jmodel.cfg, tmodel.cfg
    p = jax.tree_util.tree_map(lambda a: a[0], npp["layers"]["mixer"])
    x = np.random.default_rng(1).normal(0, 1, (B, S, 64)).astype(np.float32)
    tp = {n: bridge.to_torch(a) for n, a in p.items()}
    jx, jc = jl.attention_prefill(p, jcfg, jnp.asarray(x))
    tx, tc = tl.attention_prefill(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL)
    for n in ("k", "v"):
        assert tc[n].shape == (B, S, tcfg.n_kv_heads, 16)
        assert tc[n].dtype == tcfg.compute_dtype
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=ATOL)
    for kw in (dict(), dict(window=4), dict(causal=False)):
        np.testing.assert_allclose(
            tl.attention_train(tp, tcfg, torch.from_numpy(x), **kw).numpy(),
            np.asarray(jl.attention_train(p, jcfg, jnp.asarray(x), **kw)),
            atol=ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_forward_train_match_jax(arch):
    jmodel, params, _, tmodel = _pair(arch)
    toks = _tokens(2, tmodel.cfg.vocab_size)
    jlogits, jcache = jax.jit(jmodel.prefill)(params,
                                              {"tokens": jnp.asarray(toks)})
    logits, cache = tmodel.prefill({"tokens": torch.from_numpy(toks)})
    assert logits.shape == (B, tmodel.cfg.vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL)
    assert set(cache) == set(jcache) == {"k", "v"}
    for n in ("k", "v"):
        assert cache[n].shape == jcache[n].shape
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jcache[n]),
                                   atol=ATOL)
    full = tmodel.forward_train({"tokens": torch.from_numpy(toks)})
    assert full.shape == (B, S, tmodel.cfg.vocab_size)
    np.testing.assert_allclose(
        full.numpy(),
        np.asarray(jax.jit(jmodel.forward_train)(
            params, {"tokens": jnp.asarray(toks)})), atol=ATOL)


def test_prefill_matches_jax_in_bf16():
    """bf16 granite.  The attention blocks hold JAX's results within
    2e-2.  Over the whole model the MLP's elementwise steps round at other
    places in the two frameworks (XLA on the CPU rounds each step of the
    sigmoid to bf16; the port's fused ``silu`` rounds once), and one bf16
    ulp of the largest activations (0.0156 at 2-4) reaches entries near 0,
    so the model is held within 2e-2 of each tensor's largest magnitude."""
    jmodel, params, npp, tmodel = _pair("granite-3-2b", "bfloat16")
    jcfg, tcfg = jmodel.cfg, tmodel.cfg
    p = jax.tree_util.tree_map(lambda a: a[1], npp["layers"]["mixer"])
    tp = {n: bridge.to_torch(a) for n, a in p.items()}
    x = np.random.default_rng(3).normal(0, 1, (B, S, 64)).astype(np.float32)
    jx, jc = jl.attention_prefill(p, jcfg, jnp.asarray(x, jnp.bfloat16))
    tx, tc = tl.attention_prefill(tp, tcfg, torch.from_numpy(x).bfloat16())
    for got, want in ((tx, jx), (tc["k"], jc["k"]), (tc["v"], jc["v"])):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=2e-2, rtol=2e-2)

    toks = _tokens(3, tcfg.vocab_size)
    jlogits, jcache = jax.jit(jmodel.prefill)(params,
                                              {"tokens": jnp.asarray(toks)})
    logits, cache = tmodel.prefill({"tokens": torch.from_numpy(toks)})
    pairs = [(logits.numpy(), np.asarray(jlogits))]
    pairs += [(_np(cache[n]), np.asarray(jcache[n], np.float32))
              for n in ("k", "v")]
    assert cache["k"].dtype == torch.bfloat16
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_gives_jax_tokens(arch):
    """Prefill B=2 x 16, merge into a 32-long cache, 3 greedy steps."""
    jmodel, params, _, tmodel = _pair(arch)
    toks = _tokens(4, tmodel.cfg.vocab_size)
    jlogits, jc = jax.jit(jmodel.prefill)(params,
                                          {"tokens": jnp.asarray(toks)})
    jcache = jax.tree_util.tree_map(
        lambda z, c: z.at[tuple(slice(0, d) for d in c.shape)].set(c),
        jmodel.init_cache(B, 32), jc)
    logits, pc = tmodel.prefill({"tokens": torch.from_numpy(toks)})
    cache = tmodel.init_cache(B, 32)
    for b in range(B):          # one prompt per serving slot
        kv_cache.write_slot(cache, {n: t[:, b:b + 1] for n, t in pc.items()},
                            b)
    step = jax.jit(jmodel.decode_step)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    tok = logits.argmax(-1)
    lengths = np.full((B,), S, np.int32)
    for i in range(3):
        assert tok.tolist() == np.asarray(jtok).tolist()
        jlogits, jcache = step(params, jcache, jtok,
                               jnp.asarray(lengths + i))
        logits, cache = tmodel.decode_step(tok, torch.from_numpy(lengths + i),
                                           cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        tok = logits.argmax(-1)
    assert tok.tolist() == np.asarray(jtok).tolist()


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2.5-32b"])
def test_decode_matches_forward_train(arch):
    """Teacher forcing: decode_step's logits at t == forward_train's."""
    _, _, _, tmodel = _pair(arch)
    toks = torch.from_numpy(_tokens(5, tmodel.cfg.vocab_size, 1, 12)).long()
    full = tmodel.forward_train({"tokens": toks})
    cache = tmodel.init_cache(1, 12)
    for t in range(11):
        logits, cache = tmodel.decode_step(
            toks[:, t], torch.full((1,), t, dtype=torch.int32), cache)
        torch.testing.assert_close(logits, full[:, t], atol=2e-4, rtol=2e-4)


def test_prefill_launches_no_kernel_on_the_cpu():
    _, _, _, tmodel = _pair("deepseek-7b")
    before = ops.mha.launches
    tmodel.prefill({"tokens": torch.from_numpy(_tokens(6, 256))})
    assert ops.mha.launches == before


def test_frontends_are_refused():
    tmodel = Model(tconfigs.get_smoke("granite-3-2b"), device="cpu")
    tmodel.cfg = dataclasses.replace(tmodel.cfg, frontend="audio")
    with pytest.raises(NotImplementedError, match="audio"):
        tmodel.forward_train({"tokens": torch.zeros((1, 4), dtype=torch.long)})
