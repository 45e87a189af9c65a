"""Each ported function of ``repro.models.layers`` against its JAX original,
on granite smoke weights from ``Model.init(PRNGKey(0))`` bridged into
torch, in fp32 (atol/rtol 1e-5)."""
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
from repro_torch.models import layers as tl

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(**over):
    j = dataclasses.replace(configs.get_smoke("granite-3-2b"),
                            param_dtype=jnp.float32,
                            compute_dtype=jnp.float32, **over)
    t = dataclasses.replace(tconfigs.get_smoke("granite-3-2b"),
                            param_dtype=torch.float32,
                            compute_dtype=torch.float32, **over)
    return j, t


def _params(jcfg):
    """Layer 0's params (and the embedding) as numpy and as torch."""
    params = build_model(jcfg).init(jax.random.PRNGKey(0))
    npp = jax.tree_util.tree_map(np.asarray, params)
    layer0 = jax.tree_util.tree_map(lambda a: a[0], npp["layers"])
    return npp["embed"], layer0


def _t(tree):
    return {k: bridge.to_torch(v) for k, v in tree.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def granite():
    jcfg, tcfg = _cfgs()
    emb, layer0 = _params(jcfg)
    return jcfg, tcfg, emb, layer0


def test_rmsnorm_and_rope(granite):
    jcfg, tcfg, emb, layer0 = granite
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 5, 64)).astype(np.float32)
    scale = layer0["mlp"]["ln"] + rng.normal(0, 0.1, 64).astype(np.float32)
    _close(tl.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x), 1e-6),
           jl.rmsnorm(jnp.asarray(scale), jnp.asarray(x), 1e-6))
    xh = rng.normal(0, 1, (2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    _close(tl.rope(torch.from_numpy(xh), torch.from_numpy(pos), 10000.0),
           jl.rope(jnp.asarray(xh), jnp.asarray(pos), 10000.0))


@pytest.mark.parametrize("over", [{}, {"logit_softcap": 3.0},
                                  {"tie_embeddings": False}],
                         ids=["tied", "softcap", "untied"])
def test_embed_and_unembed(over):
    jcfg, tcfg = _cfgs(**over)
    emb, _ = _params(jcfg)
    tokens = np.array([0, 7, 255, 31], np.int64)
    _close(tl.embed(_t(emb), tcfg, torch.from_numpy(tokens)),
           jl.embed(emb, jcfg, jnp.asarray(tokens)))
    x = np.random.default_rng(1).normal(0, 1, (4, 64)).astype(np.float32)
    got = tl.unembed(_t(emb), tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, jl.unembed(emb, jcfg, jnp.asarray(x)))


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_qkv(qkv_bias):
    jcfg, tcfg = _cfgs(qkv_bias=qkv_bias)
    _, layer0 = _params(jcfg)
    p = dict(layer0["mixer"])
    rng = np.random.default_rng(2)
    for name in ("bq", "bk", "bv"):      # zero-initialized: make them count
        if name in p:
            p[name] = rng.normal(0, 1, p[name].shape).astype(np.float32)
    x = rng.normal(0, 1, (2, 3, 64)).astype(np.float32)
    got = tl._qkv(_t(p), tcfg, torch.from_numpy(x))
    want = jl._qkv(p, jcfg, jnp.asarray(x))
    for g, w in zip(got, want):
        _close(g, w)


def test_attention_decode_and_cache_spec(granite):
    jcfg, tcfg, _, layer0 = granite
    B, Smax = 4, 16
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (B, 64)).astype(np.float32)
    cache = {n: rng.normal(0, 1, (B, Smax, 2, 16)).astype(np.float32)
             for n in ("k", "v")}
    lengths = np.array([0, 5, Smax - 1, Smax + 3], np.int32)
    jx, jc = jl.attention_decode(layer0["mixer"], jcfg, jnp.asarray(x),
                                 {n: jnp.asarray(a) for n, a in cache.items()},
                                 jnp.asarray(lengths))
    tc = bridge.cache_to_torch(cache)
    tx = tl.attention_decode(_t(layer0["mixer"]), tcfg, torch.from_numpy(x),
                             tc, torch.from_numpy(lengths))
    _close(tx, jx)
    for n in ("k", "v"):                 # in place, out-of-range dropped
        _close(tc[n], jc[n])
    spec = tl.attention_cache_spec(tcfg, B, Smax)
    jspec = jl.attention_cache_spec(jcfg, B, Smax)
    for n in ("k", "v"):
        assert spec[n].shape == jspec[n].shape
        assert spec[n].dtype == torch.float32


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_core_and_block(variant):
    jcfg, tcfg = _cfgs(mlp_variant=variant)
    _, layer0 = _params(jcfg)
    x = np.random.default_rng(4).normal(0, 1, (2, 3, 64)).astype(np.float32)
    p = layer0["mlp"]
    _close(tl.mlp_core(_t(p), tcfg, torch.from_numpy(x)),
           jl.mlp_core(p, jcfg, jnp.asarray(x)))
    _close(tl.mlp_block(_t(p), tcfg, torch.from_numpy(x)),
           jl.mlp_block(p, jcfg, jnp.asarray(x)))
