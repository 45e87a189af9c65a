"""The ``Model`` of the port: init, the full-sequence forward, the
batched prompt prefill, the decode step and its cache.

The counterpart of ``repro.models.model.Model`` for the dense family
(GQA attention + MLP blocks), the SSM family (mamba2's SSD blocks, no
MLP) and the hybrid family (recurrentgemma: RG-LRU blocks and
local-window attention blocks, each with an MLP, in a repeating
pattern).  Layers run as a Python loop over ``nn.Module`` blocks; the
cache keeps the JAX layout.  Dense and SSM: every leaf (layers, slots,
...), dense ``{"k", "v"}: (layers, slots, Smax, K, Dh)``, SSM
``{"state": (layers, slots, H, P, N) fp32, "conv_x", "conv_B",
"conv_C": (layers, slots, cw-1, ...)}``.  Hybrid: the reference's tree
``{"groups": {"b<i>": ...}, "tail": {"t<i>": ...}}`` as flat keys named
by its path, ``"groups/b<i>/<leaf>"`` with a leading group axis (groups,
slots, ...) and ``"tail/t<i>/<leaf>"`` without one (slots, ...); an
RG-LRU layer's leaves are ``h`` and ``conv``, a local-attention layer's
``k`` and ``v`` over a ring of min(max_seq, window) positions.
``place_row`` puts one prefilled row into a slot of any of these.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops
from . import layers, rglru, ssd
from .common import ModelConfig, TensorSpec, resolve_device


def _param_dict(spec: layers.ParamSpec, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                           requires_grad=False)
        for name, (shape, _, _) in spec.items()})


# ---------------------------------------------------------------------------
# Per-kind blocks
# ---------------------------------------------------------------------------

def _block_param_specs(cfg: ModelConfig,
                       kind: str) -> Dict[str, layers.ParamSpec]:
    """The subtrees of one layer's parameters (the reference's
    ``_init_block``): an SSD layer has a mixer and no MLP."""
    if kind in ("attn", "wattn"):
        return {"mixer": layers.attention_param_spec(cfg),
                "mlp": layers.mlp_param_spec(cfg)}
    if kind == "rglru":
        return {"mixer": rglru.rglru_param_spec(cfg),
                "mlp": layers.mlp_param_spec(cfg)}
    if kind == "ssd":
        return {"mixer": ssd.ssd_param_spec(cfg)}
    raise ValueError(kind)


class Block(nn.Module):
    """One layer: its parameter subtrees as ``ParameterDict`` children."""

    def __init__(self, cfg: ModelConfig, kind: str, device: torch.device):
        super().__init__()
        self.kind = kind
        self.specs = _block_param_specs(cfg, kind)
        for name, spec in self.specs.items():
            self.add_module(name, _param_dict(spec, cfg.param_dtype, device))


def _block_train(blk: Block, cfg: ModelConfig, x: torch.Tensor):
    if blk.kind == "ssd":
        return ssd.ssd_train(blk.mixer, cfg, x)
    if blk.kind == "rglru":
        x = rglru.rglru_train(blk.mixer, cfg, x)
    else:
        window = cfg.attn_window if blk.kind == "wattn" else 0
        x = layers.attention_train(blk.mixer, cfg, x, window=window)
    return layers.mlp_block(blk.mlp, cfg, x)


def _block_prefill(blk: Block, cfg: ModelConfig, x: torch.Tensor):
    if blk.kind == "ssd":
        return ssd.ssd_prefill(blk.mixer, cfg, x)
    if blk.kind == "rglru":
        x, cache = rglru.rglru_prefill(blk.mixer, cfg, x)
    else:
        # a local-attention layer's prefill attends over the whole prompt
        # (window 0) and keeps its last `window` keys, as the reference
        # does (ROADMAP queue 3)
        x, cache = layers.attention_prefill(blk.mixer, cfg, x)
        if blk.kind == "wattn":
            w = cfg.attn_window
            cache = {n: t[:, -w:] for n, t in cache.items()}
    return layers.mlp_block(blk.mlp, cfg, x), cache


def _ring_attention_decode(p, cfg: ModelConfig, x: torch.Tensor,
                           cache: Dict[str, torch.Tensor],
                           lengths: torch.Tensor,
                           commit: Optional[torch.Tensor]) -> torch.Tensor:
    """Window attention against a ring-buffer cache (slot = pos % ring).

    Writes this token's K/V IN PLACE at its ring slot, attends over
    min(lengths + 1, ring) entries, then gives rows outside the bool mask
    ``commit`` (None: every row) their old entries back."""
    B, _ = x.shape
    h = layers.rmsnorm(p["ln"], x[:, None, :], cfg.norm_eps)
    q, k, v = layers._qkv(p, cfg, h)
    q = layers.rope(q, lengths[:, None], cfg.rope_theta)[:, 0]
    k = layers.rope(k, lengths[:, None], cfg.rope_theta)[:, 0]
    v = v[:, 0]
    kc, vc = cache["k"], cache["v"]
    ring_len = kc.shape[1]
    slot = lengths.long() % ring_len
    valid = torch.clamp(lengths + 1, max=ring_len).to(torch.int32)
    bidx = torch.arange(B, device=x.device)
    old_k, old_v = kc[bidx, slot], vc[bidx, slot]   # gathers: copies
    new_k, new_v = k.to(kc.dtype), v.to(vc.dtype)
    kc[bidx, slot] = new_k
    vc[bidx, slot] = new_v
    o = ops.decode_attention(q, kc, vc, valid)
    if commit is not None:
        keep = commit[:, None, None]
        kc[bidx, slot] = torch.where(keep, new_k, old_k)
        vc[bidx, slot] = torch.where(keep, new_v, old_v)
    out = torch.einsum("bhk,hkd->bd", o, p["wo"].to(cfg.compute_dtype))
    return x + out


def _block_decode(blk: Block, cfg: ModelConfig, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor], lengths: torch.Tensor,
                  commit: Optional[torch.Tensor]) -> torch.Tensor:
    if blk.kind == "ssd":
        return ssd.ssd_decode(blk.mixer, cfg, x, cache, lengths,
                              commit=commit)
    if blk.kind == "rglru":
        x = rglru.rglru_decode(blk.mixer, cfg, x, cache, lengths,
                               commit=commit)
    elif blk.kind == "wattn":
        x = _ring_attention_decode(blk.mixer, cfg, x, cache, lengths,
                                   commit)
    else:
        x = layers.attention_decode(blk.mixer, cfg, x, cache, lengths,
                                    commit=commit)
    return layers.mlp_block(blk.mlp, cfg, x[:, None, :])[:, 0]


def _block_cache_spec(cfg: ModelConfig, kind: str, batch: int,
                      max_seq: int) -> Dict[str, TensorSpec]:
    if kind == "ssd":
        return ssd.ssd_cache_spec(cfg, batch, max_seq)
    if kind == "rglru":
        return rglru.rglru_cache_spec(cfg, batch, max_seq)
    window = cfg.attn_window if kind == "wattn" else 0
    return layers.attention_cache_spec(cfg, batch, max_seq, window=window)


def slot_axis(name: str) -> int:
    """The slot axis of a cache leaf: 0 under the hybrid's ``tail``, whose
    leaves have no stacked axis; 1 everywhere else, after the layer or
    group axis."""
    return 0 if name.startswith("tail/") else 1


@torch.no_grad()
def place_row(cache: Dict[str, torch.Tensor],
              prefill_cache: Dict[str, torch.Tensor], row: int,
              slot: int) -> Dict[str, torch.Tensor]:
    """Write row ``row`` of a prefill cache into slot ``slot`` of a decode
    cache, leaf by leaf, IN PLACE.  A leaf of the prefill row may be
    shorter in its trailing dims (a shorter prompt, a local-attention
    layer's cache under its window): only that leading part of the slot
    is overwritten, as the reference's tests merge a prefill cache."""
    for name, dst in cache.items():
        ax = slot_axis(name)
        src = prefill_cache[name].select(ax, row)
        idx = (slice(None),) * ax + (slot,) + tuple(
            slice(0, n) for n in src.shape[ax:])
        dst[idx] = src.to(dst.dtype)
    return cache


class Model(nn.Module):
    """Dense, SSM or hybrid decoder.  Runs on CUDA unless ``device`` names
    another."""

    def __init__(self, cfg: ModelConfig, device: Optional[Any] = None):
        super().__init__()
        hybrid = (cfg.family == "hybrid"
                  and len(set(cfg.block_pattern)) > 1
                  and set(cfg.block_pattern) <= {"rglru", "attn"})
        flat = (cfg.family in ("dense", "ssm") and not cfg.block_pattern
                and not cfg.attn_window)
        if not (hybrid or flat) or cfg.mla or cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: the port serves the dense and ssm families "
                "and the RG-LRU hybrid only")
        self.cfg = cfg
        self.hybrid = hybrid
        self.kinds = [self._kind(i) for i in range(cfg.n_layers)]
        if hybrid:
            period = len(cfg.block_pattern)
            self.n_groups = cfg.n_layers // period
            self.group_kinds = tuple(self.kinds[:period])
            self.tail_kinds = tuple(self.kinds[self.n_groups * period:])
        self.device = resolve_device(device)
        self.embed = _param_dict(layers.embedding_param_spec(cfg),
                                 cfg.param_dtype, self.device)
        self.layers = nn.ModuleList(Block(cfg, kind, self.device)
                                    for kind in self.kinds)

    def _kind(self, i: int) -> str:
        k = self.cfg.block_kind(i)
        return "wattn" if k == "attn" and self.cfg.attn_window else k

    def tree_path(self, i: int) -> Tuple[str, Optional[int]]:
        """Where layer ``i`` sits in the reference's params and cache
        trees: its subtree's path and its index on that subtree's leading
        axis (None for a tail layer, which has no stacked axis)."""
        if not self.hybrid:
            return "layers", i
        period = len(self.group_kinds)
        if i < self.n_groups * period:
            return f"groups/b{i % period}", i // period
        return f"tail/t{i - self.n_groups * period}", None

    def _prefix(self, i: int) -> str:
        """What layer ``i``'s cache keys start with: its tree path in the
        hybrid, nothing in a flat layer stack."""
        return self.tree_path(i)[0] + "/" if self.hybrid else ""

    def _n_stacked(self) -> int:
        """The length of a stacked cache leaf's leading axis."""
        return self.n_groups if self.hybrid else self.cfg.n_layers

    def _layer_cache(self, cache: Dict[str, torch.Tensor],
                     i: int) -> Dict[str, torch.Tensor]:
        """Views of layer ``i``'s leaves in a decode cache."""
        prefix, (_, idx) = self._prefix(i), self.tree_path(i)
        return {n[len(prefix):]: t if idx is None else t[idx]
                for n, t in cache.items() if n.startswith(prefix)}

    # -- init ---------------------------------------------------------------

    def _specs(self):
        cfg = self.cfg
        yield self.embed, layers.embedding_param_spec(cfg)
        for blk in self.layers:
            for name, spec in blk.specs.items():
                yield getattr(blk, name), spec

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every weight from ``generator``, in a fixed order."""
        for pd, spec in self._specs():
            for name, (shape, init_fn, kw) in spec.items():
                pd[name].copy_(init_fn(generator, shape, self.cfg.param_dtype,
                                       device=self.device, **kw))
        return self

    # -- full sequence ------------------------------------------------------

    def _embed_inputs(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The token embedding of ``batch["tokens"]`` (B, S).  The audio and
        vision frontends are not ported."""
        if self.cfg.frontend != "none":
            raise NotImplementedError(
                f"{self.cfg.name}: the {self.cfg.frontend} frontend")
        return layers.embed(self.embed, self.cfg, batch["tokens"])

    @torch.no_grad()
    def forward_train(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits (B, S, V) in fp32 at every position of ``batch["tokens"]``
        (forward only: there is no backward kernel yet)."""
        cfg = self.cfg
        x = self._embed_inputs(batch)
        for blk in self.layers:
            x = _block_train(blk, cfg, x)
        return layers.unembed(self.embed, cfg, x)

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor]):
        """Run the prompts ``batch["tokens"]`` (B, S) through every layer at
        once.  Returns (logits (B, V) fp32 at the last position, cache):
        every layer's cache stacked on a leading layer axis, the
        reference's layout (dense ``{"k", "v"}: (layers, B, S, K, Dh)``), so
        ``kv_cache.write_slot`` can place any row into a serving slot; the
        hybrid's in its group and tail layout (see the module's doc), which
        ``place_row`` places."""
        cfg = self.cfg
        x = self._embed_inputs(batch)
        cache: Dict[str, torch.Tensor] = {}
        for i, blk in enumerate(self.layers):
            x, lc = _block_prefill(blk, cfg, x)
            # filled layer by layer, so the layers' caches are never stacked
            _, idx = self.tree_path(i)
            for n, t in lc.items():
                key = self._prefix(i) + n
                if idx is None:
                    cache[key] = t.contiguous()
                    continue
                if key not in cache:
                    cache[key] = torch.empty(
                        (self._n_stacked(),) + tuple(t.shape), dtype=t.dtype,
                        device=self.device)
                cache[key][idx] = t
        logits = layers.unembed(self.embed, cfg, x[:, -1:])[:, 0]
        return logits, cache

    # -- decode ---------------------------------------------------------------

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, lengths: torch.Tensor,
                    cache: Dict[str, torch.Tensor], return_hidden: bool = False,
                    commit: Optional[torch.Tensor] = None):
        """tokens (B,) int, lengths (B,) int32.  Returns (logits (B,V) fp32,
        cache), plus the hidden state before the final norm when
        ``return_hidden``.

        The cache is updated IN PLACE and returned as the same dict: each
        row's K/V is written at its length (an SSM row's state and conv
        histories advance), and rows outside the bool mask ``commit``
        (None: every row) keep what they held.  That is what JAX's
        ``_commit(old, decode_step(...), commit)`` gives, without
        rewriting the whole cache each token.
        """
        cfg = self.cfg
        x = layers.embed(self.embed, cfg, tokens)
        for i, blk in enumerate(self.layers):
            lc = self._layer_cache(cache, i)
            x = _block_decode(blk, cfg, x, lc, lengths, commit)
        logits = layers.unembed(self.embed, cfg, x[:, None])[:, 0]
        if return_hidden:
            return logits, cache, x
        return logits, cache

    # -- cache construction ----------------------------------------------------

    def cache_spec(self, batch: int, max_seq: int) -> Dict[str, TensorSpec]:
        out = {}
        for i, kind in enumerate(self.kinds):
            _, idx = self.tree_path(i)
            spec = _block_cache_spec(self.cfg, kind, batch, max_seq)
            for n, s in spec.items():
                out[self._prefix(i) + n] = s if idx is None else TensorSpec(
                    (self._n_stacked(),) + s.shape, s.dtype)
        return out

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, torch.Tensor]:
        return {name: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for name, s in self.cache_spec(batch, max_seq).items()}
