"""The ``Model`` of the port: init, the full-sequence forward, the
batched prompt prefill, the decode step and its cache.

The counterpart of ``repro.models.model.Model`` for the dense family
(GQA attention + MLP blocks) and the SSM family (mamba2's SSD blocks,
no MLP).  Layers run as a Python loop over ``nn.Module`` blocks; the
cache keeps the JAX layout, every leaf (layers, slots, ...): dense
``{"k", "v"}: (layers, slots, Smax, K, Dh)``, SSM ``{"state": (layers,
slots, H, P, N) fp32, "conv_x", "conv_B", "conv_C": (layers, slots,
cw-1, ...)}``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from . import layers, ssd
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
    if kind == "attn":
        return {"mixer": layers.attention_param_spec(cfg),
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
    x = layers.attention_train(blk.mixer, cfg, x, window=0)
    return layers.mlp_block(blk.mlp, cfg, x)


def _block_prefill(blk: Block, cfg: ModelConfig, x: torch.Tensor):
    if blk.kind == "ssd":
        return ssd.ssd_prefill(blk.mixer, cfg, x)
    x, cache = layers.attention_prefill(blk.mixer, cfg, x)
    return layers.mlp_block(blk.mlp, cfg, x), cache


def _block_decode(blk: Block, cfg: ModelConfig, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor], lengths: torch.Tensor,
                  commit: Optional[torch.Tensor]) -> torch.Tensor:
    if blk.kind == "ssd":
        return ssd.ssd_decode(blk.mixer, cfg, x, cache, lengths,
                              commit=commit)
    x = layers.attention_decode(blk.mixer, cfg, x, cache, lengths,
                                commit=commit)
    return layers.mlp_block(blk.mlp, cfg, x[:, None, :])[:, 0]


def _block_cache_spec(cfg: ModelConfig, kind: str, batch: int,
                      max_seq: int) -> Dict[str, TensorSpec]:
    if kind == "ssd":
        return ssd.ssd_cache_spec(cfg, batch, max_seq)
    return layers.attention_cache_spec(cfg, batch, max_seq)


class Model(nn.Module):
    """Dense or SSM decoder.  Runs on CUDA unless ``device`` names another."""

    def __init__(self, cfg: ModelConfig, device: Optional[Any] = None):
        super().__init__()
        if (cfg.family not in ("dense", "ssm") or cfg.mla
                or cfg.block_pattern or cfg.attn_window
                or cfg.frontend != "none"):
            raise NotImplementedError(
                f"{cfg.name}: the port serves the dense and ssm families "
                "only")
        self.cfg = cfg
        self.kind = cfg.block_kind(0)
        self.device = resolve_device(device)
        self.embed = _param_dict(layers.embedding_param_spec(cfg),
                                 cfg.param_dtype, self.device)
        self.layers = nn.ModuleList(Block(cfg, self.kind, self.device)
                                    for _ in range(cfg.n_layers))

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
        ``kv_cache.write_slot`` can place any row into a serving slot."""
        cfg = self.cfg
        x = self._embed_inputs(batch)
        cache: Dict[str, torch.Tensor] = {}
        for i, blk in enumerate(self.layers):
            x, lc = _block_prefill(blk, cfg, x)
            # filled layer by layer, so the layers' caches are never stacked
            for n, t in lc.items():
                if n not in cache:
                    cache[n] = torch.empty((cfg.n_layers,) + tuple(t.shape),
                                           dtype=t.dtype, device=self.device)
                cache[n][i] = t
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
            lc = {n: t[i] for n, t in cache.items()}
            x = _block_decode(blk, cfg, x, lc, lengths, commit)
        logits = layers.unembed(self.embed, cfg, x[:, None])[:, 0]
        if return_hidden:
            return logits, cache, x
        return logits, cache

    # -- cache construction ----------------------------------------------------

    def cache_spec(self, batch: int, max_seq: int) -> Dict[str, TensorSpec]:
        spec = _block_cache_spec(self.cfg, self.kind, batch, max_seq)
        return {name: TensorSpec((self.cfg.n_layers,) + s.shape, s.dtype)
                for name, s in spec.items()}

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, torch.Tensor]:
        return {name: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for name, s in self.cache_spec(batch, max_seq).items()}
