"""The dense ``Model`` of the port: init, cache and the decode step.

The counterpart of ``repro.models.model.Model`` for the dense family
(GQA attention + MLP blocks).  Layers run as a Python loop over
``nn.Module`` blocks; the cache keeps the JAX layout
``{"k", "v"}: (layers, slots, Smax, K, Dh)``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from . import layers
from .common import ModelConfig, TensorSpec, resolve_device


def _param_dict(spec: layers.ParamSpec, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                           requires_grad=False)
        for name, (shape, _, _) in spec.items()})


class Block(nn.Module):
    """One dense layer: attention mixer then MLP, each with its own norm."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.mixer = _param_dict(layers.attention_param_spec(cfg),
                                 cfg.param_dtype, device)
        self.mlp = _param_dict(layers.mlp_param_spec(cfg), cfg.param_dtype,
                               device)


class Model(nn.Module):
    """Dense decoder.  Runs on CUDA unless ``device`` names another."""

    def __init__(self, cfg: ModelConfig, device: Optional[Any] = None):
        super().__init__()
        if (cfg.family != "dense" or cfg.mla or cfg.block_pattern
                or cfg.attn_window or cfg.frontend != "none"):
            raise NotImplementedError(
                f"{cfg.name}: the port serves the dense family only")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.embed = _param_dict(layers.embedding_param_spec(cfg),
                                 cfg.param_dtype, self.device)
        self.layers = nn.ModuleList(Block(cfg, self.device)
                                    for _ in range(cfg.n_layers))

    # -- init ---------------------------------------------------------------

    def _specs(self):
        cfg = self.cfg
        yield self.embed, layers.embedding_param_spec(cfg)
        for blk in self.layers:
            yield blk.mixer, layers.attention_param_spec(cfg)
            yield blk.mlp, layers.mlp_param_spec(cfg)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every weight from ``generator``, in a fixed order."""
        for pd, spec in self._specs():
            for name, (shape, init_fn, kw) in spec.items():
                pd[name].copy_(init_fn(generator, shape, self.cfg.param_dtype,
                                       device=self.device, **kw))
        return self

    # -- decode ---------------------------------------------------------------

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, lengths: torch.Tensor,
                    cache: Dict[str, torch.Tensor], return_hidden: bool = False,
                    commit: Optional[torch.Tensor] = None):
        """tokens (B,) int, lengths (B,) int32.  Returns (logits (B,V) fp32,
        cache), plus the hidden state before the final norm when
        ``return_hidden``.

        The cache is updated IN PLACE and returned as the same dict: each
        row's K/V is written at its length, and rows outside the bool mask
        ``commit`` (None: every row) are restored after attention.  That is
        what JAX's ``_commit(old, decode_step(...), commit)`` gives, without
        rewriting the whole cache each token.
        """
        cfg = self.cfg
        x = layers.embed(self.embed, cfg, tokens)
        for i, blk in enumerate(self.layers):
            lc = {"k": cache["k"][i], "v": cache["v"][i]}
            x = layers.attention_decode(blk.mixer, cfg, x, lc, lengths,
                                        commit=commit)
            x = layers.mlp_block(blk.mlp, cfg, x[:, None, :])[:, 0]
        logits = layers.unembed(self.embed, cfg, x[:, None])[:, 0]
        if return_hidden:
            return logits, cache, x
        return logits, cache

    # -- cache construction ----------------------------------------------------

    def cache_spec(self, batch: int, max_seq: int) -> Dict[str, TensorSpec]:
        spec = layers.attention_cache_spec(self.cfg, batch, max_seq)
        return {name: TensorSpec((self.cfg.n_layers,) + s.shape, s.dtype)
                for name, s in spec.items()}

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, torch.Tensor]:
        return {name: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for name, s in self.cache_spec(batch, max_seq).items()}
