"""RG-LRU recurrent block (Griffin / RecurrentGemma): the counterpart of
``repro.models.rglru``.

Residual block layout follows Griffin: norm -> temporal mixer -> residual,
where the mixer is the gated recurrent branch (linear -> causal conv ->
RG-LRU) multiplied by a GeLU branch, followed by an output projection.
Gates use block-diagonal linears (``GATE_BLOCKS`` blocks) as in the
reference.  The recurrence runs through ``ops.rglru`` (the plain scan on
the CPU, the hand-written kernel on the card); the decode step through
``ops.rglru_decode``.  The cache is ``{"h": (B, W), "conv": (B, cw-1, W)}``
in the compute dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from .common import (ModelConfig, Params, TensorSpec, ones_init, scaled_init,
                     zeros_init)
from .layers import ParamSpec, rmsnorm

GATE_BLOCKS = 16
LRU_C = 8.0


def rglru_param_spec(cfg: ModelConfig) -> ParamSpec:
    """The parameters ``init_rglru_block`` makes, in its order."""
    d, W, cw = cfg.d_model, cfg.lru_width, cfg.conv_width
    nb = GATE_BLOCKS
    return {
        "ln": ((d,), ones_init, {}),
        "w_x": ((d, W), scaled_init, {"fan_in": d}),
        "w_gate": ((d, W), scaled_init, {"fan_in": d}),
        "conv_w": ((cw, W), scaled_init, {"fan_in": cw}),
        "conv_b": ((W,), zeros_init, {}),
        "gate_a_w": ((nb, W // nb, W // nb), scaled_init,
                     {"fan_in": W // nb}),
        "gate_a_b": ((W,), zeros_init, {}),
        "gate_x_w": ((nb, W // nb, W // nb), scaled_init,
                     {"fan_in": W // nb}),
        "gate_x_b": ((W,), zeros_init, {}),
        "lam": ((W,), ones_init, {}),
        "w_out": ((W, d), scaled_init, {"fan_in": W}),
    }


def _blockdiag(u: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """u: (..., W) -> (..., W) through a block-diagonal linear (nb
    blocks)."""
    nb, bin_, bout = w.shape
    shp = u.shape
    ub = u.reshape(shp[:-1] + (nb, bin_))
    out = torch.einsum("...ni,nio->...no", ub, w.to(u.dtype))
    return out.reshape(shp[:-1] + (nb * bout,)) + b.to(u.dtype)


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of u (B, S, W) with w (cw, W) and a bias, in
    the reference's order of adds."""
    cw = w.shape[0]
    out = u * w[-1].to(u.dtype)
    for i in range(1, cw):
        shifted = F.pad(u, (0, 0, i, 0))[:, :u.shape[1]]
        out = out + shifted * w[cw - 1 - i].to(u.dtype)
    return out + b.to(u.dtype)


def _gates(p: Params, u: torch.Tensor):
    """The per-step decay a and input term b of the recurrence, in u's
    dtype."""
    r = torch.sigmoid(_blockdiag(u, p["gate_a_w"], p["gate_a_b"]))
    i = torch.sigmoid(_blockdiag(u, p["gate_x_w"], p["gate_x_b"]))
    log_a = -LRU_C * F.softplus(p["lam"].float()) * r.float()
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * (i.float() * u.float())
    return a.to(u.dtype), b.to(u.dtype)


def _branches(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """The recurrent branch's input u_in and the GeLU gate g of x."""
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    cd = cfg.compute_dtype
    u_in = h @ p["w_x"].to(cd)
    g = F.gelu(h @ p["w_gate"].to(cd), approximate="tanh")
    return u_in, g


def _rglru_full(p: Params, cfg: ModelConfig, x: torch.Tensor):
    u_in, g = _branches(p, cfg, x)
    u = _causal_conv(u_in, p["conv_w"], p["conv_b"])
    a, b = _gates(p, u)
    hseq, hfin = ops.rglru(a, b)
    out = (hseq * g) @ p["w_out"].to(cfg.compute_dtype)
    return x + out, u_in, hfin


def rglru_train(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return _rglru_full(p, cfg, x)[0]


def rglru_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns the block's output and its cache: the last carry and the
    last cw-1 conv inputs.  A prompt shorter than cw-1 keeps all its S
    rows, as the reference's slice does: fewer than the cache spec's."""
    out, u_in, hfin = _rglru_full(p, cfg, x)
    cw = cfg.conv_width
    return out, {"h": hfin.to(cfg.compute_dtype),
                 "conv": u_in[:, -(cw - 1):, :]}


def rglru_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], lengths: torch.Tensor,
                 commit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, d) one token per row; cache h (B, W), conv (B, cw-1, W).

    Advances h and the conv history IN PLACE and returns the block's
    output.  Rows outside the bool mask ``commit`` (None: every row) keep
    their h and history bit for bit, which is what the JAX engine's
    ``_commit(old, new, mask)`` gives."""
    del lengths
    cd = cfg.compute_dtype
    u_in, g = _branches(p, cfg, x[:, None, :])
    u_in, g = u_in[:, 0], g[:, 0]                             # (B, W)
    hist = torch.cat([cache["conv"], u_in[:, None, :]], dim=1)
    u = (torch.einsum("bcw,cw->bw", hist, p["conv_w"].to(cd))
         + p["conv_b"].to(cd))
    a, b = _gates(p, u[:, None, :])
    hnew, _ = ops.rglru_decode(a[:, 0], b[:, 0], cache["h"])
    out = (hnew * g) @ p["w_out"].to(cd)
    new = {"h": hnew, "conv": hist[:, 1:]}
    for name, t in new.items():
        dst = cache[name]
        t = t.to(dst.dtype)
        if commit is not None:
            t = torch.where(commit.reshape((-1,) + (1,) * (t.dim() - 1)),
                            t, dst)
        dst.copy_(t)
    return x + out


def rglru_cache_spec(cfg: ModelConfig, batch: int,
                     max_seq: int) -> Dict[str, TensorSpec]:
    del max_seq
    W, cw, cd = cfg.lru_width, cfg.conv_width, cfg.compute_dtype
    return {"h": TensorSpec((batch, W), cd),
            "conv": TensorSpec((batch, cw - 1, W), cd)}
