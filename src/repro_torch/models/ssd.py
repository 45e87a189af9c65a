"""Mamba-2 block built on the SSD (state-space duality) scan: the
counterpart of ``repro.models.ssd``.

Block layout follows the Mamba-2 reference: in-proj produces
[z, x, B, C, dt]; causal depthwise conv over [x, B, C]; SSD; gated RMSNorm;
out-proj.  The SSD runs through ``ops.ssd`` (the plain chunked version on
the CPU, the hand-written kernel on the card); the decode step through
``ops.ssd_decode``.  The cache is ``{"state": (B,H,P,N) fp32, "conv_x",
"conv_B", "conv_C": the last cw-1 inputs of each conv}``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from .common import (ModelConfig, Params, TensorSpec, ones_init, scaled_init,
                     zeros_init)
from .layers import ParamSpec, rmsnorm


def dims(cfg: ModelConfig):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    P = cfg.ssm_head_dim
    H = di // P
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    return d, di, P, H, G, N


def ssd_param_spec(cfg: ModelConfig) -> ParamSpec:
    """The parameters ``init_ssd_block`` makes, in its order."""
    d, di, P, H, G, N = dims(cfg)
    cw = cfg.conv_width
    return {
        "ln": ((d,), ones_init, {}),
        "wz": ((d, di), scaled_init, {"fan_in": d}),
        "wx": ((d, di), scaled_init, {"fan_in": d}),
        "wB": ((d, G * N), scaled_init, {"fan_in": d}),
        "wC": ((d, G * N), scaled_init, {"fan_in": d}),
        "wdt": ((d, H), scaled_init, {"fan_in": d}),
        "conv_x": ((cw, di), scaled_init, {"fan_in": cw}),
        "conv_B": ((cw, G * N), scaled_init, {"fan_in": cw}),
        "conv_C": ((cw, G * N), scaled_init, {"fan_in": cw}),
        "dt_bias": ((H,), zeros_init, {}),
        "A_log": ((H,), zeros_init, {}),
        "Dskip": ((H,), ones_init, {}),
        "gnorm": ((di,), ones_init, {}),
        "w_out": ((di, d), scaled_init, {"fan_in": di}),
    }


def _conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv of u (B, S, C) with w (cw, C), no bias, in the
    reference's order of adds."""
    cw = w.shape[0]
    out = u * w[-1].to(u.dtype)
    for i in range(1, cw):
        shifted = F.pad(u, (0, 0, i, 0))[:, :u.shape[1]]
        out = out + shifted * w[cw - 1 - i].to(u.dtype)
    return out


def _proj_inputs(p: Params, cfg: ModelConfig, h: torch.Tensor):
    """[z, x, B, C, dt] from the normed input; dt = softplus in fp32."""
    cd = cfg.compute_dtype
    z = h @ p["wz"].to(cd)
    xs = h @ p["wx"].to(cd)
    Bm = h @ p["wB"].to(cd)
    Cm = h @ p["wC"].to(cd)
    dt = F.softplus((h @ p["wdt"].to(cd)).float() + p["dt_bias"].float())
    return z, xs, Bm, Cm, dt


def _gated_out(p: Params, cfg: ModelConfig, x, y, z):
    y = rmsnorm(p["gnorm"], y * F.silu(z), cfg.norm_eps)
    return x + y @ p["w_out"].to(cfg.compute_dtype)


def _A(p: Params) -> torch.Tensor:
    return -torch.exp(p["A_log"].float())


def ssd_train(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return _ssd_full(p, cfg, x)[0]


def _ssd_full(p: Params, cfg: ModelConfig, x: torch.Tensor):
    B, S, _ = x.shape
    d, di, P, H, G, N = dims(cfg)
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    z, xs_in, Bm_in, Cm_in, dt = _proj_inputs(p, cfg, h)
    xs = F.silu(_conv(xs_in, p["conv_x"]))
    Bm = F.silu(_conv(Bm_in, p["conv_B"]))
    Cm = F.silu(_conv(Cm_in, p["conv_C"]))
    y, state = ops.ssd(
        xs.reshape(B, S, H, P), dt, _A(p),
        Bm.reshape(B, S, G, N), Cm.reshape(B, S, G, N),
        p["Dskip"], chunk=cfg.ssm_chunk, unroll=cfg.unroll_inner)
    out = _gated_out(p, cfg, x, y.reshape(B, S, di), z)
    cw = cfg.conv_width
    # a prompt shorter than cw-1 keeps all its S rows, as the reference's
    # slice does: fewer than ssd_cache_spec's cw-1
    cache = {
        "state": state.float(),
        "conv_x": xs_in[:, -(cw - 1):],
        "conv_B": Bm_in[:, -(cw - 1):],
        "conv_C": Cm_in[:, -(cw - 1):],
    }
    return out, cache


def ssd_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor):
    return _ssd_full(p, cfg, x)


def _step_conv(hist_old: torch.Tensor, new: torch.Tensor, w: torch.Tensor,
               cd) -> Tuple[torch.Tensor, torch.Tensor]:
    """One conv output from the last cw-1 inputs and ``new``, and the
    history shifted by one."""
    hist = torch.cat([hist_old, new[:, None, :]], dim=1)
    out = torch.einsum("bcw,cw->bw", hist, w.to(cd))
    return out, hist[:, 1:]


def ssd_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], lengths: torch.Tensor,
               commit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, d) one token per row; cache as ``ssd_cache_spec``.

    Advances the state and the conv histories IN PLACE and returns the
    block's output.  Rows outside the bool mask ``commit`` (None: every
    row) keep their state and histories bit for bit, which is what the
    JAX engine's ``_commit(old, new, mask)`` gives."""
    del lengths
    Bsz, _ = x.shape
    d, di, P, H, G, N = dims(cfg)
    cd = cfg.compute_dtype
    h = rmsnorm(p["ln"], x[:, None, :], cfg.norm_eps)[:, 0]
    z, xs_in, Bm_in, Cm_in, dt = _proj_inputs(p, cfg, h)      # dt (B,H)
    xs, cx = _step_conv(cache["conv_x"], xs_in, p["conv_x"], cd)
    Bm, cB = _step_conv(cache["conv_B"], Bm_in, p["conv_B"], cd)
    Cm, cC = _step_conv(cache["conv_C"], Cm_in, p["conv_C"], cd)
    xs, Bm, Cm = F.silu(xs), F.silu(Bm), F.silu(Cm)
    y, state = ops.ssd_decode(
        xs.reshape(Bsz, H, P), dt, _A(p),
        Bm.reshape(Bsz, G, N), Cm.reshape(Bsz, G, N),
        p["Dskip"], cache["state"])
    out = _gated_out(p, cfg, x[:, None, :], y.reshape(Bsz, 1, di),
                     z[:, None, :])[:, 0]
    new = {"state": state, "conv_x": cx, "conv_B": cB, "conv_C": cC}
    for name, t in new.items():
        dst = cache[name]
        t = t.to(dst.dtype)
        if commit is not None:
            t = torch.where(commit.reshape((-1,) + (1,) * (t.dim() - 1)),
                            t, dst)
        dst.copy_(t)
    return out


def ssd_cache_spec(cfg: ModelConfig, batch: int,
                   max_seq: int) -> Dict[str, TensorSpec]:
    del max_seq
    d, di, P, H, G, N = dims(cfg)
    cw, cd = cfg.conv_width, cfg.compute_dtype
    return {
        "state": TensorSpec((batch, H, P, N), torch.float32),
        "conv_x": TensorSpec((batch, cw - 1, di), cd),
        "conv_B": TensorSpec((batch, cw - 1, G * N), cd),
        "conv_C": TensorSpec((batch, cw - 1, G * N), cd),
    }
