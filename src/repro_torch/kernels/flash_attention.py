"""Wrapper of the hand-written flash-attention kernel
(``csrc/flash_attention.cu``), which replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.

A tensor on the CPU goes to the plain version ``ref.mha``; a tensor on a
CUDA device goes to the kernel, or the wrapper raises.  There is no
fallback from one to the other.  ``flash_attention.launches`` counts the
kernel's launches, so a run can show that its attention went through it.

The kernel is forward only, as the TPU kernel is: with grad mode on and
an input that requires grad, the wrapper raises instead of returning a
tensor without a gradient.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref

NAME = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory one block may use on Hopper (bytes)
_MAX_SMEM = 232_448


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_typed", False):
        p, i, f, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                        ctypes.c_int64)
        lib.repro_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                              i, p, f, f, i, i, i64, p]
        lib.repro_flash_attention.restype = i
        lib.repro_flash_attention_smem_bytes.argtypes = [i, i]
        lib.repro_flash_attention_smem_bytes.restype = ctypes.c_size_t
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S|T, heads, dim)")
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape != (B, T, K, D) or v.shape[:3] != (B, T, K):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    if T == 0:
        raise ValueError("no keys: T == 0")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} blocks per query tile, more than "
                         "65535")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                        "takes float32 or bfloat16, all alike")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.shape[-1] % 8:
            raise ValueError(f"{name}: head dim {t.shape[-1]} is not a "
                             "multiple of 8")
        # 16-byte loads: unit last stride, aligned rows
        step = 16 // t.element_size()
        if t.stride(-1) != 1 or any(s % step for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: strides {t.stride()} / address: the "
                             "kernel needs a unit last stride and rows on "
                             "16-byte boundaries")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    q_offset: int = 0, q_chunk: int = 0,
                    unroll: bool = False) -> torch.Tensor:
    """q (B,S,H,D); k/v (B,T,K,D/Dv), H = g*K.  Returns (B,S,H,Dv) in q's
    dtype.  See ``ref.mha`` for the semantics.  ``q_chunk`` and ``unroll``
    shape only the plain version's evaluation; the kernel tiles itself."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward kernel: call it "
                           "under torch.no_grad()")
    if q.device.type == "cpu":
        return ref.mha(q, k, v, causal=causal, window=window,
                       softcap=softcap, scale=scale, q_offset=q_offset,
                       q_chunk=q_chunk, unroll=unroll)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    _check(q, k, v)
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    lib = _lib()
    smem = lib.repro_flash_attention_smem_bytes(D, Dv)
    if smem > _MAX_SMEM:
        raise ValueError(f"D={D}, Dv={Dv} need {smem} bytes of shared "
                         f"memory, more than {_MAX_SMEM}")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, S, T, H, K, D, Dv, strides, float(scale),
        float(softcap or 0.0), int(bool(causal)), int(window or 0),
        int(q_offset), stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel: "
                           + lib.repro_cuda_error_string(err).decode())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
