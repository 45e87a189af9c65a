"""Wrapper of the hand-written decode-attention kernel
(``csrc/decode_attention.cu``), which replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention``.

A tensor on the CPU goes to the plain version in ``ref.py``; a tensor on
a CUDA device goes to the kernel, or the wrapper raises.  There is no
fallback from one to the other.  ``decode_attention.launches`` counts the
kernel's launches, so a run can show that its attention went through it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref

NAME = "decode_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory one block may use on Hopper (bytes)
_MAX_SMEM = 232_448


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.repro_decode_attention.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                               i, i, f, f, i, p]
        lib.repro_decode_attention.restype = i
        lib.repro_decode_attention_smem_bytes.argtypes = [i, i, i]
        lib.repro_decode_attention_smem_bytes.restype = ctypes.c_size_t
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     softcap: float = 0.0, scale: Optional[float] = None,
                     window: int = 0) -> torch.Tensor:
    """q (B,H,D); caches (B,Smax,K,D/Dv); lengths (B,). Returns (B,H,Dv)
    in q's dtype.  See ``ref.decode_attention`` for the semantics."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, lengths,
                                    softcap=softcap, scale=scale,
                                    window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    B, H, D = q.shape
    if k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError("caches must be (B, Smax, K, D)")
    Smax, K = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    if (k_cache.shape != (B, Smax, K, D)
            or v_cache.shape[:3] != (B, Smax, K)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be int32 of shape (B,)")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}:"
                        " the kernel takes float32 or bfloat16, all alike")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _lib()
    smem = lib.repro_decode_attention_smem_bytes(H // K, D, Dv)
    if smem > _MAX_SMEM:
        raise ValueError(f"g={H // K}, D={D}, Dv={Dv} need {smem} bytes of "
                         f"shared memory, more than {_MAX_SMEM}")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], B, H, K, Smax,
        D, Dv, float(scale), float(softcap or 0.0), int(window or 0), stream)
    if err != 0:
        raise RuntimeError("decode_attention kernel: "
                           + lib.repro_cuda_error_string(err).decode())
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
