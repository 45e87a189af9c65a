"""Wrapper of the hand-written RG-LRU scan kernel (``csrc/rglru_scan.cu``),
which replaces the TPU kernel ``repro/kernels/rglru_scan.py::rglru_scan``.

A tensor on the CPU goes to the plain version ``ref.rglru``; a tensor on a
CUDA device goes to the kernel, or the wrapper raises.  There is no
fallback from one to the other.  ``rglru_scan.launches`` counts the
kernel's launches, so a run can show that its scans went through it.

The kernel takes any S and W (the TPU kernel asks for multiples of its
blocks) and returns ``h_final`` in fp32, as the oracle does.  It is
forward only: with grad mode on and an input that requires grad, the
wrapper raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build, ref

NAME = "rglru_scan"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_rglru_scan.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.repro_rglru_scan.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(a: torch.Tensor, b: torch.Tensor,
           h0: Optional[torch.Tensor]) -> None:
    """Raise on what the kernel does not take."""
    if a.dim() != 3:
        raise ValueError("a and b must be (B, S, W)")
    B, S, W = a.shape
    if b.shape != a.shape or (h0 is not None and h0.shape != (B, W)):
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if S == 0 or W == 0:
        raise ValueError(f"S={S}, W={W}: nothing to scan")
    if B > 65535:
        raise ValueError(f"B = {B} rows of blocks, more than 65535")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"dtypes {a.dtype}/{b.dtype}: a and b must be "
                        "float32 or bfloat16, both alike")
    if h0 is not None and h0.dtype not in _DTYPES:
        raise TypeError(f"h0 is {h0.dtype}, not float32 or bfloat16")
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t is None:
            continue
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous: the kernel does "
                             "not copy its inputs")


def _vec(W: int, *tensors: torch.Tensor) -> int:
    """Channels a thread loads at once: 4 where every row starts on a
    16-byte boundary, else 1."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return 4 if W % 4 == 0 and aligned else 1


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a/b (B,S,W), h0 (B,W) or None.  Returns (h (B,S,W) in a's dtype,
    h_final (B,W) fp32).  See ``ref.rglru`` for the semantics."""
    tensors = (a, b) + ((h0,) if h0 is not None else ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("rglru_scan has no backward kernel: call it "
                           "under torch.no_grad()")
    if a.device.type == "cpu":
        return ref.rglru(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for {a.device}")
    _check(a, b, h0)
    B, S, W = a.shape
    h0 = h0.float() if h0 is not None else None
    lib = _lib()
    h = torch.empty_like(a)
    h_final = torch.empty((B, W), dtype=torch.float32, device=a.device)
    vec = _vec(W, a, b, h, h_final, *((h0,) if h0 is not None else ()))
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.repro_rglru_scan(
        a.data_ptr(), b.data_ptr(), h0.data_ptr() if h0 is not None else None,
        h.data_ptr(), h_final.data_ptr(), _DTYPES[a.dtype], B, S, W, vec,
        stream)
    if err != 0:
        raise RuntimeError("rglru_scan kernel: "
                           + lib.repro_cuda_error_string(err).decode())
    rglru_scan.launches += 1
    return h, h_final


rglru_scan.launches = 0
