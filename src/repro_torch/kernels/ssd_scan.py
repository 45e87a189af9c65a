"""Wrapper of the hand-written SSD-scan kernel (``csrc/ssd_scan.cu``),
which replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``.

A tensor on the CPU goes to the plain version ``ref.ssd``; a tensor on a
CUDA device goes to the kernel, or the wrapper raises.  There is no
fallback from one to the other.  ``ssd_scan.launches`` counts the
kernel's launches, so a run can show that its scans went through it.

The kernel starts from a zero state, as the TPU kernel asserts: an
``init_state`` is taken by the plain version only.  It is forward only:
with grad mode on and an input that requires grad, the wrapper raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build, ref

NAME = "ssd_scan"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory one block may use on Hopper (bytes)
_MAX_SMEM = 232_448
# 64 x 64 register tiles a thread holds (kMaxTiles in csrc/ssd_scan.cu): y
# needs ceil(P/64), the state update ceil(P/64) * ceil(N/64)
_MAX_TILES = 2


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_ssd_scan.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                       i, i, i, p]
        lib.repro_ssd_scan.restype = i
        lib.repro_ssd_scan_smem_bytes.argtypes = [i, i, i]
        lib.repro_ssd_scan_smem_bytes.restype = ctypes.c_size_t
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(x, dt, A, Bm, Cm, D) -> None:
    """Raise on what the kernel does not take."""
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError("x (B,S,H,P), dt (B,S,H), Bm/Cm (B,S,G,N)")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (B, S, H) or Bm.shape != (B, S, G, N)
            or Cm.shape != Bm.shape or A.shape != (H,)
            or (D is not None and D.shape != (H,))):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if S == 0 or G == 0 or H % G:
        raise ValueError(f"S={S}; {H} heads over {G} groups")
    if B > 65535:
        raise ValueError(f"B = {B} rows of blocks, more than 65535")
    if -(-P // 64) * -(-N // 64) > _MAX_TILES:
        raise ValueError(f"P={P}, N={N}: the kernel takes ceil(P/64) * "
                         f"ceil(N/64) <= {_MAX_TILES}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"dtypes {x.dtype}/{Bm.dtype}/{Cm.dtype}: x, Bm and "
                        "Cm must be float32 or bfloat16, all alike")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                    ("D", D)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous: the kernel does "
                             "not copy its inputs")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             D: Optional[torch.Tensor] = None, *, chunk: int = 256,
             init_state: Optional[torch.Tensor] = None,
             unroll: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P); dt (B,S,H); A (H,); Bm/Cm (B,S,G,N); D (H,) or None.
    Returns (y (B,S,H,P) in x's dtype, final state (B,H,P,N) fp32).  See
    ``ref.ssd`` for the semantics; ``unroll`` shapes only the reference's
    HLO.  dt, A and D are taken in fp32, as the TPU wrapper casts them."""
    tensors = (x, dt, A, Bm, Cm) + ((D,) if D is not None else ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("ssd_scan has no backward kernel: call it under "
                           "torch.no_grad()")
    if x.device.type == "cpu":
        return ref.ssd(x, dt, A, Bm, Cm, D, chunk=chunk,
                       init_state=init_state, unroll=unroll)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for {x.device}")
    if init_state is not None:
        raise ValueError("the ssd_scan kernel starts from a zero state; "
                         "ref.ssd takes an init_state")
    _check(x, dt, A, Bm, Cm, D)
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    lib = _lib()
    smem = lib.repro_ssd_scan_smem_bytes(L, P, N)
    if smem > _MAX_SMEM:
        raise ValueError(f"L={L}, P={P}, N={N} need {smem} bytes of shared "
                         f"memory, more than {_MAX_SMEM}")
    dt, A = dt.float(), A.float()
    D = D.float() if D is not None else None
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.repro_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), D.data_ptr() if D is not None else None,
        y.data_ptr(), state.data_ptr(), _DTYPES[x.dtype], B, S, H, P, G, N,
        L, stream)
    if err != 0:
        raise RuntimeError("ssd_scan kernel: "
                           + lib.repro_cuda_error_string(err).decode())
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
