"""The kernel entry points the model calls.

Each dispatches by the device of the tensors it is given: the plain
version in ``ref.py`` on the CPU, the hand-written kernel on CUDA.  There
is no global backend switch, so a CUDA tensor never reaches the plain
version.  ``ssd_decode`` and ``rglru_decode`` are one recurrent step each,
einsum- or elementwise-bound, and no kernel on any device, as in the
reference.
"""
from .decode_attention import decode_attention
from .flash_attention import flash_attention as mha
from .ref import rglru_decode, ssd_decode
from .rglru_scan import rglru_scan as rglru
from .ssd_scan import ssd_scan as ssd

__all__ = ["decode_attention", "mha", "rglru", "rglru_decode", "ssd",
           "ssd_decode"]
