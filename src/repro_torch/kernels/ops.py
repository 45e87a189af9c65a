"""The kernel entry points the model calls.

Each dispatches by the device of the tensors it is given: the plain
version in ``ref.py`` on the CPU, the hand-written kernel on CUDA.  There
is no global backend switch, so a CUDA tensor never reaches the plain
version.
"""
from .decode_attention import decode_attention
from .flash_attention import flash_attention as mha

__all__ = ["decode_attention", "mha"]
