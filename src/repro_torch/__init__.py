"""PyTorch port of the affinity-group serving system, for NVIDIA Hopper.

Mirrors the module names of the JAX package ``repro``: the serving engine
(``repro_torch.serving``) runs multi-turn chat sessions routed by affinity
group over a dense model (``repro_torch.models``) whose decode attention
is a hand-written CUDA kernel (``repro_torch.kernels``).  Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""
