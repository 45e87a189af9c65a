"""LoRA adapter store with affinity grouping (paper §7.2's LoRA example).

Adapters are LM-head LoRA deltas: logits += (h @ A) @ B * scale.  Each has
an affinity key (its own id), so sessions using adapter ``a`` can be
routed to rows where ``a`` is resident ('adapter_affinity' policy);
baselines fetch the adapter on first use per row (cost = adapter bytes).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Set

import numpy as np
import torch

from repro_torch.models.common import resolve_device


@dataclasses.dataclass
class LoRAAdapter:
    name: str
    A: torch.Tensor     # (d_model, r)
    B: torch.Tensor     # (r, vocab)
    scale: float = 1.0

    @property
    def nbytes(self) -> int:
        return int(self.A.numel() * self.A.element_size()
                   + self.B.numel() * self.B.element_size())


def make_adapter(seed: int, name: str, d_model: int, vocab: int,
                 rank: int = 8, dtype=torch.float32,
                 device: Optional[Any] = None) -> LoRAAdapter:
    """A fresh adapter: A ~ N(0, 0.02) from a numpy seed, B = 0 (the
    standard LoRA init, so a new adapter leaves the logits unchanged)."""
    device = resolve_device(device)
    a = np.random.default_rng(seed).normal(0.0, 1.0, (d_model, rank)) * 0.02
    return LoRAAdapter(
        name=name,
        A=torch.from_numpy(a).to(device=device, dtype=dtype),
        B=torch.zeros((rank, vocab), dtype=dtype, device=device),
        scale=1.0)


def apply_adapter(logits: torch.Tensor, hidden: torch.Tensor,
                  adapter: LoRAAdapter) -> torch.Tensor:
    delta = (hidden.to(adapter.A.dtype) @ adapter.A) @ adapter.B
    return logits + adapter.scale * delta.to(logits.dtype)


class AdapterStore:
    """Tracks which rows hold which adapters; charges fetch bytes on miss."""

    def __init__(self, n_rows: int):
        self.adapters: Dict[str, LoRAAdapter] = {}
        self.resident: Dict[int, Set[str]] = {r: set() for r in range(n_rows)}
        self.fetches = 0
        self.bytes_fetched = 0

    def register(self, adapter: LoRAAdapter) -> None:
        self.adapters[adapter.name] = adapter

    def peek_bytes(self, row: int, name: Optional[str]) -> int:
        """Fetch bytes ``ensure_resident`` WOULD charge, without fetching —
        the planning half of a turn attempt must not mutate residency."""
        if name is None or name in self.resident[row]:
            return 0
        return self.adapters[name].nbytes

    def drop_row(self, row: int) -> None:
        """A dead row loses its resident adapters with its memory."""
        self.resident[row].clear()

    def ensure_resident(self, row: int, name: Optional[str]) -> int:
        """Returns bytes that had to be fetched to make `name` resident."""
        if name is None or name in self.resident[row]:
            return 0
        ad = self.adapters[name]
        self.resident[row].add(name)
        self.fetches += 1
        self.bytes_fetched += ad.nbytes
        return ad.nbytes

    def get(self, name: str) -> LoRAAdapter:
        return self.adapters[name]
