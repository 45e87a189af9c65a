"""KV-cache utilities: slot packing, slot moves, byte accounting.

A serving *row* owns a slotted decode cache: every leaf has layout
(layers, slots, ...).  When a session migrates between rows, or is
checkpointed, its slot is read out and later written into another slot.

Unlike the JAX versions these update the row cache IN PLACE.
``read_slot`` returns a copy, never a view: the engine reads a migration
payload and then clears the source slot, and keeps checkpoints while the
cache they came from moves on.
"""
from __future__ import annotations

from typing import Dict

import torch

Cache = Dict[str, torch.Tensor]


def tree_bytes(tree: Cache) -> int:
    return sum(t.numel() * t.element_size() for t in tree.values())


def session_cache_bytes(model, max_seq: int) -> int:
    """Bytes of one session's decode state (the migration payload)."""
    return sum(s.nbytes for s in model.cache_spec(1, max_seq).values())


@torch.no_grad()
def write_slot(row_cache: Cache, prefill_cache: Cache, slot: int) -> Cache:
    """Write a (L,1,...) cache into slot ``slot`` of (L,B,...).  The source
    may be shorter in its trailing dims (a shorter sequence): only that
    leading part of the slot is overwritten."""
    for name, dst in row_cache.items():
        src = prefill_cache[name]
        idx = (slice(None), slice(slot, slot + 1)) + tuple(
            slice(0, s) for s in src.shape[2:])
        dst[idx] = src.to(dst.dtype)
    return row_cache


@torch.no_grad()
def read_slot(row_cache: Cache, slot: int) -> Cache:
    """A copy of one slot's state (L,1,...) — the migration payload."""
    return {name: t[:, slot:slot + 1].clone() for name, t in row_cache.items()}


@torch.no_grad()
def clear_slot(row_cache: Cache, slot: int) -> Cache:
    for t in row_cache.values():
        t[:, slot].zero_()
    return row_cache


@torch.no_grad()
def reset_cache(row_cache: Cache) -> Cache:
    """Zero every slot — a dead row's memory is gone."""
    for t in row_cache.values():
        t.zero_()
    return row_cache
