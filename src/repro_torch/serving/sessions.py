"""Session registry + affinity routing for the serving engine.

Paper §7.2 applied: a session's decode state and its LoRA adapter are
*data objects*; each decode request is a *task*.  One affinity function
covers both, so the placement engine sends every turn of a session to the
row that already holds its state.  Baselines (random / least-loaded) pay a
state migration whenever the row changes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from repro_torch.core import (CallableAffinity, Descriptor, PlacementEngine,
                              stable_hash)


@dataclasses.dataclass
class Session:
    sid: str
    adapter: Optional[str] = None
    row: Optional[int] = None        # current home row
    slot: Optional[int] = None
    length: int = 0                  # tokens in decode state
    turns: int = 0
    migrations: int = 0
    migrated_bytes: int = 0
    # -- recovery state ------------------------------------------------------
    # the exact token sequence fed into the decode cache (prompts + the
    # decode inputs): replaying it rebuilds the cache, so losing a row never
    # loses a session — only time
    transcript: List[int] = dataclasses.field(default_factory=list)
    lost_state: bool = False         # row died under us; state must rebuild
    ckpt: Any = None                 # periodic KV snapshot (a cache copy)
    ckpt_len: int = 0                # transcript prefix the snapshot covers
    recoveries: int = 0
    shed: int = 0                    # turns given up after retry budget


class SessionRouter:
    """policy: 'affinity' | 'adapter_affinity' | 'random' | 'least_loaded'"""

    def __init__(self, n_rows: int, policy: str = "affinity", seed: int = 0):
        self.n_rows = n_rows
        self.policy = policy
        self._rr = stable_hash(str(seed))

        def fn(desc: Descriptor):
            if policy == "affinity":
                return desc.get("sid")
            if policy == "adapter_affinity":
                return desc.get("adapter") or desc.get("sid")
            return None   # random baseline: hash the unique request key

        self.engine = PlacementEngine(
            [str(i) for i in range(n_rows)],
            affinity_fn=CallableAffinity(fn, name=policy))

    def route(self, session: Session, request_id: str,
              row_loads: Optional[List] = None) -> int:
        # row_loads entries are any comparable load signal; the engine
        # passes (no-free-lane, virtual backlog, active sessions) tuples
        if self.policy == "least_loaded" and row_loads is not None:
            return min(range(self.n_rows), key=lambda r: row_loads[r])
        desc = Descriptor.of(f"/requests/{request_id}", kind="task",
                             sid=session.sid, adapter=session.adapter)
        return int(self.engine.place(desc).shard)

    # -- group migration (serving side) -------------------------------------

    def label_of(self, session: Session) -> str:
        """The session's affinity-group label under the active policy."""
        desc = Descriptor.of(f"/requests/{session.sid}:probe", kind="task",
                             sid=session.sid, adapter=session.adapter)
        return self.engine.place(desc).label

    def pin_group(self, label: str, row: int) -> None:
        """Re-home a whole session group; every member's next turn follows
        (paying its state migration once)."""
        self.engine.pin(label, str(row))

    def unpin_group(self, label: str) -> None:
        self.engine.unpin(label)
