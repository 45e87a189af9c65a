"""Continuous-batching serving engine with affinity-grouped session state.

The port of ``repro.serving.engine``: real PyTorch execution on one device
+ a virtual clock for the network/queue components a single card does not
have:

  * each *row* models one data-parallel replica group: it owns a slotted
    decode cache and a virtual busy-until time (the rows share the one
    ``Model`` and its weights);
  * requests route through ``SessionRouter`` (affinity vs baselines);
  * a routed turn whose session state lives on another row pays a
    migration: real `read_slot`/`write_slot` tensor movement + virtual
    transfer time = state_bytes / interconnect_bw (the cost affinity
    routing exists to avoid);
  * decode is genuinely batched: one ``decode_step`` advances every active
    slot of the row by one token, and the *virtual* cost of a step is
    priced by ``BatchCostModel`` amortized over the row's active slots, so
    co-residency (what affinity routing maximizes) directly buys decode
    throughput.

Service times (prefill/decode-step) are measured on the real model once and
reused by the virtual clock, so relative policy effects are grounded.

**Fault surface** (driven through ``fail_row``):
a row outage fails any turn whose service window overlaps it, wipes the
row's device state (cache, lengths, resident adapters), displaces its
sessions, and re-routes their groups via the router's ``pin_group`` path to
the best surviving row.  A failed turn retries under the engine's
:class:`~repro.runtime.faults.RetryPolicy` — exponential backoff, bounded
attempts, deadline-aware give-up that *sheds* the turn (session intact,
caller re-admits) instead of retrying forever.  A displaced session's state
rebuilds on its next turn, priced the cheaper of two ways and executed for
real either way:

  * **checkpoint restore**: ship the last periodic KV snapshot
    (``kv_cache.session_cache_bytes`` over the interconnect) and replay
    only the transcript suffix it misses;
  * **re-prefill**: replay the full transcript through the prefill path.

Every turn passes through a :class:`GroupSequencer` keyed by the
session's affinity-group label and commits against a per-session turn
index, so a replayed or retried turn can neither apply its effects twice
nor commit ahead of an earlier uncommitted turn of its group — the
serving-plane half of the exactly-once story (``dup_effects`` and
``order_violations`` stay zero under chaos).

Unlike the JAX engine, which rebuilds the whole cache each token, a
decode step here updates the row's cache and lengths in place
(``Model.decode_step(commit=)``, ``kv_cache``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import EpochFence, GroupSequencer
from repro_torch.models import Model
from repro_torch.runtime.batching import BatchCostModel
from repro_torch.runtime.faults import FailureEvent, RetryPolicy
from repro_torch.runtime.simulation import (CLUSTER_NET, UNIFORM,
                                            HardwareProfile, NetProfile)
from . import kv_cache as kvc
from .adapters import AdapterStore, apply_adapter
from .sessions import Session, SessionRouter


@dataclasses.dataclass
class TurnMetrics:
    sid: str
    row: int
    migrated: bool
    migration_bytes: int
    ttft: float              # virtual seconds to first token
    decode_time: float       # virtual seconds for the remaining tokens
    tokens: int
    e2e: float = 0.0         # request arrival -> last token (or give-up)
    attempts: int = 1
    retry_wait: float = 0.0  # failed-attempt + backoff seconds
    recovered: Optional[str] = None   # "ckpt" | "reprefill" | None
    recovery_time: float = 0.0
    shed: bool = False       # retry budget exhausted: turn not executed


@dataclasses.dataclass
class _RowOutage:
    row: int
    t_down: float
    t_up: float
    event: FailureEvent
    processed: bool = False


@dataclasses.dataclass
class _TurnPlan:
    """Virtual-cost schedule of one attempt — pure arithmetic, no tensor
    or residency mutation, so a planned attempt that dies with its row
    costs wasted time and nothing else."""
    row_idx: int
    t_q: float               # queue wait ends
    t_mig: float             # migration/adapter transfer ends
    t_rec: float             # recovery (restore or re-prefill) ends
    t_first: float           # prefill + first decode step ends
    t_end: float             # last decode step ends
    t_step: float            # virtual seconds per decode step
    mig_bytes: int
    migrated: bool
    recovery: Optional[str]  # "ckpt" | "reprefill" | None


class Row:
    def __init__(self, model: Model, max_slots: int, max_seq: int,
                 profile: HardwareProfile = UNIFORM):
        self.model = model
        self.cache = model.init_cache(max_slots, max_seq)
        self.lengths = torch.zeros((max_slots,), dtype=torch.int32,
                                   device=model.device)
        self.active = np.zeros((max_slots,), bool)
        self.slot_sid: List[Optional[str]] = [None] * max_slots
        self.busy_until = 0.0
        self.decoded_tokens = 0
        # backend tier: virtual decode time divides by the gpu speed, and
        # the tier's own batch curve (if declared) prices amortization
        self.profile = profile
        self.speed = profile.speed_of("gpu")
        self.cost_model = profile.cost_model()   # None -> engine-shared

    def free_slot(self) -> Optional[int]:
        for i, a in enumerate(self.active):
            if not a:
                return i
        return None

    def load(self) -> int:
        return int(self.active.sum())

    def backlog(self, now: float) -> float:
        """Virtual seconds of queued decode work still ahead of ``now`` —
        the row-scheduler analogue of a node's resource queue depth."""
        return max(0.0, self.busy_until - now)


class ServingEngine:
    def __init__(self, model: Model, n_rows: int = 4,
                 max_slots: int = 8, max_seq: int = 256,
                 policy: str = "affinity",
                 net: NetProfile = CLUSTER_NET, seed: int = 0,
                 cost_model: Optional[BatchCostModel] = None,
                 row_profiles: Optional[Sequence[HardwareProfile]] = None,
                 tracer: Optional[Any] = None,
                 retry: Optional[RetryPolicy] = None,
                 checkpoint_every: Optional[int] = None):
        self.model = model
        # optional tracer with the method names of the reference's
        # TraceRecorder (begin/span/instant/complete): every turn becomes
        # one completed trace (queueing/migration/prefill/decode spans
        # telescoping exactly over the turn's virtual window; failed
        # attempts and recovery add retry/recovery spans)
        self.tracer = tracer
        profs = list(row_profiles or [])
        profs += [UNIFORM] * (n_rows - len(profs))
        self.rows = [Row(model, max_slots, max_seq, profile=profs[i])
                     for i in range(n_rows)]
        self.router = SessionRouter(n_rows, policy=policy, seed=seed)
        self.adapters = AdapterStore(n_rows)
        self.net = net
        self.cost_model = cost_model or BatchCostModel(max_batch=max_slots)
        self.max_seq = max_seq
        self.sessions: Dict[str, Session] = {}
        self.metrics: List[TurnMetrics] = []
        self.state_bytes = kvc.session_cache_bytes(model, max_seq)
        # fault surface: outage schedule + retry budget + periodic KV
        # checkpoints (None -> recovery always re-prefills the transcript)
        self.retry = retry or RetryPolicy()
        self.checkpoint_every = checkpoint_every
        self.outages: List[_RowOutage] = []
        # per-group FIFO commit order + exactly-once commit accounting;
        # the fence extends exactly-once from crash faults to split-brain:
        # every group re-route (gang repair) advances the group's epoch,
        # and a commit still holding the pre-repair token is rejected
        # into dup_effects instead of applied
        self.sequencer = GroupSequencer()
        self.fence = EpochFence()
        self.dup_effects = 0
        self.order_violations = 0
        self.shed_turns = 0
        self.turns_failed = 0
        self.recoveries_ckpt = 0
        self.recoveries_reprefill = 0
        self.recovery_bytes = 0
        self.checkpoint_bytes = 0
        self._hwm = 0.0          # high-water mark of driven virtual time
        self._svc = self._calibrate()

    # -- calibration -----------------------------------------------------------

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def _calibrate(self) -> Dict[str, float]:
        """Time a full-batch decode step.  Nothing is committed, so the
        cache is left as it was; on the card the device is synchronized
        around the timing, or it would time the enqueue."""
        B = len(self.rows[0].active)
        dev = self.model.device
        tok = torch.zeros((B,), dtype=torch.long, device=dev)
        lens = torch.zeros((B,), dtype=torch.int32, device=dev)
        keep = torch.zeros((B,), dtype=torch.bool, device=dev)
        cache = self.rows[0].cache
        self.model.decode_step(tok, lens, cache, commit=keep)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(3):
            self.model.decode_step(tok, lens, cache, commit=keep)
        self._sync()
        step = (time.perf_counter() - t0) / 3
        return {"decode_step": step, "prefill_per_tok": step / 8}

    # -- public API ---------------------------------------------------------------

    def open_session(self, sid: str, adapter: Optional[str] = None) -> Session:
        s = Session(sid=sid, adapter=adapter)
        self.sessions[sid] = s
        return s

    # -- fault surface ------------------------------------------------------------

    def fail_row(self, row: int, at: float, duration: float) -> FailureEvent:
        """Schedule a row outage (normally via ``FaultInjector.fail_row``).

        The engine's clock is caller-driven, so outages must be scheduled
        ahead of the turns that will observe them; death effects apply
        lazily when the driven clock first reaches ``at``."""
        if not 0 <= row < len(self.rows):
            raise KeyError(f"unknown row {row!r}")
        if at < self._hwm:
            raise ValueError(f"fail_row at {at} is behind the driven clock "
                             f"{self._hwm}")
        ev = FailureEvent(node=f"row{row}", t_down=at, t_up=at + duration,
                          kind="row")
        self.outages.append(_RowOutage(row=row, t_down=at,
                                       t_up=at + duration, event=ev))
        self.outages.sort(key=lambda o: o.t_down)
        return ev

    def _row_down(self, idx: int, t: float) -> bool:
        return any(o.row == idx and o.t_down <= t < o.t_up
                   for o in self.outages)

    def _sweep_faults(self, t: float) -> None:
        """Apply every outage whose down time the clock has reached: wipe
        the row's device state, displace its sessions, and re-home their
        groups on the best surviving row (the ``pin_group`` repair path —
        the serving analogue of workflow gang re-pinning)."""
        for o in self.outages:
            if o.processed or o.t_down > t:
                continue
            o.processed = True
            row = self.rows[o.row]
            victims = [s for s in self.sessions.values() if s.row == o.row]
            labels = set()
            pin = self.router.policy in ("affinity", "adapter_affinity")
            for s in victims:
                s.row = None
                s.slot = None
                s.lost_state = True
                o.event.sessions_displaced += 1
                if pin:
                    labels.add(self.router.label_of(s))
            # the row's memory is gone: blank cache, stale adapters dropped
            kvc.reset_cache(row.cache)
            row.lengths.zero_()
            row.active[:] = False
            row.slot_sid = [None] * len(row.slot_sid)
            row.busy_until = o.t_up          # serves nothing until recovery
            self.adapters.drop_row(o.row)
            if labels:
                live = [i for i in range(len(self.rows))
                        if not self._row_down(i, o.t_down)]
                proj = {i: self.rows[i].load() for i in live}
                for lbl in sorted(labels):
                    if not live:
                        break
                    tgt = min(live, key=lambda i: (
                        0 if self.rows[i].free_slot() is not None else 1,
                        self.rows[i].backlog(o.t_down), proj[i]))
                    # re-homing claims the group: any in-flight commit
                    # still holding the pre-repair token is fenced off
                    self.fence.advance(lbl)
                    self.router.pin_group(lbl, tgt)
                    proj[tgt] += 1
                    o.event.groups_rerouted += 1

    def _group_label(self, s: Session) -> str:
        """Sequencer label: the affinity-group label under group-aware
        policies, else the session itself (each session is its own group)."""
        if self.router.policy in ("affinity", "adapter_affinity"):
            return self.router.label_of(s)
        return s.sid

    # -- the turn -----------------------------------------------------------------

    def turn(self, sid: str, prompt: List[int], gen_tokens: int = 16,
             now: float = 0.0, deadline: Optional[float] = None
             ) -> Tuple[List[int], TurnMetrics]:
        """One chat turn: route, (maybe recover/migrate), prefill, decode.

        Under faults, a turn whose row dies mid-service fails and retries
        under the engine's retry budget; exhausting it sheds the turn
        (empty output, ``metrics.shed`` set, session untouched).
        ``deadline`` (seconds from ``now``) overrides the policy timeout.
        """
        s = self.sessions[sid]
        turn_idx = s.turns
        req_id = f"{sid}:{turn_idx}"
        self._hwm = max(self._hwm, now)
        if deadline is not None:
            deadline_abs = now + deadline
        elif self.retry.timeout is not None:
            deadline_abs = now + self.retry.timeout
        else:
            deadline_abs = float("inf")
        # per-group FIFO delivery: the synchronous engine serves one turn
        # at a time, so the sequencer acts as an order/duplication
        # invariant — a replay arriving out of admission order (or a turn
        # re-entering while its group is busy) is counted, not silently
        # committed
        label = self._group_label(s)
        self.sequencer.admit(label, req_id)
        if self.sequencer.ready(label) != req_id:
            self.order_violations += 1
        try:
            return self._turn_attempts(s, turn_idx, req_id, prompt,
                                       gen_tokens, now, deadline_abs)
        finally:
            self.sequencer.complete(label)

    def _turn_attempts(self, s: Session, turn_idx: int, req_id: str,
                       prompt: List[int], gen_tokens: int, now: float,
                       deadline_abs: float
                       ) -> Tuple[List[int], TurnMetrics]:
        attempt = 1
        t_att = now
        retry_spans: List[Tuple[str, float, float]] = []
        while True:
            self._sweep_faults(t_att)
            plan = self._plan_attempt(s, req_id, prompt, gen_tokens, t_att)
            fail_at = None if plan is None else \
                self._first_conflict(plan.row_idx, t_att, plan.t_end)
            if plan is not None and fail_at is None:
                return self._execute(s, turn_idx, req_id, prompt,
                                     gen_tokens, now, t_att, attempt,
                                     plan, retry_spans)
            if plan is None:
                # no live row with capacity: shed immediately (graceful
                # degradation — the caller's admission problem now)
                return self._shed(s, req_id, now, t_att, attempt,
                                  retry_spans)
            # the chosen row dies inside our service window: the attempt
            # fails at the death instant, its virtual time wasted
            self.turns_failed += 1
            for o in self.outages:
                if o.row == plan.row_idx and o.t_down == fail_at:
                    o.event.turns_failed += 1
                    break
            retry_spans.append((f"attempt{attempt}", t_att, fail_at))
            backoff = self.retry.backoff_of(attempt)
            attempt += 1
            t_next = fail_at + backoff
            if attempt > self.retry.max_attempts or t_next > deadline_abs:
                return self._shed(s, req_id, now, fail_at, attempt - 1,
                                  retry_spans)
            retry_spans.append(("backoff", fail_at, t_next))
            t_att = t_next

    def _plan_attempt(self, s: Session, req_id: str, prompt: List[int],
                      gen_tokens: int, t_att: float) -> Optional[_TurnPlan]:
        """Route + price one attempt without mutating anything."""
        have_faults = bool(self.outages)
        # the row scheduler's load signal mirrors the DES schedulers'
        # pick_batch ranking (repro.runtime.scheduler.node_load): prefer
        # rows with a free lane first, then the shallowest virtual queue,
        # then the fewest co-resident sessions; dead rows rank last so
        # least-loaded routing never picks one
        signals = [(0 if r.free_slot() is not None else 1,
                    r.backlog(t_att), r.load()) for r in self.rows]
        if have_faults:
            signals = [(2, float("inf"), float("inf"))
                       if self._row_down(i, t_att) else sig
                       for i, sig in enumerate(signals)]
        row_idx = self.router.route(s, req_id, row_loads=signals)
        # capacity overflow (or a dead routed row): spill to the
        # best-signal live row with a free slot
        down = have_faults and self._row_down(row_idx, t_att)
        if down or (s.row != row_idx
                    and self.rows[row_idx].free_slot() is None):
            cands = [i for i, r in enumerate(self.rows)
                     if (i == s.row or r.free_slot() is not None)
                     and not (have_faults and self._row_down(i, t_att))]
            if not cands:
                return None
            row_idx = s.row if s.row in cands else \
                min(cands, key=lambda i: signals[i])
        row = self.rows[row_idx]
        slot_free = (s.slot if s.row == row_idx else row.free_slot())
        if slot_free is None:
            return None

        t = max(t_att, row.busy_until)
        t_q = t                     # queue wait ends here
        mig_bytes = self.adapters.peek_bytes(row_idx, s.adapter)
        migrated = False
        if s.row is not None and s.row != row_idx:
            mig_bytes += self.state_bytes
            migrated = True
        t += self.net.transfer_time(mig_bytes) if mig_bytes else 0.0
        t_mig = t

        # recovery pricing: the engine picks per-session between shipping
        # the last KV checkpoint + replaying the suffix, and re-prefilling
        # the whole transcript — both real, both on the turn's critical
        # path (SAGA's point: session state is bytes, losing it costs
        # either wire time or recompute time, whichever is cheaper)
        recovery = None
        per_tok = self._svc["prefill_per_tok"] / row.speed
        if s.lost_state and s.transcript:
            t_repre = per_tok * len(s.transcript)
            if s.ckpt is not None:
                t_ckpt = (self.net.transfer_time(self.state_bytes)
                          + per_tok * (len(s.transcript) - s.ckpt_len))
                recovery = "ckpt" if t_ckpt <= t_repre else "reprefill"
                t += min(t_ckpt, t_repre)
            else:
                recovery = "reprefill"
                t += t_repre
        t_rec = t

        t_prefill = self._svc["prefill_per_tok"] * len(prompt) / row.speed
        cm = row.cost_model or self.cost_model
        load_after = row.load() + (0 if s.row == row_idx else 1)
        t_step = cm.step_seconds(self._svc["decode_step"],
                                 load_after) / row.speed
        t_dec = 0.0
        for _ in range(gen_tokens):     # repeated add: matches execution
            t_dec += t_step
        return _TurnPlan(row_idx=row_idx, t_q=t_q, t_mig=t_mig, t_rec=t_rec,
                         t_first=t_rec + t_prefill + t_step,
                         t_end=t_rec + t_prefill + t_dec, t_step=t_step,
                         mig_bytes=mig_bytes, migrated=migrated,
                         recovery=recovery)

    def _first_conflict(self, row_idx: int, t0: float,
                        t1: float) -> Optional[float]:
        """Earliest row death inside the attempt's window (t0, t1)."""
        hits = [o.t_down for o in self.outages
                if o.row == row_idx and t0 < o.t_down < t1]
        return min(hits) if hits else None

    def _execute(self, s: Session, turn_idx: int, req_id: str,
                 prompt: List[int], gen_tokens: int, now: float,
                 t_att: float, attempt: int, plan: _TurnPlan,
                 retry_spans: List[Tuple[str, float, float]]
                 ) -> Tuple[List[int], TurnMetrics]:
        """The surviving attempt: real tensor work + commit, priced by
        ``plan``.  Mirrors the original single-shot turn body exactly when
        there is no retry/recovery, so the fault-free path is unchanged."""
        row_idx = plan.row_idx
        row = self.rows[row_idx]
        # epoch token for the commit below: captured after the last fault
        # sweep of the attempt loop, so a repair that re-homed this group
        # BEFORE the surviving attempt is fine, while one racing the
        # attempt itself (an async replay scenario) gets fenced
        label = self._group_label(s)
        fence_tok = self.fence.current(label)
        self.adapters.ensure_resident(row_idx, s.adapter)

        if s.row is not None and s.row != row_idx:
            # migrate session state between rows: real tensor movement
            src = self.rows[s.row]
            payload = kvc.read_slot(src.cache, s.slot)     # a copy
            kvc.clear_slot(src.cache, s.slot)
            src.active[s.slot] = False
            src.slot_sid[s.slot] = None
            slot = row.free_slot()
            assert slot is not None, "row full"
            kvc.write_slot(row.cache, payload, slot)
            row.lengths[slot] = s.length
            s.migrations += 1
            s.migrated_bytes += self.state_bytes
            s.row, s.slot = row_idx, slot
        elif s.row is None:
            slot = row.free_slot()
            assert slot is not None, "row full"
            s.row, s.slot = row_idx, slot
        slot = s.slot
        row.active[slot] = True
        row.slot_sid[slot] = s.sid

        if plan.recovery is not None:
            # real state reconstruction, exactly as priced
            if plan.recovery == "ckpt":
                kvc.write_slot(row.cache, s.ckpt, slot)
                row.lengths[slot] = s.ckpt_len
                replay = s.transcript[s.ckpt_len:]
                self.recoveries_ckpt += 1
                self.recovery_bytes += self.state_bytes
            else:
                row.lengths[slot] = 0
                replay = s.transcript
                self.recoveries_reprefill += 1
            for tok in replay:
                self._advance(row, slot, tok)
            s.lost_state = False
            s.recoveries += 1

        # prefill the prompt token-by-token through decode_step (keeps the
        # slotted cache layout; fine at test scale); like decode, virtual
        # prefill time divides by the row's tier speed
        toks = list(prompt)
        for tok in toks:
            self._advance(row, slot, tok)
        ttft = plan.t_first - now

        out: List[int] = []
        fed: List[int] = []
        adapter = (self.adapters.get(s.adapter) if s.adapter else None)
        tok = toks[-1] if toks else 0
        t_step = plan.t_step
        t_dec = 0.0
        for _ in range(gen_tokens):
            fed.append(int(tok))
            nxt = self._decode_one(row, slot, tok, adapter)
            out.append(nxt)
            tok = int(nxt)
            t_dec += t_step
            row.decoded_tokens += row.load()

        row.busy_until = plan.t_end
        s.length = int(row.lengths[slot])

        # -- exactly-once commit: effects apply against the turn index
        # captured at admission; a duplicated replay cannot re-commit,
        # and a stale-epoch attempt (its group re-homed mid-service by a
        # partitioned or superseding repair) is fenced instead of applied
        if s.turns != turn_idx or not self.fence.check(label, fence_tok):
            self.dup_effects += 1
            return out, self.metrics[-1]
        s.turns = turn_idx + 1
        s.transcript.extend(toks)
        s.transcript.extend(fed)
        if self.checkpoint_every and \
                s.turns % self.checkpoint_every == 0:
            # periodic KV snapshot, shipped off-row in the background
            # (not on this turn's critical path; restore pays the wire)
            s.ckpt = kvc.read_slot(row.cache, slot)       # a copy
            s.ckpt_len = len(s.transcript)
            self.checkpoint_bytes += self.state_bytes

        m = TurnMetrics(sid=s.sid, row=row_idx, migrated=plan.migrated,
                        migration_bytes=plan.mig_bytes, ttft=ttft,
                        decode_time=t_dec, tokens=len(out),
                        e2e=plan.t_end - now, attempts=attempt,
                        retry_wait=t_att - now, recovered=plan.recovery,
                        recovery_time=plan.t_rec - plan.t_mig)
        self.metrics.append(m)
        if self.tracer is not None:
            tr = self.tracer.begin(req_id, now)
            if tr is not None:
                rname = f"row{row_idx}"
                tracer = self.tracer
                for name, a, b in retry_spans:
                    tracer.span(tr, "retry", name, a, b, node=rname)
                tracer.span(tr, "queueing", "row_queue", t_att, plan.t_q,
                            node=rname)
                tracer.span(tr, "migration", "session_migrate", plan.t_q,
                            plan.t_mig, node=rname,
                            args={"bytes": plan.mig_bytes})
                if plan.recovery is not None:
                    tracer.span(tr, "recovery", f"restore_{plan.recovery}",
                                plan.t_mig, plan.t_rec, node=rname,
                                args={"tokens": len(s.transcript),
                                      "from_ckpt": plan.recovery == "ckpt"})
                tracer.span(tr, "compute", "prefill", plan.t_rec,
                            plan.t_end - t_dec, node=rname)
                tracer.span(tr, "compute", "decode", plan.t_end - t_dec,
                            plan.t_end, node=rname,
                            args={"tokens": len(out), "slots": row.load()})
                tracer.complete(tr, plan.t_end)
        return out, m

    def _shed(self, s: Session, req_id: str, now: float, t_give_up: float,
              attempts: int, retry_spans: List[Tuple[str, float, float]]
              ) -> Tuple[List[int], TurnMetrics]:
        """Retry budget (or capacity) exhausted: give the turn up cleanly.
        The session and its transcript are untouched — the turn index is
        not consumed, so the caller can submit it again later."""
        self.shed_turns += 1
        s.shed += 1
        m = TurnMetrics(sid=s.sid, row=-1, migrated=False,
                        migration_bytes=0, ttft=float("nan"),
                        decode_time=0.0, tokens=0,
                        e2e=t_give_up - now, attempts=attempts,
                        retry_wait=t_give_up - now, shed=True)
        self.metrics.append(m)
        if self.tracer is not None:
            tr = self.tracer.begin(req_id, now)
            if tr is not None:
                for name, a, b in retry_spans:
                    self.tracer.span(tr, "retry", name, a, b)
                self.tracer.instant(tr, "turn_shed", t_give_up,
                                    {"sid": s.sid, "attempts": attempts})
                self.tracer.complete(tr, t_give_up)
        return [], m

    # -- internals ---------------------------------------------------------------
    # Cache updates are committed per slot through a mask: every row of the
    # batch runs the step, but only the slot that consumed a token keeps
    # its K/V write (Model.decode_step(commit=)), in place.

    def _step_inputs(self, row: Row, slot: int, tok: int):
        dev = self.model.device
        B = len(row.active)
        toks = torch.zeros((B,), dtype=torch.long, device=dev)
        toks[slot] = tok
        mask = torch.zeros((B,), dtype=torch.bool, device=dev)
        mask[slot] = True
        return toks, mask

    def _advance(self, row: Row, slot: int, tok: int) -> None:
        """Feed one known token into the slot's cache (prefill path)."""
        toks, mask = self._step_inputs(row, slot, tok)
        self.model.decode_step(toks, row.lengths, row.cache, commit=mask)
        row.lengths[slot] += 1

    def _decode_one(self, row: Row, slot: int, tok: int, adapter) -> int:
        toks, mask = self._step_inputs(row, slot, tok)
        if adapter is not None:
            logits, _, hidden = self.model.decode_step(
                toks, row.lengths, row.cache, return_hidden=True,
                commit=mask)
            logits = apply_adapter(logits, hidden, adapter)
        else:
            logits, _ = self.model.decode_step(toks, row.lengths, row.cache,
                                               commit=mask)
        nxt = int(torch.argmax(logits[slot], -1))
        row.lengths[slot] += 1
        return nxt

    # -- load-aware group rebalancing ---------------------------------------------

    def rebalance(self, imbalance: int = 2, max_moves: int = 1
                  ) -> List[Tuple[str, int]]:
        """Move whole session groups off overloaded rows.

        Mirrors the store-side ``GroupMigrator`` at the serving layer: when
        the hottest row holds `imbalance` more active sessions than the
        coldest, the smallest group on the hot row is pinned to the cold
        row.  Sessions follow their group lazily — each member's next turn
        routes to the new row and pays its state migration there (the
        engine's existing migration path), so no decode work is interrupted.
        Returns the (label, destination_row) moves made.
        """
        moves: List[Tuple[str, int]] = []
        # only affinity policies route through the placement engine, so only
        # they can honor a pin — anything else would report moves that
        # never take effect
        if self.router.policy not in ("affinity", "adapter_affinity"):
            return moves
        # migration is lazy (groups move on their next turn), so work on
        # *projected* loads — else the same group gets re-picked each pass
        loads = [r.load() for r in self.rows]
        moved_labels = set()
        for _ in range(max_moves):
            hot = max(range(len(loads)), key=lambda i: loads[i])
            cold = min(range(len(loads)), key=lambda i: loads[i])
            if loads[hot] - loads[cold] < imbalance:
                break
            groups: Dict[str, List[Session]] = {}
            for s in self.sessions.values():
                if s.row == hot:
                    lbl = self.router.label_of(s)
                    if lbl not in moved_labels:
                        groups.setdefault(lbl, []).append(s)
            if not groups:
                break
            # smallest group that still fits the cold row's free slots
            free = len(self.rows[cold].active) - loads[cold]
            cands = sorted(groups.items(), key=lambda kv: len(kv[1]))
            pick = next(((lbl, ss) for lbl, ss in cands if len(ss) <= free),
                        None)
            if pick is None:
                break
            label, members = pick
            self.router.pin_group(label, cold)
            moved_labels.add(label)
            loads[hot] -= len(members)
            loads[cold] += len(members)
            moves.append((label, cold))
        return moves

    # -- reporting ----------------------------------------------------------------

    def summary(self) -> Dict[str, float]:
        if not self.metrics:
            return {}
        ok = [m for m in self.metrics if not m.shed]
        ttfts = np.array([m.ttft for m in ok]) if ok else np.array([0.0])
        migs = sum(m.migrated for m in self.metrics)
        out = {
            "turns": len(self.metrics),
            "ttft_mean": float(ttfts.mean()),
            "ttft_p95": float(np.percentile(ttfts, 95)),
            "migrations": migs,
            "migration_bytes": sum(m.migration_bytes for m in self.metrics),
            "adapter_fetch_bytes": self.adapters.bytes_fetched,
        }
        if self.outages or self.shed_turns or self.dup_effects:
            e2e = np.array([m.e2e for m in ok]) if ok else np.array([0.0])
            out.update(
                turns_ok=len(ok),
                turn_p50=float(np.percentile(e2e, 50)),
                turn_p99=float(np.percentile(e2e, 99)),
                turns_failed=self.turns_failed,
                shed_turns=self.shed_turns,
                recoveries_ckpt=self.recoveries_ckpt,
                recoveries_reprefill=self.recoveries_reprefill,
                recovery_bytes=self.recovery_bytes,
                checkpoint_bytes=self.checkpoint_bytes,
                dup_effects=self.dup_effects,
                order_violations=self.order_violations,
                sessions_displaced=sum(o.event.sessions_displaced
                                       for o in self.outages),
                groups_rerouted=sum(o.event.groups_rerouted
                                    for o in self.outages),
            )
        return out
