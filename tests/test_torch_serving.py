"""The port's serving engine against the JAX engine: the fig12 drive.

Both engines serve the same schedule (3 rows x 8 slots, max_seq 128,
8 sessions x 6 turns, gen 4) on the same granite smoke weights in fp32,
with fig12's pinned virtual service costs.  Greedy outputs must be
token-identical and ``summary()`` equal, with and without row kills, and
under the random policy, whose turns migrate session state between rows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.models import build_model
from repro.runtime import RetryPolicy, TraceRecorder
from repro.serving import ServingEngine, make_adapter
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import Model
from repro_torch.runtime import RetryPolicy as TRetryPolicy
from repro_torch.serving import ServingEngine as TServingEngine
from repro_torch.serving import Session as TSession
from repro_torch.serving import make_adapter as tmake_adapter

torch.set_num_threads(1)

N_ROWS, MAX_SLOTS, MAX_SEQ = 3, 8, 128
N_SESSIONS, TURNS, GEN, CKPT_EVERY = 8, 6, 4, 2
SVC = {"decode_step": 1e-3, "prefill_per_tok": 1.25e-4}
DT = SVC["decode_step"]
CHAOS = {0: (), 2: ((0, 40, 30), (1, 55, 30))}   # (row, t_down, dur) in DT


@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(configs.get_smoke("granite-3-2b"),
                              param_dtype=jnp.float32,
                              compute_dtype=jnp.float32)
    jmodel = build_model(cfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tconfigs.get_smoke("granite-3-2b"),
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32)
    tmodel = bridge.params_into(
        Model(tcfg, device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
    return (jmodel, params), tmodel


def _engines(models, policy, checkpoint_every, tracers=(None, None)):
    (jmodel, params), tmodel = models
    kw = dict(n_rows=N_ROWS, max_slots=MAX_SLOTS, max_seq=MAX_SEQ,
              policy=policy, checkpoint_every=checkpoint_every)
    jeng = ServingEngine(jmodel, params, tracer=tracers[0], **kw)
    teng = TServingEngine(tmodel, tracer=tracers[1], **kw)
    jeng.retry = RetryPolicy(max_attempts=4, backoff=2 * DT)
    teng.retry = TRetryPolicy(max_attempts=4, backoff=2 * DT)
    return jeng, teng


def drive(eng, intensity, adapters=0):
    """fig12's schedule; with ``adapters``, session i uses adapter
    ``i % adapters`` (registered beforehand)."""
    eng._svc = dict(SVC)
    for row, t_down, dur in CHAOS[intensity]:
        eng.fail_row(row, at=t_down * DT, duration=dur * DT)
    for i in range(N_SESSIONS):
        eng.open_session(f"s{i}",
                         adapter=f"ad{i % adapters}" if adapters else None)
    t, outs = 0.0, {}
    for _ in range(TURNS):
        for i in range(N_SESSIONS):
            out, _ = eng.turn(f"s{i}", [1 + i, 2, 3], gen_tokens=GEN, now=t)
            outs.setdefault(f"s{i}", []).extend(out)
            t += 2 * DT
    return outs


@pytest.mark.parametrize("intensity", [0, 2])
def test_fig12_drive_token_identical(models, intensity):
    jeng, teng = _engines(models, "affinity", CKPT_EVERY)
    want = drive(jeng, intensity)
    got = drive(teng, intensity)
    assert got == want
    assert teng.summary() == jeng.summary()
    assert all(len(v) == TURNS * GEN for v in got.values())
    if intensity:
        s = teng.summary()
        assert s["recoveries_ckpt"] > 0 and s["sessions_displaced"] > 0
        assert s["shed_turns"] == 0 and s["dup_effects"] == 0


def test_random_policy_drive_migrates_token_identical(models):
    jeng, teng = _engines(models, "random", None)
    want = drive(jeng, 0)
    got = drive(teng, 0)
    assert got == want
    assert teng.summary() == jeng.summary()
    assert teng.summary()["migrations"] > 0
    assert [s.length for s in teng.sessions.values()] == \
        [s.length for s in jeng.sessions.values()]


def test_adapter_affinity_drive_token_identical(models):
    """LoRA sessions: the decode path reads the hidden state, adapters are
    fetched per row and routed by adapter affinity.  A fresh adapter's B
    is zero in both packages, so its A may come from either generator."""
    (jmodel, _), tmodel = models
    jeng, teng = _engines(models, "adapter_affinity", None)
    cfg = tmodel.cfg
    for a in range(3):
        jeng.adapters.register(make_adapter(
            jax.random.PRNGKey(a), f"ad{a}", cfg.d_model, cfg.vocab_size))
        teng.adapters.register(tmake_adapter(
            a, f"ad{a}", cfg.d_model, cfg.vocab_size, device="cpu"))
    want = drive(jeng, 0, adapters=3)
    got = drive(teng, 0, adapters=3)
    assert got == want
    assert teng.summary() == jeng.summary()
    assert teng.summary()["adapter_fetch_bytes"] > 0


def test_rebalance_moves_the_same_groups(models):
    jeng, teng = _engines(models, "affinity", None)
    drive(jeng, 0)
    drive(teng, 0)
    loads = [r.load() for r in teng.rows]
    assert loads == [r.load() for r in jeng.rows]
    moves = teng.rebalance(imbalance=1, max_moves=2)
    assert moves == jeng.rebalance(imbalance=1, max_moves=2)
    assert moves, loads
    # the moved groups' next turns follow them, migrating state for real
    t = 1.0
    for i in range(N_SESSIONS):
        got, _ = teng.turn(f"s{i}", [4], gen_tokens=GEN, now=t)
        want, _ = jeng.turn(f"s{i}", [4], gen_tokens=GEN, now=t)
        assert got == want
        t += 2 * DT
    assert teng.summary() == jeng.summary()
    assert teng.summary()["migrations"] > 0


def test_traced_chaos_drive_emits_the_same_spans(models):
    """The tracer argument takes the reference's TraceRecorder as it is."""
    recs = (TraceRecorder(), TraceRecorder())
    jeng, teng = _engines(models, "affinity", CKPT_EVERY, tracers=recs)
    drive(jeng, 2)
    drive(teng, 2)

    def spans(rec):
        return sorted((tr.instance, sp.cat, sp.name, sp.t0, sp.t1, sp.node)
                      for tr in rec.traces() for sp in tr.spans)
    assert spans(recs[1]) == spans(recs[0])
    assert any(sp[1] == "recovery" for sp in spans(recs[1]))


def test_new_session_inherits_stale_length_of_a_migrated_slot(models):
    """A reference fact the port reproduces: migrating a session frees its
    slot without zeroing the slot's length, and a new session that takes
    the slot starts at that stale length over a cleared cache."""
    jeng, teng = _engines(models, "random", None)
    for eng in (jeng, teng):
        eng._svc = dict(SVC)
        eng.open_session("a")
        eng.turn("a", [5, 6, 7], gen_tokens=GEN, now=0.0)
    ta, ja = teng.sessions["a"], jeng.sessions["a"]
    first_row, first_slot = ta.row, ta.slot
    t, k = 0.0, 1
    while ta.row == first_row:       # random routing: turn until it moves
        stale = ta.length            # what the slot holds when it is left
        t += 2 * DT
        teng.turn("a", [1 + k], gen_tokens=GEN, now=t)
        jeng.turn("a", [1 + k], gen_tokens=GEN, now=t)
        k += 1
    src = teng.rows[first_row]
    assert not src.active[first_slot]
    assert int(src.lengths[first_slot]) == stale
    assert int(jeng.rows[first_row].lengths[first_slot]) == stale
    assert torch.count_nonzero(src.cache["k"][:, first_slot]) == 0
    # a new session whose first turn lands on that row takes the slot
    sid = next(f"n{i}" for i in range(1000)
               if teng.router.route(TSession(f"n{i}"), f"n{i}:0")
               == first_row)
    teng.open_session(sid)
    jeng.open_session(sid)
    t += 2 * DT
    got, _ = teng.turn(sid, [9, 8, 7], gen_tokens=GEN, now=t)
    want, _ = jeng.turn(sid, [9, 8, 7], gen_tokens=GEN, now=t)
    assert got == want
    assert teng.sessions[sid].slot == first_slot
    assert teng.sessions[sid].length == stale + 3 + GEN
    assert jeng.sessions[sid].length == stale + 3 + GEN
    assert ja.length == ta.length
