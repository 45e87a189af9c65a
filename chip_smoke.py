#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py        # from the root of a checkout, on a GPU host

Phases (any failure exits non-zero and prints no result):

  1. build    — compile every kernel's CUDA source under ``src/repro_torch``
                with ``nvcc``, one process per source, all at once, and log
                each kernel's registers, shared memory and spills;
  2. kernels  — hold each kernel against its plain PyTorch version on the
                card, at the paths' shapes and at edge cases;
  3. serve    — full-width granite-3-2b (random weights from a seed, bf16):
                ``ServingEngine`` serves 8 sessions x 2 turns on 2 rows while
                one row dies between the turns, so sessions recover from
                their KV checkpoints; every attention step must go through
                the decode kernel, and the outputs must equal a healthy
                run's.  A small fp32 drive must give the CPU's plain path's
                tokens;
  4. prefill  — the same model prefills 4 prompts of 2,048 tokens in one
                batch (every layer's attention through the flash kernel),
                places each row's cache in a serving slot and decodes 16
                greedy tokens from it;
  5. fp32     — full-width fp32: one ``decode_step`` and one 256-token
                ``prefill``, kernel against plain, and prefill against
                decode (its fp32 weights are freed before the times);
  6. times    — each kernel, its plain version and one PyTorch library call
                on the same inputs, beside the card's least time for the
                work; ``decode_step`` and ``prefill`` times and profiles;
  7. mamba2 serve   — full-width mamba2-780m (random bf16 weights from the
                seed) through the same serving drive and row failure: a
                slot's payload is its SSM state and conv history; a small
                fp32 drive must give the CPU's tokens;
  8. mamba2 prefill — 4 prompts of 2,048 tokens in one batch (every layer's
                SSD scan through the scan kernel), each row's state and
                conv history placed in a serving slot, 16 greedy tokens;
  9. mamba2 fp32    — a full-width fp32 256-token prefill, kernel against
                plain, and prefill against decode;
 10. mamba2 times   — the scan kernel, its plain version and its bound;
                ``prefill`` and ``decode_step`` times and profiles;
 11. recurrentgemma prefill — full-width recurrentgemma-9b (random bf16
                weights from the seed): 4 prompts of 2,048 tokens in one
                batch (26 RG-LRU scans through the scan kernel, 12 local
                attention layers through the flash kernel at head dim 256),
                each row's caches placed in a slot of an 8-slot cache
                (``place_row``), 16 greedy tokens through the decode kernel
                on the 2,048-entry rings;
 12. recurrentgemma fp32  — a full-width fp32 256-token prefill, kernels
                against plain, and prefill(255) + decode against
                prefill(256);
 13. recurrentgemma times — the RG-LRU scan kernel, its plain version and
                its bound; the flash kernel at head dim 256 and the decode
                kernel on full 2,048-entry rings, each beside its plain
                version, its bound and SDPA; ``prefill`` and
                ``decode_step`` times and profiles.

The lines before the last carry the card's name and power limit
(``nvidia-smi``) and one JSON object ``{"kernels": [...]}`` with an entry
for each kernel on each path that runs it (its ``path`` names the model);
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
# the path's shapes: granite-3-2b (H=32, K=8, D=64) on a row of 8 slots
B, H, K, D, SMAX = 8, 32, 8, 64, 512
N_ROWS, PROMPT, GEN, SESSIONS, TURNS = 2, 32, 16, 8, 2
# kernel against plain: the plain version's precision is the yardstick;
# bf16 outputs round to 8 bits of mantissa, so 2e-2 as in the repo's tests
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# full-width fp32 decode step: 40 layers of residual stream carry the
# attention's summation-order differences (~1e-7 each) into the logits
STEP_TOL = 2e-3
# the prefill path: a batch of prompts, each placed in a slot of a row
# cache, then greedy decoding; the fp32 check prefills one shorter prompt
PB, PS, ROW_SLOTS, ROW_SMAX, PGEN, FP32_PROMPT = 4, 2048, 8, 2560, 16, 256
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
BF16_FLOPS = 989e12            # dense tensor-core bf16, the same source
# each kernel: its source, and the TPU kernel it replaces
KERNELS = {
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:68"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:80"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:65"),
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan.py:51"),
}


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def event_ms(fn, iters):
    """Mean device time of ``fn(i)`` over ``iters`` calls, after warm-up."""
    import torch
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# -- phase 2 ------------------------------------------------------------------

def attention_inputs(gen, b, h, k, d, smax, dtype, layers=1):
    import torch
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
    kc = torch.randn((layers, b, smax, k, d), generator=gen,
                     device="cuda").to(dtype)
    vc = torch.randn((layers, b, smax, k, d), generator=gen,
                     device="cuda").to(dtype)
    lengths = torch.randint(1, smax + 2, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
    lengths[0], lengths[-1] = smax + 1, 1        # full, and one entry
    return q, kc, vc, lengths


def phase_kernels(gen):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    cases = [("path", dict(h=H, k=K, d=D, smax=SMAX)),
             ("window", dict(h=H, k=K, d=D, smax=SMAX, window=128)),
             ("softcap", dict(h=H, k=K, d=D, smax=SMAX, softcap=50.0)),
             ("ragged_smax", dict(h=H, k=K, d=D, smax=500)),
             ("mqa", dict(h=H, k=1, d=D, smax=SMAX)),
             # recurrentgemma's local attention: g = 16, D = 256 over a
             # 2,048-entry ring, every length a valid one (<= the ring)
             ("rg_ring", dict(h=16, k=1, d=256, smax=2048, ring=True))]
    errs = {}
    for name, c in cases:
        c = dict(c)
        kw = dict(window=c.pop("window", 0), softcap=c.pop("softcap", 0.0))
        ring = c.pop("ring", False)
        for dt in ("float32", "bfloat16"):
            q, kc, vc, lengths = attention_inputs(
                gen, B, dtype=getattr(torch, dt), **c)
            if ring:
                lengths.clamp_(max=c["smax"])
            got = decode_attention(q, kc[0], vc[0], lengths, **kw)
            want = ref.decode_attention(q, kc[0], vc[0], lengths, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            errs[(name, dt)] = err
            log(f"  decode_attention {name:12s} {dt:9s} max|err| {err:.3e}"
                f" (tol {TOL[dt]})")
            check(torch.allclose(got.float(), want.float(), atol=TOL[dt],
                                 rtol=TOL[dt]), f"kernel != plain: {name} {dt}")
    return errs


# the flash kernel's cases: the prefill path's shape (granite-3-2b, 4 x 2048
# tokens) and its variants; every case runs in fp32 and in bf16
FLASH = dict(B=4, S=2048, T=2048, H=H, K=K, D=D)
FLASH_CASES = [
    ("path", {}),
    ("window", dict(window=128)),
    ("bidirectional", dict(causal=False)),
    ("softcap", dict(softcap=50.0)),
    ("q_offset", dict(S=256, q_offset=1792)),
    ("mla", dict(H=16, K=16, D=192, Dv=128)),
    ("ragged", dict(S=1000, T=1000)),
    ("mqa", dict(K=1)),
    ("head_dim_128", dict(H=40, K=8, D=128)),
    # rows 127.. keep no key (q_offset + i >= T + window - 1), so they
    # average every value; the tile of rows 64..127 mixes both kinds
    ("masked_rows", dict(S=256, T=256, q_offset=192, window=64)),
    # q, k and v as head slices of one fused (B, S, H + 2K, D) tensor: the
    # kernel reads them through their strides
    ("fused_qkv", dict(fused=True)),
    # recurrentgemma-9b's prefill: MQA at head dim 256 (a 32-query tile),
    # causal, and with its 2,048-key window
    ("rg_path", dict(H=16, K=1, D=256)),
    ("rg_window", dict(H=16, K=1, D=256, window=2048)),
]


def flash_inputs(gen, dtype, B, S, T, H, K, D, Dv=None, fused=False, **kw):
    import torch
    if fused:
        qkv = torch.randn((B, S, H + 2 * K, D), generator=gen,
                          device="cuda").to(dtype)
        return (qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]), kw
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, T, K, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, T, K, Dv or D), generator=gen, device="cuda").to(dtype)
    return (q, k, v), kw


def phase_flash(gen):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    errs = {}
    for name, over in FLASH_CASES:
        for dt in ("float32", "bfloat16"):
            (q, k, v), kw = flash_inputs(gen, getattr(torch, dt),
                                         **{**FLASH, **over})
            got = flash_attention(q, k, v, **kw)
            want = ref.mha(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            errs[(name, dt)] = err
            log(f"  flash_attention  {name:13s} {dt:9s} max|err| {err:.3e}"
                f" (tol {TOL[dt]})")
            check(torch.allclose(got.float(), want.float(), atol=TOL[dt],
                                 rtol=TOL[dt]), f"kernel != plain: {name} {dt}")
            del got, want
    return errs


# -- phase 3 ------------------------------------------------------------------

class CountedModel:
    """Counts ``decode_step`` calls and non-finite logits on the device
    (no host sync per step)."""

    def __init__(self, model):
        import torch
        self.calls = 0
        self.bad = torch.zeros((), dtype=torch.int64, device=model.device)
        inner = model.decode_step

        def counted(*a, **kw):
            out = inner(*a, **kw)
            self.calls += 1
            self.bad += (~torch.isfinite(out[0])).sum()
            return out
        model.decode_step = counted


def serve(model, prompts, fail):
    """8 sessions x 2 turns; with ``fail``, row 0 dies between the turns."""
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(model, n_rows=N_ROWS, max_slots=B, max_seq=SMAX,
                        policy="affinity", checkpoint_every=1)
    outs = {}
    t = 0.0
    for turn in range(TURNS):
        if fail and turn == 1:
            t = max(t, max(r.busy_until for r in eng.rows))
            eng.fail_row(0, at=t, duration=1e3)
        for i in range(SESSIONS):
            sid = f"s{i}"
            if turn == 0:
                eng.open_session(sid)
            out, m = eng.turn(sid, prompts[i][turn], gen_tokens=GEN, now=t)
            outs.setdefault(sid, []).append(out)
            t += 1e-3
    return eng, outs


def wrappers():
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"decode_attention": decode_attention,
            "flash_attention": flash_attention, "ssd_scan": ssd_scan,
            "rglru_scan": rglru_scan}


def zero_counts():
    for w in wrappers().values():
        w.launches = 0


def counts():
    return {name: w.launches for name, w in wrappers().items()}


def phase_serve(torch, cfg, gen, per_layer=()):
    """The chaos drive at full width; every decode step must launch each
    kernel named in ``per_layer`` once per layer, and no other kernel."""
    from repro_torch.models import Model
    rng = np.random.default_rng(SEED)
    prompts = [[rng.integers(0, cfg.vocab_size, PROMPT).tolist()
                for _ in range(TURNS)] for _ in range(SESSIONS)]
    t0 = time.perf_counter()
    model = Model(cfg).init(gen)
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"  init: {wbytes / 1e9:.3f} GB of {cfg.param_dtype} weights in "
        f"{time.perf_counter() - t0:.1f} s")
    counted = CountedModel(model)
    healthy, want = serve(model, prompts, fail=False)
    # the drive the launch counts are read from: counts set to 0 just before
    zero_counts()
    counted.calls = 0
    t0 = time.perf_counter()
    eng, got = serve(model, prompts, fail=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, calls = counts(), counted.calls
    s = eng.summary()
    log(f"  calibrated svc {eng._svc}")
    log(f"  chaos drive: {calls} decode steps, launches {launches}, "
        f"{wall:.2f} s wall ({calls / wall:.1f} steps/s); summary {s}")
    check(all(len(o) == GEN for outs in got.values() for o in outs),
          "a turn returned no tokens")
    check(int(counted.bad) == 0, "non-finite logits")
    want_launches = {n: (cfg.n_layers * calls if n in per_layer else 0)
                     for n in launches}
    check(launches == want_launches,
          f"launches {launches} != {want_launches} in {calls} decode steps")
    check(s["recoveries_ckpt"] > 0 and s["sessions_displaced"] > 0,
          "no session recovered from a checkpoint")
    check(s["shed_turns"] == 0 and s["dup_effects"] == 0
          and s["order_violations"] == 0, "turns shed or duplicated")
    check(got == want, "chaos outputs differ from the healthy run's")
    log("  chaos outputs equal the healthy run's, token for token")
    del healthy, eng
    return model, launches, calls, wall


def phase_small_against_cpu(torch, cfg):
    """The fig12 drive at smoke size in fp32: the card's kernel path must
    give the CPU plain path's tokens."""
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine
    small = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    cpu = Model(small, device="cpu").init(torch.Generator().manual_seed(SEED))
    gpu = Model(small)
    gpu.load_state_dict(cpu.state_dict())
    res = []
    for model in (gpu, cpu):
        eng = ServingEngine(model, n_rows=3, max_slots=8, max_seq=128,
                            checkpoint_every=2)
        eng._svc = {"decode_step": 1e-3, "prefill_per_tok": 1.25e-4}
        eng.fail_row(0, at=0.04, duration=0.03)
        t, outs = 0.0, {}
        for _ in range(6):
            for i in range(8):
                if f"s{i}" not in eng.sessions:
                    eng.open_session(f"s{i}")
                out, _ = eng.turn(f"s{i}", [1 + i, 2, 3], gen_tokens=4, now=t)
                outs.setdefault(i, []).extend(out)
                t += 2e-3
        res.append((outs, eng.summary()))
    check(res[0] == res[1], "smoke drive: card tokens differ from the CPU's")
    log(f"  smoke fp32 drive, card == CPU: {sum(map(len, res[0][0].values()))}"
        f" tokens, summary equal")


# -- phase 4 ------------------------------------------------------------------

def prompts(torch, cfg, seed, b, s):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).cuda()


def phase_prefill(torch, model, prefill_launches, step_launches):
    """Prefill PB prompts of PS tokens, place each row's cache in a slot of
    a row cache and decode PGEN greedy tokens there.  The prefill must
    launch each kernel as often as ``prefill_launches`` says, and each
    decode step as often as ``step_launches`` says, and nothing else;
    returns the launches of the prefill and of the decode steps.
    A flat cache is placed by the engine's ``kv_cache.write_slot``, the
    hybrid's group and tail caches by ``place_row``."""
    from repro_torch.models.model import place_row, slot_axis
    from repro_torch.serving import kv_cache
    cfg = model.cfg
    toks = prompts(torch, cfg, SEED, PB, PS)
    # the drive the launch counts are read from: counts set to 0 just before
    zero_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": toks})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    log(f"  prefill {PB} x {PS} tokens: launches {launches}, {wall:.2f} s "
        f"wall (first call)")
    want = {n: prefill_launches.get(n, 0) for n in launches}
    check(launches == want, f"launches {launches} in one prefill, not {want}")
    check(tuple(logits.shape) == (PB, cfg.vocab_size), "prefill logits shape")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    spec = model.cache_spec(PB, PS)
    check(set(cache) == set(spec) and all(
        tuple(cache[n].shape) == s.shape and cache[n].dtype == s.dtype
        for n, s in spec.items()), "prefill cache layout")

    row = model.init_cache(ROW_SLOTS, ROW_SMAX)
    slots = [1, 2, 5, 7]
    for b, slot in enumerate(slots):
        if model.hybrid:
            place_row(row, cache, b, slot)
        else:
            kv_cache.write_slot(
                row, {n: t[:, b:b + 1] for n, t in cache.items()}, slot)

    def placed(n, b, slot):
        ax = slot_axis(n)
        src = cache[n].select(ax, b)
        dst = row[n].select(ax, slot)
        return torch.equal(dst[tuple(slice(0, d) for d in src.shape)], src)
    check(all(placed(n, b, slot) for n in row for b, slot in
              enumerate(slots)), "the prefill cache was not placed")
    del cache
    live = torch.zeros(ROW_SLOTS, dtype=torch.bool, device="cuda")
    live[slots] = True
    tokens = torch.zeros(ROW_SLOTS, dtype=torch.long, device="cuda")
    tokens[slots] = logits.argmax(-1)
    lengths = torch.where(live, PS, 0).to(torch.int32)
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    out = []
    zero_counts()
    for _ in range(PGEN):
        step_logits, _ = model.decode_step(tokens, lengths, row, commit=live)
        bad += (~torch.isfinite(step_logits[live])).sum()
        tokens = torch.where(live, step_logits.argmax(-1), tokens)
        lengths += live.to(torch.int32)
        out.append(tokens[slots])
    torch.cuda.synchronize()
    dec = counts()
    log(f"  {PGEN} greedy decode steps from the placed caches: launches "
        f"{dec}; first tokens {torch.stack(out, 1)[:, :4].tolist()}")
    want = {n: step_launches.get(n, 0) * PGEN for n in dec}
    check(dec == want, f"launches {dec} in {PGEN} decode steps, not {want}")
    check(int(bad) == 0, "non-finite logits decoding after prefill")
    del row
    return launches, dec


# -- phase 5 ------------------------------------------------------------------

def phase_fp32(torch, cfg, gen):
    """Full-width fp32: one decode step and one prefill, kernel against
    plain, and prefill against decode."""
    from repro_torch.kernels import ref
    from repro_torch.models import Model, layers
    from repro_torch.serving import kv_cache
    f32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    model = Model(f32).init(gen)
    cache = model.init_cache(B, SMAX)
    for t in cache.values():
        t.normal_(generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                           device="cuda")
    lengths = torch.randint(0, SMAX + 1, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
    keep = torch.zeros(B, dtype=torch.bool, device="cuda")   # cache kept
    got, _ = model.decode_step(tokens, lengths, cache, commit=keep)
    with mock.patch.object(layers.ops, "decode_attention",
                           ref.decode_attention):
        want, _ = model.decode_step(tokens, lengths, cache, commit=keep)
    err = (got - want).abs().max().item()
    log(f"  fp32 decode_step logits, kernel vs plain: max|err| {err:.3e} "
        f"(tol {STEP_TOL}); |logits| max {want.abs().max().item():.3f}")
    check(err <= STEP_TOL, "full-width step: kernel != plain")
    check(bool(torch.equal(got.argmax(-1), want.argmax(-1))),
          "full-width step: greedy tokens differ")
    del cache

    toks = prompts(torch, cfg, SEED + 1, 1, FP32_PROMPT)
    got, got_cache = model.prefill({"tokens": toks})
    with mock.patch.object(layers.ops, "mha", ref.mha):
        want, want_cache = model.prefill({"tokens": toks})
    errs = {"logits": (got - want).abs().max().item()}
    errs.update({n: (got_cache[n] - want_cache[n]).abs().max().item()
                 for n in got_cache})
    log(f"  fp32 prefill of {FP32_PROMPT} tokens, kernel vs plain: max|err| "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (tol {STEP_TOL})")
    check(max(errs.values()) <= STEP_TOL, "full-width prefill: kernel != plain")
    check(bool(torch.equal(got.argmax(-1), want.argmax(-1))),
          "full-width prefill: greedy tokens differ")
    del want_cache, got_cache

    # the last token through decode_step over the prefill of the others
    _, head = model.prefill({"tokens": toks[:, :-1]})
    row = model.init_cache(1, FP32_PROMPT)
    kv_cache.write_slot(row, head, 0)
    dec, _ = model.decode_step(toks[:, -1], torch.full(
        (1,), FP32_PROMPT - 1, dtype=torch.int32, device="cuda"), row)
    err = (dec - got).abs().max().item()
    log(f"  fp32 prefill({FP32_PROMPT - 1}) + decode_step vs prefill("
        f"{FP32_PROMPT}), last position: max|err| {err:.3e} (tol {STEP_TOL})")
    check(err <= STEP_TOL, "prefill then decode != prefill")
    check(bool(torch.equal(dec.argmax(-1), got.argmax(-1))),
          "prefill then decode: greedy token differs")
    return err


# -- phase 6 ------------------------------------------------------------------

def bound(nbytes, flops):
    """The card's least time for the work (ms), and which rate bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def decode_attention_times(torch, gen, h, k, d, smax, layers, full=False):
    """decode_attention on B rows of a path's shapes (bf16), its plain
    version, SDPA and the bound, cold in L2 as on the path: the calls walk
    ``layers`` layers' caches.  Lengths are drawn at random, or every row
    full with ``full``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    H, K, D, SMAX, L = h, k, d, smax, layers
    q, kc, vc, lengths = attention_inputs(gen, B, H, K, D, SMAX,
                                          torch.bfloat16, layers=L)
    if full:
        lengths.fill_(SMAX)
    before = decode_attention.launches
    ms = event_ms(lambda i: decode_attention(q, kc[i % L], vc[i % L],
                                             lengths), 200)
    plain_ms = event_ms(lambda i: ref.decode_attention(
        q, kc[i % L], vc[i % L], lengths), 50)
    mask = (torch.arange(SMAX, device="cuda")[None]
            < lengths[:, None])[:, None, None]                # (B,1,1,Smax)
    qs = q[:, :, None]                                        # (B,H,1,D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = event_ms(lambda i: sdpa(
        qs, kc[i % L].transpose(1, 2), vc[i % L].transpose(1, 2),
        attn_mask=mask, enable_gqa=True), 200)
    decode_attention.launches = before   # timing launches are not the path's
    kv = int(lengths.clamp(max=SMAX).sum()) * K * (D + D) * 2
    nbytes = kv + q.numel() * 2 * 2 + B * 4
    flops = int(lengths.clamp(max=SMAX).sum()) * H * (2 * D + 2 * D)
    bound_ms, by = bound(nbytes, flops)
    log(f"  decode_attention bf16 B={B} H={H} K={K} D={D} Smax={SMAX} "
        f"(sum len {int(lengths.clamp(max=SMAX).sum())}): kernel {ms:.4f} ms"
        f", plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {by} ({nbytes} B)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by)


def phase_times(torch, model, gen):
    """decode_attention at the path's shapes, cold in L2 as on the path:
    the calls walk the 40 layers' caches (~336 MB per tensor at bf16);
    the decode step's time and profile."""
    from repro_torch.kernels.decode_attention import decode_attention
    times = decode_attention_times(torch, gen, H, K, D, SMAX,
                                   model.cfg.n_layers)
    before = decode_attention.launches

    cache = model.init_cache(B, SMAX)
    tokens = torch.zeros(B, dtype=torch.long, device="cuda")
    lens = torch.full((B,), SMAX // 2, dtype=torch.int32, device="cuda")
    one = torch.zeros(B, dtype=torch.bool, device="cuda")
    one[0] = True
    step_ms = host_ms(lambda: model.decode_step(tokens, lens, cache,
                                                commit=one), 20)
    busy = device_profile(lambda: model.decode_step(tokens, lens, cache,
                                                    commit=one),
                          "decode_attention_kernel")
    decode_attention.launches = before
    log(f"  decode_step bf16 full width, B={B}, len {SMAX // 2}: "
        f"{step_ms:.3f} ms on the host clock; {B / step_ms * 1e3:.1f} tok/s "
        f"with all {B} slots decoding, {1e3 / step_ms:.1f} tok/s for one")
    log(f"  decode_step profile: device busy {busy['busy_ms']:.3f} ms "
        f"({busy['busy_ms'] / step_ms:.1%} of the step), "
        f"{busy['launches']} device kernels, decode_attention "
        f"{busy['attn_ms']:.3f} ms ({busy['attn_ms'] / busy['busy_ms']:.1%}"
        f" of device time)")
    return times


def mha_pairs(S, T, causal=True, window=0, q_offset=0):
    """(query, key) pairs that ``mha``'s mask keeps, per (row, head); a
    row that keeps none averages all T keys."""
    n = 0
    for i in range(S):
        qp = q_offset + i
        hi = min(T, qp + 1) if causal else T
        lo = max(0, qp - window + 1) if window > 0 else 0
        n += hi - lo if lo < hi else T
    return n


def phase_flash_times(torch, model, gen):
    """flash_attention at the prefill path's shape (bf16), its plain
    version and SDPA on the same inputs; then one full-width prefill."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    (q, k, v), _ = flash_inputs(gen, torch.bfloat16, **FLASH)
    before = flash_attention.launches
    ms = event_ms(lambda i: flash_attention(q, k, v), 20)
    plain_ms = event_ms(lambda i: ref.mha(q, k, v), 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = event_ms(lambda i: sdpa(qt, kt, vt, is_causal=True,
                                     enable_gqa=True), 20)
    flash_attention.launches = before   # timing launches are not the path's
    Bq, S, Hq, Dq = q.shape
    T, Dv = k.shape[1], v.shape[-1]
    pairs = Bq * Hq * mha_pairs(S, T)
    flops = pairs * 2 * (Dq + Dv)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, by = bound(nbytes, flops)
    log(f"  flash_attention bf16 causal B={Bq} S=T={S} H={Hq} K={k.shape[2]}"
        f" D={Dq}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {by} ({pairs} pairs, "
        f"{flops} flop, {nbytes} B); kernel at "
        f"{flops / ms / 1e9:.1f} TFLOP/s")
    del q, k, v, qt, kt, vt

    toks = prompts(torch, model.cfg, SEED, PB, PS)
    pre_ms = host_ms(lambda: model.prefill({"tokens": toks}), 3)
    busy = device_profile(lambda: model.prefill({"tokens": toks}),
                          "flash_attention_kernel", iters=1)
    flash_attention.launches = before
    log(f"  prefill bf16 full width, {PB} x {PS} tokens: {pre_ms:.3f} ms on "
        f"the host clock, {PB * PS / pre_ms * 1e3:.0f} tokens/s")
    log(f"  prefill profile: device busy {busy['busy_ms']:.3f} ms "
        f"({busy['busy_ms'] / pre_ms:.1%} of the call), {busy['launches']} "
        f"device kernels, flash_attention {busy['attn_ms']:.3f} ms "
        f"({busy['attn_ms'] / busy['busy_ms']:.1%} of device time)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by)


# -- phase 2: the SSD scan ----------------------------------------------------

# the scan kernel's cases: the mamba2-780m prefill path's shape (4 x 2048
# tokens, H=48, P=64, G=1, N=128, chunk 256) and its variants; every case
# runs in fp32 and in bf16
SSD = dict(B=4, S=2048, H=48, P=64, G=1, N=128, chunk=256)
SSD_CASES = [
    ("path", {}),
    ("ragged", dict(S=1000)),               # a last chunk of 232 steps
    ("one_chunk", dict(S=200)),             # S < chunk: L = S
    ("groups_8", dict(G=8)),                # 6 heads per group
    ("no_d", dict(D=False)),
    ("chunk_64", dict(chunk=64)),
    ("p128_n64", dict(H=24, P=128, N=64)),
]
# kernel against plain, held to each output's largest magnitude: fp32
# sums in another order (the scan's cumsum, the products' tiles); bf16 y
# rounds to 8 bits of mantissa, the fp32 state is held as in fp32
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def ssd_inputs(gen, dtype, B, S, H, P, G, N, chunk, D=True):
    """x, dt (softplus of a normal), A (< 0), Bm, Cm, D as the model
    makes them; x, Bm, Cm in ``dtype``, the rest fp32."""
    import torch
    x = torch.randn((B, S, H, P), generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda"))
    A = -torch.exp(0.5 * torch.randn((H,), generator=gen, device="cuda"))
    Bm = torch.randn((B, S, G, N), generator=gen, device="cuda").to(dtype)
    Cm = torch.randn((B, S, G, N), generator=gen, device="cuda").to(dtype)
    Dv = torch.randn((H,), generator=gen, device="cuda") if D else None
    return (x, dt, A, Bm, Cm, Dv), chunk


def rel_err(got, want):
    """max |got - want| over want's largest magnitude."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def phase_ssd(gen):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    errs = {}
    for name, over in SSD_CASES:
        for dt in ("float32", "bfloat16"):
            args, chunk = ssd_inputs(gen, getattr(torch, dt),
                                     **{**SSD, **over})
            y, st = ssd_scan(*args, chunk=chunk)
            y_want, st_want = ref.ssd(*args, chunk=chunk)
            torch.cuda.synchronize()
            ey, es = rel_err(y, y_want), rel_err(st, st_want)
            errs[(name, dt)] = (y.float() - y_want.float()).abs().max().item()
            log(f"  ssd_scan         {name:13s} {dt:9s} max|err| y "
                f"{errs[(name, dt)]:.3e} ({ey:.2e} of max), state "
                f"{(st - st_want).abs().max().item():.3e} ({es:.2e} of max) "
                f"(tol {SSD_TOL[dt]} of max)")
            check(y.dtype == args[0].dtype and st.dtype == torch.float32,
                  f"ssd_scan output dtypes: {name} {dt}")
            check(ey <= SSD_TOL[dt] and es <= SSD_TOL[dt],
                  f"kernel != plain: ssd {name} {dt}")
            del y, st, y_want, st_want, args
    return errs


# -- phases 7-10: mamba2 -----------------------------------------------------

# full-width fp32 through 48 layers: the kernel's summation-order
# differences (~1e-6 of each layer's largest output) carry through the
# residual stream, so the model is held 10x looser than the kernel alone
SSM_TOL = 1e-3


def phase_ssm_fp32(torch, cfg, gen):
    """Full-width fp32: a prefill, kernel against plain, and prefill
    against decode."""
    from repro_torch.kernels import ref
    from repro_torch.models import Model, ssd
    from repro_torch.serving import kv_cache
    f32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    model = Model(f32).init(gen)
    toks = prompts(torch, cfg, SEED + 1, 1, FP32_PROMPT)
    got, got_cache = model.prefill({"tokens": toks})
    with mock.patch.object(ssd.ops, "ssd", ref.ssd):
        want, want_cache = model.prefill({"tokens": toks})
    errs = {"logits": rel_err(got, want)}
    errs.update({n: rel_err(got_cache[n], want_cache[n]) for n in got_cache})
    log(f"  fp32 prefill of {FP32_PROMPT} tokens, kernel vs plain: max|err| "
        "of each tensor's largest magnitude "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (tol {SSM_TOL}); |logits| max {want.abs().max().item():.3f}")
    check(max(errs.values()) <= SSM_TOL, "full-width prefill: kernel != plain")
    check(bool(torch.equal(got.argmax(-1), want.argmax(-1))),
          "full-width prefill: greedy tokens differ")
    del want_cache, got_cache

    # the last token through decode_step over the prefill of the others
    _, head = model.prefill({"tokens": toks[:, :-1]})
    row = model.init_cache(1, FP32_PROMPT)
    kv_cache.write_slot(row, head, 0)
    dec, _ = model.decode_step(toks[:, -1], torch.full(
        (1,), FP32_PROMPT - 1, dtype=torch.int32, device="cuda"), row)
    err = rel_err(dec, got)
    log(f"  fp32 prefill({FP32_PROMPT - 1}) + decode_step vs prefill("
        f"{FP32_PROMPT}), last position: max|err| {err:.3e} of the largest "
        f"logit (tol {SSM_TOL})")
    check(err <= SSM_TOL, "prefill then decode != prefill")
    check(bool(torch.equal(dec.argmax(-1), got.argmax(-1))),
          "prefill then decode: greedy token differs")
    return err


def ssd_work(B, S, H, P, G, N, chunk, x_bytes):
    """Bytes the scan must move (each input read once, each output written
    once) and the flops its products need: C.B^T once per group over the
    causal pairs of each chunk, the weights applied to x, the C.h^T term
    and the state update per head, and the D skip."""
    L = min(chunk, S)
    sizes = [L] * (S // L) + ([S % L] if S % L else [])
    pairs = sum(n * (n + 1) // 2 for n in sizes)
    nbytes = (2 * B * S * H * P * x_bytes + 2 * B * S * G * N * x_bytes
              + B * S * H * 4 + 2 * H * 4 + B * H * P * N * 4)
    flops = (B * G * pairs * N * 2 + B * H * pairs * P * 2
             + 2 * B * H * S * N * P * 2 + B * H * S * P * 2)
    return nbytes, flops


def phase_ssd_times(torch, model, gen):
    """ssd_scan at the prefill path's shape (bf16), its plain version and
    the bound; then one full-width prefill and decode step."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    args, chunk = ssd_inputs(gen, torch.bfloat16, **SSD)
    before = ssd_scan.launches
    ms = event_ms(lambda i: ssd_scan(*args, chunk=chunk), 20)
    plain_ms = event_ms(lambda i: ref.ssd(*args, chunk=chunk), 5)
    ssd_scan.launches = before   # timing launches are not the path's
    nbytes, flops = ssd_work(**{k: SSD[k] for k in "BSHPGN"}, chunk=chunk,
                             x_bytes=2)
    bound_ms, by = bound(nbytes, flops)
    log(f"  ssd_scan bf16 B={SSD['B']} S={SSD['S']} H={SSD['H']} "
        f"P={SSD['P']} G={SSD['G']} N={SSD['N']} chunk={chunk}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, no single PyTorch call, "
        f"bound {bound_ms:.4f} ms by {by} ({nbytes} B, {flops} flop); "
        f"kernel at {flops / ms / 1e9:.1f} TFLOP/s")
    del args

    toks = prompts(torch, model.cfg, SEED, PB, PS)
    pre_ms = host_ms(lambda: model.prefill({"tokens": toks}), 3)
    busy = device_profile(lambda: model.prefill({"tokens": toks}),
                          "ssd_scan_kernel", iters=1)
    log(f"  mamba2 prefill bf16 full width, {PB} x {PS} tokens: "
        f"{pre_ms:.3f} ms on the host clock, "
        f"{PB * PS / pre_ms * 1e3:.0f} tokens/s")
    log(f"  mamba2 prefill profile: device busy {busy['busy_ms']:.3f} ms "
        f"({busy['busy_ms'] / pre_ms:.1%} of the call), {busy['launches']} "
        f"device kernels, ssd_scan {busy['attn_ms']:.3f} ms "
        f"({busy['attn_ms'] / busy['busy_ms']:.1%} of device time)")

    cache = model.init_cache(B, SMAX)
    tokens = torch.zeros(B, dtype=torch.long, device="cuda")
    lens = torch.full((B,), SMAX // 2, dtype=torch.int32, device="cuda")
    one = torch.zeros(B, dtype=torch.bool, device="cuda")
    one[0] = True
    step_ms = host_ms(lambda: model.decode_step(tokens, lens, cache,
                                                commit=one), 20)
    sbusy = device_profile(lambda: model.decode_step(tokens, lens, cache,
                                                     commit=one),
                           "ssd_scan_kernel")
    ssd_scan.launches = before
    log(f"  mamba2 decode_step bf16 full width, B={B}: {step_ms:.3f} ms on "
        f"the host clock; device busy {sbusy['busy_ms']:.3f} ms "
        f"({sbusy['busy_ms'] / step_ms:.1%} of the step), "
        f"{sbusy['launches']} device kernels")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=by)


# -- phase 2: the RG-LRU scan; phases 11-13: recurrentgemma -----------------

# the RG-LRU kernel's cases: recurrentgemma-9b's prefill shape (4 x 2048
# tokens, lru_width 4096) and its edges; every case in fp32 and in bf16
RGLRU = dict(B=4, S=2048, W=4096)
RGLRU_CASES = [
    ("path", {}),
    ("ragged_h0", dict(S=1000, W=4000, h0=True)),   # 4000 % 64 != 0
    ("one_step", dict(S=1, h0=True)),
    ("long_memory", dict(long=True)),               # a in (0.999, 1)
    ("odd_width", dict(S=77, W=13, h0=True)),       # one channel a thread
]
# kernel against plain, held to each output's largest magnitude: fp32
# composes the carry in another order than the plain doubling scan; bf16
# h rounds to 8 bits of mantissa, h_final stays fp32
RGLRU_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def rglru_inputs(gen, dtype, B, S, W, h0=False, long=False):
    """a and b as the model makes them: a = exp(-8 softplus(lam) r) with
    r a sigmoid, so a spans (0, 1) and reaches ~1e-14; b normal; h0
    normal or None."""
    import torch
    F = torch.nn.functional
    if long:
        a = 0.999 + 0.001 * torch.rand((B, S, W), generator=gen,
                                       device="cuda")
    else:
        lam = torch.randn((W,), generator=gen, device="cuda")
        r = torch.sigmoid(torch.randn((B, S, W), generator=gen,
                                      device="cuda"))
        a = torch.exp(-8.0 * F.softplus(lam) * r)
    b = torch.randn((B, S, W), generator=gen, device="cuda")
    h = torch.randn((B, W), generator=gen, device="cuda") if h0 else None
    return a.to(dtype), b.to(dtype), h


def phase_rglru(gen):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru_scan import rglru_scan
    errs = {}
    for name, over in RGLRU_CASES:
        for dt in ("float32", "bfloat16"):
            a, b, h0 = rglru_inputs(gen, getattr(torch, dt),
                                    **{**RGLRU, **over})
            h, hf = rglru_scan(a, b, h0)
            h_want, hf_want = ref.rglru(a, b, h0)
            torch.cuda.synchronize()
            eh, ef = rel_err(h, h_want), rel_err(hf, hf_want)
            errs[(name, dt)] = (h.float() - h_want.float()).abs().max().item()
            log(f"  rglru_scan       {name:13s} {dt:9s} max|err| h "
                f"{errs[(name, dt)]:.3e} ({eh:.2e} of max), h_final "
                f"{(hf - hf_want).abs().max().item():.3e} ({ef:.2e} of max) "
                f"(tol {RGLRU_TOL[dt]} of max)")
            check(h.dtype == a.dtype and hf.dtype == torch.float32,
                  f"rglru_scan output dtypes: {name} {dt}")
            check(bool(torch.isfinite(h).all()), f"rglru_scan: non-finite h "
                  f"{name} {dt}")
            check(eh <= RGLRU_TOL[dt] and ef <= RGLRU_TOL[dt],
                  f"kernel != plain: rglru {name} {dt}")
            del a, b, h0, h, hf, h_want, hf_want
    return errs


# full-width fp32 through 38 layers: the kernels' summation-order
# differences carry through the residual stream, as for mamba2
RG_TOL = 1e-3


def phase_rg_fp32(torch, cfg, gen):
    """Full-width fp32: a prefill, kernels against plain, and prefill
    against decode (256 tokens: within the 2,048-token window, where a
    placed prefill cache is in ring order)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import Model
    from repro_torch.models.model import place_row
    f32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    model = Model(f32).init(gen)
    toks = prompts(torch, cfg, SEED + 1, 1, FP32_PROMPT)
    got, got_cache = model.prefill({"tokens": toks})
    with mock.patch.object(ops, "rglru", ref.rglru), \
            mock.patch.object(ops, "mha", ref.mha):
        want, want_cache = model.prefill({"tokens": toks})
    errs = {"logits": rel_err(got, want)}
    errs.update({n: rel_err(got_cache[n], want_cache[n]) for n in got_cache})
    worst = max(errs, key=errs.get)
    log(f"  fp32 prefill of {FP32_PROMPT} tokens, kernels vs plain: max|err| "
        f"of each tensor's largest magnitude: logits {errs['logits']:.3e}, "
        f"worst of {len(errs)} tensors {worst} {errs[worst]:.3e} (tol "
        f"{RG_TOL}); |logits| max {want.abs().max().item():.3f}")
    check(max(errs.values()) <= RG_TOL, "full-width prefill: kernel != plain")
    check(bool(torch.equal(got.argmax(-1), want.argmax(-1))),
          "full-width prefill: greedy tokens differ")
    del want_cache, got_cache

    _, head = model.prefill({"tokens": toks[:, :-1]})
    row = model.init_cache(1, FP32_PROMPT)
    place_row(row, head, 0, 0)
    dec, _ = model.decode_step(toks[:, -1], torch.full(
        (1,), FP32_PROMPT - 1, dtype=torch.int32, device="cuda"), row)
    err = rel_err(dec, got)
    log(f"  fp32 prefill({FP32_PROMPT - 1}) + decode_step vs prefill("
        f"{FP32_PROMPT}), last position: max|err| {err:.3e} of the largest "
        f"logit (tol {RG_TOL})")
    check(err <= RG_TOL, "prefill then decode != prefill")
    check(bool(torch.equal(dec.argmax(-1), got.argmax(-1))),
          "prefill then decode: greedy token differs")
    return err


def phase_rg_times(torch, model, gen):
    """rglru_scan and flash_attention at recurrentgemma's prefill shapes
    and decode_attention on its rings (bf16), their plain versions, SDPA
    and the bounds; then one full-width prefill and decode step.  Returns
    each kernel's times at this path's shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    a, b, _ = rglru_inputs(gen, torch.bfloat16, **RGLRU)
    before = counts()
    ms = event_ms(lambda i: rglru_scan(a, b), 50)
    plain_ms = event_ms(lambda i: ref.rglru(a, b), 5)
    Bq, S, W = a.shape
    nbytes = 3 * a.numel() * a.element_size() + Bq * W * 4
    bound_ms, by = bound(nbytes, 2 * a.numel())
    log(f"  rglru_scan bf16 B={Bq} S={S} W={W}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, no single PyTorch call, bound {bound_ms:.4f} ms"
        f" by {by} ({nbytes} B); kernel at {nbytes / ms / 1e9:.3f} TB/s")
    rg = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
              bound_by=by)
    del a, b

    shape = {**FLASH, **dict(H=16, K=1, D=256)}
    (q, k, v), _ = flash_inputs(gen, torch.bfloat16, **shape)
    fms = event_ms(lambda i: flash_attention(q, k, v), 10)
    fplain = event_ms(lambda i: ref.mha(q, k, v), 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flib = event_ms(lambda i: sdpa(qt, kt, vt, is_causal=True,
                                   enable_gqa=True), 20)
    pairs = shape["B"] * shape["H"] * mha_pairs(shape["S"], shape["T"])
    flops = pairs * 2 * (2 * shape["D"])
    fbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    fbound, fby = bound(fbytes, flops)
    log(f"  flash_attention bf16 causal B={shape['B']} S=T={shape['S']} "
        f"H=16 K=1 D=256: kernel {fms:.4f} ms, plain {fplain:.4f} ms, sdpa "
        f"{flib:.4f} ms, bound {fbound:.4f} ms by {fby} ({flops} flop, "
        f"{fbytes} B); kernel at {flops / fms / 1e9:.1f} TFLOP/s")
    fa = dict(ms=fms, plain_ms=fplain, library_ms=flib, bound_ms=fbound,
              bound_by=fby)
    del q, k, v, qt, kt, vt
    # decode attention on the decode step's full 2,048-entry rings, cold
    # in L2 over the 12 local-attention layers' caches
    n_attn = sum(kind == "wattn" for kind in model.kinds)
    da = decode_attention_times(torch, gen, 16, 1, 256, model.cfg.attn_window,
                                n_attn, full=True)

    toks = prompts(torch, model.cfg, SEED, PB, PS)
    pre_ms = host_ms(lambda: model.prefill({"tokens": toks}), 3)
    names = ("rglru_scan_kernel", "flash_attention_kernel")
    busy = device_profile(lambda: model.prefill({"tokens": toks}),
                          names[0], iters=1, others=names)
    log(f"  recurrentgemma prefill bf16 full width, {PB} x {PS} tokens: "
        f"{pre_ms:.3f} ms on the host clock, "
        f"{PB * PS / pre_ms * 1e3:.0f} tokens/s")
    log(f"  recurrentgemma prefill profile: device busy "
        f"{busy['busy_ms']:.3f} ms ({busy['busy_ms'] / pre_ms:.1%} of the "
        f"call), {busy['launches']} device kernels, "
        + ", ".join(f"{n} {t:.3f} ms ({t / busy['busy_ms']:.1%})"
                    for n, t in busy["kernel_ms"].items()))

    cache = model.init_cache(ROW_SLOTS, ROW_SMAX)
    tokens = torch.zeros(ROW_SLOTS, dtype=torch.long, device="cuda")
    lens = torch.full((ROW_SLOTS,), PS, dtype=torch.int32, device="cuda")
    step_ms = host_ms(lambda: model.decode_step(tokens, lens, cache), 10)
    sbusy = device_profile(lambda: model.decode_step(tokens, lens, cache),
                           "decode_attention_kernel")
    log(f"  recurrentgemma decode_step bf16 full width, {ROW_SLOTS} slots "
        f"on 2,048-entry rings: {step_ms:.3f} ms on the host clock "
        f"({ROW_SLOTS / step_ms * 1e3:.1f} tok/s); device busy "
        f"{sbusy['busy_ms']:.3f} ms ({sbusy['busy_ms'] / step_ms:.1%} of "
        f"the step), {sbusy['launches']} device kernels, decode_attention "
        f"{sbusy['attn_ms']:.3f} ms "
        f"({sbusy['attn_ms'] / sbusy['busy_ms']:.1%} of device time)")
    for name, w in wrappers().items():    # timing launches are not the path's
        w.launches = before[name]
    return {"rglru_scan": rg, "flash_attention": fa, "decode_attention": da}


def host_ms(fn, iters):
    """Host-clock time of ``fn()`` per call, ending in a synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def device_profile(fn, kernel, iters=2, others=()):
    """Device time, the named kernel's device time (``attn_ms``; each of
    ``others`` in ``kernel_ms``) and launches per call of ``fn()``, from
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # device-side events only: an operator's row repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in kernels)
    check(busy > 0, "the profiler saw no device time")
    def named_ms(name):
        return sum(dev_us(e) for e in kernels if name in e.key) / iters / 1e3
    return dict(
        busy_ms=busy / iters / 1e3, attn_ms=named_ms(kernel),
        kernel_ms={name: named_ms(name) for name in others},
        launches=sum(e.count for e in kernels) // iters)


def ptxas_report(text):
    """(instance, line) for each register, shared-memory and spill line of
    ``nvcc -Xptxas -v``'s report; the instance is the kernel's dtype and
    its integer template argument, if any (the flash kernel's query tile,
    the RG-LRU scan's channels per thread)."""
    import re
    inst = "?"
    for line in text.splitlines():
        if "Compiling entry function" in line:
            inst = "bf16" if "nv_bfloat16" in line else "fp32"
            arg = re.search(r"Li(\d+)E", line)
            if arg:
                inst += f", {arg.group(1)}"
        elif "registers" in line or "spill" in line:
            yield inst, line.split(" : ")[-1].strip()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU host",
              file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    log("phase 1: build, one nvcc per source at once")
    t0 = time.perf_counter()
    build.load_all(KERNELS)
    for name in KERNELS:
        if name not in build.build_logs:   # a library this checkout built
            log(f"  {name}: built before, no nvcc report")
        for inst, line in ptxas_report(build.build_logs.get(name, "")):
            log(f"  {name} ({inst}): {line}")
    from repro_torch.kernels import decode_attention, flash_attention, ssd_scan
    da = decode_attention._lib().repro_decode_attention_smem_bytes
    fa = flash_attention._lib().repro_flash_attention_smem_bytes
    sa = ssd_scan._lib().repro_ssd_scan_smem_bytes
    log(f"  dynamic shared memory per block: decode_attention "
        f"{da(H // K, D, D)} B (g={H // K}, D={D}), {da(16, 256, 256)} B "
        f"(g=16, D=256); flash_attention {fa(D, D)} B (D={D}), "
        f"{fa(128, 128)} B (D=128), {fa(192, 128)} B (D=192, Dv=128), "
        f"{fa(256, 256)} B (D=256, the 32-query tile); ssd_scan "
        f"{sa(256, 64, 128)} B (L=256, P=64, N=128), {sa(256, 128, 64)} B "
        f"(P=128, N=64); rglru_scan none")
    log(f"  built in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    log("phase 2: kernels against their plain versions")
    errs = phase_kernels(gen)
    flash_errs = phase_flash(gen)
    ssd_errs = phase_ssd(gen)
    rglru_errs = phase_rglru(gen)
    torch.cuda.empty_cache()

    cfg = configs.get_config("granite-3-2b")
    log("phase 3: full-width granite-3-2b serving with a row failure")
    model, launches, calls, _ = phase_serve(torch, cfg, gen,
                                            per_layer=("decode_attention",))
    phase_small_against_cpu(torch, configs.get_smoke("granite-3-2b"))

    log("phase 4: full-width granite-3-2b prefill, then decode from it")
    L = cfg.n_layers
    pre, _ = phase_prefill(torch, model, {"flash_attention": L},
                           {"decode_attention": L})
    flash_launches = pre["flash_attention"]
    torch.cuda.empty_cache()

    log("phase 5: full-width fp32 decode step and prefill, kernel against "
        "plain")
    phase_fp32(torch, cfg, gen)
    torch.cuda.empty_cache()

    log("phase 6: times")
    times = {"decode_attention": phase_times(torch, model, gen),
             "flash_attention": phase_flash_times(torch, model, gen)}
    del model
    torch.cuda.empty_cache()

    mcfg = configs.get_config("mamba2-780m")
    log("phase 7: full-width mamba2-780m serving with a row failure")
    mmodel, _, _, _ = phase_serve(torch, mcfg, gen)
    phase_small_against_cpu(torch, configs.get_smoke("mamba2-780m"))

    log("phase 8: full-width mamba2-780m prefill, then decode from it")
    ssd_launches = phase_prefill(torch, mmodel, {"ssd_scan": mcfg.n_layers},
                                 {})[0]["ssd_scan"]
    torch.cuda.empty_cache()

    log("phase 9: full-width fp32 mamba2 prefill, kernel against plain")
    phase_ssm_fp32(torch, mcfg, gen)
    torch.cuda.empty_cache()

    log("phase 10: mamba2 times")
    times["ssd_scan"] = phase_ssd_times(torch, mmodel, gen)
    del mmodel
    torch.cuda.empty_cache()

    rcfg = configs.get_config("recurrentgemma-9b")
    log("phase 11: full-width recurrentgemma-9b prefill, then decode from "
        "it")
    t0 = time.perf_counter()
    rmodel = Model(rcfg).init(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in rmodel.parameters())
    log(f"  init: {n_params} parameters ({rcfg.param_count()} by "
        f"ModelConfig.param_count, which leaves out the gates' block-"
        f"diagonal weights and the norms), "
        f"{n_params * rcfg.param_dtype.itemsize / 1e9:.3f} GB of "
        f"{rcfg.param_dtype} in {time.perf_counter() - t0:.1f} s")
    n_rglru = sum(k == "rglru" for k in rmodel.kinds)
    n_attn = rcfg.n_layers - n_rglru
    rg_launches, rg_dec = phase_prefill(
        torch, rmodel, {"rglru_scan": n_rglru, "flash_attention": n_attn},
        {"decode_attention": n_attn})
    torch.cuda.empty_cache()

    log("phase 12: full-width fp32 recurrentgemma prefill, kernels against "
        "plain")
    phase_rg_fp32(torch, rcfg, gen)
    torch.cuda.empty_cache()

    log("phase 13: recurrentgemma times")
    rg_times = phase_rg_times(torch, rmodel, gen)
    del rmodel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    # one entry per (kernel, path): the launches of that path's drive, the
    # error at that path's shape in phase 2 and the times at that shape
    rg = "recurrentgemma-9b"
    entries = [
        ("decode_attention", "granite-3-2b", launches["decode_attention"],
         errs[("path", "bfloat16")], times["decode_attention"]),
        ("flash_attention", "granite-3-2b", flash_launches,
         flash_errs[("path", "bfloat16")], times["flash_attention"]),
        ("ssd_scan", "mamba2-780m", ssd_launches,
         ssd_errs[("path", "bfloat16")], times["ssd_scan"]),
        ("rglru_scan", rg, rg_launches["rglru_scan"],
         rglru_errs[("path", "bfloat16")], rg_times["rglru_scan"]),
        ("flash_attention", rg, rg_launches["flash_attention"],
         flash_errs[("rg_path", "bfloat16")], rg_times["flash_attention"]),
        ("decode_attention", rg, rg_dec["decode_attention"],
         errs[("rg_ring", "bfloat16")], rg_times["decode_attention"])]
    log(json.dumps({"kernels": [dict(
        name=name, path=on, route="cuda", source=KERNELS[name][0],
        replaces=KERNELS[name][1], launches=n, max_abs_err=err, **t)
        for name, on, n, err, t in entries]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
