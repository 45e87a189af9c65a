#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py        # from the root of a checkout, on a GPU host

Phases (any failure exits non-zero and prints no result):

  1. build    — compile the path's kernel from ``src/repro_torch``'s CUDA
                source with ``nvcc``;
  2. kernels  — hold each kernel against its plain PyTorch version on the
                card, at the path's shapes and at edge cases;
  3. serve    — full-width granite-3-2b (random weights from a seed, bf16):
                ``ServingEngine`` serves 8 sessions x 2 turns on 2 rows while
                one row dies between the turns, so sessions recover from
                their KV checkpoints; every attention step must go through
                the kernel, and the outputs must equal a healthy run's.  A
                small fp32 drive must give the CPU's plain path's tokens;
  4. step     — one full-width fp32 ``decode_step``, kernel against plain
                (its fp32 weights are freed before the times);
  5. times    — each kernel, its plain version and one PyTorch library call
                on the same inputs, beside the card's least time for the
                work; ``decode_step`` time.

The lines before the last carry the card's name and power limit
(``nvidia-smi``) and one JSON object ``{"kernels": [...]}``; the last line
is ``{"ok": true, "device": {...}}``.
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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
BF16_FLOPS = 989e12            # dense tensor-core bf16, the same source
SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:68"     # the TPU kernel


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
             ("mqa", dict(h=H, k=1, d=D, smax=SMAX))]
    errs = {}
    for name, c in cases:
        c = dict(c)
        kw = dict(window=c.pop("window", 0), softcap=c.pop("softcap", 0.0))
        for dt in ("float32", "bfloat16"):
            q, kc, vc, lengths = attention_inputs(
                gen, B, dtype=getattr(torch, dt), **c)
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


def phase_serve(torch, cfg, gen):
    from repro_torch.kernels.decode_attention import decode_attention
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
    # the drive the launch count is read from: counts set to 0 just before
    decode_attention.launches = 0
    counted.calls = 0
    t0 = time.perf_counter()
    eng, got = serve(model, prompts, fail=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, calls = decode_attention.launches, counted.calls
    s = eng.summary()
    log(f"  calibrated svc {eng._svc}")
    log(f"  chaos drive: {calls} decode steps, {launches} decode_attention "
        f"launches ({launches / calls:g} per step), {wall:.2f} s wall "
        f"({calls / wall:.1f} steps/s); summary {s}")
    check(all(len(o) == GEN for outs in got.values() for o in outs),
          "a turn returned no tokens")
    check(int(counted.bad) == 0, "non-finite logits")
    check(launches == cfg.n_layers * calls,
          f"{launches} launches != {cfg.n_layers} x {calls} decode steps")
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

def phase_step(torch, cfg, gen):
    from repro_torch.kernels import ref
    from repro_torch.models import Model, layers
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
    return err


# -- phase 5 ------------------------------------------------------------------

def phase_times(torch, model, gen):
    """decode_attention at the path's shapes, cold in L2 as on the path:
    the calls walk the 40 layers' caches (~336 MB per tensor at bf16)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    L = model.cfg.n_layers
    q, kc, vc, lengths = attention_inputs(gen, B, H, K, D, SMAX,
                                          torch.bfloat16, layers=L)
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
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS \
        else "operations"
    log(f"  decode_attention bf16 B={B} H={H} K={K} D={D} Smax={SMAX} "
        f"(sum len {int(lengths.clamp(max=SMAX).sum())}): kernel {ms:.4f} ms"
        f", plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {by} ({nbytes} B)")

    cache = model.init_cache(B, SMAX)
    tokens = torch.zeros(B, dtype=torch.long, device="cuda")
    lens = torch.full((B,), SMAX // 2, dtype=torch.int32, device="cuda")
    one = torch.zeros(B, dtype=torch.bool, device="cuda")
    one[0] = True
    step_ms = host_ms(lambda: model.decode_step(tokens, lens, cache,
                                                commit=one), 20)
    busy = device_profile(lambda: model.decode_step(tokens, lens, cache,
                                                    commit=one))
    decode_attention.launches = before
    log(f"  decode_step bf16 full width, B={B}, len {SMAX // 2}: "
        f"{step_ms:.3f} ms on the host clock; {B / step_ms * 1e3:.1f} tok/s "
        f"with all {B} slots decoding, {1e3 / step_ms:.1f} tok/s for one")
    log(f"  decode_step profile: device busy {busy['busy_ms']:.3f} ms "
        f"({busy['busy_ms'] / step_ms:.1%} of the step), "
        f"{busy['launches']} device kernels, decode_attention "
        f"{busy['attn_ms']:.3f} ms ({busy['attn_ms'] / busy['busy_ms']:.1%}"
        f" of device time)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by), step_ms


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


def device_profile(fn, iters=2):
    """Device time and launches per call of ``fn()``, from torch.profiler."""
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
    return dict(
        busy_ms=busy / iters / 1e3,
        attn_ms=sum(dev_us(e) for e in kernels
                    if "decode_attention_kernel" in e.key) / iters / 1e3,
        launches=sum(e.count for e in kernels) // iters)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU host",
              file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    t0 = time.perf_counter()
    build.load("decode_attention")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log(f"  built in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    log("phase 2: kernels against their plain versions")
    errs = phase_kernels(gen)

    cfg = configs.get_config("granite-3-2b")
    log("phase 3: full-width granite-3-2b serving with a row failure")
    model, launches, calls, _ = phase_serve(torch, cfg, gen)
    phase_small_against_cpu(torch, configs.get_smoke("granite-3-2b"))

    log("phase 4: one full-width fp32 decode step, kernel against plain")
    phase_step(torch, cfg, gen)
    torch.cuda.empty_cache()

    log("phase 5: times")
    times, _ = phase_times(torch, model, gen)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": [dict(
        name="decode_attention", route="cuda", source=SOURCE,
        replaces=REPLACES,
        launches=launches, max_abs_err=errs[("path", "bfloat16")],
        **times)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
