"""Compare the port's SSD-scan kernel with the same source built without
the minimum of two blocks per SM in its launch bound, on one NVIDIA GPU.

    python3 scripts/torch_ssd_probe.py      # from the root of a checkout

Both builds run at mamba2-780m's prefill shape (B=4, S=2048, H=48, P=64,
G=1, N=128, chunk 256) in fp32 and bf16: each is held against the plain
``ref.ssd`` (error over the output's largest magnitude) and timed with
CUDA events in turns (as built, one block, one block, as built), beside
nvcc's register and spill report and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BOUND = "__launch_bounds__(kThreads, 2)"
SHAPE = dict(B=4, S=2048, H=48, P=64, G=1, N=128)


def one_block_lib(build) -> ctypes.CDLL:
    """The scan kernel built with ``__launch_bounds__(kThreads)``."""
    src = (build.CSRC / "ssd_scan.cu").read_text()
    if BOUND not in src:
        raise RuntimeError(f"{BOUND} not found in ssd_scan.cu")
    build.BUILD_DIR.mkdir(exist_ok=True)
    cu = build.BUILD_DIR / "ssd_scan_one_block.cu"
    cu.write_text(src.replace(BOUND, "__launch_bounds__(kThreads)"))
    so = build.BUILD_DIR / "libssd_scan_one_block.so"
    proc = subprocess.run([build.nvcc(), *build.FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    report(proc.stdout + proc.stderr, "one block")
    if proc.returncode:
        raise RuntimeError("nvcc failed")
    return ctypes.CDLL(str(so))


def report(text, what):
    for line in text.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {what}: {line.split(' : ')[-1].strip()}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_ssd_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ssd_scan as scan
    torch.backends.cuda.matmul.allow_tf32 = False
    built = scan._lib()
    report(build.build_logs.get(scan.NAME, ""), "as built")
    libs = {"as built": built, "one block": one_block_lib(build)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, P, G, N = (SHAPE[k] for k in "BSHPGN")

    def use(lib):
        scan._lib = lambda: _typed(lib, built)

    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((B, S, H, P), generator=gen, device="cuda").to(dtype)
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, H), generator=gen, device="cuda"))
        A = -torch.exp(0.5 * torch.randn((H,), generator=gen, device="cuda"))
        Bm = torch.randn((B, S, G, N), generator=gen, device="cuda").to(dtype)
        Cm = torch.randn((B, S, G, N), generator=gen, device="cuda").to(dtype)
        D = torch.randn((H,), generator=gen, device="cuda")
        args = (x, dt, A, Bm, Cm, D)
        y_want, st_want = ref.ssd(*args)
        for name, lib in libs.items():
            use(lib)
            y, st = scan.ssd_scan(*args)
            torch.cuda.synchronize()
            ey = ((y.float() - y_want.float()).abs().max()
                  / y_want.float().abs().max()).item()
            es = ((st - st_want).abs().max() / st_want.abs().max()).item()
            print(f"{dtype} {name}: err y {ey:.3e}, state {es:.3e} of max")
        times = []
        for name in ("as built", "one block", "one block", "as built"):
            use(libs[name])
            for _ in range(3):
                scan.ssd_scan(*args)
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(20):
                scan.ssd_scan(*args)
            t1.record()
            torch.cuda.synchronize()
            times.append(f"{name} {t0.elapsed_time(t1) / 20:.4f} ms")
        print(f"{dtype}: " + ", ".join(times))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


def _typed(lib, built):
    """``lib`` with the argument types the wrapper gave ``built``."""
    if not getattr(lib, "_typed", False):
        for fn in ("repro_ssd_scan", "repro_ssd_scan_smem_bytes",
                   "repro_cuda_error_string"):
            getattr(lib, fn).argtypes = getattr(built, fn).argtypes
            getattr(lib, fn).restype = getattr(built, fn).restype
        lib._typed = True
    return lib


if __name__ == "__main__":
    sys.exit(main())
