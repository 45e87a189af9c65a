"""Builds the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<digest>.so``,
then loaded with ``ctypes``.  The digest covers the source and the flags,
so an edited source is rebuilt and a stale library is never loaded.
``_build/`` is ignored by git: a fresh checkout builds from its sources.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
#: nvcc's report (registers, shared memory, spills) of each build
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built first if it has no current one."""
    lib = _loaded.get(name)
    if lib is None:
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                capture_output=True, text=True)
            build_logs[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n"
                                   f"{build_logs[name]}")
            os.replace(tmp, out)      # atomic: a reader never sees half a file
        lib = _loaded[name] = ctypes.CDLL(str(out))
    return lib


def load_all(names: Iterable[str]) -> None:
    """``load`` each named library, with one ``nvcc`` per source running
    at the same time (each waits in its own thread); raises as ``load``
    does if any build fails."""
    names = list(names)
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(load, names))
