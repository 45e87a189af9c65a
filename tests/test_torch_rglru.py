"""The port's plain RG-LRU recurrence (``ref.rglru``) and decode step
against the JAX reference and a naive loop, and the kernel wrapper's
dispatch and input checks on the CPU.

Shapes are test_kernels.py::test_rglru_scan's, plus ragged S and a 2,048-
step sequence; fp32 within 2e-5 as there, bf16 within 2e-2.  The Pallas
``rglru_scan`` is not run: its interpret mode fails on current jax
(test_kernels.py marks it xfail).  Inputs are drawn with numpy from a
seed and handed to both packages.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rglru_scan import rglru_scan as wrapper

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, B, S, W, with_h0=True):
    """a = 0.95 sigmoid(normal) in (0, 0.95), b and h0 normal, as
    test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    a = (0.95 / (1 + np.exp(-rng.normal(0, 1, (B, S, W))))).astype(
        np.float32)
    b = rng.normal(0, 1, (B, S, W)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, W)).astype(np.float32) if with_h0 else None
    return a, b, h0


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


def _j(x, dtype=jnp.float32):
    return None if x is None else jnp.asarray(x).astype(dtype)


def _loop(a, b, h0=None):
    """The recurrence one step at a time, in fp32."""
    h = np.zeros(a.shape[::2], np.float32) if h0 is None else h0.copy()
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return np.stack(out, 1), h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W", [(1, 16, 8), (2, 32, 24), (1, 8, 16)])
def test_plain_matches_jax_ref(B, S, W, with_h0, dtype):
    a, b, h0 = _inputs(0, B, S, W, with_h0)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    h, hf = ref.rglru(_t(a, tdt), _t(b, tdt), _t(h0))
    assert h.shape == (B, S, W) and h.dtype == tdt
    assert hf.shape == (B, W) and hf.dtype == torch.float32
    hw, fw = jref.rglru(_j(a, jdt), _j(b, jdt), _j(h0))
    tol = TOL[dtype]
    np.testing.assert_allclose(h.float().numpy(), np.asarray(hw, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(hf.numpy(), np.asarray(fw), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("S", [1, 2, 7, 37, 100])
def test_plain_matches_a_naive_loop_at_ragged_lengths(S):
    a, b, h0 = _inputs(S, 2, S, 5)
    want, want_f = _loop(a, b, h0)
    h, hf = ref.rglru(_t(a), _t(b), _t(h0))
    np.testing.assert_allclose(h.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(hf.numpy(), want_f, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("lo,hi", [(0.999, 1.0), (1e-30, 1e-2)])
def test_a_long_sequence_neither_underflows_nor_overflows(lo, hi):
    """2,048 steps with a near 1 (long memory: h sums ~1,000 inputs) and
    with a near 0, where a running product of the a's underflows to 0
    after a few steps: the doubling scan divides nothing out, so both
    stay finite and follow the loop."""
    rng = np.random.default_rng(11)
    a = rng.uniform(lo, hi, (2, 2048, 8)).astype(np.float32)
    b = rng.normal(0, 1, (2, 2048, 8)).astype(np.float32)
    want, want_f = _loop(a, b)
    h, hf = ref.rglru(_t(a), _t(b))
    assert bool(torch.isfinite(h).all())
    scale = np.abs(want).max()
    np.testing.assert_allclose(h.numpy(), want, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(hf.numpy(), want_f, rtol=0,
                               atol=2e-5 * scale)
    hw, _ = jref.rglru(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(h.numpy(), np.asarray(hw), rtol=0,
                               atol=2e-5 * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(dtype):
    a, b, h = _inputs(3, 3, 1, 16)
    a, b = a[:, 0], b[:, 0]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got, got_f = ops.rglru_decode(_t(a, tdt), _t(b, tdt), _t(h, tdt))
    want, want_f = jref.rglru_decode(_j(a, jdt), _j(b, jdt), _j(h, jdt))
    assert got.dtype == tdt and got_f.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype],
                               rtol=TOL[dtype])
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-6)


def test_scan_equals_step_by_step_decode():
    a, b, h0 = (_t(x) for x in _inputs(5, 2, 12, 6))
    h_scan, f_scan = ref.rglru(a, b, h0)
    h = h0
    for t in range(12):
        out, h = ref.rglru_decode(a[:, t], b[:, t], h)
        torch.testing.assert_close(out, h_scan[:, t], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, f_scan, atol=1e-5, rtol=1e-5)


def test_wrapper_runs_the_plain_version_for_cpu_tensors():
    a, b, h0 = (_t(x) for x in _inputs(6, 2, 21, 12))
    before = wrapper.launches
    for args in ((a, b), (a, b, h0), (a.bfloat16(), b.bfloat16(), h0)):
        got, want = ops.rglru(*args), ref.rglru(*args)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert wrapper.launches == before        # no kernel ran


def test_wrapper_refuses_a_device_without_a_kernel():
    a = torch.empty((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.rglru(a, a)


def test_wrapper_refuses_inputs_that_require_grad():
    a, b, _ = (_t(x) for x in _inputs(7, 1, 8, 4, with_h0=False))
    b.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rglru(a, b)
    with torch.no_grad():                    # no graph, no gradient owed
        torch.testing.assert_close(ops.rglru(a, b)[0], ref.rglru(a, b)[0])


def test_kernel_input_checks():
    """What the wrapper refuses before it launches the kernel: the checks
    read only shapes, dtypes and contiguity, so they run on CPU tensors.
    Any S and W pass, unlike the TPU kernel's block multiples."""
    check = importlib.import_module("repro_torch.kernels.rglru_scan")._check
    a, b, h0 = (_t(x) for x in _inputs(8, 2, 13, 7))
    check(a, b, h0)
    check(a, b, None)
    check(a.bfloat16(), b.bfloat16(), h0)
    check(a.bfloat16(), b.bfloat16(), h0.bfloat16())
    refused = [
        (ValueError, (a[0], b[0], None)),                     # not 3-d
        (ValueError, (a, b[:, :5], h0)),                      # S differs
        (ValueError, (a, b, h0[:, :3])),                      # h0 (B, W)
        (ValueError, (a[:, :0], b[:, :0], h0)),               # S == 0
        (TypeError, (a, b.bfloat16(), h0)),                   # mixed
        (TypeError, (a.half(), b.half(), h0)),                # fp16
        (TypeError, (a, b, h0.double())),                     # h0 fp64
        (ValueError, (a.transpose(1, 2).contiguous().transpose(1, 2), b,
                      h0)),                                   # strided a
        (ValueError, (a, b, h0.t().contiguous().t())),        # strided h0
    ]
    for exc, args in refused:
        with pytest.raises(exc):
            check(*args)
