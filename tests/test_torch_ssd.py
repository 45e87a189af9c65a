"""The port's plain SSD scan (``ref.ssd``) and decode step against the JAX
reference and the Pallas ``ssd_scan`` kernel (run in interpret mode, as
tests/test_kernels.py runs it), and the kernel wrapper's dispatch and
input checks on the CPU.

Shapes are test_kernels.py::test_ssd_scan's, plus ragged S; fp32 within
5e-5 as there, bf16 within 2e-2.  Inputs are drawn with numpy from a seed
and handed to both packages.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan as wrapper

torch.set_num_threads(1)

ATOL = 5e-5


def _inputs(seed, B, S, H, P, G, N, dtype=np.float32):
    """x, dt (> 0), A (< 0), Bm, Cm, D as test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, H, P))
    dt = np.abs(rng.normal(0, 1, (B, S, H))) * 0.5 + 0.01
    A = -np.abs(rng.normal(0, 1, (H,)))
    Bm = rng.normal(0, 1, (B, S, G, N))
    Cm = rng.normal(0, 1, (B, S, G, N))
    D = rng.normal(0, 1, (H,))
    arrs = [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, D)]
    return arrs


def _jax(arrs, dtype=jnp.float32):
    x, dt, A, Bm, Cm, D = (jnp.asarray(a) for a in arrs)
    return x.astype(dtype), dt, A, Bm.astype(dtype), Cm.astype(dtype), D


def _torch(arrs, dtype=torch.float32):
    x, dt, A, Bm, Cm, D = (torch.from_numpy(a) for a in arrs)
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), D


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


SHAPES = [
    (1, 16, 2, 4, 1, 8, 4),
    (2, 32, 4, 8, 2, 16, 8),
    (1, 24, 2, 8, 2, 8, 24),   # single chunk
    (2, 21, 4, 8, 2, 16, 8),   # ragged: 21 = 2 x 8 + 5
    (1, 5, 2, 4, 1, 8, 8),     # S < chunk: one chunk of 5
]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SHAPES)
def test_plain_matches_jax_ref_and_pallas(B, S, H, P, G, N, chunk):
    arrs = _inputs(0, B, S, H, P, G, N)
    y, st = ref.ssd(*_torch(arrs), chunk=chunk)
    assert y.shape == (B, S, H, P) and y.dtype == torch.float32
    assert st.shape == (B, H, P, N) and st.dtype == torch.float32
    yw, sw = jref.ssd(*_jax(arrs), chunk=chunk)
    _close(y, yw)
    _close(st, sw)
    yk, sk = pallas_ssd(*_jax(arrs), chunk=chunk, interpret=True)
    _close(y, yk)
    _close(st, sk)


def test_plain_matches_jax_ref_in_bf16():
    """x, B and C in bf16, accumulated in fp32; y comes out in bf16."""
    arrs = _inputs(1, 2, 32, 4, 8, 2, 16)
    y, st = ref.ssd(*_torch(arrs, torch.bfloat16), chunk=8)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    yw, sw = jref.ssd(*_jax(arrs, jnp.bfloat16), chunk=8)
    _close(y, yw, atol=2e-2)
    _close(st, sw, atol=2e-2)


def test_without_d_matches_jax_ref():
    arrs = _inputs(2, 2, 21, 4, 8, 2, 16)
    t, j = _torch(arrs)[:5], _jax(arrs)[:5]
    y, st = ref.ssd(*t, None, chunk=8)
    yw, sw = jref.ssd(*j, None, chunk=8)
    _close(y, yw)
    _close(st, sw)


def test_init_state_goes_through_the_plain_version():
    """The kernels start from zero; ``ref.ssd`` (and the wrapper on the
    CPU) carries an initial state, as JAX's ``ref.ssd`` does."""
    arrs = _inputs(3, 2, 16, 4, 8, 2, 16)
    h0 = np.random.default_rng(4).normal(0, 1, (2, 4, 8, 16)).astype(
        np.float32)
    yw, sw = jref.ssd(*_jax(arrs), chunk=4, init_state=jnp.asarray(h0))
    y, st = ref.ssd(*_torch(arrs), chunk=4, init_state=torch.from_numpy(h0))
    _close(y, yw)
    _close(st, sw)
    y2, st2 = ops.ssd(*_torch(arrs), chunk=4, init_state=torch.from_numpy(h0))
    torch.testing.assert_close(y2, y, atol=0, rtol=0)
    torch.testing.assert_close(st2, st, atol=0, rtol=0)
    # and it matters: from zero the result differs
    assert (ref.ssd(*_torch(arrs), chunk=4)[0] - y).abs().max() > 1e-2


def test_chunk_invariance():
    """The chunked algorithm does not depend on the chunk size, ragged
    chunks included."""
    arrs = _inputs(5, 1, 32, 2, 4, 1, 8)
    t = _torch(arrs)[:5]
    y32, s32 = ref.ssd(*t, None, chunk=32)
    for chunk in (4, 5, 12):
        y, s = ref.ssd(*t, None, chunk=chunk)
        torch.testing.assert_close(y, y32, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(s, s32, atol=1e-4, rtol=1e-4)


def test_chunked_scan_equals_step_by_step_decode():
    B, S, H, P, G, N = 1, 12, 4, 4, 2, 8
    x, dt, A, Bm, Cm, D = _torch(_inputs(6, B, S, H, P, G, N))
    y_chunk, s_chunk = ref.ssd(x, dt, A, Bm, Cm, D, chunk=4)
    state = torch.zeros((B, H, P, N))
    ys = []
    for t in range(S):
        y, state = ref.ssd_decode(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t],
                                  D, state)
        ys.append(y)
    torch.testing.assert_close(y_chunk, torch.stack(ys, 1), atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(s_chunk, state, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("G,with_d", [(1, True), (2, True), (2, False)])
def test_decode_step_matches_jax(G, with_d):
    B, H, P, N = 3, 4, 8, 16
    rng = np.random.default_rng(7)
    x, dt, A, Bm, Cm, D = [a[:, 0] if a.ndim > 1 else a
                           for a in _inputs(8, B, 1, H, P, G, N)]
    state = rng.normal(0, 1, (B, H, P, N)).astype(np.float32)
    D = D if with_d else None
    args = (x, dt, A, Bm, Cm, D, state)
    yw, sw = jref.ssd_decode(*(None if a is None else jnp.asarray(a)
                               for a in args))
    y, st = ops.ssd_decode(*(None if a is None else torch.from_numpy(a)
                             for a in args))
    assert y.shape == (B, H, P) and st.dtype == torch.float32
    _close(y, yw, atol=1e-5)
    _close(st, sw, atol=1e-5)


def test_wrapper_runs_the_plain_version_for_cpu_tensors():
    t = _torch(_inputs(9, 2, 21, 4, 8, 2, 16))
    before = wrapper.launches
    for kw in (dict(chunk=8), dict(chunk=256, unroll=True)):
        got = ops.ssd(*t, **kw)
        want = ref.ssd(*t, **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert wrapper.launches == before        # no kernel ran


def test_wrapper_refuses_a_device_without_a_kernel():
    x = torch.empty((1, 8, 2, 4), device="meta")
    dt = torch.empty((1, 8, 2), device="meta")
    A = torch.empty((2,), device="meta")
    Bm = torch.empty((1, 8, 1, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd(x, dt, A, Bm, Bm)


def test_wrapper_refuses_inputs_that_require_grad():
    t = list(_torch(_inputs(10, 1, 8, 2, 4, 1, 8)))
    t[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd(*t, chunk=4)
    with torch.no_grad():                    # no graph, no gradient owed
        torch.testing.assert_close(ops.ssd(*t, chunk=4)[0],
                                   ref.ssd(*t, chunk=4)[0])


def test_kernel_input_checks():
    """What the wrapper refuses before it launches the kernel: the checks
    read only shapes, dtypes and contiguity, so they run on CPU tensors."""
    check = importlib.import_module("repro_torch.kernels.ssd_scan")._check
    x, dt, A, Bm, Cm, D = _torch(_inputs(11, 2, 16, 4, 64, 2, 128),
                                 torch.bfloat16)
    check(x, dt, A, Bm, Cm, D)
    check(x, dt, A, Bm, Cm, None)
    big = torch.zeros(2, 16, 4, 128, dtype=torch.bfloat16)
    check(big, dt, A, torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16),
          torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16), D)  # P=128, N=64
    refused = [
        (ValueError, (x[:, :8], dt, A, Bm, Cm, D)),             # S differs
        (ValueError, (x, dt, A[:3], Bm, Cm, D)),                # A (H,)
        (ValueError, (x, dt, A, Bm, Cm, D[:2])),                # D (H,)
        (ValueError, (torch.zeros(2, 16, 3, 64, dtype=torch.bfloat16),
                      dt[..., :3], A[:3], Bm, Cm, D[:3])),      # 3 % 2
        (ValueError, (big, dt, A, Bm, Cm, D)),                  # 2 x 2 tiles
        (TypeError, (x.float(), dt, A, Bm, Cm, D)),             # mixed
        (TypeError, (x.half(), dt, A, Bm.half(), Cm.half(), D)),  # fp16
        (ValueError, (x.transpose(1, 2).contiguous().transpose(1, 2),
                      dt, A, Bm, Cm, D)),                       # strided x
        (ValueError, (x, dt.transpose(0, 1).contiguous().transpose(0, 1),
                      A, Bm, Cm, D)),                           # strided dt
    ]
    for exc, args in refused:
        with pytest.raises(exc):
            check(*args)
