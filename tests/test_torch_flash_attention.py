"""The port's plain ``mha`` against the JAX reference and the Pallas
flash-attention kernel (run in interpret mode, as tests/test_kernels.py
runs it), and the kernel wrapper's dispatch on the CPU.

Shapes and tolerances are test_kernels.py's (2e-5 in fp32, 2e-2 in bf16),
plus a softcap case, a ragged S = 40 (against the reference only: the
Pallas wrapper asserts that its blocks divide S) and rows that keep no
key.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention as wrapper

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODES = {"causal": dict(causal=True), "bidi": dict(causal=False),
         "window": dict(causal=True, window=8)}


def _inputs(seed, B, S, T, H, K, D, Dv, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(0, 1, shp).astype(np.float32)
            for shp in ((B, S, H, D), (B, T, K, D), (B, T, K, Dv))]
    return ([jnp.asarray(a, JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _check(j, t, kw, dtype, pallas=True):
    got = ref.mha(*t, **kw)
    assert got.dtype == t[0].dtype
    assert got.shape == t[0].shape[:3] + t[2].shape[3:]
    got = got.float().numpy()
    tol = dict(atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(jref.mha(*j, **kw),
                                               np.float32), **tol)
    if pallas:
        kern = pallas_flash(*j, block_q=16, block_k=16, interpret=True, **kw)
        np.testing.assert_allclose(got, np.asarray(kern, np.float32), **tol)


@pytest.mark.parametrize("B,S,H,K,D", [
    (1, 32, 2, 2, 8),      # MHA
    (2, 64, 4, 2, 16),     # GQA g=2
    (1, 48, 8, 2, 16),     # GQA g=4
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_matches_jax_ref_and_pallas(B, S, H, K, D, dtype, mode):
    j, t = _inputs(0, B, S, S, H, K, D, D, dtype)
    _check(j, t, MODES[mode], dtype)


# (B, S, T, H, K, D, Dv) and the keywords
SPECIAL = {
    "q_offset": ((1, 16, 64, 2, 2, 8, 8), dict(causal=True, q_offset=48)),
    "mla_vdim": ((1, 32, 32, 4, 4, 24, 16), dict(causal=True,
                                                 scale=24 ** -0.5)),
    "softcap": ((2, 32, 32, 4, 2, 16, 16), dict(causal=True, softcap=5.0)),
}


@pytest.mark.parametrize("case", list(SPECIAL))
def test_plain_matches_at_offsets_vdim_and_softcap(case):
    shape, kw = SPECIAL[case]
    j, t = _inputs(1, *shape, "float32")
    _check(j, t, kw, "float32")


@pytest.mark.parametrize("mode", list(MODES))
def test_ragged_length_matches_jax_ref(mode):
    j, t = _inputs(2, 2, 40, 40, 4, 2, 16, 16, "float32")
    _check(j, t, MODES[mode], "float32", pallas=False)


def test_q_chunk_invariance():
    _, (q, k, v) = _inputs(3, 2, 32, 32, 4, 2, 8, 8, "float32")
    dense = ref.mha(q, k, v, causal=True)
    for kw in (dict(q_chunk=8), dict(q_chunk=8, unroll=True),
               dict(q_chunk=12)):          # 12 does not divide 32: dense
        torch.testing.assert_close(ref.mha(q, k, v, causal=True, **kw), dense,
                                   atol=1e-5, rtol=1e-5)
    j, _ = _inputs(3, 2, 32, 32, 4, 2, 8, 8, "float32")
    np.testing.assert_allclose(
        ref.mha(q, k, v, window=8, q_offset=4, q_chunk=8).numpy(),
        np.asarray(jref.mha(*j, window=8, q_offset=4, q_chunk=8)),
        atol=1e-5, rtol=1e-5)


def test_rows_without_a_key_average_every_value():
    """A reference fact: with q_offset + i >= T + window - 1 a causal
    windowed row keeps no key.  ``ref.mha`` (JAX's and the port's)
    softmaxes over its fully masked logits and so averages every value;
    the Pallas kernel returns zeros there."""
    B, S, T, H, K, D, W = 1, 32, 32, 2, 2, 8, 8
    j, t = _inputs(4, B, S, T, H, K, D, D, "float32")
    kw = dict(causal=True, window=W, q_offset=32)
    first_empty = T + W - 1 - 32                  # row 7
    want = np.asarray(jref.mha(*j, **kw))
    got = ref.mha(*t, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    mean = t[2].numpy().mean(axis=1)              # (B, K, Dv); H = K here
    np.testing.assert_allclose(got[:, first_empty:],
                               np.broadcast_to(mean[:, None],
                                               got[:, first_empty:].shape),
                               atol=1e-6)
    kern = np.asarray(pallas_flash(*j, block_q=16, block_k=16,
                                   interpret=True, **kw))
    assert np.all(kern[:, first_empty:] == 0)
    np.testing.assert_allclose(kern[:, :first_empty], got[:, :first_empty],
                               atol=2e-5, rtol=2e-5)
    # the rows before keep their keys
    assert np.abs(got[:, :first_empty] - mean[:, None]).max() > 1e-2


def test_wrapper_runs_the_plain_version_for_cpu_tensors():
    _, (q, k, v) = _inputs(5, 2, 24, 24, 4, 2, 16, 16, "float32")
    before = wrapper.launches
    for kw in (dict(), dict(causal=False, window=4, softcap=3.0),
               dict(q_offset=5, q_chunk=8)):
        torch.testing.assert_close(ops.mha(q, k, v, **kw),
                                   ref.mha(q, k, v, **kw), atol=0, rtol=0)
    assert wrapper.launches == before        # no kernel ran


def test_wrapper_refuses_a_device_without_a_kernel():
    q = torch.empty((2, 16, 4, 16), device="meta")
    k = torch.empty((2, 16, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.mha(q, k, k)


def test_wrapper_refuses_inputs_that_require_grad():
    _, (q, k, v) = _inputs(6, 1, 8, 8, 2, 1, 8, 8, "float32")
    k.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.mha(q, k, v)
    with torch.no_grad():                    # no graph, no gradient owed
        torch.testing.assert_close(ops.mha(q, k, v), ref.mha(q, k, v))


def test_kernel_input_checks():
    """What the wrapper refuses before it launches the kernel: the checks
    read only shapes, dtypes and strides, so they run on CPU tensors."""
    check = importlib.import_module(
        "repro_torch.kernels.flash_attention")._check
    bf = dict(dtype=torch.bfloat16)
    q = torch.zeros(2, 16, 4, 16, **bf)
    k = torch.zeros(2, 16, 2, 16, **bf)
    check(q, k, k)
    check(torch.zeros(2, 16, 8, 16, **bf)[:, :, :4], k,     # strided heads
          torch.zeros(2, 16, 2, 8, **bf))                  # Dv != D
    refused = [
        (ValueError, (q, torch.zeros(2, 16, 2, 8, **bf), k)),   # D differs
        (ValueError, (q, torch.zeros(2, 16, 3, 16, **bf),
                      torch.zeros(2, 16, 3, 16, **bf))),        # 4 % 3
        (ValueError, (q, k[:, :0], k[:, :0])),                  # T == 0
        (TypeError, (q.float(), k, k)),                          # mixed
        (TypeError, (q.half(), k.half(), k.half())),             # fp16
        (ValueError, (torch.zeros(2, 16, 4, 12, **bf),
                      torch.zeros(2, 16, 2, 12, **bf),
                      torch.zeros(2, 16, 2, 12, **bf))),         # D % 8
        (ValueError, (torch.zeros(2, 16, 4, 32, **bf)[..., ::2], k, k)),
        (ValueError, (torch.zeros(2, 16, 4, 17, **bf)[..., 1:], k, k)),
    ]
    for exc, args in refused:
        with pytest.raises(exc):
            check(*args)
