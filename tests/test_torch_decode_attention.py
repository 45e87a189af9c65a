"""The port's plain ``decode_attention`` against the JAX reference and the
Pallas kernel (run in interpret mode, as tests/test_kernels.py runs it).

Shapes are those of tests/test_kernels.py plus a window and a softcap
case; lengths are drawn from [1, Smax+1], Smax+1 included, which the
engine reaches once a slot is full.  Tolerances are test_kernels.py's.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention as wrapper

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

CASES = {
    "gqa": dict(B=2, H=4, K=2, D=16, Smax=64),
    "mqa": dict(B=3, H=8, K=1, D=8, Smax=32),
    "window": dict(B=3, H=4, K=2, D=8, Smax=32, window=8),
    "softcap": dict(B=2, H=4, K=2, D=16, Smax=64, softcap=5.0),
}


def _inputs(seed, B, H, K, D, Smax, dtype):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, Smax, K, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, Smax, K, D)).astype(np.float32)
    lengths = rng.integers(1, Smax + 2, (B,)).astype(np.int32)
    lengths[0] = Smax + 1
    lengths[-1] = 1
    j = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)]
    return j + [jnp.asarray(lengths)], t + [torch.from_numpy(lengths)]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_ref_and_pallas(case, dtype):
    c = dict(CASES[case])
    kw = dict(window=c.pop("window", 0), softcap=c.pop("softcap", 0.0))
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(7, dtype=dtype, **c)
    got = ref.decode_attention(tq, tk, tv, tl, **kw)
    assert got.dtype == TDT[dtype] and got.shape == tq.shape
    got = got.float().numpy()
    want = np.asarray(jref.decode_attention(jq, jk, jv, jl, **kw),
                      np.float32)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    kern = np.asarray(pallas_decode(jq, jk, jv, jl, block_s=16,
                                    interpret=True, **kw), np.float32)
    np.testing.assert_allclose(got, kern, atol=TOL[dtype], rtol=TOL[dtype])


def test_wrapper_runs_the_plain_version_for_cpu_tensors():
    _, (q, k, v, lengths) = _inputs(3, 2, 4, 2, 16, 64, "float32")
    before = wrapper.launches
    out = ops.decode_attention(q, k, v, lengths)
    torch.testing.assert_close(out, ref.decode_attention(q, k, v, lengths),
                               atol=0, rtol=0)
    assert wrapper.launches == before        # no kernel ran


def test_wrapper_refuses_a_device_without_a_kernel():
    q = torch.empty((2, 4, 16), device="meta")
    k = torch.empty((2, 64, 2, 16), device="meta")
    lengths = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.decode_attention(q, k, k, lengths)
