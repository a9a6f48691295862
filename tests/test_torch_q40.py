"""Port Q40 matmul (the K1/K1m/K3 wrapper, CPU tensors -> plain version) vs
the JAX package's Pallas ``q40_matmul`` in interpret mode, at the T=1 shapes
of tests/test_pallas_q40.py and at T = 2..24.

Tolerance rtol 1e-5 / atol 1e-4, the one test_pallas_q40.py holds the Pallas
kernel to: both sides read the identical Q40 value map in f32 and differ
only in summation order.
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu.io.loader import Q40Weight as RefQ40
from distributed_llama_tpu.ops.quants import quantize_q40


def _mk(d, n, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d, n)) * 0.3).astype(np.float32)
    return RefQ40(*quantize_q40(w))


def _port(w):
    from distributed_llama_tpu_torch.io.loader import Q40Weight

    return Q40Weight(torch.from_numpy(w.qs), torch.from_numpy(w.d16))


@pytest.mark.parametrize("d,n,x_shape", [(256, 512, (1, 512)),
                                         (384, 1024, (1, 1024)),
                                         (128, 256, (256,))])
def test_plain_matches_pallas_interpret(d, n, x_shape):
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_q40 import q40_matmul as ref
    from distributed_llama_tpu_torch.ops import q40

    w = _mk(d, n, seed=d)
    x = np.random.default_rng(1).standard_normal(x_shape).astype(np.float32)
    want = np.asarray(ref(w, jnp.asarray(x), interpret=True))
    before = q40.KERNEL.launches
    got = q40.q40_matmul(_port(w), torch.from_numpy(x))
    assert q40.KERNEL.launches == before  # the CPU path launches nothing
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("t", [2, 4, 8, 16, 24])
def test_plain_matches_pallas_small_t_and_gemm_bodies(t):
    """The plain version of K1m (2 <= T <= 8) and K3 (T > 8) against the
    JAX package's ``q40_matmul`` in interpret mode, which reaches the Pallas
    small-T body (_kernel_multi -> _matvec_body_multi) at T <= 8 and the
    f32 GEMM body (_kernel -> _matmul_body) above, as
    tests/test_pallas_q40.py runs them. Same tolerance as above."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_q40 import MULTI_T_MAX
    from distributed_llama_tpu.ops.pallas_q40 import q40_matmul as ref
    from distributed_llama_tpu_torch.ops import q40

    assert q40.MULTI_T_MAX == MULTI_T_MAX
    w = _mk(128, 256, seed=t)
    x = np.random.default_rng(t).standard_normal((t, 256)).astype(np.float32)
    want = np.asarray(ref(w, jnp.asarray(x), interpret=True))
    counts = [k.launches for k in q40.KERNELS]
    got = q40.q40_matmul(_port(w), torch.from_numpy(x))
    assert [k.launches for k in q40.KERNELS] == counts
    assert tuple(got.shape) == want.shape == (t, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_plain_handles_many_tokens_on_cpu():
    """T>1 is a kernel restriction only: the CPU path takes any T."""
    from distributed_llama_tpu.ops.quants import dequantize_q40
    from distributed_llama_tpu_torch.ops.q40 import q40_matmul

    w = _mk(64, 128, seed=5)
    x = np.random.default_rng(2).standard_normal((3, 128)).astype(np.float32)
    want = x @ dequantize_q40(w.qs, w.d16).T
    got = q40_matmul(_port(w), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_a_device_without_kernel():
    """Only CPU tensors take the plain version: any other device launches
    the kernel or raises — here 'meta', which has no kernel."""
    from distributed_llama_tpu_torch.ops.q40 import q40_matmul

    w = _port(_mk(32, 64))
    meta = type(w)(w.qs.to("meta"), w.d16.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        q40_matmul(meta, torch.zeros(64, device="meta"))


def test_wrapper_checks_shapes_before_launch():
    from distributed_llama_tpu_torch.ops.q40 import _check

    w = _port(_mk(32, 64))
    with pytest.raises(ValueError, match="x must be float32"):
        _check(w, torch.zeros(1, 96))
    with pytest.raises(ValueError, match="d16 must be float16"):
        _check(type(w)(w.qs, w.d16.float()), torch.zeros(1, 64))
    with pytest.raises(ValueError, match="contiguous"):
        _check(w, torch.zeros(64, 2)[:, 0])
    assert _check(w, torch.zeros(1, 64)) == (32, 2)
