"""The tensor-core arithmetic of the f32 decode matvecs (K1 at T = 1, K1m at
T = 2..8, csrc/q40_matvec.cu) on the CPU.

* ``ops/q40.bf16_split3``: every finite f32 x is p0 + p1 / 2^8 + p2 / 2^16
  exactly, each piece a bf16 value (its low 16 bits zero), subnormal and
  huge values included: the kernels' products code x piece are exact.
* A code minus 8 is exact in bf16 by the kernels' byte permute (bf16 128 +
  code) and subtraction of 136.
* ``ops/q40.q40_matmul_split_model``, a plain model of the kernels'
  arithmetic (three pieces, exact products, a per-Q40-block f32 sum, the
  scale and the pieces' join in f32), against the JAX package's
  ``q40_matmul`` at T = 1..8 (its T = 1 and small-T f32 bodies in interpret
  mode), and against the port's ``q40_matmul_plain`` at the input widths of
  7B's, 13B's and 70B's w2 (344, 432 and 896 Q40 blocks in one sum), within
  the kernels' KERNEL_RTOL of the reference's largest magnitude.
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.io.loader import Q40Weight
from distributed_llama_tpu_torch.ops import q40
from distributed_llama_tpu_torch.ops.quants import dequantize_q40_torch


def _low16(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32) & 0xFFFF


def _all_binades(seed: int) -> torch.Tensor:
    """f32 values of every exponent field 0..254 (subnormals, the least
    normal, the largest binade), 512 random mantissas each plus the
    mantissas 0, 1 and all ones, both signs."""
    rng = np.random.default_rng(seed)
    mant = np.concatenate([rng.integers(0, 1 << 23, (255, 512)),
                           np.tile([0, 1, (1 << 23) - 1], (255, 1))], 1)
    bits = (np.arange(255)[:, None] << 23) | mant
    bits = np.concatenate([bits.ravel(), bits.ravel() | (1 << 31)])
    return torch.from_numpy(bits.astype(np.uint32).view(np.int32)).view(
        torch.float32)


def test_split3_reconstructs_every_finite_f32_exactly():
    x = _all_binades(0)
    assert torch.isfinite(x).all()
    assert (x == 0).sum() == 2  # +0 and -0
    p0, p1, p2 = q40.bf16_split3(x)
    for p in (p0, p1, p2):
        assert not _low16(p).any()  # each piece is a bf16 value
        assert torch.isfinite(p).all()
        assert torch.equal(p.to(torch.bfloat16).to(torch.float32), p)
    joined = p0.double() + p1.double() / 2**8 + p2.double() / 2**16
    assert torch.equal(joined, x.double())


def test_split3_extremes():
    """The largest finite f32, the least subnormal and the least normal,
    with their neighbours, each split and joined exactly."""
    bits = torch.tensor([0x7F7FFFFF, 0x7F7F0001, 0x00000001, 0x0000FFFF,
                         0x00010000, 0x007FFFFF, 0x00800000, 0x00800001],
                        dtype=torch.int32)
    for sign in (0, -0x80000000):
        x = (bits | sign).view(torch.float32)
        p0, p1, p2 = q40.bf16_split3(x)
        joined = p0.double() + p1.double() / 2**8 + p2.double() / 2**16
        assert torch.equal(joined, x.double())


def test_code_minus_8_is_exact_in_bf16():
    """The kernels' unpack: code c in the low mantissa bits of bf16 0x4300
    is 128 + c; minus 136 it is c - 8, each step exact in bf16."""
    codes = torch.arange(16, dtype=torch.int32)
    as_bf16 = ((0x4300 | codes) << 16).view(torch.float32)
    assert torch.equal(as_bf16, 128.0 + codes.to(torch.float32))
    got = (as_bf16.to(torch.bfloat16) - torch.tensor(136.0).to(
        torch.bfloat16)).to(torch.float32)
    assert torch.equal(got, codes.to(torch.float32) - 8.0)


def _ref_q40(d, n, seed):
    from distributed_llama_tpu.io.loader import Q40Weight as RefQ40
    from distributed_llama_tpu.ops.quants import quantize_q40

    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d, n)) * 0.3).astype(np.float32)
    return RefQ40(*quantize_q40(w))


@pytest.mark.parametrize("t", range(1, 9))
def test_split_model_matches_the_jax_small_t_bodies(t):
    """The model against the JAX package's T <= 8 f32 bodies
    (_kernel_matvec, _kernel_multi) in interpret mode, within KERNEL_RTOL
    of the reference's largest magnitude."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_q40 import q40_matmul as ref

    w = _ref_q40(96, 512, seed=t)
    x = np.random.default_rng(10 + t).standard_normal((t, 512)).astype(
        np.float32)
    want = np.asarray(ref(w, jnp.asarray(x), interpret=True))
    got = q40.q40_matmul_split_model(
        Q40Weight(torch.from_numpy(w.qs), torch.from_numpy(w.d16)),
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (t, 96)
    assert np.abs(got - want).max() <= q40.KERNEL_RTOL * np.abs(want).max()


W2_WIDTHS = {"7b": 11008, "13b": 13824, "70b": 28672}  # w2's input width


@pytest.mark.parametrize("model", sorted(W2_WIDTHS))
@pytest.mark.parametrize("t", [1, 2, 8])
def test_split_model_holds_its_tolerance_at_w2_depth(model, t):
    """At w2's depth (up to 896 Q40 blocks in one sum) the model stays
    within KERNEL_RTOL of the port's plain f32 product, and within 1e-2 x
    KERNEL_RTOL of max|out| from float64: the pieces are exact, only the
    f32 sums round."""
    n = W2_WIDTHS[model]
    g = torch.Generator().manual_seed(n + t)
    w = q40.random_q40(24, n, "cpu", g)
    x = torch.randn((t, n), generator=g)
    got = q40.q40_matmul_split_model(w, x)
    want = q40.q40_matmul_plain(w, x)
    peak = want.abs().max()
    assert got.shape == want.shape == (t, 24)
    assert (got - want).abs().max() <= q40.KERNEL_RTOL * peak
    exact = x.double() @ dequantize_q40_torch(w.qs, w.d16).double().T
    assert (got.double() - exact).abs().max() <= 1e-2 * q40.KERNEL_RTOL * \
        exact.abs().max()
