"""K1d, the bf16 small-T Q40 product (csrc/q40_matvec_bf16.cu on K1m's
skeleton, csrc/q40_matvec.cuh), on the CPU:

* its plan (``ops/q40.matvec_plan(..., pieces=1)``: x in one bf16 piece)
  for every layer shape of Llama-2 7B, 13B and 70B at T = 2..8 and at
  ragged shapes, under the rules of tests/test_torch_matvec_plan.py: x and
  the ring fit a block's shared memory, one wave that keeps at least 96% of
  an H100's 132 SMs busy, every Q40 block in exactly one split;
* a model of how it rounds each weight (``split_scale`` and
  ``scaled_bf16``): for every finite f16 scale and all 16 codes, the scale
  splits exactly into bf16 hi + lo, (c - 8) lo is exact in bf16, and one
  rounding of (c - 8) hi + (c - 8) lo gives bf16_rn((c - 8) s), the
  weight ``dequantize_q40_torch(...).to(torch.bfloat16)`` holds.
The card checks the kernel's bits against the same weights
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
from test_torch_matvec_plan import MODELS, SMEM, SMS, _shapes

from distributed_llama_tpu_torch.ops import q40
from distributed_llama_tpu_torch.ops.quants import dequantize_q40_torch


def _check(t, d, nb, plan):
    wr, wk, grid_x, splits, kb = plan
    warps = wr * wk
    assert warps in q40.MATVEC_WARPS and wk >= 2
    smem = q40.matvec_smem(t, kb, wr, wk, 1)
    assert smem <= SMEM
    assert smem < q40.matvec_smem(t, kb, wr, wk)  # a third of x
    assert (splits - 1) * kb < nb <= splits * kb
    assert nb - (splits - 1) * kb >= min(nb, 4 * wk)
    tiles = -(-d // (32 * wr))
    assert 1 <= grid_x <= tiles
    per_sm = q40.matvec_blocks_per_sm(t, warps, smem, 1)
    assert per_sm >= 1
    assert grid_x * splits <= SMS * per_sm  # one wave
    if splits > 1:
        assert tiles <= q40.MATVEC_TICKETS
    return grid_x * splits


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("t", range(2, 9))
def test_k1d_plan_fits_fills_and_walks_at_every_layer_shape(model, t):
    for name, (d, n) in _shapes(model).items():
        nb = n // 32
        plan = q40.matvec_plan(t, d, nb, SMS, 1)
        assert _check(t, d, nb, plan) >= 0.96 * SMS, (name, plan)


@pytest.mark.parametrize("d,n", [(1, 32), (7, 64), (33, 32 * 129),
                                 (100, 96), (40, 96), (5, 28672)])
@pytest.mark.parametrize("t", [2, 5, 8])
def test_k1d_ragged_shapes_have_a_plan(d, n, t):
    plans = list(q40.matvec_plans(t, d, n // 32, SMS, 1))
    assert plans
    for _, plan in plans:
        _check(t, d, n // 32, plan)
    _check(t, d, n // 32, q40.matvec_plan(t, d, n // 32, SMS, 1))


def test_k1d_blocks_fit_more_of_an_sm_than_k1m():
    """One piece of x: at T = 8 a K1d block of the same plan needs less
    shared memory and holds registers for 16 warps an SM."""
    for kb in (32, 128):
        assert (q40.matvec_smem(8, kb, 4, 2, 1) + 2 * kb * 8 * 64
                + 2 * 8 * 32 * 8 * 4 == q40.matvec_smem(8, kb, 4, 2))
    assert q40.matvec_blocks_per_sm(8, 8, 60000, 1) == 2
    assert q40.matvec_blocks_per_sm(8, 8, 60000) == 1


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 -> f32, round to nearest even (cvt.rn.bf16x2.f32)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _trunc16(x: torch.Tensor) -> torch.Tensor:
    """f32 with its low 16 bits cleared (the kernel's byte permute)."""
    return (x.contiguous().view(torch.int32) & -0x10000).view(torch.float32)


def _finite_f16_scales() -> torch.Tensor:
    bits = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
    return torch.from_numpy(bits[np.isfinite(bits)].astype(np.float32))


def test_two_fma_route_rounds_each_weight_once():
    s = _finite_f16_scales()
    assert s.numel() == 63488  # every finite pattern, both zeros included
    hi = _bf16(s)                      # split_scale: bf16_rn(s)
    lo = _trunc16(s - hi)              # s - hi, exact, cut to bf16
    assert torch.equal(lo, s - hi)     # nothing cut: lo is a bf16
    assert torch.equal(hi.double() + lo.double(), s.double())
    for c in range(-8, 8):
        t = c * lo                     # fma(c, lo, -0): exact in bf16
        assert torch.equal(_bf16(t), t), c
        assert torch.equal((c * hi.double() + t.double()),
                           c * s.double()), c
        # fma(c, hi, t) rounds c hi + t = c s once: bf16_rn(c s), the
        # bf16 of the f32 product the plain version rounds
        route = _bf16((c * hi.double() + t.double()).to(torch.float32))
        assert torch.equal(route, _bf16(c * s)), c


def test_route_gives_the_dequantized_bf16_weight():
    """The route over ``q40.sweep_q40`` (codes 0..15 in every block, every
    finite f16 scale, 2^16 blocks) equals dequantize_q40_torch's f32
    weights rounded to bf16."""
    w = q40.sweep_q40("cpu")
    d, nb = w.d16.shape
    assert d * nb == 1 << 16
    assert torch.equal(w.d16.reshape(-1)[:63488].view(torch.int16).sort()[0],
                       torch.from_numpy(np.flatnonzero(np.isfinite(
                           np.arange(1 << 16, dtype=np.uint16).view(
                               np.float16))).astype(np.uint16).view(
                                   np.int16)).sort()[0])
    codes = torch.cat([w.qs & 0xF, w.qs >> 4], -1)
    assert (torch.sort(codes, -1)[0] == torch.arange(16).repeat_interleave(
        2)).all()
    want = dequantize_q40_torch(w.qs, w.d16).to(torch.bfloat16)
    sf = w.d16.to(torch.float32)[..., None]
    hi = _bf16(sf)
    lo = _trunc16(sf - hi)
    c = codes.to(torch.float64) - 8.0
    route = (c * hi.double() + c * lo.double()).to(torch.float32)
    got = route.reshape(d, nb * 32).to(torch.bfloat16)
    assert torch.equal(got.float(), want.float())
