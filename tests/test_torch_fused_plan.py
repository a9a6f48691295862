"""The plan of K8's and K9's per-warp shared-memory rings
(csrc/fused_layer.cu), as ops/layer models it: every row of every phase
taken exactly once, by one warp, in blocks' bands that differ by one job at
most; each lane's Q40 blocks of a row in P0's order across the chunks
(lane l: blocks l, l + 32, ...); every 16-byte copy of codes and scales
16-byte aligned, inside the weight and inside its slot; and the rings' shared
memory on the card. At Llama-2-7B's, 13B's and 70B's widths and at the
card tests' (tests/test_torch_cuda.py FUSED_SHAPES), grids of 132 (H100
SXM), 114 (PCIe) and 7 blocks. Also the one-hot readback weight
(layer.readback_q40) through the plain matmul, and tools/k10_phases.py's
stamps of this tree's K8 and K9."""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.ops import layer, q40

# (dim, hidden_dim, n_heads, n_kv_heads)
WIDTHS = {"7b": (4096, 11008, 32, 32), "13b": (5120, 13824, 40, 40),
          "70b": (8192, 28672, 64, 8), "f0": (256, 704, 2, 2),
          "f1": (512, 1376, 8, 4), "f3": (1024, 2816, 8, 1),
          "f4": (256, 11008, 2, 2), "f5": (256, 28672, 2, 2),
          "odd": (352, 704, 2, 2)}
GRIDS = (132, 114, 7)
H100_OPTIN = 232448  # shared-memory bytes a block may opt in to (sm_90)


def _phases(case, kernel):
    dim, hid, n_heads, n_kv = WIDTHS[case]
    if kernel == "head":
        return layer.ring_phases(dim, rows=dim + 2 * n_kv * (dim // n_heads))
    return layer.ring_phases(dim, hid)


@pytest.mark.parametrize("kernel", ["head", "tail"])
@pytest.mark.parametrize("case", sorted(WIDTHS))
def test_every_row_is_taken_once(case, kernel):
    for rows, nb, jobs, step, off in _phases(case, kernel):
        assert jobs * 2 == rows
        for grid in GRIDS:
            seen = np.zeros(rows, dtype=np.int64)
            per_block = []
            for b in range(grid):
                counts = [len(layer.ring_jobs(jobs, grid, b, w))
                          for w in range(layer.RING_WARPS)]
                assert max(counts) - min(counts) <= 1
                per_block.append(sum(counts))
                for w in range(layer.RING_WARPS):
                    for j in layer.ring_jobs(jobs, grid, b, w):
                        seen[step * j] += 1
                        seen[step * j + off] += 1
            assert (seen == 1).all(), (rows, grid)
            assert max(per_block) - min(per_block) <= 1


@pytest.mark.parametrize("kernel", ["head", "tail"])
@pytest.mark.parametrize("case", sorted(WIDTHS))
def test_rings_fit_the_card_and_keep_p0s_lanes(case, kernel):
    dim, hid = WIDTHS[case][:2]
    stage = layer.ring_stage_bytes(dim, 0 if kernel == "head" else hid)
    plan = layer.ring_chunk(stage, H100_OPTIN)
    assert plan is not None
    ch, smem = plan
    assert ch % 32 == 0 and smem <= H100_OPTIN
    assert (stage + layer.RING_WARPS * layer.RING_SLOTS
            * layer.ring_slot_bytes(ch)) == smem
    # each region of a slot starts 16-byte aligned
    assert stage % 16 == 0 and layer.ring_slot_bytes(ch) % 16 == 0
    assert (32 * ch) % 16 == 0 and (34 * ch + 16) % 16 == 0
    for _, nb, *_ in _phases(case, kernel):
        lanes = [[] for _ in range(32)]
        for c0 in range(0, nb, ch):
            n = min(ch, nb - c0)
            assert 16 * n <= 16 * ch
            for lane in range(32):
                lanes[lane] += list(range(c0 + lane, c0 + n, 32))
        for lane in range(32):
            assert lanes[lane] == list(range(lane, nb, 32))


def test_chunk_sizes_at_the_model_widths():
    """64 Q40 blocks a chunk wherever 16 warps x 2 slots of two rows fit
    beside the staged vector: at every model width up to 70B's (K9's staged
    hb there: 896 blocks, 129 KB); 32 for wider hidden layers, none where
    even that does not fit."""
    def chunk(dim, hid):
        plan = layer.ring_chunk(layer.ring_stage_bytes(dim, hid), H100_OPTIN)
        return plan and plan[0]

    assert chunk(4096, 0) == chunk(8192, 0) == 64
    assert chunk(4096, 11008) == chunk(5120, 13824) == 64
    assert chunk(8192, 28672) == 64
    assert chunk(8192, 36864) == 32
    assert chunk(256, 65536) is None


@pytest.mark.parametrize("kernel", ["head", "tail"])
@pytest.mark.parametrize("case", sorted(WIDTHS))
@pytest.mark.parametrize("base", [0, 2, 6, 14])
def test_scale_copies_are_aligned_and_stay_inside(case, kernel, base):
    """A weight's scales at a byte address 0, 2, 6 or 14 past a 16-byte
    boundary (a view into its storage): each row's chunks copy 16-byte
    pieces from 16-byte aligned addresses, no byte past the weight's end,
    at most 16 a row (lanes 0-15, 16-31), inside the row's part of the
    slot, covering every scale the chunk takes, each row's first scale as
    far into its copy in every chunk."""
    dim, hid = WIDTHS[case][:2]
    stage = layer.ring_stage_bytes(dim, 0 if kernel == "head" else hid)
    ch = layer.ring_chunk(stage, H100_OPTIN)[0]
    addr = 4096 + base
    for rows, nb, *_ in _phases(case, kernel):
        total = rows * nb
        for row in sorted({0, 1, 2, 3, rows // 2 + 1, rows - 2, rows - 1}):
            shifts = set()
            for c0 in range(0, nb, ch):
                n = min(ch, nb - c0)
                lo = addr + 2 * (row * nb + c0)
                copies = layer.ring_scale_copies(addr, row, nb, c0, n, total)
                assert 1 <= len(copies) <= 16
                assert 16 * len(copies) <= 2 * ch + 16
                got = set()
                for at, nbytes in copies:
                    assert at % 16 == 0 and 1 <= nbytes <= 16
                    assert at + nbytes <= addr + 2 * total
                    got |= set(range(at, at + nbytes))
                assert set(range(lo, lo + 2 * n)) <= got
                shifts.add((lo - copies[0][0]) // 2)
            assert len(shifts) == 1 and shifts.pop() == (
                (addr + 2 * row * nb) % 16) // 2


def test_readback_weight_returns_x_through_the_plain_matmul():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 352)).astype(np.float32))
    got = q40.q40_matmul_plain(layer.readback_q40(400, 352, "cpu"), x)
    assert torch.equal(got[0, :352], x[0])
    assert not got[0, 352:].any()


@pytest.mark.parametrize("kernel", ["head", "tail"])
def test_phase_stamps_fit_this_trees_head_and_tail(kernel):
    """tools/k10_phases.py stamps each phase of this tree's K8 and K9 at
    exactly one place."""
    from distributed_llama_tpu_torch.ops import _build
    from distributed_llama_tpu_torch.tools import k10_phases

    phases, _, keys = k10_phases.KERNELS[kernel]
    text = k10_phases.stamped((_build.CSRC / "fused_layer.cu").read_text(),
                              keys["current"])
    assert text.count("STAMP(") == len(phases) + 1  # + #define
