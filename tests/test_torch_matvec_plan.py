"""The plan of the f32 decode matvecs (K1, K1m: ``ops/q40.matvec_plan``) on
the CPU, for every layer shape of Llama-2 7B, 13B and 70B at T = 1..8 on
an H100's 132 SMs: the x slice and the ring fit a block's shared memory
(227 KB); the blocks keep at least 96% of the SMs busy in one wave and
no more than the SMs hold (d = 4096 at 32 rows a tile is 128 tiles: the
4 idle SMs cost less than the split that would fill them, as
tools/plan_sweep.py measured on an H100); every Q40 block lies in exactly
one split, and each split gives every warp a block of its first stage;
the plan is a pure function of its arguments, and every plan of
``matvec_plans`` meets the same rules.
"""

import pytest

from distributed_llama_tpu_torch.ops import q40

SMS = 132  # an H100 SXM's SMs
SMEM = 232448  # bytes of shared memory a block may use (227 KB)

# (dim, hidden, kv width, vocab) of Llama-2 7B, 13B and 70B
MODELS = {"7b": (4096, 11008, 4096, 32000), "13b": (5120, 13824, 5120, 32000),
          "70b": (8192, 28672, 1024, 32000)}


def _shapes(model):
    dim, hidden, kv, vocab = MODELS[model]
    return {"wqkv": (dim + 2 * kv, dim), "wo": (dim, dim),
            "w13": (2 * hidden, dim), "w2": (dim, hidden),
            "wcls": (vocab, dim)}


def _check(t, d, nb, plan):
    wr, wk, grid_x, splits, kb = plan
    warps = wr * wk
    assert warps in q40.MATVEC_WARPS and wk >= 2
    smem = q40.matvec_smem(t, kb, wr, wk)
    assert smem <= SMEM
    # every block in exactly one split, none empty
    assert (splits - 1) * kb < nb <= splits * kb
    last = nb - (splits - 1) * kb
    assert last >= min(nb, 4 * wk)  # every warp has a block of stage 0
    tiles = -(-d // (32 * wr))
    assert 1 <= grid_x <= tiles
    per_sm = q40.matvec_blocks_per_sm(t, warps, smem)
    assert per_sm >= 1
    assert grid_x * splits <= SMS * per_sm  # one wave
    if splits > 1:
        assert tiles <= q40.MATVEC_TICKETS
    return grid_x * splits


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("t", range(1, 9))
def test_plan_fits_fills_and_walks_at_every_layer_shape(model, t):
    for name, (d, n) in _shapes(model).items():
        nb = n // 32
        plan = q40.matvec_plan(t, d, nb, SMS)
        blocks = _check(t, d, nb, plan)
        assert blocks >= 0.96 * SMS, (name, plan)


@pytest.mark.parametrize("t", [1, 4, 8])
def test_every_plan_of_the_sweep_keeps_the_rules(t):
    for d, n in [*_shapes("7b").values(), (33, 32 * 129), (1, 32), (5, 96)]:
        nb = n // 32
        plans = list(q40.matvec_plans(t, d, nb, SMS))
        assert plans
        for _, plan in plans:
            _check(t, d, nb, plan)
        fill = [cp for cp in plans if cp[1][2] * cp[1][3] >= 0.96 * SMS]
        assert q40.matvec_plan(t, d, nb, SMS) == min(
            fill or plans, key=lambda cp: (cp[0], cp[1][3], -cp[1][0],
                                           -cp[1][0] * cp[1][1]))[1]


def test_plan_is_a_pure_function_of_its_arguments():
    args = [(t, d, n // 32, sms) for t in (1, 8) for d, n in
            _shapes("13b").values() for sms in (SMS, 114)]
    first = [q40.matvec_plan(*a) for a in args]
    q40.matvec_plan.cache_clear()
    assert [q40.matvec_plan(*a) for a in args] == first
    assert [q40.matvec_plan.__wrapped__(*a) for a in args] == first


@pytest.mark.parametrize("d,n", [(1, 32), (7, 64), (33, 32 * 129),
                                 (100, 96), (5, 28672)])
@pytest.mark.parametrize("t", [1, 2, 8])
def test_ragged_shapes_have_a_plan(d, n, t):
    _check(t, d, n // 32, q40.matvec_plan(t, d, n // 32, SMS))


def band_shapes(model, tp):
    """A tensor-parallel rank's (d, n) Q40 matrices at ``tp``
    (parallel/tp.py): column-parallel bands of d/tp rows (wqkv, w13, wcls,
    and wo/w2 under the ref scheme) and the fused scheme's row-parallel
    wo/w2 of n/tp input values (nb/tp Q40 blocks)."""
    dim, hidden, kv, vocab = MODELS[model]
    return {"wqkv": ((dim + 2 * kv) // tp, dim), "w13": (2 * hidden // tp, dim),
            "wcls": (vocab // tp, dim), "wo-ref": (dim // tp, dim),
            "w2-ref": (dim // tp, hidden), "wo-fused": (dim, dim // tp),
            "w2-fused": (dim, hidden // tp)}


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_plan_at_band_shapes(model, tp):
    """Every band of 7B/13B/70B at tp 2, 4 and 8 has a plan that keeps the
    rules at T = 1..8, and fills the SMs wherever some plan of the sweep
    does."""
    for name, (d, n) in band_shapes(model, tp).items():
        assert n % 32 == 0, name
        nb = n // 32
        for t in range(1, 9):
            plan = q40.matvec_plan(t, d, nb, SMS)
            blocks = _check(t, d, nb, plan)
            fills = any(p[2] * p[3] >= 0.96 * SMS
                        for _, p in q40.matvec_plans(t, d, nb, SMS))
            assert blocks >= 0.96 * SMS or not fills, (name, t, plan)
