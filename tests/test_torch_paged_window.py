"""K6w's and K7w's window route (csrc/paged_window.cu: verify and mixed
windows of WINDOW_MIN_T = 3 queries and more, in K4's tile design over the
page table) on the CPU:
the plain-torch model of the kernels' arithmetic
(``paged_attention.paged_window_model``: each row's live keys in tiles of
32, 3xTF32 dots, the tiles cut into splits by the window plan and merged in
split order) against the JAX package's Pallas
``paged_decode_attention_kernel`` and ``_q8`` in interpret mode at t_len 2,
4 and 8, against its XLA gather route (models/llama.py
``spec_verify_attention``, ``mixed_attention`` and ``paged_attention_q8``)
at t_len 16 and 39, and against the port's plain versions, over f32, bf16
and Q8 pools, kv_mul 1, 2, 4 and 8 and the budget-edge clamp, at 1e-5 abs
(KERNEL_ATOL: the same f32 softmax in another order, K4's 3xTF32 dots); its
own identities bit for bit (the Q8 route is the f32 route over the
dequantized pool; page placement); the window plan and the grid; the route
cut and the constants the kernel source holds."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.ops import attention
from distributed_llama_tpu_torch.ops import paged_attention as pa
from distributed_llama_tpu_torch.ops.quants import (dequantize_q80_planes,
                                                    quantize_q80_torch)

ATT_TOL = attention.KERNEL_ATOL
SMS = 132  # an H100's SMs
L, PS, HS = 2, 8, 32
# plans: one split, and plans that cut a row's 32-key tiles into as many
# splits as they hold (least 1 key: one tile a split) or into pairs
PLANS = [attention.ONE_SPLIT, (32, 1), (2, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small CPU tensors: under
    xdist, workers whose thread pools oversubscribe the cores run them
    many times slower than one thread does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _n_kv(kv_mul):
    return 2 if kv_mul < 8 else 1  # n_q * hs <= 256


def _pool(n_kv, seed, P):
    rng = np.random.default_rng(seed)
    shape = (L * P, PS, n_kv, HS)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _table(max_pages, P, seed=1):
    ids = 1 + np.random.default_rng(seed).permutation(P - 1)[:3 * max_pages]
    return ids.reshape(3, max_pages).astype(np.int32)


def _pos(max_pages):
    """Clocks of three rows: 0, mid-page, and one whose window runs past
    the virtual plane (the budget-edge clamp)."""
    return [0, 13, max_pages * PS - 2]


def _planes(k4, v4, pages):
    """The pool as the port holds it: f32 or bf16 planes, or Q8 codes and
    deltas (kq4, kd4, vq4, vd4)."""
    tk, tv = torch.from_numpy(k4), torch.from_numpy(v4)
    if pages == "bf16":
        return [tk.to(torch.bfloat16), tv.to(torch.bfloat16)]
    if pages == "f32":
        return [tk, tv]
    rows, ps, n_kv, hs = k4.shape
    out = []
    for x in (tk, tv):
        qs, d = quantize_q80_torch(x.reshape(rows, ps, n_kv * hs))
        out += [qs.reshape(rows, ps, n_kv, hs).contiguous(), d.contiguous()]
    return out


def _j(t):
    import jax.numpy as jnp

    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _case(pages, kv_mul, t_len, max_pages, seed):
    n_kv = _n_kv(kv_mul)
    P = 3 * max_pages + 1
    k4, v4 = _pool(n_kv, seed=seed, P=P)
    q = np.random.default_rng(seed + 1).standard_normal(
        (3, t_len, n_kv * kv_mul * HS)).astype(np.float32)
    return q, _planes(k4, v4, pages), _table(max_pages, P, seed=kv_mul), P


@pytest.mark.parametrize("pages", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("kv_mul", [1, 2, 4, 8])
@pytest.mark.parametrize("t_len", [2, 4, 8])
def test_window_model_matches_pallas_paged(pages, kv_mul, t_len):
    """The model under every plan against the Pallas kernel over a
    scrambled table, the last row's window clamped at the plane's edge."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_paged_attention import (
        paged_decode_attention_kernel, paged_decode_attention_kernel_q8)

    max_pages = 8
    q, planes, table, P = _case(pages, kv_mul, t_len, max_pages,
                                seed=10 * kv_mul + t_len)
    kernel = (paged_decode_attention_kernel_q8 if pages == "q8"
              else paged_decode_attention_kernel)
    pos = _pos(max_pages)
    want = np.asarray(kernel(jnp.asarray(q), *(_j(p) for p in planes), 1,
                             np.asarray(pos, np.int32), jnp.asarray(table),
                             page_size=PS, n_pages=P, kv_mul=kv_mul,
                             t_len=t_len, interpret=True))
    for plan in PLANS:
        got = pa.paged_window_model(torch.from_numpy(q), planes, 1, pos,
                                    torch.from_numpy(table), P, kv_mul, plan)
        assert tuple(got.shape) == want.shape == q.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATT_TOL, rtol=0,
                                   err_msg=f"plan {plan}")


def _jax_gather(pages, q, planes, table, P, pos, kv_mul, span):
    """The JAX package's XLA gather route for a window: its verify
    (``spec_verify_attention``) or, with ``span``, mixed
    (``mixed_attention``) attention, or ``paged_attention_q8`` over Q8
    pages. Each writes the window's own k and v first (drawn here); the
    pool it returns is what it attended over. Returns (ao, pool planes as
    torch tensors)."""
    import jax.numpy as jnp

    from distributed_llama_tpu.models import llama as jl

    B, t_len, _ = q.shape
    n_kv = planes[0].shape[2]
    rng = np.random.default_rng(t_len)
    k = rng.standard_normal((B, t_len, n_kv * HS)).astype(np.float32)
    v = rng.standard_normal((B, t_len, n_kv * HS)).astype(np.float32)
    pos = jnp.asarray(np.asarray(pos, np.int32))
    args = (HS, kv_mul, PS, P, jnp.asarray(q), jnp.asarray(k),
            jnp.asarray(v))
    if pages == "q8":
        ao, *pool = jl.paged_attention_q8(
            *args, *(_j(p) for p in planes), 1, pos, jnp.asarray(table),
            None if span is None else jnp.asarray(span))
    elif span is None:
        ao, *pool = jl.spec_verify_attention(
            *args, *(_j(p) for p in planes), 1, pos, jnp.asarray(table))
    else:
        ao, *pool = jl.mixed_attention(
            *args, *(_j(p) for p in planes), 1, pos, jnp.asarray(table),
            jnp.asarray(span))
    back = []
    for p, like in zip(pool, planes):
        a = np.asarray(p.astype(jnp.float32) if like.dtype == torch.bfloat16
                       else p)
        back.append(torch.from_numpy(a.copy()).to(like.dtype))
    return np.asarray(ao), back


@pytest.mark.parametrize("pages", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("kv_mul", [1, 2, 4, 8])
@pytest.mark.parametrize("t_len", [16, 39])
def test_window_model_matches_the_jax_gather_route(pages, kv_mul, t_len):
    """t_len 16 (a verify window; spec_verify_attention) and 39 (a mixed
    window with spans 39, 1 and 0; mixed_attention, whose padded queries
    are computed like any other), the model under every plan over the
    pool the JAX route wrote and read, within 1e-5."""
    max_pages = 16
    q, planes, table, P = _case(pages, kv_mul, t_len, max_pages,
                                seed=7 * kv_mul + t_len)
    span = None if t_len == 16 else np.asarray([39, 1, 0], np.int32)
    pos = _pos(max_pages)
    want, pool = _jax_gather(pages, q, planes, table, P, pos, kv_mul, span)
    for plan in PLANS:
        got = pa.paged_window_model(torch.from_numpy(q), pool, 1, pos,
                                    torch.from_numpy(table), P, kv_mul, plan)
        np.testing.assert_allclose(got.numpy(), want, atol=ATT_TOL, rtol=0,
                                   err_msg=f"plan {plan}")


@pytest.mark.parametrize("pages", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("kv_mul", [1, 2, 4, 8])
@pytest.mark.parametrize("t_len", [2, 5, 16, 39])
def test_window_model_matches_the_plain_versions(pages, kv_mul, t_len):
    """The model under every plan and an H100's default one against the
    port's plain versions (the CPU route of the wrappers)."""
    max_pages = 16
    q, planes, table, P = _case(pages, kv_mul, t_len, max_pages,
                                seed=3 * kv_mul + t_len)
    q, table = torch.from_numpy(q), torch.from_numpy(table)
    pos = _pos(max_pages)
    pv = torch.tensor(pos, dtype=torch.int32)
    run = (pa.paged_decode_attention_q8 if pages == "q8"
           else pa.paged_decode_attention)
    want = run(q, *planes, 1, pv, table, P, kv_mul)
    default = pa.window_plan(planes[0].shape[2], 3, t_len, kv_mul, SMS)
    for plan in [*PLANS, default]:
        got = pa.paged_window_model(q, planes, 1, pos, table, P, kv_mul,
                                    plan)
        assert (got - want).abs().max().item() <= ATT_TOL, plan


@pytest.mark.parametrize("kv_mul", [1, 2, 4, 8])
@pytest.mark.parametrize("plan", PLANS)
def test_window_model_q8_is_the_f32_route_over_the_dequantized_pool(kv_mul,
                                                                    plan):
    """K7w widens each code exactly and then runs K6w's f32 arithmetic:
    the model's Q8 route gives its f32 route's bits over the pool of the
    dequantized values."""
    q, planes, table, P = _case("q8", kv_mul, 39, 16, seed=kv_mul)
    q, table = torch.from_numpy(q), torch.from_numpy(table)
    deq = [dequantize_q80_planes(planes[0], planes[1]).contiguous(),
           dequantize_q80_planes(planes[2], planes[3]).contiguous()]
    pos = _pos(16)
    assert torch.equal(
        pa.paged_window_model(q, planes, 1, pos, table, P, kv_mul, plan),
        pa.paged_window_model(q, deq, 1, pos, table, P, kv_mul, plan))


@pytest.mark.parametrize("pages", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("plan", PLANS)
def test_window_model_is_invariant_to_page_placement(pages, plan):
    """The same logical keys in other physical pages (and junk in the
    pages no table names) give the same bits."""
    kv_mul, n_kv, max_pages = 2, 2, 16
    P = 3 * max_pages + 1
    k4, v4 = _pool(n_kv, seed=3, P=P)
    table = _table(max_pages, P, seed=5)
    perm = np.random.default_rng(6).permutation(P)
    k4p = np.random.default_rng(7).standard_normal(k4.shape).astype(
        np.float32)
    v4p = np.random.default_rng(8).standard_normal(v4.shape).astype(
        np.float32)
    for layer in range(L):
        rows = layer * P + np.arange(P)
        k4p[layer * P + perm] = k4[rows]
        v4p[layer * P + perm] = v4[rows]
    q = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (3, 16, n_kv * kv_mul * HS)).astype(np.float32))
    pos = _pos(max_pages)
    for layer in range(L):
        a = pa.paged_window_model(q, _planes(k4, v4, pages), layer, pos,
                                  torch.from_numpy(table), P, kv_mul, plan)
        b = pa.paged_window_model(
            q, _planes(k4p, v4p, pages), layer, pos,
            torch.from_numpy(perm[table].astype(np.int32)), P, kv_mul, plan)
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_kv", [1, 8, 32])
@pytest.mark.parametrize("batch", [1, 3, 8, 64])
@pytest.mark.parametrize("t_len", [2, 4, 16, 39])
@pytest.mark.parametrize("kv_mul", [1, 8])
def test_window_plan_and_the_grid(n_kv, batch, t_len, kv_mul):
    """The default plan fills the (item tile x kv head x row) grid to
    WINDOW_BLOCKS_PER_SM blocks an SM within the split cap, and the grid's
    split count, window_want of the clamped virtual plane's keys, covers
    every row's plan; a split is whole tiles and none is empty."""
    warps, groups, tiles = pa.window_tiles(t_len, kv_mul)
    assert 1 <= warps <= pa.WINDOW_WARPS
    assert groups == (2 if warps <= 2 else 1)
    assert pa.window_tiles(t_len, kv_mul, bf16=True)[1] == (
        3 if warps == 1 else groups)
    assert warps * groups <= pa.WINDOW_WARPS
    assert (tiles - 1) * 16 * warps < t_len * kv_mul <= tiles * 16 * warps
    most, least = plan = pa.window_plan(n_kv, batch, t_len, kv_mul, SMS)
    assert least == pa.WINDOW_SPLIT_KEYS
    assert 1 <= most <= attention.DECODE_MAX_SPLITS
    blocks = n_kv * batch * tiles
    assert most == 1 or most * blocks <= pa.WINDOW_BLOCKS_PER_SM * SMS
    for ps, max_pages in ((16, 128), (8, 4), (1, 2048), (16, 1)):
        s_virt = ps * max_pages
        grid = pa.window_want(s_virt, plan)
        for pos in range(0, s_virt, max(1, s_virt // 97)):
            keys = min(pos + t_len - 1, s_virt - 1) + 1
            splits, per = pa.window_splits(keys, plan)
            n_tiles = -(-keys // pa.WINDOW_KEYS)
            assert splits <= grid
            assert (splits - 1) * per < n_tiles <= splits * per


def test_the_window_kernel_source_holds_the_constants():
    """paged_window.cu: keys a tile, warps a block, the split cap it
    shares with the decode walk (flash_decode.cuh), each row's keys at
    the clamp, the plan over tiles and the grid."""
    csrc = Path(pa.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "paged_window.cu").read_text()
    walk = (csrc / "flash_decode.cuh").read_text()
    assert int(re.search(r"constexpr int kKeys = (\d+);", src).group(1)) \
        == pa.WINDOW_KEYS
    assert int(re.search(r"constexpr int kMaxWarps = (\d+);",
                         src).group(1)) == pa.WINDOW_WARPS
    assert int(re.search(r"constexpr int kMaxSplits = (\d+);",
                         walk).group(1)) == attention.DECODE_MAX_SPLITS
    assert "min(pos + a.t_len - 1, s_virt - 1) + 1" in src
    assert "decode_splits(tiles, a.most, a.least_tiles, splits, per)" in src
    assert "decode_want(tiles, a.most, a.least_tiles)" in src
    assert "(least + kKeys - 1) / kKeys" in src
    # the key groups by item warps, as window_tiles has them
    assert ("return warps == 1 ? (KIND == kBf16Pages ? 3 : 2) : warps == 2 ? "
            "2 : 1;" in src)


def test_the_route_cut_and_what_the_window_kernels_take():
    """t_len 1 and 2 stay K6's and K7's split walk (a head size that is a
    multiple of 4; the walk beat the window kernels at t_len 2 over f32
    pages on the H100); windows of 3 queries and more take K6w and K7w:
    a multiple of 8 (the MMA's k8 steps), over Q8 pages of 64 (a head's
    deltas are whole 4-byte words)."""
    assert pa.WINDOW_MIN_T == 3
    for t_len in (1, 2):
        assert pa.supports_paged(16, 1, 4, t_len)
        assert pa.supports_paged(16, 8, 32, t_len, q8=True)
    assert not pa.supports_paged(16, 1, 4, 3)
    assert pa.supports_paged(16, 4, 40, 3)
    assert not pa.supports_paged(16, 4, 36, 4)
    assert pa.supports_paged(16, 8, 64, 39, kv_mul=8, q8=True)
    assert not pa.supports_paged(16, 8, 32, 4, q8=True)
    assert not pa.supports_paged(16, 1, 136, 3)
    windows = {k.symbol for k in pa.WINDOW_KERNELS}
    assert windows == {"paged_window", "paged_window_kvbf16",
                       "paged_window_q8"}
    assert all(k.source == "paged_window.cu" for k in pa.WINDOW_KERNELS)
    assert set(pa.WINDOW_KERNELS) <= set(pa.KERNELS)


@pytest.mark.parametrize("bad", [(attention.DECODE_MAX_SPLITS + 1, 1),
                                 (0, 64), (2, 0)])
def test_a_bad_window_plan_raises(bad):
    q, planes, table, P = _case("f32", 1, 4, 8, seed=1)
    q, table = torch.from_numpy(q), torch.from_numpy(table)
    pos = torch.tensor(_pos(8), dtype=torch.int32)
    with pytest.raises(ValueError, match="plan"):
        pa.paged_decode_attention(q, *planes, 0, pos, table, P, 1, plan=bad)
    with pytest.raises(ValueError, match="plan"):
        pa.paged_window_model(q, planes, 0, _pos(8), table, P, 1, bad)
