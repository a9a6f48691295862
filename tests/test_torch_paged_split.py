"""K6's and K7's keys split across the grid (csrc/paged_attention.cu: K5's
walk with the paged key address) on the CPU: the plain-torch model of the
kernels' split-and-merge arithmetic
(``paged_attention.paged_attention_split_model``: each (row, query)'s live
pages gathered in logical order up to the budget-edge clamp, then
``attention.decode_attention_split_model`` under the plan) against the JAX
package's Pallas ``paged_decode_attention_kernel`` and ``_q8`` in interpret
mode at 1e-5 abs (ATT_TOL, as tests/test_torch_paged_attention.py holds the
plain versions: the same f32 softmax in another order), over f32, bf16 and
Q8 pools, t_len 1, kv_mul 1, 2, 4 and 8 and plans of one to 32 splits; its
own identities bit for bit (page placement, K5's model at t_len 1); the
default plan and the grid's split count; the constants the kernel source
holds; and a bad plan. The card takes windows of t_len 4 and 8 to K6w and
K7w (csrc/paged_window.cu), so those cases hold the window model
(``paged_attention.paged_window_model``) and the window plan instead;
tests/test_torch_paged_window.py holds the window route in full."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.ops import attention
from distributed_llama_tpu_torch.ops import paged_attention as pa
from distributed_llama_tpu_torch.ops.quants import quantize_q80_torch

ATT_TOL = 1e-5
SMS = 132  # an H100's SMs
L, PS, MAX_PAGES, HS = 2, 8, 4, 32
S_VIRT = MAX_PAGES * PS
# one split, and plans that cut 32 keys into 4, 8 and 32 splits
PLANS = [attention.ONE_SPLIT, (2, 8), (4, 4), (32, 1)]
# clocks of three rows: 0, mid-page, and one whose window of up to 8
# queries runs past the virtual plane (the budget-edge clamp)
POS = [0, 13, S_VIRT - 2]
# the kernel's warps a block, and its keys in flight a warp by page kind
# (rows: f32, bf16, Q8) and kv_mul (columns: 1, 2, 4, 8), tools/plan_sweep.py's
# picks: they order the loads, never the sums, so only the source holds them
WARPS = 16
KEYS_AHEAD = [[2, 4, 4, 4], [4, 8, 4, 4], [4, 4, 4, 4]]


def _n_kv(kv_mul):
    return 2 if kv_mul < 8 else 1  # n_q * hs <= 256


def _pool(n_kv, seed, P=13):
    rng = np.random.default_rng(seed)
    shape = (L * P, PS, n_kv, HS)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _table(P=13, seed=1):
    ids = 1 + np.random.default_rng(seed).permutation(P - 1)[:3 * MAX_PAGES]
    return ids.reshape(3, MAX_PAGES).astype(np.int32)


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


def _jax_ref(q, planes, layer, pos, table, P, kv_mul, t_len):
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_paged_attention import (
        paged_decode_attention_kernel, paged_decode_attention_kernel_q8)

    def j(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())

    kernel = (paged_decode_attention_kernel_q8 if len(planes) == 4
              else paged_decode_attention_kernel)
    return np.asarray(kernel(jnp.asarray(q), *(j(p) for p in planes), layer,
                             np.asarray(pos, np.int32), jnp.asarray(table),
                             page_size=PS, n_pages=P, kv_mul=kv_mul,
                             t_len=t_len, interpret=True))


@pytest.mark.parametrize("pages", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("kv_mul", [1, 2, 4, 8])
@pytest.mark.parametrize("t_len", [1, 4, 8])
def test_split_model_matches_pallas_paged(pages, kv_mul, t_len):
    """The model of the route the card takes at t_len (the split walk at
    1, the window model at 4 and 8) under every plan against the Pallas
    kernel over a scrambled table, including the clamp of the last row's
    window."""
    n_kv, P = _n_kv(kv_mul), 13
    k4, v4 = _pool(n_kv, seed=10 * kv_mul + t_len)
    planes = _planes(k4, v4, pages)
    table = _table(P, seed=kv_mul)
    q = np.random.default_rng(t_len + kv_mul).standard_normal(
        (3, t_len, n_kv * kv_mul * HS)).astype(np.float32)
    want = _jax_ref(q, planes, 1, POS, table, P, kv_mul, t_len)
    model = (pa.paged_attention_split_model if t_len == 1
             else pa.paged_window_model)
    for plan in PLANS:
        got = model(torch.from_numpy(q), planes, 1, POS,
                    torch.from_numpy(table), P, kv_mul, plan)
        assert tuple(got.shape) == want.shape == q.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATT_TOL, rtol=0,
                                   err_msg=f"plan {plan}")


@pytest.mark.parametrize("pages", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("plan", PLANS)
def test_split_model_is_invariant_to_page_placement(pages, plan):
    """The same logical keys in other physical pages (and junk in the
    pages no table names) give the same bits."""
    kv_mul, n_kv, P = 2, 2, 13
    k4, v4 = _pool(n_kv, seed=3, P=P)
    table = _table(P, seed=5)
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
        (3, 4, n_kv * kv_mul * HS)).astype(np.float32))
    for layer in range(L):
        a = pa.paged_attention_split_model(
            q, _planes(k4, v4, pages), layer, POS, torch.from_numpy(table),
            P, kv_mul, plan)
        b = pa.paged_attention_split_model(
            q, _planes(k4p, v4p, pages), layer, POS,
            torch.from_numpy(perm[table].astype(np.int32)), P, kv_mul, plan)
        assert torch.equal(a, b)


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_mul", [1, 8])
@pytest.mark.parametrize("plan", PLANS)
def test_split_model_at_t1_is_the_contiguous_split_model(cache, kv_mul,
                                                         plan):
    """A (L*B, S, n_kv, hs) batch cache is also a pool of L*B*S/ps pages:
    at t_len 1 the model over it gives K5's model's bits under the same
    plan, as K6 gives K5's on the card."""
    n_kv, B = _n_kv(kv_mul), 3
    g = torch.Generator().manual_seed(kv_mul)
    k = torch.randn((L * B, S_VIRT, n_kv, HS), generator=g).to(cache)
    v = torch.randn((L * B, S_VIRT, n_kv, HS), generator=g).to(cache)
    q = torch.randn((B, n_kv * kv_mul, HS), generator=g)
    P = B * MAX_PAGES
    table = torch.arange(P, dtype=torch.int32).reshape(B, MAX_PAGES)
    pages = [t.reshape(L * P, PS, n_kv, HS) for t in (k, v)]
    for layer in range(L):
        for pos in (POS, [S_VIRT - 1, 7, 16]):
            k5 = attention.decode_attention_split_model(q, k, v, layer, pos,
                                                        kv_mul, plan)
            k6 = pa.paged_attention_split_model(
                q.reshape(B, 1, -1), pages, layer, pos, table, P, kv_mul,
                plan)
            assert torch.equal(k6.reshape(B, -1), k5)


@pytest.mark.parametrize("n_kv", [1, 8, 32, 64])
@pytest.mark.parametrize("batch", [1, 3, 8, 64])
@pytest.mark.parametrize("t_len", [1, 4, 8])
def test_default_plan_and_the_grid(n_kv, batch, t_len):
    """At t_len 1 the default plan is decode_plan over the B rows (K5's
    plan for the same rows), and the grid's split count, decode_want of
    the clamped virtual plane's keys, covers every row's plan. The windows
    of t_len 4 and 8 take the window plan (kv_mul 1): its grid,
    window_want of the clamped virtual plane's keys, covers every row's
    plan over its deepest query's keys."""
    if t_len > 1:
        plan = pa.window_plan(n_kv, batch, t_len, 1, SMS)
        for ps, max_pages in ((16, 128), (8, 4), (1, 2048), (16, 1)):
            s_virt = ps * max_pages
            grid = pa.window_want(s_virt, plan)
            for pos in range(0, s_virt, max(1, s_virt // 97)):
                keys = min(pos + t_len - 1, s_virt - 1) + 1
                assert pa.window_splits(keys, plan)[0] <= grid
        return
    plan = pa.paged_plan(n_kv, batch, t_len, SMS)
    assert plan == attention.decode_plan(n_kv, batch * t_len, SMS)
    if t_len == 1:
        assert plan == attention.decode_plan(n_kv, batch, SMS)
    for ps, max_pages in ((16, 128), (8, 4), (1, 2048), (16, 1)):
        s_virt = ps * max_pages
        grid = attention.decode_want(s_virt, plan)
        for pos in range(0, s_virt, max(1, s_virt // 97)):
            for i in range(t_len):
                keys = min(pos + i, s_virt - 1) + 1
                assert attention.decode_splits(keys, plan)[0] <= grid


def test_the_kernel_source_holds_the_constants():
    """paged_attention.cu and the walk it shares (flash_decode.cuh): the
    warps a block, the split cap, the keys-ahead table by page kind and
    kv_mul, each (row, query)'s key count at the clamp and the grid."""
    csrc = Path(pa.__file__).resolve().parent.parent / "csrc"
    walk = (csrc / "flash_decode.cuh").read_text()
    src = (csrc / "paged_attention.cu").read_text()
    warps = re.search(r"constexpr int kWarps = (\d+);", walk)
    assert warps and int(warps.group(1)) == WARPS
    cap = re.search(r"constexpr int kMaxSplits = (\d+);", walk)
    assert cap and int(cap.group(1)) == attention.DECODE_MAX_SPLITS
    table = re.search(r"kPagedAhead\[3\]\[4\] = \{(.*?)\};", src, re.S)
    rows = re.findall(r"\{([\d,\s]+)\}", table.group(1))
    assert [[int(x) for x in r.split(",")] for r in rows] == KEYS_AHEAD
    assert ("min(__ldg(a.pos + b) + i, a.max_pages * a.ps - 1) + 1"
            in src)
    assert "decode_splits(keys, a.most, a.least, splits, per)" in src
    assert "decode_want(a.max_pages * a.ps, a.most, a.least)" in src


@pytest.mark.parametrize("bad", [(attention.DECODE_MAX_SPLITS + 1, 1),
                                 (0, 64), (2, 0)])
def test_a_bad_plan_raises(bad):
    n_kv, P = 2, 13
    planes = _planes(*_pool(n_kv, seed=1), "f32")
    q = torch.zeros((3, 1, n_kv * HS))
    pos = torch.tensor(POS, dtype=torch.int32)
    table = torch.from_numpy(_table(P))
    with pytest.raises(ValueError, match="plan"):
        pa.paged_decode_attention(q, *planes, 0, pos, table, P, 1, plan=bad)
    with pytest.raises(ValueError, match="plan"):
        pa.paged_decode_attention_q8(q, *_planes(*_pool(n_kv, seed=1), "q8"),
                                     0, pos, table, P, 1, plan=bad)
    with pytest.raises(ValueError, match="plan"):
        pa.paged_attention_split_model(q, planes, 0, POS, table, P, 1, bad)
