"""K8 and K9 (csrc/fused_layer.cu: the fused decode layer's head and tail,
their weights streamed through per-warp shared-memory rings) on the card:
P0's bits, K10's bits, the same bits on a second launch and in a CUDA-graph
replay, the barrier's count back at 0, and the plain version's values, at
every shape of tests/test_torch_cuda.py's FUSED_SHAPES (hidden widths whose
w2 rows hold 22, 43 and 88 Q40 blocks: scales that start off a 16-byte
boundary) and at Llama-2-7B's and 70B's widths. Every test takes the
``gen`` fixture, which skips it without a GPU; on one, run

    python -m pytest --noconftest tests/test_torch_fused_ring.py
"""

import pytest
import torch

from distributed_llama_tpu_torch.io.loader import Q40Weight
from distributed_llama_tpu_torch.models.spec import TransformerSpec
from distributed_llama_tpu_torch.ops import layer, q40
from distributed_llama_tpu_torch.ops.linear import rmsnorm
from distributed_llama_tpu_torch.ops.quants import FloatType

# (dim, hidden_dim, n_heads, n_kv_heads): tests/test_torch_cuda.py's
# FUSED_SHAPES, then Llama-2-7B's and 70B's layers
SHAPES = [(256, 704, 2, 2), (512, 1376, 8, 4), (512, 1376, 8, 2),
          (1024, 2816, 8, 1), (256, 11008, 2, 2), (256, 28672, 2, 2),
          (4096, 11008, 32, 32), (8192, 28672, 64, 8)]
SEQ = 64


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, dim, hid, n_heads, n_kv):
    lw = layer.random_layer(dim, hid, n_heads, n_kv, "cuda", gen)
    x = torch.randn((1, dim), device="cuda", generator=gen)
    return lw, x


def _close(got, want, rtol=q40.KERNEL_RTOL):
    err = (got - want).abs().max().item()
    assert err <= rtol * want.abs().max().item(), err


def _staged(x, lw):
    """K8's staged rmsnorm(x, rms_att), read back bit for bit through a
    wqkv of one-hot rows (layer.readback_q40) at pos 0, where RoPE turns
    by cos 0 = 1 and sin 0 = 0 exactly."""
    d, nb = lw["wqkv"].qs.shape[:2]
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    return layer.q40_head_fused(x, layer.readback_q40(d, nb * 32, "cuda"),
                                lw["rms_att"], lw["freq"], zero)[0, :nb * 32]


def _rows(w, lo, hi):
    return Q40Weight(w.qs[lo:hi], w.d16[lo:hi])


@pytest.mark.parametrize("shape", SHAPES)
def test_head_rows_have_p0_bits(gen, shape):
    """K8's rows give the classic row body's bits (the Q40 layout probe's
    P0) on the vector it staged: at pos 0 every row equals P0(wqkv, xs), at
    pos 63 the v rows (unrotated) do, xs being K8's own rmsnorm(x, rms_att)
    (read back through one-hot rows), itself within the Q40 tolerance of
    the plain rmsnorm; the whole head within it of the plain head."""
    from distributed_llama_tpu_torch.tools import nb_probe

    dim, hid, n_heads, n_kv = shape
    lw, x = _inputs(gen, *shape)
    xs = _staged(x, lw)
    _close(xs, rmsnorm(x, lw["rms_att"])[0])
    d = lw["wqkv"].qs.shape[0]
    n_rot = 2 * lw["freq"].numel()
    for pos in (0, 63):
        p = torch.tensor([pos], dtype=torch.int32, device="cuda")
        before = layer.HEAD_KERNEL.launches
        got = layer.q40_head_fused(x, lw["wqkv"], lw["rms_att"], lw["freq"],
                                   p)[0]
        assert layer.HEAD_KERNEL.launches == before + 1
        if pos == 0:
            assert torch.equal(got, nb_probe.probe_classic(lw["wqkv"], xs))
        assert torch.equal(got[n_rot:], nb_probe.probe_classic(
            _rows(lw["wqkv"], n_rot, d), xs))
        _close(got[None], layer.q40_head_fused_plain(
            x, lw["wqkv"], lw["rms_att"], lw["freq"], p))


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[0] // s[2] == 128])
def test_head_gives_k10s_bits(gen, shape):
    """Where K10 serves the layer (head size 128), K8's q rows equal K10's
    q scratch and its k and v rows the f32 cache row K10 wrote at (layer 1,
    pos), bit for bit, for the same x: one staging, one row body, one
    RoPE."""
    dim, hid, n_heads, n_kv = shape
    spec = TransformerSpec(dim=dim, hidden_dim=hid, n_layers=2,
                           n_heads=n_heads, n_kv_heads=n_kv, vocab_size=300,
                           seq_len=SEQ, weights_float_type=FloatType.Q40)
    assert layer.mega_supported(spec)
    lw, x = _inputs(gen, *shape)
    hs, kv_dim = spec.head_size, spec.kv_dim
    k = torch.randn((2, SEQ, n_kv, hs), device="cuda", generator=gen)
    v = torch.randn((2, SEQ, n_kv, hs), device="cuda", generator=gen)
    s = layer._scratch(x.device, dim, hid)
    for pos in (0, 5, 63):
        p = torch.tensor([pos], dtype=torch.int32, device="cuda")
        layer.q40_layer_mega(x, lw["wqkv"], lw["wo"], lw["w13"], lw["w2"],
                             lw["rms_att"], lw["rms_ffn"], lw["freq"], k, v,
                             1, p, n_heads // n_kv)
        head = layer.q40_head_fused(x, lw["wqkv"], lw["rms_att"], lw["freq"],
                                    p)[0]
        assert torch.equal(head[:dim], s.q), pos
        assert torch.equal(head[dim:dim + kv_dim], k[1, pos].reshape(-1)), pos
        assert torch.equal(head[dim + kv_dim:], v[1, pos].reshape(-1)), pos


@pytest.mark.parametrize("shape", SHAPES[-2:])
def test_tail_at_full_width_has_p0_bits(gen, shape):
    """K9 at 7B's and 70B's widths (70B's rings sit beside its 129 KB
    staged hb): within the Q40 tolerance of plain, its wo and w2
    rows with P0's bits (xnew = x + P0(wo, ao), out = xnew + P0(w2, hb)),
    the barrier's arrival count back at 0."""
    from distributed_llama_tpu_torch.tools import nb_probe

    dim, hid = shape[:2]
    lw, x = _inputs(gen, *shape)
    ao = torch.randn(x.shape, device="cuda", generator=gen)
    args = (lw["wo"], lw["w13"], lw["w2"], lw["rms_ffn"])
    got = layer.q40_tail_fused(ao, x, *args)
    _close(got, layer.q40_tail_fused_plain(ao, x, *args))
    s = layer._scratch(x.device, dim, hid)
    assert torch.equal(s.xnew[None], x + nb_probe.probe_classic(
        lw["wo"], ao[0])[None])
    assert torch.equal(got, s.xnew[None] + nb_probe.probe_classic(
        lw["w2"], s.hb.clone())[None])
    assert s.bar[0].item() == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_head_and_tail_give_the_same_bits_twice_and_replayed(gen, shape):
    """A second launch and a CUDA-graph replay (device pos, static
    scratch) give the first launch's bits; the tail leaves the barrier's
    arrival count at 0 each time."""
    dim, hid = shape[:2]
    lw, x = _inputs(gen, *shape)
    ao = torch.randn(x.shape, device="cuda", generator=gen)
    p = torch.tensor([63], dtype=torch.int32, device="cuda")
    head_args = (lw["wqkv"], lw["rms_att"], lw["freq"])
    tail_args = (lw["wo"], lw["w13"], lw["w2"], lw["rms_ffn"])
    head = layer.q40_head_fused(x, *head_args, p)
    tail = layer.q40_tail_fused(ao, x, *tail_args)
    assert torch.equal(layer.q40_head_fused(x, *head_args, p), head)
    assert torch.equal(layer.q40_tail_fused(ao, x, *tail_args), tail)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h_out = layer.q40_head_fused(x, *head_args, p)
        t_out = layer.q40_tail_fused(ao, x, *tail_args)
    s = layer._scratch(x.device, dim, hid)
    for pos in (63, 7):
        p.fill_(pos)
        graph.replay()
        torch.cuda.synchronize()
        assert s.bar[0].item() == 0, pos
        assert torch.equal(h_out, layer.q40_head_fused(x, *head_args, p))
        assert torch.equal(t_out, tail)


def test_rings_read_weights_whose_scales_start_off_16_bytes(gen):
    """Weights that are views starting one row into their storage, at a
    width of 11 Q40 blocks (and w2's 22), so their scales start 22 or 44
    bytes past a 16-byte boundary and every row's scales sit off one: the
    rings round each scale copy down to 16 bytes and cut the last at the
    weight's end. K8 and K9 stay within the Q40 tolerance of plain, K9's w2
    rows with P0's bits."""
    from distributed_llama_tpu_torch.tools import nb_probe

    dim, hid, n_heads, n_kv = 352, 704, 2, 2
    lw, x = _inputs(gen, dim, hid, n_heads, n_kv)
    d = lw["wqkv"].qs.shape[0]
    wqkv = _rows(q40.random_q40(d + 1, dim, "cuda", gen), 1, d + 1)
    w2 = _rows(q40.random_q40(dim + 1, hid, "cuda", gen), 1, dim + 1)
    assert wqkv.d16.data_ptr() % 16 and w2.d16.data_ptr() % 16
    p = torch.tensor([9], dtype=torch.int32, device="cuda")
    _close(layer.q40_head_fused(x, wqkv, lw["rms_att"], lw["freq"], p),
           layer.q40_head_fused_plain(x, wqkv, lw["rms_att"], lw["freq"], p))
    ao = torch.randn(x.shape, device="cuda", generator=gen)
    args = (lw["wo"], lw["w13"], w2, lw["rms_ffn"])
    got = layer.q40_tail_fused(ao, x, *args)
    _close(got, layer.q40_tail_fused_plain(ao, x, *args))
    s = layer._scratch(x.device, dim, hid)
    assert torch.equal(got, s.xnew[None] + nb_probe.probe_classic(
        w2, s.hb.clone())[None])
    assert s.bar[0].item() == 0


def test_rings_stage_vectors_wider_than_a_threads_registers(gen):
    """At dim 9216 (2304 float4s, past 4 a thread x 512 threads) K8's and
    K9's rmsnorm staging reads x twice instead of keeping it in registers:
    both stay within the Q40 tolerance of plain, K8's v rows and K9's wo
    and w2 rows with P0's bits."""
    from distributed_llama_tpu_torch.tools import nb_probe

    shape = (9216, 256, 72, 72)
    lw, x = _inputs(gen, *shape)
    xs = _staged(x, lw)
    _close(xs, rmsnorm(x, lw["rms_att"])[0])
    d = lw["wqkv"].qs.shape[0]
    n_rot = 2 * lw["freq"].numel()
    p = torch.tensor([63], dtype=torch.int32, device="cuda")
    got = layer.q40_head_fused(x, lw["wqkv"], lw["rms_att"], lw["freq"], p)
    _close(got, layer.q40_head_fused_plain(x, lw["wqkv"], lw["rms_att"],
                                           lw["freq"], p))
    assert torch.equal(got[0, n_rot:], nb_probe.probe_classic(
        _rows(lw["wqkv"], n_rot, d), xs))
    ao = torch.randn(x.shape, device="cuda", generator=gen)
    args = (lw["wo"], lw["w13"], lw["w2"], lw["rms_ffn"])
    out = layer.q40_tail_fused(ao, x, *args)
    _close(out, layer.q40_tail_fused_plain(ao, x, *args))
    s = layer._scratch(x.device, *shape[:2])
    assert torch.equal(s.xnew[None], x + nb_probe.probe_classic(
        lw["wo"], ao[0])[None])
    assert torch.equal(out, s.xnew[None] + nb_probe.probe_classic(
        lw["w2"], s.hb.clone())[None])


def test_rings_refuse_misaligned_vectors(gen):
    """The float4 staging reads x and rms_att (K8), ao and rms_ffn (K9):
    a vector off a 16-byte boundary raises rather than launching."""
    lw, x = _inputs(gen, 256, 704, 2, 2)
    wide = torch.randn((1, 257), device="cuda", generator=gen)
    p = torch.tensor([3], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        layer.q40_head_fused(wide[:, 1:], lw["wqkv"], lw["rms_att"],
                             lw["freq"], p)
    with pytest.raises(ValueError, match="16-byte aligned"):
        layer.q40_tail_fused(wide[:, 1:], x, lw["wo"], lw["w13"], lw["w2"],
                             lw["rms_ffn"])
