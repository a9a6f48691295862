"""The Q40 layout probe's P2 and P4 (tools/nb_probe.py, csrc/nb_probe.cu),
rebuilt on K1's tensor-core skeleton, on the CPU:

* P2's pre-laid x (``lay_x``): its three bf16 pieces sum back to x exactly,
  and its 16-byte chunks sit in the B-fragment order K1 stages in shared
  memory (csrc/q40_matvec.cuh), modelled here chunk by chunk;
* P4's signed widening (``widen_signed``, the kernel's SignedCodes step by
  step) gives (lo - 8, hi - 8) of every one of the 256 code bytes;
* P2's and P4's split models (``probe_xglobal_split_model``,
  ``probe_signed_split_model``) equal ``ops/q40.q40_matmul_split_model``,
  K1's arithmetic, bit for bit at small and ragged shapes, as the kernels
  must return K1's bits;
* both split models agree with the JAX probe's ``_k_v0r`` and ``_k_i4``
  bodies run in interpret mode, within 1e-5 x max|JAX|
  (tests/test_torch_nb_probe.py's bound).

All inputs are numpy from a seed; torch runs on one intra-op thread."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.io.loader import Q40Weight
from distributed_llama_tpu_torch.ops import q40
from distributed_llama_tpu_torch.tools import nb_probe

ROOT = Path(__file__).resolve().parents[1]
# (d, nb): rows off K1's 32-row tiles, block counts off its 8-block stages
SHAPES = [(7, 2), (33, 37), (40, 129), (64, 16)]
TOL = 1e-5  # |port - JAX| <= TOL x max|JAX|: f32, another summation order


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_nb_probe", ROOT / "tools" / "nb_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(d, nb, seed):
    """One layer in the JAX probe's nb-major layout (codes (1, 16, nb, d),
    f16-valued f32 scales (1, nb, d)), x, and the same layer in K1's."""
    rng = np.random.default_rng(seed)
    qs_t = rng.integers(0, 256, (1, 16, nb, d), dtype=np.uint8)
    scale = rng.uniform(0.005, 0.02, (1, nb, d)).astype(np.float16)
    scale = scale.astype(np.float32)
    x = rng.standard_normal(nb * 32).astype(np.float32)
    w = nb_probe.layer(nb_probe.from_nb_major(qs_t, scale), 0)
    return qs_t, scale, x, w


def test_lay_x_sums_back_and_holds_k1s_staging_order():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        32 * 37).astype(np.float32))
    laid = nb_probe.lay_x(x)
    assert laid.dtype == torch.bfloat16 and laid.shape == (37, 3, 4, 8)
    assert laid.numel() * 2 == 37 * 3 * 64
    p0, p1, p2 = nb_probe.unlay_x(laid)
    assert torch.equal(p0 + (p1 + p2 / 256.0) / 256.0, x.reshape(37, 32))
    assert torch.equal(p0 + p1 / 256.0 + p2 / 65536.0, x.reshape(37, 32))
    # K1's staging: chunk ((b * C + 3t + p) * 4 + c), T = 1, C = 3, holds
    # piece p of values 4c..4c+3, then 16+4c..16+4c+3, of block b
    pieces = [p.reshape(37, 32) for p in q40.bf16_split3(x)]
    chunks = laid.reshape(-1, 8).to(torch.float32)
    for b in range(37):
        for p in range(3):
            for c in range(4):
                want = torch.cat([pieces[p][b, 4 * c:4 * c + 4],
                                  pieces[p][b, 16 + 4 * c:20 + 4 * c]])
                assert torch.equal(chunks[(b * 3 + p) * 4 + c], want)


def test_signed_widening_is_exact_over_every_byte():
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    lo, hi = nb_probe.widen_signed(nb_probe.to_signed(codes))
    assert torch.equal(lo, (codes & 0xF).to(torch.float32) - 8.0)
    assert torch.equal(hi, (codes >> 4).to(torch.float32) - 8.0)
    # every operand an exact bf16: widening gives what the MMA reads
    for v in (lo, hi):
        assert torch.equal(v.to(torch.bfloat16).to(torch.float32), v)


@pytest.mark.parametrize("d,nb", SHAPES)
def test_split_models_give_k1s_bits(d, nb):
    _, _, x, w = _inputs(d, nb, seed=d + nb)
    xt = torch.from_numpy(x)
    want = q40.q40_matmul_split_model(w, xt[None])[0]
    p2 = nb_probe.probe_xglobal_split_model(w, nb_probe.lay_x(xt))
    ws = Q40Weight(nb_probe.to_signed(w.qs), w.d16)
    p4 = nb_probe.probe_signed_split_model(ws, xt)
    assert p2.shape == p4.shape == want.shape == (d,)
    assert torch.equal(p2, want)
    assert torch.equal(p4, want)


def _jax_body(m, name, qs_t, scale, x):
    """The JAX probe's _k_v0r or _k_i4 on layer 0 in interpret mode, with
    its own x preparation (as tests/test_torch_nb_probe.py runs them)."""
    from distributed_llama_tpu.ops.pallas_q40 import _pick_rows_nb, _split_x

    _, _, nb, d = qs_t.shape
    L = jnp.zeros((1,), jnp.int32)
    xlo, xhi = _split_x(jnp.asarray(x)[None], nb)     # (16, 1, nb)
    if name == "i4":
        q = jnp.asarray(qs_t)
        lo = (q & 0xF).astype(jnp.int32) - 8
        hi = (q >> 4).astype(jnp.int32) - 8
        qs4 = jnp.concatenate([lo, hi], axis=1).astype(jnp.int4)
        x32 = jnp.transpose(jnp.concatenate([xlo, xhi], axis=0), (0, 2, 1))
        out = m._call_i4(L, qs4, jnp.asarray(scale), x32,
                         rows=_pick_rows_nb(d, nb), interpret=True)
        return np.asarray(out).ravel()
    xlo = jnp.transpose(xlo, (0, 2, 1))               # (16, nb, 1)
    xhi = jnp.transpose(xhi, (0, 2, 1))
    xsum = jnp.sum(xlo[:, :, 0] + xhi[:, :, 0], axis=0)[:, None]
    xlo = jnp.broadcast_to(xlo, (16, nb, 128)) + 0.0
    xhi = jnp.broadcast_to(xhi, (16, nb, 128)) + 0.0
    out = m._call_classic(m._k_v0r, L, jnp.asarray(qs_t), jnp.asarray(scale),
                          xlo, xhi, xsum, rows=128, interpret=True)
    return np.asarray(out).ravel()


@pytest.mark.parametrize("name", ["v0r", "i4"])
def test_split_models_match_the_jax_pallas_bodies(jax_probe, name):
    d, nb = 256, 16  # the JAX bodies' row tiles: 128-row multiples
    qs_t, scale, x, w = _inputs(d, nb, seed=len(name))
    want = _jax_body(jax_probe, name, qs_t, scale, x)
    xt = torch.from_numpy(x)
    if name == "v0r":
        got = nb_probe.probe_xglobal_split_model(w, nb_probe.lay_x(xt))
    else:
        ws = Q40Weight(nb_probe.to_signed(w.qs), w.d16)
        got = nb_probe.probe_signed_split_model(ws, xt)
    assert got.shape == want.shape == (d,)
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), err


def test_laid_wrapper_takes_the_split_model_on_the_cpu():
    """probe_xglobal_laid on CPU tensors is its plain version, P2's split
    model, and so K1's model bits; probe_xglobal and probe_signed keep the
    f32 plain bodies (held to JAX in tests/test_torch_nb_probe.py)."""
    _, _, x, w = _inputs(40, 37, seed=5)
    xt = torch.from_numpy(x)
    assert torch.equal(nb_probe.probe_xglobal_laid(w, nb_probe.lay_x(xt)),
                       q40.q40_matmul_split_model(w, xt[None])[0])
    assert torch.equal(nb_probe.probe_xglobal(w, xt),
                       nb_probe.probe_xglobal_plain(w, xt))
    ws = Q40Weight(nb_probe.to_signed(w.qs), w.d16)
    assert torch.equal(nb_probe.probe_signed(ws, xt),
                       nb_probe.probe_signed_plain(ws, xt))
