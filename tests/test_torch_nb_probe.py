"""The port's Q40 layout probe (tools/nb_probe.py, B10) against the JAX
package's tools/nb_probe.py: each plain body (dma, v0, v0r, v1, i4) equals
the JAX Pallas body run in interpret mode on the same codes, scales and x,
carried across with ``from_nb_major`` and ``to_signed``; and the probe's
``main`` on the CPU runs every variant through its parity gate and chain
and prints no time."""

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
SHAPES = {"tiny": (256, 256), "384x512": (384, 512)}
# |port - JAX| <= TOL x max|JAX|: both f32, summed in another order; v1
# multiplies raw codes up to 255, so its sums cancel more
TOL = {"v1": 1e-4}
TOL_DEFAULT = 1e-5


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_nb_probe", ROOT / "tools" / "nb_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(d, n, seed):
    """One layer in the JAX probe's nb-major layout, scales drawn as f16
    values, and x."""
    rng = np.random.default_rng(seed)
    nb = n // 32
    qs_t = rng.integers(0, 256, (1, 16, nb, d), dtype=np.uint8)
    scale = rng.uniform(0.005, 0.02, (1, nb, d)).astype(np.float16)
    x = rng.standard_normal(n).astype(np.float32)
    return qs_t, scale.astype(np.float32), x


def _jax_body(m, name, qs_t, scale, x):
    """The JAX probe's body ``name`` on layer 0 in interpret mode, with its
    own per-variant x preparation (its run_variant's prep_x)."""
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
    rows = _pick_rows_nb(d, nb)
    if name == "v1":
        xhi = xhi - 16.0 * xlo
    if name == "v0r":
        xlo = jnp.broadcast_to(xlo, (16, nb, 128)) + 0.0
        xhi = jnp.broadcast_to(xhi, (16, nb, 128)) + 0.0
        rows = 128
    kernel = {"dma": m._k_dma, "v0": m._k_v0, "v1": m._k_v1,
              "v0r": m._k_v0r}[name]
    out = m._call_classic(kernel, L, jnp.asarray(qs_t), jnp.asarray(scale),
                          xlo, xhi, xsum, rows=rows, interpret=True)
    return np.asarray(out).ravel()


def _port_body(name, qs_t, scale, x):
    w = nb_probe.layer(nb_probe.from_nb_major(qs_t, scale), 0)
    xt = torch.from_numpy(x)
    if name == "dma":
        out = nb_probe.probe_stream(w)
    elif name == "v0":
        out = q40.q40_matmul(w, xt[None])[0]
    elif name == "v0r":
        out = nb_probe.probe_xglobal(w, xt)
    elif name == "v1":
        out = nb_probe.probe_nomask(w, nb_probe.prep_nomask(xt))
    else:
        out = nb_probe.probe_signed(Q40Weight(nb_probe.to_signed(w.qs),
                                              w.d16), xt)
    return out.numpy()


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", ["dma", "v0", "v0r", "v1", "i4"])
def test_plain_bodies_match_the_jax_pallas_bodies(jax_probe, name, shape):
    d, n = SHAPES[shape]
    qs_t, scale, x = _inputs(d, n, seed=len(name) + d)
    want = _jax_body(jax_probe, name, qs_t, scale, x)
    got = _port_body(name, qs_t, scale, x)
    assert got.shape == want.shape == (d,)
    err = np.abs(got - want).max()
    assert err <= TOL.get(name, TOL_DEFAULT) * np.abs(want).max(), err


def test_layout_converters():
    qs_t, scale, _ = _inputs(64, 96, seed=0)
    w = nb_probe.from_nb_major(qs_t, scale)
    assert w.qs.shape == (1, 64, 3, 16) and w.qs.dtype == torch.uint8
    assert w.d16.shape == (1, 64, 3) and w.d16.dtype == torch.float16
    # code byte j of block b of row r is plane j's (b, r) entry
    assert w.qs[0, 5, 2, 7] == qs_t[0, 7, 2, 5]
    assert w.d16[0, 5, 2].item() == scale[0, 2, 5]
    with pytest.raises(ValueError, match="exact f16"):
        nb_probe.from_nb_major(qs_t, scale + np.float32(1e-7))
    signed = nb_probe.to_signed(w.qs)
    assert torch.equal(nb_probe.to_signed(signed), w.qs)
    # every code's signed nibble is code - 8
    codes = torch.arange(256, dtype=torch.uint8)
    lo = nb_probe._signed_nibbles(nb_probe.to_signed(codes) & 0xF)
    hi = nb_probe._signed_nibbles(nb_probe.to_signed(codes) >> 4)
    assert torch.equal(lo, (codes & 0xF).to(torch.int16) - 8)
    assert torch.equal(hi, (codes >> 4).to(torch.int16) - 8)


def test_plain_bodies_hold_the_float64_references():
    """Every variant's plain body passes the probe's own parity gate at a
    width with a ragged block count, and the stream body equals its exact
    integer reference."""
    w = nb_probe.synth(2, 40, 32 * 37, "cpu", seed=3)
    x = torch.randn(32 * 37, generator=torch.Generator().manual_seed(2))
    for name in nb_probe.VARIANTS:
        call = nb_probe._caller(name, w)
        assert nb_probe.parity(name, w, x, call) < 2e-5, name
    want = nb_probe.ref_stream(w.qs[1].numpy(), w.d16[1].numpy())
    got = nb_probe.probe_stream(nb_probe.layer(w, 1)).double().numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_wrappers_raise_off_cpu_and_cuda():
    """No fallback: a tensor that lies neither on the CPU nor on a card
    gets no plain version."""
    w = Q40Weight(torch.zeros((8, 2, 16), dtype=torch.uint8, device="meta"),
                  torch.zeros((8, 2), dtype=torch.float16, device="meta"))
    x = torch.zeros(64, device="meta")
    for fn, args in ((nb_probe.probe_stream, (w,)),
                     (nb_probe.probe_xglobal, (w, x)),
                     (nb_probe.probe_nomask, (w, x)),
                     (nb_probe.probe_signed, (w, x))):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fn(*args)


def test_main_on_the_cpu_runs_every_variant_and_prints_no_time(capsys):
    assert nb_probe.main(["--shape", "tiny", "--device", "cpu", "--layers",
                          "2", "--reps", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(nb_probe.VARIANTS)
    for name, line in zip(nb_probe.VARIANTS, lines):
        assert line.split()[1] == name
        assert "4 chained calls" in line
        assert line.count("not measured (cpu)") == 1
        assert "ms/call" not in line and "GB/s" not in line


def test_main_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert nb_probe.main(["--shape", "tiny"]) == 1
    assert "no GPU" in capsys.readouterr().err


def test_main_rejects_unknown_variants(capsys):
    with pytest.raises(SystemExit):
        nb_probe.main(["--device", "cpu", "--variants", "dma,v9"])
