"""io/kernel_cache.py, the port's device-layout sidecar (the JAX package's
io/kernel_cache.py, for the port's tree):

* the written tree reads back bit for bit, wqkv and w13 fused, and the
  device tree of a warm load equals a cold one's;
* a key mismatch (the .bin rewritten) or a damaged file rebuilds;
* DLLAMA_TILED_CACHE: '0' skips the sidecar, '1' turns it on anywhere,
  unset it is on for a CUDA device only;
* the build lock skips a concurrent write, and a stale lock is broken;
* the CLI's stream from a warm load equals the JAX CLI's on the fixture
  model, and a JAX sidecar (``<model>.kcache``) is neither read nor
  overwritten.
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch
from test_torch_cli import model_files  # noqa: F401

from distributed_llama_tpu_torch.io import kernel_cache as kc
from distributed_llama_tpu_torch.io.loader import Q40Weight
from distributed_llama_tpu_torch.models.llama import params_to_device
from distributed_llama_tpu_torch.ops.linear import FUSED_LOAD
from distributed_llama_tpu_torch.ops.quants import FloatType

Q40 = FloatType.Q40
F32 = FloatType.F32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def model(model_files, tmp_path, monkeypatch):  # noqa: F811
    """A private copy of the fixture model (its sidecar is this test's),
    with the sidecar switched on for the CPU."""
    path = str(tmp_path / "model.bin")
    shutil.copy(model_files[0], path)
    monkeypatch.setenv("DLLAMA_TILED_CACHE", "1")
    return path


def _same_tree(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], Q40Weight):
            for x, y in zip(a[k], b[k]):
                assert torch.equal(x, y), k
        else:
            assert torch.equal(a[k], b[k]), k


def test_round_trip_is_bit_exact(model, capfd):
    spec, cold = kc.load_model_packed(model, Q40, F32, "cpu")
    assert "device-layout cache written" in capfd.readouterr().err
    assert os.path.exists(kc.sidecar_path(model))
    assert kc.sidecar_path(model) == model + ".tkcache"
    spec2, warm = kc.load_model_packed(model, Q40, F32, "cpu")
    assert "device-layout cache hit" in capfd.readouterr().err
    assert spec2 == spec
    assert "wqkv" in warm and "w13" in warm and "wq" not in warm
    for dst, parts in FUSED_LOAD.items():
        for field in ("qs", "d16"):
            want = np.concatenate([getattr(cold[p], field) for p in parts],
                                  axis=1)
            assert np.array_equal(getattr(warm[dst], field), want)
    for k in ("tok_embedding", "rms_att", "rms_ffn", "rms_final"):
        assert np.array_equal(warm[k], cold[k])
    for k in ("wo", "w2", "wcls"):
        assert np.array_equal(warm[k].qs, cold[k].qs)
        assert np.array_equal(warm[k].d16, cold[k].d16)
    _same_tree(params_to_device(warm, "cpu"), params_to_device(cold, "cpu"))


def test_key_mismatch_and_damage_rebuild(model, capfd):
    kc.load_model_packed(model, Q40, F32, "cpu")
    side = kc.sidecar_path(model)
    key = kc.layout_key(model, Q40, F32)
    assert kc.load_packed(side, key) is not None
    assert kc.load_packed(side, key + "x") is None
    capfd.readouterr()
    # the .bin rewritten (a new mtime): the key changes, the load rebuilds
    st = os.stat(model)
    os.utime(model, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    _, tree = kc.load_model_packed(model, Q40, F32, "cpu")
    err = capfd.readouterr().err
    assert "key mismatch" in err and "cache written" in err
    assert "wq" in tree  # the .bin was read
    _, tree = kc.load_model_packed(model, Q40, F32, "cpu")
    assert "wqkv" in tree
    capfd.readouterr()
    # a truncated sidecar, then one with a bad magic: both rebuild
    with open(side, "r+b") as fh:
        fh.truncate(os.path.getsize(side) // 2)
    _, tree = kc.load_model_packed(model, Q40, F32, "cpu")
    assert "unreadable" in capfd.readouterr().err and "wq" in tree
    with open(side, "r+b") as fh:
        fh.write(b"NOTMAGIC")
    _, tree = kc.load_model_packed(model, Q40, F32, "cpu")
    assert "wq" in tree and "cache written" in capfd.readouterr().err
    _, tree = kc.load_model_packed(model, Q40, F32, "cpu")
    assert "wqkv" in tree


def test_the_switch(model, monkeypatch):
    monkeypatch.setenv("DLLAMA_TILED_CACHE", "0")
    assert not kc.cache_enabled("cuda") and not kc.cache_enabled("cpu")
    _, tree = kc.load_model_packed(model, Q40, F32, "cuda")
    assert "wq" in tree and not os.path.exists(kc.sidecar_path(model))
    monkeypatch.delenv("DLLAMA_TILED_CACHE")
    assert kc.cache_enabled("cuda") and kc.cache_enabled("cuda:0")
    assert not kc.cache_enabled("cpu")
    kc.load_model_packed(model, Q40, F32, "cpu")
    assert not os.path.exists(kc.sidecar_path(model))
    monkeypatch.setenv("DLLAMA_TILED_CACHE", "1")
    assert kc.cache_enabled("cpu")


def test_build_lock_skips_a_concurrent_write(model, capfd):
    side = kc.sidecar_path(model)
    lock = kc.try_build_lock(side)
    assert lock is not None and kc.try_build_lock(side) is None
    _, tree = kc.load_model_packed(model, Q40, F32, "cpu")
    assert "another process is writing" in capfd.readouterr().err
    assert not os.path.exists(side) and "wq" in tree
    kc.release_build_lock(lock)
    kc.load_model_packed(model, Q40, F32, "cpu")
    assert os.path.exists(side) and not os.path.exists(side + ".lock")


def test_a_stale_lock_is_broken(model):
    side = kc.sidecar_path(model)
    with open(side + ".lock", "w") as fh:
        fh.write("12345\n")
    old = time.time() - 2 * kc._LOCK_STALE_S
    os.utime(side + ".lock", (old, old))
    kc.load_model_packed(model, Q40, F32, "cpu")
    assert os.path.exists(side) and not os.path.exists(side + ".lock")
    assert not [n for n in os.listdir(os.path.dirname(side))
                if ".stale" in n or ".tmp" in n]


def test_warm_cli_stream_equals_the_jax_cli(model, model_files,  # noqa: F811
                                            capsys):
    """The port's CLI loads through the sidecar (cold writes, warm reads)
    and both streams are the JAX CLI's; the JAX package's sidecar beside
    the model is neither read nor overwritten."""
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu.io import kernel_cache as jkc
    from distributed_llama_tpu.io.loader import load_model as jload
    from distributed_llama_tpu.ops.quants import FloatType as JFT

    from distributed_llama_tpu_torch.frontend.cli import main

    # a JAX sidecar of this model, in the JAX package's own format
    _, tree = jload(model, weights_float_type=JFT.Q40)
    jside = jkc.sidecar_path(model)
    jkc.save_packed(jside, "a key the port must not read", tree)
    jbytes = open(jside, "rb").read()
    base = ["inference", "--model", model, "--tokenizer", model_files[1],
            "--prompt", "hi", "--steps", "12", "--temperature", "0",
            "--seed", "1"]

    def pieces(out):
        return [ln.rsplit("'", 2)[-2] for ln in out.splitlines()
                if ln.startswith("🔶")]

    assert ref_main([*base, "--tp", "1"]) == 0
    want = pieces(capsys.readouterr().out)
    for _ in ("cold", "warm"):
        assert main([*base, "--device", "cpu"]) == 0
        cap = capsys.readouterr()
        assert pieces(cap.out) == want and len(want) > 4
    assert "device-layout cache hit" in cap.err
    assert open(jside, "rb").read() == jbytes
    assert kc.sidecar_path(model) != jside

