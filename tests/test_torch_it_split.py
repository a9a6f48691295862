"""The port's I/T split (utils/it_split.py) against the JAX package's: the
same families and printed text from the same per-device op totals, and
``parse_trace`` on Chrome traces written here (demangled CUDA kernel
names with template arguments, NCCL kernels on two devices, nested CPU
ops) and on a real torch.profiler trace of a tiny model's CPU forward."""

import collections
import io
import json

import numpy as np
import pytest
import torch

from distributed_llama_tpu.utils import it_split as ref
from distributed_llama_tpu_torch.utils import it_split as port

# name -> ns per device; each dict one device (or thread) of a split
SPLITS = {
    "one-device": [{"q40_matvec_kernel": 3.2e6, "flash_decode_kernel": 1.1e6,
                    "vectorized_elementwise_kernel": 4.0e5,
                    "copy_": 2.5e4, "reduce_kernel": 1.0e5}],
    "empty-T": [{"mm": 1.5e6, "linear": 2.0e5}],
    "two-devices": [{"q40_matvec_kernel": 2.0e6,
                     "ncclDevKernel_AllReduce_Sum_f32_RING_LL": 7.5e5,
                     "all-gather": 1.25e5},
                    {"q40_matvec_kernel": 2.1e6, "paged_attention_kernel":
                     3.0e5, "ncclDevKernel_AllReduce_Sum_f32_RING_LL": 7.0e5,
                     "fusion": 5.0e4}],
}


def _splits(mod, devices):
    out = {}
    for i, ops in enumerate(devices):
        s = mod.DeviceSplit()
        for name, ns in ops.items():
            s.ops[name] += ns
            if mod._COLLECTIVE_RE.search(name):
                s.transfer_ns += ns
            else:
                s.inference_ns += ns
        out[f"dev{i}"] = s
    return out


@pytest.mark.parametrize("case", sorted(SPLITS))
@pytest.mark.parametrize("tokens", [0, 7])
def test_buckets_and_summary_equal_the_jax_functions(case, tokens):
    """From the same per-device contents, bucket_ops_from_splits gives the
    same dict and summarize the same text and (I, T) as the JAX package.
    The split totals come from the port's collective classifier; the JAX
    side is handed the same totals (its regex does not know NCCL's kernel
    names, which only the port's traces hold)."""
    mine = _splits(port, SPLITS[case])
    theirs = {}
    for key, s in mine.items():
        r = ref.DeviceSplit(s.inference_ns, s.transfer_ns,
                            collections.Counter(s.ops))
        theirs[key] = r
    assert (port.bucket_ops_from_splits(mine, tokens or 1)
            == ref.bucket_ops_from_splits(theirs, tokens or 1))
    got, want = io.StringIO(), io.StringIO()
    it_got = port.summarize(mine, tokens=tokens, top=4, out=got,
                            note="; note")
    it_want = ref.summarize(theirs, tokens=tokens, top=4, out=want,
                            note="; note")
    text = got.getvalue()
    if case == "two-devices":
        # the one difference: the op list tags NCCL's kernels T, where
        # the JAX regex would tag them I
        text = text.replace("   T ncclDevKernel", "   I ncclDevKernel")
        assert it_got[1] > 0
    assert text == want.getvalue()
    assert it_got == pytest.approx(it_want)
    assert text.startswith("🔶 I ")


def _kernel(name, pid, ts, dur, tid=7):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": pid,
            "tid": tid, "ts": ts, "dur": dur}


def _cpu(name, ts, dur, tid=100, pid=1):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": pid,
            "tid": tid, "ts": ts, "dur": dur}


def _write(tmp_path, events, name="host.1.pt.trace.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"schemaVersion": 1,
                                "traceEvents": events}))
    return path


@pytest.mark.parametrize("raw,base", [
    ("void (anonymous namespace)::q40_matvec_kernel(uint4 const*, __half "
     "const*, float const*, float*, int, int)", "q40_matvec_kernel"),
    ("void flash_decode_kernel<float, 128>(float const*, float*, int)",
     "flash_decode_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, "
     "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)",
     "vectorized_elementwise_kernel"),
    ("void at::native::(anonymous namespace)::elementwise_kernel<128, 2, "
     "at::native::gpu_kernel_impl<at::native::(anonymous namespace)::"
     "foo(at::TensorIteratorBase&)::{lambda(float)#1}>(at::"
     "TensorIteratorBase&)::{lambda(int)#1}>(int, int)",
     "elementwise_kernel"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage"
     "<4096ul>)", "ncclDevKernel_AllReduce_Sum_f32_RING_LL"),
    ("aten::linear", "linear"), ("aten::add_", "add_"),
    ("probe_stream_kernel", "probe_stream_kernel"), ("::", "")])
def test_base_names(raw, base):
    assert port.base_name(raw) == base


def test_parse_trace_device_kernels_and_nccl_on_two_devices(tmp_path):
    """Kernel events give one split per device, summed over its streams;
    host cpu_op events are ignored once kernels exist; NCCL kernels are
    transfers."""
    events = [
        _kernel("void (anonymous namespace)::q40_matvec_kernel(uint4 "
                "const*, int)", 0, 10.0, 3.5),
        _kernel("void (anonymous namespace)::q40_matvec_kernel(uint4 "
                "const*, int)", 0, 20.0, 1.5, tid=13),
        _kernel("void flash_decode_kernel<float, 128>(float const*)", 0,
                30.0, 2.0),
        _kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs"
                "Storage<4096ul>)", 0, 40.0, 4.0),
        _kernel("ncclKernel_AllGather_RING_LL_Sum_int8_t(ncclWorkElem)", 1,
                40.0, 6.0),
        _kernel("void (anonymous namespace)::q40_matvec_kernel(uint4 "
                "const*, int)", 1, 10.0, 2.25),
        _cpu("aten::mm", 0.0, 500.0),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
         "tid": 7, "ts": 1.0, "dur": 9.0},
        {"ph": "M", "name": "process_name", "pid": 0},
    ]
    path = _write(tmp_path, events)
    splits = port.parse_trace(str(tmp_path))
    assert sorted(splits) == ["/device:cuda:0", "/device:cuda:1"]
    d0, d1 = splits["/device:cuda:0"], splits["/device:cuda:1"]
    assert dict(d0.ops) == {"q40_matvec_kernel": 5000.0,
                            "flash_decode_kernel": 2000.0,
                            "ncclDevKernel_AllReduce_Sum_f32_RING_LL":
                            4000.0}
    assert d0.inference_ns == 7000.0 and d0.transfer_ns == 4000.0
    assert dict(d1.ops) == {"q40_matvec_kernel": 2250.0,
                            "ncclKernel_AllGather_RING_LL_Sum_int8_t":
                            6000.0}
    assert d1.inference_ns == 2250.0 and d1.transfer_ns == 6000.0
    assert port.parse_trace(str(path)).keys() == splits.keys()
    assert port.bucket_ops(str(tmp_path), 2) == {
        "attention": 0.001, "other": 0.005, "q40_kernels": 0.004}


def test_parse_trace_counts_top_level_cpu_ops_per_thread(tmp_path):
    """Without kernel events the top-level cpu_ops of each thread count:
    nested aten ops (linear > matmul > mm) count once, at the outer op."""
    events = [_cpu("aten::linear", 0.0, 100.0),
              _cpu("aten::matmul", 5.0, 90.0),
              _cpu("aten::mm", 6.0, 88.0),
              _cpu("aten::add", 100.0, 10.0),  # starts as linear ends
              _cpu("aten::empty", 102.0, 1.0),
              _cpu("aten::mul", 0.0, 40.0, tid=200),
              _cpu("aten::mul", 50.0, 30.0, tid=200),
              {"ph": "X", "cat": "user_annotation", "name": "step",
               "pid": 1, "tid": 100, "ts": 0.0, "dur": 200.0}]
    _write(tmp_path, events)
    splits = port.parse_trace(str(tmp_path))
    assert sorted(splits) == ["/host:CPU/1/100", "/host:CPU/1/200"]
    assert dict(splits["/host:CPU/1/100"].ops) == {"linear": 100000.0,
                                                   "add": 10000.0}
    assert dict(splits["/host:CPU/1/200"].ops) == {"mul": 70000.0}
    assert all(s.transfer_ns == 0 for s in splits.values())


def test_find_trace_takes_the_newest_and_an_empty_trace_raises(tmp_path):
    import os

    old = _write(tmp_path, [_cpu("aten::mm", 0.0, 1.0)], "a.pt.trace.json")
    sub = tmp_path / "sub"
    sub.mkdir()
    new = _write(sub, [_cpu("aten::mm", 0.0, 2.0)], "b.pt.trace.json")
    os.utime(old, (1, 1))
    assert port.find_trace(str(tmp_path)) == str(new)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="--profile"):
        port.find_trace(str(empty))
    _write(empty, [{"ph": "M", "name": "x"}])
    with pytest.raises(ValueError, match="no op events"):
        port.parse_trace(str(empty))


def test_real_profiler_trace_of_a_cpu_forward_parses(tmp_path, capsys):
    """obs.profiler.trace around the tiny model's CPU forward writes a
    trace whose split is non-empty and whose summary the module's main
    prints."""
    from distributed_llama_tpu_torch.models.llama import (Llama, init_cache,
                                                          params_to_device)
    from distributed_llama_tpu_torch.models.spec import TransformerSpec
    from distributed_llama_tpu_torch.models.synth import synth_params
    from distributed_llama_tpu_torch.obs import profiler
    from distributed_llama_tpu_torch.ops.quants import FloatType

    spec = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=96, seq_len=16,
                           weights_float_type=FloatType.Q40)
    model = Llama(spec, params_to_device(synth_params(spec, q40=True,
                                                      seed=3), "cpu"))
    cache = init_cache(spec, "cpu")
    with torch.inference_mode(), profiler.trace(str(tmp_path), cuda=False):
        for pos in range(3):
            logits = model(cache, 5, pos)
    assert np.isfinite(logits.numpy()).all()
    assert profiler.capture_active() is None
    splits = port.parse_trace(str(tmp_path))
    assert len(splits) >= 1
    assert sum(s.inference_ns for s in splits.values()) > 0
    assert all(s.transfer_ns == 0 for s in splits.values())
    assert port.main([str(tmp_path), "--tokens", "3", "--top", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("🔶 I ") and "ms/token" in out[0]
    assert len(out) == 4
