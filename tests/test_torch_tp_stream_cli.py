"""Two "hosts" on localhost, the root serving its weights and the worker
fetching them (twin: tests/test_multihost.py's weight-streaming cases):
``inference --serve-weights`` on host 0 and ``worker --model-from-root
[--stream-slices]`` on host 1, whose --model path starts empty, give the
single-process tp 2 stream and the JAX CLI's under each scheme; a rank
whose bands were not fetched exits 2 before it loads."""

import os
import subprocess
import sys

import pytest

from test_torch_tp_cli import ROOT, SPEC, _pieces, model_files  # noqa: F401

GEN = ["--prompt", "hi hi", "--steps", "10", "--temperature", "0", "--seed",
       "1", "--tp", "2"]
CASES = [("ref", True), ("fused", True), ("overlap", True), ("fused", False)]


def _host(mode, model, tok, host_id, coord, extra):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-m", "distributed_llama_tpu_torch", mode,
         "--model", model, "--tokenizer", tok, *GEN, "--device", "cpu",
         "--coordinator", coord, "--num-hosts", "2", "--host-id",
         str(host_id), *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


@pytest.fixture(scope="module")
def single(model_files):
    """The port's single-process tp 2 stream (greedy: the same under every
    scheme, tests/test_torch_tp.py); its ranks print from processes of
    their own, so it runs as one."""
    model, tok, _ = model_files
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-m", "distributed_llama_tpu_torch", "inference",
         "--model", model, "--tokenizer", tok, *GEN, "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    return _pieces(res.stdout)


@pytest.mark.parametrize("scheme,slices", CASES,
                         ids=[f"{s}-{'slices' if c else 'whole'}"
                              for s, c in CASES])
def test_worker_streams_its_weights_from_the_root(model_files, single, capfd,
                                                  tmp_path, scheme, slices,
                                                  monkeypatch):
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.io.stream import needed_byte_ranges
    from distributed_llama_tpu_torch.parallel.mesh import free_port

    # the JAX CLI exports --tp-scheme into the environment: restore it
    monkeypatch.setenv("DLLAMA_TP_SCHEME", "")
    monkeypatch.delenv("DLLAMA_TP_SCHEME")
    model, tok, _ = model_files
    assert ref_main(["inference", "--model", model, "--tokenizer", tok, *GEN,
                     "--tp-scheme", scheme]) == 0
    want = _pieces(capfd.readouterr().out)
    assert len(want) > 6 and want == single

    wmodel = str(tmp_path / "worker" / "model.bin")
    port, coord = free_port(), f"127.0.0.1:{free_port()}"
    root = _host("inference", model, tok, 0, coord,
                 ["--tp-scheme", scheme, "--serve-weights", str(port),
                  "--serve-weights-bind", "127.0.0.1"])
    worker = _host("worker", wmodel, tok, 1, coord,
                   ["--tp-scheme", scheme, "--model-from-root",
                    f"127.0.0.1:{port}"]
                   + (["--stream-slices"] if slices else []))
    out_root, err_root = root.communicate(timeout=240)
    out_worker, err_worker = worker.communicate(timeout=60)
    assert root.returncode == 0, err_root[-2000:]
    assert worker.returncode == 0, err_worker[-2000:]
    assert f"⏩ serving weights on port {port}" in out_root
    assert _pieces(out_root) == want
    assert out_worker.strip() == ""  # workers run silent
    assert os.path.getsize(wmodel) == os.path.getsize(model)
    if slices:  # the worker's sidecar holds its scheme's bands of rank 1
        import json

        with open(wmodel + ".slices") as fh:
            got = [tuple(e[:2]) for e in json.load(fh)["ranges"]]
        assert got == needed_byte_ranges(SPEC, 2, {1}, scheme)
        assert sum(n for _, n in got) < os.path.getsize(model)
    else:
        assert open(wmodel, "rb").read() == open(model, "rb").read()
        assert not os.path.exists(wmodel + ".slices")


def test_a_rank_whose_bands_were_not_fetched_exits_before_loading(
        model_files, tmp_path, capsys):
    """A caller's group puts this process at rank 1, but host 0 of 2 holds
    rank 0: the fetch takes rank 0's bands and the run refuses before the
    model loads (the sparse file would give rank 1 zeros)."""
    import torch

    from distributed_llama_tpu_torch.frontend.cli import cmd_inference
    from distributed_llama_tpu_torch.io.stream import WeightServer
    from distributed_llama_tpu_torch.parallel.mesh import TPGroup

    model, tok, _ = model_files
    server = WeightServer(model, host="127.0.0.1")
    try:
        wmodel = str(tmp_path / "model.bin")
        rc = cmd_inference(
            ["--model", wmodel, "--tokenizer", tok, *GEN, "--device", "cpu",
             "--coordinator", "127.0.0.1:1", "--num-hosts", "2",
             "--host-id", "0", "--model-from-root",
             f"127.0.0.1:{server.port}", "--stream-slices"],
            quiet=True, group=TPGroup(1, 2, None, torch.device("cpu")))
    finally:
        server.close()
    assert rc == 2
    err = capsys.readouterr().err
    assert ("--stream-slices fetched tp ranks [0] but this host's devices "
            "hold ranks [1]") in err
    assert os.path.exists(wmodel + ".slices")  # fetched, never loaded


@pytest.mark.parametrize("extra,message", [
    (["--stream-slices"], "--stream-slices only applies with "
                          "--model-from-root"),
    (["--stream-slices", "--model-from-root", "h:1", "--tp", "1"],
     "--stream-slices needs an explicit --tp > 1"),
    (["--stream-slices", "--model-from-root", "h:1", "--tp", "3",
      "--num-hosts", "2", "--coordinator", "h:2", "--seed", "1"],
     "mesh of 3 devices does not divide over 2 hosts"),
], ids=["no-root", "no-tp", "hosts"])
def test_stream_flag_checks_exit_2_before_any_fetch(tmp_path, capsys, extra,
                                                    message):
    from distributed_llama_tpu_torch.frontend.cli import main

    assert main(["inference", "--model", str(tmp_path / "absent.bin"),
                 "--tokenizer", "t", "--device", "cpu", *extra]) == 2
    assert message in capsys.readouterr().err
