"""The port's ``inference --tp N`` and ``worker`` modes on the CPU (gloo
ranks, one spawned process each) against the JAX CLI (twin of
tests/test_multihost.py's test_two_process_inference_matches_single):
``--device cpu --tp 2`` prints the JAX CLI's ``--tp 2`` token stream,
greedy and seeded, and the lockstep batch's rows; a two-host
``--coordinator`` run (host 0 ``inference``, host 1 ``worker``, one rank
each) prints the single-process stream from host 0 and nothing from the
worker; the flag checks exit 2 before any load."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from distributed_llama_tpu_torch.models.spec import TransformerSpec
from distributed_llama_tpu_torch.ops.quants import FloatType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tp 2 divides heads, kv heads, hidden and vocab; wo/w2 blocks split
SPEC = TransformerSpec(dim=128, hidden_dim=256, n_layers=2, n_heads=8,
                       n_kv_heads=4, vocab_size=300, seq_len=32,
                       weights_float_type=FloatType.Q40)
PROMPT = "hi hi"
SAMPLING = {"greedy": ("0.0", "1"), "seeded": ("0.8", "42")}


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    from distributed_llama_tpu_torch.io.loader import write_model
    from distributed_llama_tpu_torch.io.tokenizer import write_tokenizer

    d = tmp_path_factory.mktemp("m")
    rng = np.random.default_rng(5)

    def t(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    tensors = {"tok_embedding": t(SPEC.vocab_size, SPEC.dim),
               "rms_att": 1 + t(SPEC.n_layers, SPEC.dim),
               "rms_ffn": 1 + t(SPEC.n_layers, SPEC.dim),
               "rms_final": 1 + t(SPEC.dim),
               "wcls": t(SPEC.vocab_size, SPEC.dim)}
    for name, shape in SPEC.layer_matmul_shapes():
        tensors[name] = t(SPEC.n_layers, *shape)
    model = str(d / "model.bin")
    write_model(model, SPEC, tensors)
    pieces = [b"<unk>", b"<s>", b"</s>"]
    pieces += [f"<0x{i:02X}>".encode() for i in range(256)]
    pieces += [b" ", b"h", b"i", b"hi", b" hi"]
    while len(pieces) < SPEC.vocab_size:
        pieces.append(f"tok{len(pieces)}".encode())
    tok = str(d / "tok.bin")
    write_tokenizer(tok, pieces, [0.0] * len(pieces))
    prompts = d / "prompts.txt"
    prompts.write_text("hi\nhi hi hi\n")
    return model, tok, str(prompts)


def _pieces(out):
    return [ln.rsplit("'", 2)[-2] for ln in out.splitlines()
            if ln.startswith("🔶")]


def _rows(out):
    return [ln for ln in out.splitlines() if re.match(r"^\[\d+\] ", ln)]


def _args(model_files, mode, extra=()):
    model, tok, _ = model_files
    temperature, seed = SAMPLING[mode]
    return ["inference", "--model", model, "--tokenizer", tok, "--prompt",
            PROMPT, "--steps", "12", "--temperature", temperature,
            "--topp", "0.9", "--seed", seed, *extra]


@pytest.mark.parametrize("mode", sorted(SAMPLING))
def test_tp2_stream_is_the_jax_clis(model_files, capfd, mode):
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    assert ref_main(_args(model_files, mode, ["--tp", "2"])) == 0
    want = _pieces(capfd.readouterr().out)
    assert len(want) > 6
    assert main(_args(model_files, mode, ["--tp", "2", "--device",
                                          "cpu"])) == 0
    out = capfd.readouterr().out
    assert _pieces(out) == want
    assert "💡 nSlices: 2 sp: 1 scheme: fused (2 cpu ranks over gloo" in out
    # rank 0 alone prints: one header, one summary
    assert out.count("💡 dim: 128") == 1
    assert re.search(r"Collectives/token: +5 \(all_gather 1, psum 4\), "
                     r"budget 5 \(fused, tp 2, gloo\)", out)


def test_tp2_without_seed_gives_every_rank_one_seed(model_files, capfd,
                                                    monkeypatch):
    """Sampling at temperature 0.8 with no --seed: the spawning process
    picks the seed once and hands it to every rank, so the ranks sample
    the same chain and the stream is the one an explicit --seed of that
    value gives (a rank that picked its own seed would feed the forward
    another token)."""
    from distributed_llama_tpu_torch.frontend import cli

    argv = _args(model_files, "seeded", ["--tp", "2", "--device", "cpu"])
    i = argv.index("--seed")
    del argv[i:i + 2]
    monkeypatch.setattr(cli, "_default_seed", lambda: 4242)
    assert cli.main(argv) == 0
    got = _pieces(capfd.readouterr().out)
    assert cli.main([*argv, "--seed", "4242"]) == 0
    want = _pieces(capfd.readouterr().out)
    assert len(want) > 6 and got == want


def test_tp_defaults_to_one_and_a_callers_group_needs_a_seed(
        tmp_path, capsys, monkeypatch):
    """--tp defaults to 1 however many GPUs are visible (every visible
    device only with --coordinator), and a caller's group of two without
    --seed exits 2 before loading."""
    import argparse

    import torch

    from distributed_llama_tpu_torch.frontend import cli
    from distributed_llama_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "visible_devices", lambda device: 4)
    args = argparse.Namespace(tp=None, device="cuda", num_hosts=1,
                              coordinator=None)
    assert cli._resolve_tp(args, None, None) == 1
    args.num_hosts, args.coordinator = 2, "h:1"
    assert cli._resolve_tp(args, None, None) == 8
    group = mesh.TPGroup(0, 2, None, torch.device("cpu"))
    assert cli.cmd_inference(["--model", str(tmp_path / "absent.bin"),
                              "--tokenizer", "t", "--device", "cpu"],
                             group=group) == 2
    assert "explicit --seed" in capsys.readouterr().err


def test_tp2_batch_rows_are_the_jax_clis(model_files, capfd, monkeypatch):
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tok, prompts = model_files
    base = ["inference", "--model", model, "--tokenizer", tok,
            "--prompts-file", prompts, "--steps", "10", "--temperature",
            "0", "--seed", "1", "--tp", "2", "--tp-scheme", "ref"]
    # the JAX CLI exports --tp-scheme into the environment: restore it
    # after this test, or a later test in this process reads "ref"
    monkeypatch.setenv("DLLAMA_TP_SCHEME", "")
    monkeypatch.delenv("DLLAMA_TP_SCHEME")
    assert ref_main(base) == 0
    want = _rows(capfd.readouterr().out)
    assert len(want) == 2
    assert main(base + ["--device", "cpu"]) == 0
    assert _rows(capfd.readouterr().out) == want


def _host(model_files, mode, host_id, port):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    argv = _args(model_files, "greedy",
                 ["--tp", "2", "--device", "cpu", "--coordinator",
                  f"127.0.0.1:{port}", "--num-hosts", "2", "--host-id",
                  str(host_id)])
    argv[0] = mode
    return subprocess.Popen([sys.executable, "-m",
                             "distributed_llama_tpu_torch", *argv],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_two_hosts_match_the_single_process_run(model_files, capfd):
    from distributed_llama_tpu_torch.frontend.cli import main
    from distributed_llama_tpu_torch.parallel.mesh import free_port

    assert main(_args(model_files, "greedy", ["--tp", "2", "--device",
                                              "cpu"])) == 0
    want = _pieces(capfd.readouterr().out)
    port = free_port()
    root = _host(model_files, "inference", 0, port)
    worker = _host(model_files, "worker", 1, port)
    out_root, err_root = root.communicate(timeout=240)
    out_worker, err_worker = worker.communicate(timeout=60)
    assert root.returncode == 0, err_root[-2000:]
    assert worker.returncode == 0, err_worker[-2000:]
    assert _pieces(out_root) == want and want
    assert out_worker.strip() == ""  # workers run silent


@pytest.mark.parametrize("extra,rc,message", [
    (["--tp", "999"], 2, "needs 999 devices on this host, have"),
    (["--tp", "3", "--device", "cpu", "--num-hosts", "2", "--coordinator",
      "h:1", "--seed", "1"], 2, "does not divide over 2 hosts"),
    (["--tp", "2", "--device", "cpu", "--num-hosts", "2"], 2,
     "--num-hosts 2 needs --coordinator"),
    (["--tp-scheme", "overlap", "--sp", "2"], 2,
     "--tp-scheme overlap needs --sp 1"),
    (["--tp-scheme", "ring"], 2, "invalid choice"),
    (["--tp", "2", "--device", "cpu", "--save-state", "s.npz",
      "--stream-slices"], 2,
     "--stream-slices only applies with --model-from-root"),
], ids=["above-devices", "hosts", "num-hosts", "overlap-sp", "scheme",
        "save-state"])
def test_tp_flag_checks_exit_before_loading(tmp_path, capsys, extra, rc,
                                            message):
    """The model path does not exist: the exit proves nothing loaded."""
    from distributed_llama_tpu_torch.frontend.cli import main

    argv = ["inference", "--model", str(tmp_path / "absent.bin"),
            "--tokenizer", str(tmp_path / "absent.tok"), *extra]
    try:
        got = main(argv)
    except SystemExit as e:  # argparse's choices
        got = e.code
    assert got == rc
    assert message in capsys.readouterr().err


def test_multi_host_needs_a_seed(tmp_path, capsys):
    from distributed_llama_tpu_torch.frontend.cli import main

    assert main(["worker", "--model", str(tmp_path / "absent.bin"),
                 "--tokenizer", "t", "--coordinator", "h:1", "--num-hosts",
                 "2", "--host-id", "1", "--tp", "2", "--device", "cpu"]) == 2
    assert "explicit --seed" in capsys.readouterr().err


@pytest.mark.parametrize("graph,raises", [(None, True), (True, True),
                                          (False, False)])
def test_tp_engines_refuse_a_graph_over_the_group(graph, raises):
    """A CUDA graph over a tp group's collectives is not yet ported: the
    engines raise unless the caller passes graph=False (never an eager
    step on their own); a group of one captures as before."""
    import torch

    from distributed_llama_tpu_torch.parallel.mesh import TPGroup, single
    from distributed_llama_tpu_torch.runtime.generate import _no_capture

    cuda = torch.device("cuda", 0)
    group = TPGroup(0, 2, None, cuda)
    if raises:
        with pytest.raises(ValueError, match="not yet ported: a CUDA graph"):
            _no_capture(group, cuda, graph)
    else:
        _no_capture(group, cuda, graph)
    _no_capture(single(cuda), cuda, graph)
