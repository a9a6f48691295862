"""The port's ``train`` mode against the JAX CLI's, on tests/
test_train_cli.py's fixture (f32 and Q40 files of a 2-layer GQA model,
a 300-piece tokenizer, a repeated sentence as the corpus):

* the per-step losses the port prints at dp 1 x tp 1, dp 2 x tp 2 and tp
  2 (gloo ranks, the port run as ``python -m distributed_llama_tpu_torch``
  with --device cpu) equal the JAX CLI's within one unit of the printed
  fourth decimal, at --batch 3 (dp 2 splits it 2 + 1, as GSPMD pads);
  the Q40 file densifies and trains to the JAX CLI's losses;
* checkpoints cross over through the CLIs: the JAX CLI's dp 2 x tp 2
  state resumes in the port at tp 2, the port's dp 2 x tp 2 state in the
  JAX CLI, each printing "Resumed training at step 2" and continuing the
  unsplit run's losses;
* a bad --seq, a tiny corpus, a resume with another --seed and
  --stream-slices (with and without --model-from-root) exit with the JAX
  CLI's codes and messages; only rank 0 prints.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=4, n_kv_heads=2,
            vocab_size=300, seq_len=32)
RUN = ["--batch", "3", "--seq", "16", "--learning-rate", "3e-3",
       "--seed", "3"]
PRINTED = 1e-4  # one unit of the printed fourth decimal


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """tests/test_train_cli.py's fixture, written by the JAX package."""
    import dataclasses

    from distributed_llama_tpu.io.loader import write_model
    from distributed_llama_tpu.io.tokenizer import write_tokenizer
    from distributed_llama_tpu.models.spec import TransformerSpec
    from distributed_llama_tpu.ops.quants import FloatType

    spec = TransformerSpec(**BASE)
    d = tmp_path_factory.mktemp("t")
    rng = np.random.default_rng(5)

    def t(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    tensors = {"tok_embedding": t(spec.vocab_size, spec.dim),
               "rms_att": 1 + t(spec.n_layers, spec.dim),
               "rms_ffn": 1 + t(spec.n_layers, spec.dim),
               "rms_final": 1 + t(spec.dim),
               "wcls": t(spec.vocab_size, spec.dim)}
    for name, shape in spec.layer_matmul_shapes():
        tensors[name] = t(spec.n_layers, *shape)
    f32 = str(d / "m32.bin")
    write_model(f32, spec, tensors)
    q40 = str(d / "m40.bin")
    write_model(q40, dataclasses.replace(
        spec, weights_float_type=FloatType.Q40), tensors)
    pieces = [b"<unk>", b"<s>", b"</s>"]
    pieces += [f"<0x{i:02X}>".encode() for i in range(256)]
    while len(pieces) < spec.vocab_size:
        pieces.append(f"tok{len(pieces)}".encode())
    tok = str(d / "tok.bin")
    write_tokenizer(tok, pieces, [0.0] * len(pieces))
    data = str(d / "corpus.txt")
    with open(data, "w") as fh:
        fh.write("the quick brown fox jumps over the lazy dog " * 40)
    return dict(f32=f32, q40=q40, tok=tok, data=data, dir=d)


def _losses(out: str) -> list[float]:
    return [float(m.group(1)) for m in re.finditer(r"loss\s+([0-9.]+)", out)]


def _argv(files, model="f32", *extra):
    return ["--model", files[model], "--tokenizer", files["tok"], "--data",
            files["data"], *RUN,
            *(["--weights-float-type", "q40"] if model == "q40" else []),
            *extra]


def _jax(argv, capsys):
    from distributed_llama_tpu.frontend.cli import main

    assert main(["train", *argv]) == 0
    return capsys.readouterr().out


def _port(argv):
    res = subprocess.run(
        [sys.executable, "-m", "distributed_llama_tpu_torch", "train",
         *argv, "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


@pytest.fixture(scope="module")
def jax_runs(files, tmp_path_factory):
    """The JAX CLI's runs: 4 steps at dp 1 x tp 1, 2 saved at dp 2 x tp 2,
    3 on the Q40 file. (In-process, its output read from a pipe.)"""
    import contextlib
    import io

    from distributed_llama_tpu.frontend.cli import main

    out = {}
    ck = str(files["dir"] / "jax.ckpt")
    for label, argv in (
            ("full", _argv(files, "f32", "--steps", "4")),
            ("saved", _argv(files, "f32", "--steps", "2", "--dp", "2",
                            "--tp", "2", "--save-state", ck)),
            ("q40", _argv(files, "q40", "--steps", "3"))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["train", *argv]) == 0
        out[label] = _losses(buf.getvalue())
    out["ck"] = ck
    return out


def test_port_losses_equal_the_jax_cli(files, jax_runs):
    full = jax_runs["full"]
    assert len(full) == 4
    np.testing.assert_allclose(jax_runs["saved"], full[:2], atol=PRINTED)
    text = _port(_argv(files, "f32", "--steps", "4"))
    assert text.count("🔶 step") == 4
    np.testing.assert_allclose(_losses(text), full, rtol=0, atol=PRINTED)
    q40 = _losses(_port(_argv(files, "q40", "--steps", "3")))
    np.testing.assert_allclose(q40, jax_runs["q40"], rtol=0, atol=PRINTED)


def test_checkpoints_cross_between_the_clis(files, jax_runs, capsys):
    full = jax_runs["full"]
    # the JAX CLI's dp 2 x tp 2 state, resumed by the port at tp 2
    text = _port(_argv(files, "f32", "--steps", "2", "--tp", "2",
                       "--resume-state", jax_runs["ck"]))
    assert "⏩ Resumed training at step 2" in text
    assert text.count("🔶 step") == 2 and "step     2" in text
    np.testing.assert_allclose(_losses(text), full[2:], rtol=0, atol=PRINTED)
    # the port's dp 2 x tp 2 state, resumed by the JAX CLI
    ck = str(files["dir"] / "port.ckpt")
    text = _port(_argv(files, "f32", "--steps", "2", "--dp", "2", "--tp",
                       "2", "--save-state", ck))
    assert text.count("🔶 step") == 2 and text.count("⏩ Saved") == 1
    assert f"⏩ Saved training state to {ck} (step 2)" in text
    np.testing.assert_allclose(_losses(text), full[:2], rtol=0, atol=PRINTED)
    out = _jax(_argv(files, "f32", "--steps", "2", "--resume-state", ck),
               capsys)
    assert "Resumed training at step 2" in out
    np.testing.assert_allclose(_losses(out), full[2:], rtol=0, atol=PRINTED)


def _both(argv, capsys):
    """(exit code, stderr) of the JAX CLI and of the port on ``argv``; a
    SystemExit with a message is exit 1 with it on stderr."""
    from distributed_llama_tpu.frontend.cli import main as jax_main
    from distributed_llama_tpu_torch.frontend.cli import main

    outs = []
    for run in (lambda: jax_main(["train", *argv]),
                lambda: main(["train", *argv, "--device", "cpu"])):
        try:
            rc = run()
            err = capsys.readouterr().err
        except SystemExit as e:
            rc, err = 1, str(e.code) + "\n"
        outs.append((rc, err.strip().splitlines()[-1]))
    return outs


def test_error_paths_match_the_jax_cli(files, tmp_path, capsys):
    tiny = str(tmp_path / "tiny.txt")
    with open(tiny, "w") as fh:
        fh.write("hi")
    base = ["--model", files["f32"], "--tokenizer", files["tok"]]
    ck = str(tmp_path / "seed3.ckpt")
    _port(_argv(files, "f32", "--steps", "1", "--save-state", ck))
    cases = {
        "seq": ([*base, "--data", files["data"], "--seq",
                 str(BASE["seq_len"])], 2),
        "corpus": ([*base, "--data", tiny, "--seq", "16"], 2),
        "seed": ([*base, "--data", files["data"], "--seq", "16", "--seed",
                  "4", "--resume-state", ck], 2),
        "slices": ([*base, "--data", files["data"], "--stream-slices"], 1),
        "slices-root": ([*base, "--data", files["data"], "--stream-slices",
                         "--model-from-root", "127.0.0.1:1"], 1),
    }
    for what, (argv, rc) in cases.items():
        jax, port = _both(argv, capsys)
        assert jax == port, (what, jax, port)
        assert port[0] == rc, (what, port)
