"""C8 pinned: a seeded ``--fast-prefill`` stream under tp.

The port keeps one route for a prefill chunk of more than 8 tokens at every
tp (bf16 products and bf16 attention dots), so its tp 2 stream is its tp 1
stream, and that is the JAX CLI's tp 1 stream. The JAX CLI's tp layer
instead runs such a chunk's attention through ``attention_core`` at
``precision=None`` (f32 dots on the CPU) while its tp 1 path takes the bf16
blockwise walk; its tp 2 stream equals its own tp 1 stream only under
``DLLAMA_PREFILL_ATTN=dense`` (f32 attention at tp 1 too). That is the
JAX-side inconsistency ROADMAP's C8 records; this file shows the cause and
holds the port to the tp-invariant stream."""

import pytest

from test_torch_tp_cli import _pieces, model_files  # noqa: F401

PROMPT = " ".join(["hi"] * 12)


def _argv(model_files, tp):
    model, tok, _ = model_files
    return ["inference", "--model", model, "--tokenizer", tok, "--prompt",
            PROMPT, "--steps", "24", "--temperature", "0.8", "--topp", "0.9",
            "--seed", "7", "--prefill-chunk", "12", "--fast-prefill",
            "--tp", str(tp)]


@pytest.fixture(scope="module")
def streams(model_files, tmp_path_factory):
    """The port's tp 1 and tp 2 streams and the JAX CLI's tp 1 and tp 2
    streams, with and without DLLAMA_PREFILL_ATTN=dense."""
    import contextlib
    import io
    import os

    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    def run(fn, argv, env=None):
        buf = io.StringIO()
        old = {k: os.environ.get(k) for k in env or {}}
        os.environ.update(env or {})
        try:
            with contextlib.redirect_stdout(buf):
                assert fn(argv) == 0
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        return _pieces(buf.getvalue())

    return {
        "port 1": run(main, _argv(model_files, 1) + ["--device", "cpu"]),
        "jax 1": run(ref_main, _argv(model_files, 1)),
        "jax 2": run(ref_main, _argv(model_files, 2)),
        "jax 1 dense": run(ref_main, _argv(model_files, 1),
                           {"DLLAMA_PREFILL_ATTN": "dense"}),
    }


def test_port_tp2_stream_is_its_tp1_stream_and_the_jax_tp1_stream(
        model_files, capfd, streams):
    from distributed_llama_tpu_torch.frontend.cli import main

    assert main(_argv(model_files, 2) + ["--device", "cpu"]) == 0
    got = _pieces(capfd.readouterr().out)
    assert len(got) > 8
    assert got == streams["port 1"]
    assert got == streams["jax 1"]


def test_jax_tp2_stream_is_its_tp1_stream_under_dense_attention(streams):
    """The cause: the JAX tp layer's f32 attention. Its tp 2 stream is not
    its tp 1 stream, and is the tp 1 stream with dense f32 attention."""
    assert streams["jax 2"] == streams["jax 1 dense"]
    assert streams["jax 2"] != streams["jax 1"]
