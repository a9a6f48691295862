"""The continuous engine's flags on single-prompt ``inference``, against the
JAX CLI on the tests/test_torch_cli.py fixture model: the JAX CLI runs its
checks and then runs the plain single-prompt path, ignoring the flags
there. With a page size every combination exits 0 with the plain greedy
stream; without one, --spec-k, --kv-quant q8 and --dispatch-tokens exit 2
with the JAX CLI's message (before the model loads)."""

import pytest
from test_torch_cli import model_files  # noqa: F401  (the fixture model)

BASE = ["--prompt", "hi", "--steps", "8", "--temperature", "0", "--seed",
        "1"]
PAGED = {
    "page-size": ["--kv-page-size", "16"],
    "kv-pages": ["--kv-page-size", "16", "--kv-pages", "64"],
    "block-steps": ["--kv-page-size", "16", "--block-steps", "4"],
    "spec-k": ["--kv-page-size", "16", "--spec-k", "2"],
    "kv-quant": ["--kv-page-size", "16", "--kv-quant", "q8"],
    "dispatch-tokens": ["--kv-page-size", "16", "--dispatch-tokens", "8"],
    "kv-host-pages": ["--kv-page-size", "16", "--kv-host-pages", "8"],
}
REFUSED = {"spec-k": ["--spec-k", "2"], "kv-quant": ["--kv-quant", "q8"],
           "dispatch-tokens": ["--dispatch-tokens", "8"]}
ENV = ("DLLAMA_KV_QUANT", "DLLAMA_LOG_JSON", "DLLAMA_TP_SCHEME")


def _pieces(out):
    return [ln.rsplit("'", 2)[-2] for ln in out.splitlines()
            if ln.startswith("🔶")]


@pytest.fixture
def clean_env(monkeypatch):
    """Both CLIs export --kv-quant (and --log-json, --tp-scheme) into the
    environment: set each key so monkeypatch restores it, then clear it."""
    for key in ENV:
        monkeypatch.setenv(key, "")
        monkeypatch.delenv(key)
    return monkeypatch


@pytest.fixture(scope="module")
def jax_plain(model_files):  # noqa: F811
    """The JAX CLI's rc and greedy stream without the flags (--tp 1: one
    device, as the port runs)."""
    import contextlib
    import io
    import os

    from distributed_llama_tpu.frontend.cli import main as ref_main

    model, tok = model_files
    saved = {k: os.environ.pop(k) for k in ENV if k in os.environ}
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = ref_main(["inference", "--model", model, "--tokenizer",
                           tok, *BASE, "--tp", "1"])
    finally:
        for k in ENV:
            os.environ.pop(k, None)
        os.environ.update(saved)
    return rc, _pieces(buf.getvalue())


@pytest.mark.parametrize("name", sorted(PAGED))
def test_paged_flags_run_the_plain_stream(name, model_files,  # noqa: F811
                                          jax_plain, capsys, clean_env):
    """With a page size the JAX CLI runs the plain path under each flag:
    rc 0 and the plain stream, which equals its run with the same argv."""
    import contextlib
    import io

    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tok = model_files
    files = ["--model", model, "--tokenizer", tok]
    rc = main(["inference", *files, *BASE, *PAGED[name], "--device", "cpu"])
    got = rc, _pieces(capsys.readouterr().out)
    for key in ENV:
        clean_env.delenv(key, raising=False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_rc = ref_main(["inference", *files, *BASE, *PAGED[name],
                           "--tp", "1"])
    assert (jax_rc, _pieces(buf.getvalue())) == jax_plain
    assert got == jax_plain and got[0] == 0 and len(got[1]) > 4


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_paged_flags_without_a_page_size_exit_2(name, tmp_path, capsys,
                                                clean_env):
    """Without --kv-page-size the JAX CLI's check refuses the flag: exit 2
    and its message, before the (absent) model is read."""
    from distributed_llama_tpu.frontend.cli import \
        cmd_inference as jax_inference
    from distributed_llama_tpu_torch.frontend.cli import main

    base = ["--model", str(tmp_path / "absent.bin"), "--tokenizer",
            str(tmp_path / "absent.tok"), *BASE, *REFUSED[name]]
    rc = main(["inference", *base, "--device", "cpu"])
    err = capsys.readouterr().err
    for key in ENV:
        clean_env.delenv(key, raising=False)
    assert jax_inference(base) == 2
    assert rc == 2 and err == capsys.readouterr().err
    assert "--kv-page-size" in err and "not yet ported" not in err
