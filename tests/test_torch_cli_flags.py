"""Flags the JAX CLI runs its plain path under, against the JAX CLI: the f16
and q40 buffer types (the JAX package acts on the buffer type only at Q80,
so both run the f32 program) and the neutral values of flags whose feature
the port does not run on this path (--dispatch-tokens 0, --num-hosts 1,
--kv-host-pages 0, --spec-ngram N without --spec-k). On the
tests/test_torch_cli.py fixture model, greedy, the port (--device cpu) must
exit as the JAX CLI does (run with --tp 1) and print its token stream.
Values that need the paged pool exit 2 with the JAX CLI's message."""

import pytest
from test_torch_cli import model_files  # noqa: F401  (the fixture model)

BASE = ["--prompt", "hi", "--steps", "12", "--temperature", "0", "--seed",
        "1"]
FLAG_SETS = {
    "buffer-f16": ["--buffer-float-type", "f16"],
    "buffer-q40": ["--buffer-float-type", "q40"],
    "dispatch-tokens-0": ["--dispatch-tokens", "0"],
    "num-hosts-1": ["--num-hosts", "1"],
    "kv-host-pages-0": ["--kv-host-pages", "0"],
    "spec-ngram-5": ["--spec-ngram", "5"],
    "all-neutral": ["--buffer-float-type", "q40", "--dispatch-tokens", "0",
                    "--num-hosts", "1", "--kv-host-pages", "0",
                    "--spec-ngram", "3"],
}


def _pieces(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("🔶")]
    return [ln.rsplit("'", 2)[-2] for ln in lines]


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, _pieces(capsys.readouterr().out)


@pytest.fixture(scope="module")
def jax_streams(model_files):  # noqa: F811
    """The JAX CLI's exit code and stream, once without the flags and once
    with every neutral flag set (f16 and q40 runs share the f32 program):
    one reference run per stream."""
    import contextlib
    import io

    from distributed_llama_tpu.frontend.cli import main as ref_main

    model, tok = model_files
    files = ["--model", model, "--tokenizer", tok]
    runs = {}
    for name, extra in (("plain", []), ("all-neutral",
                                        FLAG_SETS["all-neutral"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ref_main(["inference", *files, *BASE, *extra, "--tp", "1"])
        runs[name] = rc, _pieces(buf.getvalue())
    return runs


def test_jax_cli_ignores_the_neutral_flags(jax_streams):
    rc, pieces = jax_streams["plain"]
    assert rc == 0 and len(pieces) > 4
    assert jax_streams["all-neutral"] == jax_streams["plain"]


@pytest.mark.parametrize("name", sorted(FLAG_SETS))
def test_port_runs_the_jax_stream_under_neutral_flags(model_files,  # noqa: F811
                                                      jax_streams, capsys,
                                                      name):
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tok = model_files
    got = _run(main, ["inference", "--model", model, "--tokenizer", tok,
                      *BASE, *FLAG_SETS[name], "--device", "cpu"], capsys)
    assert got == jax_streams["plain"]


@pytest.mark.parametrize("extra", [
    ["--dispatch-tokens", "-1"], ["--kv-host-pages", "8"],
    ["--spec-ngram", "3", "--spec-k", "4"]], ids=lambda a: "-".join(a[:2]))
def test_other_values_stay_unported(extra, capsys, tmp_path, monkeypatch):
    """The model path does not exist: exit 2 proves the CLI stopped before
    any load. Each value needs the paged pool, and without --kv-page-size
    the port exits 2 with the JAX CLI's own check and message."""
    from distributed_llama_tpu.frontend.cli import \
        cmd_inference as jax_inference
    from distributed_llama_tpu_torch.frontend.cli import main

    # both CLIs export --log-json, --kv-quant and --tp-scheme into the
    # environment: set each key (so monkeypatch restores it), then clear it
    for key in ("DLLAMA_KV_QUANT", "DLLAMA_LOG_JSON", "DLLAMA_TP_SCHEME"):
        monkeypatch.setenv(key, "")
        monkeypatch.delenv(key)
    base = ["--model", str(tmp_path / "absent.bin"),
            "--tokenizer", str(tmp_path / "absent.tok")]
    rc = main(["inference", *base, "--device", "cpu", *extra])
    assert rc == 2
    err = capsys.readouterr().err
    assert jax_inference([*base, *extra]) == 2
    assert err == capsys.readouterr().err and "--kv-page-size" in err
    assert "not yet ported" not in err
