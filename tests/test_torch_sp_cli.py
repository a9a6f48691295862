"""The port's ``inference --sp N`` on the CPU (gloo ranks of sp x tp, one
spawned process each) against the JAX CLI with the same flags
(tests/test_generate_cli.py runs the JAX CLI's --sp 2 lockstep batch):
the single prompt, the lockstep batch and the contiguous continuous
engine, greedy and seeded, print the JAX CLI's token streams; the sp 2 x
tp 2 mesh too; --save-state at sp 2 and --resume-state join to the
unsplit stream. The refusals are the JAX package's: the paged pool under
sp (alone, or under --spec-k or --dispatch-tokens) raises its ValueError,
and the overlap scheme exits 2 with its message."""

import re

import pytest
from test_torch_tp_cli import SAMPLING, model_files  # noqa: F401

STEPS = "24"  # past position 16: sp 2's chunk boundary on seq_len 32


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Both CLIs export --tp-scheme, --kv-quant and --log-json into the
    environment, where an earlier test in this process may have left
    them: set each key (so monkeypatch restores it), then clear it."""
    for key in ("DLLAMA_KV_QUANT", "DLLAMA_LOG_JSON", "DLLAMA_TP_SCHEME"):
        monkeypatch.setenv(key, "")
        monkeypatch.delenv(key)


def _pieces(out):
    """The piece reprs the 🔶 lines end with."""
    return [ln.rsplit(" kB ", 1)[1] for ln in out.splitlines()
            if ln.startswith("🔶")]


def _rows(out):
    return [ln for ln in out.splitlines() if re.match(r"^\[\d+\] ", ln)
            and "] done:" not in ln]


def _argv(model_files, mode, extra):  # noqa: F811
    model, tok, _ = model_files
    temperature, seed = SAMPLING[mode]
    return ["inference", "--model", model, "--tokenizer", tok, "--steps",
            STEPS, "--temperature", temperature, "--topp", "0.9", "--seed",
            seed, *extra]


def _both(model_files, capfd, argv, read):  # noqa: F811
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    assert ref_main(argv) == 0
    want = read(capfd.readouterr().out)
    assert main([*argv, "--device", "cpu"]) == 0
    out = capfd.readouterr().out
    return read(out), want, out


PATHS = {
    "single": (["--prompt", "hi hi hi hi hi hi hi", "--prefill-chunk", "4"],
               _pieces),
    "lockstep": (["--prompts-file", None], _rows),
    "continuous": (["--prompts-file", None, "--continuous", "--slots", "2",
                    "--prefill-chunk", "4"], _rows),
}


@pytest.mark.parametrize("mode", sorted(SAMPLING))
@pytest.mark.parametrize("path", sorted(PATHS))
def test_sp2_streams_are_the_jax_clis(model_files, capfd, path,  # noqa: F811
                                      mode):
    extra, read = PATHS[path]
    extra = [model_files[2] if a is None else a for a in extra]
    got, want, out = _both(model_files, capfd,
                           _argv(model_files, mode,
                                 [*extra, "--tp", "1", "--sp", "2"]), read)
    assert len(want) >= (6 if path == "single" else 2)
    assert got == want
    assert "💡 nSlices: 1 sp: 2 scheme: - (2 cpu ranks over gloo" in out
    if path == "single":
        assert re.search(r"SP collectives/token: +6 \(sp_pmax 2, sp_psum "
                         r"4\), budget 6 \(sp 2, \d+ bytes\)", out)


def test_sp2_tp2_stream_is_the_jax_clis(model_files, capfd):  # noqa: F811
    got, want, out = _both(model_files, capfd, _argv(
        model_files, "greedy", ["--prompt", "hi hi", "--tp", "2", "--sp",
                                "2"]), _pieces)
    assert len(want) > 6 and got == want
    assert "💡 nSlices: 2 sp: 2 scheme: fused (4 cpu ranks over gloo" in out
    assert out.count("💡 dim: 128") == 1  # global rank 0 alone prints


def test_sp2_save_then_resume_joins_the_unsplit_stream(
        model_files, capfd, tmp_path):  # noqa: F811
    from distributed_llama_tpu_torch.frontend.cli import main

    state = str(tmp_path / "s.npz")
    base = _argv(model_files, "seeded", ["--prompt", "hi hi", "--sp", "2",
                                         "--device", "cpu"])
    i = base.index("--steps")
    assert main(base) == 0
    whole = _pieces(capfd.readouterr().out)
    def steps(n):  # the resumed run's --steps counts the rest
        return base[:i + 1] + [n] + base[i + 2:]

    assert main([*steps("20"), "--save-state", state]) == 0
    head = _pieces(capfd.readouterr().out)
    assert main([*steps("4"), "--resume-state", state]) == 0
    out = capfd.readouterr().out
    assert "⏩ Resumed at pos 20" in out
    assert len(whole) > 18 and head + _pieces(out) == whole


REFUSED = {"paged": ["--kv-page-size", "4"],
           "spec": ["--kv-page-size", "4", "--spec-k", "2"],
           "mixed": ["--kv-page-size", "4", "--dispatch-tokens", "8"]}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_paged_under_sp_raises_the_jax_error(model_files, name):  # noqa: F811
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    argv = _argv(model_files, "greedy", ["--prompts-file", model_files[2],
                                         "--continuous", *REFUSED[name],
                                         "--tp", "1", "--sp", "2"])
    with pytest.raises(ValueError) as want:
        ref_main(argv)
    with pytest.raises(ValueError) as got:
        main([*argv, "--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "paged KV cache requires sp=1" in str(got.value)


def test_overlap_under_sp_exits_2(model_files, capsys):  # noqa: F811
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    argv = _argv(model_files, "greedy", ["--prompt", "hi", "--tp", "2",
                                         "--sp", "2", "--tp-scheme",
                                         "overlap"])
    assert main([*argv, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert ref_main(argv) == 2
    assert err == capsys.readouterr().err and "needs --sp 1" in err
