"""The port's ``inference`` CLI (``--device cpu``) and generation loop against
the JAX package's ``generate`` on the tests/test_generate_cli.py fixture
model: token streams must be equal, greedy and seeded (temperature 0.8,
top-p 0.9, the numpy sampler on both sides), token by token and with
``--prefill-chunk``, q80 buffers, ``--fast-prefill`` and a bf16 KV cache,
``--profile`` / DLLAMA_PROFILE_DIR and ``--save-state`` / ``--resume-state``.
Unported flags exit 2 before the model loads; the CUDA default fails
without a GPU."""

import ast
import re

import numpy as np
import pytest
import torch

from distributed_llama_tpu.io.loader import write_model
from distributed_llama_tpu.io.tokenizer import write_tokenizer
from distributed_llama_tpu.models.spec import TransformerSpec
from distributed_llama_tpu.ops.quants import FloatType

SPEC = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                       n_kv_heads=2, vocab_size=300, seq_len=32,
                       weights_float_type=FloatType.Q40)
PROMPT = "hi"


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
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
    scores = [0.0] * len(pieces)
    scores[pieces.index(b"hi")] = -0.5
    scores[pieces.index(b" hi")] = -0.4
    tok = str(d / "tok.bin")
    write_tokenizer(tok, pieces, scores)
    return model, tok


def _ref_stream(model, tokp, temperature, topp, seed, steps):
    from distributed_llama_tpu.io.loader import load_model
    from distributed_llama_tpu.io.tokenizer import Tokenizer
    from distributed_llama_tpu.runtime.generate import Engine, generate
    from distributed_llama_tpu.runtime.sampling import Sampler

    spec, params = load_model(model, weights_float_type=FloatType.Q40)
    sampler = Sampler(spec.vocab_size, temperature, topp, seed,
                      use_native=False)
    out, _ = generate(Engine(spec, params), Tokenizer(tokp, spec.vocab_size),
                      sampler, PROMPT, steps, quiet=True)
    return out


SAMPLING = {"greedy": (0.0, 0.9, 1), "seeded": (0.8, 0.9, 42)}


@pytest.mark.parametrize("mode", sorted(SAMPLING))
def test_generate_stream_matches_reference(model_files, mode):
    from distributed_llama_tpu_torch.io.loader import load_model
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.ops.quants import FloatType as PFT
    from distributed_llama_tpu_torch.runtime.generate import Engine, generate
    from distributed_llama_tpu_torch.runtime.sampling import Sampler

    model, tokp = model_files
    temperature, topp, seed = SAMPLING[mode]
    steps = 24
    want = _ref_stream(model, tokp, temperature, topp, seed, steps)
    spec, params = load_model(model, weights_float_type=PFT.Q40)
    engine = Engine(spec, params, "cpu")
    tok = Tokenizer(tokp, spec.vocab_size)
    got, stats = generate(engine, tok, Sampler(spec.vocab_size, temperature,
                                               topp, seed),
                          PROMPT, steps, quiet=True)
    assert got == want
    assert stats.tokens >= len(got) > 4 and stats.total_ms > 0
    # reset() gives a fresh cache: the same greedy prefix again
    if mode == "greedy":
        engine.reset()
        again, _ = generate(engine, tok, Sampler(spec.vocab_size, 0.0, 0.9,
                                                 1), PROMPT, steps,
                            quiet=True)
        assert again == got


@pytest.mark.parametrize("mode", sorted(SAMPLING))
def test_cli_pieces_match_reference(model_files, capsys, mode):
    """The 🔶 per-token lines carry the same pieces as the JAX CLI's."""
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tokp = model_files
    temperature, topp, seed = SAMPLING[mode]
    base = ["--model", model, "--tokenizer", tokp, "--prompt", PROMPT,
            "--steps", "12", "--temperature", str(temperature), "--topp",
            str(topp), "--seed", str(seed)]

    def pieces(out):
        lines = [ln for ln in out.splitlines() if ln.startswith("🔶")]
        return [ln.rsplit("'", 2)[-2] for ln in lines]

    assert ref_main(["inference", *base, "--tp", "1"]) == 0
    want = pieces(capsys.readouterr().out)
    assert main(["inference", *base, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "💡 dim: 64" in out and "⏩ Loaded model in" in out
    assert "Avg generation time" in out and "Latency ms/token" in out
    assert len(want) > 4
    assert pieces(out) == want


UNPORTED = [["--tp", "2", "--profile", "d"], ["--sp", "2"],
            # --slots and --continuous are ported with --prompts-file;
            # --spec-k and --metrics are not ported there
            ["--slots", "4", "--prompts-file", "p.txt", "--continuous",
             "--spec-k", "4"],
            ["--kv-pages", "64"], ["--dispatch-tokens", "8"],
            ["--block-steps", "4"], ["--kv-host-pages", "8"],
            ["--stream-slices"],
            ["--continuous", "--prompts-file", "p.txt", "--metrics"],
            ["--metrics"],
            ["--log-json"],
            # --prompts-file --continuous is ported; --dispatch-tokens is
            # not, and stops the run before the (absent) prompts file is
            # opened
            ["--prompts-file", "p.txt", "--continuous", "--dispatch-tokens",
             "8"],
            # the continuous engine's flags outside --prompts-file
            ["--kv-page-size", "16"], ["--spec-k", "4"],
            ["--kv-quant", "q8"],
            # the tp flags are ported: the next flag is the one named
            ["--tp-scheme", "fused", "--sp", "2"],
            ["--workers", "10.0.0.2:9998", "--stream-slices"],
            ["--coordinator", "h:1", "--seed", "1", "--log-json"],
            ["--model-from-root", "h:1"]]
CONTINUOUS_FLAGS = ("--continuous", "--slots", "--block-steps", "--kv-pages",
                    "--kv-page-size", "--kv-quant")


def _unported_flag(extra):
    """The flag the error must name: the first one that is not ported in
    this combination (the continuous engine's flags are ported with
    --prompts-file --continuous; the tensor-parallel ones everywhere)."""
    ported = ("--fast", "--prompts-file", "--tp", "--tp-scheme",
              "--workers", "--coordinator", "--seed")
    if "--continuous" in extra and "--prompts-file" in extra:
        ported += CONTINUOUS_FLAGS
    return next(a for a in extra if a.startswith("--") and a not in ported)


@pytest.mark.parametrize("extra", UNPORTED, ids=lambda a: a[0])
def test_unported_flags_exit_2_before_loading(extra, capsys, tmp_path):
    """The model path does not exist: exit 2 proves the CLI stopped before
    any load."""
    from distributed_llama_tpu_torch.frontend.cli import main

    rc = main(["inference", "--model", str(tmp_path / "absent.bin"),
               "--tokenizer", str(tmp_path / "absent.tok"), "--device",
               "cpu", *extra])
    assert rc == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err and _unported_flag(extra) in err


@pytest.mark.parametrize("chunk", [[], ["--prefill-chunk", "1"]],
                         ids=["no-chunk", "chunk-1"])
def test_fast_prefill_needs_a_chunk(chunk, capsys, tmp_path):
    """--fast-prefill without --prefill-chunk N (N > 1) exits 2 with the JAX
    CLI's message, before any load (the model path does not exist)."""
    from distributed_llama_tpu_torch.frontend.cli import main

    rc = main(["inference", "--model", str(tmp_path / "absent.bin"),
               "--tokenizer", str(tmp_path / "absent.tok"), "--device",
               "cpu", *chunk, "--fast-prefill"])
    assert rc == 2
    assert capsys.readouterr().err.strip() == (
        "--fast-prefill only affects chunked prefill; pass --prefill-chunk "
        "N (N > 1)")


LONG_PROMPT = " ".join(["hi"] * 7)  # BOS + 7 merged " hi" pieces


def _lines(out):
    """The piece reprs the 🔶 lines end with."""
    return [ln.rsplit(" kB ", 1)[1] for ln in out.splitlines()
            if ln.startswith("🔶")]


@pytest.mark.parametrize("mode", sorted(SAMPLING))
@pytest.mark.parametrize("buf", ["f32", "q80"])
def test_cli_prefill_streams_match_reference(model_files, capsys, mode, buf):
    """``inference --prefill-chunk 4`` (f32 and q80 buffers) on the CPU: the
    decoded pieces equal those of the JAX ``generate(..., prefill_chunk=4)``
    stream (numpy sampler) and the tail of the port's own token-by-token
    run; the prompt's positions print no 🔶 line."""
    import dataclasses

    from distributed_llama_tpu.io.loader import load_model
    from distributed_llama_tpu.io.tokenizer import Tokenizer
    from distributed_llama_tpu.runtime.generate import Engine, generate
    from distributed_llama_tpu.runtime.sampling import Sampler
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tokp = model_files
    temperature, topp, seed = SAMPLING[mode]
    steps = 20
    spec, params = load_model(model, weights_float_type=FloatType.Q40)
    spec = dataclasses.replace(spec, buffer_float_type=FloatType[buf.upper()])
    tok = Tokenizer(tokp, spec.vocab_size)
    prompt = tok.encode(LONG_PROMPT, bos=True, eos=False)
    n_pre = len(prompt) - 1
    assert 2 <= n_pre < steps
    ref, _ = generate(Engine(spec, params), tok,
                      Sampler(spec.vocab_size, temperature, topp, seed,
                              use_native=False),
                      LONG_PROMPT, steps, quiet=True, prefill_chunk=4)
    assert ref[:n_pre] == prompt[1:]
    prev, want = prompt[-1], []
    for t in ref[n_pre:]:
        want.append(repr(tok.decode_piece(prev, t).decode(
            "utf-8", errors="replace")))
        prev = t

    base = ["inference", "--model", model, "--tokenizer", tokp, "--prompt",
            LONG_PROMPT, "--steps", str(steps), "--temperature",
            str(temperature), "--topp", str(topp), "--seed", str(seed),
            "--device", "cpu", "--buffer-float-type", buf]
    assert main(base + ["--prefill-chunk", "4"]) == 0
    got = _lines(capsys.readouterr().out)
    assert main(base) == 0
    stepwise = _lines(capsys.readouterr().out)
    assert len(got) > 4
    assert got == want
    assert stepwise[-len(got):] == got and len(stepwise) == n_pre + len(got)


def test_neutral_values_of_unported_flags_are_accepted(model_files):
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tokp = model_files
    assert main(["inference", "--model", model, "--tokenizer", tokp,
                 "--steps", "2", "--temperature", "0", "--device", "cpu",
                 "--tp", "1", "--sp", "1", "--prefill-chunk", "1",
                 "--kv-cache-dtype", "f32", "--buffer-float-type",
                 "f32"]) == 0


def test_default_device_fails_without_gpu(model_files, monkeypatch, capsys):
    from distributed_llama_tpu_torch.frontend.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, tokp = model_files
    rc = main(["inference", "--model", model, "--tokenizer", tokp])
    assert rc != 0
    assert "no GPU" in capsys.readouterr().err


@pytest.mark.parametrize("argv,rc", [(["serve"], 2), (["worker"], 2),
                                     (["train"], 2), (["convert"], 2),
                                     (["frobnicate"], 1), ([], 1)])
def test_modes(argv, rc, capsys):
    from distributed_llama_tpu_torch.frontend.cli import main

    assert main(argv) == rc


def test_python_dash_m_entry_point(model_files):
    """``python -m distributed_llama_tpu_torch inference`` runs."""
    import subprocess
    import sys

    model, tokp = model_files
    res = subprocess.run(
        [sys.executable, "-m", "distributed_llama_tpu_torch", "inference",
         "--model", model, "--tokenizer", tokp, "--prompt", PROMPT,
         "--steps", "4", "--temperature", "0", "--device", "cpu"],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("🔶") == 4


FAST_PROMPT = " ".join(["hi"] * 15)  # BOS + 15 pieces: more than a chunk
BF16_OPTIONS = {"fast": ["--prefill-chunk", "12", "--fast-prefill"],
                "bf16-cache": ["--kv-cache-dtype", "bf16"],
                "both": ["--prefill-chunk", "12", "--fast-prefill",
                         "--kv-cache-dtype", "bf16"]}


@pytest.mark.parametrize("mode", sorted(SAMPLING))
@pytest.mark.parametrize("opts", sorted(BF16_OPTIONS))
def test_cli_bf16_streams_match_reference(model_files, capsys, mode, opts):
    """``inference --device cpu`` with --fast-prefill at chunk 12 (the
    15-token prefix takes a full and a padded T=12 window through the bf16
    route), with --kv-cache-dtype bf16, and with both: the 🔶 pieces equal
    the JAX CLI's with the same flags, greedy and seeded. ``--steps`` lies
    above the prompt, or prefill would not run."""
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tokp = model_files
    temperature, topp, seed = SAMPLING[mode]
    steps = 28
    n_pre = len(Tokenizer(tokp, SPEC.vocab_size).encode(
        FAST_PROMPT, bos=True, eos=False)) - 1
    assert 12 < n_pre < steps
    base = ["inference", "--model", model, "--tokenizer", tokp, "--prompt",
            FAST_PROMPT, "--steps", str(steps), "--temperature",
            str(temperature), "--topp", str(topp), "--seed", str(seed),
            *BF16_OPTIONS[opts]]
    assert ref_main(base + ["--tp", "1"]) == 0
    want = _lines(capsys.readouterr().out)
    assert main(base + ["--device", "cpu"]) == 0
    got = _lines(capsys.readouterr().out)
    assert len(got) > 4
    assert got == want


# ---------------------------------------------------------------------------
# --fast and --prompts-file
# ---------------------------------------------------------------------------

def _fast_text(out):
    """The pieces line --fast prints before its stats."""
    lines = out.splitlines()
    i = next(i for i, ln in enumerate(lines)
             if ln.startswith("Generated tokens:"))
    return lines[i - 1]


FAST_OPTIONS = {"plain": [], "chunk": ["--prefill-chunk", "4"],
                "fast-prefill": ["--prefill-chunk", "12", "--fast-prefill",
                                 "--kv-cache-dtype", "bf16"],
                "q80": ["--buffer-float-type", "q80"]}


@pytest.mark.parametrize("mode", sorted(SAMPLING))
@pytest.mark.parametrize("opts", sorted(FAST_OPTIONS))
def test_cli_fast_matches_reference(model_files, capsys, mode, opts):
    """``inference --fast`` on the CPU prints the JAX CLI's text and device
    step count with the same flags, greedy and seeded, alone and with
    --prefill-chunk, --fast-prefill over a bf16 cache, and q80 buffers; its
    text is the per-step run's pieces."""
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tokp = model_files
    temperature, topp, seed = SAMPLING[mode]
    base = ["inference", "--model", model, "--tokenizer", tokp, "--prompt",
            FAST_PROMPT, "--steps", "24", "--temperature", str(temperature),
            "--topp", str(topp), "--seed", str(seed), *FAST_OPTIONS[opts]]
    assert ref_main(base + ["--tp", "1", "--fast"]) == 0
    ref_out = capsys.readouterr().out
    assert main(base + ["--device", "cpu", "--fast"]) == 0
    out = capsys.readouterr().out
    assert _fast_text(out) == _fast_text(ref_out)
    steps = re.findall(r"\(fused loop, (\d+) device steps\)", out)
    assert steps and steps == re.findall(
        r"\(fused loop, (\d+) device steps\)", ref_out)
    assert "🔶" not in out
    assert main(base + ["--device", "cpu"]) == 0
    stepwise = "".join(ast.literal_eval(p)
                       for p in _lines(capsys.readouterr().out))
    assert _fast_text(out).endswith(stepwise)


@pytest.fixture
def prompts_file(tmp_path):
    path = tmp_path / "prompts.txt"
    path.write_text("hi\nhi hi hi\n\n hi hi\nhi hi hi hi hi hi hi\n")
    return str(path)


@pytest.mark.parametrize("mode", sorted(SAMPLING))
@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_cli_prompts_file_matches_reference(model_files, prompts_file,
                                            capsys, mode, cache):
    """``inference --prompts-file`` on the CPU: the [b] row lines and the
    token count equal the JAX CLI's (blank lines skipped, 4 rows)."""
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tokp = model_files
    temperature, topp, seed = SAMPLING[mode]
    base = ["inference", "--model", model, "--tokenizer", tokp,
            "--prompts-file", prompts_file, "--steps", "16",
            "--temperature", str(temperature), "--topp", str(topp),
            "--seed", str(seed), "--kv-cache-dtype", cache]

    def rows(out):
        return [ln for ln in out.splitlines()
                if re.match(r"\[\d\] ", ln) or "across" in ln]

    assert ref_main(base + ["--tp", "1"]) == 0
    want = rows(capsys.readouterr().out)
    assert main(base + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert rows(out) == want and len(want) == 5
    assert "(4 rows x 16 lockstep steps)" in out


@pytest.mark.parametrize("flags,note", [
    (["--metrics"], "--metrics has nothing to collect"),
    (["--spec-k", "2", "--kv-page-size", "8"], "--spec-k only applies"),
    (["--kv-page-size", "8"], "--kv-page-size/--kv-quant only apply")])
def test_cli_prompts_file_notes_continuous_only_flags(model_files,
                                                      prompts_file, capsys,
                                                      flags, note):
    """Flags of the continuous engine print the JAX CLI's note on the
    lockstep path, and the batch runs."""
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tokp = model_files
    assert main(["inference", "--model", model, "--tokenizer", tokp,
                 "--prompts-file", prompts_file, "--steps", "4",
                 "--temperature", "0", "--device", "cpu", *flags]) == 0
    res = capsys.readouterr()
    assert note in res.err and "across 4 rows" in res.out


def test_cli_prompts_file_exit_2_paths(capsys, tmp_path):
    """Before any load (the model path does not exist): an empty prompts
    file, --prefill-chunk on the lockstep path and --spec-k without
    --kv-page-size exit 2 with the JAX CLI's messages."""
    from distributed_llama_tpu_torch.frontend.cli import main

    empty = tmp_path / "empty.txt"
    empty.write_text("\n  \n")
    base = ["inference", "--model", str(tmp_path / "absent.bin"),
            "--tokenizer", str(tmp_path / "absent.tok"), "--device", "cpu",
            "--prompts-file", str(empty)]
    assert main(base) == 2
    assert capsys.readouterr().err.strip() == "prompts file is empty"
    assert main(base + ["--prefill-chunk", "4"]) == 2
    assert capsys.readouterr().err.strip() == (
        "--prefill-chunk with --prompts-file needs --continuous (lockstep "
        "rows share the position clock)")
    assert main(base + ["--spec-k", "2"]) == 2
    assert capsys.readouterr().err.strip() == (
        "--spec-k needs the paged KV cache: add --kv-page-size P (with "
        "--continuous)")


# ---------------------------------------------------------------------------
# --continuous
# ---------------------------------------------------------------------------

@pytest.fixture
def continuous_prompts(tmp_path):
    """Prompts of 2 to 14 tokens whose leading " hi" pieces fill shared
    pages of 4 positions."""
    path = tmp_path / "continuous.txt"
    path.write_text("hi hi hi hi hi hi hi hi hi\nhi\n"
                    "hi hi hi hi hi hi hi hi hi hi hi hi hi\nhi hi hi hi\n"
                    "hi hi hi hi hi hi\n\nhi hi hi hi hi hi hi hi hi hi hi\n")
    return str(path)


CONTINUOUS_OPTIONS = {
    "contiguous": [],
    "contiguous-chunk-block": ["--prefill-chunk", "4", "--block-steps", "4",
                               "--kv-cache-dtype", "bf16"],
    "paged": ["--kv-page-size", "4"],
    "paged-chunk-block": ["--kv-page-size", "4", "--prefill-chunk", "4",
                          "--block-steps", "4"],
    "paged-q8": ["--kv-page-size", "4", "--kv-quant", "q8",
                 "--prefill-chunk", "4"],
    "paged-oversubscribed": ["--kv-page-size", "4", "--kv-pages", "12",
                             "--block-steps", "4"],
}


@pytest.mark.parametrize("mode", sorted(SAMPLING))
@pytest.mark.parametrize("opts", sorted(CONTINUOUS_OPTIONS))
def test_cli_continuous_matches_reference(model_files, continuous_prompts,
                                          capsys, monkeypatch, mode, opts):
    """``inference --prompts-file --continuous --slots 2`` on the CPU:
    the [i] rows, the token and step count line and the ``Paged KV:`` line
    equal the JAX CLI's with the same flags, greedy and seeded, contiguous
    and paged (f32 and q8 pages, prefix sharing, chunked admission prefill,
    fused block steps, an oversubscribed pool)."""
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    # the JAX CLI writes --kv-quant into DLLAMA_KV_QUANT: restore it after
    monkeypatch.setenv("DLLAMA_KV_QUANT", "")
    model, tokp = model_files
    temperature, topp, seed = SAMPLING[mode]
    base = ["inference", "--model", model, "--tokenizer", tokp,
            "--prompts-file", continuous_prompts, "--steps", "24",
            "--temperature", str(temperature), "--topp", str(topp),
            "--seed", str(seed), "--continuous", "--slots", "2",
            *CONTINUOUS_OPTIONS[opts]]

    def lines(out):
        return [ln for ln in out.splitlines()
                if re.match(r"\[\d\] ", ln) or ln.startswith(
                    ("Generated tokens:", "Paged KV:"))]

    assert ref_main(base + ["--tp", "1"]) == 0
    want = lines(capsys.readouterr().out)
    assert main(base + ["--device", "cpu"]) == 0
    got = lines(capsys.readouterr().out)
    assert got == want
    # a "[i] done" and a "[i] 'text'" line per request, then the stats
    assert len(want) == 13 + ("--kv-page-size" in base)
    assert "across 6 requests (2 slots," in want[12]
    if "--kv-page-size" in base:
        assert "prefix hit rate 0%" not in want[13]


@pytest.mark.parametrize("flags,message", [
    (["--kv-quant", "q8", "--continuous"],
     "--kv-quant q8 quantizes paged KV pages: add --kv-page-size P (with "
     "--continuous)"),
    (["--slots", "-1", "--continuous"],
     "--slots must be non-negative (0 = auto: min(#prompts, 8)), got -1")])
def test_cli_continuous_exit_2_paths(flags, message, capsys, tmp_path):
    """Before any load (the model path does not exist), with a prompts
    file: the JAX CLI's checks and messages."""
    from distributed_llama_tpu_torch.frontend.cli import main

    prompts = tmp_path / "p.txt"
    prompts.write_text("hi\n")
    rc = main(["inference", "--model", str(tmp_path / "absent.bin"),
               "--tokenizer", str(tmp_path / "absent.tok"), "--device",
               "cpu", "--prompts-file", str(prompts), *flags])
    assert rc == 2
    assert capsys.readouterr().err.strip() == message


# flags the JAX CLI accepts and ignores in these combinations: the port
# gives its exit code and its token stream
IGNORED = {"nthreads": ["--nthreads", "4"],
           "lockstep-slots": ["--prompts-file", "{prompts}", "--slots", "3"],
           "lockstep-block-steps": ["--prompts-file", "{prompts}",
                                    "--block-steps", "4"],
           "lockstep-kv-pages": ["--prompts-file", "{prompts}",
                                 "--kv-pages", "8"]}


@pytest.mark.parametrize("case", sorted(IGNORED))
def test_cli_ignored_flags_match_jax_cli(model_files, prompts_file, capsys,
                                         case):
    """--nthreads on the token-by-token path, and --slots, --block-steps
    and --kv-pages on the lockstep --prompts-file path without
    --continuous: both CLIs exit 0 with the same pieces (or rows)."""
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tokp = model_files
    extra = [a.format(prompts=prompts_file) for a in IGNORED[case]]
    base = ["inference", "--model", model, "--tokenizer", tokp, "--prompt",
            PROMPT, "--steps", "12", "--temperature", "0", "--seed", "1",
            *extra]

    def stream(out):
        return [ln for ln in out.splitlines()
                if ln.startswith("🔶") or re.match(r"\[\d\] ", ln)
                or "across" in ln]

    assert ref_main(base + ["--tp", "1"]) == 0
    want = [ln.rsplit(" kB ", 1)[-1] for ln in
            stream(capsys.readouterr().out)]
    assert main(base + ["--device", "cpu"]) == 0
    got = [ln.rsplit(" kB ", 1)[-1] for ln in
           stream(capsys.readouterr().out)]
    assert len(want) > 4
    assert got == want


def test_cli_continuous_kv_pages_without_page_size_matches_jax_cli(
        model_files, continuous_prompts, monkeypatch):
    """--continuous --kv-pages N without --kv-page-size: the argument
    checks pass in both CLIs and the engine raises the same ValueError
    after the load."""
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    monkeypatch.setenv("DLLAMA_KV_QUANT", "")
    model, tokp = model_files
    base = ["inference", "--model", model, "--tokenizer", tokp,
            "--prompts-file", continuous_prompts, "--steps", "12",
            "--temperature", "0", "--continuous", "--kv-pages", "8"]
    with pytest.raises(ValueError) as want:
        ref_main(base + ["--tp", "1"])
    with pytest.raises(ValueError) as got:
        main(base + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "kv_pages requires page_size > 0" in str(got.value)


@pytest.mark.parametrize("flags", [["--continuous"], ["--slots", "2"]])
def test_cli_continuous_needs_a_prompts_file(flags, capsys, tmp_path):
    from distributed_llama_tpu_torch.frontend.cli import main

    rc = main(["inference", "--model", str(tmp_path / "absent.bin"),
               "--tokenizer", str(tmp_path / "absent.tok"), "--device",
               "cpu", *flags])
    assert rc == 2
    assert capsys.readouterr().err.strip() == (
        "--continuous/--slots need --prompts-file (the request queue)")


def test_cli_continuous_reads_kv_quant_from_the_environment(
        model_files, continuous_prompts, capsys, monkeypatch):
    """DLLAMA_KV_QUANT=q8 without the flag gives q8 pages; an unknown value
    raises, as in the JAX package."""
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tokp = model_files
    base = ["inference", "--model", model, "--tokenizer", tokp,
            "--prompts-file", continuous_prompts, "--steps", "12",
            "--temperature", "0", "--continuous", "--kv-page-size", "4",
            "--device", "cpu"]
    monkeypatch.setenv("DLLAMA_KV_QUANT", "q8")
    assert main(base) == 0
    assert "positions (q8)" in capsys.readouterr().out
    monkeypatch.setenv("DLLAMA_KV_QUANT", "q4")
    with pytest.raises(ValueError, match="DLLAMA_KV_QUANT"):
        main(base)


# ---------------------------------------------------------------------------
# --profile, DLLAMA_PROFILE_DIR, --save-state, --resume-state
# ---------------------------------------------------------------------------

def _stream(out, fast):
    """The generated text: --fast's pieces line, or the pieces of the
    per-token 🔶 lines (not the 🔶 I/T line of --profile)."""
    if fast:
        return _fast_text(out)
    return "".join(ast.literal_eval(ln.rsplit(" kB ", 1)[1])
                   for ln in out.splitlines()
                   if ln.startswith("🔶") and " kB " in ln)


@pytest.mark.parametrize("how", ["flag", "env"])
@pytest.mark.parametrize("fast", [False, True], ids=["host-loop", "fast"])
def test_cli_profile_matches_reference(model_files, capsys, monkeypatch,
                                       tmp_path, how, fast):
    """--profile DIR and DLLAMA_PROFILE_DIR=DIR on the host loop and under
    --fast (seeded, with --prefill-chunk): the stream equals the run
    without them and the JAX CLI's; the trace is written and its I/T split
    printed with the prompt-prefill note."""
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tokp = model_files
    monkeypatch.delenv("DLLAMA_PROFILE_DIR", raising=False)
    base = ["inference", "--model", model, "--tokenizer", tokp, "--prompt",
            LONG_PROMPT, "--steps", "16", "--temperature", "0.8", "--topp",
            "0.9", "--seed", "42", "--prefill-chunk", "4",
            *(["--fast"] if fast else [])]
    assert ref_main(base + ["--tp", "1"]) == 0
    want = _stream(capsys.readouterr().out, fast)
    assert main(base + ["--device", "cpu"]) == 0
    plain = capsys.readouterr()
    trace_dir = tmp_path / "trace"
    if how == "flag":
        extra = ["--profile", str(trace_dir)]
    else:
        extra = []
        monkeypatch.setenv("DLLAMA_PROFILE_DIR", str(trace_dir))
    assert main(base + ["--device", "cpu", *extra]) == 0
    res = capsys.readouterr()
    assert len(want) > 4
    assert _stream(res.out, fast) == _stream(plain.out, fast) == want
    assert f"⏩ Profiler trace written to {trace_dir}" in res.out
    split = [ln for ln in res.out.splitlines() if ln.startswith("🔶 I ")]
    assert len(split) == 1 and "ms/token" in split[0]
    assert "trace includes ~8-token prompt prefill" in split[0]
    assert "I/T split unavailable" not in res.err
    assert list(trace_dir.glob("*.pt.trace.json"))
    assert "Profiler trace" not in plain.out


def test_cli_profile_of_an_unparsable_trace_still_succeeds(
        model_files, capsys, monkeypatch, tmp_path):
    """A trace the split cannot read prints the 💡 note on stderr and the
    run exits 0, as in the JAX CLI."""
    from distributed_llama_tpu_torch.frontend.cli import main
    from distributed_llama_tpu_torch.utils import it_split

    def broken(path):
        raise ValueError("no op events")

    monkeypatch.setattr(it_split, "parse_trace", broken)
    model, tokp = model_files
    assert main(["inference", "--model", model, "--tokenizer", tokp,
                 "--prompt", PROMPT, "--steps", "4", "--temperature", "0",
                 "--device", "cpu", "--profile", str(tmp_path / "t")]) == 0
    res = capsys.readouterr()
    assert "⏩ Profiler trace written to" in res.out
    assert res.err.startswith("💡 I/T split unavailable (ValueError: no op "
                              "events)")


RESUME = {"after-prompt": (PROMPT, "6", "8"),
          "mid-prompt": (LONG_PROMPT, "4", "12")}


@pytest.mark.parametrize("mode", sorted(SAMPLING))
@pytest.mark.parametrize("split", sorted(RESUME))
@pytest.mark.parametrize("fast", [False, True], ids=["host-loop", "fast"])
def test_cli_save_then_resume_matches_jax_cli(model_files, capsys, tmp_path,
                                              mode, split, fast):
    """--save-state after a first run, then --resume-state for more steps:
    the exit codes, the ⏩ lines and the joined stream equal the JAX CLI's
    with the same flags, and the joined stream is the unsplit run's."""
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tokp = model_files
    temperature, topp, seed = SAMPLING[mode]
    prompt, first, second = RESUME[split]
    base = ["inference", "--model", model, "--tokenizer", tokp, "--prompt",
            prompt, "--temperature", str(temperature), "--topp", str(topp),
            "--seed", str(seed), *(["--fast"] if fast else [])]

    def joined(cli, extra, tag):
        path = str(tmp_path / f"{tag}.npz")
        outs = []
        assert cli(base + ["--steps", first, "--save-state", path,
                           *extra]) == 0
        outs.append(capsys.readouterr().out)
        assert cli(base + ["--steps", second, "--resume-state", path,
                           *extra]) == 0
        outs.append(capsys.readouterr().out)
        notes = [ln.replace(path, "PATH") for out in outs
                 for ln in out.splitlines()
                 if ln.startswith(("⏩ Saved", "⏩ Resumed"))]
        return "".join(_stream(o, fast) for o in outs), notes

    want, want_notes = joined(ref_main, ["--tp", "1"], "jax")
    got, notes = joined(main, ["--device", "cpu"], "port")
    total = str(int(first) + int(second))
    assert main(base + ["--steps", total, "--device", "cpu"]) == 0
    unsplit = _stream(capsys.readouterr().out, fast)
    assert notes == want_notes and len(notes) == 2
    assert notes[1].startswith(f"⏩ Resumed at pos {first} (")
    assert len(want) > 4
    assert got == want == unsplit


@pytest.mark.parametrize("fast", [False, True], ids=["host-loop", "fast"])
def test_cli_nothing_resumable_after_zero_steps(model_files, capsys,
                                                tmp_path, fast):
    """--steps 0 --save-state: both CLIs exit 0 and print the same note,
    and no file is written."""
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tokp = model_files
    base = ["inference", "--model", model, "--tokenizer", tokp, "--prompt",
            PROMPT, "--steps", "0", "--temperature", "0",
            *(["--fast"] if fast else [])]
    notes = []
    for cli, extra, tag in ((ref_main, ["--tp", "1"], "jax"),
                            (main, ["--device", "cpu"], "port")):
        path = tmp_path / f"{tag}.npz"
        assert cli(base + ["--save-state", str(path), *extra]) == 0
        notes.append([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("💡 Generation ended")])
        assert not path.exists()
    assert notes[0] == notes[1] == [
        "💡 Generation ended (BOS or zero steps); nothing resumable to save"]


def test_cli_resume_into_another_cache_type_raises_the_jax_message(
        model_files, capsys, tmp_path):
    """A checkpoint of an f32-cache run resumed with --kv-cache-dtype bf16:
    the loader's ValueError, as the JAX CLI raises it."""
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tokp = model_files
    base = ["inference", "--model", model, "--tokenizer", tokp, "--prompt",
            PROMPT, "--temperature", "0"]
    path = str(tmp_path / "s.npz")
    assert main(base + ["--steps", "4", "--save-state", path, "--device",
                        "cpu"]) == 0
    resume = base + ["--steps", "4", "--resume-state", path,
                     "--kv-cache-dtype", "bf16"]
    with pytest.raises(ValueError) as want:
        ref_main(resume + ["--tp", "1"])
    with pytest.raises(ValueError) as got:
        main(resume + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "resume with the same --kv-cache-dtype" in str(got.value)


def test_cli_batch_path_ignores_profile_and_state_flags(
        model_files, prompts_file, capsys, tmp_path):
    """With --prompts-file the JAX CLI returns before its profile and
    checkpoint blocks: the port runs the batch, writes no trace and no
    checkpoint, and prints the same rows."""
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tokp = model_files
    base = ["inference", "--model", model, "--tokenizer", tokp,
            "--prompts-file", prompts_file, "--steps", "8",
            "--temperature", "0"]
    assert ref_main(base + ["--tp", "1"]) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if re.match(r"\[\d\] ", ln)]
    extra = ["--profile", str(tmp_path / "t"), "--save-state",
             str(tmp_path / "s.npz")]
    assert main(base + ["--device", "cpu", *extra]) == 0
    out = capsys.readouterr().out
    assert [ln for ln in out.splitlines() if re.match(r"\[\d\] ", ln)] == want
    assert len(want) == 4
    assert not (tmp_path / "t").exists() and not (tmp_path / "s.npz").exists()
