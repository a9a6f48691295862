"""tools/stream_compare.py's reading of the CLI's output, on the CPU: the
streams it takes from a single-prompt run and from a --continuous run, and
where two streams first differ."""

import numpy as np
import pytest

from distributed_llama_tpu_torch.tools import stream_compare


def test_streams_of_a_single_prompt_are_its_pieces():
    out = ("💡 prompt\n"
           "🔶 G   12 ms I   11 ms T    0 ms S      0 kB R      0 kB ' hi'\n"
           "🔶 G   12 ms I   11 ms T    0 ms S      0 kB R      0 kB 'tok9'\n"
           "Generated tokens:    2\n")
    assert stream_compare.streams(out, False) == [[" hi", "tok9"]]


def test_streams_of_a_continuous_run_are_its_rows():
    out = ("[0] hi hi a\n[1] hi hi bb\n[0] done: 4 tokens\n"
           "Generated tokens: 8 across 2 requests (8 slots, 5 steps)\n")
    assert stream_compare.streams(out, True) == [["hi hi a"], ["hi hi bb"]]


@pytest.mark.parametrize("a,b,want", [
    ([" hi", "tok9"], [" hi", "tok9"], None),
    ([" hi", "tok9"], [" hi", "tok8"], 1),
    ([" hi"], [" hi", "tok8"], 1),
    (["hi hi a"], ["hi hi a"], None),
    (["hi hi ab"], ["hi hi ac"], 7),
])
def test_first_difference(a, b, want):
    assert stream_compare.first_difference(a, b) == want


def test_fast_text_is_the_line_before_the_stats():
    out = ("💡 prompt\n hi hi tok9\n"
           "Generated tokens: 3 (fused loop, 3 device steps)\n")
    assert stream_compare.fast_text(out) == " hi hi tok9"


@pytest.mark.parametrize("char,want", [(0, 0), (2, 0), (3, 1), (6, 1),
                                       (7, 2), (9, 3)])
def test_piece_at_maps_a_character_to_its_piece(char, want):
    assert stream_compare.piece_at([" hi", "tok9", "!x"], char) == want


@pytest.mark.parametrize("at,tie", [(0, True), (1, False), (2, False)])
def test_near_tie_holds_the_gap_against_the_logit_tolerance(at, tie):
    gaps = [[0.005, 10.0], [0.5, 10.0]]  # tolerance 1e-3 x 10 = 0.01
    got, gap, tol = stream_compare.near_tie(at, gaps, 1e-3)
    assert got is tie
    if at < len(gaps):
        assert (gap, tol) == (gaps[at][0], 1e-3 * gaps[at][1])


def test_run_n_f32_is_run_n_without_q8_pages():
    """The n-f32 run keeps run n's oversubscribed pool and sampling and
    drops only its Q8 pages."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_flags", stream_compare.ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    runs = stream_compare._runs(smoke)
    n = runs["n"]
    i = n.index("--kv-quant")
    assert runs["n-f32"] == n[:i] + n[i + 2:]


def _chain(toks, used=None, logits=None):
    """A recording of chain steps as the chain script writes it: (steps,
    slots) tokens, every slot sampled unless ``used`` says otherwise, and
    logits of 3 values a slot."""
    toks = np.asarray(toks)
    used = np.ones(toks.shape, bool) if used is None else np.asarray(used)
    if logits is None:
        logits = np.tile(np.array([10.0, 9.0, -1.0], np.float32),
                         (*toks.shape, 1))
    return {"used": used, "toks": toks, "logits": logits}


def test_chain_parting_is_none_for_equal_steps():
    rec = _chain([[1, 2], [3, 4]])
    assert stream_compare.chain_parting(rec, rec, 1e-3) is None


@pytest.mark.parametrize("shift,tie", [(0.005, True), (0.02, False)])
def test_chain_parting_holds_the_logits_against_the_tolerance(shift, tie):
    """The first step and slot whose sampled tokens differ; the logits
    there are compared against 1e-3 x the reference's max |logit| (10)."""
    theirs = _chain([[1, 2], [3, 4], [5, 6]])
    ours = _chain([[1, 2], [3, 7], [8, 9]])
    ours["logits"] = ours["logits"].copy()
    ours["logits"][1, 1, 2] += shift
    got = stream_compare.chain_parting(ours, theirs, 1e-3)
    assert (got["step"], got["slot"], got["tie"]) == (1, 1, tie)
    assert got["err"] == pytest.approx(shift, rel=1e-3)
    assert got["tol"] == pytest.approx(0.01)


def test_chain_parting_skips_slots_not_sampled_and_flags_a_schedule():
    """A differing token in a slot that is forced or inactive is no
    parting; slots sampled on one side only part the schedule."""
    theirs = _chain([[1, 2], [3, 4]], used=[[True, False], [True, True]])
    ours = _chain([[1, 5], [3, 4]], used=[[True, False], [True, True]])
    assert stream_compare.chain_parting(ours, theirs, 1e-3) is None
    ours["used"] = np.array([[True, False], [False, True]])
    got = stream_compare.chain_parting(ours, theirs, 1e-3)
    assert (got["step"], got["slot"], got["tie"]) == (1, None, False)


def test_chain_script_records_the_streams_it_prints(tmp_path):
    """The chain script on the CPU: a sampled --continuous run over an
    oversubscribed pool of pages prints the plain CLI's streams, and every
    fused-chain step's slots, tokens and logits are recorded."""
    from distributed_llama_tpu.io.loader import write_model
    from distributed_llama_tpu.io.tokenizer import write_tokenizer
    from distributed_llama_tpu.models.spec import TransformerSpec
    from distributed_llama_tpu.ops.quants import FloatType

    spec = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=300, seq_len=32,
                           weights_float_type=FloatType.Q40)
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
    model, tok = tmp_path / "model.bin", tmp_path / "tok.bin"
    write_model(str(model), spec, tensors)
    pieces = [b"<unk>", b"<s>", b"</s>"]
    pieces += [f"<0x{i:02X}>".encode() for i in range(256)]
    pieces += [b" ", b"h", b"i", b"hi", b" hi"]
    pieces += [f"tok{i}".encode() for i in range(len(pieces),
                                                 spec.vocab_size)]
    write_tokenizer(str(tok), pieces, [0.0] * len(pieces))
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("hi hi hi hi hi\nhi\nhi hi hi hi hi hi hi hi\nhi hi\n")
    flags = ["--prompts-file", str(prompts), "--continuous", "--slots", "2",
             "--steps", "24", "--temperature", "0.8", "--seed", "7",
             "--kv-page-size", "4", "--kv-pages", "12", "--block-steps",
             "4", "--device", "cpu"]
    root = stream_compare.ROOT
    plain = stream_compare._cli(root, model, tok, flags)
    path = tmp_path / "chain.npz"
    spied = stream_compare._cli(root, model, tok, flags, chain=path)
    rows = stream_compare.streams(plain, True)
    assert len(rows) == 4
    assert stream_compare.streams(spied, True) == rows
    with np.load(path) as f:
        rec = {k: f[k] for k in f.files}
    steps = len(rec["used"])
    assert steps > 0 and rec["used"].any()
    assert rec["used"].shape == rec["toks"].shape == (steps, 2)
    assert rec["logits"].shape == (steps, 2, spec.vocab_size)
    assert np.isfinite(rec["logits"]).all()
    assert stream_compare.chain_parting(rec, rec, 1e-3) is None


def test_runs_h_and_p_are_runs_g_and_i_under_their_environment():
    """Run h is run g over a bf16 cache under DLLAMA_MULTI_T_BODY=dequant
    (K1d), run p run i under DLLAMA_LAYER_FUSION=on (K10), as chip_smoke.py
    drives them; run o is run a and run p-headtail run i under
    DLLAMA_LAYER_FUSION=headtail (K8, K9), both compared exactly."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_flags", stream_compare.ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    runs = stream_compare._runs(smoke)
    assert runs["h"] == [*runs["g"], "--kv-cache-dtype", "bf16"]
    assert runs["p"] == runs["i"]
    assert runs["o"] == runs["a"] and runs["p-headtail"] == runs["i"]
    assert stream_compare.RUN_ENV == {
        "h": {"DLLAMA_MULTI_T_BODY": "dequant"},
        "o": {"DLLAMA_LAYER_FUSION": "headtail"},
        "p": {"DLLAMA_LAYER_FUSION": "on"},
        "p-headtail": {"DLLAMA_LAYER_FUSION": "headtail"}}
    assert stream_compare.EXACT == ("o", "p-headtail")
