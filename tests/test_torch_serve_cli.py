"""The port's ``serve`` mode (frontend/cli.cmd_serve) against the JAX
CLI's: every exit-2 check gives the JAX CLI's code and message for the
same argv, and a corrupt journal its exit 1, all before any load (the
model path does not exist). The disaggregation, KV tier, chaos and tp
flags are ported: their checks are the JAX CLI's, and an argv both CLIs
accept goes on to the load (FileNotFoundError on the absent model), or
with --supervise to the supervisor (recorded here, not spawned). Then ``python -m distributed_llama_tpu_torch serve
--device cpu --port 0`` as a child process: it prints the bound port,
answers a request, and on SIGTERM drains, exits 0 and leaves the
unfinished requests live in its journal; restarted on that journal it
says "recovered N" and finishes them."""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from test_torch_cli import model_files  # noqa: F401  (the fixture)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """Both CLIs export --kv-quant and --log-json into the environment:
    each key is set first, so monkeypatch restores it afterwards (a
    delenv of an absent key would restore nothing), then cleared."""
    for key in ("DLLAMA_KV_QUANT", "DLLAMA_LOG_JSON", "DLLAMA_TP_SCHEME"):
        monkeypatch.setenv(key, "")
        monkeypatch.delenv(key)


def _runs(argv, tmp_path):
    """The JAX CLI's and the port's serve on ``argv`` (absent model)."""
    from distributed_llama_tpu.frontend.cli import cmd_serve as jax_serve
    from distributed_llama_tpu_torch.frontend.cli import main

    base = ["--model", str(tmp_path / "absent.bin"), "--tokenizer",
            str(tmp_path / "absent.tok")]
    return (lambda: jax_serve(base + argv),
            lambda: main(["serve", *base, "--device", "cpu", *argv]))


def _both(argv, tmp_path, capsys):
    out = []
    for run in _runs(argv, tmp_path):
        rc = run()
        out.append((rc, capsys.readouterr().err))
        for key in ("DLLAMA_KV_QUANT", "DLLAMA_LOG_JSON"):
            os.environ.pop(key, None)
    return out


CHECKS = [["--slots", "0"], ["--fast-prefill", "--prefill-chunk", "1"],
          ["--spec-k", "4"],
          ["--spec-k", "4", "--kv-page-size", "4", "--dispatch-tokens", "8"],
          ["--dispatch-tokens", "8"], ["--kv-quant", "q8"],
          ["--slo", "interactive:x"], ["--log-json", "--slots", "-1"]]


@pytest.mark.parametrize("argv", CHECKS, ids=lambda a: "_".join(a))
def test_exit_2_checks_give_the_jax_message(argv, tmp_path, capsys):
    jax, port = _both(argv, tmp_path, capsys)
    assert port == jax and jax[0] == 2 and jax[1]


def test_a_corrupt_journal_exits_1_as_jax(tmp_path, capsys):
    path = tmp_path / "j.wal"
    path.write_bytes(b'{"t":"journal","v":1}\n{"t":"tok","id":3,"tok":1,'
                     b'"cursor":0}\n{"t":"journal","v":1}\n')
    jax, port = _both(["--journal", str(path)], tmp_path, capsys)
    assert port == jax and jax[0] == 1 and "is corrupt" in jax[1]


REFUSED = [["--chaos", "step_delay_every=1"],
           ["--disagg-role", "prefill", "--kv-page-size", "4"],
           ["--disagg-peer", "h:1"], ["--page-channel-port", "9"],
           ["--handoff-min-pages", "3"],
           ["--kv-host-pages", "8", "--kv-page-size", "4"],
           ["--kv-disk-dir", "d"], ["--kv-disk-gb", "1"], ["--tp", "2"],
           ["--supervise", "--chaos", "x"]]


@pytest.mark.parametrize("argv", REFUSED, ids=lambda a: "_".join(a))
def test_unported_flags_exit_2_before_loading(argv, tmp_path, capsys,
                                              monkeypatch):
    """Every flag of serve is ported (--tp above 1 too): the JAX CLI's
    check and message, or, where both accept the argv, the load proceeds
    (FileNotFoundError on the absent model; under --tp 2 the port reads
    the header before it spawns a rank). With --supervise both re-exec
    first: the child command each would supervise is recorded instead
    of spawned."""
    from distributed_llama_tpu.runtime import supervisor as jax_sup
    from distributed_llama_tpu_torch.runtime import supervisor as port_sup

    flag = next(a for a in argv if a != "--supervise")
    children = []
    for mod in (jax_sup, port_sup):
        monkeypatch.setattr(mod, "supervise", lambda cmd, **kw:
                            children.append(cmd) or 0)
    outs = []
    for run in _runs(argv, tmp_path):
        try:
            outs.append((run(), capsys.readouterr().err))
        except FileNotFoundError as e:
            outs.append(("load", str(e)))
        for key in ("DLLAMA_KV_QUANT", "DLLAMA_LOG_JSON"):
            os.environ.pop(key, None)
    jax, port = outs
    assert port == jax and "not yet ported" not in str(port[1])
    if "--supervise" in argv:
        assert len(children) == 2 and all(
            flag in c and "--supervise" not in c for c in children)


class _Child:
    def __init__(self, model, tok, journal):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "distributed_llama_tpu_torch", "serve",
             "--model", model, "--tokenizer", tok, "--device", "cpu",
             "--port", "0", "--slots", "1", "--steps", "30",
             "--temperature", "0", "--seed", "1", "--kv-page-size", "4",
             "--prefill-chunk", "4", "--journal", journal, "--drain-s",
             "0"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
        self.lines, self.port = [], None
        self.ready = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()
        assert self.ready.wait(120), self.lines
        assert self.port, self.lines

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)
            m = re.search(r"🌐 serving on http://127.0.0.1:(\d+) ", line)
            if m:
                self.port = int(m.group(1))
                self.ready.set()
        self.ready.set()

    def post(self, body, lines=None):
        rq = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/generate",
            data=json.dumps(body).encode())
        with urllib.request.urlopen(rq, timeout=120) as r:
            if lines is None:
                return json.loads(r.read())
            for ln in r:
                lines.append(json.loads(ln))

    def health(self):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}/health", timeout=60) as r:
            return json.loads(r.read())

    def term(self):
        self.proc.send_signal(signal.SIGTERM)
        return self.proc.wait(60)


def test_serve_child_answers_drains_and_recovers(model_files, tmp_path):
    from distributed_llama_tpu_torch.runtime.journal import load_journal

    model, tok = model_files
    journal = str(tmp_path / "j.wal")
    child = _Child(model, tok, journal)
    try:
        reply = child.post({"prompt": "hi hi", "steps": 12})
        assert reply["steps"] == len(reply["tokens"]) > 0
        streams = [[], []]
        clients = [threading.Thread(target=child.post, args=(
            {"prompt": "hi", "steps": 30, "stream": True}, streams[i]))
            for i in range(2)]
        for t in clients:
            t.start()
        deadline = time.time() + 60
        while not streams[0] and time.time() < deadline:
            time.sleep(0.01)  # one slot: the second request waits
        assert child.term() == 0
        for t in clients:
            t.join(30)
    finally:
        if child.proc.poll() is None:
            child.proc.kill()
    assert any("🌐 drained" in ln for ln in child.lines), child.lines
    live = [e for e in load_journal(journal) if e.status is None]
    assert len(live) >= 1
    again = _Child(model, tok, journal)
    try:
        # the line follows the serving line the reader woke on
        deadline = time.time() + 60
        while time.time() < deadline:
            said = [ln for ln in again.lines if "🌐 recovered" in ln]
            if said or again.proc.poll() is not None:
                break
            time.sleep(0.01)
        assert said and f"recovered {len(live)} journaled" in said[0]
        deadline = time.time() + 60
        while time.time() < deadline:
            h = again.health()
            if h["active"] == 0 and h["queued"] == 0:
                break
            time.sleep(0.05)
        assert h["journal"]["recovered"] == len(live)
        assert again.term() == 0
    finally:
        if again.proc.poll() is None:
            again.proc.kill()
    assert not [e for e in load_journal(journal) if e.status is None]


def _families(text):
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def _events(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_inference_takes_metrics_and_log_json(model_files, tmp_path,
                                              capsys):
    """``inference --continuous --metrics`` prints the JAX CLI's exposition
    (its families, its request and token counts); ``--log-json`` turns the
    🔶 lines into the JAX CLI's NDJSON events."""
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    model, tok = model_files
    prompts = tmp_path / "p.txt"
    prompts.write_text("hi\nhi hi hi\n")
    base = ["inference", "--model", model, "--tokenizer", tok, "--steps",
            "16", "--temperature", "0", "--seed", "1"]
    cont = ["--prompts-file", str(prompts), "--continuous", "--metrics",
            "--kv-page-size", "4"]
    try:
        assert ref_main([*base, *cont, "--tp", "1"]) == 0
        want = capsys.readouterr().err
        assert main([*base, *cont, "--device", "cpu"]) == 0
        got = capsys.readouterr().err
        assert _families(got) == _families(want) and _families(got)
        for name in ("dllama_requests_total", "dllama_generated_tokens_total",
                     "dllama_engine_steps_total"):
            pick = re.compile(rf"^{name} (\S+)$", re.M)
            assert pick.findall(got) == pick.findall(want) != []
        one = ["--prompt", "hi hi", "--log-json"]
        assert ref_main([*base, *one, "--tp", "1"]) == 0
        want = _events(capsys.readouterr().out)
        assert main([*base, *one, "--device", "cpu"]) == 0
        got = _events(capsys.readouterr().out)
    finally:
        for key in ("DLLAMA_LOG_JSON", "DLLAMA_KV_QUANT"):
            os.environ.pop(key, None)
    assert [(e["event"], e.get("token")) for e in got] \
        == [(e["event"], e.get("token")) for e in want]
    assert {k for e in got for k in e} == {k for e in want for k in e}
