"""``serve --tp 2`` of the port on the CPU (rank 0 in the serve process,
one spawned gloo follower, runtime/tp_plan.py) against the JAX server at
tp 2 (a mesh over 2 of the host devices tests/conftest.py forces) and the
port's server at tp 1, on the tests/test_torch_tp_cli.py fixture model:

* six concurrent requests, greedy and seeded, give the same tokens on all
  three, over paged pages with admission prefill, with --spec-k 2, with
  --dispatch-tokens 8 and over Q8 pages (chained by --block-steps 4);
  /health's ``tp`` block counts the plans and no digest ever differed;
* a stream cancelled mid-flight (the client goes away) retires on both
  ranks, and the next request is served;
* the journal's config fingerprint records the tp scheme, not "single";
* a follower killed mid-burst makes rank 0 fail the burst (every client
  answered) and exit non-zero within the channel's timeout.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch
from test_torch_tp_cli import model_files  # noqa: F401  (the fixture model)

from distributed_llama_tpu_torch.runtime.tp_plan import DEFAULT_TIMEOUT_S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = DEFAULT_TIMEOUT_S  # the plan channel's
BURST = [{"prompt": "hi hi", "steps": 16, "temperature": 0},
         {"prompt": "hi", "steps": 14, "temperature": 0.8, "seed": 3,
          "stream": True},
         {"prompt": "hi hi hi hi hi", "steps": 20, "temperature": 0},
         {"prompt": "hi", "steps": 12, "temperature": 0.8, "seed": 9},
         {"prompt": "hi hi hi", "steps": 18, "temperature": 0,
          "stream": True},
         {"prompt": "hi hi hi hi", "steps": 22, "temperature": 0.8,
          "topp": 0.5, "seed": 21}]
CONFIGS = {
    "paged": ["--kv-page-size", "4", "--prefill-chunk", "4"],
    "spec": ["--kv-page-size", "4", "--spec-k", "2"],
    "mixed": ["--kv-page-size", "4", "--dispatch-tokens", "8"],
    "q8": ["--kv-page-size", "4", "--kv-quant", "q8", "--prefill-chunk",
           "4", "--block-steps", "4"],
}
_KW = {"--kv-page-size": "page_size", "--prefill-chunk": "prefill_chunk",
       "--spec-k": "spec_k", "--dispatch-tokens": "dispatch_tokens",
       "--kv-quant": "kv_quant", "--block-steps": "block_steps"}


ENV_KEYS = ("DLLAMA_KV_QUANT", "DLLAMA_LOG_JSON", "DLLAMA_TP_SCHEME")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """The CLIs' exported flags an earlier test in this process may have
    left (the serve children inherit the environment): set each key (so
    monkeypatch restores it), then clear it."""
    for key in ENV_KEYS:
        monkeypatch.setenv(key, "")
        monkeypatch.delenv(key)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Served:
    """A ``serve`` child of the port's CLI on the CPU."""

    def __init__(self, model_files, extra, env=None):  # noqa: F811
        model, tok, _ = model_files
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "distributed_llama_tpu_torch", "serve",
             "--device", "cpu", "--model", model, "--tokenizer", tok,
             "--port", "0", "--slots", "3", "--steps", "24", "--seed", "5",
             *extra],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env={**os.environ, "OMP_NUM_THREADS": "1",
                            **(env or {})})
        self.pids = []
        self.lines = []
        for line in self.proc.stdout:
            self.lines.append(line)
            m = re.search(r"follower pids ([\d ]+)\)", line)
            if m:
                self.pids = [int(p) for p in m.group(1).split()]
            m = re.search(r"serving on http://[\d.]+:(\d+)", line)
            if m:
                self.port = int(m.group(1))
            if "🌐 tp:" in line or ("serving on" in line
                                    and "--tp" not in extra):
                break
        else:
            raise AssertionError(f"no server: {self.proc.stderr.read()}")

    def health(self) -> dict:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}/health", timeout=30) as r:
            return json.loads(r.read())

    def stop(self) -> tuple[int, str]:
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(120)
        return rc, self.proc.stderr.read()


def _post(port, payload, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            if payload.get("stream"):
                return r.status, [json.loads(ln) for ln in r]
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _tokens(reply):
    status, body = reply
    assert status == 200, body
    if isinstance(body, list):
        assert body[-1]["done"] and "error" not in body[-1], body[-1]
        return [ln["token"] for ln in body[:-1]]
    return body["tokens"]


def _wait_journaled_open(path, n, timeout_s):
    """Poll the journal until ``n`` requests hold open (unretired)
    records, or the deadline passes; returns the last count seen."""
    from distributed_llama_tpu_torch.runtime.journal import load_journal

    deadline = time.time() + timeout_s
    seen = 0
    while True:
        try:
            seen = sum(e.status is None for e in load_journal(str(path)))
        except (OSError, ValueError):
            seen = 0  # not created yet, or caught mid-append
        if seen >= n or time.time() > deadline:
            return seen
        time.sleep(0.05)


def _burst(port, payloads=BURST):
    """Every payload at once, on its own thread: the replies in order."""
    out = [None] * len(payloads)

    def go(i):
        out[i] = _post(port, payloads[i])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _jax_tokens(model_files, extra):  # noqa: F811
    """The JAX server at tp 2 (a mesh over two host devices)."""
    from distributed_llama_tpu.io.loader import load_model
    from distributed_llama_tpu.io.tokenizer import Tokenizer
    from distributed_llama_tpu.ops.quants import FloatType
    from distributed_llama_tpu.parallel import make_mesh
    from distributed_llama_tpu.runtime.server import InferenceServer

    model, tok, _ = model_files
    spec, params = load_model(model, weights_float_type=FloatType.Q40)
    kw = {_KW[extra[i]]: (extra[i + 1] if extra[i] == "--kv-quant"
                          else int(extra[i + 1]))
          for i in range(0, len(extra), 2)}
    srv = InferenceServer(spec, params, Tokenizer(tok, spec.vocab_size),
                          "127.0.0.1", 0, 3, 24, 0.8, 0.9, 5,
                          mesh=make_mesh(tp=2), quiet=True, **kw)
    srv.start()
    try:
        return [_tokens(r) for r in _burst(srv.port)]
    finally:
        srv.stop()


def _port_tp1_tokens(model_files, extra, payloads=BURST):  # noqa: F811
    """The port's server on one device, in process."""
    from distributed_llama_tpu_torch.io.loader import load_model
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.ops.quants import FloatType
    from distributed_llama_tpu_torch.runtime.server import InferenceServer

    model, tok, _ = model_files
    spec, params = load_model(model, weights_float_type=FloatType.Q40)
    kw = {_KW[extra[i]]: (extra[i + 1] if extra[i] == "--kv-quant"
                          else int(extra[i + 1]))
          for i in range(0, len(extra), 2)}
    srv = InferenceServer(spec, params, Tokenizer(tok, spec.vocab_size),
                          "127.0.0.1", 0, 3, 24, 0.8, 0.9, 5, quiet=True,
                          device="cpu", **kw)
    srv.start()
    try:
        return [_tokens(r) for r in _burst(srv.port, payloads)]
    finally:
        srv.stop()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_served_streams_equal_jax_tp2_and_port_tp1(model_files,  # noqa: F811
                                                   name):
    extra = CONFIGS[name]
    child = Served(model_files, [*extra, "--tp", "2"])
    try:
        got = [_tokens(r) for r in _burst(child.port)]
        health = child.health()
    finally:
        rc, err = child.stop()
    assert rc == 0, err
    tp = health["tp"]
    assert tp["ranks"] == 2 and tp["backend"] == "gloo" and \
        tp["error"] is None and tp["plans_sent"] > 0
    assert sorted(tp["plan_ms"]) == ["digest", "pickle", "send"] and \
        all(v > 0 for v in tp["plan_ms"].values())
    assert all(len(t) > 4 for t in got)
    assert got == _port_tp1_tokens(model_files, extra)
    assert got == _jax_tokens(model_files, extra)


@pytest.mark.parametrize("device,gpus,ranks,want", [
    ("cpu", 0, 2, "gloo"), ("cuda", 1, 2, "gloo"), ("cuda", 2, 4, "gloo"),
    ("cuda", 2, 2, "nccl"), ("cuda", 8, 4, "nccl"), ("cuda", 0, 2, "nccl")])
def test_group_backend_shares_cards_only_when_ranks_outnumber_them(
        monkeypatch, device, gpus, ranks, want):
    """serve --tp N's backend: NCCL with a GPU a rank, gloo on the CPU or
    where the ranks outnumber the visible GPUs; with none visible NCCL,
    which check_tp refuses with the JAX message."""
    from distributed_llama_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: gpus > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    assert mesh.group_backend(ranks, device) == want
    if want == "nccl":  # serve checks only an NCCL group's devices
        assert (mesh.check_tp(ranks, device) is not None) == (gpus == 0)


def test_cancel_mid_stream_then_serve_again(model_files):  # noqa: F811
    child = Served(model_files, [*CONFIGS["paged"], "--tp", "2"])
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{child.port}/generate",
            data=json.dumps({"prompt": "hi hi", "steps": 30,
                             "temperature": 0, "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        r = urllib.request.urlopen(req, timeout=60)
        for _ in range(3):
            assert "token" in json.loads(r.readline())
        r.close()  # the client goes away mid-stream
        deadline = time.time() + 30
        while child.health()["active"] and time.time() < deadline:
            time.sleep(0.1)
        health = child.health()
        assert health["active"] == 0 and health["tp"]["error"] is None
        again = _tokens(_post(child.port, BURST[0]))
    finally:
        rc, err = child.stop()
    assert rc == 0, err
    assert again == _port_tp1_tokens(model_files, CONFIGS["paged"])[0]


def test_journal_records_the_tp_scheme_and_recovers_at_tp2(
        model_files, tmp_path):  # noqa: F811
    """Rank 0 alone writes the journal, whose fingerprint records the tp
    scheme; SIGTERM with greedy requests in flight (dispatches slowed by
    the chaos delay, no drain time) leaves them journaled, and the
    restarted group recovers them through its first plans and finishes
    each with the uninterrupted run's tokens."""
    from distributed_llama_tpu_torch.runtime.journal import load_journal

    path = tmp_path / "j.wal"
    flags = [*CONFIGS["paged"], "--tp", "2", "--journal", str(path)]
    env = {"DLLAMA_TP_SCHEME": "ref"}
    child = Served(model_files, [*flags, "--drain-s", "0", "--chaos",
                                 "step_delay_every=1,step_delay_ms=250"],
                   env=env)
    greedy = [{"prompt": " ".join(["hi"] * n), "steps": 30,
               "temperature": 0} for n in (2, 3, 5)]
    threads = [threading.Thread(target=_post, args=(child.port, p))
               for p in greedy]
    try:
        for t in threads:
            t.start()
        # in flight: every request journaled and still open (its admit
        # record reaches the file at the first dispatch's sync), however
        # slowly a loaded host serves the posts
        open_ = _wait_journaled_open(path, len(greedy), 60)
    finally:
        rc, err = child.stop()
    assert open_ == len(greedy), (open_, err[-2000:])
    for t in threads:
        t.join(60)
    assert rc == 0, err
    header = json.loads(path.read_text().splitlines()[0])
    assert header["config"]["tp_scheme"] == "ref"
    live = [e for e in load_journal(str(path)) if e.status is None]
    assert live
    again = Served(model_files, flags, env=env)
    try:
        recovered = "".join(again.lines)
        deadline = time.time() + 60
        while time.time() < deadline and any(
                e.status is None for e in load_journal(str(path))):
            time.sleep(0.2)
        health = again.health()
    finally:
        rc, err = again.stop()
    assert rc == 0, err
    assert f"recovered {len(live)} journaled requests" in recovered
    assert health["tp"]["error"] is None and health["tp"]["plans_sent"]
    entries = load_journal(str(path))
    assert all(e.status is not None for e in entries)
    # a finished life's stream: its prompt's echo (a recovered life's
    # prompt carries the first life's samples) and what it sampled
    finished = [e.tokens[1:] + e.sampled for e in entries
                if e.status == "done"]
    refs = _port_tp1_tokens(model_files, CONFIGS["paged"], greedy)
    assert len(finished) == len(greedy)
    assert sorted(finished) == sorted(refs)


def test_killed_follower_fails_the_burst_and_exits_nonzero(
        model_files):  # noqa: F811
    """Dispatches slowed by the chaos monkey's delay (rank 0 sleeps
    before each), so the burst is in flight when the follower dies."""
    child = Served(model_files, [*CONFIGS["paged"], "--tp", "2", "--chaos",
                                 "step_delay_every=1,step_delay_ms=40"])
    assert child.pids
    long = [{"prompt": "hi hi", "steps": 30, "temperature": 0,
             "stream": i % 2 == 0} for i in range(6)]
    replies = [None] * len(long)
    started = threading.Event()

    def go(i):
        if long[i]["stream"]:  # read line by line: the first token flags
            req = urllib.request.Request(
                f"http://127.0.0.1:{child.port}/generate",
                data=json.dumps(long[i]).encode(),
                headers={"Content-Type": "application/json"})
            lines = []
            with urllib.request.urlopen(req, timeout=TIMEOUT_S * 3) as r:
                for ln in r:
                    lines.append(json.loads(ln))
                    started.set()
            replies[i] = (200, lines)
        else:
            replies[i] = _post(child.port, long[i], timeout=TIMEOUT_S * 3)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    try:
        assert started.wait(TIMEOUT_S)
        t0 = time.time()
        os.kill(child.pids[0], signal.SIGKILL)
        rc = child.proc.wait(TIMEOUT_S * 3)
        took = time.time() - t0
    finally:
        if child.proc.poll() is None:  # never leave rank 0 behind
            child.proc.kill()
            child.proc.wait()
    for t in threads:
        t.join(TIMEOUT_S)
    err = child.proc.stderr.read()
    assert rc != 0 and took < TIMEOUT_S, (rc, took, err[-2000:])
    assert "the tp group failed" in err
    assert all(r is not None for r in replies)  # every client answered
    errors = 0
    for status, body in replies:
        if isinstance(body, list):  # a stream ends with its done line
            assert body[-1].get("done")
            errors += "error" in body[-1]
        else:
            assert status in (200, 500), body
            errors += status == 500
    assert errors  # the burst was failed, not finished
