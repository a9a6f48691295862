"""``serve --chaos`` and the chaos-armed server, on the CPU:

* the port's CLI parses --chaos through ChaosMonkey.parse: a bad spec
  exits 2 with the JAX CLI's ``serve: …`` message, a good one prints the
  JAX CLI's 🔶 CHAOS ARMED banner on stderr and goes on to the load (at
  --tp 2 too);
* the server drops a disconnected stream's KV pages and counts an
  oversized prompt (the twins of tests/test_chaos.py's server cases);
* a server armed with ``step_delay_every=1`` has its stream open at
  stop(), which wakes and joins every thread and leaves the request live
  in the journal; its drain journals the remainder and answers the
  waiter 500 (the twins of tests/test_server.py's drain cases).
"""

import http.client
import json
import os
import threading
import time
import urllib.request

import pytest

from test_torch_server import (_IdTokenizer, _get, _one_thread,  # noqa: F401
                               _post, _server, model)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for key in ("DLLAMA_KV_QUANT", "DLLAMA_LOG_JSON", "DLLAMA_TP_SCHEME"):
        monkeypatch.setenv(key, "")
        monkeypatch.delenv(key)


def _serve_both(argv, tmp_path, capsys):
    """The JAX CLI's and the port's serve on ``argv`` over an absent
    model: (exit code or "load", stderr) each."""
    from distributed_llama_tpu.frontend.cli import cmd_serve as jax_serve
    from distributed_llama_tpu_torch.frontend.cli import main

    base = ["--model", str(tmp_path / "absent.bin"), "--tokenizer",
            str(tmp_path / "absent.tok")]
    outs = []
    for run in (lambda: jax_serve(base + argv),
                lambda: main(["serve", *base, "--device", "cpu", *argv])):
        try:
            rc = run()
        except FileNotFoundError:
            rc = "load"
        outs.append((rc, capsys.readouterr().err))
        for key in ("DLLAMA_KV_QUANT", "DLLAMA_LOG_JSON"):
            os.environ.pop(key, None)
    return outs


@pytest.mark.parametrize("spec", ["nope=1", "step_delay_every",
                                  "deny_pages=many"])
def test_bad_chaos_spec_exits_2_with_the_jax_message(spec, tmp_path,
                                                      capsys):
    jax, port = _serve_both(["--chaos", spec], tmp_path, capsys)
    assert port == jax and port[0] == 2
    assert port[1].startswith("serve: ")


def test_chaos_banner_on_stderr_then_the_load(tmp_path, capsys):
    spec = "step_delay_every=8,step_delay_ms=50,deny_pages=4"
    jax, port = _serve_both(["--chaos", spec], tmp_path, capsys)
    assert port == jax and port[0] == "load"
    banner = "🔶 CHAOS ARMED: deterministic fault injection is live"
    assert f"{banner} ({spec})" in port[1]


def test_tp_above_one_still_refused(tmp_path, capsys):
    """serve --tp 2 is ported: with --chaos it ends as the JAX CLI's does
    (the banner, then the load of the absent model; the port reads the
    header before it spawns a rank)."""
    jax, port = _serve_both(["--chaos", "deny_pages=1", "--tp", "2"],
                            tmp_path, capsys)
    assert port == jax and port[0] == "load"
    assert "CHAOS ARMED" in port[1] and "not yet ported" not in port[1]


def _metric(port, name):
    for line in _get(port, "/metrics").decode().splitlines():
        if line.startswith(name + " "):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"{name} not in /metrics")


def test_server_stream_disconnect_frees_kv_pages(model):
    srv = _server("port", model, steps=32, page_size=4, block_steps=4)
    srv.start()
    try:
        free_before = _metric(srv.port, "dllama_kv_pages_free")
        assert free_before == srv.engine.allocator.n_pages
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.request("POST", "/generate",
                     body=json.dumps({"prompt": "hello there", "steps": 32,
                                      "stream": True}))
        resp = conn.getresponse()
        resp.read(1)  # decoding in a slot, pages held
        conn.close()  # vanish mid-stream
        deadline = time.time() + 30
        while time.time() < deadline:
            h = json.loads(_get(srv.port, "/health"))
            if h["active"] == 0 and h["queued"] == 0 and _metric(
                    srv.port, "dllama_kv_pages_free") == free_before:
                break
            time.sleep(0.05)
        assert h["active"] == 0 and h["queued"] == 0, h
        assert _metric(srv.port, "dllama_kv_pages_free") == free_before
        assert srv.engine.audit_pages() == []
    finally:
        srv.stop()


def test_server_oversized_prompt_rejected_and_counted(model):
    srv = _server("port", model, steps=8)
    srv.start()
    try:
        status, body = _post(srv.port, {"prompt": "x" * 64, "steps": 8})
        assert status == 400 and "seq_len" in body["error"]
        text = _get(srv.port, "/metrics").decode()
        assert 'dllama_admission_rejected_total{reason="oversized"} 1' \
            in text
        h = json.loads(_get(srv.port, "/health"))
        assert h["admission_rejected"]["oversized"] == 1
    finally:
        srv.stop()


def _slow_server(model, tmp_path):
    from distributed_llama_tpu_torch.runtime.chaos import ChaosMonkey
    from distributed_llama_tpu_torch.runtime.journal import RequestJournal

    jpath = str(tmp_path / "j.journal")
    monkey = ChaosMonkey(step_delay_every=1, step_delay_s=0.2)
    srv = _server("port", model, steps=8, journal=RequestJournal(jpath),
                  page_size=4, kv_pages=24, chaos=monkey)
    return srv, jpath, monkey


def test_chaos_server_stop_with_open_stream_leaves_no_threads(model,
                                                              tmp_path):
    from distributed_llama_tpu_torch.runtime.journal import load_journal

    before = set(threading.enumerate())
    srv, jpath, monkey = _slow_server(model, tmp_path)
    srv.start()
    got: dict = {}

    def client():
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate",
            data=json.dumps({"prompt": "hello", "steps": 8,
                             "stream": True}).encode())
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                got["lines"] = [json.loads(ln) for ln in r if ln.strip()]
        except Exception as e:  # noqa: BLE001 - surfaced in the asserts
            got["error"] = e

    t = threading.Thread(target=client)
    t.start()
    deadline = time.time() + 30
    while time.time() < deadline and not srv._streams:
        time.sleep(0.01)
    assert srv._streams, "stream handler never registered"
    srv.stop()
    t.join(timeout=30)
    assert not t.is_alive()
    if "lines" in got:
        assert got["lines"][-1].get("error")
    deadline = time.time() + 10
    while time.time() < deadline:
        leaked = [th for th in set(threading.enumerate()) - before
                  if th.is_alive() and th is not t]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, leaked
    assert srv.health.state == "stopped"
    assert len([e for e in load_journal(jpath) if e.status is None]) == 1
    assert monkey.injected_delays >= 1


def test_chaos_server_drain_journals_remainder(model, tmp_path):
    from distributed_llama_tpu_torch.runtime.journal import load_journal

    srv, jpath, monkey = _slow_server(model, tmp_path)
    srv.start()
    got: dict = {}

    def client():
        got["reply"] = _post(srv.port, {"prompt": "hello", "steps": 8})

    t = threading.Thread(target=client)
    t.start()
    deadline = time.time() + 30
    while time.time() < deadline:
        with srv.engine._lock:
            queued = len(srv.engine._queue)
        if queued or any(not s.free for s in srv.engine._pool):
            break
        time.sleep(0.01)
    remainder = srv.drain(budget_s=0.05)  # far below the request
    assert remainder == 1
    t.join(timeout=30)
    assert not t.is_alive()
    assert got["reply"][0] == 500  # the waiter woke with the suspend error
    assert srv.health.state == "stopped"
    assert srv.engine.audit_pages() == []
    assert len([e for e in load_journal(jpath) if e.status is None]) == 1
    assert monkey.injected_delays >= 1
