"""Prefill/decode disaggregation across two of the port's HTTP servers
(runtime/server.py, ``disagg_role``), on the CPU:

* a prefill server and a decode server pointed at it answer greedy and
  seeded requests, streamed and not, with the single-pool server's tokens
  (the JAX single-pool server's too); the prompt's full pages cross the
  page channel, and both /health payloads carry the disagg block;
* short prompts run on the decode pool (verdict local); with the peer
  down every request is served locally, with the same tokens (verdict
  failed);
* a tiered server's /health has the JAX server's kv_tiers keys;
* ``serve``'s disaggregation and tier checks exit 2 with the JAX CLI's
  messages, and the 🌐 role banner is the JAX CLI's.
"""

import json
import re
import urllib.request

import pytest
import torch

from test_torch_cli import model_files  # noqa: F401  (the fixture)
from test_torch_server import _post, _server, _tokens

from distributed_llama_tpu.models.synth import synth_params
from test_torch_continuous import SPEC, _host


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    params = synth_params(SPEC, q40=True, seed=4, scale=0.3)
    return params, _host(params)


PAGED = dict(page_size=4, prefill_chunk=4, kv_pages=24)
# "hello there" and "good morning" span two and three full pages (BOS +
# bytes): they hand off; "hi" is short and runs on the decode pool
REQUESTS = [{"prompt": "hello there", "steps": 24},
            {"prompt": "good morning", "steps": 22, "stream": True},
            {"prompt": "hello there", "steps": 20, "temperature": 0.8,
             "topp": 0.9, "seed": 3},
            {"prompt": "good morning", "steps": 24, "temperature": 0.8,
             "seed": 9, "stream": True},
            {"prompt": "hi", "steps": 12}]


def _health(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                timeout=60) as r:
        return json.loads(r.read())


def _metric(port, line_start):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as r:
        text = r.read().decode()
    for line in text.splitlines():
        if line.startswith(line_start):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"{line_start} not exposed")


def _replies(port):
    return [_tokens(_post(port, dict(p))) for p in REQUESTS]


@pytest.fixture(scope="module")
def single(model):
    out = {}
    for package in ("port", "jax"):
        srv = _server(package, model, **PAGED)
        srv.start()
        try:
            out[package] = _replies(srv.port)
        finally:
            srv.stop()
    return out


def test_two_servers_give_the_single_pool_streams(model, single, tmp_path):
    from distributed_llama_tpu_torch.runtime.journal import RequestJournal

    pre = _server("port", model, disagg_role="prefill",
                  journal=RequestJournal(str(tmp_path / "pre.wal")),
                  **PAGED)
    pre.start()
    dec = _server("port", model, disagg_role="decode",
                  disagg_peer=f"127.0.0.1:{pre.port}", **PAGED)
    dec.start()
    try:
        got = _replies(dec.port)
        h_pre, h_dec = _health(pre.port), _health(dec.port)
        shipped = _metric(dec.port, 'dllama_handoff_requests_total'
                                    '{verdict="shipped"}')
        local = _metric(dec.port, 'dllama_handoff_requests_total'
                                  '{verdict="local"}')
        pages = _metric(pre.port, "dllama_dcn_pages_shipped_total")
        nbytes = _metric(pre.port, "dllama_dcn_bytes_total")
    finally:
        dec.stop()
        pre.stop()
    assert got == single["port"] == single["jax"]
    assert (shipped, local) == (4, 1)
    assert h_pre["disagg"]["role"] == "prefill"
    assert h_pre["disagg"]["page_channel_port"] == pre._page_channel.port
    assert h_pre["disagg"]["handoff_queue_depth"] == 0  # all acked
    assert h_dec["disagg"]["role"] == "decode"
    assert h_dec["disagg"]["pages_adopted"] >= 2
    from distributed_llama_tpu_torch.parallel.comm_stats import \
        dcn_handoff_budget

    # each handoff ships its prompt's full pages: the budget's pages and
    # bytes (positions = the prompt's tokens before the last)
    budgets = [dcn_handoff_budget(pre.spec, 1, len(p["prompt"]), 4)
               for p in REQUESTS[:4]]
    assert pages == sum(b["pages"] for b in budgets) == 10
    assert nbytes == sum(b["bytes"] for b in budgets)
    assert dec.engine.audit_pages() == [] == pre.engine.audit_pages()


def test_peer_down_serves_locally(model, single):
    from distributed_llama_tpu_torch.parallel.mesh import free_port

    dec = _server("port", model, disagg_role="decode",
                  disagg_peer=f"127.0.0.1:{free_port()}", **PAGED)
    dec.start()
    try:
        got = _replies(dec.port)
        failed = _metric(dec.port, 'dllama_handoff_requests_total'
                                   '{verdict="failed"}')
    finally:
        dec.stop()
    assert got == single["port"]
    assert failed == 4
    assert dec.engine.allocator.remote_adopted == 0


def test_tiered_health_has_the_jax_kv_tiers_block(model, tmp_path):
    blocks = {}
    for package in ("port", "jax"):
        srv = _server(package, model, kv_host_pages=4,
                      kv_disk_dir=str(tmp_path / package),
                      **{**PAGED, "kv_pages": 6})
        srv.start()
        try:
            for p in REQUESTS[:3]:
                _tokens(_post(srv.port, dict(p)))
            blocks[package] = _health(srv.port)["kv_tiers"]
        finally:
            srv.stop()
    port, jax = blocks["port"], blocks["jax"]
    assert sorted(port) == sorted(jax)
    assert port["host_capacity"] == jax["host_capacity"] == 4
    assert sorted(port["pages"]) == sorted(jax["pages"])
    assert sum(port["demotions"].values()) > 0


CHECKS = [["--disagg-role", "prefill"],
          ["--disagg-role", "decode", "--kv-page-size", "4"],
          ["--disagg-peer", "h:1", "--kv-page-size", "4"],
          ["--handoff-min-pages", "0"],
          ["--kv-host-pages", "-1", "--kv-page-size", "4"],
          ["--kv-host-pages", "4"],
          ["--kv-disk-gb", "1", "--kv-page-size", "4"]]


@pytest.mark.parametrize("argv", CHECKS, ids=lambda a: "_".join(a))
def test_disagg_and_tier_checks_give_the_jax_message(argv, tmp_path,
                                                     capsys):
    from test_torch_serve_cli import _both

    jax, port = _both(argv, tmp_path, capsys)
    assert port == jax and jax[0] == 2 and jax[1]


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_role_banner_is_the_jax_banner(model_files, role, capsys,  # noqa: F811
                                       monkeypatch):
    """Both CLIs build their server, print the 🌐 lines and (patched)
    start and stop it at once."""
    from distributed_llama_tpu.frontend.cli import cmd_serve as jax_serve
    from distributed_llama_tpu.runtime import server as ref_server
    from distributed_llama_tpu_torch.frontend.cli import main
    from distributed_llama_tpu_torch.runtime import server

    for mod in (ref_server, server):
        monkeypatch.setattr(mod.InferenceServer, "serve_forever",
                            lambda self: (self.start(), self.stop()))
    model, tok = model_files
    argv = ["--model", model, "--tokenizer", tok, "--port", "0",
            "--slots", "1", "--kv-page-size", "4", "--seed", "1",
            "--disagg-role", role]
    if role == "decode":
        argv += ["--disagg-peer", "127.0.0.1:9", "--handoff-min-pages",
                 "3"]

    def banner(out):
        return [re.sub(r"port \d+", "port N", ln)
                for ln in out.splitlines() if "disagg role" in ln]

    assert jax_serve(argv) == 0
    want = banner(capsys.readouterr().out)
    assert main(["serve", *argv, "--device", "cpu"]) == 0
    got = banner(capsys.readouterr().out)
    assert got == want and len(got) == 1


def test_prefill_rpc_rejects_a_non_prefill_pool(model):
    srv = _server("port", model, **PAGED)
    srv.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/prefill",
            data=json.dumps({"tokens": [1, 2], "steps": 4}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 404
    finally:
        srv.stop()
