"""``serve --tp 2`` of the port with the KV tiers, either role of a
disaggregated pair, and chaos, on the CPU (gloo ranks; the
tests/test_torch_tp_cli.py fixture model):

* the tiers under tp 2 (a pool too small for the traffic, a host tier and
  a disk tier, so cold pages demote and prefix hits promote them) keep
  the port's untiered tp 1 streams;
* a tp 2 decode role fed by a tp 1 prefill role, and the reverse, serve
  the single-pool streams, and the pages and bytes the prefill role ships
  equal comm_stats.dcn_handoff_budget (a tp 2 prefill role gathers its
  ranks' bands first, so its pages are the tp 1 pool's);
* the engine drills that drive an engine step by step (pool exhaustion,
  transient starvation, oversized prompt, disconnect, latency spike, the
  tier spill storm) pass on every rank of a tp 2 group;
* ``serve --tp 2 --chaos`` keeps the streams, and the kill_tp_follower
  drill passes: a follower SIGKILLed mid-burst makes rank 0 fail the
  burst and exit non-zero within the timeout, and under ``--supervise``
  the group is respawned and serves again;
* a handoff and a page export that reach rank 0 while a plan is in
  flight ride the next plan (the follower adopts with rank 0; the export
  is gathered across the ranks).
"""

import os
import sys

import pytest
import torch
from test_torch_serve_tp import (TIMEOUT_S, Served, _burst,  # noqa: F401
                                 _clean_env, _port_tp1_tokens, _post,
                                 _tokens)
from test_torch_tp import spawn_ranks
from test_torch_tp_cli import model_files  # noqa: F401  (the fixture model)

PAGED = ["--kv-page-size", "4", "--prefill-chunk", "4"]


def _prompt(i: int) -> str:
    """Nine bytes (nine byte tokens after BOS: two full pages of 4),
    distinct for each i."""
    return "".join(chr(97 + (7 * i + j) % 26) for j in range(9))


# six distinct two-page prompts, greedy and seeded, half streamed
LONG = [{"prompt": _prompt(i), "steps": 16,
         **({"temperature": 0} if i % 2 else {"temperature": 0.8,
                                               "seed": 3 + i}),
         **({"stream": True} if i % 3 == 0 else {})} for i in range(6)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sequential(port, payloads):
    return [_tokens(_post(port, p)) for p in payloads]


def _metric(port, name):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        for line in r.read().decode().splitlines():
            if line.startswith(name + " ") or line.startswith(name + "{"):
                return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"{name} not exposed")


def test_tp2_tiers_keep_the_untiered_streams(model_files,  # noqa: F811
                                             tmp_path):
    waves = LONG + LONG[::-1]  # the second wave re-hits spilled prefixes
    child = Served(model_files, [*PAGED, "--tp", "2", "--slots", "2",
                                 "--kv-pages", "8", "--kv-host-pages", "3",
                                 "--kv-disk-dir", str(tmp_path / "d")])
    try:
        got = _sequential(child.port, waves)
        tiers = child.health()["kv_tiers"]
        tp = child.health()["tp"]
    finally:
        rc, err = child.stop()
    assert rc == 0, err
    assert tp["error"] is None
    assert sum(tiers["demotions"].values()) > 0
    assert sum(tiers["promotions"].values()) > 0
    want = _port_tp1_tokens(model_files, ["--kv-page-size", "4",
                                          "--prefill-chunk", "4"],
                            payloads=waves)
    assert got == want


@pytest.mark.parametrize("pre_tp,dec_tp", [(1, 2), (2, 1)])
def test_disagg_pair_across_tp(model_files, pre_tp, dec_tp,  # noqa: F811
                              tmp_path):
    from distributed_llama_tpu_torch.io.loader import read_spec
    from distributed_llama_tpu_torch.ops.quants import FloatType
    from distributed_llama_tpu_torch.parallel.comm_stats import \
        dcn_handoff_budget

    # a sampled stream's handoff carries its coin cursor: the prefill
    # role keeps a journal
    pre = Served(model_files, [*PAGED, "--disagg-role", "prefill",
                               "--journal", str(tmp_path / "pre.wal"),
                               *(["--tp", "2"] if pre_tp == 2 else [])])
    try:
        dec = Served(model_files, [*PAGED, "--disagg-role", "decode",
                                   "--disagg-peer",
                                   f"127.0.0.1:{pre.port}",
                                   *(["--tp", "2"] if dec_tp == 2 else [])])
        try:
            got = _sequential(dec.port, LONG)
            shipped = _metric(dec.port, 'dllama_handoff_requests_total'
                                        '{verdict="shipped"}')
            pages = _metric(pre.port, "dllama_dcn_pages_shipped_total")
            nbytes = _metric(pre.port, "dllama_dcn_bytes_total")
        finally:
            rc_dec, err_dec = dec.stop()
    finally:
        rc_pre, err_pre = pre.stop()
    assert rc_dec == 0 and rc_pre == 0, (err_dec, err_pre)
    assert got == _port_tp1_tokens(model_files, ["--kv-page-size", "4",
                                                 "--prefill-chunk", "4"],
                                   payloads=LONG)
    spec = read_spec(model_files[0], FloatType.Q40)
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer

    tok = Tokenizer(model_files[1], spec.vocab_size)
    budgets = [dcn_handoff_budget(spec, 1, len(tok.encode(
        p["prompt"], bos=True, eos=False)) - 1, 4) for p in LONG]
    assert all(b["pages"] == 2 for b in budgets)
    assert shipped == len(LONG)
    assert pages == sum(b["pages"] for b in budgets) > 0
    assert nbytes == sum(b["bytes"] for b in budgets)


ENGINE_DRILLS = ("pool_exhaustion", "transient_starvation",
                 "oversized_prompt", "disconnect", "latency_spike",
                 "tier_spill_storm")


def _drill_rank(rank, world, port, out):
    """One rank of a tp 2 group: the engine drills, each on a fresh tp
    engine over this rank's bands; rank 0 writes the verdicts."""
    import pickle

    from distributed_llama_tpu_torch.models.spec import TransformerSpec
    from distributed_llama_tpu_torch.models.synth import synth_params
    from distributed_llama_tpu_torch.obs.metrics import Registry
    from distributed_llama_tpu_torch.parallel.mesh import close, init_rank
    from distributed_llama_tpu_torch.parallel.tp import shard_params
    from distributed_llama_tpu_torch.runtime.chaos import run_drills
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine

    g = init_rank(rank, world, f"tcp://localhost:{port}", "cpu")
    # tests/test_torch_chaos.py's model and engine options
    spec = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=128, seq_len=32)
    tree = synth_params(spec, q40=False, seed=4, scale=0.3)
    bands = shard_params(tree, rank, world, "fused")
    kw = dict(slots=4, temperature=0.0, topp=0.9, seed=7, prefill_chunk=4,
              page_size=4, kv_pages=20, kv_tier_async=False)

    def make(chaos=None, **overrides):
        opts = {**kw, **overrides}
        if opts.get("kv_disk_dir"):  # each rank keeps its own disk tier
            opts["kv_disk_dir"] = os.path.join(opts["kv_disk_dir"],
                                               f"r{rank}")
        return ContinuousEngine(spec, bands, chaos=chaos,
                                metrics=Registry() if rank == 0 else None,
                                device="cpu", graph=False, mesh=g,
                                scheme="fused", **opts)

    res = run_drills(make, which=ENGINE_DRILLS, device="cpu")
    if rank == 0:
        with open(out, "wb") as fh:
            pickle.dump([(r.name, r.passed, r.violations) for r in res], fh)
    close(g)


def test_engine_drills_pass_on_every_rank_of_tp2(tmp_path):
    got = spawn_ranks(_drill_rank, 2, tmp_path / "drills.pkl")
    assert [name for name, _, _ in got] == list(ENGINE_DRILLS)
    assert all(passed for _, passed, _ in got), got


def _window_rank(rank, world, port, out):
    """One rank of a tp 2 group serving as a decode role (remote pages):
    rank 0 leads, rank 1 follows its plans. While rank 0's channel sends
    a plan (after the plan point took the inboxes), a handler thread's
    handoff (ingest_remote) and page export (export_prefix_sync) arrive;
    rank 0 writes the plans it sent, the export's answer and a first
    export's answer made through a plan of its own."""
    import pickle
    import threading

    from distributed_llama_tpu_torch.models.spec import TransformerSpec
    from distributed_llama_tpu_torch.models.synth import synth_params
    from distributed_llama_tpu_torch.parallel.mesh import close, init_rank
    from distributed_llama_tpu_torch.parallel.tp import shard_params
    from distributed_llama_tpu_torch.runtime.continuous import (
        ContinuousEngine, Request)
    from distributed_llama_tpu_torch.runtime.tp_plan import (PlanChannel,
                                                              PlanLeader,
                                                              follow_loop)

    g = init_rank(rank, world, f"tcp://localhost:{port}", "cpu")
    channel = PlanChannel(g)
    spec = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=128, seq_len=32)
    bands = shard_params(synth_params(spec, q40=False, seed=4, scale=0.3),
                         rank, world, "fused")
    engine = ContinuousEngine(spec, bands, slots=2, temperature=0.0,
                              topp=0.9, seed=7, prefill_chunk=4, page_size=4,
                              kv_pages=20, device="cpu", graph=False, mesh=g,
                              scheme="fused", remote_pages=True)
    if rank:
        follow_loop(engine, channel)
        engine.close()
        close(g)
        return
    engine.bind_plan(PlanLeader(channel))
    a = [1] + [5 + i for i in range(8)]  # two full pages of 4
    b = [1] + [40 + i for i in range(8)]

    def run():
        while engine.has_work():
            engine.step_many(1)

    req = engine.submit(Request(tokens=a, steps=12))
    run()
    assert req.done.is_set() and req.error is None
    first: dict = {}
    t = threading.Thread(target=lambda: first.update(
        planes=engine.export_prefix_sync(a, timeout=60)))
    t.start()
    while t.is_alive() and not engine.has_work():
        t.join(0.001)
    run()  # the export's own plan
    t.join(60)
    plans, late, real = [], {}, channel.send
    held = threading.Event()

    def send(plan):  # the window: the inboxes are taken, the plan in flight
        plans.append(plan)
        if not held.is_set():
            held.set()
            engine.ingest_remote(b, first["planes"],
                                 Request(tokens=b, steps=10))
            th = threading.Thread(target=lambda: late.update(
                planes=engine.export_prefix_sync(a, timeout=60)))
            th.start()
            while not engine._export_inbox:
                th.join(0.001)
            late["thread"] = th
        real(plan)

    channel.send = send
    engine.submit(Request(tokens=a, steps=12))
    run()
    late.pop("thread").join(60)
    channel.send = real
    channel.send_shutdown()
    engine.close()
    with open(out, "wb") as fh:
        pickle.dump(dict(first=first["planes"], late=late.get("planes"),
                         plans=[(p.remote and [p.remote[0][0]], p.exports)
                                for p in plans]), fh)
    close(g)


def test_handoffs_in_the_send_window_ride_the_next_plan(tmp_path):
    """A handoff and a page export that reach rank 0 while a plan is in
    flight go out in the next plan: the follower adopts the pages with
    rank 0 (it follows every plan, its digest equal; a rank-0-only
    adoption would part the books) and the export is gathered across the
    ranks (the full model's kv heads, as a first export through a plan of
    its own gave)."""
    import numpy as np

    got = spawn_ranks(_window_rank, 2, tmp_path / "window.pkl")
    b = [1] + [40 + i for i in range(8)]
    a = [1] + [5 + i for i in range(8)]
    assert got["plans"][0] == ([], [])  # in flight when they arrived
    assert got["plans"][1] == ([b], [a])  # the next plan carries both
    assert len(got["first"]) == 2 and len(got["late"]) == 2
    for want, have in zip(got["first"], got["late"]):
        assert len(want) == len(have)
        for x, y in zip(want, have):
            assert x.shape == y.shape and np.array_equal(x, y)
    # the full model's kv heads (n_kv_heads 2 over tp 2: one a rank)
    assert got["first"][0][0].shape[-2] == 2


def test_chaos_under_tp2_keeps_the_streams(model_files):  # noqa: F811
    child = Served(model_files, [*PAGED, "--tp", "2", "--chaos",
                                 "step_delay_every=3,step_delay_ms=2,"
                                 "deny_pages=3"])
    try:
        got = [_tokens(r) for r in _burst(child.port)]
        health = child.health()
    finally:
        rc, err = child.stop()
    assert rc == 0, err
    assert health["tp"]["error"] is None
    assert got == _port_tp1_tokens(model_files, PAGED)


@pytest.mark.parametrize("supervised", [True, False])
def test_kill_tp_follower_drill(model_files, supervised):  # noqa: F811
    from distributed_llama_tpu_torch.runtime.chaos import \
        drill_kill_tp_follower

    model, tok, _ = model_files
    cmd = [sys.executable, "-m", "distributed_llama_tpu_torch", "serve",
           *(["--supervise", "--max-restarts", "1"] if supervised else []),
           "--device", "cpu",
           "--model", model, "--tokenizer", tok, "--port", "0", "--slots",
           "3", "--seed", "5", "--tp", "2",
           *PAGED, "--chaos", "step_delay_every=1,step_delay_ms=40"]
    res = drill_kill_tp_follower(
        cmd, TIMEOUT_S, payloads=[{"prompt": "hi hi", "steps": 30,
                                   "temperature": 0, "stream": i % 2 == 0}
                                  for i in range(4)],
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.passed, res
    assert res.details["failed_requests"]
    assert res.details["rank0_exit_s"] < TIMEOUT_S
    if supervised:  # the supervisor respawned the group, which served
        assert res.details["respawned"]
    else:  # the serve process is rank 0: it exited non-zero
        assert res.details["rc"] not in (0, None)
