"""parallel/shard_sim.py of the port against the JAX package's:

* the modelled link ms (modeled_ici_ms, modeled_dcn_handoff_ms,
  modeled_overlap_hidden_ms, project_full_system with its speculative and
  mixed terms) equal JAX's at JAX's constants (rtol 1e-12);
* the simulated rank at tp 1 is the one-device forward exactly;
* the simulated rank's census equals comm_stats.tp_collective_budget
  under ref, fused and overlap at tp 2, 4 and 8 (a prefill chunk too);
  synth_rank_q40's bands have the rank's shapes under each scheme;
* a Chrome trace of ``inference --tp 2`` on gloo reconciles: counts equal
  to the budget exactly, coverage >= 0.95, the time check SKIPped.
"""

import os
import subprocess
import sys
from dataclasses import asdict

import numpy as np
import pytest
import torch
from test_torch_tp_cli import ROOT, model_files  # noqa: F401

from distributed_llama_tpu_torch.models.llama import (Llama, init_cache,
                                                      params_to_device)
from distributed_llama_tpu_torch.models.spec import TransformerSpec
from distributed_llama_tpu_torch.models.synth import synth_params
from distributed_llama_tpu_torch.ops.quants import FloatType
from distributed_llama_tpu_torch.parallel import shard_sim
from distributed_llama_tpu_torch.parallel.collectives import CENSUS
from distributed_llama_tpu_torch.parallel.comm_stats import \
    tp_collective_budget

SPEC = TransformerSpec(dim=256, hidden_dim=512, n_layers=2, n_heads=8,
                       n_kv_heads=8, vocab_size=128, seq_len=16,
                       weights_float_type=FloatType.Q40)
MODELS = ("7b", "13b", "70b", "small")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    from distributed_llama_tpu.obs import drift
    from distributed_llama_tpu.parallel import shard_sim as js

    return js, drift


def _specs(model):
    from distributed_llama_tpu_torch.obs.drift import spec_for

    js, drift = _jax()
    return spec_for(model)[0], drift.spec_for(model)[0]


@pytest.mark.parametrize("model", MODELS)
def test_modeled_ms_equal_jax_at_its_constants(model):
    js, _ = _jax()
    ps, jspec = _specs(model)
    kw = dict(gbps=js.V5E_ICI_GBPS_PER_DIRECTION,
              latency_us=js.ICI_COLLECTIVE_LATENCY_US)
    for tp in (2, 4, 8):
        for scheme in ("ref", "fused", "overlap"):
            np.testing.assert_allclose(
                shard_sim.modeled_ici_ms(ps, tp, scheme, **kw),
                js.modeled_ici_ms(jspec, tp, scheme, **kw), rtol=1e-12)
            got = shard_sim.project_full_system(ps, tp, 12.5,
                                                scheme=scheme, **kw)
            want = js.project_full_system(jspec, tp, 12.5, scheme=scheme,
                                          **kw)
            for field in ("shard_ms", "ici_bandwidth_ms", "ici_latency_ms",
                          "ici_hidden_ms", "total_ms",
                          "gather_bytes_per_chip", "n_collectives"):
                np.testing.assert_allclose(getattr(got, field),
                                           getattr(want, field), rtol=1e-12)
            assert asdict(got.speculative(4, 0.7)) == \
                asdict(want.speculative(4, 0.7))
            assert asdict(got.mixed(8)) == asdict(want.mixed(8))
        np.testing.assert_allclose(
            shard_sim.modeled_overlap_hidden_ms(ps, tp, 9.0, **kw),
            js.modeled_overlap_hidden_ms(jspec, tp, 9.0, **kw), rtol=1e-12)
        for quant in ("f32", "q8"):
            np.testing.assert_allclose(
                shard_sim.modeled_dcn_handoff_ms(ps, tp, 77, 16, quant,
                                                 gbps=3.0, latency_us=200.0),
                js.modeled_dcn_handoff_ms(jspec, tp, 77, 16, quant),
                rtol=1e-12)
    for alpha, k in ((0.0, 1), (0.5, 4), (1.0, 3)):
        assert shard_sim.expected_accepted_span(alpha, k) == \
            js.expected_accepted_span(alpha, k)


def test_card_constants_and_the_rank_memory():
    """The defaults are the card's (NVLink 4 a direction; planning
    latency), and a 70B tp 8 rank fits an 80 GB card."""
    assert shard_sim.NVLINK_GBPS_PER_DIRECTION == 450.0
    ps, _ = _specs("70b")
    bw, lat = shard_sim.modeled_ici_ms(ps, 8, "ref")
    assert lat == pytest.approx(321 * 7 * 2.0 / 1e3)
    proj = shard_sim.project_full_system(ps, 8, 50.0, scheme="ref")
    assert proj.hbm_fits and 5.0 < proj.hbm_per_device_gib < 6.5
    assert proj.total_ms == pytest.approx(50.0 + bw + lat)


def test_sim_at_tp1_is_the_one_device_forward():
    params = params_to_device(synth_params(SPEC, q40=True, seed=9), "cpu")
    want = Llama(SPEC, params).forward(init_cache(SPEC, "cpu"), [3, 11], 0)
    fwd = shard_sim.make_rank_forward(SPEC, 1, params)
    got = fwd.forward(shard_sim.init_rank_cache(SPEC, 1, "cpu"), [3, 11], 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("scheme", ["ref", "fused", "overlap"])
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_sim_census_equals_the_budget(scheme, tp):
    """A decode step and a 3-token chunk: each forward issues the
    budget's collectives, the chunk's bytes at t_len 3; the logits come
    back whole."""
    params = shard_sim.synth_rank_q40(SPEC, tp, seed=tp, scheme=scheme,
                                      device="cpu")
    fwd = shard_sim.make_rank_forward(SPEC, tp, params, scheme)
    cache = shard_sim.init_rank_cache(SPEC, tp, "cpu")
    for tokens, pos in (([5], 0), ([6, 7, 8], 1)):
        CENSUS.reset()
        logits = fwd.forward(cache, tokens, pos)
        budget = tp_collective_budget(SPEC, tp, scheme, t_len=len(tokens))
        assert {k: tuple(v) for k, v in CENSUS.counts.items()} == {
            k: (c, b) for k, c, b in budget.entries}
        assert tuple(logits.shape) == (len(tokens), SPEC.vocab_size)
        assert torch.isfinite(logits).all()
    assert fwd.group.backend == "sim"


@pytest.mark.parametrize("scheme", ["ref", "fused"])
def test_synth_rank_bands(scheme):
    """The JAX synth_rank_q40's band shapes, fused as the rank's device
    tree holds them; the same seed gives the same codes."""
    js, _ = _jax()
    tp = 4
    want = js.synth_rank_q40(SPEC, tp, seed=1, scheme=scheme)
    got = shard_sim.synth_rank_q40(SPEC, tp, seed=1, scheme=scheme,
                                   device="cpu")
    rows = {name: want[name].qs.shape[-3] for name in
            ("wq", "wk", "wv", "w1", "w3")}
    assert got["wqkv"].qs.shape == (2, rows["wq"] + rows["wk"] + rows["wv"],
                                    SPEC.dim // 32, 16)
    assert got["w13"].qs.shape == (2, rows["w1"] + rows["w3"],
                                   SPEC.dim // 32, 16)
    for name in ("wo", "w2", "wcls"):
        assert tuple(got[name].qs.shape) == want[name].qs.shape, name
        assert tuple(got[name].d16.shape) == want[name].d16.shape, name
        assert got[name].d16.dtype == torch.float16
        assert torch.isfinite(got[name].d16.float()).all()
    assert tuple(got["tok_embedding"].shape) == \
        want["tok_embedding"].shape
    again = shard_sim.synth_rank_q40(SPEC, tp, seed=1, scheme=scheme,
                                     device="cpu")
    assert torch.equal(again["w13"].qs, got["w13"].qs)
    with pytest.raises(ValueError, match="does not divide heads"):
        shard_sim.synth_rank_q40(SPEC, 3, device="cpu")


@pytest.mark.parametrize("scheme", ["ref", "fused", "overlap"])
def test_tp2_gloo_trace_reconciles(model_files, tmp_path, scheme):  # noqa: F811
    """``inference --tp 2 --profile`` on gloo ranks: rank 0's Chrome
    trace, reconciled against its .bin's spec, holds the budget's
    collectives exactly a forward (the prefill's skipped logits gather
    taken off), coverage >= 0.95, the time check SKIPped on gloo."""
    from distributed_llama_tpu_torch.obs.drift import reconcile_capture

    model, tok, _ = model_files
    prof = tmp_path / "prof"
    res = subprocess.run(
        [sys.executable, "-m", "distributed_llama_tpu_torch", "inference",
         "--model", model, "--tokenizer", tok, "--prompt", "hi hi hi hi",
         "--steps", "10", "--prefill-chunk", "4", "--temperature", "0",
         "--seed", "1", "--tp", "2", "--tp-scheme", scheme, "--device",
         "cpu", "--profile", str(prof)],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-2000:]
    att, report = reconcile_capture(str(prof / "rank0"), model=model, tp=2,
                                    scheme=scheme)
    rows = {(r.check, r.kind): r for r in report.rows}
    counts = [r for r in report.rows if r.check == "count"]
    assert counts and all(r.verdict == "OK" and r.threshold == "exact"
                          for r in counts)
    assert att.logits_skipped >= 1 and att.backend == "gloo"
    assert att.coverage >= 0.95
    assert rows["time", "step"].verdict == "SKIP"
    assert report.ok
