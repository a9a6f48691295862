"""The port's shardcheck (distributed_llama_tpu_torch/analysis/
shardcheck.py) over the support matrix on one H100 80 GB: the full matrix
is clean, and each seeded mutant is reported as the JAX package's tests
report theirs (tests/test_shardcheck_repo.py): a replicated weight (J004),
a rogue dequant (J005), ragged heads (J006), a KV overshoot (the budget)
and a declared-unfit config that fits (drift). The JAX package's
run_shardcheck is not called (it traces with jax)."""

from __future__ import annotations

import dataclasses
import json
import textwrap
from pathlib import Path

import pytest

from distributed_llama_tpu_torch.analysis import shardcheck as S

PKG = Path(S.__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def results():
    return S.run_shardcheck()


def test_full_matrix_is_clean(results):
    bad = [f.render() for r in results for f in r.findings]
    assert bad == []
    assert len(results) == 72 + 12
    assert {r.config for r in results} == {e.label for e in S.SUPPORT_MATRIX}


def test_pinned_verdicts(results):
    by = {r.config: r for r in results}
    assert by["70b-tp1-fused-q40"].report.fits
    assert not by["70b-tp1-fused-f16"].report.fits
    assert all(r.report.fits == r.expect_fits for r in results)


def test_report_json_is_machine_readable(results):
    rep = json.loads(json.dumps(S.report_json(results)))
    assert rep["n_configs"] == len(results) and rep["n_violations"] == 0
    row = next(c for c in rep["configs"] if c["config"] == "7b-tp1-ref-q40")
    comp = row["report"]["components_bytes"]
    assert set(comp) == {"weights", "replicated", "rope", "kv_cache",
                         "activation", "workspace", "collective"}
    assert row["report"]["total_bytes"] == sum(comp.values())
    assert rep["capacity_bytes"] == 85_017_493_504


def _entry(label):
    return next(e for e in S.SUPPORT_MATRIX if e.label == label)


def test_replicated_weight_reports_j004():
    from distributed_llama_tpu_torch.parallel import tp as tp_mod

    entry = _entry("70b-tp8-fused-q40")
    spec = S.model_spec("70b", "q40")
    specs = tp_mod.param_specs(S.meta_params(spec), "fused")
    specs["wcls"] = None  # the seeded hazard: classifier on every rank
    res = S.check_config(entry, specs=specs, dequant=[])
    j004 = [f for f in res.findings if f.rule == "J004"]
    assert j004 and "wcls" in j004[0].detail and "REPLICATED" in \
        j004[0].detail, res.findings


def test_rogue_dequant_reports_j005(tmp_path):
    pkg = tmp_path / "pkg" / "runtime"
    pkg.mkdir(parents=True)
    (pkg / "rogue.py").write_text(textwrap.dedent("""
        from ..ops.quants import dequantize_q40_torch

        def fallback(w, x):
            return x @ dequantize_q40_torch(w.qs, w.d16).T
    """), encoding="utf-8")
    (pkg / "fine.py").write_text(textwrap.dedent("""
        def q40_matmul_plain(w, x):
            return x
    """), encoding="utf-8")
    found = S.check_dequant_sites(sorted(pkg.glob("*.py")), tmp_path)
    assert [f.rule for f in found] == ["J005"]
    assert "fallback()" in found[0].detail
    res = S.check_config(_entry("7b-tp1-fused-q40"), dequant=found)
    assert [f.rule for f in res.findings] == ["J005"]


def test_the_package_has_no_rogue_dequant():
    assert S.check_dequant_sites() == []


def test_dequant_registry_names_real_functions():
    import ast

    from distributed_llama_tpu_torch.ops import dequant_sites as D

    for suffix, name in D.ALLOWED_DEQUANT_SITES + D.DEQUANT_FUNCTIONS:
        tree = ast.parse((PKG / suffix).read_text(encoding="utf-8"))
        defs = {n.name for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef)}
        assert name in defs, (suffix, name)
    assert D.site_allowed("x/ops/q40.py", "q40_matmul_plain")
    assert not D.site_allowed("x/ops/q40.py", "q40_matmul")


def test_ragged_heads_report_j006():
    spec = dataclasses.replace(S.model_spec("7b", "q40"), n_heads=36,
                               n_kv_heads=36)
    res = S.check_config(_entry("7b-tp8-fused-q40"), spec=spec, dequant=[])
    j006 = [f for f in res.findings if f.rule == "J006"]
    assert j006 and "n_heads=36" in j006[0].detail


def test_block_boundary_reports_j006():
    # hidden 11040 / 8 = 1380 is not a 32-multiple: fused's input bands of
    # w2 would cut a Q40 block (ref's output bands do not)
    spec = dataclasses.replace(S.model_spec("7b", "q40"), hidden_dim=11040)
    res = S.check_uniform_shards(spec, 8, "fused", "7b-tp8-fused-q40")
    assert [f.rule for f in res] == ["J006"]
    assert S.check_uniform_shards(spec, 8, "ref", "7b-tp8-ref-q40") == []


def test_kv_overshoot_reports_the_budget():
    # 131072 positions of f32 cache: 128 GiB, past the card
    spec = dataclasses.replace(S.model_spec("7b", "q40"), seq_len=131072)
    res = S.check_config(_entry("7b-tp1-fused-q40"), spec=spec, dequant=[])
    budget = [f for f in res.findings if f.rule == "HBM-BUDGET"]
    assert budget and "declared to fit" in budget[0].detail


def test_declared_unfit_config_that_fits_is_drift(tmp_path):
    path = tmp_path / "m.json"
    path.write_text(json.dumps([
        {"model": "7b", "tp": 1, "scheme": "fused", "wtype": "q40",
         "expect_fits": False},
        {"model": "70b", "tp": 1, "scheme": "ref", "wtype": "f16",
         "expect_fits": False}]), encoding="utf-8")
    res = S.run_shardcheck(S.load_matrix(path))
    assert [r.ok for r in res] == [False, True]
    assert "declared NOT to fit" in res[0].findings[0].detail


def test_kv_quant_column_and_pool_equivalence():
    spec = S.model_spec("13b", "q40")
    assert S.check_kv_quant_pricing(spec, 8, "c") == []
    # one kv head of 20 values a rank: no whole 32-value Q80 block
    narrow = dataclasses.replace(spec, n_kv_heads=8, n_heads=8,
                                 dim=8 * 20)
    found = S.check_kv_quant_pricing(narrow, 8, "c")
    assert [f.rule for f in found] == ["KV-QUANT"]
    odd = dataclasses.replace(spec, seq_len=2047)
    assert [f.rule for f in S.check_paged_equivalence(odd, 1, "c", 0)] == \
        ["KV-PAGED"]
