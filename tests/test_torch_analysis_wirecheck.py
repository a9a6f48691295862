"""The port's wirecheck (distributed_llama_tpu_torch/analysis/wirecheck.py
+ wiremodel.py) and its tools: the registry validates and declares every
format of the JAX registry plus the port's own (dispatch plans, the
.tkcache and .slices sidecars); each W-rule has firing, non-firing and
pragma fixtures, fired the same under the JAX package's checker (mini
registries built in each package's own classes); the port's tree holds no
finding, with an empty baseline; the port's tools/wirecheck.py skew
matrix exits 0 and each inject arm exactly 1; the port's
tools/make_wire_corpus.py writes the committed corpus byte for byte."""

from __future__ import annotations

import filecmp
import textwrap
from pathlib import Path

import pytest

from distributed_llama_tpu_torch.analysis import wiremodel as wm
from distributed_llama_tpu_torch.analysis.lint import (apply_baseline,
                                                       load_baseline,
                                                       write_baseline)
from distributed_llama_tpu_torch.analysis.wirecheck import (WIRE_RULES,
                                                            run_wirecheck,
                                                            wire_files,
                                                            wire_scope)

PKG = Path(wm.__file__).resolve().parents[1]
ROOT = PKG.parent
CORPUS = ROOT / "tests" / "fixtures" / "wire"


def _jax_wm():
    from distributed_llama_tpu.analysis import wiremodel as jwm

    return jwm


def _fmt(mod, **kw):
    base = dict(name="fix.rec", version=2, persistent=False,
                fields=(mod.WireField("a", "int"),
                        mod.WireField("opt", "int", required=False,
                                      default=0, since=1),
                        mod.WireField("maybe", "str", required=False,
                                      default=None, since=1)),
                producers=("runtime/wire.py:make",),
                consumers=("runtime/wire.py:read",))
    base.update(kw)
    return mod.WireFormat(**base)


def _codec(mod):
    return _fmt(mod, codec_pairs=(("runtime/wire.py:make",
                                   "runtime/wire.py:read"),))


def _persistent(mod, late_required):
    b = (mod.WireField("b", "int", since=2) if late_required else
         mod.WireField("b", "int", required=False, default=None, since=2))
    return _fmt(mod, persistent=True,
                fields=(mod.WireField("a", "int", since=1), b))


def _fams(mod):
    return {"dllama_known_total": mod.MetricFamily("dllama_known_total")}


# (id, path, source, formats(mod), families(mod), rules fired)
FIXTURES = [
    ("w001-fires", "runtime/wire.py", """
        def make(x):
            return {"a": x, "zzz": 1}

        def read(rec):
            return rec["a"]
    """, lambda m: (_fmt(m),), None, ["W001"]),
    ("w001-quiet", "runtime/wire.py", """
        def make(x, post):
            post(json={"unrelated": 1})
            rec = {"a": x}
            rec["opt"] = 2
            return rec

        def read(rec):
            return rec["a"]
    """, lambda m: (_fmt(m),), None, []),
    ("w001-pragma", "runtime/wire.py", """
        def make(x):
            # wirecheck: allow[W001] scratch key, stripped before send
            return {"a": x, "zzz": 1}

        def read(rec):
            return rec["a"]
    """, lambda m: (_fmt(m),), None, []),
    ("w002-unregistered", "runtime/wire.py", """
        def make(x):
            return {"a": x}

        def read(rec):
            return rec["a"], rec["nope"]
    """, lambda m: (_fmt(m),), None, ["W002"]),
    ("w002-subscript-optional", "runtime/wire.py", """
        def make(x):
            return {"a": x}

        def read(rec):
            return rec["a"], rec["opt"]
    """, lambda m: (_fmt(m),), None, ["W002"]),
    ("w002-contradicting-default", "runtime/wire.py", """
        def make(x):
            return {"a": x}

        def read(rec):
            return rec["a"], rec.get("opt", 7)
    """, lambda m: (_fmt(m),), None, ["W002"]),
    ("w002-quiet", "runtime/wire.py", """
        def make(x):
            return {"a": x}

        def read(rec):
            return rec["a"], rec.get("opt", 0), rec.get("maybe")
    """, lambda m: (_fmt(m),), None, []),
    ("w002-pragma", "runtime/wire.py", """
        def make(x):
            return {"a": x}

        def read(rec):
            # wirecheck: allow[W002] a counter's label child
            return rec["a"], rec["nope"]
    """, lambda m: (_fmt(m),), None, []),
    ("w003-packed-not-unpacked", "runtime/wire.py", """
        def make(x):
            return {"a": x, "opt": 1}

        def read(rec):
            return rec["a"]
    """, lambda m: (_codec(m),), None, ["W003"]),
    ("w003-quiet", "runtime/wire.py", """
        def make(x):
            return {"a": x, "opt": 1}

        def read(rec):
            return rec["a"], rec.get("opt", 0)
    """, lambda m: (_codec(m),), None, []),
    ("w004-fires", "obs/met.py", """
        NAME = "dllama_bogus_total"
    """, lambda m: (), _fams, ["W004"]),
    ("w004-quiet", "obs/met.py", """
        A = "dllama_known_total"
        B = "dllama_known_total_bucket"
    """, lambda m: (), _fams, []),
    ("w004-pragma", "obs/met.py", """
        # wirecheck: allow[W004] negative fixture for the family gate
        NAME = "dllama_bogus_total"
    """, lambda m: (), _fams, []),
    ("w005-late-required", "runtime/wire.py", """
        def make(x):
            return {"a": x, "b": 1}

        def read(rec):
            return rec["a"], rec["b"]
    """, lambda m: (_persistent(m, True),), None, ["W005"]),
    ("w005-quiet", "runtime/wire.py", """
        def make(x):
            return {"a": x, "b": 1}

        def read(rec):
            return rec["a"], rec.get("b")
    """, lambda m: (_persistent(m, False),), None, []),
    ("w005-pragma", "runtime/wire.py", """
        # wirecheck: allow[W005] a fixture's own upgrade note
        def make(x):
            return {"a": x, "b": 1}

        def read(rec):
            return rec["a"], rec["b"]
    """, lambda m: (_persistent(m, True),), None, []),
]


@pytest.mark.parametrize("name,rel,source,formats,families,want", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_fixture_fires_the_same_rules_as_the_jax_checker(
        tmp_path, name, rel, source, formats, families, want):
    from distributed_llama_tpu.analysis.wirecheck import \
        run_wirecheck as jax_run

    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source), encoding="utf-8")
    jwm = _jax_wm()
    got = run_wirecheck([path], tmp_path, formats=formats(wm),
                        families=families(wm) if families else {},
                        full_scan=False)
    assert sorted({f.rule for f in got}) == want, [f.render() for f in got]
    theirs = jax_run([path], tmp_path, formats=formats(jwm),
                     families=families(jwm) if families else {},
                     full_scan=False)
    assert sorted({f.rule for f in theirs}) == want


def test_w000_reports_an_unresolvable_site(tmp_path):
    path = tmp_path / "runtime" / "wire.py"
    path.parent.mkdir(parents=True)
    path.write_text("def make(x):\n    return {'a': x}\n", encoding="utf-8")
    found = run_wirecheck([path], tmp_path, formats=(_fmt(
        wm, consumers=("runtime/wire.py:vanished",)),), families={},
        full_scan=True)
    assert any(f.rule == "W000" and "vanished" in f.message for f in found)


# -- the registry -------------------------------------------------------------


def test_registry_validates_and_covers_the_jax_formats():
    assert wm.validate() == []
    jwm = _jax_wm()
    assert set(jwm.FORMATS_BY_NAME) < set(wm.FORMATS_BY_NAME)
    for name in ("tp_plan.admission", "tp_plan.plan", "kernel_cache.header",
                 "stream.slices"):
        assert name in wm.FORMATS_BY_NAME
    for name, fmt in jwm.FORMATS_BY_NAME.items():
        mine = wm.FORMATS_BY_NAME[name]
        assert {f.name for f in fmt.fields} <= {f.name for f in mine.fields}
        assert all(s.startswith("distributed_llama_tpu_torch/")
                   for s in mine.producers + mine.consumers)
    assert set(jwm.METRIC_FAMILIES) <= set(wm.METRIC_FAMILIES)
    assert wm.HEALTH_SCHEMA_VERSION == jwm.HEALTH_SCHEMA_VERSION


def test_plan_admission_fields_are_the_engines():
    from distributed_llama_tpu_torch.runtime import tp_plan

    fields = {f.name for f in wm.FORMATS_BY_NAME["tp_plan.admission"].fields}
    assert fields == set(tp_plan.ADMISSION_FIELDS)


def test_every_emitted_family_is_registered():
    """Every whole family-name literal outside the registry is a
    registered family (W004 holds it in runtime/, obs/, tools/ and io/;
    this reads the whole package)."""
    import re

    names = set()
    for path in sorted(PKG.rglob("*.py")):
        if path.parent.name != "analysis":
            names |= set(re.findall(r"[\"'](dllama_[a-z0-9_]*[a-z0-9])[\"']",
                                    path.read_text()))
    assert len(names) >= 40
    fams = {re.sub(r"_(?:bucket|sum|count)$", "", n) for n in names}
    assert fams <= set(wm.METRIC_FAMILIES), sorted(
        fams - set(wm.METRIC_FAMILIES))


def test_scope_and_scan_set():
    assert wire_scope("distributed_llama_tpu_torch/runtime/journal.py")
    assert wire_scope("distributed_llama_tpu_torch/io/kernel_cache.py")
    assert wire_scope("distributed_llama_tpu_torch/tools/wirecheck.py")
    assert not wire_scope("distributed_llama_tpu_torch/models/llama.py")
    files = wire_files(PKG, ROOT)
    assert PKG / "tools" / "make_wire_corpus.py" in files


def test_every_rule_has_a_catalogue_entry():
    assert sorted(WIRE_RULES) == [f"W00{i}" for i in range(6)]


def test_baseline_round_trip_on_wirecheck_findings(tmp_path):
    path = tmp_path / "runtime" / "wire.py"
    path.parent.mkdir(parents=True)
    path.write_text(textwrap.dedent(FIXTURES[0][2]), encoding="utf-8")
    found = run_wirecheck([path], tmp_path, formats=(_fmt(wm),),
                          families={}, full_scan=False)
    write_baseline(tmp_path / "wb.txt", found)
    assert apply_baseline(found, load_baseline(tmp_path / "wb.txt")) == \
        ([], len(found), [])


# -- the repo gate and the tools ----------------------------------------------


def test_the_port_has_no_wirecheck_findings():
    assert run_wirecheck(wire_files(PKG, ROOT), ROOT) == []


def test_the_baseline_is_empty():
    assert sum(load_baseline(PKG / "analysis"
                             / "wirecheck_baseline.txt").values()) == 0


def test_skew_matrix_exits_zero(capsys):
    from distributed_llama_tpu_torch.tools import wirecheck as tool

    assert tool.main([]) == 0
    out = capsys.readouterr().out
    assert "23 check(s), 0 failed" in out


@pytest.mark.parametrize("arm", ["skew-reader", "drop-registry-field"])
def test_each_inject_arm_exits_one(capsys, arm):
    from distributed_llama_tpu_torch.tools import wirecheck as tool

    assert tool.main(["--inject", arm]) == 1
    out = capsys.readouterr().out
    if arm == "drop-registry-field":
        assert "W001" in out and "cursor" in out
    else:
        assert "4 failed" in out


def test_corpus_is_written_byte_for_byte(tmp_path):
    from distributed_llama_tpu_torch.tools import make_wire_corpus

    written = make_wire_corpus.write_corpus(str(tmp_path / "c"))
    committed = sorted(p.relative_to(CORPUS).as_posix()
                       for p in CORPUS.rglob("*") if p.is_file()
                       and p.name != "README.md")
    assert written == committed
    for rel in written:
        assert filecmp.cmp(tmp_path / "c" / rel, CORPUS / rel,
                           shallow=False), rel
