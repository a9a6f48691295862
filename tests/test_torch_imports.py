"""Import hygiene of the port: it imports with jax and optax blocked,
never loads the JAX package, and no source of it (or of chip_smoke.py)
names any of them."""

import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "distributed_llama_tpu_torch"
SOURCES = sorted(p.relative_to(ROOT).as_posix()
                 for pat in ("*.py", "*.cu", "*.cuh") for p in PKG.rglob(pat))

_BLOCKED = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "optax", "distributed_llama_tpu"):
                raise ImportError(f"blocked import of {name}")

    sys.meta_path.insert(0, Block())
    import distributed_llama_tpu_torch as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")
             if m.name != pkg.__name__ + ".__main__"]
    for name in names:
        importlib.import_module(name)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "optax",
                                  "distributed_llama_tpu")]
    assert not bad, bad
    print(*names)
""")
# modules the walk must reach (an __init__.py missing would hide them)
NEW_MODULES = ("utils.it_split", "utils.rng", "obs.profiler",
               "runtime.checkpoint", "tools.nb_probe", "tools.plan_sweep",
               "tools.stream_compare", "parallel.mesh",
               "parallel.comm_stats", "parallel.collectives", "parallel.tp",
               "convert", "io.stream", "runtime.speculative",
               "obs.log", "utils.fingerprint", "obs.tracectx", "obs.metrics",
               "obs.ledger", "obs.spans", "obs.trace", "obs.slo",
               "runtime.journal", "runtime.supervisor", "obs.flightrec",
               "obs.fleet", "obs.watch", "runtime.server",
               "runtime.pagewire", "runtime.kv_io", "runtime.page_channel",
               "runtime.disagg", "tools.c7_probe", "runtime.chaos",
               "tools.loadgen", "tools.loadcheck", "parallel.ring",
               "parallel.train", "parallel.sp_train", "parallel.shard_sim",
               "obs.xprof", "obs.drift", "io.kernel_cache",
               "tools.tracecheck", "tools.make_trace_fixture",
               "tools.costcheck", "tools.tracejoin", "tools.watchcheck",
               "tools.fleetcheck", "tools.racecheck")


def test_every_module_imports_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = res.stdout.split()
    assert len(names) >= 15  # every module was walked
    for mod in NEW_MODULES:
        assert f"distributed_llama_tpu_torch.{mod}" in names, mod


def test_sources_include_every_kernel_source():
    """The name check below covers the CUDA sources too, the probe's
    included."""
    for rel in ("csrc/nb_probe.cu", "csrc/q40_row.cuh", "tools/nb_probe.py",
                "obs/profiler.py", "utils/it_split.py"):
        assert f"distributed_llama_tpu_torch/{rel}" in SOURCES, rel


_JAX = re.compile(r"^\s*(import|from)\s+(jax(lib)?|optax)\b", re.M)
_REF = re.compile(r"distributed_llama_tpu(?!_torch)")


@pytest.mark.parametrize("rel", SOURCES)
def test_source_names_neither_jax_nor_the_reference(rel):
    text = (ROOT / rel).read_text()
    assert not _JAX.search(text), f"{rel} imports jax"
    hits = [ln for ln in text.splitlines() if _REF.search(ln)]
    assert not hits, f"{rel} names the JAX package: {hits}"


def test_chip_smoke_names_the_reference_only_as_paths():
    """chip_smoke.py reports which TPU kernel each port kernel replaces, as a
    file:line of the JAX package; it never imports that package or jax."""
    text = (ROOT / "chip_smoke.py").read_text()
    assert not _JAX.search(text), "chip_smoke.py imports jax"
    hits = [ln for ln in text.splitlines() if _REF.search(ln)]
    assert hits  # the "replaces" entries of the kernels line
    for ln in hits:
        assert not re.search(r"\b(import|from)\b", ln), f"{rel}: {ln}"
        assert "distributed_llama_tpu/" in ln, f"{rel}: {ln}"
