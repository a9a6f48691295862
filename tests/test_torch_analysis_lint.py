"""The port's dlint (distributed_llama_tpu_torch/analysis/lint.py and
rules.py): its pragma grammar and baseline against the JAX package's
analysis/lint.py on the same inputs, and each D-rule with a firing, a
non-firing and a pragma-suppressed fixture (D001, D005, D006 and D008
adapted from tests/test_dlint_rules.py with torch subjects).

Fixture modules are written under a fake package layout (tmp/runtime/...,
tmp/ops/...) so each rule's path scope applies as on the real tree. The
linter is pure AST: no snippet is imported or run."""

from __future__ import annotations

import textwrap
from pathlib import Path

import pytest

from distributed_llama_tpu_torch.analysis import lint as plint
from distributed_llama_tpu_torch.analysis.lint import (Finding,
                                                       apply_baseline,
                                                       lint_paths,
                                                       load_baseline,
                                                       write_baseline)


def run_on(tmp_path: Path, rel: str, source: str):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source), encoding="utf-8")
    return lint_paths([path], tmp_path)


def fired(findings):
    return {f.rule for f in findings}


# -- the machinery against the JAX package's ---------------------------------

PRAGMA_SNIPPETS = [
    "x = 1\ny = t.item()  # dlint: allow[D001] the design\n",
    "# dlint: allow[D001,D008] two rules\nz = t.cpu()\nw = 2\n",
    "a = 1  # threadcheck: allow[T003] held briefly\n"
    "# wirecheck: allow[W002] label child\nb = c['x']\n",
    "# dlint: allow [D001] a space before the bracket does not parse\n"
    "q = t.tolist()\n",
    "no pragma here\n# dlint: allow[ D005 , D007 ] spaced\nr = 3\n",
]


@pytest.mark.parametrize("text", PRAGMA_SNIPPETS)
def test_parse_pragmas_equals_the_jax_engines(text):
    from distributed_llama_tpu.analysis import lint as jlint

    lines = text.splitlines()
    assert plint.parse_pragmas(lines) == jlint.parse_pragmas(lines)


def _findings(cls):
    return [cls(rule="D001", path="pkg/runtime/a.py", line=3, message="m",
                hint="h", context="f", snippet="x = t.item()"),
            cls(rule="D001", path="pkg/runtime/a.py", line=9, message="m",
                hint="h", context="f", snippet="x = t.item()"),
            cls(rule="D008", path="pkg/parallel/b.py", line=4, message="m",
                hint="h", context="<module>", snippet="dt = now() - t0")]


def test_baseline_round_trip_equals_the_jax_engines(tmp_path):
    from distributed_llama_tpu.analysis import lint as jlint

    pf, jf = _findings(plint.Finding), _findings(jlint.Finding)
    assert [f.key() for f in pf] == [f.key() for f in jf]
    assert [f.render() for f in pf] == [f.render() for f in jf]
    write_baseline(tmp_path / "p.txt", pf[:2])
    jlint.write_baseline(tmp_path / "j.txt", jf[:2])
    pb, jb = load_baseline(tmp_path / "p.txt"), jlint.load_baseline(
        tmp_path / "j.txt")
    assert pb == jb and sum(pb.values()) == 2
    # each side reads the other's file the same way
    assert load_baseline(tmp_path / "j.txt") == jlint.load_baseline(
        tmp_path / "p.txt")
    got = apply_baseline(pf, pb)
    want = jlint.apply_baseline(jf, jb)
    assert [f.key() for f in got[0]] == [f.key() for f in want[0]]
    assert got[1:] == want[1:] == (2, [])
    assert apply_baseline(pf[:1], pb)[2] == jlint.apply_baseline(
        jf[:1], jb)[2] != []


def test_unreadable_path_is_a_finding(tmp_path):
    bad = tmp_path / "runtime" / "broken.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f(:\n", encoding="utf-8")
    findings = lint_paths([bad, tmp_path / "missing.py"], tmp_path)
    assert [f.rule for f in findings] == ["D000", "D000"]


# -- D001 ---------------------------------------------------------------------


def test_d001_fires_on_torch_syncs_in_hot_path(tmp_path):
    findings = run_on(tmp_path, "runtime/hot.py", """
        import numpy as np
        import torch

        def step(model, cache, tok, ev):
            logits = model(cache, tok)
            host = logits.cpu().numpy()          # sync
            n = logits.sum().item()              # sync
            rows = logits.argmax(-1).tolist()    # sync
            torch.cuda.synchronize()             # sync
            ev.synchronize()                     # sync
            f = float(torch.max(logits))         # sync
            a = np.asarray(logits.detach())      # sync
            return host, n, rows, f, a
    """)
    d001 = [f for f in findings if f.rule == "D001"]
    assert [f.line for f in d001] == [7, 8, 9, 10, 11, 12, 13], findings
    assert all(f.context == "step" for f in d001)


def test_d001_quiet_on_host_values_and_cold_modules(tmp_path):
    quiet = """
        import numpy as np

        def stage(pool, z, header):
            a = np.asarray([s.token for s in pool])   # host list comp
            b = z["rest"].astype(int).tolist()         # a numpy value
            c = np.frombuffer(header, np.int32).tolist()
            d = np.asarray(pool)                       # not evidently a tensor
            return a, b, c, d
    """
    assert run_on(tmp_path, "runtime/stage.py", quiet) == []
    cold = """
        def show(t):
            return t.cpu().item()
    """
    assert run_on(tmp_path, "tools/show.py", cold) == []


def test_d001_pragma_suppresses_with_reason(tmp_path):
    findings = run_on(tmp_path, "runtime/hot.py", """
        def infer(model, cache, tok):
            logits = model(cache, tok)
            # dlint: allow[D001] host sampling: one read a step
            return logits[0].cpu().numpy()

        def other(t):
            return t.item()  # dlint: allow[D008] the wrong rule
    """)
    assert [(f.rule, f.line) for f in findings] == [("D001", 8)]


# -- D002: captured static buffer rebound -------------------------------------

CAPTURING = """
    import torch
    from runtime.decode import GraphStep

    class Loop:
        def __init__(self, device):
            self.buf = torch.zeros(4, device=device)
            self.cache = torch.zeros(8, device=device)
            self.graph = GraphStep(self._step, device)

        def _step(self):
            self.buf.add_(self.cache.sum())

        def reset(self):
            {reset}
"""


def test_d002_fires_on_rebinding_a_captured_buffer(tmp_path):
    findings = run_on(tmp_path, "runtime/loop.py", CAPTURING.format(
        reset="self.cache = torch.ones(8)"))
    assert [(f.rule, f.line) for f in findings] == [("D002", 15)]
    assert "self.cache" in findings[0].message


@pytest.mark.parametrize("capture", [
    "return GraphStep(lambda: self._fwd(), 'cuda')",
    "gc.disable()\n                with torch.cuda.graph(g):\n"
    "                    self._fwd()",
])
def test_d002_fires_through_a_lambda_step_and_a_graph_block(tmp_path,
                                                           capture):
    findings = run_on(tmp_path, "runtime/eng.py", f"""
        import gc
        import torch

        class Engine:
            def __init__(self):
                self.x = torch.zeros(2)

            def _fwd(self):
                return self.x * 2

            def capture(self, g):
                {capture}

            def admit(self, x):
                self.x = x
    """)
    assert fired(findings) == {"D002"}


def test_d002_quiet_on_in_place_writes_and_init(tmp_path):
    assert run_on(tmp_path, "runtime/loop.py", CAPTURING.format(
        reset="self.cache.zero_()")) == []
    not_captured = """
        import torch

        class Plain:
            def __init__(self):
                self.buf = torch.zeros(4)

            def reset(self):
                self.buf = torch.ones(4)
    """
    assert run_on(tmp_path, "runtime/plain.py", not_captured) == []


def test_d002_pragma_suppresses_with_reason(tmp_path):
    findings = run_on(tmp_path, "runtime/loop.py", CAPTURING.format(
        reset="self.cache = torch.ones(8)  "
              "# dlint: allow[D002] recaptured below"))
    assert findings == []


# -- D003: capture with the collector on --------------------------------------


def test_d003_fires_on_capture_without_gc_off(tmp_path):
    findings = run_on(tmp_path, "runtime/cap.py", """
        import torch

        def capture(step):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                step()
            return g

        def begin(g):
            g.capture_begin()
    """)
    assert [(f.rule, f.line) for f in findings] == [("D003", 6),
                                                    ("D003", 11)]


def test_d003_quiet_inside_a_gc_off_block(tmp_path):
    assert run_on(tmp_path, "runtime/cap.py", """
        import gc
        import torch

        def capture(step):
            g = torch.cuda.CUDAGraph()
            gc.disable()
            try:
                with torch.cuda.graph(g):
                    step()
            finally:
                gc.enable()
            return g
    """) == []


def test_d003_pragma_suppresses_with_reason(tmp_path):
    assert run_on(tmp_path, "runtime/cap.py", """
        import torch

        def capture(step, g):
            # dlint: allow[D003] no garbage can hold a graph here
            with torch.cuda.graph(g):
                step()
    """) == []


# -- D004: per-step list upload -----------------------------------------------


def test_d004_fires_in_step_functions_and_loops(tmp_path):
    findings = run_on(tmp_path, "runtime/sched.py", """
        import torch

        def step_once(pool, device):
            rows = [s.token for s in pool]
            return torch.tensor(rows, device=device)

        def drain(pools, device):
            for pool in pools:
                torch.as_tensor([s.pos for s in pool], device=device)
    """)
    assert [(f.rule, f.line) for f in findings] == [("D004", 6),
                                                    ("D004", 10)]


def test_d004_quiet_on_staged_uploads_and_cold_functions(tmp_path):
    assert run_on(tmp_path, "runtime/sched.py", """
        import numpy as np
        import torch

        def step_once(buf, staging, pool):
            for i, s in enumerate(pool):
                staging[i] = s.token
            buf.copy_(torch.from_numpy(staging))

        def setup(device):
            return torch.tensor([1, 2, 3], device=device)
    """) == []
    assert run_on(tmp_path, "ops/plan.py", """
        import torch

        def step(rows):
            return torch.tensor([r for r in rows])
    """) == []


def test_d004_pragma_suppresses_with_reason(tmp_path):
    assert run_on(tmp_path, "runtime/sched.py", """
        import torch

        def step_once(pool, device):
            # dlint: allow[D004] one row, at admission only
            return torch.tensor([s.token for s in pool], device=device)
    """) == []


# -- D005: time.time() around device work -------------------------------------


def test_d005_fires_on_unsynced_time_time_delta(tmp_path):
    findings = run_on(tmp_path, "runtime/bench.py", """
        import time
        import torch

        def bench(x):
            t0 = time.time()
            y = torch.matmul(x, x)
            return y, time.time() - t0
    """)
    assert fired(findings) == {"D005"}


def test_d005_quiet_with_sync_or_without_device_work(tmp_path):
    synced = """
        import time
        import torch

        def bench(x, ev0, ev1):
            t0 = time.time()
            y = torch.matmul(x, x)
            ms = ev0.elapsed_time(ev1)
            return y, time.time() - t0, ms
    """
    assert "D005" not in fired(run_on(tmp_path, "tools/bench.py", synced))
    host_only = """
        import time

        def wait(deadline):
            return deadline - time.time()
    """
    assert run_on(tmp_path, "io/net.py", host_only) == []
    nested_host_helper = """
        import time
        import torch

        def outer(x, deadline):
            def remaining():
                return deadline - time.time()   # host timeout math only
            y = torch.matmul(x, x)
            return y, remaining()
    """
    assert run_on(tmp_path, "tools/bench.py", nested_host_helper) == []


def test_d005_pragma_suppresses_with_reason(tmp_path):
    assert run_on(tmp_path, "tools/bench.py", """
        import time
        import torch

        def bench(x):
            t0 = time.time()
            torch.matmul(x, x)
            # dlint: allow[D005] the launch cost is what this times
            return time.time() - t0
    """) == []


# -- D006: collectives outside parallel/collectives.py ------------------------


def test_d006_fires_on_a_collective_outside_collectives(tmp_path):
    findings = run_on(tmp_path, "parallel/tp.py", """
        import torch.distributed as dist

        def combine(x, group):
            dist.all_reduce(x, group=group)
            return x

        class Channel:
            def __init__(self):
                import torch.distributed as d
                self._dist = d

            def send(self, t):
                self._dist.broadcast(t, 0)
    """)
    assert [(f.rule, f.line) for f in findings] == [("D006", 5),
                                                    ("D006", 14)]


def test_d006_quiet_in_collectives_and_on_group_setup(tmp_path):
    assert run_on(tmp_path, "parallel/collectives.py", """
        import torch.distributed as dist

        def psum(x, group):
            dist.all_reduce(x, group=group)
            return x
    """) == []
    assert run_on(tmp_path, "parallel/mesh.py", """
        import torch.distributed as dist

        def init(rank, size, addr):
            dist.init_process_group("gloo", init_method=addr, rank=rank,
                                    world_size=size)
            return dist.new_group([0, 1])
    """) == []


def test_d006_pragma_suppresses_with_reason(tmp_path):
    assert run_on(tmp_path, "runtime/plan.py", """
        import torch.distributed as dist

        def send(t, pg):
            # dlint: allow[D006] the plan's side group, not a forward
            dist.broadcast(t, 0, group=pg)
    """) == []


# -- D007: implicit promotion -------------------------------------------------


def test_d007_fires_on_bf16_mixed_with_f32(tmp_path):
    findings = run_on(tmp_path, "ops/mix.py", """
        import numpy as np
        import torch

        def mix(x, w):
            xb = x.to(torch.bfloat16)
            wf = w.float()
            y = xb * wf
            z = x.half() + np.float32(0.5)
            return y, z
    """)
    assert [(f.rule, f.line) for f in findings] == [("D007", 8),
                                                    ("D007", 9)]


def test_d007_quiet_on_weak_scalars_and_matched_dtypes(tmp_path):
    assert run_on(tmp_path, "ops/mix.py", """
        import torch

        def mix(x, w):
            xb = x.to(torch.bfloat16)
            wb = w.bfloat16()
            return xb * 0.5, xb * wb, x.float() * w.float()
    """) == []


def test_d007_pragma_suppresses_with_reason(tmp_path):
    assert run_on(tmp_path, "ops/mix.py", """
        import torch

        def mix(x, w):
            xb = x.to(torch.bfloat16)
            wf = w.to(torch.float32)
            return xb * wf  # dlint: allow[D007] f32 accumulate wanted
    """) == []


# -- D008: perf_counter around device work ------------------------------------


def test_d008_fires_on_unspanned_unsynced_clock_deltas(tmp_path):
    findings = run_on(tmp_path, "runtime/loop.py", """
        import time
        import torch

        def dispatch(model, x):
            t0 = time.perf_counter()
            y = torch.relu(model(x))
            dt = time.perf_counter() - t0
            m0 = time.monotonic()
            z = torch.relu(y)
            return z, dt, time.monotonic() - m0
    """)
    assert [(f.rule, f.line) for f in findings] == [("D008", 8),
                                                    ("D008", 11)]


@pytest.mark.parametrize("guard", [
    "torch.cuda.synchronize()",
    "host = y.cpu()",
    "ev.synchronize()",
    "with self._span('step'):\n                pass",
])
def test_d008_quiet_with_a_sync_or_a_span(tmp_path, guard):
    src = f"""
        import time
        import torch

        def dispatch(self, model, x, ev):
            t0 = time.perf_counter()
            y = torch.relu(model(x))
            {guard}
            return y, time.perf_counter() - t0
    """
    assert "D008" not in fired(run_on(tmp_path, "parallel/loop.py", src))


def test_d008_pragma_suppresses_with_reason(tmp_path):
    assert run_on(tmp_path, "runtime/loop.py", """
        import time
        import torch

        def run(loop):
            t0 = time.perf_counter()
            torch.relu(loop)
            # dlint: allow[D008] loop.run ends in a read back
            return time.perf_counter() - t0
    """) == []


def test_finding_render_and_key_shape():
    f = Finding(rule="D001", path="p/runtime/x.py", line=2, message="m",
                hint="h", context="f", snippet="t.item()")
    assert f.render() == "p/runtime/x.py:2: D001 m  [fix: h]"
    rule, where, digest = f.key().split(" ")
    assert (rule, where, len(digest)) == ("D001", "p/runtime/x.py:f", 12)
