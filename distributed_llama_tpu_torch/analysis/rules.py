"""dlint hazard rules D001-D008 (the JAX package's analysis/rules.py, each
rule aimed at the port's own version of its hazard).

Each rule is a callable ``rule(ctx: ModuleContext) -> Iterator[Finding]``
with ``rule_id``/``title``/``hint`` attributes and an optional ``scope``
(repo-path substrings the rule is restricted to):

  D001  implicit device->host sync in runtime/, ops/ or parallel/
  D002  a captured CUDA graph's static buffer rebound between replays
        instead of written in place (the graph keeps reading the old
        storage)
  D003  a CUDA graph capture begun outside a garbage-collector-off block
        (a collection mid-capture may free an earlier graph or stream
        through a CUDA call that invalidates the capture: fault C3)
  D004  per-step host list uploaded by torch.tensor/torch.as_tensor in a
        decode step
  D005  time.time() deltas around device work with no sync or CUDA event
  D006  a torch.distributed collective outside parallel/collectives.py,
        the port's one caller (its CENSUS is what the comm_stats budget
        is held to)
  D007  a bf16/f16 value mixed with an explicit f32 operand: the whole
        expression is silently promoted to f32
  D008  a monotonic/perf_counter delta around device work with neither a
        sync nor a span: it measures the launches and leaves a hole in the
        span timeline

False-positive policy (the JAX package's): rules stay narrow, so that
missing a hazard is preferred to teaching people to add pragmas by
reflex; intentional sites carry ``# dlint: allow[Dnnn] reason`` pragmas
and grandfathered findings live in ``analysis/dlint_baseline.txt``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .lint import Finding, ModuleContext

HOT_PATH_SCOPE = ("runtime/", "ops/", "parallel/")

# numpy.asarray/array over these argument forms is host-side staging
_HOST_LITERALS = (ast.List, ast.Tuple, ast.Dict, ast.Set, ast.Constant,
                  ast.ListComp, ast.GeneratorExp, ast.DictComp, ast.SetComp)
# methods that exist on a torch tensor and not on a numpy array: a call
# through one of them is a tensor (np.asarray of it reads it back)
_TENSOR_METHODS = frozenset(("detach", "cuda", "contiguous", "to", "float",
                             "half", "bfloat16", "clone", "flatten"))
_NUMPY_COPY = ("numpy.asarray", "numpy.array", "numpy.ascontiguousarray")


def _finding(ctx: ModuleContext, node: ast.AST, rule_id: str, message: str,
             hint: str) -> Finding:
    line = getattr(node, "lineno", 0)
    snippet = (ctx.lines[line - 1].strip()
               if 0 < line <= len(ctx.lines) else "")
    return Finding(rule=rule_id, path=ctx.relpath, line=line,
                   message=message, hint=hint, context=ctx.qualname(node),
                   snippet=snippet)


def rule(rule_id: str, title: str, hint: str, scope=None):
    def deco(fn):
        fn.rule_id, fn.title, fn.hint, fn.scope = rule_id, title, hint, scope
        return fn
    return deco


def _method(node: ast.Call) -> str | None:
    """The method name of ``x.m(...)``, else None."""
    return node.func.attr if isinstance(node.func, ast.Attribute) else None


def _is_host_array(ctx: ModuleContext, expr: ast.AST) -> bool:
    """Is ``expr`` evidently a numpy value (a numpy.* call, ``.astype``,
    or a tensor's ``.numpy()``)? Its ``.tolist()`` reads no device."""
    if isinstance(expr, ast.Call):
        t = ctx.call_target(expr)
        if t is not None and t.startswith("numpy."):
            return True
        return _method(expr) in ("astype", "numpy")
    return False


def _is_tensor_expr(ctx: ModuleContext, expr: ast.AST) -> bool:
    """Is ``expr`` evidently a torch tensor (a torch.* call or a method
    only tensors have)?"""
    if not isinstance(expr, ast.Call):
        return False
    t = ctx.call_target(expr)
    if t is not None and t.startswith("torch."):
        return True
    return _method(expr) in _TENSOR_METHODS


@rule("D001", "implicit device->host sync in hot-path module",
      "keep the hot path asynchronous; if the sync is the design, annotate "
      "it with `# dlint: allow[D001] <reason>`",
      scope=HOT_PATH_SCOPE)
def d001_implicit_sync(ctx: ModuleContext) -> Iterator[Finding]:
    """``.item()``, ``.cpu()`` (``.cpu().numpy()`` counts once),
    ``.tolist()`` of a tensor, ``.numpy(force=True)``,
    ``torch.cuda.synchronize()`` and ``Event``/``Stream.synchronize()``,
    ``np.asarray`` of a tensor, and float()/int()/bool() around a torch
    call, inside runtime/, ops/ or parallel/. Each blocks the Python
    thread until the card has drained its queue up to that value; in a
    decode loop that turns asynchronous launches into lock-step round
    trips. A bare ``.numpy()`` raises on a CUDA tensor, so it never syncs
    by itself; a ``.tolist()`` of a numpy value reads no device.

    What the AST cannot type (``bool()`` of a tensor held in an attribute,
    a pageable host->device ``copy_`` or ``torch.tensor(..., device=)``,
    which wait for the stream too) the card's sync census finds:
    chip_smoke.py's analysis_full_width runs the host loop, --fast and the
    continuous engine under torch.cuda.set_sync_debug_mode("warn") and
    fails on a sync at a line no D001 pragma covers, so those sites carry
    the pragma as well."""
    hint = d001_implicit_sync.hint
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        target = ctx.call_target(node)
        m = _method(node)
        no_args = not node.args and not node.keywords
        if target in _NUMPY_COPY:
            if node.args and _is_tensor_expr(ctx, node.args[0]):
                yield _finding(ctx, node, "D001",
                               f"{target.split('.')[-1]}() of a tensor "
                               f"reads it back to the host", hint)
        elif m == "synchronize" and not node.args:
            what = ("torch.cuda.synchronize() drains the device"
                    if target == "torch.cuda.synchronize"
                    else ".synchronize() blocks on the device")
            yield _finding(ctx, node, "D001", what, hint)
        elif m == "item" and no_args:
            yield _finding(ctx, node, "D001",
                           ".item() forces a device->host sync", hint)
        elif m == "cpu" and no_args:
            parent = ctx.parent(node)
            chained = (isinstance(parent, ast.Attribute)
                       and parent.attr == "numpy")
            yield _finding(ctx, node, "D001",
                           ".cpu().numpy() reads the tensor back to the host"
                           if chained else
                           ".cpu() copies the tensor back to the host", hint)
        elif m == "tolist" and no_args:
            if not _is_host_array(ctx, node.func.value):
                yield _finding(ctx, node, "D001",
                               ".tolist() reads the tensor back to the host",
                               hint)
        elif m == "numpy" and any(
                kw.arg == "force" and not (isinstance(kw.value, ast.Constant)
                                           and kw.value.value is False)
                for kw in node.keywords):
            yield _finding(ctx, node, "D001",
                           ".numpy(force=True) copies the tensor back to the "
                           "host", hint)
        elif (isinstance(node.func, ast.Name)
              and node.func.id in ("float", "int", "bool")
              and len(node.args) == 1 and isinstance(node.args[0], ast.Call)):
            inner = ctx.call_target(node.args[0])
            if inner and inner.startswith("torch."):
                yield _finding(
                    ctx, node, "D001",
                    f"{node.func.id}() of a torch value syncs the device",
                    hint)


# -- D002/D003: CUDA graph capture -------------------------------------------

_CAPTURE_BUILDERS = ("GraphStep", "DecodeLoop")


def _self_attr(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _captured_methods(ctx: ModuleContext, cls: ast.ClassDef,
                      methods: dict[str, ast.AST]) -> set[str]:
    """Methods of ``cls`` a graph captures: the step handed to GraphStep /
    DecodeLoop (``self.m`` or a lambda calling ``self.m(...)``), the
    bodies of ``with torch.cuda.graph(...)`` blocks' enclosing methods'
    self-calls inside the block, and every self-call they make."""
    seeds: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Call):
            t = ctx.call_target(node) or ""
            if t.split(".")[-1] in _CAPTURE_BUILDERS and node.args:
                step = node.args[0]
                for sub in ast.walk(step):
                    a = _self_attr(sub)
                    if a in methods:
                        seeds.add(a)
        elif isinstance(node, ast.With):
            if any(isinstance(it.context_expr, ast.Call)
                   and ctx.call_target(it.context_expr) == "torch.cuda.graph"
                   for it in node.items):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call):
                        a = _self_attr(sub.func)
                        if a in methods:
                            seeds.add(a)
    todo, seen = list(seeds), set(seeds)
    while todo:
        for sub in ast.walk(methods[todo.pop()]):
            if isinstance(sub, ast.Call):
                a = _self_attr(sub.func)
                if a in methods and a not in seen:
                    seen.add(a)
                    todo.append(a)
    return seen


def _with_capture(ctx: ModuleContext, cls: ast.ClassDef) -> bool:
    for node in ast.walk(cls):
        if isinstance(node, ast.Call):
            t = ctx.call_target(node) or ""
            if (t.split(".")[-1] in _CAPTURE_BUILDERS
                    or t == "torch.cuda.graph"):
                return True
    return False


@rule("D002", "captured static buffer rebound between replays",
      "write the buffer in place (copy_/fill_/index_copy_): a CUDA graph "
      "replays the storage it was captured over, so a rebound attribute "
      "leaves every later replay reading the old tensor")
def d002_static_rebind(ctx: ModuleContext) -> Iterator[Finding]:
    """In a class that captures a CUDA graph (GraphStep, DecodeLoop or
    ``torch.cuda.graph``), the ``self.<attr>`` values the captured step
    reads are the graph's static inputs. Rebinding one (``self.cache =
    ...``) outside ``__init__`` leaves the graph replaying over the old
    storage; the hazard the continuous engine's admission prefill
    avoids by writing the cache in place."""
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef) or not _with_capture(ctx, cls):
            continue
        methods = {n.name: n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        captured = _captured_methods(ctx, cls, methods)
        static: set[str] = set()
        for name in captured:
            for sub in ast.walk(methods[name]):
                a = _self_attr(sub)
                if (a is not None and a not in methods
                        and isinstance(sub.ctx, ast.Load)):
                    static.add(a)
        for name, fn in methods.items():
            if name == "__init__":
                continue
            for sub in ast.walk(fn):
                if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = (sub.targets if isinstance(sub, ast.Assign)
                           else [sub.target])
                for t in targets:
                    for el in (t.elts if isinstance(t, ast.Tuple) else [t]):
                        a = _self_attr(el)
                        if a in static:
                            yield _finding(
                                ctx, sub, "D002",
                                f"{cls.name}.{name} rebinds self.{a}, a "
                                f"static input of a captured graph",
                                d002_static_rebind.hint)


@rule("D003", "CUDA graph capture outside a gc-off block",
      "disable the garbage collector around the capture (gc.disable() "
      "before it, re-enabled in a finally): a collection mid-capture can "
      "free an earlier graph or stream through a CUDA call that "
      "invalidates the capture")
def d003_capture_gc(ctx: ModuleContext) -> Iterator[Finding]:
    """``with torch.cuda.graph(...)`` or ``graph.capture_begin()`` in a
    function that has not called ``gc.disable()`` on an earlier line."""
    for node in ast.walk(ctx.tree):
        site = None
        if isinstance(node, ast.With):
            for it in node.items:
                if (isinstance(it.context_expr, ast.Call)
                        and ctx.call_target(it.context_expr)
                        == "torch.cuda.graph"):
                    site = node
        elif isinstance(node, ast.Call) and _method(node) == "capture_begin":
            site = node
        if site is None:
            continue
        fn = ctx.enclosing_function(site)
        scope = fn if fn is not None else ctx.tree
        off = any(isinstance(sub, ast.Call)
                  and ctx.call_target(sub) == "gc.disable"
                  and sub.lineno < site.lineno for sub in ast.walk(scope))
        if not off:
            yield _finding(ctx, site, "D003",
                           "CUDA graph capture begun with the garbage "
                           "collector on", d003_capture_gc.hint)


@rule("D004", "per-step host list uploaded in the decode step",
      "stage rows into one static device buffer (copy_ from one host "
      "array) instead of building a tensor from a Python list each step",
      scope=("runtime/",))
def d004_hot_loop_upload(ctx: ModuleContext) -> Iterator[Finding]:
    """``torch.tensor([f(s) for s in rows], device=...)`` in a per-step
    function builds B boxed Python objects, one host tensor and one small
    upload per list, every decode step. Fires inside functions named
    step*/_step* and inside explicit loops in runtime/ modules."""
    targets = ("torch.tensor", "torch.as_tensor")

    def in_step_fn(node):
        fn = ctx.enclosing_function(node)
        return (fn is not None and isinstance(fn, (ast.FunctionDef,
                                                   ast.AsyncFunctionDef))
                and fn.name.lstrip("_").startswith("step"))

    comp_names: set[tuple[ast.AST, str]] = set()
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Assign) and in_step_fn(node)
                and isinstance(node.value, (ast.ListComp, ast.List))):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    comp_names.add((ctx.enclosing_function(node), t.id))

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        if ctx.call_target(node) not in targets:
            continue
        if not (in_step_fn(node) or ctx.in_loop(node)):
            continue
        arg = node.args[0]
        is_comp = isinstance(arg, (ast.ListComp, ast.List, ast.GeneratorExp))
        is_comp_name = (isinstance(arg, ast.Name)
                        and (ctx.enclosing_function(node),
                             arg.id) in comp_names)
        if is_comp or is_comp_name:
            yield _finding(ctx, node, "D004",
                           "per-step Python list uploaded by "
                           f"{ctx.call_target(node)}",
                           d004_hot_loop_upload.hint)


def _syncs(ctx: ModuleContext, func: ast.AST) -> bool:
    """Does this def wait for the device: synchronize(), a CUDA event's
    elapsed_time, or a blocking read (.cpu(), .item(), .tolist())?"""
    for node in ast.walk(func):
        if isinstance(node, ast.Call) and _method(node) in (
                "synchronize", "elapsed_time", "cpu", "item", "tolist"):
            return True
        if (isinstance(node, ast.Call)
                and ctx.call_target(node) in _NUMPY_COPY and node.args
                and _is_tensor_expr(ctx, node.args[0])):
            return True
    return False


def _clock_deltas(ctx: ModuleContext, fn: ast.AST, clocks) -> Iterator:
    """Subtractions in ``fn`` (not in nested defs) with a clock reading,
    or a name assigned from one in ``fn``, on either side."""
    names: set[str] = set()
    for sub in ast.walk(fn):
        if (isinstance(sub, ast.Assign)
                and ctx.enclosing_function(sub) is fn
                and isinstance(sub.value, ast.Call)
                and ctx.call_target(sub.value) in clocks):
            for t in sub.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)

    def clock_side(expr):
        if isinstance(expr, ast.Call) and ctx.call_target(expr) in clocks:
            return True
        return isinstance(expr, ast.Name) and expr.id in names

    for sub in ast.walk(fn):
        if not isinstance(sub, ast.BinOp) or not isinstance(sub.op, ast.Sub):
            continue
        # a delta inside a nested def is that def's business
        if ctx.enclosing_function(sub) is not fn:
            continue
        if clock_side(sub.left) or clock_side(sub.right):
            yield sub


@rule("D005", "time.time() delta around device work",
      "time with CUDA events (elapsed_time) or synchronize before reading "
      "time.perf_counter(), so the interval measures device work, not "
      "the launches")
def d005_bare_time(ctx: ModuleContext) -> Iterator[Finding]:
    """A ``time.time()`` delta in a function that issues torch work but
    never waits for the card measures only the launches (the 'the card is
    infinitely fast' trap)."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not ctx.function_calls_device(node) or _syncs(ctx, node):
            continue
        for sub in _clock_deltas(ctx, node, ("time.time",)):
            yield _finding(ctx, sub, "D005",
                           "time.time() interval around un-synced device "
                           "work", d005_bare_time.hint)


# collectives of torch.distributed that add traffic the comm_stats budget
# must model
_COLLECTIVES = frozenset((
    "all_gather", "all_gather_into_tensor", "all_reduce", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "broadcast",
    "send", "recv", "isend", "irecv", "batch_isend_irecv", "reduce",
    "gather", "scatter", "barrier", "all_gather_object",
    "broadcast_object_list"))
_COLLECTIVES_FILE = "parallel/collectives.py"


@rule("D006", "torch.distributed collective outside parallel/collectives.py",
      "route the collective through parallel/collectives.py (CENSUS counts "
      "it) and land its parallel/comm_stats.py budget term in the same "
      "change")
def d006_unmodeled_collective(ctx: ModuleContext) -> Iterator[Finding]:
    """Every collective the port issues goes through
    parallel/collectives.py, whose CENSUS the budget
    (comm_stats.tp_collective_budget) and the J001 contract are held to.
    Any ``torch.distributed`` collective elsewhere, called through the
    module (``dist.all_reduce``) or through a name that holds it
    (``self._dist.broadcast``), is flagged."""
    if ctx.relpath.endswith(_COLLECTIVES_FILE):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        t = ctx.call_target(node) or ""
        m = _method(node)
        held = (m in _COLLECTIVES and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, (ast.Attribute, ast.Name))
                and (ctx.dotted(node.func.value) or "").split(".")[-1]
                in ("dist", "_dist"))
        if (t.startswith("torch.distributed.")
                and t.split(".")[-1] in _COLLECTIVES) or held:
            yield _finding(ctx, node, "D006",
                           f"collective {m} issued outside "
                           f"{_COLLECTIVES_FILE}",
                           d006_unmodeled_collective.hint)


_LOW_DTYPES = frozenset(("torch.bfloat16", "torch.float16", "torch.half",
                         "numpy.float16", "bfloat16", "float16"))
_F32_DTYPES = frozenset(("torch.float32", "torch.float", "numpy.float32",
                         "float32"))
_F32_CONSTRUCTORS = frozenset(("numpy.float32", "numpy.float64"))


@rule("D007", "implicit dtype promotion to f32 in a low-precision path",
      "pick one dtype for the expression: cast the operand to the bf16/f16 "
      "side, or the value to f32 explicitly; a silent upcast doubles the "
      "bytes of every later read",
      scope=("ops/", "parallel/"))
def d007_dtype_promotion(ctx: ModuleContext) -> Iterator[Finding]:
    """Arithmetic mixing a known-low-precision local (from ``.to(bf16)``,
    ``.bfloat16()``, ``.half()``, ``.astype(float16)`` or a dtype=bf16
    constructor) with an explicit f32 operand (a local from ``.to(float32)``
    / ``.float()`` / a dtype=float32 constructor, or ``np.float32(...)``).
    torch promotes the whole expression to f32 silently. Both sides must
    be typed within the same function: ``x * 0.5`` never fires."""

    def dtype_class(expr) -> str | None:
        name = None
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            name = expr.value
        elif isinstance(expr, (ast.Attribute, ast.Name)):
            name = ctx.dotted(expr)
        if name in _LOW_DTYPES:
            return "low"
        if name in _F32_DTYPES:
            return "f32"
        return None

    def value_class(expr, local) -> str | None:
        if isinstance(expr, ast.Name):
            return local.get(expr.id)
        if not isinstance(expr, ast.Call):
            return None
        m = _method(expr)
        if m in ("bfloat16", "half") and not expr.args:
            return "low"
        if m == "float" and not expr.args:
            return "f32"
        if m in ("astype", "to") and expr.args:
            cls = dtype_class(expr.args[0])
            if cls is not None:
                return cls
        if ctx.call_target(expr) in _F32_CONSTRUCTORS:
            return "f32"
        for kw in expr.keywords:
            if kw.arg == "dtype":
                return dtype_class(kw.value)
        return None

    locals_of: dict = {}
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            cls = value_class(node.value, {})
            if cls is not None:
                fn = ctx.enclosing_function(node)
                locals_of.setdefault(fn, {})[node.targets[0].id] = cls

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.BinOp):
            continue
        local = locals_of.get(ctx.enclosing_function(node), {})
        sides = {value_class(node.left, local),
                 value_class(node.right, local)}
        if sides == {"low", "f32"}:
            yield _finding(
                ctx, node, "D007",
                "bf16/f16 value mixed with an explicit f32 operand: the "
                "expression silently upcasts to f32",
                d007_dtype_promotion.hint)


_D008_CLOCKS = ("time.monotonic", "time.perf_counter")


def _calls_span(ctx: ModuleContext, func: ast.AST) -> bool:
    """Does this def open a span (``tracer.span(...)``, ``self._span(...)``
    or a torch.profiler.record_function scope)? The final attribute
    segment, underscores stripped, is 'span', or the call ends in
    record_function."""
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            t = ctx.call_target(node)
            if t is None and isinstance(node.func, ast.Attribute):
                t = node.func.attr
            if t is not None and (t.rsplit(".", 1)[-1].lstrip("_") == "span"
                                  or t.endswith("record_function")):
                return True
    return False


@rule("D008", "timed region wraps device work with neither a sync nor a span",
      "open a span (obs/spans.SpanTracer; the timeline then owns the "
      "region) or wait for the card (synchronize, a CUDA event, a "
      "blocking read); otherwise the interval measures the launches",
      scope=("runtime/", "parallel/"))
def d008_span_hygiene(ctx: ModuleContext) -> Iterator[Finding]:
    """A ``time.monotonic()``/``time.perf_counter()`` delta in a function
    that issues torch work but never waits for the card (synchronize, a
    CUDA event's elapsed_time, a blocking read) and never opens a span.
    D005 catches the time.time() spelling of the same trap."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not ctx.function_calls_device(node):
            continue
        if _syncs(ctx, node) or _calls_span(ctx, node):
            continue
        for sub in _clock_deltas(ctx, node, _D008_CLOCKS):
            yield _finding(ctx, sub, "D008",
                           "monotonic/perf_counter interval around device "
                           "work with no sync and no span",
                           d008_span_hygiene.hint)


RULES = (d001_implicit_sync, d002_static_rebind, d003_capture_gc,
         d004_hot_loop_upload, d005_bare_time, d006_unmodeled_collective,
         d007_dtype_promotion, d008_span_hygiene)
