"""threadcheck: the thread-ownership lint over the port's runtime/ and
obs/ (the JAX package's analysis/threadcheck.py; the rules and their
machinery unchanged, the registry the port's analysis/threadmodel.py).

A pure-AST pass that never imports the runtime. Rules (each has firing,
non-firing and pragma fixtures in tests/test_torch_analysis_threadcheck.py):

* **T001 unlocked cross-domain write**: a write to a registered attribute
  family outside its declared lock, reachable from a domain the family
  does not own (a family with ``lock=None`` is domain-private);
* **T002 lock-order inversion**: the lock acquisition graph (``with``
  nesting plus resolved calls made under a lock) has a cycle;
* **T003 blocking call under a lock**: fsync/sleep/socket I/O/join/
  ``wait`` on a foreign primitive, or a device sync, while holding a
  lock (``cond.wait()`` under ``with cond:`` is the sanctioned idiom);
* **T004 unregistered thread**: a ``threading.Thread(target=...)`` whose
  target is not in the entrypoint registry;
* **T005 mutable state escape**: a registered mutable attribute returned
  raw from a method callable cross-domain.

Domains propagate through ``self.``-calls and the declared INSTANCE_HINTS
from the registered entrypoints and METHOD_DOMAINS seeds; what the pass
cannot resolve it does not guess. Suppression is dlint's: ``#
threadcheck: allow[T003] reason`` pragmas and the baseline in
analysis/threadcheck_baseline.txt (empty: every finding is fixed or
pragma'd at its site).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from .lint import Finding, ModuleContext, iter_module_contexts
from . import threadmodel as tm

# rule catalogue (rendered by --threadcheck and the README table)
THREAD_RULES: dict[str, tuple[str, str]] = {
    "T000": ("unreadable input",
             "fix the path or the parse error"),
    "T001": ("unlocked cross-domain write",
             "hold the family's declared lock, or marshal through the "
             "owner domain (inbox/Event box)"),
    "T002": ("lock-order inversion",
             "acquire locks in one global order; release before calling "
             "into another locked object"),
    "T003": ("blocking call while holding a lock",
             "move the blocking operation outside the critical section; "
             "snapshot under the lock, block after"),
    "T004": ("thread started outside the entrypoint registry",
             "register the target in threadmodel.ENTRYPOINTS with its "
             "domain and join/stop path"),
    "T005": ("mutable state escapes its domain",
             "return a copy (list()/dict()) — the snapshot crossing "
             "point — not the guarded object itself"),
}

_SCOPES = ("runtime/", "obs/")

# mutating container methods: a call through one of these writes the
# receiver just as surely as an assignment does
_MUTATORS = frozenset({
    "append", "appendleft", "add", "extend", "insert", "remove",
    "discard", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "sort", "reverse",
})

# copy-constructor call names that turn a return into a snapshot
_SNAPSHOTS = frozenset({"list", "dict", "tuple", "set", "frozenset",
                        "sorted", "copy", "deepcopy"})

_LOCKISH = re.compile(r"(^|_)(lock|cond|mutex|sem)\b|_lock$|_cond$")

# dotted names that block (module-qualified)
_BLOCKING_DOTTED = frozenset({
    "time.sleep", "os.fsync", "os.fdatasync", "select.select",
    "socket.create_connection", "subprocess.run", "subprocess.check_call",
    "torch.cuda.synchronize",
})
# attribute calls that block regardless of receiver
_BLOCKING_ATTRS = frozenset({
    "recv", "recvfrom", "accept", "sendall", "serve_forever",
    "synchronize", "fsync", "fdatasync",
})


def _is_lock_attr(name: str) -> bool:
    return name in tm.LOCK_ATTRS or bool(_LOCKISH.search(name))


# -- program index ---------------------------------------------------------


class _Method:
    """One method (plus everything nested in it) of an indexed class."""

    def __init__(self, cls: str, name: str, node: ast.AST,
                 ctx: ModuleContext):
        self.cls = cls
        self.name = name
        self.qual = f"{cls}.{name}"
        self.node = node
        self.ctx = ctx
        self.self_calls: set[str] = set()          # self.m(...)
        self.hint_calls: set[tuple[str, str]] = set()  # (class, method)
        self.lock_keys: set[str] = set()           # locks acquired here


class _Index:
    """Cross-module program index: classes, methods, domains, locks."""

    def __init__(self, contexts: list[ModuleContext]):
        self.contexts = contexts
        self.methods: dict[str, _Method] = {}      # qual -> method
        self.by_class: dict[str, dict[str, _Method]] = {}
        self.method_of_node: dict[ast.AST, _Method] = {}
        for ctx in contexts:
            self._index_module(ctx)
        self._resolve_calls()
        self.domains = self._propagate_domains()
        self.acquires = self._transitive_acquires()

    # -- construction ------------------------------------------------------

    def _index_module(self, ctx: ModuleContext) -> None:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            cls = node.name
            table = self.by_class.setdefault(cls, {})
            for child in node.body:
                if not isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                    continue
                m = _Method(cls, child.name, child, ctx)
                # first definition wins (server.py defines Handler once;
                # fixtures may shadow — per-run indexes are fresh)
                self.methods.setdefault(m.qual, m)
                table.setdefault(child.name, m)
                for sub in ast.walk(child):
                    self.method_of_node[sub] = m

    def method_for(self, node: ast.AST) -> "_Method | None":
        return self.method_of_node.get(node)

    def _resolve_calls(self) -> None:
        for m in self.methods.values():
            for node in ast.walk(m.node):
                if isinstance(node, ast.With):
                    for item in node.items:
                        key = self.lock_key(m, item.context_expr)
                        if key:
                            m.lock_keys.add(key)
                if not isinstance(node, ast.Call):
                    continue
                dotted = m.ctx.dotted(node.func)
                if not dotted:
                    continue
                parts = dotted.split(".")
                if len(parts) == 2 and parts[0] == "self":
                    m.self_calls.add(parts[1])
                elif len(parts) >= 2:
                    hint = tm.INSTANCE_HINTS.get(parts[-2])
                    if hint:
                        m.hint_calls.add((hint, parts[-1]))

    # -- lock identity -----------------------------------------------------

    def lock_key(self, m: "_Method | None",
                 expr: ast.AST) -> str | None:
        """Graph-node identity of a ``with <expr>:`` lock acquisition,
        resolved through the declared instance hints so the same lock
        reached by different attribute paths keys one node. None when
        the expression is not lock-shaped."""
        ctx = m.ctx if m is not None else None
        dotted = ctx.dotted(expr) if ctx is not None else None
        if dotted is None:
            return None
        parts = dotted.split(".")
        attr = parts[-1]
        if not _is_lock_attr(attr):
            return None
        if parts[0] == "self" and len(parts) == 2 and m is not None:
            return f"{m.cls}.{attr}"
        hint = tm.INSTANCE_HINTS.get(parts[-2]) if len(parts) >= 2 \
            else None
        if hint:
            return f"{hint}.{attr}"
        return f"?.{attr}"

    # -- domain propagation ------------------------------------------------

    def _propagate_domains(self) -> dict[str, frozenset]:
        """Seed method domains from the registry, then flow them through
        self-calls and hinted cross-class calls to a fixpoint. A method
        no declared or inferred domain reaches runs only in its class's
        owner domain."""
        dom: dict[str, set] = {q: set() for q in self.methods}
        for qual, m in self.methods.items():
            if m.name in tm.CONSTRUCTION_METHODS:
                continue
            if qual in tm.METHOD_DOMAINS:
                dom[qual] |= tm.METHOD_DOMAINS[qual]
            ep = tm.ENTRYPOINTS.get(qual) or tm.ENTRYPOINTS.get(m.name)
            if ep is not None and ep.key in (qual, m.name):
                dom[qual].add(ep.domain)
        changed = True
        while changed:
            changed = False
            for qual, m in self.methods.items():
                src = dom[qual]
                if not src:
                    continue
                targets = [f"{m.cls}.{n}" for n in m.self_calls]
                targets += [f"{c}.{n}" for c, n in m.hint_calls]
                for t in targets:
                    tmedia = self.methods.get(t)
                    if tmedia is None \
                            or tmedia.name in tm.CONSTRUCTION_METHODS:
                        continue
                    # declared methods hold their declared set: the
                    # registry row IS the crossing-point contract, and
                    # widening it silently would hide missing rows
                    if t in tm.METHOD_DOMAINS:
                        continue
                    if not src <= dom[t]:
                        dom[t] |= src
                        changed = True
        out: dict[str, frozenset] = {}
        for qual, m in self.methods.items():
            if dom[qual]:
                out[qual] = frozenset(dom[qual])
            else:
                out[qual] = frozenset(
                    {tm.CLASS_OWNER.get(m.cls, tm.MAIN)})
        return out

    def method_domains(self, m: "_Method") -> frozenset:
        return self.domains.get(m.qual,
                                frozenset({tm.CLASS_OWNER.get(m.cls,
                                                              tm.MAIN)}))

    # -- transitive lock acquisition ---------------------------------------

    def _transitive_acquires(self) -> dict[str, frozenset]:
        memo: dict[str, frozenset] = {}

        def visit(qual: str, stack: frozenset) -> frozenset:
            if qual in memo:
                return memo[qual]
            if qual in stack:
                return frozenset()
            m = self.methods.get(qual)
            if m is None:
                return frozenset()
            acc = set(m.lock_keys)
            nxt = stack | {qual}
            for n in m.self_calls:
                acc |= visit(f"{m.cls}.{n}", nxt)
            for c, n in m.hint_calls:
                acc |= visit(f"{c}.{n}", nxt)
            memo[qual] = frozenset(acc)
            return memo[qual]

        for qual in list(self.methods):
            visit(qual, frozenset())
        return memo


# -- shared AST helpers ----------------------------------------------------


def _write_targets(node: ast.AST):
    """Yield (base_expr, attr_name) for every attribute-family write in
    a statement: plain/aug assigns, subscript stores, del of a keyed
    entry, and mutator-method calls."""
    if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = list(node.targets if isinstance(node, ast.Assign)
                       else [node.target])
        # a tuple target writes each of its elements (a, self.x = ...)
        while any(isinstance(t, (ast.Tuple, ast.List)) for t in targets):
            targets = [e for t in targets
                       for e in (t.elts if isinstance(t, (ast.Tuple,
                                                          ast.List))
                                 else [t])]
        for t in targets:
            while isinstance(t, ast.Subscript):
                t = t.value
            if isinstance(t, ast.Attribute):
                yield t.value, t.attr
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            while isinstance(t, ast.Subscript):
                t = t.value
            if isinstance(t, ast.Attribute):
                yield t.value, t.attr
    elif isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS \
                and isinstance(f.value, ast.Attribute):
            yield f.value.value, f.value.attr


def _held_locks(index: _Index, m: _Method, node: ast.AST) -> set[str]:
    """Lock keys of every ``with`` lexically enclosing ``node`` within
    its own function."""
    held: set[str] = set()
    ctx = m.ctx
    cur = ctx.parent(node)
    while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                  ast.Module)):
        if isinstance(cur, ast.With):
            for item in cur.items:
                key = index.lock_key(m, item.context_expr)
                if key:
                    held.add(key)
        cur = ctx.parent(cur)
    return held


def _held_lock_exprs(index: _Index, m: _Method,
                     node: ast.AST) -> set[str]:
    """Dotted spellings of the enclosing with-locks (the T003 condition-
    idiom exemption compares the wait receiver against these)."""
    held: set[str] = set()
    ctx = m.ctx
    cur = ctx.parent(node)
    while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                  ast.Module)):
        if isinstance(cur, ast.With):
            for item in cur.items:
                if index.lock_key(m, item.context_expr):
                    d = ctx.dotted(item.context_expr)
                    if d:
                        held.add(d)
        cur = ctx.parent(cur)
    return held


def _finding(ctx: ModuleContext, node: ast.AST, rule: str,
             message: str) -> Finding:
    line = getattr(node, "lineno", 0)
    snippet = (ctx.lines[line - 1].strip()
               if 0 < line <= len(ctx.lines) else "")
    return Finding(rule=rule, path=ctx.relpath, line=line,
                   message=message, hint=THREAD_RULES[rule][1],
                   context=ctx.qualname(node), snippet=snippet)


def _cross_domains(domains: frozenset, owner: str) -> frozenset:
    """Domains that make an access cross-domain: everything beyond the
    family owner and the exempt (quiesced/setup) domains."""
    return frozenset(domains) - {owner} - tm.EXEMPT_DOMAINS


# -- rules -----------------------------------------------------------------


def _base_class(ctx: ModuleContext, m, base) -> str | None:
    """Best-effort class of a write's base expression: ``self`` is the
    enclosing class; anything else resolves its leaf name through
    INSTANCE_HINTS (``self.engine`` -> ContinuousEngine)."""
    if isinstance(base, ast.Name) and base.id == "self":
        return m.cls
    dotted = ctx.dotted(base)
    if dotted:
        return tm.INSTANCE_HINTS.get(dotted.split(".")[-1])
    return None


def _rule_t001(index: _Index, ctx: ModuleContext):
    """Unlocked writes to registered attribute families."""
    for node in ast.walk(ctx.tree):
        for base, attr in _write_targets(node):
            m = index.method_for(node)
            if m is None or m.name in tm.CONSTRUCTION_METHODS:
                continue
            fam = tm.family_for(_base_class(ctx, m, base), attr)
            if fam is None:
                continue
            domains = index.method_domains(m)
            if domains <= tm.EXEMPT_DOMAINS:
                continue
            if fam.lock is not None:
                held = _held_locks(index, m, node)
                if any(k.endswith(f".{fam.lock}") for k in held):
                    continue
                yield _finding(
                    ctx, node, "T001",
                    f"write to {fam.owner_class}.{attr} (owned by "
                    f"{fam.domain!r}) without holding "
                    f"{fam.owner_class}.{fam.lock} — reachable from "
                    f"{{{', '.join(sorted(domains))}}}")
            else:
                cross = _cross_domains(domains, fam.domain)
                if not cross:
                    continue
                yield _finding(
                    ctx, node, "T001",
                    f"write to {fam.owner_class}.{attr} from "
                    f"{{{', '.join(sorted(cross))}}} but the family is "
                    f"{fam.domain!r}-private (no lock declared)")


def _rule_t002(index: _Index, contexts: list[ModuleContext]):
    """Lock-order inversion over the global acquisition graph."""
    # edges: (outer key, inner key) -> first acquisition site
    edges: dict[tuple[str, str], tuple[ModuleContext, ast.AST]] = {}

    def note(outer: str, inner: str, ctx: ModuleContext,
             site: ast.AST) -> None:
        if outer != inner:
            edges.setdefault((outer, inner), (ctx, site))

    for ctx in contexts:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.With):
                continue
            m = index.method_for(node)
            if m is None:
                continue
            inner_keys = [index.lock_key(m, it.context_expr)
                          for it in node.items]
            inner_keys = [k for k in inner_keys if k]
            if not inner_keys:
                continue
            outer_held = _held_locks(index, m, node)
            for outer in outer_held:
                for inner in inner_keys:
                    note(outer, inner, ctx, node)
            # multiple locks in ONE with statement acquire in item order
            for i, outer in enumerate(inner_keys):
                for inner in inner_keys[i + 1:]:
                    note(outer, inner, ctx, node)
            # calls made while holding these locks acquire the callee's
            # transitive lock set
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                dotted = m.ctx.dotted(sub.func)
                if not dotted:
                    continue
                parts = dotted.split(".")
                target = None
                if len(parts) == 2 and parts[0] == "self":
                    target = f"{m.cls}.{parts[1]}"
                elif len(parts) >= 2:
                    hint = tm.INSTANCE_HINTS.get(parts[-2])
                    if hint:
                        target = f"{hint}.{parts[-1]}"
                if target is None:
                    continue
                for inner in index.acquires.get(target, frozenset()):
                    for outer in inner_keys:
                        note(outer, inner, ctx, sub)

    # cycle detection (iterative DFS, deterministic order)
    graph: dict[str, list[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, []).append(b)
    for a in graph:
        graph[a].sort()
    seen_cycles: set[tuple] = set()
    state: dict[str, int] = {}  # 0 visiting / 1 done

    def dfs(start: str, path: list[str]):
        node = path[-1]
        for nxt in graph.get(node, ()):
            if nxt in path:
                cyc = tuple(path[path.index(nxt):])
                canon = min(tuple(cyc[i:] + cyc[:i])
                            for i in range(len(cyc)))
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    a, b = node, nxt
                    ctx, site = edges[(a, b)]
                    yield ctx, site, cyc + (nxt,)
            elif state.get(nxt) != 1:
                yield from dfs(start, path + [nxt])
        state[node] = 1

    for start in sorted(graph):
        if state.get(start) != 1:
            yield from (
                _finding(ctx, site, "T002",
                         f"lock-order inversion: "
                         f"{' -> '.join(cycle)} forms a cycle")
                for ctx, site, cycle in dfs(start, [start]))


def _rule_t003(index: _Index, ctx: ModuleContext):
    """Blocking calls lexically inside a with-lock body."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        m = index.method_for(node)
        if m is None:
            continue
        held = _held_locks(index, m, node)
        if not held:
            continue
        dotted = m.ctx.dotted(node.func) or ""
        attr = (node.func.attr
                if isinstance(node.func, ast.Attribute) else "")
        blocking = None
        if dotted in _BLOCKING_DOTTED \
                or any(dotted.endswith("." + d.split(".")[-1])
                       and dotted.split(".")[-2:] == d.split(".")[-2:]
                       for d in _BLOCKING_DOTTED):
            blocking = dotted
        elif attr in _BLOCKING_ATTRS:
            blocking = attr
        elif attr == "join":
            base = node.func.value
            base_dotted = m.ctx.dotted(base) or ""
            if isinstance(base, ast.Constant):
                pass  # ", ".join(...) — string join
            elif base_dotted.endswith("path") or ".path." in base_dotted:
                pass  # os.path.join
            else:
                blocking = f"{base_dotted or '<expr>'}.join"
        elif attr == "wait":
            base_dotted = m.ctx.dotted(node.func.value) or ""
            if base_dotted and base_dotted in _held_lock_exprs(
                    index, m, node):
                pass  # cond.wait() under `with cond:` — sanctioned
            else:
                blocking = f"{base_dotted or '<expr>'}.wait"
        if blocking is None:
            continue
        yield _finding(
            ctx, node, "T003",
            f"blocking call {blocking}() while holding "
            f"{{{', '.join(sorted(held))}}}")


def _thread_target_keys(ctx: ModuleContext, m: "_Method | None",
                        expr: ast.AST) -> list[str] | None:
    """Registry keys a Thread target expression can resolve to; None
    when unresolvable. A Name bound by an enclosing ``for x in (a, b)``
    resolves to every element (the server.start idiom)."""
    dotted = ctx.dotted(expr)
    if dotted is not None:
        parts = dotted.split(".")
        if parts[0] == "self" and len(parts) == 2 and m is not None:
            return [f"{m.cls}.{parts[1]}", parts[1]]
        return [dotted, parts[-1]]
    return None


def _rule_t004(index: _Index, ctx: ModuleContext):
    """Thread construction outside the entrypoint registry."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = ctx.dotted(node.func) or ""
        if not (dotted == "threading.Thread"
                or dotted.endswith(".Thread")):
            continue
        m = index.method_for(node)
        target = None
        for kw in node.keywords:
            if kw.arg == "target":
                target = kw.value
        if target is None and node.args:
            # Thread(group, target, ...) positional form
            target = node.args[1] if len(node.args) > 1 else None
        if target is None:
            yield _finding(ctx, node, "T004",
                           "Thread() without a resolvable target")
            continue
        candidates: list[list[str]] = []
        if isinstance(target, ast.Name):
            # loop-bound target: `for t in (self._a, self._b):` — every
            # element must be registered; a Name with no such binding
            # is a local function spawned by name (pump_requests)
            cur = ctx.parent(node)
            while cur is not None and not isinstance(cur,
                                                     ast.FunctionDef):
                if isinstance(cur, ast.For) \
                        and isinstance(cur.target, ast.Name) \
                        and cur.target.id == target.id \
                        and isinstance(cur.iter, (ast.Tuple, ast.List)):
                    for el in cur.iter.elts:
                        k = _thread_target_keys(ctx, m, el)
                        if k is not None:
                            candidates.append(k)
                    break
                cur = ctx.parent(cur)
            if not candidates:
                candidates.append([target.id])
        else:
            keys = _thread_target_keys(ctx, m, target)
            if keys is not None:
                candidates.append(keys)
        if not candidates:
            yield _finding(ctx, node, "T004",
                           "Thread() target not statically resolvable "
                           "— register it or name it directly")
            continue
        for keys in candidates:
            if not any(k in tm.ENTRYPOINTS for k in keys):
                yield _finding(
                    ctx, node, "T004",
                    f"thread target {keys[0]!r} is not in the "
                    f"entrypoint registry (threadmodel.ENTRYPOINTS)")


def _rule_t005(index: _Index, ctx: ModuleContext):
    """Raw mutable family attrs returned across a domain boundary."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        val = node.value
        if not isinstance(val, ast.Attribute):
            continue
        attr = val.attr
        m = index.method_for(node)
        if m is None or m.name in tm.CONSTRUCTION_METHODS:
            continue
        fam = tm.family_for(_base_class(ctx, m, val.value), attr)
        if fam is None:
            continue
        domains = index.method_domains(m)
        cross = _cross_domains(domains, fam.domain)
        if not cross:
            continue
        yield _finding(
            ctx, node, "T005",
            f"returns {fam.owner_class}.{attr} raw to "
            f"{{{', '.join(sorted(cross))}}} — the {fam.domain!r}-owned "
            f"object escapes its domain")


# -- the run -----------------------------------------------------------------


def thread_scope(relpath: str) -> bool:
    """The checked surface: the host runtime and the observability
    plane (where every thread domain meets)."""
    return any(s in relpath for s in _SCOPES)


def run_threadcheck(files: list[Path], rel_to: Path) -> list[Finding]:
    """Parse, index, and run every T-rule; returns pragma-filtered
    findings sorted by (path, line, rule). Same contract as
    lint.lint_paths, same Finding/baseline machinery."""
    contexts: list[ModuleContext] = []
    findings: list[Finding] = []
    for ctx in iter_module_contexts(files, rel_to):
        if isinstance(ctx, tuple):  # (relpath, read/parse error)
            relpath, err = ctx
            if thread_scope(relpath):
                findings.append(Finding(
                    rule="T000", path=relpath,
                    line=getattr(err, "lineno", None) or 0,
                    message=f"unreadable or unparseable: "
                            f"{type(err).__name__}: {err}",
                    hint=THREAD_RULES["T000"][1],
                    snippet=getattr(err, "text", None) or ""))
            continue
        if thread_scope(ctx.relpath):
            contexts.append(ctx)
    index = _Index(contexts)
    raw: list[Finding] = list(_rule_t002(index, contexts))
    for ctx in contexts:
        raw.extend(_rule_t001(index, ctx))
        raw.extend(_rule_t003(index, ctx))
        raw.extend(_rule_t004(index, ctx))
        raw.extend(_rule_t005(index, ctx))
    ctx_by_path = {c.relpath: c for c in contexts}
    for f in raw:
        ctx = ctx_by_path.get(f.path)
        if ctx is not None:
            allowed = (ctx.pragmas.get(f.line, set())
                       | ctx.pragmas_below.get(f.line, set()))
            if f.rule in allowed:
                continue
        findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
