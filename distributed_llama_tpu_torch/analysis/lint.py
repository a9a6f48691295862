"""dlint engine: AST module contexts, findings, pragmas, and the baseline
(the JAX package's analysis/lint.py, the port's own copy).

The linter is pure static analysis: it never imports the modules it
checks (a lint pass must not depend on torch or a card, and must not run
package side effects). Each rule in ``rules.py`` receives a
``ModuleContext`` with the parsed AST plus the shared resolution helpers
(import-alias dotted names, enclosing-function maps) and yields
``Finding``s.

Suppression has two layers:

* **pragmas**: ``# dlint: allow[D001] reason`` on the finding line (or
  alone on the line above, for findings inside multi-line expressions)
  marks an intentional hazard at the site, with its reason in the source;
* **baseline**: ``analysis/dlint_baseline.txt`` grandfathers findings so
  a gate reads "no NEW findings". Keys are line-number-independent (rule
  + file + enclosing def + a hash of the flagged line's text), so edits
  above a finding do not churn the file.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import re
from collections import Counter
from pathlib import Path
from typing import Iterator


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint hit. ``path`` is repo-relative posix; ``context`` is the
    enclosing def's qualified name ("<module>" at top level); ``snippet``
    is the stripped source line (feeds the baseline key)."""

    rule: str
    path: str
    line: int
    message: str
    hint: str
    context: str = "<module>"
    snippet: str = ""

    def key(self) -> str:
        """Baseline identity: stable across line renumbering (a hash of
        the flagged line's text, not its position)."""
        digest = hashlib.sha1(self.snippet.encode()).hexdigest()[:12]
        return f"{self.rule} {self.path}:{self.context} {digest}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} {self.message}"
                f"  [fix: {self.hint}]")


# one pragma grammar for every head of this engine: the tag names the head
# (`dlint:` for the D-rules, `threadcheck:` for the T-rules, `wirecheck:`
# for the W-rules); rule ids are disjoint, so a tag never blesses a
# foreign head's finding
_PRAGMA_RE = re.compile(
    r"#\s*(?:dlint|threadcheck|wirecheck):\s*allow\[([A-Z0-9,\s]+)\]")


def parse_pragmas(lines: list[str]) -> tuple[dict[int, set[str]],
                                             dict[int, set[str]]]:
    """(same_line, line_below) suppression maps, both 1-based.

    A trailing pragma on a code line covers that line only; a comment-only
    pragma line covers the line below it (for findings inside multi-line
    expressions)."""
    same: dict[int, set[str]] = {}
    below: dict[int, set[str]] = {}
    for i, text in enumerate(lines, start=1):
        rules: set[str] = set()
        for m in _PRAGMA_RE.finditer(text):
            rules |= {r.strip() for r in m.group(1).split(",")
                      if r.strip()}
        if not rules:
            continue
        same[i] = rules
        if text.strip().startswith("#"):  # comment-only pragma line
            below[i + 1] = rules
    return same, below


class ModuleContext:
    """Parsed module + the resolution helpers every rule needs."""

    def __init__(self, path: Path, relpath: str, source: str):
        self.path = path
        self.relpath = relpath  # repo-relative posix
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        self.pragmas, self.pragmas_below = parse_pragmas(self.lines)
        self._parents: dict[ast.AST, ast.AST] = {}
        self._func_of: dict[ast.AST, ast.AST | None] = {}
        self._qualname: dict[ast.AST, str] = {}
        self.aliases = self._collect_aliases()
        self._index_tree()

    # -- tree indexing -----------------------------------------------------

    def _index_tree(self):
        def walk(node, func, qual):
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node
                cqual, cfunc = qual, func
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    cqual = f"{qual}.{child.name}" if qual else child.name
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                        cfunc = child
                elif isinstance(child, ast.Lambda):
                    cqual = f"{qual}.<lambda>" if qual else "<lambda>"
                    cfunc = child
                self._func_of[child] = cfunc
                self._qualname[child] = cqual or "<module>"
                walk(child, cfunc, cqual)

        self._func_of[self.tree] = None
        self._qualname[self.tree] = "<module>"
        walk(self.tree, None, "")

    def parent(self, node: ast.AST) -> ast.AST | None:
        return self._parents.get(node)

    def enclosing_function(self, node: ast.AST):
        """Nearest enclosing FunctionDef/Lambda (None at module level).
        For a def node itself, its *enclosing* function."""
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return self._func_of.get(self._parents.get(node))
        return self._func_of.get(node)

    def qualname(self, node: ast.AST) -> str:
        """Qualified name of the def enclosing ``node`` ("<module>" at top
        level): the baseline's context component."""
        fn = self.enclosing_function(node)
        if fn is None:
            return "<module>"
        return self._qualname.get(fn, "<module>")

    def in_loop(self, node: ast.AST) -> bool:
        """Is ``node`` lexically inside a for/while loop of its own
        function (loops in enclosing defs do not count)?"""
        cur, func = self._parents.get(node), self.enclosing_function(node)
        while cur is not None and cur is not func:
            if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
                return True
            cur = self._parents.get(cur)
        return False

    # -- name resolution ---------------------------------------------------

    def _collect_aliases(self) -> dict[str, str]:
        """Local name -> canonical dotted module/symbol, from every import
        in the file (function-local imports included: the port imports
        torch.distributed and the tools lazily)."""
        aliases: dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return aliases

    def dotted(self, node: ast.AST) -> str | None:
        """'np.asarray'-style dotted string for a Name/Attribute chain, the
        leading segment resolved through the import aliases (``_np.asarray``
        -> 'numpy.asarray', ``dist.all_reduce`` ->
        'torch.distributed.all_reduce'). None for other expressions."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.aliases.get(node.id, node.id))
        return ".".join(reversed(parts))

    def call_target(self, call: ast.Call) -> str | None:
        return self.dotted(call.func)

    def function_calls_device(self, func: ast.AST) -> bool:
        """Does this def issue torch work (any torch.* call)? The D005 and
        D008 'around device work' gate."""
        for node in ast.walk(func):
            if isinstance(node, ast.Call):
                t = self.call_target(node)
                if t and (t == "torch" or t.startswith("torch.")):
                    return True
        return False


# -- scanning --------------------------------------------------------------


def iter_module_contexts(files: list[Path],
                         rel_to: Path) -> Iterator[ModuleContext]:
    for path in files:
        try:
            relpath = path.resolve().relative_to(
                rel_to.resolve()).as_posix()
        except ValueError:
            relpath = path.as_posix()
        try:
            source = path.read_text(encoding="utf-8")
            yield ModuleContext(path, relpath, source)
        except (OSError, UnicodeDecodeError, SyntaxError) as e:
            # an unreadable or unparseable input is itself a finding: a
            # silent skip would let a typo'd path report a clean tree
            yield relpath, e  # type: ignore[misc]  # caller branches


def lint_paths(files: list[Path], rel_to: Path,
               rules=None) -> list[Finding]:
    """Run every rule over ``files``; returns pragma-filtered findings
    sorted by (path, line, rule). ``rel_to`` anchors the repo-relative
    paths that scoped rules (and baseline keys) match against."""
    from . import rules as rules_mod

    active = rules if rules is not None else rules_mod.RULES
    findings: list[Finding] = []
    for ctx in iter_module_contexts(files, rel_to):
        if isinstance(ctx, tuple):  # (relpath, read/parse error)
            relpath, err = ctx
            findings.append(Finding(
                rule="D000", path=relpath,
                line=getattr(err, "lineno", None) or 0,
                message=f"unreadable or unparseable: "
                        f"{type(err).__name__}: {err}",
                hint="fix the path or the parse error",
                snippet=getattr(err, "text", None) or ""))
            continue
        for rule in active:
            scope = getattr(rule, "scope", None)
            if scope and not any(s in ctx.relpath for s in scope):
                continue
            for f in rule(ctx):
                allowed = (ctx.pragmas.get(f.line, set())
                           | ctx.pragmas_below.get(f.line, set()))
                if f.rule not in allowed:
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def package_files(package_dir: Path) -> list[Path]:
    """Every .py under the package: the lint surface (the port's tools/
    are inside the package, so they are scanned too)."""
    return sorted(p for p in package_dir.rglob("*.py")
                  if "__pycache__" not in p.parts)


# -- baseline --------------------------------------------------------------

_BASELINE_LINE_RE = re.compile(
    r"^(?P<key>\S+ \S+ [0-9a-f]{12})(?: x(?P<count>\d+))?$")


def load_baseline(path: Path) -> Counter:
    """Baseline file -> Counter of finding keys. Lines: ``<key>`` or
    ``<key> xN`` for N identical findings; '#' comments and blanks skipped.
    A missing file is an empty baseline."""
    counts: Counter = Counter()
    if not path.exists():
        return counts
    for raw in path.read_text(encoding="utf-8").splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _BASELINE_LINE_RE.match(line)
        if m:
            counts[m.group("key")] += int(m.group("count") or 1)
    return counts


def write_baseline(path: Path, findings: list[Finding],
                   flag: str = "--lint --write-baseline") -> None:
    counts = Counter(f.key() for f in findings)
    lines = [
        "# grandfathered findings, suppressed so the gate reads \"no NEW",
        "# findings\". Regenerate with:",
        f"#   python -m distributed_llama_tpu_torch.analysis {flag}",
        "# Key: <rule> <path>:<enclosing def> <sha1[:12] of the flagged "
        "line>; xN = count.",
        "",
    ]
    for key in sorted(counts):
        n = counts[key]
        lines.append(key if n == 1 else f"{key} x{n}")
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


def apply_baseline(findings: list[Finding],
                   baseline: Counter) -> tuple[list[Finding], int, list[str]]:
    """Split findings into (new, n_suppressed, stale_keys). The first N
    findings matching a baseline key (in file order) are suppressed; any
    extra occurrence is new. Baseline keys with no current match are stale
    (fixed since the baseline was written)."""
    budget = Counter(baseline)
    new: list[Finding] = []
    suppressed = 0
    for f in findings:
        k = f.key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            suppressed += 1
        else:
            new.append(f)
    stale = sorted(k for k, n in budget.items() if n > 0)
    return new, suppressed, stale
