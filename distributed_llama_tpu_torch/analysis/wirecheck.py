"""wirecheck: producer/consumer wire-schema drift lint over the port (the
JAX package's analysis/wirecheck.py; the rules and their machinery
unchanged, the registry the port's analysis/wiremodel.py).

A pure-AST pass that never imports the runtime. Rules (each has firing,
non-firing and pragma fixtures in tests/test_torch_analysis_wirecheck.py):

* **W001 unregistered key at a producer site**;
* **W002 consumer read disagrees with the registry** (an unregistered
  key, ``[]`` on an optional key, or a ``.get`` fallback that contradicts
  the declared default);
* **W003 pack/unpack asymmetry** in a declared codec pair;
* **W004 unregistered Prometheus family**;
* **W005 persistent format without an upgrade path**.

W000 reports unreadable inputs and, on full scans, registry self-check
failures and registered sites that resolve to no def.

Scope: the port's ``runtime/``, ``obs/``, ``tools/`` and ``io/`` (the
``.tkcache`` and ``.slices`` sidecars live there); the port's tools are
inside its package, so the scan set is the package. Suppression is
dlint's: ``# wirecheck: allow[W002] reason`` pragmas and the baseline in
analysis/wirecheck_baseline.txt (empty).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from .lint import Finding, ModuleContext, iter_module_contexts
from . import wiremodel as wm

# rule catalogue (rendered by --wirecheck and the README table)
WIRE_RULES: dict[str, tuple[str, str]] = {
    "W000": ("unreadable input or inconsistent registry",
             "fix the path/parse error, or repair the wiremodel entry"),
    "W001": ("unregistered key written at a producer site",
             "declare the field in wiremodel (with required/default/"
             "since), or drop the write"),
    "W002": ("consumer read disagrees with the registry",
             "register the key, or read optional fields via .get with "
             "the declared default"),
    "W003": ("pack/unpack asymmetry in a declared codec pair",
             "serialize and parse the same field set — or retire the "
             "field from both sides"),
    "W004": ("unregistered Prometheus family",
             "add the family (and its labels) to "
             "wiremodel.METRIC_FAMILIES"),
    "W005": ("persistent format field without an upgrade path",
             "give the field a since version and an absent-tolerant "
             "read (optional + default) so N-1 files still load"),
}

_SCOPES = ("runtime/", "obs/", "tools/", "io/")

#: where registry-level findings (W000 self-check, W005 fallback)
#: anchor when no producer site resolves
_REGISTRY_PATH = "distributed_llama_tpu_torch/analysis/wiremodel.py"

_METRIC_RE = re.compile(r"dllama_[a-z0-9_]+")

_MISSING = object()  # `.get(key)` with no fallback argument


def wire_scope(relpath: str) -> bool:
    """The checked surface: the host runtime, the observability plane,
    and the tools that parse both back (fleet scrape, corpus CLIs)."""
    return any(s in relpath for s in _SCOPES)


def wire_files(package_dir: Path, repo_root: Path) -> list[Path]:
    """The wirecheck scan set: the package (the port's tools/, which parse
    the formats back, are inside it)."""
    from .lint import package_files

    return package_files(package_dir)


# -- site resolution -------------------------------------------------------


def _iter_defs(mc: ModuleContext):
    """Every (qualified name, def node) in the module, where the
    qualname includes the def's OWN name (ModuleContext.qualname gives
    the ENCLOSING def — the baseline context — which is the wrong
    identity for matching a site to its def)."""
    out: list[tuple[str, ast.AST]] = []

    def walk(node, stack):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                q = ".".join(stack + [child.name])
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    out.append((q, child))
                walk(child, stack + [child.name])
            else:
                walk(child, stack)

    walk(mc.tree, [])
    return out


class _Sites:
    """Resolves registry ``path.py:Qual.name`` sites against the parsed
    tree. Qualnames match by suffix so ``Handler.do_GET`` finds the
    handler class nested inside a factory method; paths match exactly
    or by ``/``-suffix so fixture trees under tmp dirs resolve too."""

    def __init__(self, contexts: list[ModuleContext]):
        self._defs: dict[str, list[tuple[str, ast.AST]]] = {
            mc.relpath: _iter_defs(mc) for mc in contexts}
        self._by_path = {mc.relpath: mc for mc in contexts}
        self._cache: dict[str, tuple[ModuleContext, ast.AST] | None] = {}

    def resolve(self, site: str) -> tuple[ModuleContext, ast.AST] | None:
        if site in self._cache:
            return self._cache[site]
        path, _, qual = site.partition(":")
        hit = None
        for relpath, defs in sorted(self._defs.items()):
            if not (relpath == path or relpath.endswith("/" + path)):
                continue
            for q, node in defs:
                if q == qual or q.endswith("." + qual):
                    hit = (self._by_path[relpath], node)
                    break
            if hit:
                break
        self._cache[site] = hit
        return hit


# -- key collection --------------------------------------------------------


def _written_keys(mc: ModuleContext, func: ast.AST):
    """(key, node) for every literal string key the def writes: dict
    display keys (except dicts passed as keyword arguments — those are
    API kwargs like ``headers={...}``, not wire payload construction)
    and ``obj["key"] = ...`` subscript stores."""
    out: list[tuple[str, ast.AST]] = []
    for node in ast.walk(func):
        if isinstance(node, ast.Dict):
            if isinstance(mc.parent(node), ast.keyword):
                continue
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value,
                                                              str):
                    out.append((k.value, k))
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Store):
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                out.append((sl.value, node))
    return out


def _read_keys(mc: ModuleContext, func: ast.AST):
    """(key, node, kind, default_expr) for every literal string read:
    ``obj["key"]`` loads (kind="index") and ``obj.get("key"[, d])``
    calls (kind="get", default_expr is _MISSING when absent)."""
    out: list[tuple[str, ast.AST, str, object]] = []
    for node in ast.walk(func):
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load):
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                out.append((sl.value, node, "index", _MISSING))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "get" \
                and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            default = node.args[1] if len(node.args) > 1 else _MISSING
            out.append((node.args[0].value, node, "get", default))
    return out


def _finding(mc: ModuleContext, node: ast.AST, rule: str,
             message: str) -> Finding:
    line = getattr(node, "lineno", 0)
    snippet = (mc.lines[line - 1].strip()
               if 0 < line <= len(mc.lines) else "")
    return Finding(rule=rule, path=mc.relpath, line=line,
                   message=message, hint=WIRE_RULES[rule][1],
                   context=mc.qualname(node), snippet=snippet)


def _registry_finding(rule: str, message: str,
                      context: str = "<registry>") -> Finding:
    return Finding(rule=rule, path=_REGISTRY_PATH, line=1,
                   message=message, hint=WIRE_RULES[rule][1],
                   context=context, snippet=message)


# -- rules -----------------------------------------------------------------


def _rule_w001(sites: _Sites, formats):
    """Producer writes a key the registry does not declare."""
    # a def may produce several formats (compact writes both the header
    # and replayed admits): its allowed set is the union
    allowed: dict[int, set[str]] = {}
    owners: dict[int, tuple[ModuleContext, ast.AST, list[str]]] = {}
    for fmt in formats:
        for site in fmt.producers:
            hit = sites.resolve(site)
            if hit is None:
                continue
            mc, node = hit
            allowed.setdefault(id(node), set()).update(
                f.name for f in fmt.fields)
            owners.setdefault(id(node), (mc, node, []))[2].append(fmt.name)
    for key_id in sorted(owners, key=lambda i: (
            owners[i][0].relpath, owners[i][1].lineno)):
        mc, node, names = owners[key_id]
        ok = allowed[key_id]
        for key, knode in _written_keys(mc, node):
            if key not in ok:
                yield _finding(
                    mc, knode, "W001",
                    f"producer of {'/'.join(sorted(set(names)))} writes "
                    f"unregistered key {key!r}")


def _rule_w002(sites: _Sites, formats):
    """Consumer read disagrees with the declared schema."""
    fields: dict[int, dict[str, list]] = {}
    owners: dict[int, tuple[ModuleContext, ast.AST, list[str]]] = {}
    for fmt in formats:
        for site in fmt.consumers:
            hit = sites.resolve(site)
            if hit is None:
                continue
            mc, node = hit
            table = fields.setdefault(id(node), {})
            for f in fmt.fields:
                table.setdefault(f.name, []).append(f)
            owners.setdefault(id(node), (mc, node, []))[2].append(fmt.name)
    for key_id in sorted(owners, key=lambda i: (
            owners[i][0].relpath, owners[i][1].lineno)):
        mc, node, names = owners[key_id]
        table = fields[key_id]
        label = "/".join(sorted(set(names)))
        for key, knode, kind, default in _read_keys(mc, node):
            decls = table.get(key)
            if decls is None:
                yield _finding(
                    mc, knode, "W002",
                    f"consumer of {label} reads unregistered key {key!r}")
                continue
            if any(f.required for f in decls):
                # required-in-any wins: the reader may assume presence,
                # and any .get fallback is dead code, not drift
                continue
            if kind == "index":
                yield _finding(
                    mc, knode, "W002",
                    f"optional key {key!r} read with [] — an N-1 "
                    f"producer legally omits it (declared default "
                    f"{decls[0].default!r})")
                continue
            if default is _MISSING:
                if any(f.default is None for f in decls):
                    continue
                yield _finding(
                    mc, knode, "W002",
                    f".get({key!r}) without the declared default "
                    f"{decls[0].default!r} — absent parses as None")
                continue
            try:
                literal = ast.literal_eval(default)
            except (ValueError, SyntaxError):
                continue  # computed fallback: out of static reach
            if not any(_defaults_equal(f.default, literal)
                       for f in decls):
                yield _finding(
                    mc, knode, "W002",
                    f".get({key!r}, {literal!r}) contradicts the "
                    f"declared default {decls[0].default!r}")


def _defaults_equal(declared, literal) -> bool:
    if declared == literal:
        # 0 == False would bless a bool/int confusion; require the
        # types to agree too (int/float interchange is fine)
        return (type(declared) is type(literal)
                or {type(declared), type(literal)} <= {int, float}
                and not {type(declared), type(literal)} & {bool})
    # tuple-vs-list: JSON has no tuples, so () and [] declare the
    # same absent-sequence default
    if isinstance(declared, (tuple, list)) \
            and isinstance(literal, (tuple, list)):
        return tuple(declared) == tuple(literal)
    return False


def _rule_w003(sites: _Sites, formats):
    """Keys serialized on one side of a codec pair but not the other."""
    for fmt in formats:
        for pack_site, unpack_site in fmt.codec_pairs:
            pack = sites.resolve(pack_site)
            unpack = sites.resolve(unpack_site)
            if pack is None or unpack is None:
                continue  # full-scan W000 reports unresolved sites
            pmc, pnode = pack
            umc, unode = unpack
            written = {}
            for key, knode in _written_keys(pmc, pnode):
                written.setdefault(key, knode)
            read = {}
            for key, knode, _, _ in _read_keys(umc, unode):
                read.setdefault(key, knode)
            if not written or not read:
                continue  # binary codec: the corpus round-trip owns it
            for key in sorted(set(written) - set(read)):
                yield _finding(
                    pmc, written[key], "W003",
                    f"{fmt.name}: {key!r} packed by {pack_site.split(':')[1]}"
                    f" but never unpacked by {unpack_site.split(':')[1]}")
            for key in sorted(set(read) - set(written)):
                yield _finding(
                    umc, read[key], "W003",
                    f"{fmt.name}: {key!r} unpacked by "
                    f"{unpack_site.split(':')[1]} but never packed by "
                    f"{pack_site.split(':')[1]}")


def _rule_w004(mc: ModuleContext, families):
    """dllama_* family literals absent from the registry."""
    for node in ast.walk(mc.tree):
        if not (isinstance(node, ast.Constant)
                and isinstance(node.value, str)):
            continue
        for m in _METRIC_RE.finditer(node.value):
            fam = m.group(0)
            if fam in families:
                continue
            # exposition suffixes ride on a registered family name
            base = re.sub(r"_(?:bucket|sum|count)$", "", fam)
            if base in families:
                continue
            yield _finding(
                mc, node, "W004",
                f"Prometheus family {fam!r} is not in "
                f"wiremodel.METRIC_FAMILIES")


def _rule_w005(sites: _Sites, formats):
    """Persistent-format fields that strand N-1 files."""
    for fmt in formats:
        if not fmt.persistent:
            continue
        anchor = None
        for site in fmt.producers:
            anchor = sites.resolve(site)
            if anchor is not None:
                break
        for f in fmt.fields:
            problem = None
            if f.since is None:
                problem = (f"persistent format {fmt.name} field "
                           f"{f.name!r} has no since version")
            elif f.since > 1 and f.required:
                problem = (f"persistent format {fmt.name} field "
                           f"{f.name!r} added at v{f.since} as REQUIRED "
                           f"— a v{f.since - 1} file cannot satisfy it")
            if problem is None:
                continue
            if anchor is not None:
                mc, node = anchor
                yield _finding(mc, node, "W005", problem)
            else:
                yield _registry_finding("W005", problem,
                                        context=fmt.name)


# -- the run -----------------------------------------------------------------


def run_wirecheck(files: list[Path], rel_to: Path,
                  formats=None, families=None,
                  full_scan: bool = True) -> list[Finding]:
    """Parse, resolve sites, and run every W-rule; returns pragma-
    filtered findings sorted by (path, line, rule). Same contract as
    lint.lint_paths, same Finding/baseline machinery. ``formats`` /
    ``families`` override the registry (rule fixtures, mutation
    gates); ``full_scan=False`` (partial file list) skips the
    registry-consistency and site-resolution W000s, which are only
    meaningful against the whole tree."""
    formats = wm.FORMATS if formats is None else formats
    families = wm.METRIC_FAMILIES if families is None else families
    contexts: list[ModuleContext] = []
    findings: list[Finding] = []
    for mc in iter_module_contexts(files, rel_to):
        if isinstance(mc, tuple):  # (relpath, read/parse error)
            relpath, err = mc
            if wire_scope(relpath):
                findings.append(Finding(
                    rule="W000", path=relpath,
                    line=getattr(err, "lineno", None) or 0,
                    message=f"unreadable or unparseable: "
                            f"{type(err).__name__}: {err}",
                    hint=WIRE_RULES["W000"][1],
                    snippet=getattr(err, "text", None) or ""))
            continue
        if wire_scope(mc.relpath):
            contexts.append(mc)
    sites = _Sites(contexts)
    raw: list[Finding] = []
    if full_scan:
        for problem in wm.validate(formats, families):
            raw.append(_registry_finding("W000", problem))
        every_site = sorted({
            s for fmt in formats
            for s in (fmt.producers + fmt.consumers
                      + tuple(x for pair in fmt.codec_pairs
                              for x in pair))})
        for site in every_site:
            if sites.resolve(site) is None:
                raw.append(_registry_finding(
                    "W000", f"registered site {site!r} resolves to no "
                            f"def in the scanned tree"))
    raw.extend(_rule_w001(sites, formats))
    raw.extend(_rule_w002(sites, formats))
    raw.extend(_rule_w003(sites, formats))
    for mc in contexts:
        raw.extend(_rule_w004(mc, families))
    raw.extend(_rule_w005(sites, formats))
    mc_by_path = {c.relpath: c for c in contexts}
    for f in raw:
        mc = mc_by_path.get(f.path)
        if mc is not None:
            allowed = (mc.pragmas.get(f.line, set())
                       | mc.pragmas_below.get(f.line, set()))
            if f.rule in allowed:
                continue
        findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
