"""shardcheck: the sharding and device-memory verifier of the tp grid on
one H100 80 GB (the JAX package's analysis/shardcheck.py).

For every config of the declared support matrix (model 7B/13B/70B x tp
1/2/4/8 x scheme ref/fused/overlap x weights Q40/F16, 72 configs, plus a
Q8-page column of 12: each model and tp under the fused scheme) it proves,
on the CPU, with no weight byte made:

  HBM-BUDGET  the rank's footprint (analysis/memory_model.py) fits the
              card with its headroom, and the verdict agrees with the
              declared one: a config that stops fitting fails, and one
              that starts fitting flags the matrix as stale;
  J004        each matmul weight a rank holds is its 1/tp band: the
              contract rows of parallel/tp.param_specs /
              expected_shard_names, read over ``meta`` tensors of the
              full tree, give every matmul leaf a tp axis on a tp > 1
              group, and the rank's leaves sum to the memory model's
              weights + replicated bytes;
  J005        no call of a dequantizing function (ops/dequant_sites.
              DEQUANT_FUNCTIONS) from outside the registered sites: an
              AST pass over the package, the static form of "no fallback
              to the plain version on the card";
  J006        bands are rank-uniform and cut on 32-value block boundaries
              (parallel/tp.validate_sharding's rules, reported as
              findings);
  KV-QUANT, KV-PAGED, KV-TIER, MIXED-HBM  the Q8 page price against the
              Q80 layout and its 2x capacity floor, the paged pool at its
              default size against the contiguous stripe, the tiers'
              staging and the mixed window inside a fitting config's
              headroom.

``tools/shardcheck.py`` of the port emits the run as JSON (PERF.md's
footprint table is generated from it).
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path

from ..parallel.comm_stats import SCHEMES
from .memory_model import (GIB, MemoryReport, device_footprint,
                           replicated_device_bytes, weights_device_bytes)

MODELS = ("7b", "13b", "70b")
WEIGHT_TYPES = ("q40", "f16")

# The declared support matrix: per (model, weights) x tp, does one rank
# fit an H100 80 GB (usable: 90% of its 85,017,493,504 bytes)? Worked out
# from the memory model and pinned, so that model drift is loud. Two are
# anchors: 70B Q40 fits one card, 70B F16 (130 GiB) does not. The scheme
# moves no verdict (every scheme bands every matmul 1/tp; only the
# collective staging, KB, differs).
_EXPECT_FITS = {
    ("7b", "q40"): {1: True, 2: True, 4: True, 8: True},
    ("7b", "f16"): {1: True, 2: True, 4: True, 8: True},
    ("13b", "q40"): {1: True, 2: True, 4: True, 8: True},
    ("13b", "f16"): {1: True, 2: True, 4: True, 8: True},
    ("70b", "q40"): {1: True, 2: True, 4: True, 8: True},
    ("70b", "f16"): {1: False, 2: True, 4: True, 8: True},
}


@dataclasses.dataclass(frozen=True)
class MatrixEntry:
    model: str
    tp: int
    scheme: str
    wtype: str
    expect_fits: bool
    # 'f32' prices the contiguous f32 stripe; 'q8' the paged pool at the
    # default page count in the Q8 layout (a smaller KV term)
    kv_quant: str = "f32"

    @property
    def label(self) -> str:
        base = f"{self.model}-tp{self.tp}-{self.scheme}-{self.wtype}"
        return base if self.kv_quant == "f32" else f"{base}-{self.kv_quant}"


SUPPORT_MATRIX = tuple(
    MatrixEntry(m, tp, s, w, _EXPECT_FITS[(m, w)][tp])
    for m in MODELS for tp in (1, 2, 4, 8)
    for s in SCHEMES for w in WEIGHT_TYPES) + tuple(
    # the Q8-page column: the serving codec across the tp grid under the
    # fused scheme (KV pricing does not depend on the scheme)
    MatrixEntry(m, tp, "fused", "q40", _EXPECT_FITS[(m, "q40")][tp],
                kv_quant="q8")
    for m in MODELS for tp in (1, 2, 4, 8))


@dataclasses.dataclass(frozen=True)
class ShardFinding:
    rule: str     # J004 | J005 | J006 | HBM-BUDGET | KV-* | MIXED-HBM
    config: str
    detail: str

    def render(self) -> str:
        return f"shardcheck: {self.config} FAIL {self.rule}: {self.detail}"


@dataclasses.dataclass(frozen=True)
class ConfigResult:
    config: str
    expect_fits: bool | None
    report: MemoryReport | None
    findings: tuple
    kv_quant: str = "f32"

    @property
    def ok(self) -> bool:
        return not self.findings


def model_spec(model: str, wtype: str):
    from ..models import synth
    from ..ops.quants import FloatType

    factory = {"7b": synth.llama2_7b_spec, "13b": synth.llama2_13b_spec,
               "70b": synth.llama2_70b_spec}[model]
    ft = {"q40": FloatType.Q40, "f16": FloatType.F16,
          "f32": FloatType.F32}[wtype]
    return factory(weights_float_type=ft)


def meta_params(spec) -> dict:
    """The full host tree's leaves as ``meta`` tensors (no bytes): Q40
    leaves as (codes (L, d, nb, 16) uint8, scales (L, d, nb) f16) pairs,
    dense ones f16/f32, the embedding and norms f32 (io/loader's tree)."""
    import torch

    from ..io.loader import Q40Weight
    from ..models.synth import _build_tree
    from ..ops.quants import QK, FloatType

    ft = spec.weights_float_type

    def t(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    def mm(*shape):
        if ft == FloatType.Q40:
            *lead, d, n = shape
            return Q40Weight(
                torch.empty((*lead, d, n // QK, 16), dtype=torch.uint8,
                            device="meta"),
                torch.empty((*lead, d, n // QK), dtype=torch.float16,
                            device="meta"))
        dt = torch.float16 if ft == FloatType.F16 else torch.float32
        return torch.empty(shape, dtype=dt, device="meta")

    return _build_tree(spec, t, mm)


# -- the contract checks ----------------------------------------------------


def check_sharding(spec, tp: int, scheme: str, config: str,
                   specs=None) -> list[ShardFinding]:
    """J004 over the full tree's meta leaves: the contract rows
    (tp.expected_shard_names) give every matmul leaf a tp axis on a tp > 1
    group, each banded axis divides over tp, and the rank's leaves (banded
    1/tp, replicated whole) sum to the memory model's weights + replicated
    bytes. ``specs`` overrides tp.param_specs (mutation self-tests: a
    weight declared replicated)."""
    from ..io.loader import Q40Weight
    from ..parallel import tp as tp_mod

    params = meta_params(spec)
    bands = specs if specs is not None else tp_mod.param_specs(params,
                                                               scheme)
    findings = []
    rank_bytes = 0
    matmul = set(tp_mod._MATMUL_SPECS)
    for name, val in params.items():
        band = bands.get(name)
        leaves = (val.qs, val.d16) if isinstance(val, Q40Weight) else (val,)
        tail = ((3, 2) if isinstance(val, Q40Weight) else (2,))
        for arr, t_dims in zip(leaves, tail):
            nbytes = arr.numel() * arr.element_size()
            if band is None or tp == 1:
                if tp > 1 and name in matmul:
                    findings.append(ShardFinding(
                        "J004", config,
                        f"{name}: matmul weight ({tuple(arr.shape)} "
                        f"{arr.dtype}) is REPLICATED on a tp={tp} group: "
                        f"every rank holds its {nbytes / GIB:.3f} GiB whole"))
                rank_bytes += nbytes
                continue
            axis = arr.ndim - t_dims + (0 if band == "out" else 1)
            if arr.shape[axis] % tp:
                findings.append(ShardFinding(
                    "J004", config,
                    f"{name}: axis {axis} ({arr.shape[axis]}) does not "
                    f"divide over tp={tp}"))
            rank_bytes += nbytes // tp
    if specs is None:
        rows = dict(tp_mod.expected_shard_names(params, scheme))
        for name in matmul & set(params):
            leaf = (f"{name}.qs" if isinstance(params[name], Q40Weight)
                    else name)
            if tp > 1 and not rows.get(leaf):
                findings.append(ShardFinding(
                    "J004", config,
                    f"{leaf}: no tp axis in tp.expected_shard_names"))
    want = weights_device_bytes(spec, tp) + replicated_device_bytes(spec)
    if not findings and rank_bytes != want:
        findings.append(ShardFinding(
            "J004", config,
            f"a rank's leaves hold {rank_bytes} B but the memory model "
            f"prices {want} B (weights + replicated)"))
    return findings


def _package_dir() -> Path:
    return Path(__file__).resolve().parents[1]


def check_dequant_sites(files=None, rel_to: Path | None = None,
                        config: str = "package") -> list[ShardFinding]:
    """J005: every call of a dequantizing function (by name, resolved
    through the module's imports to ops/quants) sits in a registered
    dequant site (ops/dequant_sites.py)."""
    from ..ops.dequant_sites import dequant_names, site_allowed
    from .lint import iter_module_contexts, package_files

    rel_to = rel_to or _package_dir().parent
    files = files if files is not None else package_files(_package_dir())
    names = dequant_names()
    # only a file that names a dequantizer can call one: parse just those
    files = [f for f in files
             if any(n in Path(f).read_text(encoding="utf-8") for n in names)]
    findings = []
    for ctx in iter_module_contexts(files, rel_to):
        if isinstance(ctx, tuple):
            continue
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            target = ctx.call_target(node) or ""
            leaf = target.rsplit(".", 1)[-1]
            if leaf not in names or not (
                    "quants" in target or target == leaf):
                continue
            fn = ctx.enclosing_function(node)
            fname = getattr(fn, "name", "<module>")
            if site_allowed(ctx.relpath, fname):
                continue
            findings.append(ShardFinding(
                "J005", config,
                f"{ctx.relpath}:{node.lineno} {fname}() calls {leaf}, "
                f"outside the registered dequant sites "
                f"(ops/dequant_sites.py): a weight's f32 copy the memory "
                f"model does not price"))
    return findings


def check_uniform_shards(spec, tp: int, scheme: str,
                         config: str) -> list[ShardFinding]:
    """J006: the constraints parallel/tp.validate_sharding raises on,
    reported as findings: heads, kv heads, hidden and vocab divide over
    tp, and under fused/overlap the Q40 input bands of wo/w2 are cut on
    32-value block boundaries."""
    from ..ops.quants import QK, FloatType
    from ..parallel import tp as tp_mod

    findings = []
    for value, what in ((spec.n_heads, "n_heads"),
                        (spec.n_kv_heads, "n_kv_heads"),
                        (spec.hidden_dim, "hidden_dim"),
                        (spec.vocab_size, "vocab_size")):
        if value % tp:
            findings.append(ShardFinding(
                "J006", config,
                f"{what}={value} does not divide over tp={tp}: ranks get "
                f"ragged bands (distinct shapes a rank)"))
    if scheme in ("fused", "overlap") \
            and spec.weights_float_type == FloatType.Q40:
        for value, what in ((spec.dim, "dim"),
                            (spec.hidden_dim, "hidden_dim")):
            if tp > 1 and value % tp == 0 and (value // tp) % QK:
                findings.append(ShardFinding(
                    "J006", config,
                    f"{scheme} scheme bands {what}={value} along the Q40 "
                    f"input-block axis: {value}/{tp} must be a "
                    f"{QK}-multiple"))
    if findings:
        return findings
    try:
        tp_mod.validate_sharding(spec, tp, scheme)
    except ValueError as e:
        findings.append(ShardFinding("J006", config,
                                     f"tp.validate_sharding: {e}"))
    return findings


def check_kv_quant_pricing(spec, tp: int, config: str) -> list[ShardFinding]:
    """KV-QUANT: the q8 page price equals the Q80 layout (per position
    kv_dim int8 codes + one f16 delta a 32-value block), recomputed here,
    and the equal-memory q8 pool holds at least 2x the f32 pages."""
    from ..ops.quants import QK
    from .memory_model import (DEFAULT_PAGE_SIZE, default_kv_pages,
                               equal_hbm_kv_pages, kv_position_bytes)

    findings = []
    kv_loc = (spec.n_kv_heads // tp) * spec.head_size
    if kv_loc % QK:
        return [ShardFinding(
            "KV-QUANT", config,
            f"shard-local kv width {kv_loc} does not divide into "
            f"{QK}-value Q80 blocks: q8 KV pages cannot run this config")]
    want = 2 * spec.n_layers * (kv_loc + 2 * (kv_loc // QK))
    got = kv_position_bytes(spec, tp, kv_quant="q8")
    if got != want:
        findings.append(ShardFinding(
            "KV-QUANT", config,
            f"q8 position bytes {got} != {want} (Q80 codes+deltas): the "
            f"memory_model q8 formula drifted from the page layout"))
    pages = default_kv_pages(spec, 1, DEFAULT_PAGE_SIZE)
    q8_pages = equal_hbm_kv_pages(spec, tp, pages, DEFAULT_PAGE_SIZE)
    if q8_pages < 2 * pages:
        findings.append(ShardFinding(
            "KV-QUANT", config,
            f"equal-memory q8 pool holds {q8_pages} pages for {pages} f32 "
            f"pages: below the 2x capacity floor the q8 column claims"))
    return findings


def check_paged_equivalence(spec, tp: int, config: str,
                            contiguous_bytes: int) -> list[ShardFinding]:
    """KV-PAGED: the paged pool at its default size (one slot's pages,
    scrap page excluded) charges exactly the contiguous stripe's bytes."""
    from .memory_model import (DEFAULT_PAGE_SIZE, default_kv_pages,
                               kv_page_pool_bytes)

    ps = DEFAULT_PAGE_SIZE
    if spec.seq_len % ps:
        return [ShardFinding(
            "KV-PAGED", config,
            f"seq_len={spec.seq_len} is not a multiple of the default "
            f"page size {ps}: paged engines cannot run this config")]
    paged = kv_page_pool_bytes(spec, tp, default_kv_pages(spec, 1, ps), ps,
                               include_scrap=False)
    if paged != contiguous_bytes:
        return [ShardFinding(
            "KV-PAGED", config,
            f"paged pool at default sizing charges {paged} B but the "
            f"contiguous stripe charges {contiguous_bytes} B: the "
            f"memory_model formulas drifted apart")]
    return []


def check_tier_staging(spec, tp: int, config: str, report,
                       kv_quant: str, expect_fits: bool) -> list:
    """KV-TIER: a tiered engine's 2-page promotion staging follows the page
    price and fits inside a fitting config's headroom."""
    from .memory_model import DEFAULT_PAGE_SIZE, kv_page_bytes

    findings = []
    staged = device_footprint(spec, tp, report.scheme, model=report.model,
                              kv_page_size=DEFAULT_PAGE_SIZE,
                              kv_quant=kv_quant, tier_staging_pages=2)
    want = 2 * kv_page_bytes(spec, tp, DEFAULT_PAGE_SIZE, kv_quant=kv_quant)
    if staged.tier_staging_bytes != want:
        findings.append(ShardFinding(
            "KV-TIER", config,
            f"tier staging priced {staged.tier_staging_bytes} B != {want} "
            f"B (2 pages at the pool byte rate)"))
    if expect_fits and report.fits and not staged.fits:
        findings.append(ShardFinding(
            "KV-TIER", config,
            f"the 2-page tier staging "
            f"({staged.tier_staging_bytes / GIB:.3f} GiB) pushes this "
            f"fitting config over the card"))
    return findings


def check_mixed_budget(spec, tp: int, config: str, report,
                       kv_quant: str, expect_fits: bool,
                       budget: int = 16) -> list:
    """MIXED-HBM: the mixed window of ``budget`` tokens prices exactly as a
    verify window of as many (one t_len formula, two knobs), and a
    fitting config still fits with it."""
    from .memory_model import DEFAULT_PAGE_SIZE

    findings = []
    mixed = device_footprint(spec, tp, report.scheme, model=report.model,
                             kv_page_size=DEFAULT_PAGE_SIZE,
                             kv_quant=kv_quant, mixed_budget=budget)
    twin = device_footprint(spec, tp, report.scheme, model=report.model,
                            kv_page_size=DEFAULT_PAGE_SIZE,
                            kv_quant=kv_quant, spec_k=budget)
    if mixed.total_bytes != twin.total_bytes:
        findings.append(ShardFinding(
            "MIXED-HBM", config,
            f"mixed_budget={budget} prices {mixed.total_bytes} B but "
            f"spec_k={budget} prices {twin.total_bytes} B"))
    if expect_fits and report.fits and not mixed.fits:
        findings.append(ShardFinding(
            "MIXED-HBM", config,
            f"the {budget}-token mixed window "
            f"({mixed.total_bytes / GIB:.3f} GiB) pushes this fitting "
            f"config over the card"))
    return findings


# -- per-config run ----------------------------------------------------------


def check_config(entry: MatrixEntry, spec=None, specs=None,
                 dequant: list | None = None) -> ConfigResult:
    """Every check of one matrix entry. ``spec`` overrides the model
    lookup, ``specs`` the param bands (mutation self-tests); ``dequant``
    is the package's J005 findings (computed once a run)."""
    from .memory_model import DEFAULT_PAGE_SIZE

    spec = spec if spec is not None else model_spec(entry.model, entry.wtype)
    config = entry.label
    kv_quant = entry.kv_quant
    if kv_quant not in ("f32", "q8"):
        return ConfigResult(config, entry.expect_fits, None, (ShardFinding(
            "KV-QUANT", config,
            f"unknown kv_quant {kv_quant!r} (expected f32|q8)"),),
            kv_quant=kv_quant)
    findings = check_uniform_shards(spec, entry.tp, entry.scheme, config)
    if not findings:
        findings += check_sharding(spec, entry.tp, entry.scheme, config,
                                   specs)
    findings += [dataclasses.replace(f, config=config)
                 for f in (dequant if dequant is not None
                           else check_dequant_sites())]
    if kv_quant == "q8":
        report = device_footprint(spec, entry.tp, entry.scheme,
                                  model=entry.model,
                                  kv_page_size=DEFAULT_PAGE_SIZE,
                                  kv_quant="q8")
        findings += check_kv_quant_pricing(spec, entry.tp, config)
    else:
        report = device_footprint(spec, entry.tp, entry.scheme,
                                  model=entry.model)
        findings += check_paged_equivalence(spec, entry.tp, config,
                                            report.kv_cache_bytes)
    if spec.seq_len % DEFAULT_PAGE_SIZE == 0:
        findings += check_tier_staging(spec, entry.tp, config, report,
                                       kv_quant, entry.expect_fits)
        findings += check_mixed_budget(spec, entry.tp, config, report,
                                       kv_quant, entry.expect_fits)
    if report.fits != entry.expect_fits:
        if entry.expect_fits:
            findings.append(ShardFinding(
                "HBM-BUDGET", config,
                f"declared to fit but total "
                f"{report.total_bytes / GIB:.2f} GiB exceeds the "
                f"{report.budget_bytes / GIB:.2f} GiB usable budget by "
                f"{-report.headroom_bytes / GIB:.2f} GiB"))
        else:
            findings.append(ShardFinding(
                "HBM-BUDGET", config,
                f"declared NOT to fit but total "
                f"{report.total_bytes / GIB:.2f} GiB now leaves "
                f"{report.headroom_bytes / GIB:.2f} GiB headroom: update "
                f"the support matrix"))
    return ConfigResult(config, entry.expect_fits, report, tuple(findings),
                        kv_quant=kv_quant)


def run_shardcheck(matrix=None) -> list[ConfigResult]:
    dequant = check_dequant_sites()
    return [check_config(e, dequant=dequant)
            for e in (matrix if matrix is not None else SUPPORT_MATRIX)]


def load_matrix(path) -> tuple[MatrixEntry, ...]:
    """A JSON support-matrix override: a list of {model, tp, scheme, wtype,
    expect_fits[, kv_quant]} objects."""
    raw = json.loads(Path(path).read_text(encoding="utf-8"))
    return tuple(MatrixEntry(e["model"], int(e["tp"]), e["scheme"],
                             e["wtype"], bool(e["expect_fits"]),
                             kv_quant=e.get("kv_quant", "f32"))
                 for e in raw)


def report_json(results: list[ConfigResult]) -> dict:
    """The machine-readable report (the port's tools/shardcheck.py emits
    it; PERF.md's footprint table is generated from it)."""
    from .memory_model import CARD_MEMORY_BYTES, MEMORY_HEADROOM_FRACTION

    return {
        "device": "NVIDIA H100 80GB HBM3",
        "capacity_bytes": CARD_MEMORY_BYTES,
        "headroom_fraction": MEMORY_HEADROOM_FRACTION,
        "n_configs": len(results),
        "n_violations": sum(not r.ok for r in results),
        "configs": [{
            "config": r.config,
            "kv_quant": r.kv_quant,
            "expect_fits": r.expect_fits,
            "ok": r.ok,
            "findings": [{"rule": f.rule, "detail": f.detail}
                         for f in r.findings],
            "report": r.report.as_json() if r.report else None,
        } for r in results],
    }
