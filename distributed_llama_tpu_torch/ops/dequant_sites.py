"""Registry of the port functions allowed to turn Q40 codes into f32 or
bf16 weights (the JAX package's ops/dequant_sites.py).

A Q40 weight lives on the card as codes + f16 scales (18 bytes a 32-value
block); its f32 form costs 7x the bytes and is what the hand kernels
exist to avoid: they widen each block in registers. Exactly a handful of
functions may materialize it, all of them plain versions or the CPU path:

* ``ops/q40.q40_matmul_plain`` / ``q40_matmul_bf16_plain``: the plain
  versions of K1/K1m/K3 and K3b/K1d, which CPU tensors take and the card's
  tests hold the kernels against;
* ``ops/q40.q40_matmul_tf32_model``: the CPU model of K3's 3xTF32
  rounding (tests);
* ``io/loader.densify_params``: the training tree, dense f32 by design
  (training runs no hand kernel: the JAX package runs no Pallas kernel
  there).

``analysis/shardcheck.py`` enforces it as contract J005: an AST pass over
the package finds every call of a dequantizing function
(``DEQUANT_FUNCTIONS``) and requires its enclosing function to be listed
here; anything else is a rogue dequant, the static form of "no fallback to
the plain version on the card". ``tests/test_torch_analysis_shardcheck.py``
pins every entry to a real function so the registry cannot rot.
"""

from __future__ import annotations

# the functions that widen Q40 codes into f32 weights: (file suffix, name)
DEQUANT_FUNCTIONS: tuple[tuple[str, str], ...] = (
    ("ops/quants.py", "dequantize_q40"),
    ("ops/quants.py", "dequantize_q40_torch"),
)

# (repo-relative file suffix, enclosing function name) of every call site
# allowed to call one of them
ALLOWED_DEQUANT_SITES: tuple[tuple[str, str], ...] = (
    ("ops/q40.py", "q40_matmul_plain"),
    ("ops/q40.py", "q40_matmul_bf16_plain"),
    ("ops/q40.py", "q40_matmul_tf32_model"),
    ("io/loader.py", "densify_params"),
)


def site_allowed(file_name: str, function_name: str) -> bool:
    """Is a call from ``function_name`` in ``file_name`` a registered
    dequant site?"""
    path = file_name.replace("\\", "/")
    return any(function_name == fn and path.endswith(suffix)
               for suffix, fn in ALLOWED_DEQUANT_SITES)


def dequant_names() -> frozenset:
    return frozenset(name for _, name in DEQUANT_FUNCTIONS)
