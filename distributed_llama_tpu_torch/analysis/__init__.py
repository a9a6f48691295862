"""Static analysis of the port: AST lint, contracts, shardcheck,
threadcheck and wirecheck (the JAX package's analysis/, each head checking
the port's own tree, registries, device layout and card).

One gate, ``python -m distributed_llama_tpu_torch.analysis`` (aliases in
``tools/dlint.py``, ``tools/shardcheck.py``, ``tools/threadcheck.py``):

* ``rules.py``: AST hazard rules D001-D008 over the package source
  (device->host syncs in the hot path, CUDA-graph capture traps, per-step
  uploads, unsynced timing, collectives outside parallel/collectives.py,
  implicit dtype promotion); imports nothing it checks;
* ``contracts.py``: J001-J003 on a small model on the CPU or the card
  (the tp census against comm_stats' budget, KV planes written in place,
  the captured step's static buffers stable);
* ``shardcheck.py`` + ``memory_model.py``: every config of the support
  matrix priced on one H100 80 GB (J004 bands, J005 dequant sites, J006
  uniform bands, the budget verdicts);
* ``threadcheck.py`` + ``threadmodel.py``: T001-T005 over runtime/ and
  obs/;
* ``wirecheck.py`` + ``wiremodel.py``: W000-W005 over runtime/, obs/,
  tools/ and io/.

The baselines live beside them (``dlint_baseline.txt``,
``threadcheck_baseline.txt``, ``wirecheck_baseline.txt``).
"""

from .lint import (Finding, apply_baseline, lint_paths,  # noqa: F401
                   load_baseline, package_files, write_baseline)
from .rules import RULES  # noqa: F401
