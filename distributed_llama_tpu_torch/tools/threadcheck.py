"""Alias of ``python -m distributed_llama_tpu_torch.analysis
--threadcheck``: the thread-ownership lint over runtime/ + obs/ (T-rules
against analysis/threadmodel.py). Extra argv is passed through
(``--no-baseline``, ``--write-threadcheck-baseline``)."""

import sys

from ..analysis.__main__ import main

if __name__ == "__main__":
    sys.exit(main(["--threadcheck", *sys.argv[1:]]))
