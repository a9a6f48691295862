"""Alias of ``python -m distributed_llama_tpu_torch.analysis`` (see its
--help): ``python -m distributed_llama_tpu_torch.tools.dlint --all``."""

import sys

from ..analysis.__main__ import main

if __name__ == "__main__":
    sys.exit(main())
