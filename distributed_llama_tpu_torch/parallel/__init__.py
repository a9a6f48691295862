"""Tensor parallelism over torch.distributed (the JAX package's parallel/):
the rank group (mesh), the collectives and their census (collectives),
the analytic budget (comm_stats) and the banded forward (tp)."""
