"""Observability: torch.profiler captures (profiler)."""
