"""Sampler, Engine and the generation loop."""
