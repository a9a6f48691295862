"""Generation checkpoint/resume: the port's copy of the JAX package's
runtime/checkpoint.py, in the same file format.

The complete decode state is (KV-cache prefix, next token, position,
sampler RNG state), and all of it is exact — the xorshift64* stream is a
single uint64, the cache is plain f32 or bf16 — so a resumed run continues
bit-identically to the run that was interrupted (tests/
test_torch_checkpoint.py holds split == unsplit token streams).

Format: one .npz, version 1, with the 28-byte spec header for
compatibility checking; the live cache prefix [0, pos) is stored as f32
(lossless for both cache types) beside the cache type as numpy names it
('float32', 'bfloat16'). A checkpoint of either package resumes in the
other.

Under tensor parallelism the file is the same: the cache's kv heads in
global order. Saving gathers the ranks' kv-head bands (cache axis 2, a
contiguous band a rank) through parallel/collectives.py, so every rank
must call it, and only rank 0 writes; loading gives each rank its own
band. A checkpoint written at one tp resumes at any other, tp 1 included.
Under sequence parallelism the sp ranks' position chunks are gathered
first (cache axis 1), and loading gives each rank its chunk.

The restore writes into the engine's cache in place and never rebinds it:
the ``--fast`` loop's captured CUDA graph and the fused layer's static
buffers hold that storage, and a new tensor would leave them reading stale
memory.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import collectives
from .generate import Engine
from .sampling import Sampler

FORMAT_VERSION = 1
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _dtype_name(engine: Engine) -> str:
    return _DTYPE_NAMES[engine.cache.k.dtype]


def save_generation_state(path: str, engine: Engine, sampler: Sampler,
                          pos: int, token: int,
                          tokens_out: list[int],
                          prompt_rest: list[int] | None = None) -> None:
    """Snapshot a generation: resume later with load + generate(resume=...).

    ``pos``/``token``: the next inference step's inputs (GenStats.final_pos /
    final_token from the interrupted run). ``tokens_out``: tokens emitted so
    far (stored so the caller can reconstruct the full stream).
    ``prompt_rest``: prompt tokens the interrupted run had NOT yet consumed
    (GenStats.prompt_rest) — without them a resumed run would sample where
    the unsplit run forces, silently diverging.

    Under a tp group every rank calls this (the kv-head bands are
    gathered) and rank 0 writes the file.
    """
    group = engine.group

    def prefix(t: torch.Tensor) -> np.ndarray:
        if group.sp_size > 1:  # the position chunks, in sp order
            t = collectives.gather_sp(t, group, dim=1)
        live = t[:, :pos].to(torch.float32)
        if group.size > 1:
            live = collectives.gather(live, group, dim=2)
        # dlint: allow[D001] a checkpoint holds host arrays
        return live.cpu().numpy()

    k, v = prefix(engine.cache.k), prefix(engine.cache.v)
    if group.world_rank != 0:
        return
    # write through a file object: np.savez(str_path) would silently append
    # '.npz', landing the file somewhere other than the path we report
    with open(path, "wb") as f:
        np.savez(
            f,
            version=np.int32(FORMAT_VERSION),
            header=np.frombuffer(engine.spec.header(), dtype=np.uint8),
            k=k,
            v=v,
            cache_dtype=np.array(_dtype_name(engine)),
            pos=np.int32(pos),
            token=np.int32(token),
            rng_state=np.uint64(sampler.rng.state),
            tokens_out=np.asarray(tokens_out, dtype=np.int32),
            prompt_rest=np.asarray(prompt_rest or [], dtype=np.int32),
        )


def load_generation_state(
        path: str, engine: Engine,
        sampler: Sampler) -> tuple[int, int, list[int], list[int]]:
    """Restore a snapshot into ``engine``/``sampler``.

    Returns (pos, token, tokens_out, prompt_rest) — pass (pos, token) to
    generate(resume=...) and prompt_rest to its ``resume_prompt``. Raises
    ValueError on format/spec mismatch.
    """
    z = np.load(path)
    version = int(z["version"])
    if version != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {version}, expected "
                         f"{FORMAT_VERSION}")
    if z["header"].tobytes() != engine.spec.header():
        raise ValueError("checkpoint spec header does not match the loaded "
                         "model")
    saved_dtype = str(z["cache_dtype"]) if "cache_dtype" in z else "float32"
    want = _dtype_name(engine)
    if saved_dtype != want:
        # restoring into a different cache precision would silently break
        # the bit-identical-resume contract (module docstring)
        raise ValueError(
            f"checkpoint cache dtype {saved_dtype!r} does not match the "
            f"engine's {want!r} — resume with the same --kv-cache-dtype")
    n_kv = engine.cache.k.shape[2]  # the rank's kv heads
    heads = slice(engine.group.rank * n_kv, (engine.group.rank + 1) * n_kv)
    chunk = engine.cache.k.shape[1]  # the rank's positions (sp chunk)
    first = engine.group.sp_rank * chunk
    for dst, src in ((engine.cache.k, z["k"]), (engine.cache.v, z["v"])):
        dst.zero_()  # the dead suffix, as a fresh cache has it
        live = src[:, first:first + chunk, heads]
        dst[:, :live.shape[1]].copy_(torch.from_numpy(
            np.ascontiguousarray(live)))
    sampler.rng.state = int(z["rng_state"])
    rest = (z["prompt_rest"].astype(int).tolist()
            if "prompt_rest" in z else [])
    return (int(z["pos"]), int(z["token"]),
            z["tokens_out"].astype(int).tolist(), rest)
