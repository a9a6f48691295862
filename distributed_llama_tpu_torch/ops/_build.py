"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into ``build/kernels/<name>-<hash>.so`` at the repository root, keyed by a
hash of the sources and flags, and loaded with ctypes: a plain C interface,
``c_void_p`` for every pointer and for the stream. Nothing here falls back:
a missing ``nvcc`` or a failed build raises.

This is the counterpart of what ``utils/native.py`` does for the JAX
package's host library, but the port's kernels have no host-only fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

ALL: list["CudaKernel"] = []  # every kernel, in the order it was defined
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the port's CUDA kernels cannot "
                       "be built")


class CudaKernel:
    """One hand-written kernel: its source, its ctypes entry point (built on
    first use) and ``launches``, a plain count of successful launches.

    The C entry point launches on the given stream and returns the
    ``cudaGetLastError()`` code; ``launch`` raises on any non-zero code. A
    call made while a CUDA graph is being captured counts too, though the
    kernel runs only when the graph is replayed: runtime/decode.py moves
    such counts to the replays. Every kernel is listed in ``ALL``.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._lib = None
        ALL.append(self)

    def library_path(self) -> Path:
        h = hashlib.sha256()
        h.update((CSRC / self.source).read_bytes())
        for hdr in sorted(CSRC.glob("*.cuh")):
            h.update(hdr.name.encode())
            h.update(hdr.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{Path(self.source).stem}-{h.hexdigest()[:16]}.so"

    def _start_build(self) -> tuple[subprocess.Popen, Path, Path] | None:
        """Start nvcc for this kernel unless its library is built already.
        Returns (process, temp output, final path) or None."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    def _bind(self):
        lib = ctypes.CDLL(str(self.library_path()))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.kernel_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._lib, self._fn = lib, fn

    def launch(self, *args) -> None:
        """Call the C entry point; raise if the launch reported an error."""
        if self._fn is None:
            build([self])
        rc = self._fn(*args)
        if rc != 0:
            msg = self._lib.kernel_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA launch failed with "
                               f"error {rc} ({msg})")
        self.launches += 1


def build(kernels: list[CudaKernel]) -> float:
    """Build every kernel not built yet — one nvcc per source (kernels that
    share a source share its library), all started together — and bind
    them. Returns the wall seconds spent. Raises with the compiler's output
    if any build fails."""
    t0 = time.perf_counter()
    by_source = {k.source: k for k in kernels}
    jobs = [(k, k._start_build()) for k in by_source.values()]
    failures = []
    for k, job in jobs:
        if job is None:
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{k.source}: nvcc exited {proc.returncode}\n"
                            f"{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    for k in kernels:
        if k._fn is None:
            k._bind()
    return time.perf_counter() - t0
