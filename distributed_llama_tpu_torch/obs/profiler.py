"""torch.profiler captures: a traced block for one-shot runs, and timed
captures for a server, with the JAX package's obs/profiler.py API.

* ``trace(dir)`` wraps a block of work (``inference --profile DIR``, or
  ``DLLAMA_PROFILE_DIR`` without the flag: ``env_profile_dir``) in
  ``torch.profiler.profile`` over the host's ops and, on the card, its
  kernels, and on exit writes ``<host>.<pid>.pt.trace.json`` into ``dir``,
  the Chrome trace that utils/it_split.py reads.
* ``start_capture(dir, secs)`` traces for ``secs`` seconds while the
  caller goes on working, as a ``POST /profile`` would.

A profiler started on one thread cannot be stopped from another: a stop
from a second thread finds "no active profiling session" and writes
nothing. So ``start_capture`` starts, sleeps and stops on ONE daemon
thread; it cannot start in the caller and stop on a timer, as the JAX
package does. A profile started off the main thread records no host op of
the main thread ("External init callback must run in same thread as
registerClient"): such a capture holds the card's kernels at most.

On the card, ``trace`` opens the window TRACE_LEAD_S before its block's
first launch and closes it TRACE_LEAD_S after the block's last kernel
ends. In a session the profiler can place every kernel a constant few
milliseconds earlier than the host events around it (measured on an H100
host with busy CPUs: −2.3, −2.7 and −4.1 ms, where a kernel normally
starts ~5 µs after its launch), and it drops a kernel that then seems to
start before the window opened: without the lead such sessions lost the
first 11 or 18 of a chain's kernels.

Only one capture can be active per process; a second one gets a clean
RuntimeError.
"""

from __future__ import annotations

import contextlib
import math
import os
import socket
import threading
import time

_lock = threading.Lock()
_active_dir: str | None = None
# seconds between the window's edges and the traced block's first launch
# and last kernel on the card (module docstring)
TRACE_LEAD_S = 0.05


def span(name: str):
    """While a profiler runs, a ``record_function`` span named ``name``:
    the forwards' phases (obs/spans.py's embed, attn, ffn, logits, which
    obs/xprof buckets a trace by) and the collectives' ``tp::`` spans
    (utils/it_split reads them as T). Without a profiler no span is made
    (one costs ~14 us), so a forward costs nothing more and a captured
    graph is the same."""
    import torch

    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def env_profile_dir() -> str | None:
    """DLLAMA_PROFILE_DIR, or None when unset/empty."""
    return os.environ.get("DLLAMA_PROFILE_DIR") or None


def capture_active() -> str | None:
    """The directory of the in-flight capture, or None."""
    with _lock:
        return _active_dir


def trace_file(trace_dir: str) -> str:
    """Where a capture of this process into ``trace_dir`` is written."""
    return os.path.join(trace_dir,
                        f"{socket.gethostname()}.{os.getpid()}.pt.trace.json")


def _claim(trace_dir: str) -> None:
    """Make ``trace_dir`` (raising OSError if it cannot be written) and
    mark it the active capture (RuntimeError if one is active)."""
    global _active_dir
    with _lock:
        if _active_dir is not None:
            raise RuntimeError(f"a profile capture into {_active_dir} is "
                               f"already running")
        os.makedirs(trace_dir, exist_ok=True)
        if not os.access(trace_dir, os.W_OK):
            raise PermissionError(f"profile directory {trace_dir!r} is not "
                                  f"writable")
        _active_dir = trace_dir


def _release() -> None:
    global _active_dir
    with _lock:
        _active_dir = None


def _profile(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


@contextlib.contextmanager
def trace(trace_dir: str, cuda: bool | None = None):
    """Profile the block; on exit write its Chrome trace to
    ``trace_file(trace_dir)``. ``cuda`` adds the card's kernels (default:
    whether torch sees a card): the card is synchronised, and TRACE_LEAD_S
    waited out, after the profiler starts and again before it stops, so
    every kernel the block launched is in the trace, also where the
    profiler shifts the card's timestamps (module docstring)."""
    import torch

    if cuda is None:
        cuda = torch.cuda.is_available()
    _claim(trace_dir)
    try:
        with _profile(cuda) as prof:
            if cuda:
                torch.cuda.synchronize()
                time.sleep(TRACE_LEAD_S)
            yield prof
            if cuda:
                torch.cuda.synchronize()
                time.sleep(TRACE_LEAD_S)
        prof.export_chrome_trace(trace_file(trace_dir))
    finally:
        _release()


def start_capture(trace_dir: str, seconds: float) -> None:
    """Trace into ``trace_dir`` for ``seconds`` on a daemon thread, which
    starts the profiler, sleeps and stops it (module docstring), and
    return once the profiler runs. Raises RuntimeError if a capture is
    already running, ValueError on a non-positive or non-finite duration
    (json.loads accepts NaN/Infinity; either would kill the thread's sleep
    and wedge the capture open forever), OSError when the directory cannot
    be written — before anything starts."""
    if not seconds or not math.isfinite(seconds) or seconds <= 0:
        raise ValueError(f"profile duration must be positive and finite, "
                         f"got {seconds}")
    _claim(trace_dir)
    started = threading.Event()
    failed: list[BaseException] = []

    def run():
        try:
            import torch

            with _profile(torch.cuda.is_available()) as prof:
                started.set()
                time.sleep(seconds)
            prof.export_chrome_trace(trace_file(trace_dir))
        except Exception as e:  # a failed capture must not kill the caller
            failed.append(e)
        finally:
            started.set()
            _release()

    threading.Thread(target=run, daemon=True,
                     name="dllama-profile-capture").start()
    started.wait()
    if failed:
        raise RuntimeError(f"profile capture failed: {failed[0]!r}")


def wait_capture(timeout: float = 30.0) -> bool:
    """Block until no capture is active (True) or ``timeout`` expires
    (False). Test/shutdown convenience."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if capture_active() is None:
            return True
        time.sleep(0.02)
    return capture_active() is None
