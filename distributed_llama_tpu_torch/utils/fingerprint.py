"""Session fingerprint + run-config stamp, shared by logs and bundles.

``env_fingerprint`` pins the torch/CUDA versions, the card's name and the
clock source; ``run_stamp`` adds the active kernel-policy knobs (tp
scheme, Q40 body policy) and is stamped onto every ``--log-json`` NDJSON
record (obs/log.py) and every flight-recorder bundle, so traces and log
streams are JOINABLE: same fingerprint → same session basis, different →
visibly not comparable. The keys are the JAX package's, with torch's
versions where it records jax's.
"""

from __future__ import annotations

import os
import sys
import time

# env_fingerprint cache, keyed by whether CUDA was initialized at compute
# time: an early log event (weight streaming logs before the model reaches
# the card) must not freeze a device-less fingerprint for the whole process
_FP_CACHE: dict = {}


def _cuda_ready() -> bool:
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def env_fingerprint() -> dict:
    """torch/CUDA versions, backend + device kind, and the clock source.

    The device fields are read only once CUDA is initialized in this
    process: a log call never brings a CUDA context up by itself.
    """
    out: dict = {}
    clock = time.get_clock_info("perf_counter")
    out["clock"] = clock.implementation
    out["clock_resolution_s"] = clock.resolution
    torch = sys.modules.get("torch")
    if torch is None:
        return out
    out["torch"] = torch.__version__
    out["cuda"] = torch.version.cuda or ""
    if not _cuda_ready():
        out["backend"] = "cpu"
        return out
    try:
        out["backend"] = "gpu"
        out["device_kind"] = torch.cuda.get_device_name(
            torch.cuda.current_device())
        out["n_devices"] = torch.cuda.device_count()
    except Exception:  # noqa: BLE001 - a dead device must not kill a log line
        pass
    return out


def run_stamp() -> dict:
    """The joinability header: tp scheme + Q40 body policy + fingerprint.

    The knob fields are read FRESH per call (cheap env lookups): a
    ``--model-from-root`` run logs fetch-progress events before cli.py
    has exported ``--tp-scheme`` into the env, and a frozen early stamp
    would mislabel every later decode record. Only the fingerprint is
    cached, keyed by whether CUDA is up, for the same reason. Never
    raises — a malformed env var degrades the stamp, not the log line
    carrying it.
    """
    stamp: dict = {}
    try:
        from ..parallel.comm_stats import tp_scheme

        stamp["tp_scheme"] = tp_scheme()
    except Exception:  # noqa: BLE001
        stamp["tp_scheme"] = os.environ.get("DLLAMA_TP_SCHEME", "?")
    stamp["q40_body"] = os.environ.get("DLLAMA_Q40_BODY", "auto")
    key = _cuda_ready()
    if key not in _FP_CACHE:
        try:
            _FP_CACHE[key] = env_fingerprint()
        except Exception:  # noqa: BLE001
            _FP_CACHE[key] = {}
    stamp["env_fingerprint"] = _FP_CACHE[key]
    return stamp


def reset_stamp_cache() -> None:
    """Test hook: recompute the fingerprint after env changes."""
    _FP_CACHE.clear()
