"""Serving supervision: step watchdog, health state machine, crash-loop
backoff.

Three independent pieces the crash-safe server composes:

* ``StepWatchdog`` — a deadline on each device dispatch. The scheduler
  thread arms it just before launching a step and disarms it once the
  host outputs land; a monitor thread fires ``on_hang`` when a dispatch
  overruns its deadline (a wedged device runtime, a hung collective, a
  dead tunnel). Detection only: the watchdog cannot cancel device work —
  it marks the server DEGRADED and logs, and the ``--supervise`` wrapper
  (or the operator) decides whether to restart. A dispatch that
  eventually completes after tripping disarms normally and the health
  machine recovers to SERVING.
* ``HealthMonitor`` — the starting/serving/degraded/draining/stopped
  state machine, surfaced in ``/health`` as ``"state"`` and as the
  ``dllama_health_state`` gauge (numeric code; see ``HEALTH_CODES``).
  Transitions are validated: a server cannot leave ``stopped``, and
  ``draining`` only moves to ``stopped`` — anything else is a
  programming error and raises.
* ``CrashLoopBackoff`` + ``supervise()`` — the ``serve --supervise``
  wrapper: respawn the serve child when it dies non-zero, doubling the
  delay for RAPID crash loops (a child that served healthily for
  ``healthy_s`` resets the backoff), forwarding SIGTERM to the child so
  graceful drain (runtime/server.py) runs exactly once, and exiting
  with the child's code once it exits 0 or the restart budget is spent.
"""

from __future__ import annotations

import signal
import subprocess
import sys
import threading
import time

from ..obs.log import log_event

HEALTH_STATES = ("starting", "serving", "degraded", "draining", "stopped")
HEALTH_CODES = {s: i for i, s in enumerate(HEALTH_STATES)}
_TRANSITIONS = {
    "starting": {"serving", "draining", "stopped"},
    "serving": {"degraded", "draining", "stopped"},
    "degraded": {"serving", "draining", "stopped"},
    "draining": {"stopped"},
    "stopped": set(),
}


class HealthMonitor:
    """The serving health state machine (module docstring). Thread-safe:
    the scheduler, watchdog monitor, and signal paths all transition."""

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        self._state = "starting"
        self._gauge = None
        if registry is not None:
            self._gauge = registry.gauge(
                "dllama_health_state",
                "Serving health state machine: 0=starting 1=serving "
                "2=degraded 3=draining 4=stopped")
            self._gauge.set(HEALTH_CODES[self._state])

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def to(self, state: str) -> bool:
        """Transition; returns True if the state changed. Same-state is a
        no-op, an ILLEGAL transition raises — with two fault-path
        carve-outs (bookkeeping must never crash a fault handler):
        ``stopped`` is enterable from any live state, and ``degraded``
        from any state still ADMITTING (starting/serving). ``draining``
        stays one-way: a watchdog trip mid-drain must NOT reopen
        admission by bouncing through degraded -> serving."""
        if state not in HEALTH_CODES:
            raise ValueError(f"unknown health state {state!r}")
        with self._lock:
            if state == self._state:
                return False
            if (state not in _TRANSITIONS[self._state]
                    and not (state == "stopped"
                             and self._state != "stopped")
                    and not (state == "degraded"
                             and self._state in ("starting", "serving"))):
                raise ValueError(
                    f"illegal health transition {self._state} -> {state}")
            prev, self._state = self._state, state
            if self._gauge is not None:
                self._gauge.set(HEALTH_CODES[state])
        # stderr: health transitions fire from library threads inside
        # tools whose stdout is a machine-readable artifact (loadcheck
        # --json) — diagnostics must not pollute it
        log_event("health.state", f"🌐 health: {prev} -> {state}",
                  file=sys.stderr, prev=prev, state=state)
        return True


class StepWatchdog:
    """Per-dispatch deadline (module docstring).

    ``arm()`` before the device call, ``disarm()`` after the host
    outputs sync; the monitor thread fires ``on_hang(elapsed_s)`` ONCE
    per armed dispatch that overruns ``timeout_s``. ``trips`` counts
    firings. Use as a context manager around the dispatch::

        with watchdog:            # arm ... disarm, exception-safe
            out = step(...)
    """

    def __init__(self, timeout_s: float, on_hang=None):
        if timeout_s <= 0:
            raise ValueError(f"watchdog timeout must be > 0, "
                             f"got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.on_hang = on_hang
        self.trips = 0
        self._cond = threading.Condition()
        self._deadline: float | None = None
        self._armed_at = 0.0
        self._fired = False
        self._closed = False
        self._thread = threading.Thread(target=self._monitor, daemon=True,
                                        name="dllama-step-watchdog")
        self._thread.start()

    def arm(self) -> None:
        with self._cond:
            self._armed_at = time.monotonic()
            self._deadline = self._armed_at + self.timeout_s
            self._fired = False
            self._cond.notify()

    def disarm(self) -> None:
        with self._cond:
            self._deadline = None
            self._cond.notify()

    def __enter__(self):
        self.arm()
        return self

    def __exit__(self, *exc):
        self.disarm()
        return False

    @property
    def overdue(self) -> bool:
        """True while an armed dispatch has already overrun (the health
        recovery check: do not flip back to serving under a live hang)."""
        with self._cond:
            return (self._deadline is not None
                    and time.monotonic() >= self._deadline)

    def _monitor(self) -> None:
        while True:
            with self._cond:
                if self._closed:
                    return
                if self._deadline is None or self._fired:
                    self._cond.wait()
                    continue
                now = time.monotonic()
                if now < self._deadline:
                    self._cond.wait(self._deadline - now)
                    continue
                # overrun: fire once for this arm
                self._fired = True
                self.trips += 1
                elapsed = now - self._armed_at
            log_event("watchdog.trip",
                      f"🔶 watchdog: dispatch exceeded "
                      f"{self.timeout_s * 1e3:.0f} ms "
                      f"({elapsed * 1e3:.0f} ms and counting)",
                      file=sys.stderr, timeout_s=self.timeout_s,
                      elapsed_s=round(elapsed, 6))
            if self.on_hang is not None:
                try:
                    self.on_hang(elapsed)
                except Exception:  # noqa: BLE001 - a broken callback must
                    pass           # never kill the monitor thread

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._thread.join(timeout=5)


class CrashLoopBackoff:
    """Exponential restart delay for rapidly-crashing children.

    ``next_delay(uptime_s)`` is called after each non-zero child exit
    with how long that child lived: a child that survived at least
    ``healthy_s`` resets the delay to ``initial_s`` (the crash was news,
    not a loop); shorter lives double it up to ``max_s``."""

    def __init__(self, initial_s: float = 1.0, max_s: float = 60.0,
                 healthy_s: float = 30.0):
        self.initial_s = initial_s
        self.max_s = max_s
        self.healthy_s = healthy_s
        self._delay = 0.0

    def next_delay(self, uptime_s: float) -> float:
        if uptime_s >= self.healthy_s:
            self._delay = self.initial_s
        elif self._delay <= 0.0:
            self._delay = self.initial_s
        else:
            self._delay = min(self._delay * 2.0, self.max_s)
        return self._delay


def supervise(child_cmd: list[str], max_restarts: int | None = None,
              backoff: CrashLoopBackoff | None = None,
              sleep=time.sleep, popen=subprocess.Popen,
              install_signals: bool = True,
              flightrec_dir: str | None = None) -> int:
    """Run ``child_cmd`` under crash-loop supervision (``serve
    --supervise``). Restarts on non-zero exits with ``backoff`` delays;
    exits with the child's code on a clean 0 or once ``max_restarts``
    respawns are spent (None = unbounded). SIGTERM/SIGINT forward to the
    child — its graceful drain runs, it exits 0, and the supervisor
    exits 0 without respawning. With ``flightrec_dir`` set, every
    crash-loop respawn drops a flight-recorder bundle from
    the SUPERVISOR's vantage — exit code, uptime, restart count, the
    spawn history ring — next to whatever bundles the child's own
    recorder managed to write before dying."""
    backoff = backoff or CrashLoopBackoff()
    terminating = {"flag": False}
    child_box: dict = {"proc": None}
    recorder = None
    if flightrec_dir is not None:
        from ..obs.flightrec import FlightRecorder

        recorder = FlightRecorder()

    def _forward(signum, frame):
        terminating["flag"] = True
        proc = child_box["proc"]
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGTERM)

    if install_signals:
        signal.signal(signal.SIGTERM, _forward)
        signal.signal(signal.SIGINT, _forward)

    restarts = 0
    while True:
        t0 = time.monotonic()
        proc = popen(child_cmd)
        child_box["proc"] = proc
        log_event("supervisor.spawn",
                  f"🌐 supervisor: child pid {proc.pid} started",
                  file=sys.stderr, pid=proc.pid, restarts=restarts)
        if recorder is not None:
            recorder.note("supervisor.spawn", pid=proc.pid,
                          restarts=restarts)
        rc = proc.wait()
        uptime = time.monotonic() - t0
        if recorder is not None and rc != 0 and not terminating["flag"]:
            # the crash-loop postmortem bundle: written BEFORE the
            # respawn, so an operator paging in mid-loop finds the
            # history even while the loop is still spinning
            recorder.note("supervisor.crash", rc=rc,
                          uptime_s=round(uptime, 3), restarts=restarts)
            try:
                recorder.dump(flightrec_dir, "crash_loop")
            except OSError:
                pass  # a failed dump must never block the respawn
        if rc == 0 or terminating["flag"]:
            log_event("supervisor.exit",
                      f"🌐 supervisor: child exited {rc} "
                      f"({'terminated' if terminating['flag'] else 'clean'})",
                      file=sys.stderr, rc=rc,
                      uptime_s=round(uptime, 3))
            return rc
        if max_restarts is not None and restarts >= max_restarts:
            log_event("supervisor.give_up",
                      f"🔶 supervisor: child crashed (exit {rc}) and the "
                      f"restart budget ({max_restarts}) is spent",
                      file=sys.stderr, rc=rc, restarts=restarts)
            return rc
        delay = backoff.next_delay(uptime)
        restarts += 1
        log_event("supervisor.restart",
                  f"🔶 supervisor: child crashed (exit {rc}) after "
                  f"{uptime:.1f}s; restart {restarts} in {delay:.1f}s",
                  file=sys.stderr, rc=rc, uptime_s=round(uptime, 3),
                  delay_s=delay, restarts=restarts)
        sleep(delay)


def serve_child_cmd(serve_argv: list[str]) -> list[str]:
    """The re-exec command for ``serve --supervise``: this interpreter,
    this package, the same serve argv minus the supervision flags (the
    child must SERVE, not recurse into another supervisor)."""
    stripped: list[str] = []
    skip = False
    for arg in serve_argv:
        if skip:
            skip = False
            continue
        if arg == "--supervise":
            continue
        if arg in ("--max-restarts",):
            skip = True
            continue
        if arg.startswith("--max-restarts="):
            continue
        stripped.append(arg)
    return [sys.executable, "-m", "distributed_llama_tpu_torch", "serve",
            *stripped]
