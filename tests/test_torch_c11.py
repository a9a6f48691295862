"""C11: a streaming request and the server's shutdown paths, pinned with a
held scheduler instead of timing.

* ``_streams`` holds a streaming handler only once its stream has begun
  (a token taken off its queue: the engine ran the request); before
  that the handler is in ``_handlers``, which stop() joins. A stop()
  between the submit and the first dispatch wakes the handler with the
  stop error, journals the request and leaves no thread.
* Once drain() or stop() has closed admission, a request that passed the
  health check is refused with 503 instead of reaching an engine whose
  outstanding work was already counted (it would never be woken).
"""

import json
import threading
import time
import urllib.request

from test_torch_server import (_one_thread, _post, _server,  # noqa: F401
                               model)


def test_stream_is_open_only_once_the_engine_ran_it(model, tmp_path):
    from distributed_llama_tpu_torch.runtime.journal import (RequestJournal,
                                                             load_journal)

    jpath = str(tmp_path / "j.journal")
    before = set(threading.enumerate())
    srv = _server("port", model, steps=8, journal=RequestJournal(jpath),
                  page_size=4, kv_pages=24)
    hold = threading.Event()
    step_many = srv.engine.step_many

    def held(*args, **kwargs):
        # the scheduler waits until released, then meets the shutdown as
        # its loop's check would
        hold.wait()
        if srv._shutdown.is_set():
            return 0
        return step_many(*args, **kwargs)

    srv.engine.step_many = held
    srv.start()
    got: dict = {}

    def client():
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate",
            data=json.dumps({"prompt": "hello", "steps": 8,
                             "stream": True}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            got["lines"] = [json.loads(ln) for ln in r if ln.strip()]

    t = threading.Thread(target=client)
    t.start()
    deadline = time.time() + 30
    while time.time() < deadline and not srv._handlers:
        time.sleep(0.01)
    assert srv._handlers, "the request never reached the engine"
    time.sleep(0.2)
    assert not srv._streams  # nothing has run: the stream has not begun
    stopper = threading.Thread(target=srv.stop)
    stopper.start()
    while not srv._shutdown.is_set():
        time.sleep(0.01)
    hold.set()  # the scheduler sees the shutdown and never dispatches
    stopper.join(timeout=60)
    t.join(timeout=30)
    assert not stopper.is_alive() and not t.is_alive()
    assert got["lines"][-1].get("error")
    leaked = [th for th in set(threading.enumerate()) - before
              if th.is_alive()]
    assert not leaked, leaked
    assert srv.health.state == "stopped"
    assert len([e for e in load_journal(jpath) if e.status is None]) == 1


def test_closed_admission_refuses_instead_of_submitting(model):
    srv = _server("port", model, steps=8)
    submitted = []
    srv.engine.submit = submitted.append
    srv.start()
    try:
        srv._close_admission()  # drain()/stop() between the check and submit
        for stream in (False, True):
            status, body = _post(srv.port, {"prompt": "hi", "steps": 4,
                                            "stream": stream})
            assert status == 503 and "draining" in body["error"]
        assert submitted == [] and not srv._handlers
    finally:
        srv.stop()
