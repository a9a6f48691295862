"""The device half of the KV tiers: page copies between the pool and host
memory (runtime/paging.py keeps the books; this module moves the bytes).

The JAX package moves pages with ``np.asarray`` on a pool slice (demotion)
and a donated ``.at[:, pid].set`` jit (promotion). Here a page is the
``pool[:, pid]`` slice of every plane, in the page wire layout, so a copy
is one strided ``copy_`` a plane; no kernel is written for it.

On the card:

* the host tier is ONE pinned slab of ``host_pages`` rows, allocated when
  the engine is built (``cudaHostAlloc`` is slow and locks RAM: never page
  by page); a host payload is the plane views of its row, so a disk record
  or a wire frame of it needs no further copy;
* a demotion copies the page on the main stream (after the last dispatch
  that wrote it, before the page is handed out again) into its slab row,
  or into a pinned demotion buffer when it goes straight to disk, and
  waits on the copy's event before the host reads the bytes;
* a promotion copies host planes into the pool page IN PLACE on a
  dedicated copy stream (the page is pending, so no dispatch reads it
  meaningfully; the captured graphs' tensors are never rebound) and
  records an event; the job counts as landed once ``event.query()`` is
  true, and the main stream waits on the event before the next dispatch.
  A payload that views a slab row is copied at once (the row may be
  written by the next demotion, which first waits on that copy); a disk
  or shipped payload is first copied into a pinned staging buffer by the
  PageUploader thread, the host work, with no CUDA call off the
  scheduler thread;
* a page whose pending node is dropped while its copy is in flight makes
  the main stream wait on that copy before the page can be written again.

Every CUDA call runs on the scheduler thread: the engine captures its
graphs there in the global mode, which fails on another thread's CUDA
call. On the CPU the copies are synchronous and every job lands at the
next step boundary. A CUDA error raises; nothing degrades to the CPU.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .pagewire import plane_views


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A pool plane as the wire sees it: bf16 travels as its raw int16
    words (numpy has no bfloat16)."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def page_layout(cache) -> tuple:
    """((shape), dtype str) of one page's planes, ``pool[:, pid]`` of each
    pool plane in order: (k, v) or (kq, kd, vq, vd)."""
    out = []
    for plane in cache:
        w = _wire(plane)
        shape = (w.shape[0],) + tuple(w.shape[2:])
        out.append((shape, np.dtype(str(w.dtype).replace("torch.", ""))
                    .str))
    return tuple(out)


def _tensor(p: np.ndarray) -> torch.Tensor:
    """A host plane as a tensor (a read-only payload, as one loaded from
    disk or the wire, is copied first)."""
    return torch.from_numpy(p if p.flags.writeable else p.copy())


def layout_bytes(layout) -> int:
    return sum(int(np.prod(s)) * np.dtype(d).itemsize for s, d in layout)


class _JobIO:
    """A promotion job's device-side state."""

    __slots__ = ("staging", "event", "start")

    def __init__(self):
        self.staging = None  # index of the pinned staging buffer held
        self.event = None    # the copy's end event (card), or True (CPU)
        self.start = None    # the copy's start event (card, timing)


class PageIO:
    """Page copies of one engine's pool (one rank's band under tp).
    ``host_pages`` sizes the host slab (0: none), ``staging`` the pinned
    staging buffers the uploader fills. ``lockstep`` (the ranks of a tp
    group) lands every launched copy at the next step boundary, waiting
    for it: when a paused slot resumes must not depend on one rank's copy
    timing, or the ranks' dispatches (and collectives) diverge."""

    def __init__(self, cache, device, host_pages: int = 0,
                 staging: int = 4, lockstep: bool = False):
        self.cache = tuple(cache)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.lockstep = lockstep
        self.layout = page_layout(self.cache)
        self.page_bytes = layout_bytes(self.layout)
        pin = self.cuda

        def host(rows):
            return torch.empty((rows, self.page_bytes), dtype=torch.uint8,
                               pin_memory=pin)

        self._slab_t = host(host_pages) if host_pages > 0 else None
        self.slab = (self._slab_t.numpy() if self._slab_t is not None
                     else None)
        self.stream = None
        self._stage_t = self._demote_t = None
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            self._stage_t = host(staging)
            self._demote_t = host(1)
        self._stage_np = (self._stage_t.numpy()
                          if self._stage_t is not None else None)
        self._stage_free = list(range(staging if self.cuda else 0))
        self._stage_cv = threading.Condition()
        self._closed = False
        self._row_events: dict[int, object] = {}
        self.inflight: list = []  # launched jobs not yet landed
        # what a promotion cost on the copy stream (card only): per-page
        # ms between its start and end events
        self.upload_ms: list[float] = []
        self.demote_s = 0.0   # host seconds spent in demotion reads
        self.demotions = 0

    @property
    def pinned_bytes(self) -> int:
        """Bytes of pinned host memory this engine holds (0 on the CPU)."""
        if not self.cuda:
            return 0
        return sum(int(t.numel()) for t in
                   (self._slab_t, self._stage_t, self._demote_t)
                   if t is not None)

    # -- demotion (scheduler thread) ------------------------------------------

    def _read(self, pid: int, dst: tuple) -> tuple:
        t0 = time.perf_counter()
        with torch.no_grad():
            for plane, d in zip(self.cache, dst):
                torch.from_numpy(d).copy_(_wire(plane)[:, pid],
                                          non_blocking=self.cuda)
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            # dlint: allow[D001] the demoted bytes go to the host
            ev.synchronize()  # the bytes are the host's from here on
        self.demote_s += time.perf_counter() - t0
        self.demotions += 1
        return dst

    def fetch(self, pid: int) -> tuple:
        """Pool page ``pid``'s planes on the host. On the card they view a
        pinned buffer the next fetch overwrites: the caller (the disk
        store) packs them at once."""
        if not self.cuda:
            return tuple(_wire(p)[:, pid].numpy().copy() for p in self.cache)
        return self._read(pid, plane_views(self._demote_t.numpy()[0],
                                           self.layout))

    def fetch_into(self, pid: int, hid: int) -> tuple:
        """Pool page ``pid`` into host-slab row ``hid`` (after any copy
        still reading the row lands); returns the row's views."""
        ev = self._row_events.pop(hid, None)
        if ev is not None:
            # dlint: allow[D001] the row's last copy lands first
            ev.synchronize()
        return self._read(pid, plane_views(self.slab[hid], self.layout))

    # -- promotion -----------------------------------------------------------

    def stage_inline(self, job):
        """The allocator's inline stage (scheduler thread): a payload that
        views a slab row is copied into its pool page now (the row may be
        written by the next demotion); any other payload is uploaded from
        where it lies at the next step boundary."""
        job.io = _JobIO()
        if job.row >= 0:
            self.launch(job, job.payload)
        return job.payload

    def stage_host(self, job):
        """The uploader's host work (its own thread, no CUDA call): copy
        the payload into a pinned staging buffer (blocks while all are in
        flight). On the CPU there is nothing to do."""
        job.io = _JobIO()
        if not self.cuda:
            return job.payload
        with self._stage_cv:
            while not self._stage_free and not self._closed:
                self._stage_cv.wait(0.1)
            if self._closed:
                return job.payload
            idx = self._stage_free.pop()
        job.io.staging = idx
        dst = plane_views(self._stage_np[idx], self.layout)
        for d, s in zip(dst, job.payload):
            np.copyto(d, s)
        return dst

    def release(self, job) -> None:
        """Give a job's staging buffer back (idempotent)."""
        io = job.io
        if io is None:
            return
        with self._stage_cv:
            idx, io.staging = io.staging, None
            if idx is not None:
                self._stage_free.append(idx)
                self._stage_cv.notify()

    def launch(self, job, planes) -> None:
        """Copy ``planes`` into pool page ``job.page`` in place: on the copy
        stream after the work already queued on the main stream, with an
        event (card); synchronously (CPU)."""
        if job.io is None:
            job.io = _JobIO()
        if job.io.event is not None:
            return
        if not self.cuda:
            with torch.no_grad():
                for plane, p in zip(self.cache, planes):
                    _wire(plane)[:, job.page].copy_(_tensor(p))
            job.io.event = True
            return
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        with torch.cuda.stream(self.stream), torch.no_grad():
            start.record(self.stream)
            for plane, p in zip(self.cache, planes):
                _wire(plane)[:, job.page].copy_(_tensor(p),
                                                non_blocking=True)
            end.record(self.stream)
        job.io.start, job.io.event = start, end
        if job.row >= 0:
            self._row_events[job.row] = end

    def _landed(self, job) -> bool:
        ev = job.io.event
        if ev is True:
            return True
        if self.lockstep:
            # dlint: allow[D001] tp lockstep: ranks resume together
            ev.synchronize()
            return True
        return ev.query()

    def settle(self, alloc) -> list:
        """Step-boundary apply: launch every staged job, then report the
        ones whose copy landed (the main stream waits on each before the
        next dispatch). Returns the live jobs applied."""
        for job in alloc.take_staged_promotions():
            self.launch(job, job.staged)
            self.inflight.append(job)
        applied, rest = [], []
        for job in self.inflight:
            if not self._landed(job):
                rest.append(job)
                continue
            if self.cuda:
                torch.cuda.current_stream(self.device).wait_event(
                    job.io.event)
                self.upload_ms.append(job.io.start.elapsed_time(
                    job.io.event))
            self.release(job)
            if not job.cancelled:
                alloc.promotion_applied(job)
                applied.append(job)
        self.inflight = rest
        return applied

    def on_pending_drop(self, job) -> None:
        """A pending node was dropped: a copy still landing in its page
        must finish before the main stream writes the page again; a staged
        buffer nothing will read goes back."""
        io = job.io
        if io is None:
            return
        if io.event is None:
            self.release(job)
        elif io.event is not True:
            torch.cuda.current_stream(self.device).wait_event(io.event)

    def close(self) -> None:
        """Stop staging, wait for every launched copy (a copy still
        landing reads its pinned source, so the slab and the staging
        buffers must outlive it: an engine torn down mid-promotion), then
        drop this object's hold on the pinned buffers: ``pinned_bytes``
        reads 0, and the memory goes back to the host allocator once the
        engine's allocator, which views the slab, goes too."""
        with self._stage_cv:
            self._closed = True
            self._stage_cv.notify_all()
        for job in self.inflight:
            ev = job.io.event
            if ev is not None and ev is not True:
                # dlint: allow[D001] copies land before the slab goes
                ev.synchronize()
        self.inflight = []
        self._slab_t = self._stage_t = self._demote_t = None
        self.slab = self._stage_np = None
