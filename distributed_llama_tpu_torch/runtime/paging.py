"""Paged KV allocation, radix prefix sharing and the KV tiers: the host
half of paged KV (the JAX package's runtime/paging.py, its own copy here).

A fixed pool of fixed-size pages (vLLM's PagedAttention unit) plus a
prefix tree over full pages (SGLang's RadixAttention), so requests that
share a system prompt map the SAME physical prefill pages instead of
recomputing them. Everything here is host-side bookkeeping over small
Python ints and numpy payloads; the device sees only the page-table rows
(int32 physical page ids per slot) that models/llama.forward_batch_paged
walks, the pool planes they index, and the page copies the engine's
device half (runtime/kv_io.py) makes when this module asks for them.

Invariants (tests/test_torch_paging.py and tests/test_torch_tiering.py
hold them against the JAX package's allocator):

* a page's refcount = (# slots mapping it) + (1 if the tree holds it in
  HBM); it returns to the free list exactly when that count reaches zero;
* page id 0 is RESERVED as the scrap page (free and paused slot rows
  write their dead k/v there); the pool never hands it out;
* the tree only shares FULL pages (``page_size`` tokens each): a partly
  filled tail page is private to its request, so decode writes never land
  in a shared page;
* eviction frees least-recently-used tree LEAVES whose pages no live slot
  maps; interior nodes become evictable once their children are gone.

The KV tiers: with ``host_pages`` or ``disk_dir`` the pool is the top of
a three-tier hierarchy, HBM pages, a host-RAM pool (``HostPagePool``,
payloads in the page wire layout, on the card views into one pinned slab)
and append-only disk segments (``DiskPageStore``, records CRC32'd by
read-back into io/stream's ``.slices`` sidecar), and eviction becomes
write-behind DEMOTION: LRU pressure moves a cold page's bytes down a tier
instead of dropping it. A radix hit on a spilled prefix starts a
PROMOTION: the payload is read (disk CRC-verified), an HBM page is
allocated, and the upload is queued; the engine PAUSEs the request until
the upload lands at a step boundary. A payload is owned by EXACTLY one
tier; a CRC-damaged disk page is dropped with its now-unreachable subtree
and re-derives through prefill on the next miss. The decode pool of a
disaggregated pair adopts shipped pages (``adopt_remote_pages``) through
the same promotion-pending machinery.

Device I/O is bound by the engine (``bind_device_io``): ``fetch(pid)``
reads a pool page to host planes, ``fetch_into(pid, hid)`` into host-slab
row ``hid``, and ``stage(job)`` starts a promotion's host-to-device path
(None leaves the raw payload for the engine to apply). ``PageUploader``
runs ``stage`` off the scheduler thread for jobs that need host work; it
never makes a CUDA call.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .pagewire import pack_planes as _pack_planes
from .pagewire import plane_views
from .pagewire import unpack_planes as _unpack_planes

SCRAP_PAGE = 0  # physical page 0: dead-write target for parked slots

TIER_HBM = "hbm"    # payload lives in the device page pool (node.page)
TIER_HOST = "host"  # payload lives in the host pool (node.host_id)
TIER_DISK = "disk"  # payload lives in a disk segment (node.disk_ref)


class PagePool:
    """Free-list + refcount accounting over physical page ids 1..n_pages.

    ``alloc`` hands out the lowest free id (deterministic schedules make
    the paged == contiguous parity tests reproducible); ``retain`` /
    ``release`` move the per-page refcount, and a page re-enters the free
    list exactly at refcount zero.
    """

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"page pool needs >= 1 page, got {n_pages}")
        self.n_pages = n_pages
        self._free = list(range(n_pages, 0, -1))  # pop() = lowest id
        self._ref: dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self) -> int | None:
        """One page at refcount 1, or None when the pool is dry."""
        if not self._free:
            return None
        pid = self._free.pop()
        self._ref[pid] = 1
        return pid

    def retain(self, pid: int) -> None:
        if pid not in self._ref:
            raise ValueError(f"retain of unallocated page {pid}")
        self._ref[pid] += 1

    def release(self, pid: int) -> None:
        n = self._ref.get(pid)
        if n is None:
            raise ValueError(f"release of unallocated page {pid}")
        if n == 1:
            del self._ref[pid]
            self._free.append(pid)
            # keep the lowest-first order: sort only when it broke
            if len(self._free) > 1 and self._free[-1] > self._free[-2]:
                self._free.sort(reverse=True)
        else:
            self._ref[pid] = n - 1

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)

    def refcounts(self) -> dict[int, int]:
        """A copy of the live refcount table (the audit's view)."""
        return dict(self._ref)

    def free_ids(self) -> list[int]:
        """A copy of the free list."""
        return list(self._free)


class HostPagePool:
    """The middle tier: up to ``n_pages`` page payloads in host RAM, with
    the device pool's free-list/ownership invariants: ids hand out
    lowest-first, every live id is owned by exactly one tree node, and
    free + live always covers the capacity (the tier audit pins it).
    Payloads are numpy plane tuples in the page wire layout (f32/bf16
    planes, or Q8 codes and deltas), so demote->promote round trips are
    byte-identical by construction.

    With ``slab`` (a (n_pages, page_bytes) uint8 array, on the card a view
    of one pinned host allocation made when the engine is built) and
    ``layout`` (the planes' ((shape), dtype str) metas) row ``hid`` holds
    its payload: ``views(hid)`` are the planes a demotion copies into, and
    a stored payload IS those views, so a disk record or a wire frame of
    it needs no further copy."""

    def __init__(self, n_pages: int, slab=None, layout=None):
        if n_pages < 1:
            raise ValueError(f"host page pool needs >= 1 page, "
                             f"got {n_pages}")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))  # pop() = lowest id
        self._store: dict[int, tuple] = {}
        self._reserved: set[int] = set()
        self.slab = slab
        self.layout = layout

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return len(self._store)

    def views(self, hid: int):
        """The plane views of slab row ``hid`` (None without a slab)."""
        if self.slab is None:
            return None
        return plane_views(self.slab[hid], self.layout)

    def reserve(self) -> int | None:
        """Take the lowest free id for a payload about to be written into
        it (``put`` completes the store); None when the pool is full."""
        if not self._free:
            return None
        hid = self._free.pop()
        self._reserved.add(hid)
        return hid

    def put(self, hid: int, payload) -> None:
        """Complete a reserved store. With a slab the payload lives in its
        row: one read straight into the row's views is kept as it is, any
        other payload is copied in."""
        dst = self.views(hid)
        if dst is not None and not np.shares_memory(dst[0], payload[0]):
            for d, s in zip(dst, payload):
                np.copyto(d, s)
            payload = dst
        self._reserved.discard(hid)
        self._store[hid] = payload

    def store(self, payload) -> int | None:
        """Adopt one payload; returns its host id, or None when the pool
        is full (the caller spills its LRU entry to disk, or drops)."""
        hid = self.reserve()
        if hid is not None:
            self.put(hid, payload)
        return hid

    def load(self, hid: int):
        """The payload at ``hid`` (still owned by the pool)."""
        return self._store[hid]

    def live(self, hid: int) -> bool:
        return hid in self._store

    def free(self, hid: int):
        """Release ``hid`` and return its payload (a promotion takes the
        bytes with it: exactly-one-tier ownership). A slab row's payload
        is its views: the caller copies them out before the row is
        written again (the engine's row guard)."""
        payload = self._store.pop(hid)
        self._free.append(hid)
        if len(self._free) > 1 and self._free[-1] > self._free[-2]:
            self._free.sort(reverse=True)  # keep lowest-first handout
        return payload

    def live_ids(self) -> list[int]:
        return sorted(self._store)

    def audit(self) -> list[str]:
        problems = []
        if len(set(self._free)) != len(self._free):
            problems.append("host pool free list has duplicate ids")
        for hid in self._free:
            if hid in self._store:
                problems.append(f"host page {hid} is both free and live")
        if self._reserved:
            problems.append(f"host pages {sorted(self._reserved)} reserved "
                            f"but never stored")
        if len(self._free) + len(self._store) != self.n_pages:
            problems.append(
                f"host pool accounting: {len(self._free)} free + "
                f"{len(self._store)} live != {self.n_pages} pages")
        return problems


class DiskPageStore:
    """The bottom tier: page payloads appended to segment files, each
    record CRC32'd by READ-BACK into the segment's ``.slices`` sidecar
    (io/stream.append_record_verified, the weight cache's machinery) and
    verified again on every load. A record that fails its CRC loads as
    None: the caller drops the page and prefill re-derives it. The
    segment files and sidecars are the JAX package's, byte for byte.
    ``budget_bytes`` caps LIVE bytes (0 = uncapped); fully dead segments
    are unlinked, which bounds append-only growth."""

    SEGMENT_BYTES = 8 << 20

    def __init__(self, directory: str, budget_bytes: int = 0):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.budget_bytes = int(budget_bytes)
        self._seg_path: str | None = None
        self._seg_n = 0
        self._seg_bytes = 0
        self._seg_live: dict[str, int] = {}   # path -> live record count
        self._seg_entries: dict[str, list] = {}  # path -> sidecar ranges
        self._live: dict[tuple, int] = {}     # (path, off) -> length
        self.live_bytes = 0
        self.stores = 0
        self.loads = 0
        self.crc_failures = 0
        # the disk tier is a CACHE: a previous process's segments are
        # orphans (their index lived in that process's radix tree), so
        # they are reclaimed here, or every restart would stack a dead
        # budget's worth of segment files next to the live one
        for name in sorted(os.listdir(directory)):
            if name.startswith("kvpages-"):
                try:
                    os.unlink(os.path.join(directory, name))
                except OSError:
                    pass

    @property
    def n_live(self) -> int:
        return len(self._live)

    def has_room(self, nbytes: int) -> bool:
        return (not self.budget_bytes
                or self.live_bytes + nbytes <= self.budget_bytes)

    def _flush_sidecar(self, path: str) -> None:
        """Write the segment's accumulated record ranges to its sidecar
        (every record was read-back CRC'd at append time; this persists
        the entries for verified_ranges and the audit)."""
        from ..io.stream import write_record_sidecar

        entries = self._seg_entries.get(path)
        if entries:
            write_record_sidecar(path, entries[-1][0] + entries[-1][1],
                                 entries)

    def _reclaim_if_dead(self, path: str) -> None:
        """Unlink a SEALED segment with zero live records."""
        if path == self._seg_path or self._seg_live.get(path, 1) != 0:
            return
        from ..io.stream import _sidecar_path

        self._seg_live.pop(path, None)
        self._seg_entries.pop(path, None)
        for victim in (path, _sidecar_path(path)):
            try:
                os.unlink(victim)
            except OSError:
                pass

    def _segment(self, nbytes: int) -> str:
        if (self._seg_path is None
                or self._seg_bytes + nbytes > self.SEGMENT_BYTES):
            sealed = self._seg_path
            self._seg_n += 1
            self._seg_path = os.path.join(
                self.dir, f"kvpages-{self._seg_n:05d}.seg")
            open(self._seg_path, "wb").close()
            self._seg_bytes = 0
            self._seg_live[self._seg_path] = 0
            self._seg_entries[self._seg_path] = []
            if sealed is not None:
                self._flush_sidecar(sealed)
                self._reclaim_if_dead(sealed)
        return self._seg_path

    def store(self, payload) -> tuple | None:
        """Append one payload; returns an opaque record ref, or None when
        the live-byte budget cannot take it."""
        from ..io.stream import append_record_verified

        blob, metas = _pack_planes(payload)
        if not self.has_room(len(blob)):
            return None
        path = self._segment(len(blob))
        off, length, crc = append_record_verified(
            path, blob, entries=self._seg_entries[path])
        self._seg_bytes += length
        self._seg_live[path] += 1
        self._live[(path, off)] = length
        self.live_bytes += length
        self.stores += 1
        return (path, off, length, crc, metas)

    def live(self, ref) -> bool:
        return ref is not None and (ref[0], ref[1]) in self._live

    def load(self, ref):
        """The payload at ``ref``, CRC-verified; None on any damage."""
        from ..io.stream import read_record_verified

        path, off, length, crc, metas = ref
        blob = read_record_verified(path, off, length, crc)
        if blob is None:
            self.crc_failures += 1
            return None
        self.loads += 1
        return _unpack_planes(blob, metas)

    def free(self, ref) -> None:
        path, off, length = ref[0], ref[1], ref[2]
        if self._live.pop((path, off), None) is None:
            return
        self.live_bytes -= length
        self._seg_live[path] -= 1
        self._reclaim_if_dead(path)

    def live_refs(self) -> list[tuple]:
        return sorted(self._live)

    def audit(self) -> list[str]:
        """Verify every live record against its segment's read-back CRC
        sidecar (io/stream.verified_ranges): the disk half of the
        three-tier audit."""
        from ..io.stream import verified_ranges

        problems = []
        if self._seg_path is not None:
            self._flush_sidecar(self._seg_path)
        by_path: dict[str, list] = {}
        for (path, off), length in self._live.items():
            by_path.setdefault(path, []).append((off, length))
        for path, records in by_path.items():
            ok_set = set(verified_ranges(path) or ())
            for off, length in sorted(records):
                if (off, length) not in ok_set:
                    problems.append(
                        f"disk tier: record [{off}, {off + length}) of "
                        f"{os.path.basename(path)} fails its read-back "
                        f"CRC (or lost its sidecar entry)")
        return problems


@dataclasses.dataclass(eq=False)
class _PromotionJob:
    """One page being raised to HBM (a spilled node's promotion or a
    shipped page's adoption): ``payload`` is the host planes, ``staged``
    whatever ``stage`` made of them (None until then: the PageUploader
    still works on it). ``row`` is the host-slab row the payload views
    (-1: the payload owns its memory). ``node.pending`` stays True until
    the engine reports the write landed; a job whose node was dropped in
    the meantime is dead (``cancelled``) and discarded. ``io`` is the
    engine's device-side state of the job (its pinned staging buffer and
    copy event)."""

    node: "_Node"
    page: int
    payload: tuple
    staged: object = None
    row: int = -1
    cancelled: bool = False
    io: object = None


class PageUploader:
    """Background staging thread: runs ``stage(job)`` off the scheduler
    thread for promotions whose payload needs host work before its upload
    (on the card: the copy of a disk payload into pinned memory; no CUDA
    call). ``gate``, when a test installs a threading Event, stalls the
    work so admission-PAUSE semantics can be pinned deterministically. A
    host-side failure degrades to the raw payload (the engine then uploads
    from it); ``on_cancel(job)`` runs for a job that died while staged."""

    def __init__(self, stage=None, on_cancel=None):
        import queue
        import threading

        self._stage = stage
        self._on_cancel = on_cancel
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self.gate = None  # tests: threading.Event held = staging stalls
        self.staged_jobs = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dllama-kv-uploader")
        self._thread.start()

    def submit(self, job: _PromotionJob) -> None:
        self._q.put(job)

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            gate = self.gate
            if gate is not None:
                gate.wait()
            try:
                staged = (self._stage(job) if self._stage
                          else job.payload)
            except Exception:  # noqa: BLE001 - host work degrades to raw
                staged = job.payload
            job.staged = staged
            self.staged_jobs += 1
            if job.cancelled and self._on_cancel is not None:
                self._on_cancel(job)

    def close(self) -> None:
        self._q.put(None)


@dataclasses.dataclass
class _Node:
    """One FULL page of the prefix tree: ``key`` is its page_size-token
    window. Exactly ONE of the tier fields is live at a time (the audit
    pins it): ``page`` when tier == hbm (the tree holds a pool ref),
    ``host_id`` when tier == host, ``disk_ref`` when tier == disk.
    ``pending`` marks a promotion in flight: the node is at tier hbm with
    ``page`` allocated, but the payload has not landed in the device pool
    yet, so readers wait (the engine's PAUSE)."""
    key: tuple
    page: int
    parent: "_Node | None"
    children: dict = dataclasses.field(default_factory=dict)
    last_used: int = 0
    tier: str = TIER_HBM
    host_id: int = -1
    disk_ref: tuple | None = None
    pending: bool = False
    promoted_from: str | None = None  # transient match-walk attribution


class PrefixTree:
    """Page-granular radix tree over token ids.

    Each node spans exactly one full page (the radix alphabet is page
    windows, so depth = pages), holding one tree-owned reference on its
    physical page while in HBM. ``match`` walks the longest stored
    page-aligned prefix and RETAINS every matched page for the caller;
    ``insert`` adopts a request's full prompt pages; ``evict_lru`` frees
    idle leaves.
    """

    def __init__(self, pool: PagePool, page_size: int, owner=None):
        self.pool = pool
        self.page_size = page_size
        # ``owner`` (the PagedAllocator) routes node-drop storage release
        # and spilled-node re-adoption through the tier bookkeeping; a
        # bare tree keeps the pool-only semantics
        self.owner = owner
        self._roots: dict[tuple, _Node] = {}
        self._clock = 0
        self._n_nodes = 0

    def __len__(self) -> int:
        return self._n_nodes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _windows(self, tokens) -> list[tuple]:
        ps = self.page_size
        return [tuple(tokens[i:i + ps])
                for i in range(0, (len(tokens) // ps) * ps, ps)]

    def match(self, tokens, promote=None, on_match=None) -> list[int]:
        """Physical page ids of the longest stored page-aligned prefix of
        ``tokens``; each carries a NEW reference the caller must release.
        Every touched node gets its own monotonic tick, so LRU order is a
        strict total order (no two nodes tie).

        ``promote`` (tiering) is called with a node whose payload is NOT
        in HBM: it raises the node to tier hbm (allocating ``node.page``,
        possibly still promotion-pending) and returns True, or returns
        False to stop the match at the spill boundary. ``on_match``
        observes every matched node (tier-source attribution)."""
        pages: list[int] = []
        children = self._roots
        for key in self._windows(tokens):
            node = children.get(key)
            if node is None:
                break
            if node.tier != TIER_HBM:
                if promote is None or not promote(node):
                    break
            node.last_used = self._tick()
            self.pool.retain(node.page)
            pages.append(node.page)
            if on_match is not None:
                on_match(node)
            children = node.children
        return pages

    def insert(self, tokens, pages) -> int:
        """Adopt the full pages of ``tokens`` (``len(pages)`` pages covering
        ``len(pages) * page_size`` token ids). The tree retains one ref per
        NEWLY adopted page; windows already present refresh recency (their
        page stays whichever physical id got there first: the content is
        identical by the prefix key), EXCEPT a window whose node was
        demoted: the inserting request just prefilled fresh HBM pages with
        that content, so the node re-adopts the fresh page and its spilled
        copy is freed (promotion by recompute). Returns the pages
        adopted."""
        adopted = 0
        children, parent = self._roots, None
        for key, pid in zip(self._windows(tokens), pages):
            node = children.get(key)
            if node is None:
                node = _Node(key=key, page=pid, parent=parent,
                             last_used=self._tick())
                children[key] = node
                self.pool.retain(pid)
                if self.owner is not None:
                    self.owner._note_tier(None, TIER_HBM)
                self._n_nodes += 1
                adopted += 1
            else:
                node.last_used = self._tick()
                if node.tier != TIER_HBM and self.owner is not None:
                    self.owner._readopt(node, pid)
            children, parent = node.children, node
        return adopted

    def _leaves(self):
        stack = list(self._roots.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                yield node

    def nodes(self):
        """Every node (an HBM node holds ONE tree ref on ``node.page``)."""
        stack = list(self._roots.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def evict_lru(self, n_pages: int) -> int:
        """Drop up to ``n_pages`` least-recently-used HBM leaf pages that no
        live slot maps (pool refcount 1 = tree-only), leaf by leaf, so an
        interior chain unwinds. Spilled leaves hold no pool page and are
        skipped. Returns the pages freed."""
        freed = 0
        while freed < n_pages:
            victims = [n for n in self._leaves()
                       if n.tier == TIER_HBM and not n.pending
                       and self.pool.refcount(n.page) == 1]
            if not victims:
                break
            self._drop(min(victims, key=lambda n: n.last_used))
            freed += 1
        return freed

    def _drop(self, node: _Node) -> None:
        siblings = (node.parent.children if node.parent is not None
                    else self._roots)
        del siblings[node.key]
        self._n_nodes -= 1
        if self.owner is not None:
            self.owner.release_node_storage(node)
        else:
            self.pool.release(node.page)

    def clear(self) -> int:
        """Release every tree-held page (fail_all)."""
        freed = 0
        while self._n_nodes:
            for node in list(self._leaves()):
                self._drop(node)
                freed += 1
        return freed


class PagedAllocator:
    """The engine-facing facade: pool + tree + the share/evict policy and
    the tier hierarchy.

    ``alloc_page`` demotes (or, untiered, evicts) idle tree pages when the
    free list runs dry; ``match_prefix`` / ``record_admission`` /
    ``insert_prefix`` are the admission and retire hooks; ``prefix_hits``,
    ``prefix_misses``, ``tokens_saved``, ``evictions`` and the per-tier
    counters count what sharing and tiering did.
    """

    def __init__(self, n_pages: int, page_size: int,
                 prefix_share: bool = True, host_pages: int = 0,
                 disk_dir: str | None = None, disk_bytes: int = 0,
                 remote: bool = False, host_slab=None, host_layout=None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.n_pages = n_pages
        self.prefix_share = prefix_share
        self.pool = PagePool(n_pages)
        self.tree = PrefixTree(self.pool, page_size, owner=self)
        self.prefix_hits = 0       # admissions that mapped >= 1 shared page
        self.prefix_misses = 0     # admissions that mapped none
        self.tokens_saved = 0      # prefill positions skipped via sharing
        self.evictions = 0         # tree pages DROPPED (not demoted)
        self.host = (HostPagePool(host_pages, host_slab, host_layout)
                     if host_pages > 0 else None)
        self.disk = (DiskPageStore(disk_dir, disk_bytes)
                     if disk_dir else None)
        self.tiered = self.host is not None or self.disk is not None
        # the decode pool of a disaggregated pair adopts shipped pages
        # through the promotion-pending machinery; ``remote`` only widens
        # the pending gates
        self.remote = remote
        self.remote_adopted = 0   # pages adopted from a handoff
        self.remote_rejected = 0  # shipped pages the pool could not place
        # tree-node population per tier, kept incrementally at every
        # transition; the audit recounts it from the tree
        self.tier_pages = {TIER_HBM: 0, TIER_HOST: 0, TIER_DISK: 0}
        self.demotions = {TIER_HOST: 0, TIER_DISK: 0}
        self.promotions = {TIER_HOST: 0, TIER_DISK: 0, "reprefill": 0}
        # prefill positions saved per SOURCE tier of the shared pages
        self.tokens_saved_by_tier = {TIER_HBM: 0, TIER_HOST: 0,
                                     TIER_DISK: 0}
        self.crc_drops = 0  # disk pages lost to CRC damage (re-derived)
        self._fetch = None
        self._fetch_into = None
        self._stage = None
        self._uploader: PageUploader | None = None
        self.on_pending_drop = None  # engine hook: a pending page dropped
        self.corrupt_demote = None  # fault hook: True = drop the payload
        self._pending: dict[int, _Node] = {}  # target pid -> node
        self._jobs: list[_PromotionJob] = []
        self._job_of: dict[int, _PromotionJob] = {}  # target pid -> job
        self._match_sources: list[str] = []  # last match's per-page tiers

    def bind_device_io(self, fetch, stage=None, uploader=None,
                       fetch_into=None) -> None:
        """Attach the engine's device callbacks: ``fetch(pid)`` -> host
        planes of pool page ``pid`` (demotion reads through it),
        ``fetch_into(pid, hid)`` the same into host-slab row ``hid``,
        ``stage(job)`` starts a promotion's upload path (None = the raw
        payload is applied at the step boundary), ``uploader`` a
        PageUploader that stages jobs off the scheduler thread (None =
        stage inline at promotion time). Jobs whose payload views a
        host-slab row always stage inline: the row may be written again
        by the next demotion."""
        self._fetch = fetch
        self._stage = stage
        self._uploader = uploader
        self._fetch_into = fetch_into

    @property
    def n_free(self) -> int:
        return self.pool.n_free

    @property
    def pending_capable(self) -> bool:
        """True when pages can be promotion-PENDING (payload not yet in
        the device pool): tiering or remote adoption is on. The engine's
        pause/settle gates consult this."""
        return self.tiered or self.remote

    def pages_for(self, n_positions: int) -> int:
        """Pages needed to cover ``n_positions`` sequence positions."""
        return -(-n_positions // self.page_size)

    def alloc_page(self) -> int | None:
        pid = self.pool.alloc()
        if pid is None and len(self.tree):
            if self.tiered and self._fetch is not None:
                self.demote_cold(1)
            else:
                self.evictions += self.tree.evict_lru(1)
            pid = self.pool.alloc()
        return pid

    def match_prefix(self, tokens) -> list[int]:
        """Admission hook: shared FULL pages for the longest stored prefix
        of ``tokens`` (refs retained for the caller). Counting waits for
        ``record_admission``: an admission the pool cannot serve yet is
        requeued and re-matches on every retry.

        With tiering, a matched node whose payload was spilled PROMOTES on
        the way through (async: the caller sees its page id now, the bytes
        land at a step boundary; pause until ``slot_pending`` is clear); a
        promotion the pool cannot place (or a CRC-dead disk page) stops
        the match at the spill boundary and the suffix prefills."""
        self._match_sources = []
        if not self.prefix_share:
            return []
        if not self.tiered:
            return self.tree.match(tokens)
        sources = self._match_sources

        def promote(node):
            src = node.tier
            if not self._promote(node):
                return False
            node.promoted_from = src  # consumed by on_match below
            return True

        def on_match(node):
            src = node.promoted_from
            node.promoted_from = None
            sources.append(src or TIER_HBM)

        return self.tree.match(tokens, promote=promote, on_match=on_match)

    def record_admission(self, n_shared_pages: int) -> None:
        """Count one admission that attempted prefix sharing and stuck.
        Savings attribute to each shared page's SOURCE tier at match
        time (the host/disk rows are the prefills tiering avoided)."""
        if n_shared_pages > 0:
            self.prefix_hits += 1
            self.tokens_saved += n_shared_pages * self.page_size
            sources = self._match_sources[:n_shared_pages]
            for i in range(n_shared_pages):
                src = sources[i] if i < len(sources) else TIER_HBM
                self.tokens_saved_by_tier[src] = (
                    self.tokens_saved_by_tier.get(src, 0) + self.page_size)
        else:
            self.prefix_misses += 1

    # -- tier transitions ---------------------------------------------------

    def _note_tier(self, old: str | None, new: str | None) -> None:
        """Incremental tier-population ledger (the audit recounts it)."""
        if old is not None:
            self.tier_pages[old] -= 1
        if new is not None:
            self.tier_pages[new] += 1

    @staticmethod
    def _chain_ids(node: _Node) -> set:
        """id()s of ``node`` and every ancestor: the PROTECT set. While a
        node is mid-demotion or mid-promotion, neither it nor an ancestor
        may be dropped by a lower tier's pressure eviction."""
        out = set()
        while node is not None:
            out.add(id(node))
            node = node.parent
        return out

    def demote_cold(self, n_pages: int, protect=frozenset()) -> int:
        """Write-behind demotion: move up to ``n_pages`` coldest tree-only
        HBM pages (pool refcount 1, not promotion-pending) down a tier:
        the payload is read from the device pool and stored host-first
        (host pressure spills the host LRU to disk first), and the HBM
        page is released. A payload no lower tier can take DROPS, with
        its now-unreachable subtree. Returns the HBM pages freed."""
        if self._fetch is None:
            # no device reader bound (pure-host harnesses): plain LRU
            # eviction, the drop path
            freed = self.tree.evict_lru(n_pages)
            self.evictions += freed
            return freed
        freed = 0
        while freed < n_pages:
            victims = [nd for nd in self.tree.nodes()
                       if nd.tier == TIER_HBM and not nd.pending
                       and self.pool.refcount(nd.page) == 1
                       and id(nd) not in protect]
            if not victims:
                break
            node = min(victims, key=lambda nd: nd.last_used)
            pid = node.page
            if self.corrupt_demote is not None and self.corrupt_demote():
                # seeded fault (drop_on_demote): the page leaves HBM but
                # its payload is never stored; the audit must flag it
                self._note_tier(TIER_HBM, TIER_HOST)
                node.tier, node.page, node.host_id = TIER_HOST, -1, -1
                self.pool.release(pid)
                freed += 1
                continue
            dest = self._store_down(node, pid,
                                    protect | self._chain_ids(node))
            if dest is None:
                self._drop_subtree(node)
            else:
                self._note_tier(TIER_HBM, dest)
                node.tier, node.page = dest, -1
                self.pool.release(pid)
                self.demotions[dest] += 1
            freed += 1
        return freed

    def _store_down(self, node: _Node, pid: int,
                    protect=frozenset()) -> str | None:
        """Place pool page ``pid``'s payload a tier down: host pool first
        (spilling the host LRU to disk under pressure), disk second. The
        page is read once, straight into the host row it lands in where
        the host pool has a slab. Returns the tier it landed in
        (node.host_id / disk_ref set), or None (nowhere: the caller drops
        the page). ``protect`` shields the node's ancestor chain."""
        if self.host is not None:
            hid = self.host.reserve()
            if hid is None and self._spill_host(1, protect):
                hid = self.host.reserve()
            if hid is not None:
                self.host.put(hid, self._fetch_into(pid, hid)
                              if self._fetch_into is not None
                              and self.host.slab is not None
                              else self._fetch(pid))
                node.host_id = hid
                return TIER_HOST
        if self.disk is not None:
            ref = self._disk_store(self._fetch(pid), protect)
            if ref is not None:
                node.disk_ref = ref
                return TIER_DISK
        return None

    def _spill_host(self, n: int, protect=frozenset()) -> bool:
        """Host-budget pressure: move the LRU host-tier payloads to disk.
        Without a disk tier (or with a full one) the LRU host page DROPS,
        subtree and all. True if any host row was freed."""
        spilled = 0
        while spilled < n:
            cands = [nd for nd in self.tree.nodes()
                     if nd.tier == TIER_HOST and self.host.live(nd.host_id)
                     and id(nd) not in protect]
            if not cands:
                return spilled > 0
            node = min(cands, key=lambda nd: nd.last_used)
            payload = self.host.free(node.host_id)
            node.host_id = -1
            ref = self._disk_store(payload,
                                   protect | self._chain_ids(node))
            if ref is None:
                self._drop_subtree(node)
            else:
                self._note_tier(TIER_HOST, TIER_DISK)
                node.tier, node.disk_ref = TIER_DISK, ref
                self.demotions[TIER_DISK] += 1
            spilled += 1
        return True

    def _disk_store(self, payload, protect=frozenset()):
        """Append to the disk tier, evicting LRU disk pages when the
        live-byte budget is tight. None = no disk tier / nothing left to
        evict."""
        if self.disk is None:
            return None
        while True:
            ref = self.disk.store(payload)
            if ref is not None:
                return ref
            cands = [nd for nd in self.tree.nodes()
                     if nd.tier == TIER_DISK and id(nd) not in protect]
            if not cands:
                return None
            self._drop_subtree(min(cands, key=lambda nd: nd.last_used))

    def _drop_subtree(self, node: _Node) -> None:
        """Drop ``node`` and every descendant (children are unreachable
        without their prefix chain), releasing each one's tier storage;
        post-order so the parent dicts stay consistent."""
        for child in list(node.children.values()):
            self._drop_subtree(child)
        self.evictions += 1
        self.tree._drop(node)

    def _queue_job(self, job: _PromotionJob) -> None:
        self._pending[job.page] = job.node
        self._jobs.append(job)
        self._job_of[job.page] = job

    def _promote(self, node: _Node) -> bool:
        """Raise a spilled node to HBM: allocate the target page (demoting
        colder pages if the pool is dry), load the payload (disk reads
        CRC-verify), and queue the upload. False = could not promote (pool
        truly dry, or a CRC-dead disk page: the node and its subtree are
        dropped and the match stops at the spill boundary)."""
        src = node.tier
        pid = self.pool.alloc()
        if pid is None:
            # colder pages make room, with the promoting chain protected
            self.demote_cold(1, protect=self._chain_ids(node))
            pid = self.pool.alloc()
        if pid is None:
            return False
        row = -1
        if src == TIER_HOST:
            if self.host is None or not self.host.live(node.host_id):
                self.pool.release(pid)
                raise RuntimeError(
                    f"kv tiering: host tier has no payload for node "
                    f"(host_id={node.host_id}) — a demotion dropped its "
                    f"bytes; the page ledger is corrupt")
            if self.host.slab is not None:
                row = node.host_id
            payload = self.host.free(node.host_id)
            node.host_id = -1
        else:
            payload = self.disk.load(node.disk_ref) if self.disk else None
            if payload is None:
                # CRC damage (or a lost store): this prefix chain is gone;
                # drop it and let prefill re-derive on the miss
                self.pool.release(pid)
                if self.disk is not None and self.disk.live(node.disk_ref):
                    self.disk.free(node.disk_ref)
                node.disk_ref = None
                self.crc_drops += 1
                self._drop_subtree(node)
                return False
            self.disk.free(node.disk_ref)
            node.disk_ref = None
        self._note_tier(src, TIER_HBM)
        node.tier, node.page, node.pending = TIER_HBM, pid, True
        self.promotions[src] += 1
        job = _PromotionJob(node=node, page=pid, payload=payload, row=row)
        self._queue_job(job)
        if self._uploader is not None and row < 0:
            self._uploader.submit(job)
        else:
            # threadcheck: allow[T001] the job is not yet the uploader's
            job.staged = (self._stage(job) if self._stage is not None
                          else payload)
        return True

    def _readopt(self, node: _Node, pid: int) -> None:
        """insert() found a spilled node whose content the inserting
        request just re-prefilled into fresh HBM pages: adopt the fresh
        page and free the spilled copy (promotion by recompute)."""
        self._note_tier(node.tier, TIER_HBM)
        if node.tier == TIER_HOST and self.host is not None \
                and self.host.live(node.host_id):
            self.host.free(node.host_id)
        elif node.tier == TIER_DISK and self.disk is not None \
                and self.disk.live(node.disk_ref):
            self.disk.free(node.disk_ref)
        node.tier, node.host_id, node.disk_ref = TIER_HBM, -1, None
        node.page = pid
        self.pool.retain(pid)
        self.promotions["reprefill"] += 1

    def adopt_remote_pages(self, tokens, payloads) -> list:
        """Handoff ingestion: adopt shipped page payloads under their
        full-page token-window keys as promotion-PENDING tree nodes (the
        decode pool's twin of a disk promotion, minus the disk). Each
        adopted window allocates its HBM page now (demoting or evicting
        cold pages under pressure), stages its payload inline, and queues
        the job for the engine's step-boundary apply; a request matching
        the prefix meanwhile PAUSEs until the payload lands.
        ``payloads[i]`` covers window i of ``tokens`` (wire-layout plane
        tuples, or None for a page that never arrived: the adoption stops
        at the gap and the suffix re-derives via prefill). Returns the
        adopted nodes (a cancelled handoff drops them)."""
        adopted: list = []
        children, parent = self.tree._roots, None
        windows = self.tree._windows(tokens)
        for consumed, (key, payload) in enumerate(zip(windows, payloads)):
            if payload is None:
                break  # dropped/damaged in flight: prefill re-derives
            node = children.get(key)
            if node is None:
                pid = self.alloc_page()
                if pid is None:
                    self.remote_rejected += len(payloads) - consumed
                    break  # pool dry even after eviction
                node = _Node(key=key, page=pid, parent=parent,
                             last_used=self.tree._tick(), pending=True)
                children[key] = node
                self.tree._n_nodes += 1
                self._note_tier(None, TIER_HBM)
                job = _PromotionJob(node=node, page=pid, payload=payload)
                self._queue_job(job)
                # threadcheck: allow[T001] the job is not yet the uploader's
                job.staged = (self._stage(job) if self._stage is not None
                              else payload)
                self.remote_adopted += 1
                adopted.append(node)
            else:
                # the window is already stored here (an earlier handoff or
                # a local prefill published it): the local copy wins, the
                # content is identical by the prefix key
                node.last_used = self.tree._tick()
            children, parent = node.children, node
        return adopted

    def drop_adopted(self, nodes) -> int:
        """Cancel-path cleanup for ``adopt_remote_pages``: drop adopted
        nodes that are STILL promotion-pending (nothing attends over them
        yet), so a cancelled handoff frees its pages on this pool now.
        Nodes whose payload landed stay as ordinary prefix pages."""
        dropped = 0
        for node in reversed(nodes):  # leaf-first: the chain unwinds
            if node.pending and self._pending.get(node.page) is node \
                    and not node.children:
                self.tree._drop(node)
                dropped += 1
        return dropped

    def release_node_storage(self, node: _Node) -> None:
        """Tree-drop hook (PrefixTree._drop): release whatever tier owns
        this node's payload. A promotion-pending node cancels its job and
        tells the engine (``on_pending_drop``: a copy may still be landing
        in the page the pool is about to hand out again)."""
        self._note_tier(node.tier, None)
        if node.tier == TIER_HBM:
            if node.pending:
                node.pending = False
                if self._pending.get(node.page) is node:
                    del self._pending[node.page]
                    job = self._job_of.pop(node.page, None)
                    if job is not None:
                        job.cancelled = True
                        if self.on_pending_drop is not None:
                            self.on_pending_drop(job)
            self.pool.release(node.page)
        elif node.tier == TIER_HOST:
            if self.host is not None and self.host.live(node.host_id):
                self.host.free(node.host_id)
        elif node.tier == TIER_DISK:
            if self.disk is not None and self.disk.live(node.disk_ref):
                self.disk.free(node.disk_ref)

    def take_staged_promotions(self) -> list[_PromotionJob]:
        """Promotion jobs whose payloads are staged: the engine writes them
        into the pool at a step boundary, then calls
        ``promotion_applied``. Dead jobs (node dropped meanwhile) are
        discarded; jobs the uploader still works on stay queued."""
        ready, rest = [], []
        for job in self._jobs:
            if job.cancelled or self._pending.get(job.page) is not job.node:
                continue  # cancelled: node dropped / storage released
            if job.staged is None:
                rest.append(job)  # uploader still staging
                continue
            ready.append(job)
        self._jobs = rest
        return ready

    def promotion_applied(self, job: _PromotionJob) -> None:
        """The engine wrote ``job``'s payload into pool page ``job.page``:
        the node's payload is live in HBM; waiting slots may dispatch."""
        job.node.pending = False
        if self._pending.get(job.page) is job.node:
            del self._pending[job.page]
        if self._job_of.get(job.page) is job:
            del self._job_of[job.page]

    def is_pending(self, pid: int) -> bool:
        return pid in self._pending

    def slot_pending(self, pages) -> bool:
        """True while any of a slot's pages awaits its promotion upload:
        the engine PAUSEs the slot until the payload lands."""
        if not self._pending:
            return False
        return any(p in self._pending for p in pages)

    def tier_page_counts(self) -> dict:
        """Tree-node population per tier, recounted from the tree (the
        audit's ground truth; ``tier_pages`` is the incremental twin)."""
        counts = {TIER_HBM: 0, TIER_HOST: 0, TIER_DISK: 0}
        for nd in self.tree.nodes():
            counts[nd.tier] = counts.get(nd.tier, 0) + 1
        return counts

    def insert_prefix(self, tokens, pages) -> int:
        """Retire hook: publish a request's full prompt pages for reuse."""
        if not self.prefix_share:
            return 0
        n_full = min(len(tokens) // self.page_size, len(pages))
        return self.tree.insert(tokens[:n_full * self.page_size],
                                pages[:n_full])

    def release_pages(self, pages) -> None:
        for pid in pages:
            self.pool.release(pid)

    def audit(self, slot_page_lists) -> list[str]:
        """Full-accounting invariant check over every live slot's page list:
        each allocated page's refcount must equal its slot-list occurrences
        plus one if an HBM tree node holds it (more is a leak, less a
        use-after-free in waiting); the scrap page is never allocated or
        mapped; the free list has no duplicates and no allocated ids; free
        + allocated covers the pool; and the tier half (``_audit_tiers``)
        holds. Returns the violations ([] = clean)."""
        problems: list[str] = []
        expected: dict[int, int] = {}
        for pages in slot_page_lists:
            for pid in pages:
                expected[pid] = expected.get(pid, 0) + 1
        for node in self.tree.nodes():
            if node.tier == TIER_HBM:  # spilled nodes hold no pool ref
                expected[node.page] = expected.get(node.page, 0) + 1
        problems += self._audit_tiers()
        refs = self.pool.refcounts()
        for pid, want in sorted(expected.items()):
            if pid == SCRAP_PAGE:
                problems.append(f"scrap page {SCRAP_PAGE} is mapped by a "
                                f"slot or the tree")
                continue
            have = refs.get(pid, 0)
            if have != want:
                problems.append(
                    f"page {pid}: refcount {have} != {want} expected "
                    f"(slots+tree)")
        for pid, have in sorted(refs.items()):
            if pid not in expected:
                problems.append(f"page {pid}: leaked (refcount {have} but "
                                f"no slot or tree node maps it)")
        free = self.pool.free_ids()
        if len(set(free)) != len(free):
            problems.append("free list contains duplicate page ids")
        if SCRAP_PAGE in free or SCRAP_PAGE in refs:
            problems.append(f"scrap page {SCRAP_PAGE} entered the pool")
        for pid in free:
            if pid in refs:
                problems.append(f"page {pid} is both free and allocated")
        if len(free) + len(refs) != self.n_pages:
            problems.append(
                f"pool accounting: {len(free)} free + {len(refs)} "
                f"allocated != {self.n_pages} pages")
        return problems

    def _audit_tiers(self) -> list[str]:
        """The tier half of the audit: every spilled node owns exactly one
        live host/disk copy, no copy is shared or orphaned, host-pool
        accounting closes, live disk records verify against their
        read-back CRC sidecars, promotion-pending nodes have in-flight
        jobs, and the incremental tier ledger matches a fresh recount."""
        if not self.tiered:
            return []
        problems: list[str] = []
        host_owner: dict[int, _Node] = {}
        disk_owner: dict[tuple, _Node] = {}
        for nd in self.tree.nodes():
            where = f"node {nd.key!r}"
            if nd.tier == TIER_HBM:
                if nd.host_id != -1 or nd.disk_ref is not None:
                    problems.append(f"tier audit: hbm {where} still "
                                    f"holds a host/disk copy (two-tier "
                                    f"ownership)")
                if nd.pending and nd.page not in self._pending:
                    problems.append(f"tier audit: {where} is promotion-"
                                    f"pending with no in-flight job")
            elif nd.tier == TIER_HOST:
                if self.host is None or not self.host.live(nd.host_id):
                    problems.append(f"tier audit: host {where} has no "
                                    f"live host-pool copy (payload "
                                    f"dropped on demote?)")
                elif nd.host_id in host_owner:
                    problems.append(f"tier audit: host page "
                                    f"{nd.host_id} owned by two nodes")
                else:
                    host_owner[nd.host_id] = nd
                if nd.page != -1 or nd.disk_ref is not None:
                    problems.append(f"tier audit: host {where} also "
                                    f"claims an hbm/disk copy")
            elif nd.tier == TIER_DISK:
                if self.disk is None or not self.disk.live(nd.disk_ref):
                    problems.append(f"tier audit: disk {where} has no "
                                    f"live disk record")
                elif (nd.disk_ref[0], nd.disk_ref[1]) in disk_owner:
                    problems.append(f"tier audit: disk record "
                                    f"{nd.disk_ref[:2]} owned by two "
                                    f"nodes")
                else:
                    disk_owner[(nd.disk_ref[0], nd.disk_ref[1])] = nd
                if nd.page != -1 or nd.host_id != -1:
                    problems.append(f"tier audit: disk {where} also "
                                    f"claims an hbm/host copy")
            else:
                problems.append(f"tier audit: {where} has unknown tier "
                                f"{nd.tier!r}")
        if self.host is not None:
            problems += self.host.audit()
            for hid in self.host.live_ids():
                if hid not in host_owner:
                    problems.append(f"tier audit: host page {hid} leaked "
                                    f"(live but no node owns it)")
        if self.disk is not None:
            problems += self.disk.audit()  # CRC read-back of live records
            for ref_key in self.disk.live_refs():
                if ref_key not in disk_owner:
                    problems.append(f"tier audit: disk record {ref_key} "
                                    f"leaked (live but no node owns it)")
        counts = self.tier_page_counts()
        if counts != self.tier_pages:
            problems.append(f"tier audit: incremental tier ledger "
                            f"{self.tier_pages} != recount {counts}")
        return problems

    def reset_counters(self) -> None:
        """Zero the admission and tier counters WITHOUT touching pool or
        tree state (a warm-up/timed-pass boundary)."""
        self.prefix_hits = self.prefix_misses = 0
        self.tokens_saved = self.evictions = 0
        self.demotions = {TIER_HOST: 0, TIER_DISK: 0}
        self.promotions = {TIER_HOST: 0, TIER_DISK: 0, "reprefill": 0}
        self.tokens_saved_by_tier = {TIER_HBM: 0, TIER_HOST: 0,
                                     TIER_DISK: 0}
        self.crc_drops = 0
        self.remote_adopted = self.remote_rejected = 0

    @property
    def hit_rate(self) -> float:
        n = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / n if n else 0.0
