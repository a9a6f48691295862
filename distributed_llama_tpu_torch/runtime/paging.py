"""Paged KV allocation + radix prefix sharing: the host half of paged KV
(the JAX package's runtime/paging.py, its own copy here).

A fixed pool of fixed-size pages (vLLM's PagedAttention unit) plus a
prefix tree over full pages (SGLang's RadixAttention), so requests that
share a system prompt map the SAME physical prefill pages instead of
recomputing them. Everything here is host-side bookkeeping over small
Python ints; the device sees only the page-table rows (int32 physical page
ids per slot) that models/llama.forward_batch_paged walks, and the pool
planes they index.

Invariants (tests/test_torch_paging.py holds them against the JAX
package's allocator under the same sequences of calls):

* a page's refcount = (# slots mapping it) + (1 if the tree holds it); it
  returns to the free list exactly when that count reaches zero;
* page id 0 is RESERVED as the scrap page (free and paused slot rows
  write their dead k/v there); the pool never hands it out;
* the tree only shares FULL pages (``page_size`` tokens each): a partly
  filled tail page is private to its request, so decode writes never land
  in a shared page;
* eviction frees least-recently-used tree LEAVES whose pages no live slot
  maps; interior nodes become evictable once their children are gone.

Left out: the KV tiers (the host page pool, the disk page store, the
uploader, promotion and demotion) and the adoption of remote pages. Their
constructor arguments raise "not yet ported"; ``tiered`` and
``pending_capable`` are constant False, so the engine's gates read as in
the JAX package.
"""

from __future__ import annotations

import dataclasses

SCRAP_PAGE = 0  # physical page 0: dead-write target for parked slots


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


@dataclasses.dataclass
class _Node:
    """One FULL page of the prefix tree: ``key`` is its page_size-token
    window, ``page`` the physical page the tree holds one reference on."""
    key: tuple
    page: int
    parent: "_Node | None"
    children: dict = dataclasses.field(default_factory=dict)
    last_used: int = 0


class PrefixTree:
    """Page-granular radix tree over token ids.

    Each node spans exactly one full page (the radix alphabet is page
    windows, so depth = pages), holding one tree-owned reference on its
    physical page. ``match`` walks the longest stored page-aligned prefix
    and RETAINS every matched page for the caller; ``insert`` adopts a
    request's full prompt pages; ``evict_lru`` frees idle leaves.
    """

    def __init__(self, pool: PagePool, page_size: int):
        self.pool = pool
        self.page_size = page_size
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

    def match(self, tokens) -> list[int]:
        """Physical page ids of the longest stored page-aligned prefix of
        ``tokens``; each carries a NEW reference the caller must release.
        Every touched node gets its own monotonic tick, so LRU order is a
        strict total order (no two nodes tie)."""
        pages: list[int] = []
        children = self._roots
        for key in self._windows(tokens):
            node = children.get(key)
            if node is None:
                break
            node.last_used = self._tick()
            self.pool.retain(node.page)
            pages.append(node.page)
            children = node.children
        return pages

    def insert(self, tokens, pages) -> int:
        """Adopt the full pages of ``tokens`` (``len(pages)`` pages covering
        ``len(pages) * page_size`` token ids). The tree retains one ref per
        NEWLY adopted page; windows already present only refresh recency
        (their page stays whichever physical id got there first: the
        content is identical by the prefix key). Returns the pages
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
                self._n_nodes += 1
                adopted += 1
            else:
                node.last_used = self._tick()
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
        """Every node (each holds ONE tree ref on ``node.page``)."""
        stack = list(self._roots.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def evict_lru(self, n_pages: int) -> int:
        """Drop up to ``n_pages`` least-recently-used leaf pages that no
        live slot maps (pool refcount 1 = tree-only), leaf by leaf, so an
        interior chain unwinds. Returns the pages freed."""
        freed = 0
        while freed < n_pages:
            victims = [n for n in self._leaves()
                       if self.pool.refcount(n.page) == 1]
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
    """The engine-facing facade: pool + tree + the share/evict policy.

    ``alloc_page`` evicts idle tree leaves when the free list runs dry;
    ``match_prefix`` / ``record_admission`` / ``insert_prefix`` are the
    admission and retire hooks; ``prefix_hits``, ``prefix_misses``,
    ``tokens_saved`` and ``evictions`` count what sharing did.
    """

    # the KV tiers are not ported: the engine's tier gates read these
    tiered = False
    pending_capable = False

    def __init__(self, n_pages: int, page_size: int,
                 prefix_share: bool = True, host_pages: int = 0,
                 disk_dir: str | None = None, disk_bytes: int = 0,
                 remote: bool = False):
        if host_pages or disk_dir or disk_bytes or remote:
            raise ValueError("not yet ported: the KV tiers (host_pages, "
                             "disk_dir, disk_bytes) and remote page "
                             "adoption")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.n_pages = n_pages
        self.prefix_share = prefix_share
        self.pool = PagePool(n_pages)
        self.tree = PrefixTree(self.pool, page_size)
        self.prefix_hits = 0       # admissions that mapped >= 1 shared page
        self.prefix_misses = 0     # admissions that mapped none
        self.tokens_saved = 0      # prefill positions skipped via sharing
        self.evictions = 0         # tree pages dropped

    @property
    def n_free(self) -> int:
        return self.pool.n_free

    def pages_for(self, n_positions: int) -> int:
        """Pages needed to cover ``n_positions`` sequence positions."""
        return -(-n_positions // self.page_size)

    def alloc_page(self) -> int | None:
        pid = self.pool.alloc()
        if pid is None and len(self.tree):
            self.evictions += self.tree.evict_lru(1)
            pid = self.pool.alloc()
        return pid

    def match_prefix(self, tokens) -> list[int]:
        """Admission hook: shared FULL pages for the longest stored prefix
        of ``tokens`` (refs retained for the caller). Counting waits for
        ``record_admission``: an admission the pool cannot serve yet is
        requeued and re-matches on every retry."""
        if not self.prefix_share:
            return []
        return self.tree.match(tokens)

    def record_admission(self, n_shared_pages: int) -> None:
        """Count one admission that attempted prefix sharing and stuck."""
        if n_shared_pages > 0:
            self.prefix_hits += 1
            self.tokens_saved += n_shared_pages * self.page_size
        else:
            self.prefix_misses += 1

    def insert_prefix(self, tokens, pages) -> int:
        """Publish a request's full prompt pages for reuse."""
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
        plus one if a tree node holds it (more is a leak, less a
        use-after-free in waiting); the scrap page is never allocated or
        mapped; the free list has no duplicates and no allocated ids; and
        free + allocated covers the pool. Returns the violations ([] =
        clean)."""
        problems: list[str] = []
        expected: dict[int, int] = {}
        for pages in slot_page_lists:
            for pid in pages:
                expected[pid] = expected.get(pid, 0) + 1
        for node in self.tree.nodes():
            expected[node.page] = expected.get(node.page, 0) + 1
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

    @property
    def hit_rate(self) -> float:
        n = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / n if n else 0.0
