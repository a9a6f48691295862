"""The port's paged-KV bookkeeping (runtime/paging.py) against the JAX
package's, on the CPU: the same seeded sequences of admit / match / insert /
grow / retire / evict calls drive both allocators, and after every call
their free lists, refcounts, radix trees, counters and ``audit()`` must be
equal; plus the tests/test_paging.py unit cases on the port's own copy."""

import numpy as np
import pytest

from distributed_llama_tpu.runtime import paging as ref_paging
from distributed_llama_tpu_torch.runtime import paging
from distributed_llama_tpu_torch.runtime.paging import (SCRAP_PAGE, PagePool,
                                                        PagedAllocator,
                                                        PrefixTree)


def _state(alloc, slots):
    nodes = sorted((n.key, n.page, n.last_used) for n in alloc.tree.nodes())
    return (alloc.pool.free_ids(), alloc.pool.refcounts(), nodes,
            alloc.prefix_hits, alloc.prefix_misses, alloc.tokens_saved,
            alloc.evictions, alloc.n_free, len(alloc.tree),
            alloc.audit([s["pages"] for s in slots]))


class _Driver:
    """The engine's use of an allocator (paged admission, page growth,
    publish and retire), over host lists of pages."""

    def __init__(self, alloc, page_size):
        self.alloc = alloc
        self.ps = page_size
        self.slots = []

    def admit(self, tokens):
        a = self.alloc
        pages = a.match_prefix(tokens[:-1])
        shared = len(pages)
        while len(pages) < a.pages_for(len(tokens)):
            pid = a.alloc_page()
            if pid is None:  # dry: release and requeue, nothing counted
                a.release_pages(pages)
                return "dry"
            pages.append(pid)
        a.record_admission(shared)
        self.slots.append({"tokens": tokens, "pages": pages})
        return shared

    def publish(self, i):
        s = self.slots[i]
        return self.alloc.insert_prefix(s["tokens"][:-1], s["pages"])

    def grow(self, i, n):
        s = self.slots[i]
        for _ in range(n):
            pid = self.alloc.alloc_page()
            if pid is None:
                return False
            s["pages"].append(pid)
        return True

    def retire(self, i, publish=True):
        s = self.slots.pop(i)
        if publish:
            self.alloc.insert_prefix(s["tokens"], s["pages"])
        self.alloc.release_pages(s["pages"])


@pytest.mark.parametrize("n_pages,page_size", [(12, 4), (20, 4), (9, 8)])
@pytest.mark.parametrize("seed", range(6))
def test_allocator_matches_reference_under_seeded_sequences(seed, n_pages,
                                                            page_size):
    rng = np.random.default_rng(seed)
    systems = [list(rng.integers(2, 6, 3 * page_size)) for _ in range(3)]
    port = _Driver(PagedAllocator(n_pages, page_size), page_size)
    ref = _Driver(ref_paging.PagedAllocator(n_pages, page_size), page_size)
    for step in range(60):
        op = rng.integers(0, 4)
        if op == 0 or not port.slots:
            tokens = [1, *systems[rng.integers(0, 3)][:rng.integers(
                0, 3 * page_size)], *rng.integers(2, 9, rng.integers(1, 9))]
            got, want = port.admit(tokens), ref.admit(tokens)
        elif op == 1:
            i = int(rng.integers(0, len(port.slots)))
            got, want = port.publish(i), ref.publish(i)
        elif op == 2:
            i = int(rng.integers(0, len(port.slots)))
            n = int(rng.integers(1, 3))
            got, want = port.grow(i, n), ref.grow(i, n)
        else:
            i = int(rng.integers(0, len(port.slots)))
            publish = bool(rng.integers(0, 4))
            got = port.retire(i, publish)
            want = ref.retire(i, publish)
        assert got == want, step
        assert _state(port.alloc, port.slots) == \
            _state(ref.alloc, ref.slots), step
        assert port.alloc.audit([s["pages"] for s in port.slots]) == []
    assert port.alloc.hit_rate == ref.alloc.hit_rate
    while port.slots:
        port.retire(0)
        ref.retire(0)
    port.alloc.tree.clear()
    ref.alloc.tree.clear()
    assert _state(port.alloc, []) == _state(ref.alloc, [])
    assert port.alloc.n_free == n_pages


def test_pool_alloc_order_refcounts_and_free():
    pool = PagePool(4)
    assert pool.n_free == 4
    a, b = pool.alloc(), pool.alloc()
    assert (a, b) == (1, 2)  # lowest-first, deterministic
    pool.retain(a)
    assert pool.refcount(a) == 2
    pool.release(a)
    assert pool.refcount(a) == 1 and pool.n_free == 2
    pool.release(a)
    assert pool.refcount(a) == 0 and pool.n_free == 3
    assert pool.alloc() == 1  # back at the head of the free list
    assert SCRAP_PAGE not in pool.free_ids()


def test_pool_release_unallocated_raises():
    pool = PagePool(2)
    with pytest.raises(ValueError, match="unallocated"):
        pool.release(1)
    with pytest.raises(ValueError, match="unallocated"):
        pool.retain(2)
    with pytest.raises(ValueError, match=">= 1 page"):
        PagePool(0)


def test_tree_insert_match_full_pages_only():
    pool = PagePool(8)
    tree = PrefixTree(pool, 4)
    pages = [pool.alloc() for _ in range(3)]
    toks = list(range(10, 21))  # 11 tokens: 2 full pages + a tail
    assert tree.insert(toks, pages) == 2
    assert len(tree) == 2 and pool.refcount(pages[0]) == 2
    assert pool.refcount(pages[2]) == 1  # the partial tail is private
    assert tree.match(toks) == pages[:2]
    assert tree.match(toks[:7]) == pages[:1]
    assert tree.match([0, *toks]) == []


def test_eviction_order_is_strict_lru():
    pool = PagePool(6)
    tree = PrefixTree(pool, 2)
    a = [pool.alloc() for _ in range(2)]
    b = [pool.alloc() for _ in range(2)]
    tree.insert([1, 2, 3, 4], a)
    tree.insert([5, 6, 7, 8], b)
    for p in a + b:
        pool.release(p)  # tree-only now
    tree.match([1, 2, 3, 4])  # a's chain is the most recent
    for p in a:
        pool.release(p)
    assert tree.evict_lru(1) == 1
    assert sorted(n.page for n in tree.nodes()) == sorted(a + b[:1])
    # interior nodes go only once their children are gone
    assert tree.evict_lru(10) == 3 and len(tree) == 0
    assert pool.n_free == 6


def test_allocator_evicts_idle_tree_pages_when_dry():
    alloc = PagedAllocator(2, 2)
    pages = [alloc.alloc_page(), alloc.alloc_page()]
    alloc.insert_prefix([1, 2, 3, 4], pages)
    alloc.release_pages(pages)
    assert alloc.n_free == 0 and len(alloc.tree) == 2
    assert alloc.alloc_page() is not None and alloc.evictions == 1
    assert alloc.audit([]) != []  # the new page is mapped by no slot


def test_allocator_counters_and_pages_for():
    alloc = PagedAllocator(8, 4)
    assert [alloc.pages_for(n) for n in (0, 1, 4, 5, 8)] == [0, 1, 1, 2, 2]
    alloc.record_admission(0)
    alloc.record_admission(2)
    assert (alloc.prefix_hits, alloc.prefix_misses, alloc.tokens_saved) == \
        (1, 1, 8)
    assert alloc.hit_rate == 0.5
    assert PagedAllocator(8, 4).hit_rate == 0.0  # no admission yet


def test_audit_flags_leaks_and_scrap_mappings():
    alloc = PagedAllocator(4, 2)
    pid = alloc.alloc_page()
    assert alloc.audit([[pid]]) == []
    assert any("leaked" in p for p in alloc.audit([]))
    assert any("scrap page" in p for p in alloc.audit([[pid, SCRAP_PAGE]]))
    assert any("refcount" in p for p in alloc.audit([[pid, pid]]))


def test_prefix_share_off_never_matches():
    alloc = PagedAllocator(4, 2, prefix_share=False)
    pages = [alloc.alloc_page()]
    assert alloc.insert_prefix([1, 2], pages) == 0
    assert alloc.match_prefix([1, 2, 3]) == []


@pytest.mark.parametrize("kw", [{"host_pages": 4}, {"disk_dir": "d"},
                                {"disk_bytes": 1}, {"remote": True}])
def test_tiers_are_not_yet_ported(kw, tmp_path, monkeypatch):
    """The tier arguments are ported: each builds the allocator the JAX
    package builds for it (``remote`` is the JAX engine's attribute), and
    the same demote / promote sequence gives both the same tier books."""
    monkeypatch.chdir(tmp_path)
    port = PagedAllocator(4, 2, **kw)
    jkw = {k: v for k, v in kw.items() if k != "remote"}
    if "disk_dir" in jkw:
        jkw["disk_dir"] = "jax-d"
    ref = ref_paging.PagedAllocator(4, 2, **jkw)
    ref.remote = kw.get("remote", False)
    for a in (port, ref):
        assert (a.tiered, a.pending_capable) == (port.tiered,
                                                  port.pending_capable)
        a.bind_device_io(lambda pid: (np.full((2, 3), pid, np.float32),))
        pages = [a.alloc_page() for _ in range(3)]
        a.insert_prefix([1, 2, 3, 4, 5, 6], pages)
        a.release_pages(pages)
        a.demote_cold(2)
        got = a.match_prefix([1, 2, 3, 4, 5, 6, 7])
        for job in a.take_staged_promotions():
            a.promotion_applied(job)
        a.release_pages(got)
    for name in ("tier_pages", "demotions", "promotions", "evictions"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.tier_page_counts() == ref.tier_page_counts()
    assert port.audit([]) == ref.audit([]) == []
