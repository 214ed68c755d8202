"""Host-side page allocator + prefix cache for the paged KV pool.

``PoolSession`` owns the free-list / refcounts for ONE engine's pool of
physical KV pages. It is pure host bookkeeping — the device arrays live
in the engine's decode state (quant/kvcache.PagedKV); this class only
decides WHICH physical page each slot's logical page maps to. Page ids
are 1-based: physical page 0 is the sacrificial dump page and is never
handed out.

Refcount invariants:

* every admitted slot holds one reference on each physical page its page
  table maps (shared prefix pages included);
* the prefix cache holds one reference of its own on each registered
  page, so a shared page survives its donor slot's release;
* a prefix match not yet admitted or unpinned (a chunked prefill in
  flight) holds one reference on each page it pinned, counted apart, so
  ``check_invariants`` holds while it is out (the reference's does not,
  and fails a repack made while a chunked prefill holds a hit);
* a page returns to the free list exactly when its count reaches 0.

Copy-on-write prefix sharing: prompts are matched page-by-page against
previously admitted prompts (exact token match per full page). Matching
FULL pages are mapped read-only into the new slot (refcount bumped, never
re-written: decode writes only touch positions >= prompt_len, and a
shared page always ends before the donor's prompt_len). The first
divergent / partial page is the COW boundary: its tokens are copied into
a freshly allocated private page at insert time (``cow_copies`` counts
these). The hit is capped at ``prompt_len - 1`` so at least one prompt
token always runs through the model to produce the next-token logits.

A copy of the JAX package's ``serving/pool.py``, with its trace instants
(``pool/cow-copy``, ``pool/prefix-hit``, on the owning replica's ``pid``;
``repro_torch.obs``, off unless a tracer is installed). ``flush_prefix`` and
``rebuild`` (with ``PrefixCache.remap``) serve a live repack of the pool
(graceful degradation, ``ServeEngine.apply_kv_plan``); a rebuilt allocator
keeps the page map it was rebuilt through (``perm``), with which a match
pinned before the repack (an in-flight chunked prefill's) follows its
pages (``PrefixMatch.remap``; the reference keeps the old ids).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np

from repro_torch import obs


class OutOfPages(RuntimeError):
    """The pool cannot supply the pages a request needs (admission-time
    backpressure — the caller should retry after a slot is released)."""


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    """Engine-level paged-pool knobs.

    ``pool_pages=None`` sizes the pool to the dense engine's reservation
    (num_slots * ceil(max_seq / page_size) pages — equal memory), which
    makes the paged win purely allocation-side: short requests leave the
    spare pages to extra concurrent slots."""
    page_size: int = 64
    pool_pages: Optional[int] = None
    prefix_sharing: bool = True


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Result of matching a prompt against the prefix cache. ``full_ids``
    are physical pages mapped verbatim (pinned); ``donor`` optionally
    contributes its first ``donor_tokens`` rows to seed the COW boundary
    page. ``hit = len(full_ids) * P + donor_tokens`` prompt tokens skip
    prefill."""
    hit: int = 0
    full_ids: tuple[int, ...] = ()
    donor: Optional[int] = None
    donor_tokens: int = 0

    def remap(self, perm: np.ndarray) -> "PrefixMatch":
        """The same match after a pool repack moved its pinned pages
        (``perm[old_pid] = new_pid``)."""
        return dataclasses.replace(
            self, full_ids=tuple(int(perm[p]) for p in self.full_ids),
            donor=None if self.donor is None else int(perm[self.donor]))


class PrefixCache:
    """Token-exact page-granular prefix index.

    ``_children[prefix_tokens][page_tokens] -> page_id`` maps a known
    prompt prefix to the physical page holding its next P tokens. The LRU
    order is kept per (prefix, page) entry; eviction only removes entries
    whose page no live slot maps (refcount 1 — the cache's own)."""

    def __init__(self) -> None:
        self._children: dict[tuple, dict[tuple, int]] = {}
        self._lru: OrderedDict[tuple[tuple, tuple], int] = OrderedDict()

    def __len__(self) -> int:
        return len(self._lru)

    def match(self, tokens: tuple, page_size: int) -> PrefixMatch:
        p = len(tokens)
        prefix: tuple = ()
        full: list[int] = []
        i = 0
        while i + page_size <= p:
            page = tokens[i:i + page_size]
            entry = self._children.get(prefix, {})
            pid = entry.get(page)
            if pid is None:
                break
            full.append(pid)
            self._lru.move_to_end((prefix, page))
            prefix = prefix + page
            i += page_size
        # best partial-overlap donor for the COW boundary page
        donor, donor_t = None, 0
        rest = tokens[i:]
        if rest:
            for page, pid in self._children.get(prefix, {}).items():
                t = 0
                for a, b in zip(rest, page):
                    if a != b:
                        break
                    t += 1
                if t > donor_t:
                    donor, donor_t = pid, t
        hit = len(full) * page_size + donor_t
        if hit >= p:  # keep >= 1 prompt token for the model to prefill
            hit = p - 1
            over = hit - len(full) * page_size
            if over < 0:  # whole prompt sat in full pages: demote the last
                donor, donor_t = full.pop(), hit - len(full) * page_size
            else:
                donor_t = over
                if donor_t == 0:
                    donor = None
        return PrefixMatch(hit=hit, full_ids=tuple(full), donor=donor,
                           donor_tokens=donor_t)

    def register(self, tokens: tuple, prompt_len: int, row: np.ndarray,
                 page_size: int) -> list[int]:
        """Index every FULL prompt page of a freshly admitted slot. Returns
        the page ids newly referenced by the cache (caller increfs them)."""
        new_refs: list[int] = []
        prefix: tuple = ()
        for j in range(prompt_len // page_size):
            page = tuple(tokens[j * page_size:(j + 1) * page_size])
            entry = self._children.setdefault(prefix, {})
            if page not in entry:
                entry[page] = int(row[j])
                self._lru[(prefix, page)] = int(row[j])
                new_refs.append(int(row[j]))
            else:
                self._lru.move_to_end((prefix, page))
            prefix = prefix + page
        return new_refs

    def evict_lru(self, refcounts: np.ndarray) -> Optional[int]:
        """Drop the least-recently-used entry whose page only the cache
        still references; returns the page id to decref (or None)."""
        for key, pid in self._lru.items():
            if refcounts[pid] == 1:
                prefix, page = key
                del self._lru[key]
                entry = self._children.get(prefix)
                if entry is not None:
                    entry.pop(page, None)
                    if not entry:
                        del self._children[prefix]
                return pid
        return None

    def evictable(self, refcounts: np.ndarray) -> int:
        return sum(1 for pid in self._lru.values() if refcounts[pid] == 1)

    def remap(self, perm: np.ndarray) -> "PrefixCache":
        """Clone onto a remapped physical page space (``perm[old] = new``),
        preserving LRU order (live pool repack)."""
        pc = PrefixCache()
        pc._children = {
            prefix: {page: int(perm[pid]) for page, pid in entry.items()}
            for prefix, entry in self._children.items()}
        pc._lru = OrderedDict(
            (key, int(perm[pid])) for key, pid in self._lru.items())
        return pc


class PoolSession:
    """Free-list + refcount allocator for one engine's page pool."""

    def __init__(self, num_pages: int, page_size: int, n_log: int,
                 prefix_sharing: bool = True) -> None:
        assert num_pages >= 1 and page_size >= 1 and n_log >= 1
        self.num_pages = num_pages
        self.page_size = page_size
        self.n_log = n_log
        # pop() hands out low ids first (cosmetic, but makes tests legible)
        self._free = list(range(num_pages, 0, -1))
        self._ref = np.zeros(num_pages + 1, np.int64)  # [0] = dump, unused
        self._slot_pages: dict[int, list[int]] = {}
        self.prefix = PrefixCache() if prefix_sharing else None
        # trace pid: the owning session stamps its replica id, so prefix-hit
        # and COW instants land on its process
        self.pid = 0
        # stats
        self.peak_pages = 0
        self.cow_copies = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prompt_tokens = 0
        self.admitted = 0
        self.perm: Optional[np.ndarray] = None  # set by ``rebuild``
        # references held by matches not yet admitted or unpinned (a
        # chunked prefill's pins), so the invariants hold while one is out
        self._pins = np.zeros(num_pages + 1, np.int64)

    # -- accounting --------------------------------------------------------

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def pages_for(self, seq_len: int) -> int:
        """Pages a request needs to cover ``seq_len`` tokens."""
        return min(-(-seq_len // self.page_size), self.n_log)

    def can_admit(self, num_pages: int) -> bool:
        """Worst-case (no prefix hit) admission check: free pages plus
        cache-only pages we may evict."""
        avail = len(self._free)
        if self.prefix is not None:
            avail += self.prefix.evictable(self._ref)
        return num_pages <= avail

    # -- refcount plumbing -------------------------------------------------

    def _incref(self, pid: int) -> None:
        assert pid != 0
        self._ref[pid] += 1

    def _decref(self, pid: int) -> None:
        assert pid != 0 and self._ref[pid] > 0, (pid, self._ref[pid])
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free.append(pid)

    def _alloc(self) -> int:
        if not self._free and self.prefix is not None:
            evicted = self.prefix.evict_lru(self._ref)
            if evicted is not None:
                self._decref(evicted)
        if not self._free:
            raise OutOfPages(
                f"page pool exhausted: {self.num_pages} pages all "
                f"referenced (no evictable prefix entries)")
        pid = self._free.pop()
        self._ref[pid] = 1
        return pid

    # -- admission protocol ------------------------------------------------

    def match(self, tokens) -> PrefixMatch:
        """Match a prompt against the prefix cache and PIN the matched
        pages (incref) so they survive until ``admit``/``unpin``. Call
        once per request, before prefill."""
        if self.prefix is None:
            return PrefixMatch()
        m = self.prefix.match(tuple(int(t) for t in tokens), self.page_size)
        for pid in self._pinned(m):
            self._incref(pid)
            self._pins[pid] += 1
        return m

    @staticmethod
    def _pinned(m: PrefixMatch) -> list:
        return list(m.full_ids) + ([m.donor] if m.donor is not None else [])

    def unpin(self, m: PrefixMatch) -> None:
        """Drop the pins ``match`` took (admission failed / abandoned)."""
        for pid in self._pinned(m):
            self._pins[pid] -= 1
            self._decref(pid)

    def admit(self, slot: int, tokens, num_pages: int,
              m: Optional[PrefixMatch] = None
              ) -> tuple[np.ndarray, np.ndarray]:
        """Allocate the private pages of a request and build its page-table
        row. Returns ``(row, wrow)``, both (n_log,) int32: ``row`` is the
        slot's logical->physical map (0 past its allocation); ``wrow``
        redirects the shared (read-only) prefix pages to the dump page so
        the insert scatter cannot touch them. Raises ``OutOfPages`` with
        the match unpinned and nothing leaked."""
        m = m or PrefixMatch()
        assert slot not in self._slot_pages, f"slot {slot} already admitted"
        n_shared = len(m.full_ids)
        assert n_shared <= num_pages <= self.n_log, (n_shared, num_pages)
        private: list[int] = []
        try:
            for _ in range(num_pages - n_shared):
                private.append(self._alloc())
        except OutOfPages:
            for pid in private:
                self._decref(pid)
            self.unpin(m)
            raise
        for pid in self._pinned(m):
            self._pins[pid] -= 1    # the full pages' pins pass to the slot
        if m.donor is not None:
            self._decref(m.donor)   # its rows are copied, not mapped
            self.cow_copies += 1
            obs.instant("pool/cow-copy", self.pid, args={"slot": slot})
        row = np.zeros(self.n_log, np.int32)
        wrow = np.zeros(self.n_log, np.int32)
        row[:n_shared] = m.full_ids          # pinned refs transfer to slot
        row[n_shared:num_pages] = private
        wrow[n_shared:num_pages] = private   # shared pages -> dump on write
        self._slot_pages[slot] = list(row[:num_pages])
        self.admitted += 1
        self.prompt_tokens += len(tokens)
        if m.hit:
            self.prefix_hits += 1
            self.prefix_hit_tokens += m.hit
            obs.instant("pool/prefix-hit", self.pid,
                        args={"slot": slot, "tokens": m.hit})
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        return row, wrow

    def register(self, slot: int, tokens, prompt_len: int) -> None:
        """Index the slot's full prompt pages for future prefix sharing
        (call after the insert has written them)."""
        if self.prefix is None:
            return
        row = np.asarray(self._slot_pages[slot], np.int32)
        toks = tuple(int(t) for t in tokens)[:prompt_len]
        for pid in self.prefix.register(toks, prompt_len, row,
                                        self.page_size):
            self._incref(pid)

    def release(self, slot: int) -> None:
        """Return the slot's page references (shared pages survive while
        the prefix cache or other slots still hold them)."""
        for pid in self._slot_pages.pop(slot):
            self._decref(pid)

    def flush_prefix(self) -> int:
        """Evict every cache-only prefix entry (pages no live slot maps).
        Promotion back up the degradation ladder shrinks the pool at
        constant bytes — cached-but-unmapped pages are the first to go."""
        n = 0
        while self.prefix is not None:
            pid = self.prefix.evict_lru(self._ref)
            if pid is None:
                break
            self._decref(pid)
            n += 1
        return n

    def rebuild(self, perm: np.ndarray, num_pages_new: int) -> "PoolSession":
        """Clone this allocator onto a remapped physical page space (live
        KV-precision repack resizes the pool at constant bytes).
        ``perm[old_pid] = new_pid`` for live pages, 0 for dead ones;
        refcounts, slot maps, the prefix cache and stats all carry over."""
        ns = PoolSession(num_pages_new, self.page_size, self.n_log,
                         prefix_sharing=self.prefix is not None)
        ref = np.zeros(num_pages_new + 1, np.int64)
        pins = np.zeros(num_pages_new + 1, np.int64)
        for old in range(1, self.num_pages + 1):
            if self._ref[old] > 0:
                new = int(perm[old])
                assert 1 <= new <= num_pages_new, (old, new, num_pages_new)
                ref[new] = self._ref[old]
                pins[new] = self._pins[old]
        ns._ref = ref
        ns._pins = pins
        ns._free = [pid for pid in range(num_pages_new, 0, -1)
                    if ref[pid] == 0]
        ns._slot_pages = {
            slot: [int(perm[pid]) for pid in pages]
            for slot, pages in self._slot_pages.items()}
        if self.prefix is not None:
            ns.prefix = self.prefix.remap(perm)
        ns.peak_pages = self.peak_pages
        ns.pid = self.pid
        ns.cow_copies = self.cow_copies
        ns.prefix_hits = self.prefix_hits
        ns.prefix_hit_tokens = self.prefix_hit_tokens
        ns.prompt_tokens = self.prompt_tokens
        ns.admitted = self.admitted
        ns.perm = np.asarray(perm)
        ns.check_invariants()
        return ns

    def check_invariants(self) -> None:
        """Debug/test hook: refcounts, free list and slot maps agree."""
        assert self._ref[0] == 0, "dump page must never be referenced"
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        for pid in range(1, self.num_pages + 1):
            if pid in free:
                assert self._ref[pid] == 0, (pid, self._ref[pid])
            else:
                assert self._ref[pid] > 0, (pid, self._ref[pid])
        held = np.zeros_like(self._ref)
        for pages in self._slot_pages.values():
            for pid in pages:
                held[pid] += 1
        if self.prefix is not None:
            for pid in self.prefix._lru.values():
                held[pid] += 1
        held += self._pins
        held[0] = 0
        assert np.array_equal(held, self._ref), (held, self._ref)
