"""Host-side paged KV-cache bookkeeping: ref-counted copy-on-write page
pool + page tables + an automatic prefix cache.

A copy of ``repro/serving/kv_cache.py`` (the original imports the null-page
id from the JAX kernel module; this one keeps its own).

The device-side KV pools (``transformer.init_paged_cache``) are plain tensors
[num_pages, page_size, KH, D]; this module decides *which* page ids a
sequence owns.  Page ids are layer-agnostic — one allocation covers every
layer's pool, so the free list is a single flat structure regardless of
depth.  Page 0 is reserved as the null page: empty decode slots point their
block-table rows at it and their garbage writes land there harmlessly.

Sharing model (vLLM-style, adapted to Horn's ensembles):

  * every page carries a **refcount** = number of live sequence tables that
    map it.  ``fork``/``adopt`` map an existing page into another table
    (refcount + 1) instead of copying; ``free_seq`` decrements.
  * **copy-on-write**: before a sequence writes K/V into a page it shares
    (refcount > 1, or a page the prefix cache still indexes), the engine
    calls ``prepare_write`` — the pool swaps in a fresh page and returns
    (src, dst) pairs for a device-side page copy.  The last writer left
    holding a page (refcount 1, unindexed) writes in place.
  * **prefix cache**: full pages are content-addressed by a rolling hash
    chained over their token block (``chain_hashes``); a ``PrefixCache``
    maps hash -> page and keeps an LRU of *evictable* pages — published
    pages whose refcount has dropped to zero.  Such pages hold their bytes
    until allocation pressure reclaims them, so an identical prompt prefix
    admitted later maps the same pages and skips its prefill
    (``match_prefix``).  Hashes are namespaced: K/V bytes depend on which
    circuit encoded the tokens, so a dense-parent page never answers a
    lookup for a masked sub-model's prefix (and vice versa).

Allocations carry an optional *owner* tag (the serving engine passes the
request's submodel id) so pool pressure is attributable: when G sub-models
share one pool, ``utilization_by_owner`` says which circuit is squeezing
it.  A page shared by several owners is attributed once, to the owner of
the earliest-registered sequence mapping it, so per-owner page counts sum
exactly to ``used_pages``.

Under the scheduler's ``reserve`` policy an ensemble member's tail pages
are promised at admission but only position-mapped when the member forks
off the shared prompt prefix; ``deferred`` credits account for that promise
so intervening admissions cannot steal the reserved pages.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

# page 0 is the null page of every pool (the same id the kernels' plain
# versions route dead block-table entries to)
NULL_PAGE = 0


class PagePoolOOM(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list
    (plus whatever the prefix cache can evict)."""


def kv_page_bytes(page_size: int, kv_heads: int, head_dim: int,
                  dtype: str = "bfloat16") -> int:
    """HBM bytes one K+V page pair costs per layer, including the int8
    scale sidecar (two f32 scalars per (page, kv-head): one for K, one
    for V).  The int8/bf16 ratio is the engine's effective capacity gain
    at equal HBM — ~2x for realistic page_size * head_dim (the 8-byte
    scale overhead per head is amortized over page_size * head_dim
    elements)."""
    elems = page_size * kv_heads * head_dim
    itemsize = {"int8": 1, "bfloat16": 2, "float16": 2, "float32": 4}
    per_pool = elems * itemsize[str(dtype)]
    sidecar = kv_heads * 4 if str(dtype) == "int8" else 0
    return 2 * (per_pool + sidecar)


def chain_hashes(namespace: bytes, tokens, page_size: int) -> List[bytes]:
    """Content ids for every FULL page of ``tokens``: hash i covers token
    block [i * page_size, (i+1) * page_size) *chained on the previous
    block's hash*, so a page's id pins the entire prefix behind it — two
    streams share hash i only if they agree on every token before
    (i+1) * page_size.  ``namespace`` seeds the chain: K/V bytes are a
    function of (tokens, encoder), so pages encoded by different circuits
    must never answer each other's lookups."""
    toks = np.asarray(tokens, np.int32)
    out: List[bytes] = []
    prev = hashlib.blake2b(namespace, digest_size=16).digest()
    for i in range(len(toks) // page_size):
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(toks[i * page_size:(i + 1) * page_size].tobytes())
        prev = h.digest()
        out.append(prev)
    return out


class PrefixCache:
    """Content index + LRU over immutable full pages.

    ``index`` maps content hash -> page id for every *published* page —
    live-referenced or not — so concurrent requests share pages that are
    still being decoded against.  Only pages whose refcount has dropped to
    zero sit in the ``lru`` (eviction order: least recently freed first);
    they keep their bytes until ``pop_evictable`` reclaims one for a fresh
    allocation."""

    def __init__(self) -> None:
        self.index: Dict[bytes, int] = {}        # hash -> page id
        self.lru: "OrderedDict[int, bytes]" = OrderedDict()  # evictable
        self.neg: set = set()   # chain-head hashes known cold (see match)
        self.hits = 0           # pages adopted from the index
        self.misses = 0         # adoptions whose lookup fell short
        self.neg_hits = 0       # walks short-circuited by the negative cache
        self.evictions = 0      # cached pages reclaimed for allocation
        self.inserts = 0

    @property
    def evictable(self) -> int:
        return len(self.lru)

    def stats(self) -> Dict[str, int]:
        """Lifetime counters + current index occupancy, for the telemetry
        snapshot (the engine's windowed eviction delta stays on the
        engine: these never reset)."""
        return {
            "indexed_pages": len(self.index),
            "evictable_pages": self.evictable,
            "hits": self.hits,
            "misses": self.misses,
            "neg_hits": self.neg_hits,
            "evictions": self.evictions,
            "inserts": self.inserts,
        }

    def match(self, hashes: Sequence[bytes], *,
              peek: bool = False) -> List[int]:
        """Longest indexed prefix of ``hashes`` -> page ids.  Chained
        hashes make prefix matching a linear walk: the first miss ends it.

        ``peek`` marks a feasibility probe (a blocked FCFS head replanning
        every tick): it must not distort the hit/miss statistics — those
        are committed once, on actual adoption, via ``commit_match``.
        Either way the walk consults (and feeds) the *negative cache*: a
        chain-head hash that missed is remembered as cold, so a blocked or
        cold-prompt request stops re-probing every tick; ``publish``
        invalidates the negative set (new pages may warm any prefix)."""
        if hashes and hashes[0] in self.neg:
            self.neg_hits += 1
            if not peek:               # a committed cold lookup is a miss
                self.commit_match(0, True)
            return []
        pages: List[int] = []
        for h in hashes:
            page = self.index.get(h)
            if page is None:
                break
            pages.append(page)
        if hashes and not pages:
            self.neg.add(hashes[0])      # known-cold until the next publish
        if not peek:
            self.commit_match(len(pages), len(pages) < len(hashes))
        return pages

    def commit_match(self, n_hit: int, missed: bool) -> None:
        """Fold one *adopted* lookup into the hit/miss statistics (peek
        probes are free — only admissions that actually map pages count)."""
        self.hits += n_hit
        if missed:
            self.misses += 1

    def publish(self, h: bytes, page: int) -> bool:
        """Index ``page`` under ``h``; no-op (False) when the hash is
        already indexed (a concurrent identical prefill got there first —
        the duplicate page simply stays anonymous and frees normally)."""
        if h in self.index:
            return False
        self.index[h] = page
        self.inserts += 1
        # a fresh page can warm any prefix whose walk previously went cold
        # at its chain head — the negative cache is only valid between
        # publishes, so drop it wholesale
        self.neg.clear()
        return True

    def release(self, page: int, h: bytes) -> None:
        """Page's refcount hit zero: hold it, most-recently-used."""
        self.lru[page] = h
        self.lru.move_to_end(page)

    def reacquire(self, page: int) -> None:
        """Page picked up by a live sequence again: no longer evictable."""
        self.lru.pop(page, None)

    def pop_evictable(self, pinned: frozenset = frozenset()) -> Optional[int]:
        """Reclaim the least-recently-freed evictable page (skipping
        ``pinned`` — pages an in-flight admission is about to adopt) and
        drop its index entry.  None when nothing can go."""
        for page, h in self.lru.items():
            if page not in pinned:
                del self.lru[page]
                del self.index[h]
                self.evictions += 1
                return page
        return None

    def forget(self, page: int, h: bytes) -> None:
        """Drop ``page`` from the index without reclaiming it (COW safety
        path: the bytes are about to be overwritten in place)."""
        self.lru.pop(page, None)
        if self.index.get(h) == page:
            del self.index[h]


class PagePool:
    """Fixed-size page pool: free list, per-sequence page tables, page
    refcounts, and (optionally) a prefix cache of retired full pages."""

    def __init__(self, num_pages: int, page_size: int, *,
                 prefix_cache: bool = False):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null page)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list, low ids first off the stack (page 0 never enters)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._tables: Dict[int, List[int]] = {}
        self._owners: Dict[int, Hashable] = {}      # seq_id -> owner tag
        self._ref: Dict[int, int] = {}              # page -> live table refs
        self._hash_of: Dict[int, bytes] = {}        # page -> published hash
        self._deferred: Dict[int, int] = {}         # seq_id -> promised pages
        self._version: Dict[int, int] = {}          # seq_id -> table mutations
        self.cache: Optional[PrefixCache] = PrefixCache() if prefix_cache \
            else None
        self.cow_copies = 0

    # -- accounting ---------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Allocatable pages (everything except the reserved null page)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        """Retired pages the prefix cache is holding (reclaimable)."""
        return self.cache.evictable if self.cache is not None else 0

    @property
    def used_pages(self) -> int:
        """Distinct pages mapped by at least one live sequence."""
        return self.capacity - len(self._free) - self.cached_pages

    @property
    def deferred_pages(self) -> int:
        """Pages promised to admitted sequences but not yet mapped."""
        return sum(self._deferred.values())

    def utilization(self) -> float:
        """Fraction of allocatable pages currently mapped by sequences
        (cache-held pages are reclaimable and do not count)."""
        return self.used_pages / self.capacity

    def pages_by_owner(self) -> Dict[Hashable, int]:
        """Distinct mapped pages per owner tag.  A page shared by several
        sequences counts once, for the owner of the earliest-registered
        sequence mapping it (deterministic: insertion order of ``alloc``),
        so values sum exactly to ``used_pages``."""
        out: Dict[Hashable, int] = {}
        seen: set = set()
        for seq_id, table in self._tables.items():   # insertion-ordered
            owner = self._owners.get(seq_id)
            n = 0
            for p in table:
                if p not in seen:
                    seen.add(p)
                    n += 1
            if n or owner not in out:
                out[owner] = out.get(owner, 0) + n
        return out

    def utilization_by_owner(self) -> Dict[Hashable, float]:
        """Per-owner fraction of allocatable pages: integer page counts
        per owner (``pages_by_owner``) divided once by ``capacity``."""
        return {o: n / self.capacity for o, n in self.pages_by_owner().items()}

    def stats(self) -> Dict[str, object]:
        """Point-in-time occupancy snapshot for the telemetry layer (the
        `pool` block of ``Engine.metrics()`` and the Perfetto counter
        track)."""
        return {
            "capacity": self.capacity,
            "used_pages": self.used_pages,
            "free_pages": self.free_pages,
            "cached_pages": self.cached_pages,
            "deferred_pages": self.deferred_pages,
            "utilization": self.utilization(),
            "cow_copies": self.cow_copies,
            "live_seqs": len(self._tables),
            "pages_by_owner": dict(self.pages_by_owner()),
        }

    def live_table_pages(self) -> int:
        """Distinct pages actually referenced by live sequence tables —
        the ground-truth counterpart of the ``used_pages`` accounting
        identity (capacity - free - cached).  COW/fork shares count
        once.  The two disagree only when pages left the free list but
        no live table can reach them (deferred credits keep their pages
        ON the free list until redeemed, so promises don't skew this):
        the pool-leak watchdog's signal.  Walks every table, so callers
        sample it every N ticks rather than every tick."""
        seen: set = set()
        for table in self._tables.values():
            seen.update(table)
        return len(seen)

    def pages_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)       # ceil div

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def table_version(self, seq_id: int) -> int:
        """Bumped on every mutation of ``seq_id``'s table (page appended,
        adopted, or COW-swapped) — cheap dirtiness key for block-table
        row sync."""
        return self._version[self._known(seq_id)]

    # -- internal plumbing --------------------------------------------------
    def _known(self, seq_id: int) -> int:
        if seq_id not in self._tables:
            raise ValueError(
                f"sequence {seq_id} is not allocated in this pool (never "
                f"registered, or already freed — double free?); live "
                f"sequences: {sorted(self._tables)[:8]}"
                f"{'...' if len(self._tables) > 8 else ''}")
        return seq_id

    def allocatable(self, *, pinned: frozenset = frozenset()) -> int:
        """Pages a NEW allocation could draw on right now: the free list
        plus evictable cached pages (minus any an in-flight admission has
        pinned), minus pages already promised to other sequences."""
        evictable = 0
        if self.cache is not None:       # O(|pinned|), not O(cached pages)
            evictable = self.cache.evictable \
                - sum(1 for p in pinned if p in self.cache.lru)
        return len(self._free) + evictable - self.deferred_pages

    def can_alloc(self, n_pages: int, *,
                  pinned: frozenset = frozenset()) -> bool:
        return self.allocatable(pinned=pinned) >= n_pages

    def _take(self, seq_id: int, pinned: frozenset = frozenset()) -> int:
        """One physical page off the free list (evicting from the prefix
        cache when the list is dry), honoring deferred credits: a sequence
        with promised pages consumes its own promise first; anyone else
        must leave the promised pages untouched."""
        credit = self._deferred.get(seq_id, 0)
        if credit:
            self._deferred[seq_id] = credit - 1
        elif self.allocatable(pinned=pinned) < 1:
            raise PagePoolOOM(
                f"page pool exhausted: seq {seq_id} needs 1 more page, "
                f"{len(self._free)} free + {self.cached_pages} cached of "
                f"{self.capacity} with {self.deferred_pages} promised "
                f"({self.utilization():.0%} utilized)")
        if self._free:
            return self._free.pop()
        page = self.cache.pop_evictable(pinned) if self.cache else None
        if page is None:                 # credit promised more than exists
            raise PagePoolOOM(
                f"page pool exhausted: seq {seq_id} holds an unredeemable "
                f"page promise ({len(self._free)} free, "
                f"{self.cached_pages} cached)")
        self._hash_of.pop(page, None)
        return page

    def _retire(self, page: int) -> None:
        """Page's last reference is gone: park it in the prefix cache when
        it is published (its bytes may serve a future prefix match), else
        return it to the free list."""
        h = self._hash_of.get(page)
        if self.cache is not None and h is not None:
            self.cache.release(page, h)
        else:
            self._hash_of.pop(page, None)
            self._free.append(page)

    def _map(self, seq_id: int, page: int) -> None:
        self._tables[seq_id].append(page)
        self._ref[page] = self._ref.get(page, 0) + 1
        self._version[seq_id] += 1

    # -- allocation ---------------------------------------------------------
    def alloc(self, seq_id: int, num_tokens: int,
              owner: Optional[Hashable] = None) -> List[int]:
        """Register ``seq_id`` and allocate pages for its first
        ``num_tokens`` tokens.  Returns the page table (a live view)."""
        self.alloc_pages(seq_id, self.pages_for(num_tokens), owner=owner)
        return self._tables[seq_id]

    def alloc_pages(self, seq_id: int, n_pages: int,
                    owner: Optional[Hashable] = None, *,
                    cached: Sequence[int] = (), deferred: int = 0
                    ) -> List[int]:
        """Register ``seq_id``: adopt ``cached`` pages (a ``match_prefix``
        result — mapped first, in order, refcount + 1 each), then allocate
        ``n_pages`` fresh pages, then promise ``deferred`` more for later
        (``reserve``-policy ensemble tails).  Atomic: on OOM nothing is
        registered.  Returns the page table (a live view)."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already allocated")
        pinned = frozenset(cached)
        if self.allocatable(pinned=pinned) < n_pages + deferred:
            raise PagePoolOOM(
                f"page pool exhausted: seq {seq_id} needs {n_pages} page(s) "
                f"+ {deferred} promised at admission, {len(self._free)} free "
                f"+ {self.cached_pages} cached of {self.capacity} with "
                f"{self.deferred_pages} already promised "
                f"({self.utilization():.0%} utilized)")
        self._tables[seq_id] = []
        self._owners[seq_id] = owner
        self._version[seq_id] = 0
        for page in cached:
            if self._ref.get(page, 0) == 0 and self.cache is not None:
                self.cache.reacquire(page)
            self._map(seq_id, page)
        for _ in range(n_pages):
            self._map(seq_id, self._take(seq_id, pinned))
        if deferred:
            self._deferred[seq_id] = deferred
        return self._tables[seq_id]

    def ensure(self, seq_id: int, num_tokens: int) -> List[int]:
        """Grow ``seq_id``'s table to cover ``num_tokens`` tokens, pulling
        pages from the free list (or the prefix cache's LRU) on demand.
        Raises PagePoolOOM (leaving the existing allocation intact) when
        the pool is exhausted."""
        table = self._tables[self._known(seq_id)]
        need = self.pages_for(num_tokens) - len(table)
        credit = self._deferred.get(seq_id, 0)
        if need - credit > self.allocatable():
            raise PagePoolOOM(
                f"page pool exhausted: seq {seq_id} needs {need} more "
                f"page(s), {len(self._free)} free + {self.cached_pages} "
                f"cached of {self.capacity} with {self.deferred_pages} "
                f"promised ({self.utilization():.0%} utilized)")
        for _ in range(max(0, need)):
            self._map(seq_id, self._take(seq_id))
        return table

    def fork(self, src_seq: int, dst_seq: int,
             owner: Optional[Hashable] = None, *,
             num_pages: Optional[int] = None) -> List[int]:
        """Map the first ``num_pages`` pages (default: all) of ``src_seq``
        into a fresh table for ``dst_seq`` — refcount + 1 per page, no
        copy.  Writes into shared pages go through ``prepare_write``."""
        src = self._tables[self._known(src_seq)]
        shared = src[:len(src) if num_pages is None else num_pages]
        return self.alloc_pages(dst_seq, 0, owner=owner, cached=shared)

    def adopt_prefix(self, seq_id: int, pages: Sequence[int]) -> None:
        """Prepend already-materialized shared pages to ``seq_id``'s table
        (refcount + 1 each) — the ensemble-member fork for a sequence that
        was registered page-less at admission.  The table must still be
        empty: adopted pages cover positions [0, len * page_size)."""
        table = self._tables[self._known(seq_id)]
        if table:
            raise ValueError(
                f"sequence {seq_id} already maps {len(table)} page(s); "
                f"prefix adoption must precede its own allocations")
        for page in pages:
            if self._ref.get(page, 0) == 0 and self.cache is not None:
                self.cache.reacquire(page)
            self._map(seq_id, page)

    # -- copy-on-write ------------------------------------------------------
    def prepare_write(self, seq_id: int, first_token: int,
                      last_token: int) -> List[Tuple[int, int]]:
        """Make the pages covering token positions [first_token,
        last_token) privately writable by ``seq_id``: any page shared with
        another table (refcount > 1) is COW-swapped for a fresh page and
        the (src, dst) pair returned so the caller can issue the device
        copy; a page the prefix cache still indexes (refcount 1) is simply
        un-published — its bytes are about to change in place.  Raises
        PagePoolOOM when no fresh page can back a needed copy."""
        table = self._tables[self._known(seq_id)]
        pairs: List[Tuple[int, int]] = []
        lo = first_token // self.page_size
        hi = self.pages_for(last_token)
        for i in range(lo, min(hi, len(table))):
            page = table[i]
            if self._ref.get(page, 0) > 1:
                fresh = self._take(seq_id)
                self._ref[page] -= 1
                table[i] = fresh
                self._ref[fresh] = self._ref.get(fresh, 0) + 1
                self._version[seq_id] += 1
                pairs.append((page, fresh))
                self.cow_copies += 1
            elif self.cache is not None and page in self._hash_of:
                self.cache.forget(page, self._hash_of.pop(page))
        return pairs

    # -- prefix cache -------------------------------------------------------
    def match_pages(self, hashes: Sequence[bytes], *,
                    peek: bool = False) -> List[int]:
        """Longest content-indexed prefix of ``hashes`` -> page ids (empty
        when the pool runs without a prefix cache).  ``peek`` marks a
        feasibility probe that must not count toward hit/miss stats."""
        if self.cache is None:
            return []
        return self.cache.match(hashes, peek=peek)

    def commit_match(self, n_hit: int, missed: bool) -> None:
        """Commit one adopted lookup's hit/miss statistics (the peek
        probes that sized it were free)."""
        if self.cache is not None:
            self.cache.commit_match(n_hit, missed)

    def match_prefix(self, namespace: bytes, tokens,
                     max_tokens: Optional[int] = None
                     ) -> Tuple[List[int], int]:
        """Longest cached page-prefix of ``tokens`` under ``namespace``:
        (page ids, tokens they cover).  ``max_tokens`` caps the match (a
        fresh request must recompute at least its last prompt token — the
        chunk that completes prefill yields the first sampled token)."""
        if self.cache is None:
            return [], 0
        toks = np.asarray(tokens, np.int32)
        n = len(toks) if max_tokens is None else min(len(toks), max_tokens)
        hashes = chain_hashes(namespace, toks[:n - n % self.page_size],
                              self.page_size)
        pages = self.cache.match(hashes)
        return pages, len(pages) * self.page_size

    def publish_prefix(self, seq_id: int, hashes: Sequence[bytes],
                       num_pages: int) -> int:
        """Content-index the first ``num_pages`` pages of ``seq_id``'s
        table under ``hashes`` (their chained content ids) once their K/V
        is fully materialized.  Already-published pages (adopted via a
        prefix match) and hash collisions with a concurrent identical
        prefill are skipped.  Returns pages newly indexed."""
        if self.cache is None:
            return 0
        table = self._tables[self._known(seq_id)]
        new = 0
        for i in range(min(num_pages, len(hashes), len(table))):
            page = table[i]
            if page in self._hash_of:
                continue
            if self.cache.publish(hashes[i], page):
                self._hash_of[page] = hashes[i]
                new += 1
        return new

    def truncate_seq(self, seq_id: int, num_tokens: int, *,
                     recredit: bool = False) -> int:
        """Drop ``seq_id``'s page references beyond the pages covering its
        first ``num_tokens`` tokens — the speculative-decode rollback: a
        rejected draft tail is a ref-release, not a copy.  Shared pages
        survive under their other holders; exclusive pages return to the
        free list (or the prefix cache when published).  ``recredit`` turns
        each physically reclaimed page into a deferred credit for
        ``seq_id`` (reserve-policy engines: the reservation made at
        admission must survive the rollback, or a later re-grow could OOM
        against pages another admission took in between).  Returns pages
        released."""
        table = self._tables[self._known(seq_id)]
        keep = self.pages_for(num_tokens)
        dropped = 0
        while len(table) > keep:
            page = table.pop()
            self._ref[page] -= 1
            if self._ref[page] == 0:
                del self._ref[page]
                self._retire(page)
                if recredit:
                    self._deferred[seq_id] = \
                        self._deferred.get(seq_id, 0) + 1
            dropped += 1
        if dropped:
            self._version[seq_id] += 1
        return dropped

    # -- release ------------------------------------------------------------
    def free_seq(self, seq_id: int) -> int:
        """Drop all of ``seq_id``'s page references: each page's refcount
        falls by one, and pages nobody maps anymore return to the free
        list — or, when published in the prefix cache, are held there
        (evictable) so their bytes can serve future prefix matches.
        Raises a descriptive ValueError on an unknown or already-freed
        ``seq_id`` (an overlapping preempt/finish double free must surface
        loudly, not as silent refcount corruption)."""
        table = self._tables.pop(self._known(seq_id))
        self._owners.pop(seq_id, None)
        self._deferred.pop(seq_id, None)
        self._version.pop(seq_id, None)
        for page in reversed(table):
            self._ref[page] -= 1
            if self._ref[page] == 0:
                del self._ref[page]
                self._retire(page)
        return len(table)

    def table(self, seq_id: int) -> List[int]:
        return list(self._tables[self._known(seq_id)])

    @property
    def num_seqs(self) -> int:
        return len(self._tables)

    # -- invariants (exercised by tests) ------------------------------------
    def check_invariants(self) -> None:
        refs: Dict[int, int] = {}
        for seq_id, t in self._tables.items():
            assert len(set(t)) == len(t), \
                f"seq {seq_id} maps a page twice: {t}"
            for p in t:
                refs[p] = refs.get(p, 0) + 1
        assert NULL_PAGE not in refs, "null page mapped by a sequence"
        assert NULL_PAGE not in self._free, "null page on the free list"
        assert refs == self._ref, \
            f"refcounts out of sync with tables: {self._ref} != {refs}"
        overlap = set(refs) & set(self._free)
        assert not overlap, f"pages both free and mapped: {overlap}"
        cached = set()
        if self.cache is not None:
            cached = set(self.cache.lru)
            assert not cached & set(refs), \
                "cache-held (evictable) page still mapped by a live seq"
            assert not cached & set(self._free), \
                "cache-held page also on the free list"
            for h, p in self.cache.index.items():
                assert self._hash_of.get(p) == h, \
                    f"index entry {p} disagrees with page hash registry"
            for p, h in self.cache.lru.items():
                assert self.cache.index.get(h) == p, \
                    f"evictable page {p} not content-indexed"
            assert not self.cache.neg & set(self.cache.index), \
                "negative-cache entry for an indexed chain head"
        for p in self._hash_of:
            assert p in refs or p in cached, \
                f"published page {p} neither mapped nor cache-held"
        assert len(refs) + len(self._free) + len(cached) \
            == self.num_pages - 1, "pages leaked or duplicated"
        assert set(self._owners) == set(self._tables), \
            "owner registry out of sync with page tables"
        assert set(self._version) == set(self._tables), \
            "version registry out of sync with page tables"
        assert all(v >= 0 for v in self._deferred.values())
        assert set(self._deferred) <= set(self._tables), \
            "deferred credit for a dead sequence"
        assert self.deferred_pages <= len(self._free) + len(cached), \
            "more pages promised than physically reclaimable"
        by_owner = self.pages_by_owner()
        assert sum(by_owner.values()) == self.used_pages, \
            f"per-owner page counts {by_owner} do not sum to used_pages"
