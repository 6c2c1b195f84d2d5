"""Paged KV cache: block arena, page tables, and shared-prefix reuse
(counterpart of ``repro/serve/kvcache.py``, copied near verbatim: the
allocator and prefix index are pure Python).

ONE fixed arena of ``(n_layers, n_blocks + 1, block_size, ...)`` KV pages
for the engine's lifetime, carved into ``block_size``-token blocks that
requests borrow on demand:

  * ``BlockAllocator`` — host-side block accounting.  Lowest-free-first
    allocation (deterministic), split refcounts (``req_rc`` live request
    holders vs ``cache_rc`` prefix-cache entries), and a reservation
    ledger so admission can promise a request its worst-case growth up
    front while the physical blocks are still handed out lazily.
  * ``PrefixCache`` — hash-keyed shared-prefix index.  After a prompt is
    prefilled, every full-block prefix of it is registered; a later
    request whose prompt starts with the same tokens *shares* those
    blocks instead of re-prefilling them.  Sharing is restricted to
    immutable full blocks, so copy-on-write degenerates to share-only.
  * ``KVCachePool`` — the arena + row slots + per-request block lists
    (page tables).  Logical position ``p`` of a request lives in its
    table's block ``p // block_size`` at offset ``p % block_size``.

The arena is torch tensors on the model's device, and the engine's steps
update them IN PLACE (``models.attention.paged_chunk_attn`` writes the new
K/V into the pages it is given); the JAX package instead donates and
replaces its arrays every step.

Physical block 0 is the NULL block: never allocated, the write/read
target for idle rows and unallocated table slots.  Its ``pos`` map stays
all ``-1``, so every gather through it is masked out of attention.
"""

from __future__ import annotations

import heapq
from collections import OrderedDict

#: Physical block id reserved as the masked-out null target.
NULL_BLOCK = 0


class BlockAllocator:
    """Host-side accounting for ``n_blocks`` usable KV pages (ids
    ``1..n_blocks``; 0 is the null block and is never handed out).

    Each block carries two refcounts: ``req_rc`` (live requests holding
    it in their page table) and ``cache_rc`` (prefix-cache entries
    covering it).  A block returns to the free heap exactly when both
    hit zero.  ``reserve``/``unreserve`` maintain a ledger of blocks
    promised to admitted requests but not yet physically allocated, so
    ``available`` is the admission-safe headroom.
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 1:
            raise ValueError(f"need at least 1 block, got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self._free = list(range(1, self.n_blocks + 1))
        heapq.heapify(self._free)
        self._req_rc: dict = {}
        self._cache_rc: dict = {}
        self.reserved = 0
        # freed-page log: the engine drains this before each step
        # and resets those pages' ``pos`` maps to -1 — a reused page must
        # not leak its previous occupant's valid positions into gathers
        self.freed_log: list = []

    # --- queries ------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        """Blocks currently held by at least one request or cache entry."""
        return self.n_blocks - len(self._free)

    @property
    def available(self) -> int:
        """Free blocks not yet promised to an admitted request."""
        return len(self._free) - self.reserved

    def req_rc(self, bid: int) -> int:
        return self._req_rc.get(bid, 0)

    def cache_rc(self, bid: int) -> int:
        return self._cache_rc.get(bid, 0)

    # --- lifecycle ----------------------------------------------------------
    def alloc(self) -> int:
        """Hand out the lowest free block with ``req_rc = 1``."""
        if not self._free:
            raise RuntimeError(
                f"block pool exhausted ({self.n_blocks} blocks live)")
        bid = heapq.heappop(self._free)
        self._req_rc[bid] = 1
        return bid

    def share(self, bid: int) -> None:
        """One more live request holds ``bid`` (prefix hit)."""
        if self._req_rc.get(bid, 0) + self._cache_rc.get(bid, 0) <= 0:
            raise KeyError(f"block {bid} is not live")
        self._req_rc[bid] = self._req_rc.get(bid, 0) + 1

    def release(self, bid: int) -> bool:
        """Drop one request hold; True if the block went back to the
        free heap (no remaining holders of either kind)."""
        rc = self._req_rc.get(bid, 0)
        if rc <= 0:
            raise KeyError(f"double free of block {bid}")
        self._req_rc[bid] = rc - 1
        return self._maybe_free(bid)

    def cache_hold(self, bid: int) -> None:
        if self._req_rc.get(bid, 0) + self._cache_rc.get(bid, 0) <= 0:
            raise KeyError(f"block {bid} is not live")
        self._cache_rc[bid] = self._cache_rc.get(bid, 0) + 1

    def cache_drop(self, bid: int) -> bool:
        rc = self._cache_rc.get(bid, 0)
        if rc <= 0:
            raise KeyError(f"cache double-drop of block {bid}")
        self._cache_rc[bid] = rc - 1
        return self._maybe_free(bid)

    def _maybe_free(self, bid: int) -> bool:
        if self._req_rc.get(bid, 0) == 0 and self._cache_rc.get(bid, 0) == 0:
            self._req_rc.pop(bid, None)
            self._cache_rc.pop(bid, None)
            heapq.heappush(self._free, bid)
            self.freed_log.append(bid)
            return True
        return False

    # --- reservation ledger -------------------------------------------------
    def reserve(self, n: int) -> None:
        if n < 0:
            raise ValueError(f"cannot reserve {n} blocks")
        self.reserved += n

    def unreserve(self, n: int) -> None:
        if n < 0 or n > self.reserved:
            raise ValueError(
                f"unreserve({n}) with only {self.reserved} reserved")
        self.reserved -= n

    def check(self) -> None:
        """Invariant audit (the property tests call this after every op):
        every id is exactly free xor refcounted, counts conserve."""
        free = set(self._free)
        assert len(free) == len(self._free), "free heap holds duplicates"
        for bid in free:
            assert 1 <= bid <= self.n_blocks, f"foreign block {bid} freed"
            assert self._req_rc.get(bid, 0) == 0, f"block {bid} free+held"
            assert self._cache_rc.get(bid, 0) == 0, f"block {bid} free+cached"
        live = {b for b, rc in self._req_rc.items() if rc > 0} | \
               {b for b, rc in self._cache_rc.items() if rc > 0}
        assert not (live & free), "block both live and free"
        assert len(live) + len(free) == self.n_blocks, "blocks leaked"
        assert 0 <= self.reserved, "negative reservation ledger"


class PrefixCache:
    """Hash-keyed index of computed full-block prompt prefixes.

    Keys are token tuples whose length is a multiple of ``block_size``;
    the value is the tuple of physical blocks holding their K/V.  Every
    entry holds a ``cache_rc`` on each of its blocks, so the K/V survive
    the computing request's release.  Entries are kept in LRU order;
    ``evict`` refuses while any of the entry's blocks has a live request
    holder, and ``evict_lru`` (allocation-pressure path) only ever takes
    entries with no live holders.
    """

    def __init__(self, alloc: BlockAllocator):
        self.alloc = alloc
        self.block_size = alloc.block_size
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self):
        return list(self._entries)

    def lookup(self, prompt, max_blocks: int):
        """Longest cached prefix of ``prompt``, at most ``max_blocks``
        blocks.  Returns the block-id tuple (possibly empty).  Does NOT
        take references — the pool shares the blocks on admission."""
        prompt = tuple(prompt)
        best = ()
        for i in range(min(len(prompt) // self.block_size, max_blocks), 0, -1):
            key = prompt[:i * self.block_size]
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                best = hit
                break
        if best:
            self.hits += 1
        else:
            self.misses += 1
        return best

    def insert(self, prompt, blocks) -> int:
        """Register every full-block prefix of ``prompt`` backed by
        ``blocks`` (the holder's leading page-table entries).  Returns
        the number of NEW entries."""
        prompt, blocks = tuple(prompt), tuple(blocks)
        n_full = min(len(prompt) // self.block_size, len(blocks))
        added = 0
        for i in range(1, n_full + 1):
            key = prompt[:i * self.block_size]
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            entry = blocks[:i]
            for bid in entry:
                self.alloc.cache_hold(bid)
            self._entries[key] = entry
            added += 1
        return added

    def holders(self, key) -> int:
        """Live request holds on the entry's last (deepest) block — the
        number of requests still reading through this prefix."""
        entry = self._entries[tuple(key)]
        return max(self.alloc.req_rc(b) for b in entry)

    def evict(self, key) -> int:
        """Drop one entry; refused (RuntimeError) while any of its
        blocks is held by a live request.  Returns blocks freed."""
        key = tuple(key)
        entry = self._entries.get(key)
        if entry is None:
            raise KeyError("prefix not cached")
        held = [b for b in entry if self.alloc.req_rc(b) > 0]
        if held:
            raise RuntimeError(
                f"prefix eviction refused: blocks {held} still held by "
                "live requests")
        del self._entries[key]
        return sum(self.alloc.cache_drop(b) for b in entry)

    def evict_lru(self, n_needed: int) -> int:
        """Free >= ``n_needed`` blocks by evicting oldest entries with no
        live holders.  Returns blocks actually freed (may fall short)."""
        freed = 0
        for key in list(self._entries):
            if freed >= n_needed:
                break
            entry = self._entries[key]
            if any(self.alloc.req_rc(b) > 0 for b in entry):
                continue
            freed += self.evict(key)
        return freed

    @property
    def evictable_blocks(self) -> int:
        """Blocks that evicting every holder-free entry would free.

        A block frees only when its ``cache_rc`` hits zero, i.e. every
        entry covering it is gone — and ``evict_lru`` refuses any entry
        with a live-held block ANYWHERE in it.  So a block counts only
        if no covering entry is pinned; counting per-block ``req_rc``
        alone overstates headroom and lets ``can_admit`` admit requests
        that then crash in ``alloc``.
        """
        pinned: set = set()
        for entry in self._entries.values():
            if any(self.alloc.req_rc(b) > 0 for b in entry):
                pinned.update(entry)
        seen, n = set(), 0
        for entry in self._entries.values():
            for b in entry:
                if b in seen or b in pinned:
                    continue
                seen.add(b)
                n += 1
        return n


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _leaves(tree) -> list:
    """The tensors of a nested dict, depth first."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


class KVCachePool:
    """Paged KV-cache pool: fixed block arena + page-table bookkeeping.

    The arena (a dict of tensors) lives in ``self.cache``; every leaf has the
    layer-stacked paged layout ``(n_layers, n_blocks + 1, block_size,
    ...)`` (slot 0 = null block).  ``max_batch`` decode rows and
    ``max_len`` logical tokens per request are unchanged from the slab
    pool; ``max_len`` must divide into whole blocks (checked HERE, at
    construction — not on first alloc).  The default arena
    (``n_blocks = max_batch * max_len / block_size``) has exactly the
    slab pool's capacity; pass a smaller ``n_blocks`` to overcommit
    (admission then reasons about free *blocks*, not free rows).  On a
    mesh (``mesh``, ``dims``) the arena holds this rank's kv heads
    (``Model.init_cache``); every rank keeps the same page tables, so the
    block accounting is the one-rank pool's.
    """

    def __init__(self, model, max_batch: int, max_len: int, dtype=None, *,
                 block_size: int = 32, n_blocks=None,
                 prefix_cache: bool = True, mesh=None, dims=None):
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.block_size = int(min(block_size, self.max_len))
        if self.max_len % self.block_size:
            raise ValueError(
                f"max_len {self.max_len} is not divisible by block_size "
                f"{self.block_size}")
        self.max_blocks = self.max_len // self.block_size
        if n_blocks is None:
            n_blocks = self.max_batch * self.max_blocks
        self.n_blocks = int(n_blocks)
        # +1: physical slot 0 is the never-allocated null block
        self.cache = model.init_cache(self.n_blocks + 1, self.block_size,
                                      dtype, mesh=mesh, dims=dims)
        self._validate_leaves()
        self.alloc_blocks = BlockAllocator(self.n_blocks, self.block_size)
        self.prefix = PrefixCache(self.alloc_blocks) if prefix_cache else None
        self._row_free = list(range(self.max_batch))
        heapq.heapify(self._row_free)
        self._row_of: dict = {}       # rid -> decode row
        self._table: dict = {}        # rid -> [block ids]
        self._shared: dict = {}       # rid -> leading shared block count
        self._resv: dict = {}         # rid -> blocks still reserved

    def _validate_leaves(self):
        """Leaf-shape audit — runs for EVERY construction, including
        dtype-overridden caches."""
        want = self.n_blocks + 1
        for leaf in _leaves(self.cache):
            if leaf.ndim < 2 or leaf.shape[1] != want:
                raise ValueError(
                    "KVCachePool needs every cache leaf shaped "
                    f"(layers, n_blocks + 1, ...) = (*, {want}, ...); "
                    f"got {leaf.shape}")
            if leaf.ndim >= 3 and leaf.shape[2] != self.block_size:
                raise ValueError(
                    f"cache leaf {leaf.shape} does not use block_size "
                    f"{self.block_size} pages")

    # --- admission control ---------------------------------------------------
    @property
    def n_free(self) -> int:
        """Free decode rows (the slab pool's admission quantity)."""
        return len(self._row_free)

    @property
    def n_live(self) -> int:
        return len(self._row_of)

    @property
    def n_free_blocks(self) -> int:
        return self.alloc_blocks.n_free

    def occupancy(self) -> float:
        """Fraction of arena blocks currently live."""
        return self.alloc_blocks.n_live / max(self.n_blocks, 1)

    def blocks_needed(self, prompt_len: int, max_new: int) -> int:
        return _ceil_div(min(prompt_len + max_new, self.max_len),
                         self.block_size)

    def can_admit(self, prompt_len: int = 1, max_new: int = 0) -> bool:
        """A free row AND enough unpromised blocks for the request's
        worst case (free + evictable holder-free prefix entries,
        minus what other live requests may still claim)."""
        if not self._row_free:
            return False
        need = self.blocks_needed(prompt_len, max_new)
        head = self.alloc_blocks.available
        if self.prefix is not None:
            head += self.prefix.evictable_blocks
        return head >= need

    # --- request lifecycle ---------------------------------------------------
    def alloc(self, rid, prompt=(), max_new: int = 0):
        """Admit ``rid``: assign the lowest free row, share the longest
        cached prefix of ``prompt`` (full blocks only, capped so at
        least one prompt token is left to prefill), and reserve the
        request's worst-case remaining block growth.

        Returns ``(row, n_shared_tokens)``.
        """
        if rid in self._row_of:
            raise KeyError(f"request {rid!r} already holds row "
                           f"{self._row_of[rid]}")
        if not self._row_free:
            raise RuntimeError(
                f"KV-cache pool exhausted ({self.max_batch} rows live)")
        prompt = tuple(prompt)
        need = self.blocks_needed(max(len(prompt), 1), max_new)
        shared: tuple = ()
        if self.prefix is not None and len(prompt) > 1:
            # cap: the final prompt token is always prefilled, so there
            # is a position to sample the first generated token from
            shared = self.prefix.lookup(prompt,
                                        (len(prompt) - 1) // self.block_size)
        # can_admit's exact headroom bound, measured BEFORE this request
        # pins anything.  Sharing-path success implies it (sharing m
        # blocks removes >= m from the evictable count), so when it
        # fails we can refuse up front without evicting anything.
        evictable0 = 0 if self.prefix is None else \
            self.prefix.evictable_blocks
        if self.alloc_blocks.available + evictable0 < need:
            raise RuntimeError(
                f"KV-cache pool exhausted: request needs {need} blocks, "
                f"{self.alloc_blocks.available} available "
                f"(+{evictable0} evictable)")
        # Hold the matched blocks BEFORE any eviction: evict_lru skips
        # entries with live request holders, so this pins the hit —
        # otherwise pressure-eviction below could free the (holder-free)
        # entry we just matched and share() would KeyError.
        for bid in shared:
            self.alloc_blocks.share(bid)
        private_need = need - len(shared)
        if self.alloc_blocks.available < private_need:
            self.prefix.evict_lru(
                private_need - self.alloc_blocks.available)
            # re-check available alone: freed blocks already returned to
            # the free heap, adding evict_lru's count would double-count
            if self.alloc_blocks.available < private_need:
                # Sharing pinned every entry touching the matched blocks
                # (longer prefixes of the same chain), which may be the
                # only remaining evictable headroom.  Give the hit back
                # and retry share-free — the feasibility bound above
                # guarantees this path succeeds, so alloc admits in
                # exactly the states can_admit approves.
                for bid in shared:
                    self.alloc_blocks.release(bid)
                if shared:
                    self.prefix.hits -= 1
                    self.prefix.misses += 1
                shared = ()
                private_need = need
                self.prefix.evict_lru(
                    need - self.alloc_blocks.available)
                if self.alloc_blocks.available < need:
                    raise RuntimeError(
                        f"KV-cache pool exhausted: request needs "
                        f"{need} blocks, "
                        f"{self.alloc_blocks.available} available")
        self.alloc_blocks.reserve(private_need)
        row = heapq.heappop(self._row_free)
        self._row_of[rid] = row
        self._table[rid] = list(shared)
        self._shared[rid] = len(shared)
        self._resv[rid] = private_need
        return row, len(shared) * self.block_size

    def ensure(self, rid, pos: int) -> None:
        """Grow ``rid``'s page table (on demand, from its reservation)
        until logical position ``pos`` has a physical block."""
        if pos >= self.max_len:
            raise ValueError(f"position {pos} beyond max_len {self.max_len}")
        table = self._table[rid]
        while len(table) * self.block_size <= pos:
            if self._resv[rid] <= 0:
                raise RuntimeError(
                    f"request {rid!r} grew past its reservation")
            if self.alloc_blocks.n_free == 0 and self.prefix is not None:
                self.prefix.evict_lru(1)
            table.append(self.alloc_blocks.alloc())
            self._resv[rid] -= 1
            self.alloc_blocks.unreserve(1)

    def commit_prefix(self, rid, prompt) -> int:
        """Register ``rid``'s freshly prefilled prompt (full blocks
        only) in the prefix cache.  Returns new entries added."""
        if self.prefix is None:
            return 0
        prompt = tuple(prompt)
        n_full = min(len(prompt) // self.block_size,
                     len(self._table[rid]))
        if n_full == 0:
            return 0
        return self.prefix.insert(prompt, self._table[rid][:n_full])

    def release(self, rid) -> int:
        """Finish/cancel: free the row, drop one hold on every block of
        the page table, and return the unused reservation."""
        if rid not in self._row_of:
            raise KeyError(f"request {rid!r} holds no row")
        row = self._row_of.pop(rid)
        heapq.heappush(self._row_free, row)
        for bid in self._table.pop(rid):
            self.alloc_blocks.release(bid)
        self.alloc_blocks.unreserve(self._resv.pop(rid))
        self._shared.pop(rid, None)
        return row

    def drain_freed(self) -> list:
        """Pages freed since the last drain (engine: reset their ``pos``
        maps before the next step touches the arena)."""
        freed, self.alloc_blocks.freed_log = \
            self.alloc_blocks.freed_log, []
        return freed

    # --- views ---------------------------------------------------------------
    def row_of(self, rid) -> int:
        return self._row_of[rid]

    # old slab-pool name, kept for API continuity
    slot_of = row_of

    def table_of(self, rid) -> list:
        return list(self._table[rid])

    def shared_blocks(self, rid) -> int:
        return self._shared.get(rid, 0)

    def live(self) -> dict:
        """Snapshot of the request -> row map."""
        return dict(self._row_of)

    def block_tables(self):
        """The engine steps' ``(max_batch, max_blocks)`` int32 gather
        table: row r's logical block i -> physical arena slot.  Idle
        rows and unallocated slots point at the null block (0)."""
        import numpy as np
        tables = np.zeros((self.max_batch, self.max_blocks), np.int32)
        for rid, row in self._row_of.items():
            t = self._table[rid]
            tables[row, :len(t)] = t
        return tables
