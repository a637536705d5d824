"""Radix prefix cache over the block pool: copy-on-write page sharing
for shared-prefix serving traffic (the vLLM/SGLang prefix-caching idea
on :mod:`veles_tpu_torch.gen.paged`).

Counterpart of :mod:`veles_tpu.gen.prefix`, copied as it is (pure
Python).  The pool's sorted-free-list determinism makes a FULL page's
K/V a pure function of (a) the token prefix up to and including the
page and (b) the prefill program that wrote it: causal attention keeps
later tokens out of earlier positions' K/V, and identical programs round
identically.  So a radix tree keyed by ``block_size``-token page keys
can hand an already-written physical page to a NEW admission of the
same prefix: the adopting slot's block table points at the shared page
(the pool increfs it), only the unshared suffix allocates fresh pages,
and nobody ever writes a shared page (``BlockPool.admit`` keeps the
write frontier on an exclusive page).

Program identity is the second half of purity, so the tree keeps one
root per **tag**: the chunked engine registers everything under its one
chunk shape's tag and shares freely; the whole-bucket engine tags pages
with the bucket that wrote them, declining cross-bucket sharing where a
shape-dependent reduction order could round differently.

Lifetime: the cache holds ONE pool reference per registered page on top
of the referencing slot tables, so a page outlives its writer and is
reclaimed, LRU **leaf** first and never a page something still
references, either lazily when the pool comes up short (the
``pool.reclaimer`` hook) or through :meth:`PrefixCache.evict`.  The LRU
stamp (a logical clock) and the leaf tie-break (lowest block id) are
both deterministic.
"""


class _Node(object):
    """One registered FULL page: ``key`` is its ``block_size``-token
    tuple, the root→node path spells the whole prefix."""

    __slots__ = ("key", "bid", "parent", "children", "stamp")

    def __init__(self, key, bid, parent, stamp):
        self.key = key
        self.bid = bid
        self.parent = parent
        self.children = {}
        self.stamp = stamp


class PrefixCache(object):
    """Token-keyed radix tree of immutable full pages over one
    :class:`~veles_tpu_torch.gen.paged.BlockPool`.  Single scheduler
    thread, like the pool.  Installing the cache hooks
    ``pool.reclaimer`` so allocation pressure evicts LRU leaves before
    ``PoolExhausted`` fires."""

    def __init__(self, pool):
        self.pool = pool
        self.block_size = pool.block_size
        #: tag -> root node (children keyed by page token tuples)
        self._roots = {}
        self._clock = 0
        self.pages = 0
        self.hits_pages_total = 0
        self.misses_pages_total = 0
        self.inserted_pages_total = 0
        self.evicted_pages_total = 0
        pool.reclaimer = self.evict

    # -- lookup / registration ---------------------------------------------
    def _key(self, tokens, index):
        bs = self.block_size
        return tuple(int(t) for t in tokens[index * bs:(index + 1) * bs])

    def match(self, tokens, tag):
        """Longest registered full-page chain prefixing ``tokens``
        under ``tag`` — capped at ``(len(tokens) - 1) // block_size``
        pages so the admission always keeps >= 1 unshared suffix
        token (the write frontier must be an exclusive page).
        Touches the matched path's LRU stamps and returns the block
        ids in position order (possibly empty)."""
        root = self._roots.get(tag)
        limit = (len(tokens) - 1) // self.block_size
        if root is None or limit <= 0:
            return []
        node, bids = root, []
        for i in range(limit):
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            node = child
            bids.append(node.bid)
        self._clock += 1
        while node is not root:
            node.stamp = self._clock
            node = node.parent
        self.hits_pages_total += len(bids)
        self.misses_pages_total += limit - len(bids)
        return bids

    def insert(self, tokens, bids, tag):
        """Register ``bids`` (position order) as the full pages
        covering ``tokens[:len(bids) * block_size]`` under ``tag``.
        Pages already in the tree keep their ORIGINAL node (the
        caller's duplicate copy stays private to its slot); each
        newly added node takes one pool reference so the page
        survives its writer.  Returns the number of pages added."""
        root = self._roots.get(tag)
        if root is None:
            root = self._roots[tag] = _Node(None, None, None, 0)
        self._clock += 1
        node, added = root, 0
        for i, bid in enumerate(bids):
            key = self._key(tokens, i)
            child = node.children.get(key)
            if child is None:
                bid = int(bid)
                if bid == self.pool.TRASH:
                    raise ValueError(
                        "cannot register the trash block as a prefix "
                        "page")
                self.pool.incref(bid)
                child = _Node(key, bid, node, self._clock)
                node.children[key] = child
                self.pages += 1
                added += 1
            child.stamp = self._clock
            node = child
        self.inserted_pages_total += added
        return added

    # -- accounting --------------------------------------------------------
    def _walk(self):
        for root in self._roots.values():
            stack = list(root.children.values())
            while stack:
                node = stack.pop()
                yield node
                stack.extend(node.children.values())

    def cache_only_pages(self):
        """Pages ONLY the cache still references — held HBM that no
        in-flight request is using (the ``hbm_per_request_bytes``
        discount)."""
        return sum(1 for node in self._walk()
                   if self.pool.refcount(node.bid) == 1)

    def reclaimable(self):
        """Pages eviction could actually free right now: cache-only
        SUBTREES (a cache-only inner page becomes a leaf once its
        cache-only children go) — what admission pricing may count on
        top of the free list."""
        total = 0
        for root in self._roots.values():
            for child in root.children.values():
                total += self._reclaimable(child)[1]
        return total

    def _reclaimable(self, node):
        """(fully_evictable, evictable_page_count) of ``node``'s
        subtree."""
        count, full = 0, self.pool.refcount(node.bid) == 1
        for child in node.children.values():
            sub_full, sub_count = self._reclaimable(child)
            count += sub_count
            full = full and sub_full
        return full, count + (1 if full else 0)

    # -- eviction (LRU leaf first, never a referenced page) ----------------
    def evict(self, need):
        """Free at least ``need`` pages by dropping least-recently-
        used LEAVES whose page nothing else references (pool refcount
        1 — the cache's own).  A dropped leaf may expose its parent as
        the next candidate.  Deterministic: LRU stamp, then lowest
        block id.  Returns the number of pages actually freed (may be
        < ``need`` when everything left is referenced)."""
        freed = 0
        while freed < int(need):
            victim = None
            for node in self._walk():
                if node.children:
                    continue
                if self.pool.refcount(node.bid) != 1:
                    continue
                if victim is None or (node.stamp, node.bid) < \
                        (victim.stamp, victim.bid):
                    victim = node
            if victim is None:
                break
            del victim.parent.children[victim.key]
            self.pages -= 1
            self.pool.decref(victim.bid)
            self.evicted_pages_total += 1
            freed += 1
        return freed

    def clear(self):
        """Drop every registered page (engine close): decref all
        nodes regardless of sharing — the slots' own references keep
        shared pages alive."""
        for node in self._walk():
            self.pool.decref(node.bid)
        dropped, self.pages = self.pages, 0
        self._roots = {}
        return dropped

    def describe(self):
        return {
            "prefix_pages": self.pages,
            "prefix_cache_only_pages": self.cache_only_pages(),
            "prefix_hits_pages_total": self.hits_pages_total,
            "prefix_misses_pages_total": self.misses_pages_total,
            "prefix_inserted_pages_total": self.inserted_pages_total,
            "prefix_evicted_pages_total": self.evicted_pages_total,
        }
