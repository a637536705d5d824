"""Block-pool paged KV cache: the allocation layer under the generative
engine (vLLM's PagedAttention applied to the slot engine).

Counterpart of :mod:`veles_tpu.gen.paged`, copied as it is (pure
numpy, host-side bookkeeping).  The paged engine owns ONE shared device
pool, ``{"k", "v"}: [layers, num_blocks, block_size, heads, head_dim]``
(held in the HBM ledger's ``kv`` category like the slot-major cache),
and maps each sequence onto pages through a per-slot **block table**
(int32 ``[slots, max_blocks]``, host-mirrored here, uploaded to the
device with every paged decode step).  A sequence of ``n`` tokens holds
``ceil(n / block_size)`` pages, so capacity is priced by the observed
mix rather than the worst case.

Determinism is load-bearing: the free list stays **sorted** and every
allocation pops the lowest ids, so the same request mix always lands in
the same pages in the same order and the paged==contiguous parity gate
stays bitwise.  Block id 0 is the **trash block**: never allocated,
never read unmasked.  Table entries past a sequence's allocation,
bucket-tail garbage writes, and decode-inactive slots' ride-along writes
all route there, which keeps every entry point at one shape whatever the
allocation state.

:class:`PoolExhausted` is the admission/append failure the scheduler
turns into preemption: free the YOUNGEST sequence's pages, requeue it at
the queue front with its tokens-so-far (greedy decode of the prefix
reproduces the stream, so preemption is lossless), and retry.

Pages are REFCOUNTED: a full page's content is a pure function of its
token prefix, so the radix prefix cache
(:mod:`veles_tpu_torch.gen.prefix`) can hand the same physical page to
several slots' tables copy-on-write: a shared page carries one reference
per slot table naming it plus one for the cache itself, and returns to
the free list only when the LAST reference drops.  Exclusive pages
(refcount 1) behave as if there were no refcounts.
"""

import bisect
import math

import numpy


class PoolExhausted(RuntimeError):
    """No free block in the pool — the scheduler's cue to preempt the
    youngest sequence (or the caller's to shed load)."""

    def __init__(self, message, needed=1, free=0):
        super(PoolExhausted, self).__init__(message)
        self.needed = int(needed)
        self.free = int(free)


class BlockPool(object):
    """Host-side page accounting for one paged engine: the sorted free
    list, per-slot block ownership, and the host mirror of the device
    block tables.  Single scheduler thread — no locking, same as the
    engine's slot bookkeeping."""

    #: block id 0 — the write sink for everything that must not land
    #: in a live page; never allocated, never read unmasked
    TRASH = 0

    def __init__(self, slots, max_blocks, num_blocks, block_size):
        self.slots = int(slots)
        self.max_blocks = int(max_blocks)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        if self.num_blocks < self.max_blocks + 1:
            raise ValueError(
                "num_blocks %d cannot hold one full sequence "
                "(%d blocks) plus the trash block — the pool would "
                "deadlock on its first long request"
                % (self.num_blocks, self.max_blocks))
        #: sorted free list; id 0 (trash) is never a member
        self._free = list(range(1, self.num_blocks))
        #: slot -> [block ids] in position order
        self._owned = {}
        #: block id -> live reference count (slot tables + the prefix
        #: cache); absent = free.  Exclusive pages sit at 1.
        self._refs = {}
        #: optional ``reclaimer(need) -> freed`` hook the prefix cache
        #: installs: called once when an allocation comes up short so
        #: LRU cache leaves can be evicted before PoolExhausted fires
        self.reclaimer = None
        #: host mirror of the device block tables; entries past a
        #: slot's allocation stay TRASH
        self.tables = numpy.zeros((self.slots, self.max_blocks),
                                  numpy.int32)

    # -- capacity ----------------------------------------------------------
    @property
    def blocks_total(self):
        return self.num_blocks - 1

    @property
    def blocks_free(self):
        return len(self._free)

    @property
    def blocks_used(self):
        return self.blocks_total - len(self._free)

    def blocks_for(self, n_tokens):
        return max(1, int(math.ceil(n_tokens / float(self.block_size))))

    def can_fit(self, n_tokens):
        return self.blocks_for(n_tokens) <= len(self._free)

    # -- refcounts (prefix sharing) ----------------------------------------
    def refcount(self, bid):
        return self._refs.get(bid, 0)

    def incref(self, bid):
        """One more reference to a LIVE page (a slot table or the
        prefix cache adopting it)."""
        if bid == self.TRASH:
            raise ValueError("the trash block is never referenced")
        if bid not in self._refs:
            raise ValueError("block %d is free — cannot share it"
                             % bid)
        self._refs[bid] += 1

    def decref(self, bid):
        """Drop one reference; the page returns to the sorted free
        list when the LAST reference drops.  Returns True when the
        page was actually freed."""
        refs = self._refs.get(bid)
        if not refs:
            raise ValueError("block %d has no live reference" % bid)
        if refs > 1:
            self._refs[bid] = refs - 1
            return False
        del self._refs[bid]
        bisect.insort(self._free, bid)
        return True

    # -- allocation (lowest-id-first: deterministic) -----------------------
    def _pop(self, count, what):
        if count > len(self._free) and self.reclaimer is not None:
            # one reclaim attempt: the prefix cache evicts LRU leaves
            # whose only reference is its own, growing the free list
            self.reclaimer(count - len(self._free))
        if count > len(self._free):
            raise PoolExhausted(
                "block pool exhausted: %s needs %d page(s), %d free "
                "of %d" % (what, count, len(self._free),
                           self.blocks_total),
                needed=count, free=len(self._free))
        ids, self._free = self._free[:count], self._free[count:]
        for bid in ids:
            self._refs[bid] = 1
        return ids

    def admit(self, slot, n_tokens, shared=()):
        """Allocate the pages for a freshly admitted ``n_tokens``
        prefix and fill the slot's table row.  ``shared`` (prefix-
        cache hits, position order) are LIVE pages adopted by
        reference — incref'd, never written by this slot — and only
        the unshared suffix is allocated fresh.  Returns the block
        ids (position order)."""
        if slot in self._owned:
            raise ValueError("slot %d already owns pages" % slot)
        shared = list(shared)
        need = self.blocks_for(n_tokens)
        if len(shared) >= need:
            raise ValueError(
                "%d shared pages leave no exclusive tail page for %d "
                "tokens — the write frontier must stay unshared"
                % (len(shared), n_tokens))
        # incref BEFORE popping: _pop may invoke the reclaimer, and a
        # matched-but-not-yet-adopted cache page (refcount 1) would be
        # fair game for eviction otherwise
        for bid in shared:
            self.incref(bid)
        try:
            ids = self._pop(need - len(shared),
                            "admitting slot %d" % slot)
        except PoolExhausted:
            for bid in shared:
                self.decref(bid)
            raise
        ids = shared + ids
        self._owned[slot] = ids
        self.tables[slot, :len(ids)] = ids
        return ids

    def append(self, slot, position):
        """Ensure the page holding ``position`` exists — the decode
        append: a new page is allocated exactly when the position
        crosses a block boundary.  Returns True when a page was
        allocated."""
        owned = self._owned.get(slot)
        if owned is None:
            raise ValueError("slot %d owns no pages" % slot)
        index = position // self.block_size
        if index < len(owned):
            return False
        if index != len(owned):
            raise ValueError(
                "append at position %d skips pages (slot %d owns %d)"
                % (position, slot, len(owned)))
        (bid,) = self._pop(1, "appending to slot %d" % slot)
        owned.append(bid)
        self.tables[slot, index] = bid
        return True

    def owned(self, slot):
        """The slot's page ids in position order (empty tuple when the
        slot owns nothing) — the fleet handoff exports exactly these."""
        return tuple(self._owned.get(slot, ()))

    def needs_append(self, slot, position):
        """True when decoding at ``position`` requires a page the slot
        does not own yet (the scheduler's preemption probe)."""
        owned = self._owned.get(slot)
        return owned is not None and \
            position // self.block_size >= len(owned)

    def truncate(self, slot, n_tokens):
        """Shrink the slot back to ``n_tokens`` — the speculative-
        decode rollback: pages past ``blocks_for(n_tokens)`` drop one
        reference (freed only when nothing else shares them) and their
        table entries return to TRASH.  Returns the number of pages
        dropped from the table."""
        owned = self._owned.get(slot)
        if owned is None:
            raise ValueError("slot %d owns no pages" % slot)
        keep = self.blocks_for(n_tokens)
        if keep >= len(owned):
            return 0
        dropped = owned[keep:]
        del owned[keep:]
        for bid in dropped:
            self.decref(bid)
        self.tables[slot, keep:] = self.TRASH
        return len(dropped)

    def release(self, slot):
        """Drop the slot's reference on every page it names (sorted
        free list — the deterministic-allocation invariant) and reset
        its table row.  Shared pages survive until their LAST
        reference drops.  Returns the number of pages actually
        freed."""
        ids = self._owned.pop(slot, None)
        if ids is None:
            return 0
        freed = 0
        for bid in ids:
            freed += bool(self.decref(bid))
        self.tables[slot, :] = self.TRASH
        return freed

    def pages_saved(self):
        """Pages prefix sharing is currently saving: a shared page
        always carries exactly ONE cache registration ref (sharing
        only arises through the radix tree), so every reference past
        slot+cache is a page some slot did NOT have to allocate."""
        return sum(refs - 2 for refs in self._refs.values()
                   if refs > 2)

    def describe(self):
        shared = sum(1 for refs in self._refs.values() if refs > 1)
        return {
            "block_size": self.block_size,
            "blocks_total": self.blocks_total,
            "blocks_free": self.blocks_free,
            "blocks_used": self.blocks_used,
            "blocks_shared": shared,
            "max_blocks_per_slot": self.max_blocks,
        }
