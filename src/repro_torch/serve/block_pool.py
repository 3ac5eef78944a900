"""Host-side block pool for the paged KV cache (vLLM discipline).

A copy of the reference's numpy-only ``repro/serve/block_pool.py``: the
port keeps its own so it imports nothing of ``repro``.

The serving engine's KV cache is one global device pool of
``num_blocks`` fixed-size blocks (``block_size`` token positions each,
per layer-period); a request's logical cache positions map to physical
blocks through a per-slot block table.  This module owns the *host*
side of that contract — allocation, refcounting, content hashing, and
eviction.  It never touches a device array: the engine turns pool
decisions into block tables / slot maps that ship with each unified
step, and into the rare copy-on-write block copy.

Prefix caching
--------------
A *full* block's KV content is a pure function of the token history up
to and including the block, so each completed block is registered under
a **chain hash**::

    h_0 = H(ROOT,    tokens[0:B])
    h_j = H(h_{j-1}, tokens[jB:(j+1)B])

(H = blake2b-128).  Admission hashes the new prompt's full blocks along
the same chain and reuses any registered block by bumping its refcount
— the TiM-DNN in-memory-reuse discipline (amortize one write across
many readers) applied to activations instead of weights.

Lifecycle of a block::

    free ──allocate──► owned (ref 1, writable by exactly one slot)
    owned ──register (on completion)──► owned+cached (immutable)
    owned ──lookup hit──► shared (ref >= 2, immutable)
    shared/owned ──decref to 0──► cached (evictable, still matchable)
    cached ──allocate (eviction)──► free (hash dropped) ──► owned

Eviction is oldest-release-first among cached blocks (plain free blocks
are handed out before any cached block is sacrificed).  Blocks with a
live reference are never evicted.

Public contract / invariants
----------------------------
* ``allocate``/``try_allocate`` return a block with refcount exactly 1
  (exclusively owned, writable); ``try_allocate`` returns None instead
  of raising when every block holds a live reference — the signal the
  serving engine's preemption policy acts on (undersized pools preempt
  a slot rather than fail; see docs/serving.md §preemption).
* refcount[bid] == number of live references (slot-table entries plus
  transient admission holds); a block is *written* only while its
  refcount is 1.
* ``hash_to_block`` and ``block_hash`` are mutually consistent
  (``check()`` asserts it), a hash maps to at most one block, and a
  block's hash survives decref-to-0 (stays matchable) until the block
  is recycled by ``allocate``.
* ``blocks_in_use + len(free-or-cached) == num_blocks`` at all times;
  release-queue entries staled by a ``lookup`` revival are skipped via
  per-block release generations, never honored out of order.
"""
from __future__ import annotations

import hashlib
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

ROOT_HASH = b"tim-paged-kv-root"


def default_num_blocks(slots: int, max_len: int, block_size: int) -> int:
    """The engine's default pool sizing — a full batch plus one spare
    block per slot (>= the constructor's full-batch + 1-CoW-transient
    floor).  The dry-run cost model and kernel-bench accounting import
    this so the published num_blocks always describes a constructible
    engine."""
    return slots * (-(-max_len // block_size) + 1)


def chain_hash(prev: bytes, tokens: Sequence[int]) -> bytes:
    """Positional content hash of one full block given the chain hash of
    everything before it."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.digest()


class BlockPool:
    """Refcounted allocator over ``num_blocks`` physical KV blocks."""

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks >= 1 and block_size >= 1
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.refcount = np.zeros((num_blocks,), np.int32)
        self.block_hash: List[Optional[bytes]] = [None] * num_blocks
        self.hash_to_block: Dict[bytes, int] = {}
        # two release queues: hashless blocks are handed out before any
        # cached (hashed, matchable) block is sacrificed; within each,
        # oldest release first.  Entries carry the block's release
        # generation so entries staled by a lookup() revival are
        # skipped instead of jumping the queue: only the entry from the
        # block's LATEST release is honored.
        self._release_seq = np.zeros((num_blocks,), np.int64)
        self._free_clean = deque((bid, 0) for bid in range(num_blocks))
        self._free_cached: deque = deque()
        self.evictions = 0

    # -- allocation ---------------------------------------------------------

    def _pop_free(self, q: deque) -> Optional[int]:
        while q:
            bid, seq = q.popleft()
            if self.refcount[bid] == 0 and seq == self._release_seq[bid]:
                self._release_seq[bid] += 1     # invalidate the entry
                return bid
        return None

    def try_allocate(self) -> Optional[int]:
        """``allocate`` that returns None on exhaustion — every block
        holds a live reference, nothing (cached included) is evictable.
        The engine turns None into a preemption instead of an error."""
        bid = self._pop_free(self._free_clean)
        if bid is None:
            bid = self._pop_free(self._free_cached)
        if bid is None:
            return None
        h = self.block_hash[bid]
        if h is not None:                     # evict cached content
            del self.hash_to_block[h]
            self.block_hash[bid] = None
            self.evictions += 1
        self.refcount[bid] = 1
        return bid

    def allocate(self) -> int:
        """Hand out a writable block (refcount 1), evicting the oldest-
        released cached block only if no plain-free block remains."""
        bid = self.try_allocate()
        if bid is None:
            raise RuntimeError(
                f"block pool exhausted: all {self.num_blocks} blocks "
                f"hold a live reference (size the pool > slots * "
                f"ceil(max_len / block_size) — a full batch plus one "
                f"transient copy-on-write block — or serve with "
                f"preemption enabled)")
        return bid

    def incref(self, bid: int) -> None:
        assert self.refcount[bid] >= 1, bid
        self.refcount[bid] += 1

    def incref_all(self, bids: Sequence[int]) -> None:
        """Bump every block in ``bids`` by one reference — the sibling/
        beam fork path: a child sequence adopts its parent's full
        (immutable) blocks wholesale, so the engine shares them by
        refcount in one call instead of copying KV.  All-or-nothing by
        the same live-reference precondition as ``incref`` (parent
        tables only ever hold live blocks)."""
        for bid in bids:
            assert self.refcount[bid] >= 1, bid
        for bid in bids:
            self.refcount[bid] += 1

    def decref(self, bid: int) -> None:
        assert self.refcount[bid] >= 1, bid
        self.refcount[bid] -= 1
        if self.refcount[bid] == 0:
            # keep the hash: the block stays matchable until evicted
            self._release_seq[bid] += 1
            entry = (bid, int(self._release_seq[bid]))
            if self.block_hash[bid] is not None:
                self._free_cached.append(entry)
            else:
                self._free_clean.append(entry)

    # -- prefix cache -------------------------------------------------------

    def lookup(self, h: bytes) -> Optional[int]:
        """Full-block cache hit: returns the block id with its refcount
        bumped (reviving an evictable cached block), or None."""
        bid = self.hash_to_block.get(h)
        if bid is None:
            return None
        # reviving an evictable cached block: its queued release entry
        # goes stale (skipped at pop via refcount, or via the release
        # generation once the block is released again)
        self.refcount[bid] += 1
        return bid

    def revive(self, bid: int) -> bool:
        """Re-acquire a specific released block WITHOUT recycling it:
        refcount 0 -> 1, contents intact.  The queued release entry
        goes stale exactly as in ``lookup`` (skipped at pop via the
        refcount check, or via the release generation once the block
        is released again).  Returns False when the block holds a live
        reference (someone allocated or revived it first).  Used by the
        serving engine's tail-donation cache to pin a finished
        request's partial tail block for the duration of a
        copy-on-write read — partial tails carry no chain hash, so
        ``lookup`` cannot revive them."""
        if self.refcount[bid] != 0:
            return False
        self.refcount[bid] += 1
        return True

    def register(self, bid: int, h: bytes) -> None:
        """Publish a completed block's chain hash.  First writer wins:
        if the hash is already mapped (a concurrent identical prefill),
        the existing mapping is kept and this block stays private."""
        assert self.refcount[bid] >= 1, bid
        if h in self.hash_to_block or self.block_hash[bid] is not None:
            return
        self.hash_to_block[h] = bid
        self.block_hash[bid] = h

    # -- introspection ------------------------------------------------------

    @property
    def blocks_in_use(self) -> int:
        return int((self.refcount > 0).sum())

    @property
    def blocks_free(self) -> int:
        """Blocks with no live reference — allocatable without
        preempting anyone (cached evictables included)."""
        return self.num_blocks - self.blocks_in_use

    @property
    def blocks_cached(self) -> int:
        """Evictable blocks still holding registered (matchable) KV."""
        return sum(1 for h, bid in self.hash_to_block.items()
                   if self.refcount[bid] == 0)

    def check(self) -> None:
        """Internal consistency (raises AssertionError)."""
        for h, bid in self.hash_to_block.items():
            assert self.block_hash[bid] == h, (bid, h)
        for bid, h in enumerate(self.block_hash):
            if h is not None:
                assert self.hash_to_block.get(h) == bid, (bid, h)
        assert (self.refcount >= 0).all()
