"""Blocked (paged) KV-cache pool for the serving runtime (vLLM
PagedAttention mapped onto a fixed-shape decode step), with
content-addressed radix prefix caching (SGLang RadixAttention mapped
onto flat block tables).

The device side is two preallocated tensors per model, ``k`` and ``v``
of shape ``[n_layers, num_blocks + 1, block_size, n_heads, head_dim]``,
which the steps update in place (where the JAX package donates its
arrays and gets new ones back). A sequence's cache is not contiguous:
it owns an ordered list of block ids, its *block table*.

Block 0 is the *null block*: it is never allocated, every unused
block-table entry points at it, and inactive batch slots route their
masked-out cache writes into it, so indices stay in range without
per-slot branches in the step.

Allocation is host-side and two-phase: ``reserve(owner, n)`` at
admission reserves the worst-case block count, so the pool can never be
exhausted mid-decode; ``alloc_block(owner)`` hands out physical ids
lazily, drawn from that reservation, as the sequence crosses block
boundaries. ``free_owner`` drops a retired sequence's references and
the unused rest of its reservation; ``truncate_owner`` is speculative
decoding's rollback, returning the tail blocks past the committed
position to the free list and to the owner's reservation.

Prefix caching makes the pool content-addressed, as in the JAX package:

  * Every block is refcounted. A full block whose contents are a known
    prompt span can be *sealed* into the content index under a
    chain-hash key (``prefix_chain_keys``: key ``i`` commits to the
    namespace and every token of blocks ``0..i``).
  * ``reserve(owner, n, prefix_keys=...)`` adopts the longest sealed run
    of the caller's keys: matched blocks join the owner's table with a
    refcount bump, and only the rest of the worst case is reserved.
  * A block returns to circulation only at refcount zero; sealed blocks
    then park on an LRU *cached* list, still indexed, so a later equal
    prefix can revive them. ``alloc_block`` evicts the least recently
    freed cached block only once the free list is empty.

Reviving a cached block during adoption is charged against availability
like an allocation, so outstanding reservations stay backed:
``free + cached - reserved >= 0`` and ``free + cached + in-table ==
total`` at every step (``check_invariants``; under
``PTPU_LOCK_CHECK=1`` the serving engine audits them at every step
boundary and reports a break as a ``pool-invariant`` violation).
``serving/prefix_cache_flushes`` counts ``flush_prefix_cache`` calls.
"""

import hashlib
from collections import OrderedDict

import torch

from ..analysis.concurrency import make_lock
from ..core.place import resolve_device
from ..observability import metrics as _metrics

__all__ = ["KVBlockPool", "blocks_needed", "prefix_chain_keys"]


def blocks_needed(num_tokens, block_size):
    """Blocks required to hold ``num_tokens`` cache slots."""
    if num_tokens <= 0:
        return 0
    return -(-int(num_tokens) // int(block_size))


def prefix_chain_keys(token_ids, block_size, namespace=""):
    """Content-addressed keys for every full block of ``token_ids``:
    ``key[i]`` is a sha1 chain over ``namespace``, ``key[i-1]`` and block
    ``i``'s tokens, so two requests share ``key[i]`` iff their first
    ``(i + 1) * block_size`` tokens are equal under the same namespace.
    Returns ``len(token_ids) // block_size`` hex digests, the JAX
    package's digests (the trailing partial block is never keyed)."""
    bs = int(block_size)
    h = hashlib.sha1(("ptpu-prefix:%s" % namespace).encode()).hexdigest()
    out = []
    for i in range(len(token_ids) // bs):
        blk = token_ids[i * bs:(i + 1) * bs]
        h = hashlib.sha1(
            (h + ":" + ",".join(str(int(t)) for t in blk)).encode()
        ).hexdigest()
        out.append(h)
    return out


class KVBlockPool:
    """Fixed-size-block KV cache pool with refcounted per-owner block
    accounting and a content-addressed prefix index.

    ``num_blocks`` counts usable blocks; one extra null block (id 0) is
    added on top, so the device tensors hold ``num_blocks + 1`` blocks.
    ``device=None`` is ``cuda:0`` and raises without CUDA.
    """

    NULL_BLOCK = 0

    def __init__(self, n_layers, n_heads, head_dim, block_size,
                 num_blocks, device=None):
        if num_blocks < 1:
            raise ValueError("KVBlockPool needs at least one usable block")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        shape = (self.n_layers, self.num_blocks + 1, self.block_size,
                 self.n_heads, self.head_dim)
        device = resolve_device(device)
        self.k = torch.zeros(shape, dtype=torch.float32, device=device)
        self.v = torch.zeros(shape, dtype=torch.float32, device=device)

        self._lock = make_lock("serving.kv_pool")
        # LIFO free list: a retired sequence's blocks go to the next
        # admission while still warm in cache
        self._free = list(range(self.num_blocks, 0, -1))
        self._reserved = {}   # owner -> blocks still reservable
        self._owned = {}      # owner -> [block ids], table order
        # owner -> reserved + owned, fixed at reserve(): alloc_block
        # moves one unit from reserved to owned, truncate_owner moves it
        # back, so the sum is invariant until free_owner
        self._ceiling = {}
        self._refs = {}       # bid -> refcount (>= 1 while in a table)
        self._sealed = {}     # content key -> bid
        self._block_key = {}  # bid -> content key (sealed blocks)
        # refcount-0 sealed blocks, least recently freed first (the
        # eviction order)
        self._cached = OrderedDict()   # bid -> content key
        self.truncate_calls = 0
        self.blocks_truncated = 0

    # -- accounting ----------------------------------------------------
    @property
    def blocks_total(self):
        return self.num_blocks

    @property
    def blocks_free(self):
        """Blocks reclaimable for a new reservation: free plus cached
        (refcount 0), minus what reservations already spoke for."""
        with self._lock:
            return (len(self._free) + len(self._cached)
                    - sum(self._reserved.values()))

    @property
    def blocks_in_use(self):
        """Distinct blocks in at least one owner's table."""
        with self._lock:
            return len(self._refs)

    @property
    def blocks_cached(self):
        """Refcount-0 sealed blocks kept for prefix reuse."""
        with self._lock:
            return len(self._cached)

    def stats(self):
        with self._lock:
            free = len(self._free)
            cached = len(self._cached)
            reserved = sum(self._reserved.values())
            owned = sum(1 for r in self._refs.values() if r == 1)
            shared = len(self._refs) - owned
        return {
            "blocks_total": self.num_blocks,
            "blocks_in_use": owned + shared,
            "blocks_owned": owned,
            "blocks_shared": shared,
            "blocks_cached": cached,
            "blocks_reserved": reserved,
            "blocks_free": free + cached - reserved,
            "utilization": (owned + shared) / self.num_blocks,
            "truncate_calls": self.truncate_calls,
            "blocks_truncated": self.blocks_truncated,
        }

    # -- admission-side API --------------------------------------------
    def reserve(self, owner, n, prefix_keys=None):
        """Reserve ``n`` worst-case blocks for ``owner``. Returns False
        (reserving nothing) when the pool cannot cover it — the
        scheduler's admission check. With ``prefix_keys`` (the prompt's
        ``prefix_chain_keys``) the longest sealed run is adopted first:
        its blocks join the owner's table with a refcount bump and only
        ``n - matched`` blocks are reserved; reviving a cached block is
        charged against availability like an allocation."""
        n = int(n)
        with self._lock:
            if owner in self._reserved or owner in self._owned:
                raise ValueError("owner %r already holds a reservation"
                                 % (owner,))
            matched = []
            for key in prefix_keys or ():
                bid = self._sealed.get(key)
                if bid is None:
                    break
                matched.append(bid)
            revive = sum(1 for bid in matched if bid not in self._refs)
            need = max(n - len(matched), 0)
            avail = (len(self._free) + len(self._cached)
                     - sum(self._reserved.values()))
            if avail < need + revive:
                return False
            for bid in matched:
                r = self._refs.get(bid, 0)
                if r == 0:
                    del self._cached[bid]        # revived from the LRU
                self._refs[bid] = r + 1
            self._reserved[owner] = need
            self._owned[owner] = matched
            self._ceiling[owner] = need + len(matched)
            return True

    def alloc_block(self, owner):
        """Hand one physical block id to ``owner``, drawn from its
        reservation (appended to the owner's block table). With the free
        list empty, the least recently freed cached block is evicted and
        its index entry dropped."""
        with self._lock:
            if self._reserved.get(owner, 0) <= 0:
                raise RuntimeError(
                    "owner %r has no remaining reservation — the "
                    "scheduler must reserve the worst-case block count "
                    "at admission" % (owner,))
            if self._free:
                bid = self._free.pop()
            else:
                bid, key = self._cached.popitem(last=False)
                del self._sealed[key]
                del self._block_key[bid]
            self._reserved[owner] -= 1
            self._refs[bid] = 1
            self._owned[owner].append(bid)
            return bid

    def block_table(self, owner):
        with self._lock:
            return list(self._owned.get(owner, ()))

    def free_owner(self, owner):
        """Drop ``owner``'s references and release the unused part of its
        reservation. A block leaves a table for good only at refcount 0:
        sealed blocks park on the cached LRU, the rest go back to the
        free list. The table is walked in reverse, so eviction consumes
        a chain tail first (the prefix match walks head first: an
        evicted head would strand its cached successors). Idempotent.
        Returns the number of blocks the owner's table held."""
        with self._lock:
            blocks = self._owned.pop(owner, [])
            self._reserved.pop(owner, None)
            self._ceiling.pop(owner, None)
            for bid in reversed(blocks):
                r = self._refs.get(bid, 0) - 1
                if r > 0:
                    self._refs[bid] = r
                    continue
                self._refs.pop(bid, None)
                key = self._block_key.get(bid)
                if key is not None:
                    self._cached[bid] = key
                    self._cached.move_to_end(bid)
                else:
                    self._free.append(bid)
            return len(blocks)

    def truncate_owner(self, owner, n_keep):
        """Rewind ``owner``'s block table to its first ``n_keep``
        entries — the KV rollback of speculative decoding: positions
        written for rejected drafts live in over-allocated tail blocks,
        and this returns them. Each dropped block goes back to the free
        list while the owner's reservation grows back by one, the exact
        inverse of ``alloc_block``, so the rewound sequence re-crosses
        the same boundaries without a new reservation. Only unshared,
        unsealed tail blocks may go: a shared or sealed block past the
        rollback point raises. Returns the dropped block ids in table
        order."""
        n_keep = int(n_keep)
        if n_keep < 0:
            raise ValueError("n_keep must be >= 0, got %d" % n_keep)
        with self._lock:
            blocks = self._owned.get(owner)
            if blocks is None:
                raise KeyError("owner %r holds no block table" % (owner,))
            if n_keep >= len(blocks):
                return []
            dropped = blocks[n_keep:]
            for bid in dropped:
                if self._refs.get(bid, 0) != 1:
                    raise RuntimeError(
                        "refusing to truncate block %d with refcount %d "
                        "— shared blocks are never rolled back"
                        % (bid, self._refs.get(bid, 0)))
                if bid in self._block_key:
                    raise RuntimeError(
                        "refusing to truncate sealed block %d — cached "
                        "prefix blocks are never rolled back" % bid)
            del blocks[n_keep:]
            # reversed: the shallowest dropped block lands last on the
            # LIFO free list, so re-crossing the same boundary hands the
            # same (cache-warm) block back first
            for bid in reversed(dropped):
                del self._refs[bid]
                self._free.append(bid)
            self._reserved[owner] += len(dropped)
            self.truncate_calls += 1
            self.blocks_truncated += len(dropped)
            return list(dropped)

    def check_invariants(self):
        """Audit the accounting in one consistent snapshot; returns a
        list of problem strings (empty = clean): conservation (free +
        cached + in-table == total), refcounts >= 1 for every table
        block, non-negative and backed reservations (free + cached >=
        reserved), the content index and its reverse map in agreement,
        cached blocks exactly the refcount-0 sealed ones, the null block
        never circulating, no block id twice, every owner's reserved +
        owned equal to the reservation fixed at ``reserve()``, and no
        free-list block still keyed."""
        problems = []
        with self._lock:
            free = list(self._free)
            cached = list(self._cached)
            refs = dict(self._refs)
            reserved = dict(self._reserved)
            owned = {o: list(b) for o, b in self._owned.items()}
            sealed = dict(self._sealed)
            block_key = dict(self._block_key)
            ceilings = dict(self._ceiling)
        if len(free) + len(cached) + len(refs) != self.num_blocks:
            problems.append("conservation broken: free %d + cached %d + "
                            "in-table %d != total %d"
                            % (len(free), len(cached), len(refs),
                               self.num_blocks))
        for bid, r in refs.items():
            if r < 1:
                problems.append("block %d referenced with refcount %d"
                                % (bid, r))
        for owner, n in reserved.items():
            if n < 0:
                problems.append("owner %r reservation went negative (%d)"
                                % (owner, n))
        n_reserved = sum(max(n, 0) for n in reserved.values())
        if len(free) + len(cached) < n_reserved:
            problems.append("reservations unbacked: free %d + cached %d < "
                            "reserved %d" % (len(free), len(cached),
                                             n_reserved))
        for key, bid in sealed.items():
            if block_key.get(bid) != key:
                problems.append("sealed index maps key %s.. to block %d "
                                "but the block's key is %r"
                                % (key[:8], bid, block_key.get(bid)))
        for bid, key in block_key.items():
            if sealed.get(key) != bid:
                problems.append("block %d keyed %s.. missing from the "
                                "sealed index" % (bid, key[:8]))
        for bid in cached:
            if bid in refs:
                problems.append("cached block %d is also referenced "
                                "(refcount %d)" % (bid, refs[bid]))
            if bid not in block_key:
                problems.append("cached block %d lost its index entry"
                                % bid)
        seen = {}
        for where, ids in (("free", free), ("cached", cached)):
            for bid in ids:
                if bid == self.NULL_BLOCK:
                    problems.append("null block circulating on the %s "
                                    "list" % where)
                if bid in seen:
                    problems.append("block %d on both %s and %s"
                                    % (bid, seen[bid], where))
                seen[bid] = where
        for owner, blocks in owned.items():
            for bid in blocks:
                if refs.get(bid, 0) < 1:
                    problems.append("owner %r table references block %d "
                                    "with no refcount" % (owner, bid))
                if bid in seen:
                    problems.append("block %d in a table but also on the "
                                    "%s list" % (bid, seen[bid]))
            have = reserved.get(owner, 0) + len(blocks)
            if have != ceilings.get(owner):
                problems.append(
                    "owner %r reserved %d + owned %d != reservation %r"
                    % (owner, reserved.get(owner, 0), len(blocks),
                       ceilings.get(owner)))
        for bid in free:
            if bid in block_key:
                problems.append("free-list block %d still carries content "
                                "key %s.." % (bid, block_key[bid][:8]))
        return problems

    # -- content index (radix prefix caching) --------------------------
    def seal_block(self, bid, key):
        """Register a full, fully written prompt block in the content
        index, so later ``reserve(prefix_keys=...)`` calls can adopt it.
        Only live (refcount >= 1) non-null blocks seal; the first sealer
        of a key wins. Returns True when ``bid`` is the block for
        ``key``."""
        bid = int(bid)
        with self._lock:
            if bid == self.NULL_BLOCK or self._refs.get(bid, 0) < 1:
                return False
            if bid in self._block_key:
                return self._block_key[bid] == key
            if key in self._sealed:
                return False
            self._sealed[key] = bid
            self._block_key[bid] = key
            return True

    def lookup_prefix(self, prefix_keys):
        """Longest sealed run of ``prefix_keys`` adoptable now (a
        diagnostic; admission uses the atomic ``reserve``)."""
        with self._lock:
            out = []
            for key in prefix_keys:
                bid = self._sealed.get(key)
                if bid is None:
                    break
                out.append(bid)
            return out

    def flush_prefix_cache(self):
        """Drop the whole content index (cached KV is valid only for the
        weights that computed it). Referenced blocks stay in their
        owners' tables unkeyed; cached blocks return to the free list.
        Returns the number of index entries dropped."""
        with self._lock:
            dropped = len(self._sealed)
            self._free.extend(self._cached)
            self._cached.clear()
            self._sealed.clear()
            self._block_key.clear()
        _metrics.counter("serving/prefix_cache_flushes").inc()
        return dropped
