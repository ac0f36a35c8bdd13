"""Blocked (paged) KV-cache pool for the serving runtime (vLLM
PagedAttention mapped onto a fixed-shape decode step).

The device side is two preallocated tensors per model, ``k`` and ``v``
of shape ``[n_layers, num_blocks + 1, block_size, n_heads, head_dim]``,
which the decode step updates in place (where the JAX package donates
its arrays and gets new ones back). A sequence's cache is not
contiguous: it owns an ordered list of block ids, its *block table*.

Block 0 is the *null block*: it is never allocated, every unused
block-table entry points at it, and inactive batch slots route their
masked-out cache writes into it, so indices stay in range without
per-slot branches in the step.

Allocation is host-side and two-phase: ``reserve(owner, n)`` at
admission reserves the worst-case block count, so the pool can never be
exhausted mid-decode; ``alloc_block(owner)`` hands out physical ids
lazily, drawn from that reservation, as the sequence crosses block
boundaries. ``free_owner`` returns a retired sequence's blocks and the
unused rest of its reservation; ``truncate_owner`` is speculative
decoding's rollback, returning the tail blocks past the committed
position to the free list and to the owner's reservation.
"""

import torch

from ..analysis.concurrency import make_lock
from ..core.place import resolve_device

__all__ = ["KVBlockPool", "blocks_needed"]


def blocks_needed(num_tokens, block_size):
    """Blocks required to hold ``num_tokens`` cache slots."""
    if num_tokens <= 0:
        return 0
    return -(-int(num_tokens) // int(block_size))


class KVBlockPool:
    """Fixed-size-block KV cache pool with per-owner block accounting.

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
        # moves one unit from reserved to owned, so the sum is
        # invariant until free_owner (check_invariants pins it)
        self._ceiling = {}
        self.truncate_calls = 0
        self.blocks_truncated = 0

    # -- accounting ----------------------------------------------------
    @property
    def blocks_total(self):
        return self.num_blocks

    @property
    def blocks_free(self):
        """Blocks free for a new reservation: the free list minus what
        outstanding reservations already spoke for."""
        with self._lock:
            return len(self._free) - sum(self._reserved.values())

    @property
    def blocks_in_use(self):
        with self._lock:
            return sum(len(b) for b in self._owned.values())

    def stats(self):
        with self._lock:
            free = len(self._free)
            reserved = sum(self._reserved.values())
            in_use = sum(len(b) for b in self._owned.values())
        return {
            "blocks_total": self.num_blocks,
            "blocks_in_use": in_use,
            "blocks_reserved": reserved,
            "blocks_free": free - reserved,
            "utilization": in_use / self.num_blocks,
        }

    # -- admission-side API --------------------------------------------
    def reserve(self, owner, n):
        """Reserve ``n`` worst-case blocks for ``owner``. Returns False
        (reserving nothing) when the pool cannot cover it — the
        scheduler's admission check."""
        n = int(n)
        with self._lock:
            if owner in self._reserved or owner in self._owned:
                raise ValueError("owner %r already holds a reservation"
                                 % (owner,))
            if len(self._free) - sum(self._reserved.values()) < n:
                return False
            self._reserved[owner] = n
            self._owned[owner] = []
            self._ceiling[owner] = n
            return True

    def alloc_block(self, owner):
        """Hand one physical block id to ``owner``, drawn from its
        reservation (appended to the owner's block table)."""
        with self._lock:
            if self._reserved.get(owner, 0) <= 0:
                raise RuntimeError(
                    "owner %r has no remaining reservation — the "
                    "scheduler must reserve the worst-case block count "
                    "at admission" % (owner,))
            bid = self._free.pop()
            self._reserved[owner] -= 1
            self._owned[owner].append(bid)
            return bid

    def block_table(self, owner):
        with self._lock:
            return list(self._owned.get(owner, ()))

    def free_owner(self, owner):
        """Return ``owner``'s blocks and release the unused part of its
        reservation. Idempotent. Returns the number of blocks freed."""
        with self._lock:
            blocks = self._owned.pop(owner, [])
            self._reserved.pop(owner, None)
            self._ceiling.pop(owner, None)
            self._free.extend(reversed(blocks))
            return len(blocks)

    def truncate_owner(self, owner, n_keep):
        """Rewind ``owner``'s block table to its first ``n_keep``
        entries — the KV rollback of speculative decoding: positions
        written for rejected drafts live in over-allocated tail blocks,
        and this returns them. Each dropped block goes back to the free
        list while the owner's reservation grows back by one, the exact
        inverse of ``alloc_block``, so the rewound sequence re-crosses
        the same boundaries without a new reservation. Returns the
        dropped block ids in table order."""
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
            del blocks[n_keep:]
            # reversed: the shallowest dropped block lands last on the
            # LIFO free list, so re-crossing the same boundary hands the
            # same (cache-warm) block back first
            self._free.extend(reversed(dropped))
            self._reserved[owner] += len(dropped)
            self.truncate_calls += 1
            self.blocks_truncated += len(dropped)
            return list(dropped)

    def check_invariants(self):
        """Audit the accounting in one consistent snapshot; returns a
        list of problem strings (empty = clean): conservation (free +
        in-table == total), non-negative and backed reservations, the
        null block never circulating, no block id twice, and the
        rollback accounting — every owner's reserved + owned equal to
        the reservation fixed at ``reserve()`` (``alloc_block`` moves
        one unit from reserved to owned, ``truncate_owner`` moves it
        back)."""
        problems = []
        with self._lock:
            free = list(self._free)
            reserved = dict(self._reserved)
            owned = {o: list(b) for o, b in self._owned.items()}
            ceilings = dict(self._ceiling)
        in_table = [bid for blocks in owned.values() for bid in blocks]
        if len(free) + len(in_table) != self.num_blocks:
            problems.append("conservation broken: free %d + in-table %d "
                            "!= total %d" % (len(free), len(in_table),
                                             self.num_blocks))
        for owner, n in reserved.items():
            if n < 0:
                problems.append("owner %r reservation went negative (%d)"
                                % (owner, n))
        n_reserved = sum(max(n, 0) for n in reserved.values())
        if len(free) < n_reserved:
            problems.append("reservations unbacked: free %d < reserved %d"
                            % (len(free), n_reserved))
        seen = set()
        for bid in free + in_table:
            if bid == self.NULL_BLOCK:
                problems.append("null block circulating")
            if bid in seen:
                problems.append("block %d appears twice" % bid)
            seen.add(bid)
        for owner, blocks in owned.items():
            have = reserved.get(owner, 0) + len(blocks)
            if have != ceilings.get(owner):
                problems.append(
                    "owner %r reserved %d + owned %d != reservation %r"
                    % (owner, reserved.get(owner, 0), len(blocks),
                       ceilings.get(owner)))
        return problems
