"""Fault-tolerant streaming data plane (parity: the JAX package's
``data_plane.py``, all of it).

One truncated shard or one restart mid-epoch must degrade the pipeline,
not kill or silently skew the run. Two pieces, metered through `data/*`
counters:

  corrupt-input containment — `iter_shard_records` re-reads the recordio
      chunk format (``core/native.py``) with per-chunk CRC, per-record
      framing and truncated-tail detection and routes every anomaly
      through `PTPU_DATA_ANOMALY_POLICY`:
        abort            raise a structured `DataAnomalyError`
        skip_record      skip the damaged records, keep the shard
        quarantine_shard abandon the shard at its first damage point
                         (each pass yields only the stable good
                         prefix; the registry lists the shard for
                         operators — it is telemetry, never iteration
                         state, so resume stays bitwise)
      default `skip_record`. On healthy shards every policy yields the
      scanner's record stream, including snappy-compressed
      reference-format chunks: the chunk decoder is
      ``core.native``'s, which the scanner runs too.
  mid-epoch resume — `DatasetCursor` names an exact position in the
      deterministic record stream (epoch, shard-order seed, shard
      index, in-shard record offset). `Dataset.resumable_batches`
      advances it as batches are CONSUMED (never as they are
      prefetched — queued batches carry their post-batch cursor state
      and apply it only on consumption), and `write_to(scope)` parks it
      under `__data_cursor__`, so it rides a scope snapshot or
      checkpoint with no format change: `ResilientTrainer.restore()`
      brings it back and the resumed record stream is byte-identical to
      the unfailed run.

The JAX package streams healthy shards through its C scanner and
switches to this reader at the first damage; the port's scanner is
Python too, so every shard reads through the containment reader. The
`data_corrupt_shard:N` / `data_stall_shard:N` injector sites
(``resilience.FaultInjector``) make damage and stalls reproducible. The peer-loss exchange of a multi-worker global shuffle
is ROADMAP.md Queue 1 item 9's.
"""

import random
import time
import warnings

import numpy as np

from .analysis.concurrency import make_lock
from .core.native import (_ChunkDamage, _ShardTorn, _read_chunk,
                          _split_records)
from .flags import env as _env
from .observability import flight_recorder as _blackbox
from .observability import metrics as _metrics
from .recordio_writer import RecordFormatError, deserialize_sample

__all__ = [
    "DATA_POLICY_ABORT", "DATA_POLICY_SKIP_RECORD",
    "DATA_POLICY_QUARANTINE_SHARD", "DATA_POLICIES",
    "data_anomaly_policy", "DataAnomalyError", "iter_shard_records",
    "resilient_sample_reader", "quarantined_shards", "reset_quarantine",
    "DatasetCursor", "shard_order", "apply_cursor",
]


# ---------------------------------------------------------------------------
# anomaly policy
# ---------------------------------------------------------------------------

DATA_POLICY_ABORT = "abort"
DATA_POLICY_SKIP_RECORD = "skip_record"
DATA_POLICY_QUARANTINE_SHARD = "quarantine_shard"
DATA_POLICIES = (DATA_POLICY_ABORT, DATA_POLICY_SKIP_RECORD,
                 DATA_POLICY_QUARANTINE_SHARD)


def data_anomaly_policy(value=None):
    """Resolve the data-plane anomaly policy: explicit arg >
    $PTPU_DATA_ANOMALY_POLICY > `skip_record` (a streaming epoch should
    survive one torn shard by default)."""
    policy = value or _env("PTPU_DATA_ANOMALY_POLICY") \
        or DATA_POLICY_SKIP_RECORD
    if policy not in DATA_POLICIES:
        raise ValueError("unknown data anomaly policy %r (want one of %s)"
                         % (policy, "|".join(DATA_POLICIES)))
    return policy


class DataAnomalyError(RuntimeError):
    """Structured corrupt-input failure (policy `abort`): which shard,
    what kind of damage (`crc`, `framing`, `truncated`, `record`,
    `injected`), where."""

    def __init__(self, shard, kind, chunk_index=None, record_index=None,
                 detail=""):
        msg = "corrupt input in shard %r (%s" % (shard, kind)
        if chunk_index is not None:
            msg += ", chunk %d" % chunk_index
        if record_index is not None:
            msg += ", record %d" % record_index
        msg += ")"
        if detail:
            msg += ": " + detail
        super().__init__(msg)
        self.shard = shard
        self.kind = kind
        self.chunk_index = chunk_index
        self.record_index = record_index
        self.detail = detail


# ---------------------------------------------------------------------------
# quarantine registry (process-local shard out-of-service list)
# ---------------------------------------------------------------------------

_quarantine_lock = make_lock("data.quarantine")
_QUARANTINED = set()


def quarantined_shards():
    """Snapshot of shard paths the `quarantine_shard` policy has taken
    out of service — the operator surface for "replace these files".
    The registry is telemetry, NOT iteration state: every pass re-reads
    a damaged shard's stable good prefix and stops at the on-disk
    damage point, so the record stream is a pure function of (bytes on
    disk, policy) and a kill-then-resume run stays bitwise identical
    to the unfailed one (the DatasetCursor contract)."""
    with _quarantine_lock:
        return set(_QUARANTINED)


def reset_quarantine():
    """Clear the quarantine registry (tests / operator override after
    replacing the damaged files)."""
    with _quarantine_lock:
        _QUARANTINED.clear()


def _quarantine(path):
    with _quarantine_lock:
        new = path not in _QUARANTINED
        _QUARANTINED.add(path)
    if new:
        _metrics.counter("data/shards_quarantined").inc()
        _blackbox.record_event("shard_quarantined", shard=str(path))
    return new


# ---------------------------------------------------------------------------
# resilient recordio shard reader
# ---------------------------------------------------------------------------

def _record_damage(path, policy, kind, n_lost, chunk_index, detail,
                   warned, record_index=None):
    """Apply the anomaly policy to `n_lost` damaged records — one
    chunk's loss, or a single undecodable record when `record_index`
    is given (the sample-reader path). ONE dispatch for every damage
    site: abort raise / quarantine / skip telemetry and the once-per-
    shard warning all live here. Returns True when the shard should be
    quarantined (caller stops reading it). Telemetry runs outside any
    lock."""
    n_lost = max(1, int(n_lost))
    _metrics.counter("data/records_corrupt").inc(n_lost)
    where = ("record %d" % record_index if record_index is not None
             else "chunk %s" % chunk_index)
    if policy == DATA_POLICY_ABORT:
        raise DataAnomalyError(path, kind, chunk_index=chunk_index,
                               record_index=record_index, detail=detail)
    if policy == DATA_POLICY_QUARANTINE_SHARD:
        _quarantine(path)
        warnings.warn(
            "data plane: quarantining shard %r (%s, %s: %s)"
            % (path, kind, where, detail), RuntimeWarning)
        return True
    _metrics.counter("data/records_skipped").inc(n_lost)
    if not warned[0]:
        warned[0] = True
        if record_index is not None:
            warnings.warn(
                "data plane: skipping undecodable record %d in shard "
                "%r: %s" % (record_index, path, detail), RuntimeWarning)
        else:
            warnings.warn(
                "data plane: skipping ~%d damaged record(s) in shard %r "
                "(%s, %s: %s)" % (n_lost, path, kind, where, detail),
                RuntimeWarning)
    return False


def iter_shard_records(path, shard_index=0, policy=None):
    """Yield the raw records of one recordio shard with corrupt-input
    containment: per-chunk CRC, per-record framing and truncated-tail
    damage route through the anomaly policy instead of raising
    mid-epoch. On a healthy shard the emitted stream is byte-identical
    to the scanner's (the two share ``core.native``'s chunk decoder).
    `shard_index` keys the `data_corrupt_shard:N` / `data_stall_shard:N`
    injector sites."""
    from .resilience import maybe_inject_shard_fault

    policy = data_anomaly_policy(policy)
    injected = maybe_inject_shard_fault(shard_index)
    if injected == "stall":
        # a slow shard must not wedge the pipeline's determinism —
        # bounded, one-shot (the prefetch window absorbs it)
        time.sleep(0.25)
    force_corrupt = injected == "corrupt"
    warned = [False]
    chunk_index = 0
    with open(path, "rb") as f:
        while True:
            try:
                loaded = _read_chunk(f, force_corrupt=force_corrupt)
            except _ChunkDamage as dmg:
                if _record_damage(path, policy, dmg.kind,
                                  dmg.num_records, chunk_index,
                                  dmg.detail, warned):
                    return
                chunk_index += 1
                continue
            except _ShardTorn as torn:
                # no recoverable boundary past this point: whatever the
                # policy, the rest of the shard is gone — count it as
                # one unknown-size loss and stop
                _record_damage(path, policy, "truncated", 1, chunk_index,
                               torn.detail, warned)
                return
            if loaded is None:
                return
            records, damage = _split_records(*loaded)
            yield from records
            if damage is not None and _record_damage(
                    path, policy, damage.kind, damage.num_records,
                    chunk_index, damage.detail, warned):
                return
            chunk_index += 1


def resilient_sample_reader(paths, policy=None, shard_indices=None):
    """Reader creator over recordio shards with containment: yields
    deserialized samples; record-payload damage (`RecordFormatError`
    from a record whose chunk CRC still passed) routes through the same
    policy as chunk damage. Drop-in for
    `recordio_writer.recordio_reader_creator` on the dataset path."""
    if isinstance(paths, str):
        paths = paths.split(",")
    paths = list(paths)
    if shard_indices is None:
        shard_indices = list(range(len(paths)))

    def reader():
        resolved = data_anomaly_policy(policy)
        for shard_index, path in zip(shard_indices, paths):
            warned = [False]
            record_index = 0
            for rec in iter_shard_records(path, shard_index=shard_index,
                                          policy=resolved):
                try:
                    sample = deserialize_sample(rec)
                except RecordFormatError as e:
                    if _record_damage(path, resolved, "record", 1,
                                      None, str(e), warned,
                                      record_index=record_index):
                        break
                    record_index += 1
                    continue
                record_index += 1
                yield sample

    return reader


# ---------------------------------------------------------------------------
# mid-epoch resumable iteration
# ---------------------------------------------------------------------------

_CURSOR_VERSION = 1


def shard_order(n_shards, seed=None, epoch=0):
    """The deterministic per-epoch shard permutation the resumable
    stream reads in: `seed=None` keeps filelist order (the legacy
    contract); otherwise a seeded per-epoch shuffle so multi-epoch runs
    revisit shards in fresh orders while any resume recomputes the
    identical permutation."""
    order = list(range(int(n_shards)))
    if seed is not None:
        random.Random(int(seed) * 1000003 + int(epoch) * 7919).shuffle(
            order)
    return order


class DatasetCursor:
    """A checkpointable position in the deterministic record stream: the
    NEXT record the consumer has not seen is record `record_offset` of
    shard `shard_order(n, seed, epoch)[shard_idx]` of epoch `epoch`.
    `Dataset.resumable_batches` advances it as batches are consumed;
    `write_to(scope)` parks it under ``__data_cursor__`` so scope
    snapshots and checkpoints carry it for free and a restored run
    resumes the byte-identical stream."""

    SCOPE_KEY = "__data_cursor__"

    __slots__ = ("epoch", "shard_idx", "record_offset", "seed")

    def __init__(self, epoch=0, shard_idx=0, record_offset=0, seed=None):
        self.epoch = int(epoch)
        self.shard_idx = int(shard_idx)
        self.record_offset = int(record_offset)
        self.seed = None if seed is None else int(seed)

    def position(self):
        return (self.epoch, self.shard_idx, self.record_offset)

    def advance_to(self, epoch, shard_idx, record_offset):
        self.epoch = int(epoch)
        self.shard_idx = int(shard_idx)
        self.record_offset = int(record_offset)
        return self

    def shard_order(self, n_shards, epoch=None):
        return shard_order(n_shards, self.seed,
                           self.epoch if epoch is None else epoch)

    def clone(self):
        return DatasetCursor(self.epoch, self.shard_idx,
                             self.record_offset, self.seed)

    def to_array(self):
        """Checkpoint encoding: one int64 vector (rides any manifest
        that can hold a numpy leaf)."""
        return np.asarray(
            [_CURSOR_VERSION, self.epoch, self.shard_idx,
             self.record_offset, 0 if self.seed is None else 1,
             0 if self.seed is None else self.seed], np.int64)

    @classmethod
    def from_array(cls, arr):
        arr = np.asarray(arr).reshape(-1)
        if arr.size < 6 or int(arr[0]) != _CURSOR_VERSION:
            raise ValueError("unrecognized DatasetCursor encoding %r"
                             % (arr,))
        return cls(epoch=int(arr[1]), shard_idx=int(arr[2]),
                   record_offset=int(arr[3]),
                   seed=int(arr[5]) if int(arr[4]) else None)

    def write_to(self, scope):
        scope.set(self.SCOPE_KEY, self.to_array())
        return self

    @classmethod
    def from_scope(cls, scope):
        """The cursor a restored scope carries, or None when the run
        never used one."""
        val = scope.get(cls.SCOPE_KEY)
        if val is None:
            return None
        return cls.from_array(val)

    def __repr__(self):
        return ("DatasetCursor(epoch=%d, shard_idx=%d, record_offset=%d,"
                " seed=%r)" % (self.epoch, self.shard_idx,
                               self.record_offset, self.seed))


def apply_cursor(pairs, cursor, scope=None):
    """Consumer-side cursor application: `pairs` yields
    `(batch, (epoch, shard_idx, record_offset))` — possibly through a
    prefetch queue — and the cursor (plus its scope mirror) advances
    only when the CONSUMER takes the batch. Batches still sitting in
    the prefetch queue never move the cursor, so a checkpoint taken
    mid-stream names exactly the first unconsumed record (the
    prefetcher drain state is implicit)."""
    for batch, state in pairs:
        cursor.advance_to(*state)
        if scope is not None:
            cursor.write_to(scope)
        yield batch
