"""Static pipeline schedules as host-precomputed tables (parity: the
JAX package's ``parallel/pipeline_schedule.py``, a copy: `Schedule` :32,
`Schedule.stats` :62, `build_schedule` :81, `_validate` :231; the tables
equal the JAX package's int32 for int32).

The 1F1B schedule is data-independent, so it is built once on the host
by a greedy list scheduler and read by each rank of the pipelined step
(``pipeline_program.py``) row by row: [tick, pp rank] int32 tables. That
one mechanism covers classic 1F1B (v=1, the closed-form K = M + 2*pp - 2
ticks) and Megatron-style interleaved virtual stages (v>1: each rank
hosts v non-contiguous chunks; virtual stage s lives on rank s % pp, so
consecutive stages sit on consecutive ranks and the same +1/-1 ring
carries both schedules). A chunk is 1/v of the layers, so a tick costs
about 1/v of a v=1 tick: the bubble fraction drops from
(2pp-2)/(M+2pp-2) toward its 1/v multiple.

Every generated schedule is validated against the dependency rules
(wire arrival = send tick + 1) at build time: an invalid schedule is a
bug and raises; it cannot silently corrupt gradients.

Unit semantics per tick per rank: at most one forward chunk-unit and one
backward chunk-unit; the backward of (s, i) may run in the same tick as
its forward (the stash write comes first in the tick); ring wires sent
at tick t are readable from tick t+1.
"""

import numpy as np

__all__ = ["Schedule", "build_schedule"]


class Schedule:
    """Precomputed tables, all int32 [K, pp]; -1 = no-op / no slot.

    fwd_mb / fwd_chunk   microbatch + chunk of the tick's forward unit
    fwd_read             arrive-stash slot holding its input wire
                         (-1: virtual stage 0, reads the feed)
    fwd_save             input-stash slot to save the input for backward
    fwd_recv             arrive-stash slot for the wire arriving this
                         tick on the forward ring
    bwd_mb / bwd_chunk   backward unit (vjp of the chunk forward)
    bwd_read             input-stash slot with the saved forward input
    cot_read             cot-stash slot with the arrived cotangent
                         (-1 when this unit seeds at the loss stage or
                         runs a post-loss stage with zero cotangent)
    cot_recv             cot-stash slot for the wire arriving this tick
                         on the backward ring
    """

    def __init__(self, pp, v, M, tables, arrive_slots, input_slots,
                 cot_slots):
        self.pp, self.v, self.M = pp, v, M
        self.S = v * pp
        self.K = tables["fwd_mb"].shape[0]
        for k, t in tables.items():
            setattr(self, k, np.asarray(t, np.int32))
        self.arrive_slots = max(arrive_slots, 1)
        self.input_slots = max(input_slots, 1)
        self.cot_slots = max(cot_slots, 1)

    # -- efficiency accounting -------------------------------------------
    def stats(self):
        """Bubble accounting. A tick costs one chunk fwd + one chunk bwd
        on every rank whether units are valid or not (masked compute
        still runs), so cost-per-tick ~ 1/v of a v=1 tick and the ideal
        schedule would need M*v ticks; bubble = 1 - M*v/K."""
        valid_f = int((self.fwd_mb >= 0).sum())
        valid_b = int((self.bwd_mb >= 0).sum())
        ideal_ticks = self.M * self.v  # per rank: M microbatches x v chunks
        return {
            "pp": self.pp, "virtual_stages": self.v,
            "microbatches": self.M, "ticks": self.K,
            "ideal_ticks": ideal_ticks,
            "bubble_fraction": 1.0 - ideal_ticks / float(self.K),
            "equivalent_full_ticks": self.K / float(self.v),
            "unit_utilization": (valid_f + valid_b)
            / float(2 * self.K * self.pp),
        }


def build_schedule(pp, M, v=1):
    """Greedy list scheduler for (interleaved) 1F1B.

    Virtual stage s in [0, S), S = v*pp, lives on rank s % pp (chunk
    c = s // pp). Readiness rules:
      fwd(s, i): s == 0, or fwd(s-1, i) finished at a tick < t
      bwd(s, i): fwd(s, i) finished at a tick <= t, and
                 (s == S-1, or bwd(s+1, i) finished at a tick < t)
    Per tick each rank runs at most one fwd and one bwd unit. Priorities
    (which make v=1 reproduce classic 1F1B exactly and v>1 come out
    Megatron-interleaved): backward prefers the OLDEST ready microbatch
    at the DEEPEST stage; forward prefers the deepest ready stage, then
    the oldest microbatch — "drain before fill" keeps the in-flight
    window (and the stash sizes) at the 1F1B bound."""
    if pp < 1 or v < 1 or M < 1:
        raise ValueError("pp, v, M must be >= 1")
    S = v * pp
    fwd_done = {}   # (s, i) -> tick
    bwd_done = {}
    # slot managers: per rank free-lists, max watermark = array size
    arrive_owner = {}  # (s, i) -> slot   (fwd wire awaiting consumption)
    input_owner = {}   # (s, i) -> slot   (saved fwd input awaiting bwd)
    cot_owner = {}     # (s, i) -> slot   (cotangent awaiting bwd)
    free = {"arr": [set() for _ in range(pp)],
            "inp": [set() for _ in range(pp)],
            "cot": [set() for _ in range(pp)]}
    high = {"arr": [0] * pp, "inp": [0] * pp, "cot": [0] * pp}

    def take(kind, r):
        pool = free[kind][r]
        if pool:
            return pool.pop()
        slot = high[kind][r]
        high[kind][r] += 1
        return slot

    def give(kind, r, slot):
        free[kind][r].add(slot)

    cols = ["fwd_mb", "fwd_chunk", "fwd_read", "fwd_save", "fwd_recv",
            "bwd_mb", "bwd_chunk", "bwd_read", "cot_read", "cot_recv"]
    rows = {k: [] for k in cols}
    # wires in flight: sent at tick t, land at t+1
    fly_fwd = [None] * pp   # per SOURCE rank: (s, i) the wire carries
    fly_cot = [None] * pp

    t = 0
    limit = 4 * (M * S + S * S + 16)  # far above any legit schedule
    while len(bwd_done) < S * M:
        if t > limit:
            raise AssertionError(
                "pipeline scheduler failed to converge (pp=%d v=%d M=%d)"
                % (pp, v, M))
        row = {k: [-1] * pp for k in cols}

        # -- land last tick's wires ----------------------------------
        landed_fwd = [None] * pp
        landed_cot = [None] * pp
        for src in range(pp):
            if fly_fwd[src] is not None:
                s, i = fly_fwd[src]
                dst = (src + 1) % pp
                slot = take("arr", dst)
                arrive_owner[(s + 1, i)] = slot
                row["fwd_recv"][dst] = slot
                landed_fwd[dst] = (s + 1, i)
            if fly_cot[src] is not None:
                s, i = fly_cot[src]
                dst = (src - 1) % pp
                slot = take("cot", dst)
                cot_owner[(s - 1, i)] = slot
                row["cot_recv"][dst] = slot
                landed_cot[dst] = (s - 1, i)
        fly_fwd = [None] * pp
        fly_cot = [None] * pp

        for r in range(pp):
            # -- forward unit ---------------------------------------
            cands = []
            for c in range(v):
                s = c * pp + r
                for i in range(M):
                    if (s, i) in fwd_done:
                        continue
                    if s == 0 or fwd_done.get((s - 1, i), t) < t or \
                            landed_fwd[r] == (s, i):
                        # wire that landed THIS tick is readable: the
                        # stash write precedes the fwd unit in the body
                        if s == 0 or (s, i) in arrive_owner:
                            cands.append((s, i))
                    break  # per chunk, microbatches go in order
            fwd_unit = max(cands, key=lambda si: (si[0], -si[1])) \
                if cands else None
            if fwd_unit is not None:
                s, i = fwd_unit
                row["fwd_mb"][r] = i
                row["fwd_chunk"][r] = s // pp
                if s > 0:
                    slot = arrive_owner.pop((s, i))
                    row["fwd_read"][r] = slot
                    give("arr", r, slot)
                slot = take("inp", r)
                input_owner[(s, i)] = slot
                row["fwd_save"][r] = slot
                fwd_done[(s, i)] = t
                if s < S - 1:
                    fly_fwd[r] = (s, i)

            # -- backward unit --------------------------------------
            cands = []
            for c in range(v):
                s = c * pp + r
                for i in range(M):
                    if (s, i) in bwd_done:
                        continue
                    if (s, i) not in fwd_done:  # includes same-tick fwd
                        break
                    if s == S - 1 or bwd_done.get((s + 1, i), t) < t or \
                            landed_cot[r] == (s, i):
                        if s == S - 1 or (s, i) in cot_owner:
                            cands.append((s, i))
                    break
            bwd_unit = max(cands, key=lambda si: (si[0], -si[1])) \
                if cands else None
            if bwd_unit is not None:
                s, i = bwd_unit
                row["bwd_mb"][r] = i
                row["bwd_chunk"][r] = s // pp
                slot = input_owner.pop((s, i))
                row["bwd_read"][r] = slot
                give("inp", r, slot)
                if s < S - 1:
                    slot = cot_owner.pop((s, i))
                    row["cot_read"][r] = slot
                    give("cot", r, slot)
                bwd_done[(s, i)] = t
                if s > 0:
                    fly_cot[r] = (s, i)

        for k in cols:
            rows[k].append(row[k])
        t += 1

    tables = {k: np.array(rows[k], np.int32) for k in cols}
    sched = Schedule(pp, v, M, tables, max(high["arr"]), max(high["inp"]),
                     max(high["cot"]))
    _validate(sched)
    return sched


def _validate(sched):
    """Re-check the emitted tables against the dependency rules by
    simulating ONLY the tables (no scheduler state): every microbatch
    must flow 0..S-1 forward then S-1..0 backward with wire latency 1
    (strict — an upstream forward the SAME tick is a violation), and
    every stash slot read must return exactly what the schedule last
    stored there (a free-list bug would surface here, not as silently
    wrong gradients)."""
    pp, v, M, S = sched.pp, sched.v, sched.M, sched.S
    fwd_at, bwd_at = {}, {}
    # per-rank slot contents: slot index -> the (s, i) unit it serves
    arr = [dict() for _ in range(pp)]   # arrived fwd wire for unit (s,i)
    inp = [dict() for _ in range(pp)]   # saved fwd input/residuals
    cot = [dict() for _ in range(pp)]   # arrived cotangent for (s,i)
    for t in range(sched.K):
        # land wires sent at t-1 (ring: fwd +1, cot -1)
        if t > 0:
            for src in range(pp):
                i = int(sched.fwd_mb[t - 1, src])
                if i >= 0:
                    s = int(sched.fwd_chunk[t - 1, src]) * pp + src
                    if s < S - 1:
                        dst = (src + 1) % pp
                        slot = int(sched.fwd_recv[t, dst])
                        assert slot >= 0, "fwd wire landed with no slot"
                        arr[dst][slot] = (s + 1, i)
                i = int(sched.bwd_mb[t - 1, src])
                if i >= 0:
                    s = int(sched.bwd_chunk[t - 1, src]) * pp + src
                    if s > 0:
                        dst = (src - 1) % pp
                        slot = int(sched.cot_recv[t, dst])
                        assert slot >= 0, "cot wire landed with no slot"
                        cot[dst][slot] = (s - 1, i)
        for r in range(pp):
            i = int(sched.fwd_mb[t, r])
            if i >= 0:
                s = int(sched.fwd_chunk[t, r]) * pp + r
                assert (s, i) not in fwd_at, "fwd unit duplicated"
                if s == 0:
                    assert int(sched.fwd_read[t, r]) < 0, \
                        "stage 0 reads the feed, not a wire slot"
                else:
                    assert fwd_at.get((s - 1, i), t) < t, \
                        "fwd before its producer's wire can arrive"
                    slot = int(sched.fwd_read[t, r])
                    assert arr[r].get(slot) == (s, i), \
                        "fwd read a stale/foreign arrive slot"
                    del arr[r][slot]
                save = int(sched.fwd_save[t, r])
                assert save >= 0 and save not in inp[r], \
                    "fwd save slot missing or still live"
                inp[r][save] = (s, i)
                fwd_at[(s, i)] = t
            i = int(sched.bwd_mb[t, r])
            if i >= 0:
                s = int(sched.bwd_chunk[t, r]) * pp + r
                assert (s, i) not in bwd_at, "bwd unit duplicated"
                assert fwd_at.get((s, i), t + 1) <= t, "bwd before fwd"
                slot = int(sched.bwd_read[t, r])
                assert inp[r].get(slot) == (s, i), \
                    "bwd read a stale/foreign input slot"
                del inp[r][slot]
                if s == S - 1:
                    assert int(sched.cot_read[t, r]) < 0, \
                        "the last stage seeds, it has no cotangent wire"
                else:
                    assert bwd_at.get((s + 1, i), t) < t, \
                        "bwd before its consumer's cotangent can arrive"
                    slot = int(sched.cot_read[t, r])
                    assert cot[r].get(slot) == (s, i), \
                        "bwd read a stale/foreign cot slot"
                    del cot[r][slot]
                bwd_at[(s, i)] = t
    assert len(fwd_at) == S * M and len(bwd_at) == S * M, \
        "schedule incomplete"
    # classic 1F1B tick-count sanity: v=1 must match the closed form
    if v == 1:
        assert sched.K == M + 2 * pp - 2, \
            "v=1 schedule is not 1F1B-optimal: K=%d != %d" % (
                sched.K, M + 2 * pp - 2)
