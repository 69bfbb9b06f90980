"""Interleaved (virtual-stage) 1F1B schedule generation (the port's copy
of ``kfac_tpu/parallel/interleaved.py``, pure numpy, element for element
the same tables).

Megatron-LM's interleaved schedule (Narayanan et al. 2021, section 2.2)
assigns each pipeline rank ``v`` model chunks (logical stages ``s = c*p +
r``) and reduces the 1F1B bubble from ``(p-1)*(tf+tb)`` to
``(p-1)*(tf+tb)/v``: fill and drain are paid in chunk units instead of
whole-device-stage units.

It runs on the host once per model to produce static per-tick lookup
tables: :func:`generate_single_slot`'s drive
:class:`~kfac_tpu_torch.parallel.interleaved_scan.InterleavedPipelinedLM`
(every rank reads the same table, so each point-to-point send is matched
by a receive posted in the same tick), and :func:`generate`'s two-slot
tables are kept for the schedule comparison.

Slot encoding: each tick, each rank executes at most one F chunk and one
B chunk. A table entry is ``(chunk, microbatch)`` or ``(-1, -1)`` (idle).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class InterleavedSchedule(NamedTuple):
    """Static schedule tables for one (p, v, m) configuration.

    ``f`` / ``b``: int32 arrays (ticks, p, 2) — per tick and rank, the
    (chunk, microbatch) of the forward / backward chunk-execution, or
    (-1, -1) when that slot is idle. ``ticks``: total tick count.
    """

    f: np.ndarray
    b: np.ndarray
    ticks: int

    @property
    def p(self) -> int:
        return self.f.shape[1]

    def bubble_slots(self) -> int:
        """Total idle slots (F + B) across all ranks — the bubble, in
        chunk-execution units."""
        idle_f = int((self.f[:, :, 0] < 0).sum())
        idle_b = int((self.b[:, :, 0] < 0).sum())
        return idle_f + idle_b


def _chunk_of(k: int, p: int, v: int) -> int:
    """Model chunk executed by the k-th F (or B) slot of a rank
    (Megatron's get_model_chunk_id): ranks cycle chunks in blocks of p."""
    return (k % (p * v)) // p


def _microbatch_of(k: int, p: int, v: int) -> int:
    """Microbatch of a rank's k-th F slot under block-of-p interleaving:
    group g = k // (p*v) covers microbatches [g*p, (g+1)*p)."""
    return (k // (p * v)) * p + k % p


class SingleSlotSchedule(NamedTuple):
    """Static tables for the SINGLE-SLOT interleaved scan: one F *or* B
    chunk execution per rank per tick (the model that realizes Megatron's
    full (p-1)/v bubble reduction — the 2-slot tables of :func:`generate`
    cap the gain at ~25% because fill ticks waste the paired B slot).

    ``ops``: int32 (ticks, p, 4): per tick and rank,
    ``(kind, chunk, mb, slot)`` with kind 0=F / 1=B / -1=idle; ``slot`` is
    the residual-ring slot the F stores its stage input into (and the
    matching B reads from — allocated here so the scan needs no runtime
    free-list).
    ``ring``: residual-ring depth (max concurrently stored stage inputs on
    any rank).
    ``act_depth`` / ``cot_depth``: per-(rank, chunk) inbox depths for
    in-flight activations / cotangents (messages are produced and consumed
    in microbatch order per (rank, chunk), so an inbox indexed by
    ``mb % depth`` can never collide).
    """

    ops: np.ndarray
    ticks: int
    ring: int
    act_depth: int
    cot_depth: int

    @property
    def p(self) -> int:
        return self.ops.shape[1]

    def bubble_slots(self) -> int:
        """Total idle (rank, tick) slots — the bubble in chunk units."""
        return int((self.ops[:, :, 0] < 0).sum())


def generate_single_slot(p: int, v: int, m: int) -> SingleSlotSchedule:
    """Event-driven single-slot interleaved 1F1B.

    Per rank, ops run in Megatron's strict order — warmup F's
    (``min((p-r-1)*2 + (v-1)*p, total)``), then alternating F/B pairs,
    then the remaining B's — each at the earliest tick its dependencies
    allow:

    - F(s, mb) needs F(s-1, mb) at a strictly earlier tick (activations
      ppermute between ticks);
    - B(s, mb) needs its own F strictly earlier (it reads the saved stage
      input; same rank, so different tick by construction) and, below the
      last logical stage, B(s+1, mb) strictly earlier (cotangents
      ppermute between ticks). The LAST stage's B computes
      head+loss+cotangent in-op from the saved input, so it has no
      external cotangent dependency.
    - Exactly one op per rank per tick.
    """
    if m % p != 0 or m <= 0:
        raise ValueError(
            f'interleaved 1F1B needs microbatches ({m}) to be a positive '
            f'multiple of pipeline ranks ({p})'
        )
    if v < 1:
        raise ValueError(f'chunks per rank must be >= 1, got {v}')
    total = m * v
    last_stage = p * v - 1
    warmup = [min((p - r - 1) * 2 + (v - 1) * p, total) for r in range(p)]

    def f_slot(r: int, k: int) -> tuple[int, int, int]:
        c = _chunk_of(k, p, v)
        return c * p + r, c, _microbatch_of(k, p, v)

    def b_slot(r: int, k: int) -> tuple[int, int, int]:
        c = v - 1 - _chunk_of(k, p, v)
        return c * p + r, c, _microbatch_of(k, p, v)

    # strict per-rank op order: warmup F's, then F,B,F,B..., then B tail
    orders: list[list[tuple[str, int]]] = []
    for r in range(p):
        seq: list[tuple[str, int]] = [('F', k) for k in range(warmup[r])]
        kf, kb = warmup[r], 0
        while kf < total or kb < total:
            if kf < total:
                seq.append(('F', kf))
                kf += 1
            if kb < total:
                seq.append(('B', kb))
                kb += 1
        orders.append(seq)

    f_done: dict[tuple[int, int], int] = {}
    b_done: dict[tuple[int, int], int] = {}
    nxt = [0] * p
    rows: list[np.ndarray] = []
    # residual-ring allocation: per rank, F takes the smallest free slot,
    # its B frees it
    free: list[list[int]] = [[] for _ in range(p)]
    grown = [0] * p
    slot_of: dict[tuple[int, int], int] = {}  # (stage, mb) -> slot
    ring = 0
    # inbox occupancy tracking -> depths
    act_live: dict[tuple[int, int], int] = {}
    cot_live: dict[tuple[int, int], int] = {}
    act_depth = 1
    cot_depth = 1

    tick = 0
    while any(nxt[r] < len(orders[r]) for r in range(p)):
        row = np.full((p, 4), -1, np.int32)
        fired: list[tuple[str, int, int, int]] = []  # (kind, r, stage, mb)
        for r in range(p):
            if nxt[r] >= len(orders[r]):
                continue
            kind, k = orders[r][nxt[r]]
            if kind == 'F':
                s, c, mb = f_slot(r, k)
                if s == 0 or f_done.get((s - 1, mb), tick) < tick:
                    if free[r]:
                        slot = free[r].pop(0)
                    else:
                        slot = grown[r]
                        grown[r] += 1
                        ring = max(ring, grown[r])
                    slot_of[(s, mb)] = slot
                    row[r] = (0, c, mb, slot)
                    fired.append(('F', r, s, mb))
                    nxt[r] += 1
            else:
                s, c, mb = b_slot(r, k)
                f_ok = f_done.get((s, mb), tick) < tick
                cot_ok = (
                    s == last_stage
                    or b_done.get((s + 1, mb), tick) < tick
                )
                if f_ok and cot_ok:
                    slot = slot_of.pop((s, mb))
                    free[r].append(slot)
                    free[r].sort()
                    row[r] = (1, c, mb, slot)
                    fired.append(('B', r, s, mb))
                    nxt[r] += 1
        # inbox accounting: within a tick, consumes (reads during the tick)
        # strictly precede produces (ppermute delivery at tick end), so a
        # same-tick consume+produce on one inbox never double-counts
        for kind, r, s, mb in fired:
            if kind == 'F':
                f_done[(s, mb)] = tick
                if s > 0:  # consumed its activation message
                    key = (r, s // p)
                    act_live[key] = act_live.get(key, 0) - 1
            else:
                b_done[(s, mb)] = tick
                if s < last_stage:  # consumed its cotangent message
                    key = (r, s // p)
                    cot_live[key] = cot_live.get(key, 0) - 1
        for kind, r, s, mb in fired:
            if kind == 'F':
                if s < last_stage:  # output message to the next stage
                    nr, nc = (s + 1) % p, (s + 1) // p
                    act_live[(nr, nc)] = act_live.get((nr, nc), 0) + 1
                    act_depth = max(act_depth, act_live[(nr, nc)])
            else:
                if s > 0:  # cotangent message to the previous stage
                    nr, nc = (s - 1) % p, (s - 1) // p
                    cot_live[(nr, nc)] = cot_live.get((nr, nc), 0) + 1
                    cot_depth = max(cot_depth, cot_live[(nr, nc)])
        rows.append(row)
        tick += 1
        if tick > 8 * (2 * total + 2 * p * v):
            raise RuntimeError(
                f'single-slot schedule deadlocked at tick {tick} '
                f'(p={p}, v={v}, m={m}, nxt={nxt})'
            )

    return SingleSlotSchedule(
        ops=np.stack(rows), ticks=tick, ring=max(ring, 1),
        act_depth=act_depth, cot_depth=cot_depth,
    )


def generate(p: int, v: int, m: int) -> InterleavedSchedule:
    """Event-driven interleaved 1F1B: per rank, Megatron's slot order
    (warmup F's, steady 1F1B pairs, cooldown B's), each slot issued at the
    earliest tick its cross-rank dependency allows.

    Constraints honored (asserted in tests):
    - F(s, mb) requires F(s-1, mb) at a strictly earlier tick (the
      activation ppermutes between ticks); s = c*p + r, so s-1 is the
      previous rank (same chunk) or rank p-1 of the previous chunk.
    - B(s, mb) requires B(s+1, mb) strictly earlier, and B of the LAST
      logical stage runs in the same tick as its F (the in-tick pivot the
      non-interleaved scan already uses).
    - One F slot and one B slot per rank per tick.

    ``m`` must be a positive multiple of ``p`` (Megatron's interleaving
    constraint; pad the microbatch count up, exactly like the
    non-interleaved path pads batch to microbatches).
    """
    if m % p != 0 or m <= 0:
        raise ValueError(
            f'interleaved 1F1B needs microbatches ({m}) to be a positive '
            f'multiple of pipeline ranks ({p})'
        )
    if v < 1:
        raise ValueError(f'chunks per rank must be >= 1, got {v}')
    total = m * v  # F slots per rank (== B slots per rank)
    last_stage = p * v - 1

    # Per-rank slot orders, Megatron style: rank r runs
    # warmup = min((p - r - 1)*2 + (v - 1)*p, total) F's, then 1F1B pairs,
    # then the remaining B's. B order is the F order of the REVERSED chunk
    # sequence (chunk v-1 first).
    warmup = [min((p - r - 1) * 2 + (v - 1) * p, total) for r in range(p)]

    f_done: dict[tuple[int, int], int] = {}  # (stage, mb) -> tick
    b_done: dict[tuple[int, int], int] = {}
    nf = [0] * p  # next F slot index per rank
    nb = [0] * p
    f_rows: list[np.ndarray] = []
    b_rows: list[np.ndarray] = []

    def f_slot(r: int, k: int) -> tuple[int, int, int]:
        c = _chunk_of(k, p, v)
        return c * p + r, c, _microbatch_of(k, p, v)

    def b_slot(r: int, k: int) -> tuple[int, int, int]:
        c = v - 1 - _chunk_of(k, p, v)
        return c * p + r, c, _microbatch_of(k, p, v)

    tick = 0
    while min(nb) < total:
        f_row = np.full((p, 2), -1, np.int32)
        b_row = np.full((p, 2), -1, np.int32)
        fired_f: list[tuple[int, int]] = []  # (stage, mb)
        fired_b: list[tuple[int, int]] = []
        for r in range(p):
            # F slot: fire when the activation dependency is met AND the
            # in-flight count (F's without their B) stays within the
            # warmup depth — Megatron's steady loop pairs each post-warmup
            # F with a B, which in the per-tick (F, B) slot model is
            # exactly this bound (the same-tick B restores it).
            if nf[r] < total and nf[r] - nb[r] <= warmup[r]:
                s, c, mb = f_slot(r, nf[r])
                if s == 0 or f_done.get((s - 1, mb), tick) < tick:
                    f_row[r] = (c, mb)
                    fired_f.append((s, mb))
                    nf[r] += 1
            # B slot: needs its own F done (same tick allowed: the
            # last-stage in-tick pivot) and the upstream cotangent
            # B(s+1) from a strictly earlier tick (it ppermutes between
            # ticks).
            if nb[r] < total:
                s, c, mb = b_slot(r, nb[r])
                f_ok = (
                    f_done.get((s, mb), tick + 1) <= tick
                    or (s, mb) in fired_f
                )
                if s == last_stage:
                    cot_ok = f_ok
                else:
                    cot_ok = b_done.get((s + 1, mb), tick) < tick
                if f_ok and cot_ok:
                    b_row[r] = (c, mb)
                    fired_b.append((s, mb))
                    nb[r] += 1
        for s, mb in fired_f:
            f_done[(s, mb)] = tick
        for s, mb in fired_b:
            b_done[(s, mb)] = tick
        f_rows.append(f_row)
        b_rows.append(b_row)
        tick += 1
        if tick > 4 * (total + 2 * p * v):  # safety: schedule must make progress
            raise RuntimeError(
                f'interleaved schedule deadlocked at tick {tick} '
                f'(p={p}, v={v}, m={m}, nf={nf}, nb={nb})'
            )

    return InterleavedSchedule(
        f=np.stack(f_rows), b=np.stack(b_rows), ticks=tick
    )
