"""The single-slot interleaved 1F1B pipeline over point-to-point sends
(counterpart of ``kfac_tpu/parallel/interleaved_scan.py``).

:class:`InterleavedPipelinedLM` gives each of the ``p`` pipeline ranks
``v`` model chunks: logical stage ``s = c*p + r`` lives on rank ``r`` as
its chunk ``c``, so the model has ``p * v`` logical stages. It runs the
tables of :func:`~kfac_tpu_torch.parallel.interleaved.generate_single_slot`:
at each tick a rank executes one forward (F) or one backward (B) of one
chunk for one microbatch, or idles, so fill and drain are paid in chunk
units and a rank's bubble drops to ``2*(p-1)/v`` stage units (Megatron's
interleaving, Narayanan et al. 2021, section 2.2).

The JAX package runs every tick of every rank as one ``lax.scan`` inside a
``shard_map``, switching between an idle, a forward and a backward body,
and ``ppermute``s activations and cotangents every tick, zeros where a
rank has nothing to send. Here each rank walks its own column of the same
static table:

- **F** ``(c, mb, slot)``: the stage input (stage 0: the embedded
  microbatch; else the activation inbox of chunk ``c`` at ``mb % depth``)
  is kept in the residual ring at ``slot``; below the last logical stage
  the chunk runs without a graph and its output goes to logical stage
  ``s + 1``, which is rank ``(r + 1) % p`` (on the wrap from rank ``p - 1``
  to rank 0, that rank's next chunk). The last stage's F only keeps its
  input: its B computes head and loss.
- **B** ``(c, mb, slot)``: the chunk is recomputed from the ring's input
  with the capture hooks on (A once per microbatch and chunk, G from its
  backward), then run backward: from the cotangent inbox, or, at the last
  logical stage, through the head and the loss. The input's cotangent goes
  to stage ``s - 1`` (rank ``(r - 1) % p``), or, at stage 0, to the
  embedding's backward, which runs once after the last tick.
- **Messages.** A rank derives from the table, for every tick, what its
  two neighbours send it (the previous rank's F output below the last
  stage, the next rank's B input cotangent above stage 0) and posts those
  receives with its own send in one ``batch_isend_irecv``. Every rank reads
  the same table, so each receive is posted in the tick its peer sends and
  no send goes unmatched: the ring of sends from rank ``p - 1`` back to
  rank 0 cannot deadlock. With one rank (``p = 1``) the messages stay in
  the process. Inboxes are indexed ``mb % depth`` by the depths the
  generator proved.

The ring holds ``2*(p-1) + (v-1)*p + 1`` stage inputs (the interleaved
warmup depth) against 1F1B's ``2*p - 1``: the deeper in-flight set is
the price of the smaller bubble. Each rank counts the F, B and idle ticks
it executed; :meth:`InterleavedPipelinedLM.tick_report` holds them against
the table.

A rank's ``stage`` module holds its chunks as ``chunk0``, ``chunk1``, ...,
so its registry (and :class:`~kfac_tpu_torch.parallel.pipeline.PipelineKFAC`'s
state) covers its ``v`` chunks' layers, in chunk order.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from kfac_tpu_torch.parallel import collectives
from kfac_tpu_torch.parallel import interleaved as interleaved_lib
from kfac_tpu_torch.parallel import pipeline as pipeline_lib


def logical_to_stack(p: int, v: int, s: int) -> int:
    """Stack index (rank-major ``r*v + c``) of logical stage ``s = c*p + r``
    in the JAX package's stage-stacked parameters."""
    return (s % p) * v + s // p


class Chunks(nn.Module):
    """A pipeline rank's model chunks, ``chunk0`` ... ``chunk{v-1}``: chunk
    ``c`` is logical stage ``c * p + rank``. It is not a chain: the
    schedule calls each chunk on its own."""

    def __init__(self, chunks: Sequence[nn.Module]):
        super().__init__()
        for c, mod in enumerate(chunks):
            self.add_module(f'chunk{c}', mod)

    def chunk(self, c: int) -> nn.Module:
        return getattr(self, f'chunk{c}')


class InterleavedPipelinedLM(pipeline_lib.PipelinedLM):
    """Decoder LM pipelined with ``virtual_chunks`` model chunks a rank
    under the single-slot interleaved 1F1B schedule.

    The arguments are :class:`~kfac_tpu_torch.parallel.pipeline.PipelinedLM`'s
    (its ``schedule`` is ``'interleaved'``); ``n_stages`` is the logical
    stage count ``p * virtual_chunks``, ``num_layers`` must divide by it,
    and ``n_microbatches`` must be a positive multiple of the rank count
    ``p`` (Megatron's constraint; the schedule generator raises otherwise).
    ``seed`` draws the weights in ``TransformerLM``'s order, so logical
    stage ``s`` holds the blocks ``s * k`` to ``(s + 1) * k - 1`` of the
    ``TransformerLM`` of that seed. ``params`` (this rank's full
    ``state_dict``, ``convert.from_flax_interleaved_params``) replaces the
    drawn weights.
    """

    def __init__(self, grid: Any, *args, virtual_chunks: int = 2, **kwargs):
        if virtual_chunks < 1:
            raise ValueError(f'virtual_chunks must be >= 1, got {virtual_chunks}')
        # the table first: it raises for microbatches that are not a
        # multiple of the ranks before any process group is touched
        sched = interleaved_lib.generate_single_slot(
            grid.n_stages, int(virtual_chunks), int(kwargs.get('n_microbatches', 4))
        )
        # read by PipelinedLM.__init__ (_chunks_per_rank) before it builds
        # the stage modules and the registry
        self.virtual_chunks = int(virtual_chunks)
        kwargs['schedule'] = 'interleaved'
        super().__init__(grid, *args, **kwargs)
        self.p_ranks = grid.n_stages
        self._sched = sched
        self.last_ticks: list[int] | None = None  # (F, B, idle) of the last run

    def _chunks_per_rank(self) -> int:
        return self.virtual_chunks

    def _executes_interleaved(self) -> bool:
        return True

    def _stage_of(self, mine: list[nn.Module]) -> nn.Module:
        return Chunks(mine)

    def _schedule_fn(self) -> Callable:
        return self._interleaved

    @torch.no_grad()
    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            'the forward-only apply() path runs the plain per-rank pipeline and does not '
            'understand virtual chunks; use loss_and_stats (the single-slot schedule) or a '
            'PipelinedLM'
        )

    # --------------------------------------------------------------- body

    def _interleaved(self, tokens, targets, total, taps) -> torch.Tensor:
        """This rank's column of the single-slot table, tick by tick;
        returns the summed loss of the microbatches whose last stage ran
        here (zero elsewhere)."""
        grid = self.grid
        p, v, m = self.p_ranks, self.virtual_chunks, self.n_microbatches
        r = grid.stage
        sched = self._sched
        ops = sched.ops
        d_act, d_cot = sched.act_depth, sched.cot_depth
        last = p * v - 1
        shape = tokens.shape[1:] + (self.d_model,)
        nxt, prv = (r + 1) % p, (r - 1) % p
        feed, leaf = self._feed(tokens) if r == 0 else (None, None)
        ring: list[torch.Tensor | None] = [None] * sched.ring
        act: list[list[torch.Tensor | None]] = [[None] * d_act for _ in range(v)]
        cot: list[list[torch.Tensor | None]] = [[None] * d_cot for _ in range(v)]
        xbars: list[torch.Tensor | None] = [None] * m
        loss = torch.zeros((), device=grid.device)
        counts = [0, 0, 0]
        for t in range(sched.ticks):
            kind, c, mb, slot = (int(x) for x in ops[t, r])
            s = c * p + r
            out = None  # (tensor, 'act' or 'cot', destination chunk, microbatch)
            if kind == 0:  # F: keep the stage input, send the output on
                x_in = leaf[mb] if s == 0 else act[c][mb % d_act]
                act[c][mb % d_act] = None
                ring[slot] = x_in
                if s < last:
                    taps.active = False
                    with torch.no_grad():
                        y = self.stage.chunk(c)(x_in)
                    out = (y, 'act', (s + 1) // p, mb)
                counts[0] += 1
            elif kind == 1:  # B: recompute under the hooks, then backward
                x = ring[slot].detach().requires_grad_(True)
                ring[slot] = None
                taps.active = True
                y = self.stage.chunk(c)(x)
                taps.active = False
                if s == last:  # head, loss and cotangent from the saved input
                    lval = self._nll(y, targets[mb]).sum() / total
                    lval.backward()
                    loss = loss + lval.detach()
                else:
                    torch.autograd.backward(y, cot[c][mb % d_cot])
                    cot[c][mb % d_cot] = None
                if s > 0:
                    out = (x.grad, 'cot', (s - 1) // p, mb)
                else:
                    xbars[mb] = x.grad
                counts[1] += 1
            else:
                counts[2] += 1
            if p == 1:  # the messages stay in this process
                if out is not None:
                    box, depth = (act, d_act) if out[1] == 'act' else (cot, d_cot)
                    box[out[2]][out[3] % depth] = out[0]
                continue
            sends = []
            if out is not None:
                sends.append((out[0], self._peer(nxt if out[1] == 'act' else prv)))
            recvs = []
            # what the neighbours send this tick, from their columns
            k_p, c_p, mb_p, _ = (int(x) for x in ops[t, prv])
            if k_p == 0 and c_p * p + prv < last:  # its output, to stage s + 1 here
                buf = self._buffer(shape)
                act[(c_p * p + prv + 1) // p][mb_p % d_act] = buf
                recvs.append((buf, self._peer(prv)))
            k_n, c_n, mb_n, _ = (int(x) for x in ops[t, nxt])
            if k_n == 1 and c_n * p + nxt > 0:  # its input cotangent, to stage s - 1 here
                buf = self._buffer(shape)
                cot[(c_n * p + nxt - 1) // p][mb_n % d_cot] = buf
                recvs.append((buf, self._peer(nxt)))
            collectives.exchange(sends, recvs)
        self.last_ticks = counts
        if r == 0:
            feed.backward(torch.stack(xbars))
        return loss

    # --------------------------------------------------------------- loss

    def loss_stats_and_ticks(self, batch: Any, capture: bool = True):
        """:meth:`loss_and_stats` plus the executed ``(F, B, idle)`` tick
        counts of every pipe rank, ``(p, 3)`` int64 on the host (one
        all-gather over the pipe group), which :meth:`tick_report` holds
        against the table."""
        loss, grads, stats = self.loss_and_stats(batch, capture=capture)
        mine = torch.tensor(self.last_ticks, dtype=torch.int64, device=self.grid.device)
        if self.p_ranks > 1:
            rows = [torch.empty_like(mine) for _ in range(self.p_ranks)]
            dist.all_gather(rows, mine, group=self.grid.pipe_group)
            mine = torch.stack(rows)
        else:
            mine = mine[None]
        return loss, grads, stats, mine.cpu().numpy()

    # ------------------------------------------------------------- report

    def tick_report(self, tick_counts=None) -> dict[str, Any]:
        """The schedule's accounting: the table's per-rank F, B and idle
        slot counts, its ticks and bubble slots (a count of idle (rank,
        tick) slots, not a measured time); with ``tick_counts`` (the
        ``(p, 3)`` counts of :meth:`loss_stats_and_ticks`) also the
        executed counts and whether they match the table."""
        sched = self._sched
        kinds = np.asarray(sched.ops)[:, :, 0]
        predicted = np.stack(
            [(kinds == 0).sum(0), (kinds == 1).sum(0), (kinds < 0).sum(0)], axis=1
        )
        p = self.p_ranks
        out = {
            'schedule': self.schedule,
            'p_ranks': p,
            'virtual_chunks': self.virtual_chunks,
            'n_microbatches': self.n_microbatches,
            'ticks': int(sched.ticks),
            'bubble_slots': int(sched.bubble_slots()),
            'bubble_fraction': float(sched.bubble_slots()) / float(sched.ticks * p),
            'ring': int(sched.ring),
            'predicted': {
                'executed_f': predicted[:, 0].tolist(),
                'executed_b': predicted[:, 1].tolist(),
                'idle': predicted[:, 2].tolist(),
            },
        }
        if tick_counts is not None:
            executed = np.asarray(tick_counts)
            out['executed'] = {
                'executed_f': executed[:, 0].tolist(),
                'executed_b': executed[:, 1].tolist(),
                'idle': executed[:, 2].tolist(),
            }
            out['matches_schedule'] = bool((executed == predicted).all())
        return out
