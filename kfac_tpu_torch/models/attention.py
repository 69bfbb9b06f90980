"""Attention: dense causal, and ring and zigzag ring attention over the
sequence shards of a training grid (counterpart of
``kfac_tpu/models/attention.py``).

Ring attention shards the sequence over a process group (the grid's
``seq_group``) and rotates K/V blocks around the ring while the output
accumulates in the blockwise-softmax (flash) form. Every attend is
``flash_attention_partials`` at the blocks' global offsets: the kernel on
a CUDA tensor, the plain partials on a CPU tensor. The rotation is an
autograd-aware ring permute (``parallel.collectives.ring_shift``): its
backward sends the gradients the opposite way, as ``ppermute``'s
transpose does.

The causal skips are the JAX package's: the ring attends block ``src`` of
the global sequence iff ``src <= my``; zigzag gives each shard chunks
``my`` and ``2n-1-my`` and attends, per step, chunk ``my`` against the
incoming first chunk iff ``src <= my``, the mirror against it always and
the mirror against the incoming mirror iff ``src >= my`` (chunk ``my``
against the incoming mirror never: statically skipped).

A schedule (:func:`ring_schedule`, :func:`zigzag_schedule`) is the list of
steps, each with the attends it runs, their offsets and the output chunk
each merges into, and :func:`run_schedule` drives it from any source of
K/V blocks: the ring's rotation, or a list of every shard's blocks in one
process (how ``chip_smoke.py`` composes the ring on one card).

Where the JAX wrapper takes and returns natural sequence order and
permutes globally, the port keeps the zigzag layout end to end: a
``TrainGrid(zigzag=True)`` hands each rank its zigzag chunks of the
tokens (``TrainGrid.local_tokens``) and the LM adds the positions that
match (``TrainGrid.seq_positions``). Heads are whatever the caller holds:
a tensor-parallel LM's column-parallel q/k/v give each model rank its
``num_heads / model`` heads.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from kfac_tpu_torch.ops import flash_attention


def dense_causal_attention(q, k, v):
    """Single-device causal attention: (B, S, H, D) -> (B, S, H, D).

    Always the flash partials: on a CUDA tensor that is the kernel, on a
    CPU tensor the plain einsum partials.
    """
    out = _finish(flash_attention.flash_attention_partials(q, k, v, 0, 0, True))
    return out.to(q.dtype)


def _merge(carry, blk):
    """Log-sum-exp merge of two blockwise-softmax partials (flash form)."""
    acc, m, l = carry
    blk_acc, blk_m, blk_l = blk
    new_m = torch.maximum(m, blk_m)
    scale_old = torch.exp(m - new_m)
    scale_blk = torch.exp(blk_m - new_m)
    l = l * scale_old + blk_l * scale_blk
    acc = (
        acc * scale_old.transpose(1, 2)[..., None]
        + blk_acc * scale_blk.transpose(1, 2)[..., None]
    )
    return acc, new_m, l


def _finish(carry):
    """Normalize accumulated blockwise output (guarding fully-masked rows)."""
    acc, _, l = carry
    denom = torch.where(l == 0.0, 1.0, l)
    return acc / denom.transpose(1, 2)[..., None]


class Attend(NamedTuple):
    """One flash attend of a ring step: rows ``q_rows`` of the local
    queries against rows ``k_rows`` of the step's K/V block, at their
    global offsets, merged into output chunk ``carry``."""

    carry: int
    q_rows: tuple[int, int]
    k_rows: tuple[int, int]
    q_offset: int
    k_offset: int


class Schedule(NamedTuple):
    """A ring's steps for one shard: step ``i`` holds the block of shard
    ``sources[i]`` and runs ``attends[i]``; ``carries`` are the output
    chunks' row ranges, concatenated in order."""

    sources: tuple[int, ...]
    attends: tuple[tuple[Attend, ...], ...]
    carries: tuple[tuple[int, int], ...]
    causal: bool


def ring_schedule(n: int, my: int, s_local: int, causal: bool = True) -> Schedule:
    """Shard ``my`` of ``n`` holding ``s_local`` contiguous positions: step
    ``i`` brings block ``src = (my - i) % n`` and attends it unless
    ``causal`` and ``src > my`` (a block above the diagonal)."""
    sources, attends = [], []
    for i in range(n):
        src = (my - i) % n
        skip = causal and src > my
        sources.append(src)
        attends.append(() if skip else (
            Attend(0, (0, s_local), (0, s_local), my * s_local, src * s_local),
        ))
    return Schedule(tuple(sources), tuple(attends), ((0, s_local),), causal)


def zigzag_schedule(n: int, my: int, s_local: int) -> Schedule:
    """Shard ``my`` of ``n`` holding zigzag chunks ``my`` (rows ``[0, c)``)
    and ``2n-1-my`` (rows ``[c, 2c)``), ``c = s_local / 2``: two attends a
    step, three on the diagonal step (causal)."""
    if s_local % 2:
        raise ValueError('zigzag shards hold two chunks; S_local must be even')
    c = s_local // 2
    off_a, off_b = my * c, (2 * n - 1 - my) * c
    a, b = (0, c), (c, 2 * c)
    sources, attends = [], []
    for i in range(n):
        src = (my - i) % n
        k1, k2 = src * c, (2 * n - 1 - src) * c
        step = []
        if src <= my:
            step.append(Attend(0, a, a, off_a, k1))
        # the mirror q-chunk is later than every incoming first K-chunk
        step.append(Attend(1, b, a, off_b, k1))
        if src >= my:
            step.append(Attend(1, b, b, off_b, k2))
        sources.append(src)
        attends.append(tuple(step))
    return Schedule(tuple(sources), tuple(attends), (a, b), True)


def _rows(x: torch.Tensor, rows: tuple[int, int]) -> torch.Tensor:
    if rows == (0, x.shape[1]):
        return x
    return x[:, rows[0]:rows[1]].contiguous()


def run_schedule(
    q: torch.Tensor,
    schedule: Schedule,
    kv_at: Callable[[int], tuple[torch.Tensor, torch.Tensor]],
) -> torch.Tensor:
    """The attention output of ``q`` under ``schedule``: ``kv_at(i)`` gives
    step ``i``'s (K, V) block; each attend is one
    ``flash_attention_partials`` call, merged into its chunk in step
    order."""
    carries: list[Any] = [None] * len(schedule.carries)
    for i, attends in enumerate(schedule.attends):
        k, v = kv_at(i)
        for at in attends:
            blk = flash_attention.flash_attention_partials(
                _rows(q, at.q_rows), _rows(k, at.k_rows), _rows(v, at.k_rows),
                at.q_offset, at.k_offset, schedule.causal,
            )
            c = carries[at.carry]
            carries[at.carry] = blk if c is None else _merge(c, blk)
    return torch.cat([_finish(c) for c in carries], dim=1).to(q.dtype)


class _Anchor(torch.autograd.Function):
    """``out`` unchanged, with a zero gradient for ``dep``: keeps a rotated
    block that no attend used in the graph, so that every rank runs every
    rotation's backward (the ring's peers wait for it)."""

    @staticmethod
    def forward(ctx, out, dep):
        ctx.dep = (dep.shape, dep.dtype, dep.device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.dep
        return grad, torch.zeros(shape, dtype=dtype, device=device)


def _run_ring(q, k, v, group, schedule: Schedule) -> torch.Tensor:
    """``run_schedule`` with the K/V block rotating around ``group``: one
    ring permute of the stacked (K, V) a step after the first."""
    from kfac_tpu_torch.parallel import collectives

    rotated = []

    def kv_at(i):
        if not i:
            return k, v
        rotated.append(collectives.ring_shift(
            rotated[-1] if rotated else torch.stack([k, v]), group
        ))
        return rotated[-1][0], rotated[-1][1]

    out = run_schedule(q, schedule, kv_at)
    if rotated and not schedule.attends[-1] and rotated[-1].requires_grad:
        out = _Anchor.apply(out, rotated[-1])
    return out


def _ring_position(group) -> tuple[int, int]:
    if group is None or not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_group_rank(group, dist.get_rank())


def ring_attention(q, k, v, group, causal: bool = True):
    """Context-parallel attention over the sequence shards of ``group``.

    Args:
        q, k, v: this rank's contiguous sequence shard (B, S_local, H, D);
            shard ``j`` of the global sequence is on the ``j``-th rank of
            ``group``.
        group: the process group of the sequence shards (a grid's
            ``seq_group``; None: one shard).
        causal: a causal mask in *global* positions.

    Returns (B, S_local, H, D): this shard's rows of the attention output,
    the dense computation's on the gathered sequence.
    """
    n, my = _ring_position(group)
    return _run_ring(q, k, v, group, ring_schedule(n, my, q.shape[1], causal))


def zigzag_ring_attention(q, k, v, group):
    """Load-balanced causal ring attention: this rank of ``group`` holds
    zigzag chunks ``my`` and ``2n-1-my`` of the sequence (rows ``[0, c)``
    and ``[c, 2c)`` of its (B, 2c, H, D) shard, :func:`zigzag_indices`), so
    every rank attends ``2n + 1`` chunk pairs. Returns its rows of the
    output in the same layout."""
    n, my = _ring_position(group)
    return _run_ring(q, k, v, group, zigzag_schedule(n, my, q.shape[1]))


def zigzag_indices(seq_len: int, n_shards: int):
    """Permutation taking a natural-order sequence to zigzag shard layout.

    Shard j receives chunks (j, 2n-1-j) of size seq_len/(2n). Returns
    (perm, inv) index arrays: ``x_zigzag = x[:, perm]``,
    ``x_natural = y[:, inv]``.
    """
    if seq_len % (2 * n_shards):
        raise ValueError(f'{seq_len=} not divisible by 2*{n_shards=}')
    c = seq_len // (2 * n_shards)
    perm = np.concatenate([
        np.concatenate([
            np.arange(j * c, (j + 1) * c),
            np.arange((2 * n_shards - 1 - j) * c, (2 * n_shards - j) * c),
        ])
        for j in range(n_shards)
    ])
    return perm, np.argsort(perm)


def make_context_parallel_attention(
    mesh,
    axis_name: str = 'seq',
    causal: bool = True,
    zigzag: bool = False,
):
    """Ring attention over ``mesh``'s sequence shards (a
    :class:`~kfac_tpu_torch.parallel.mesh.TrainGrid`): ``fn(q, k, v)`` on
    this rank's (B, S_local, H, D) shards in the grid's layout, returning
    its rows of the output in the same layout.

    ``zigzag=True`` (causal only) is the load-balanced zigzag ring; the
    grid must lay the sequence out in zigzag chunks (``train_mesh(...,
    zigzag=True)``), as its tokens then are.
    """
    if axis_name != 'seq':
        raise ValueError(f'ring attention runs over the grid\'s seq axis, not {axis_name!r}')
    if zigzag and not causal:
        raise ValueError(
            'zigzag balances the causal workload; use zigzag=False for non-causal attention'
        )
    if bool(getattr(mesh, 'zigzag', False)) != zigzag:
        raise ValueError(
            f'zigzag={zigzag} attention on a grid whose sequence layout is '
            f'{"zigzag" if mesh.zigzag else "contiguous"}: build the grid with '
            f'train_mesh(..., zigzag={zigzag})'
        )
    group = mesh.seq_group
    if zigzag:
        return lambda q, k, v: zigzag_ring_attention(q, k, v, group)
    return lambda q, k, v: ring_attention(q, k, v, group, causal)
