"""Symmetric and bucketed factor transport, and the collectives of the
distributed engine (counterpart of ``kfac_tpu/parallel/collectives.py``).

The transport encoding is the JAX package's: the upper triangle of a
symmetric factor carries half its bytes (:func:`get_triu` /
:func:`fill_triu`), and flat buffers capped in bytes trade many small
collectives for a few large ones (:func:`concat_flat_chunked`,
:func:`plan_chunks`, :func:`split_flat_chunked`).

Under XLA the collectives are implicit, placed by sharding constraints;
here they are explicit ``torch.distributed`` calls: ``all_reduce``,
``all_gather`` and (the compressed stat transport's) ``reduce_scatter``,
which NCCL and gloo both have, so the CPU tests run the path the card
runs.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

# ---------------------------------------------------------------- triangles


def get_triu(x: torch.Tensor) -> torch.Tensor:
    """The upper triangle (diagonal included) of a square matrix, row by
    row, as a flat vector."""
    if x.ndim != 2 or x.shape[0] != x.shape[1]:
        raise ValueError(f'expected square matrix, got shape {tuple(x.shape)}')
    rows, cols = torch.triu_indices(x.shape[0], x.shape[0], device=x.device)
    return x[rows, cols]


def fill_triu(shape: tuple[int, int], triu: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`get_triu`: the symmetric matrix."""
    n = shape[0]
    rows, cols = torch.triu_indices(n, n, device=triu.device)
    out = torch.zeros(shape, dtype=triu.dtype, device=triu.device)
    out[rows, cols] = triu
    lower = out.T - torch.diag(torch.diag(out))
    return out + lower


# ------------------------------------------------------------- flat buffers

Spec = tuple[tuple[int, ...], int, torch.dtype]


def concat_flat(tensors: Sequence[torch.Tensor]) -> tuple[torch.Tensor, list[Spec]]:
    """Flatten and concatenate ``tensors`` into one buffer of their
    promoted dtype; returns it and each tensor's (shape, size, dtype) for
    :func:`split_flat`."""
    specs = [(tuple(t.shape), t.numel(), t.dtype) for t in tensors]
    if not tensors:
        return torch.zeros((0,)), specs
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.cat([t.reshape(-1).to(dtype) for t in tensors]), specs


def split_flat(flat: torch.Tensor, specs: Sequence[Spec]) -> list[torch.Tensor]:
    """Inverse of :func:`concat_flat` (shapes and dtypes restored; views of
    ``flat`` where the dtype is unchanged)."""
    out, offset = [], 0
    for shape, size, dtype in specs:
        out.append(flat[offset:offset + size].reshape(shape).to(dtype))
        offset += size
    return out


def _dtype_info(dtype: Any) -> tuple[Any, int, str]:
    """(dtype, itemsize, numpy-style name) of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype, dtype.itemsize, str(dtype).removeprefix('torch.')
    dt = np.dtype(dtype)
    return dt, dt.itemsize, str(dt)


def _promote(a: Any, b: Any) -> Any:
    if isinstance(a, torch.dtype) and isinstance(b, torch.dtype):
        return torch.promote_types(a, b)
    return np.result_type(a, b)


def concat_flat_chunked(
    tensors: Sequence[torch.Tensor],
    max_bytes: int | float | None = None,
) -> list[tuple[torch.Tensor, list[Spec]]]:
    """:func:`concat_flat` with a byte cap per buffer: greedy in order, a
    new chunk starting where the next tensor would push the current one
    past ``max_bytes`` at the promoted dtype (a tensor larger than the cap
    gets a chunk of its own, never split). ``None`` packs one buffer."""
    if max_bytes is None or not tensors:
        return [concat_flat(tensors)]
    chunks = []
    cur: list[torch.Tensor] = []
    cur_elems, cur_dtype = 0, None
    for t in tensors:
        new_dtype = t.dtype if cur_dtype is None else torch.promote_types(cur_dtype, t.dtype)
        new_elems = cur_elems + t.numel()
        if cur and new_elems * new_dtype.itemsize > max_bytes:
            chunks.append(concat_flat(cur))
            cur = []
            new_dtype, new_elems = t.dtype, t.numel()
        cur.append(t)
        cur_elems, cur_dtype = new_elems, new_dtype
    chunks.append(concat_flat(cur))
    return chunks


def plan_chunks(
    specs: Sequence[tuple[int, Any]],
    max_bytes: int | float | None = None,
) -> list[dict[str, Any]]:
    """:func:`concat_flat_chunked`'s packing from ``(n_elements, dtype)``
    specs alone (torch or numpy dtypes), for the comms accounting: one
    ``{'tensors', 'elements', 'bytes', 'dtype'}`` a chunk."""

    def chunk(elems: int, count: int, dtype: Any) -> dict[str, Any]:
        _, item, name = _dtype_info(dtype)
        return {'tensors': count, 'elements': elems, 'bytes': elems * item, 'dtype': name}

    if not specs:
        return []
    if max_bytes is None:
        dtype = specs[0][1]
        for _, dt in specs[1:]:
            dtype = _promote(dtype, dt)
        return [chunk(sum(int(n) for n, _ in specs), len(specs), dtype)]
    chunks: list[dict[str, Any]] = []
    cur_count, cur_elems, cur_dtype = 0, 0, None
    for n, dt in specs:
        new_dtype = dt if cur_dtype is None else _promote(cur_dtype, dt)
        new_elems = cur_elems + int(n)
        if cur_count and new_elems * _dtype_info(new_dtype)[1] > max_bytes:
            chunks.append(chunk(cur_elems, cur_count, cur_dtype))
            cur_count = 0
            new_dtype, new_elems = dt, int(n)
        cur_count += 1
        cur_elems, cur_dtype = new_elems, new_dtype
    chunks.append(chunk(cur_elems, cur_count, cur_dtype))
    return chunks


def split_flat_chunked(
    chunks: Sequence[tuple[torch.Tensor, list[Spec]]],
) -> list[torch.Tensor]:
    """Inverse of :func:`concat_flat_chunked` (the original order)."""
    out: list[torch.Tensor] = []
    for flat, specs in chunks:
        out.extend(split_flat(flat, specs))
    return out


# -------------------------------------------------------------- collectives


def all_reduce_sum(tensors: Sequence[torch.Tensor], group: Any = None) -> list[torch.Tensor]:
    """The sum over the ranks of ``group`` of each tensor, one
    ``all_reduce`` a tensor (contiguous copies; the inputs are untouched)."""
    out = []
    for t in tensors:
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        out.append(t)
    return out


def all_reduce_sum_flat(
    tensors: Sequence[torch.Tensor],
    group: Any = None,
    max_bytes: int | float | None = None,
) -> list[torch.Tensor]:
    """:func:`all_reduce_sum` through flat buffers of at most ``max_bytes``
    (:func:`concat_flat_chunked`): one ``all_reduce`` a buffer."""
    chunks = concat_flat_chunked(list(tensors), max_bytes)
    for flat, _ in chunks:
        dist.all_reduce(flat, group=group)
    return split_flat_chunked(chunks)


def mean_grads(
    grads: dict[str, torch.Tensor],
    group: Any = None,
    max_bytes: int | float | None = None,
    extra: Sequence[torch.Tensor] = (),
) -> tuple[dict[str, torch.Tensor], list[torch.Tensor]]:
    """The mean over the ranks of ``group`` of a grads dict, bucketed into
    flat buffers of at most ``max_bytes`` (the data-parallel gradient
    reduction that pjit performs implicitly); ``extra`` tensors (a loss)
    ride in the same buffers. Returns the mean grads and the mean extras."""
    names = list(grads)
    world = dist.get_world_size(group)
    summed = all_reduce_sum_flat([grads[n] for n in names] + list(extra), group, max_bytes)
    mean = [t / world for t in summed]
    return dict(zip(names, mean[:len(names)])), mean[len(names):]


def reduce_scatter(out: torch.Tensor, full: torch.Tensor, group: Any = None) -> None:
    """Rank r's ``out`` becomes elements ``[r * n, (r + 1) * n)`` of the
    sum over the ranks of ``full`` (``n = out.numel()``)."""
    # reduce_scatter_single is the newer name of reduce_scatter_tensor
    op = getattr(dist, 'reduce_scatter_single', None) or dist.reduce_scatter_tensor
    op(out, full, group=group)


def all_gather_cat(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """Each rank's ``x`` (one shape on every rank) concatenated along the
    leading axis in the order of the group's ranks."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)
