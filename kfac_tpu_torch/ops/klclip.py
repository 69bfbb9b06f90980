"""kl-clip multiply-reduce and scale (counterpart of the kl-clip half of
``kfac_tpu/ops/pallas_ns.py``).

On CUDA tensors both run the CUDA kernels of ``kfac_tpu_torch/csrc/klclip.cu``,
one launch for a list of tensors: the dot ``klclip_dot_multi_f32``, which
also folds the layers' terms into the kl-clip scale on the device, and the
scale ``klclip_scale_multi_f32``. On CPU tensors each wrapper runs the plain
version beside it.
"""

from __future__ import annotations

import array
import ctypes
import functools
from collections.abc import Sequence

import torch

from kfac_tpu_torch.ops import build

# elements a block of either kernel covers: kBlockElems in csrc/klclip.cu
BLOCK_ELEMS = 4096
# tensors one launch takes: kMaxTensors in csrc/klclip.cu
TABLE_CAPACITY = 96


def klclip_dot_plain(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 scalar ``sum(p * g)``."""
    return torch.sum(p.float() * g.float())


def kl_clip_scale_plain(
    vg_sum: torch.Tensor, kl_clip: float | torch.Tensor
) -> torch.Tensor:
    """Plain version of the scale the dot kernel ends with:
    ``min(1, sqrt(kl_clip / |vg_sum|))``, 1 where the sum is zero, NaN where
    it is NaN."""
    vg_abs = torch.abs(vg_sum)
    zero = vg_abs == 0.0
    safe = torch.where(zero, torch.ones_like(vg_abs), vg_abs)
    scale = torch.clamp(torch.sqrt(kl_clip / safe), max=1.0)
    return torch.where(zero, torch.ones_like(scale), scale)


def klclip_dot_many_plain(
    ps: Sequence[torch.Tensor], gs: Sequence[torch.Tensor], lr: float, kl_clip: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`klclip_dot_many`: each layer's
    ``sum(p * g) * lr**2``, Python's ``sum`` over the layers, then the
    scale: the engine's expression before the grouped kernel."""
    terms = [klclip_dot_plain(p, g) * (lr ** 2) for p, g in zip(ps, gs)]
    vg_sum = sum(terms)
    return torch.stack(terms), vg_sum, kl_clip_scale_plain(vg_sum, kl_clip)


def klclip_scale_plain(p: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: ``p * scale`` in f32."""
    return p.float() * scale


def klclip_scale_many_plain(
    ps: Sequence[torch.Tensor], scale: torch.Tensor
) -> list[torch.Tensor]:
    """Plain version of :func:`klclip_scale_many`: ``p * scale`` in f32 for
    each tensor."""
    return [klclip_scale_plain(p, scale) for p in ps]


@functools.cache
def _dot_launcher():
    fn = build.library('klclip').klclip_dot_multi_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def klclip_dot_many(
    ps: Sequence[torch.Tensor],
    gs: Sequence[torch.Tensor],
    lr: float,
    kl_clip: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kl-clip reduction of every layer: ``(terms, vg_sum, scale)``,
    device tensors of shape (T,), () and ():

    - ``terms[t] = sum(ps[t] * gs[t]) * f32(lr**2)``;
    - ``vg_sum``, the terms added left to right, as ``sum(terms)``;
    - ``scale = min(1, sqrt(kl_clip / |vg_sum|))``, 1 where the sum is 0.

    ``ps[t]`` and ``gs[t]`` share a shape; ``lr`` and ``kl_clip`` are host
    floats. CUDA tensors (f32, contiguous, one device, else raises) go
    through the grouped kernel, one launch for every ``TABLE_CAPACITY``
    pairs, and the host reads nothing back; CPU tensors through
    :func:`klclip_dot_many_plain`.
    """
    ps, gs = list(ps), list(gs)
    if not ps or len(ps) != len(gs):
        raise ValueError(
            f'klclip_dot_many takes one or more pairs; got {len(ps)} p and {len(gs)} g'
        )
    for p, g in zip(ps, gs):
        if p.shape != g.shape:
            raise ValueError(f'shape mismatch: {tuple(p.shape)} vs {tuple(g.shape)}')
    device = ps[0].device
    if any(t.device != device for t in ps + gs):
        raise ValueError('klclip_dot_many takes tensors on one device')
    if device.type == 'cpu':
        return klclip_dot_many_plain(ps, gs, lr, kl_clip)
    if device.type != 'cuda':
        raise ValueError(f'klclip_dot_many runs on cuda or cpu, not {device}')
    f32 = torch.float32
    for t in ps + gs:
        if t.dtype is not f32 or not t.is_contiguous():
            raise ValueError(
                f'the klclip_dot kernel takes contiguous float32 tensors; got '
                f'{t.dtype}, contiguous={t.is_contiguous()}'
            )
    count = len(ps)
    numels = [p.numel() for p in ps]
    capacity = sum(-(-n // BLOCK_ELEMS) + 1 for n in numels if n)
    # one allocation: terms, vg_sum, scale, then the partial sums' scratch
    out = torch.empty(count + 2 + max(capacity, 1), dtype=f32, device=device)
    # (p, g, numel) a pair, read by the launcher before it returns
    rows = array.array(
        'q', [x for p, g, n in zip(ps, gs, numels) for x in (p.data_ptr(), g.data_ptr(), n)]
    )
    with torch.cuda.device(device):
        code = _dot_launcher()(
            rows.buffer_info()[0], count, out[count + 2:].data_ptr(), capacity,
            out.data_ptr(), lr ** 2, kl_clip,
            torch.cuda.current_stream(device).cuda_stream,
        )
    build.check('klclip', code)
    klclip_dot.launches += -(-count // TABLE_CAPACITY)
    return out[:count], out[count], out[count + 1]


def klclip_dot(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """0-d f32 tensor ``sum(p * g)`` over two tensors of one shape:
    :func:`klclip_dot_many` of one pair (its term at ``lr = 1``), whose
    launches count here."""
    if p.shape != g.shape:
        raise ValueError(f'shape mismatch: {tuple(p.shape)} vs {tuple(g.shape)}')
    if p.device.type == 'cpu' and g.device.type == 'cpu':
        return klclip_dot_plain(p, g)
    return klclip_dot_many([p], [g], 1.0, 1.0)[0][0]


@functools.cache
def _scale_launcher():
    fn = build.library('klclip').klclip_scale_multi_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _empty_at_offset_of(p: torch.Tensor) -> torch.Tensor:
    """An empty tensor like the contiguous ``p``, at ``p``'s offset from a
    16-byte boundary (the kernel moves a source and its destination in the
    same float4 steps)."""
    off = p.data_ptr() % 16 // 4
    if off == 0:
        return torch.empty_like(p)
    return torch.empty(p.numel() + off, dtype=p.dtype, device=p.device)[off:].view(p.shape)


def klclip_scale_many(
    ps: Sequence[torch.Tensor], scale: torch.Tensor, *, in_place: bool = False
) -> list[torch.Tensor]:
    """``p * scale`` in f32 for every tensor of ``ps``; ``scale`` is a
    one-element f32 tensor on their device, read by the kernel (no host
    sync).

    CUDA tensors (f32, contiguous, else raises) go through one kernel launch
    for every ``TABLE_CAPACITY`` non-empty tensors; CPU tensors through
    :func:`klclip_scale_many_plain`. Returns new tensors, or with
    ``in_place`` scales ``ps`` themselves and returns that list: the engine
    scales its own preconditioned gradients so, where the JAX package's
    ``fused_klclip_scale`` returns new arrays.

    The engine calls this once a step over every layer, so the host's work
    per tensor is a few attribute reads.
    """
    ps = list(ps)
    if not ps:
        return ps
    if not ps[0].is_cuda:
        if any(p.device.type != 'cpu' for p in ps):
            raise ValueError('klclip_scale_many takes tensors on one device')
        if not in_place:
            return klclip_scale_many_plain(ps, scale)
        for p in ps:
            p.copy_(klclip_scale_plain(p, scale))
        return ps
    f32 = torch.float32
    dev = scale.get_device()
    if scale.numel() != 1 or scale.dtype is not f32 or dev < 0:
        raise ValueError('the kl-clip scale is a one-element float32 CUDA tensor')
    for p in ps:
        if p.dtype is not f32 or not p.is_contiguous() or p.get_device() != dev:
            raise ValueError(
                f'the klclip_scale kernel takes contiguous float32 tensors on '
                f'cuda:{dev}; got {p.dtype} on {p.device}, contiguous={p.is_contiguous()}'
            )
    out = ps if in_place else [_empty_at_offset_of(p) for p in ps]
    # (source, destination, numel) a tensor, read by the launcher before it returns
    rows = array.array(
        'q', [x for p, o in zip(ps, out) for x in (p.data_ptr(), o.data_ptr(), p.numel())]
    )
    with torch.cuda.device(dev):
        code = _scale_launcher()(
            rows.buffer_info()[0], len(ps), scale.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check('klclip', code)
    nonempty = sum(p.numel() > 0 for p in ps)
    klclip_scale.launches += -(-nonempty // TABLE_CAPACITY)
    return out


def klclip_scale(p: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``p * scale`` in f32; ``scale`` is a one-element device tensor, read
    by the kernel (no host sync). :func:`klclip_scale_many` of one tensor:
    its launches count here too."""
    if p.device.type == 'cpu':
        return klclip_scale_plain(p, scale)
    if p.device.type != 'cuda':
        raise ValueError(f'klclip_scale runs on cuda or cpu, not {p.device}')
    return klclip_scale_many([p], scale)[0]


klclip_dot.launches = 0
klclip_scale.launches = 0
