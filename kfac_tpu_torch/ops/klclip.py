"""kl-clip multiply-reduce and scale (counterpart of the kl-clip half of
``kfac_tpu/ops/pallas_ns.py``).

On CUDA tensors the dot launches its Triton kernels
(:mod:`kfac_tpu_torch.ops.klclip_triton`, imported at launch) and the scale
the CUDA kernel ``klclip_scale_multi_f32`` (``kfac_tpu_torch/csrc/klclip.cu``),
one launch for a list of tensors; on CPU tensors each wrapper runs the
plain version beside it.
"""

from __future__ import annotations

import array
import ctypes
import functools
from collections.abc import Sequence

import torch

from kfac_tpu_torch.ops import build

DOT_BLOCK = 4096
FINAL_BLOCK = 1024
# tensors one scale launch takes: kMaxTensors in csrc/klclip.cu
TABLE_CAPACITY = 96


def klclip_dot_plain(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 scalar ``sum(p * g)``."""
    return torch.sum(p.float() * g.float())


def klclip_scale_plain(p: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: ``p * scale`` in f32."""
    return p.float() * scale


def klclip_scale_many_plain(
    ps: Sequence[torch.Tensor], scale: torch.Tensor
) -> list[torch.Tensor]:
    """Plain version of :func:`klclip_scale_many`: ``p * scale`` in f32 for
    each tensor."""
    return [klclip_scale_plain(p, scale) for p in ps]


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != 'cuda':
            raise ValueError(f'{name} runs on cuda or cpu, not {t.device}')
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f'the {name} kernel takes contiguous float32 tensors; got '
                f'{t.dtype}, contiguous={t.is_contiguous()}'
            )


def klclip_dot(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """0-d f32 tensor ``sum(p * g)`` over two tensors of one shape."""
    if p.shape != g.shape:
        raise ValueError(f'shape mismatch: {tuple(p.shape)} vs {tuple(g.shape)}')
    if p.device.type == 'cpu':
        return klclip_dot_plain(p, g)
    _check_cuda('klclip_dot', p, g)
    from kfac_tpu_torch.ops import klclip_triton

    n = p.numel()
    nblocks = max(1, -(-n // DOT_BLOCK))
    partials = torch.empty(nblocks, dtype=torch.float32, device=p.device)
    out = torch.empty((), dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        klclip_triton.dot_partials_kernel[(nblocks,)](
            p, g, partials, n, BLOCK=DOT_BLOCK, num_warps=8
        )
        klclip_triton.dot_final_kernel[(1,)](
            partials, out, nblocks, BLOCK=FINAL_BLOCK, num_warps=4
        )
    klclip_dot.launches += 1
    return out


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
