"""kl-clip multiply-reduce and scale (counterpart of the kl-clip half of
``kfac_tpu/ops/pallas_ns.py``).

On a CUDA tensor each wrapper launches its Triton kernel
(:mod:`kfac_tpu_torch.ops.klclip_triton`, imported at launch); on a CPU
tensor it runs the plain version beside it.
"""

from __future__ import annotations

import torch

DOT_BLOCK = 4096
FINAL_BLOCK = 1024
SCALE_BLOCK = 4096


def klclip_dot_plain(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 scalar ``sum(p * g)``."""
    return torch.sum(p.float() * g.float())


def klclip_scale_plain(p: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: ``p * scale`` in f32."""
    return p.float() * scale


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


def klclip_scale(p: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``p * scale`` in f32; ``scale`` is a one-element device tensor, read
    by the kernel (no host sync)."""
    if p.device.type == 'cpu':
        return klclip_scale_plain(p, scale)
    scale = scale.reshape(1)
    _check_cuda('klclip_scale', p, scale)
    from kfac_tpu_torch.ops import klclip_triton

    n = p.numel()
    out = torch.empty_like(p)
    with torch.cuda.device(p.device):
        klclip_triton.scale_kernel[(max(1, -(-n // SCALE_BLOCK)),)](
            p, scale, out, n, BLOCK=SCALE_BLOCK, num_warps=8
        )
    klclip_scale.launches += 1
    return out


klclip_dot.launches = 0
klclip_scale.launches = 0
