"""Symmetric second moment ``a^T a / scale`` (counterpart of
``kfac_tpu/ops/pallas_cov.py``).

On a CUDA tensor :func:`sym_cov` launches the hand-written kernel in
``kfac_tpu_torch/csrc/sym_cov.cu`` (which replaces the TPU kernel
``_sym_cov_kernel``, ``kfac_tpu/ops/pallas_cov.py:40``); on a CPU tensor it
runs :func:`sym_cov_plain`. Both compute the upper triangle and mirror it,
so the result is exactly symmetric.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kfac_tpu_torch.ops import build


def sym_cov_plain(a: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version: upper triangle of ``a^T a`` mirrored, then
    divided by ``scale`` (default: the row count)."""
    if scale is None:
        scale = a.shape[0]
    full = a.T @ a
    upper = torch.triu(full)
    return (upper + torch.triu(full, diagonal=1).T) / scale


@functools.cache
def _launcher():
    fn = build.library('sym_cov').sym_cov_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def tile_for(d: int, device: torch.device) -> int:
    """Output tile edge: 64 when its upper-triangle grid gives every SM two
    CTAs, else 32 (more, smaller CTAs for the d ~ 512 factors)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    nblk = -(-d // 64)
    return 64 if nblk * (nblk + 1) // 2 >= 2 * sms else 32


def sym_cov(a: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """``a^T a / scale`` for a 2-D ``a`` of shape (N, D); (D, D) f32.

    CUDA tensors go through the kernel (f32, contiguous, else raises);
    CPU tensors through :func:`sym_cov_plain`.
    """
    if a.ndim != 2:
        raise ValueError(f'expected a 2D tensor, got shape {tuple(a.shape)}')
    if scale is None:
        scale = a.shape[0]
    if a.device.type == 'cpu':
        return sym_cov_plain(a, scale)
    if a.device.type != 'cuda':
        raise ValueError(f'sym_cov runs on cuda or cpu, not {a.device}')
    if a.dtype != torch.float32 or not a.is_contiguous():
        raise ValueError(
            'the sym_cov kernel takes a contiguous float32 tensor; got '
            f'{a.dtype}, contiguous={a.is_contiguous()}'
        )
    n, d = a.shape
    out = torch.empty((d, d), dtype=torch.float32, device=a.device)
    if d == 0:
        return out
    with torch.cuda.device(a.device):
        code = _launcher()(
            a.data_ptr(), out.data_ptr(), n, d, float(scale),
            tile_for(d, a.device),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    build.check('sym_cov', code)
    sym_cov.launches += 1
    return out


sym_cov.launches = 0
