"""One Newton-Schulz iteration of the damped inverse (counterpart of the NS
half of ``kfac_tpu/ops/pallas_ns.py``).

On a CUDA tensor :func:`fused_ns_step` launches the hand-written kernels in
``kfac_tpu_torch/csrc/newton_schulz.cu`` (which replace the TPU kernels
``_ns_xupdate_kernel`` and ``_ns_mx_resid_kernel``: both products on the
tensor cores at f32 accuracy, in the output tile :func:`plan` picks); on a
CPU tensor it runs :func:`fused_ns_step_plain`, the unfused loop body of
``newton_schulz_inverse_info``. Unlike the JAX dispatch gate, the kernel
takes every size, ragged ones included.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from kfac_tpu_torch.ops import build


def fused_ns_step_plain(
    m: torch.Tensor, x: torch.Tensor, mx: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: ``x_new = x (2I - mx)``, ``mx_new = m x_new`` and the
    0-d residual ``||I - mx_new||_F / sqrt(d)``."""
    d = m.shape[-1]
    eye = torch.eye(d, dtype=m.dtype, device=m.device)
    x_new = x @ (2.0 * eye - mx)
    mx_new = m @ x_new
    return x_new, mx_new, torch.linalg.norm(eye - mx_new) / math.sqrt(d)


# output tiles the kernel is built for, (rows, columns): two warpgroups of
# 64 rows, or one (the last)
TILES = ((128, 128), (128, 144), (64, 32))


@functools.cache
def _launcher():
    fn = build.library('newton_schulz').ns_step_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def grid(d: int, tile: tuple[int, int]) -> tuple[int, int]:
    """CTAs (over rows, over columns) of a (d, d) product in ``tile``s."""
    return -(-d // tile[0]), -(-d // tile[1])


def plan(d: int, sms: int) -> tuple[int, int]:
    """Output tile of the kernel at width ``d`` on a card of ``sms`` SMs.
    Of the two-warpgroup tiles whose grid gives every SM a CTA, the one
    that takes the fewest waves of tile area (``ceil(CTAs / sms)`` times
    its rows times its columns), the first of :data:`TILES` on a tie; where
    neither fills the card, the one-warpgroup tile (the d ~ 512 factors:
    128 CTAs of 64 x 32 against 16 of 128 x 128). At d = 2049, 128 x 144
    takes 255 CTAs, two waves, where 128 x 128 takes 289, three."""
    filling = [t for t in TILES[:-1] if math.prod(grid(d, t)) >= sms]
    if not filling:
        return TILES[-1]
    return min(filling, key=lambda t: -(-math.prod(grid(d, t)) // sms) * t[0] * t[1])


def fused_ns_step(
    m: torch.Tensor, x: torch.Tensor, mx: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(x_new, mx_new, resid)`` of one iteration for square ``m``, ``x``,
    ``mx`` of one shape; ``resid`` is a 0-d f32 tensor on their device.

    CUDA tensors go through the kernels (f32, contiguous, else raises); CPU
    tensors through :func:`fused_ns_step_plain`.
    """
    if m.ndim != 2 or m.shape[0] != m.shape[1] or m.shape[0] == 0:
        raise ValueError(f'expected a non-empty square matrix, got {tuple(m.shape)}')
    if x.shape != m.shape or mx.shape != m.shape:
        raise ValueError(
            f'shape mismatch: m {tuple(m.shape)}, x {tuple(x.shape)}, mx {tuple(mx.shape)}'
        )
    if {t.device for t in (m, x, mx)} != {m.device}:
        raise ValueError('m, x and mx must lie on one device')
    if m.device.type == 'cpu':
        return fused_ns_step_plain(m, x, mx)
    if m.device.type != 'cuda':
        raise ValueError(f'fused_ns_step runs on cuda or cpu, not {m.device}')
    for t in (m, x, mx):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                'the Newton-Schulz kernel takes contiguous float32 tensors; '
                f'got {t.dtype}, contiguous={t.is_contiguous()}'
            )
    d = m.shape[0]
    tile = plan(d, torch.cuda.get_device_properties(m.device).multi_processor_count)
    rows, cols = grid(d, tile)
    x_new = torch.empty_like(m)
    mx_new = torch.empty_like(m)
    partials = torch.empty(rows * cols, dtype=torch.float32, device=m.device)
    resid = torch.empty((), dtype=torch.float32, device=m.device)
    with torch.cuda.device(m.device):
        code = _launcher()(
            m.data_ptr(), x.data_ptr(), mx.data_ptr(), x_new.data_ptr(),
            mx_new.data_ptr(), partials.data_ptr(), resid.data_ptr(), d, *tile,
            torch.cuda.current_stream(m.device).cuda_stream,
        )
    build.check('newton_schulz', code)
    fused_ns_step.launches += 1
    return x_new, mx_new, resid


fused_ns_step.launches = 0
