"""One Newton-Schulz iteration of the damped inverse (counterpart of the NS
half of ``kfac_tpu/ops/pallas_ns.py``).

On a CUDA tensor :func:`fused_ns_step` launches the hand-written kernels in
``kfac_tpu_torch/csrc/newton_schulz.cu`` (which replace the TPU kernels
``_ns_xupdate_kernel`` and ``_ns_mx_resid_kernel``); on a CPU tensor it
runs :func:`fused_ns_step_plain`, the unfused loop body of
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


@functools.cache
def _launcher():
    fn = build.library('newton_schulz').ns_step_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tile_for(d: int, device: torch.device) -> int:
    """Output tile edge: 64 when its grid gives every SM two CTAs, else 32
    (more, smaller CTAs for the d ~ 512 factors)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 64 if (-(-d // 64)) ** 2 >= 2 * sms else 32


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
    tile = tile_for(d, m.device)
    x_new = torch.empty_like(m)
    mx_new = torch.empty_like(m)
    partials = torch.empty((-(-d // tile)) ** 2, dtype=torch.float32, device=m.device)
    resid = torch.empty((), dtype=torch.float32, device=m.device)
    with torch.cuda.device(m.device):
        code = _launcher()(
            m.data_ptr(), x.data_ptr(), mx.data_ptr(), x_new.data_ptr(),
            mx_new.data_ptr(), partials.data_ptr(), resid.data_ptr(), d, tile,
            torch.cuda.current_stream(m.device).cuda_stream,
        )
    build.check('newton_schulz', code)
    fused_ns_step.launches += 1
    return x_new, mx_new, resid


fused_ns_step.launches = 0
