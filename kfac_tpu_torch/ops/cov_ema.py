"""Covariance blended into a running factor, ``beta F + coeff a^T a``
(counterpart of ``kfac_tpu/ops/pallas_cov_ema.py``).

On a CUDA tensor :func:`sym_cov_ema` launches the hand-written kernels in
``kfac_tpu_torch/csrc/sym_cov.cu`` (``sym_cov_ema_f32``, which replaces the
TPU kernel ``_sym_cov_ema_kernel``, ``kfac_tpu/ops/pallas_cov_ema.py:47``):
``sym_cov``'s tensor-core loop (3xTF32) and split over N
(:func:`kfac_tpu_torch.ops.sym_cov.plan`), with the blend as the epilogue.
On a CPU tensor it runs :func:`sym_cov_ema_plain`. Both blend the upper
triangle and mirror it, so the result is exactly symmetric.

A bfloat16 or float16 ``a`` takes the 16-bit kernel's blend
(``sym_cov_ema_bf16`` / ``_f16``: ``sym_cov``'s ``wgmma`` walk,
:func:`kfac_tpu_torch.ops.sym_cov.plan16`), the TPU kernel's function at
that dtype: the products of the 16-bit values summed in f32, F and the
output f32.

Contract, as in the JAX package: ``F`` is symmetric. The kernel reads
``F[i, j]`` for ``i <= j`` only; the TPU mirrors whole tiles and so also
reads the lower half of diagonal tiles. The two agree for a symmetric ``F``.

The JAX dispatch gate (``use_fused_cov_ema_for``) is not carried over:
every size and shape goes through the kernel on the card. The row-sharded
SPMD form and the stacked form come with the distributed engine.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kfac_tpu_torch.ops import build, sym_cov


def sym_cov_ema_plain(
    f: torch.Tensor, a: torch.Tensor, beta: float, coeff: float
) -> torch.Tensor:
    """Plain PyTorch version, the kernel's own expression: the upper
    triangle of ``beta * f + coeff * (a^T a)``, mirrored; a 16-bit ``a`` is
    taken in f32 (its products are exact there)."""
    a = a.float()
    full = beta * f + coeff * (a.T @ a)
    return torch.triu(full) + torch.triu(full, diagonal=1).T


# the C entry point of each dtype of ``a``
ENTRY = {
    torch.float32: 'sym_cov_ema_f32',
    torch.bfloat16: 'sym_cov_ema_bf16',
    torch.float16: 'sym_cov_ema_f16',
}


@functools.cache
def _launcher(dtype: torch.dtype = torch.float32):
    fn = getattr(build.library('sym_cov'), ENTRY[dtype])
    if dtype in sym_cov.HALF:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            *[ctypes.c_int] * 5, ctypes.c_void_p,
        ]
    else:
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
    fn.restype = ctypes.c_int
    return fn


def launch(
    f: torch.Tensor, a: torch.Tensor, out: torch.Tensor, beta: float, coeff: float,
    p: sym_cov.CovPlan,
) -> None:
    """Run the f32 kernels on ``a`` and ``f`` into ``out`` by plan ``p``
    (checked arguments; no launch count)."""
    part = sym_cov.scratch(p, a.device)
    with torch.cuda.device(a.device):
        code = _launcher()(
            a.data_ptr(), f.data_ptr(), out.data_ptr(),
            0 if part is None else part.data_ptr(), p.n, p.d, float(beta), float(coeff),
            p.splits, p.rows_per_split, torch.cuda.current_stream(a.device).cuda_stream,
        )
    build.check('sym_cov', code)


def launch16(
    f: torch.Tensor, a: torch.Tensor, out: torch.Tensor, beta: float, coeff: float,
    p: sym_cov.HalfPlan,
) -> None:
    """Run the 16-bit kernels on a :func:`sym_cov.tma_ready` ``a`` and
    ``f`` into ``out`` by plan ``p`` (checked arguments; no launch count)."""
    part = sym_cov.half_scratch(p, a.device)
    with torch.cuda.device(a.device):
        code = _launcher(a.dtype)(
            a.data_ptr(), a.stride(0), f.data_ptr(), out.data_ptr(),
            0 if part is None else part.data_ptr(), p.n, p.d, float(beta), float(coeff),
            *sym_cov.walk_args(p), torch.cuda.current_stream(a.device).cuda_stream,
        )
    build.check('sym_cov', code)


def sym_cov_ema(
    f: torch.Tensor, a: torch.Tensor, beta: float, coeff: float
) -> torch.Tensor:
    """``beta * f + coeff * a^T a`` for ``a`` (N, D) and a symmetric ``f``
    (D, D); (D, D) f32, exactly symmetric, a new tensor.

    CUDA tensors go through the kernels (``a`` contiguous f32, or bf16 or
    f16 in any layout, copied where TMA cannot read it; else raises; ``f``
    is read as f32), by ``sym_cov``'s plan or ``plan16``, whose scratch is
    allocated here; CPU tensors go through :func:`sym_cov_ema_plain`. Each
    launch adds one to ``sym_cov_ema.launches`` and to
    ``sym_cov_ema.launches_by_dtype[a.dtype]``.
    """
    if a.ndim != 2:
        raise ValueError(f'expected a 2D tensor, got shape {tuple(a.shape)}')
    n, d = a.shape
    if f.shape != (d, d):
        raise ValueError(f'running factor {tuple(f.shape)} does not match a {tuple(a.shape)}')
    if f.device != a.device:
        raise ValueError(f'f on {f.device} and a on {a.device}: one device expected')
    f = f.float().contiguous()
    if a.device.type == 'cpu':
        return sym_cov_ema_plain(f, a, beta, coeff)
    if a.device.type != 'cuda':
        raise ValueError(f'sym_cov_ema runs on cuda or cpu, not {a.device}')
    if a.dtype not in ENTRY or (a.dtype == torch.float32 and not a.is_contiguous()):
        raise ValueError(
            'the sym_cov_ema kernel takes a float32, bfloat16 or float16 tensor, a '
            f'float32 one contiguous; got {a.dtype}, contiguous={a.is_contiguous()}'
        )
    out = torch.empty((d, d), dtype=torch.float32, device=a.device)
    if d == 0:
        return out
    sms = sym_cov.sm_count(a.device.index)
    if a.dtype in sym_cov.HALF:
        launch16(f, sym_cov.half_input(a), out, beta, coeff, sym_cov.plan16(n, d, sms))
    else:
        launch(f, a, out, beta, coeff, sym_cov.plan(n, d, sms))
    build.count(sym_cov_ema, a.dtype)
    return out


build.reset_counts(sym_cov_ema)


def fused_cov_ema(
    running: torch.Tensor | None,
    a: torch.Tensor,
    alpha: float,
    scale: float | None = None,
) -> torch.Tensor:
    """``ema_update(running, get_cov(a, scale), alpha)`` in one pass.

    ``running=None`` is ``ema_update``'s cold start (the identity in
    ``a``'s dtype). ``scale`` defaults to the row count. The blend is
    ``beta = alpha``, ``coeff = (1 - alpha) / scale``, in Python doubles as
    the JAX package computes them. Returns ``promote(running, a)``'s dtype.
    """
    n, d = a.shape
    if scale is None:
        scale = n
    if running is None:
        running = torch.eye(d, dtype=a.dtype, device=a.device)
    out_dtype = torch.promote_types(running.dtype, a.dtype)
    beta = float(alpha)
    coeff = (1.0 - beta) / float(scale)
    return sym_cov_ema(running, a, beta, coeff).to(out_dtype)
