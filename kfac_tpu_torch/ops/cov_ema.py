"""Covariance blended into a running factor, ``beta F + coeff a^T a``
(counterpart of ``kfac_tpu/ops/pallas_cov_ema.py``).

On a CUDA tensor :func:`sym_cov_ema` launches the hand-written kernels in
``kfac_tpu_torch/csrc/sym_cov.cu`` (``sym_cov_ema_f32``, which replaces the
TPU kernel ``_sym_cov_ema_kernel``, ``kfac_tpu/ops/pallas_cov_ema.py:47``):
``sym_cov``'s tensor-core loop (3xTF32) and split over N
(:func:`kfac_tpu_torch.ops.sym_cov.plan`), with the blend as the epilogue.
On a CPU tensor it runs :func:`sym_cov_ema_plain`. Both blend the upper
triangle and mirror it, so the result is exactly symmetric.

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
    triangle of ``beta * f + coeff * (a^T a)``, mirrored."""
    full = beta * f + coeff * (a.T @ a)
    return torch.triu(full) + torch.triu(full, diagonal=1).T


@functools.cache
def _launcher():
    fn = build.library('sym_cov').sym_cov_ema_f32
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
    """Run the kernels on ``a`` and ``f`` into ``out`` by plan ``p`` (checked
    arguments; no launch count)."""
    part = sym_cov.scratch(p, a.device)
    with torch.cuda.device(a.device):
        code = _launcher()(
            a.data_ptr(), f.data_ptr(), out.data_ptr(),
            0 if part is None else part.data_ptr(), p.n, p.d, float(beta), float(coeff),
            p.splits, p.rows_per_split, torch.cuda.current_stream(a.device).cuda_stream,
        )
    build.check('sym_cov', code)


def sym_cov_ema(
    f: torch.Tensor, a: torch.Tensor, beta: float, coeff: float
) -> torch.Tensor:
    """``beta * f + coeff * a^T a`` for ``a`` (N, D) and a symmetric ``f``
    (D, D); (D, D) f32, exactly symmetric, a new tensor.

    CUDA tensors go through the kernels (``a`` contiguous f32, else raises;
    ``f`` is read as f32), split by ``sym_cov``'s plan, whose scratch is
    allocated here; CPU tensors go through :func:`sym_cov_ema_plain`.
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
        return sym_cov_ema_plain(f, a.float(), beta, coeff)
    if a.device.type != 'cuda':
        raise ValueError(f'sym_cov_ema runs on cuda or cpu, not {a.device}')
    if a.dtype != torch.float32 or not a.is_contiguous():
        raise ValueError(
            'the sym_cov_ema kernel takes a contiguous float32 tensor; got '
            f'{a.dtype}, contiguous={a.is_contiguous()}'
        )
    out = torch.empty((d, d), dtype=torch.float32, device=a.device)
    if d == 0:
        return out
    launch(f, a, out, beta, coeff, sym_cov.plan(n, d, sym_cov.sm_count(a.device.index)))
    sym_cov_ema.launches += 1
    return out


sym_cov_ema.launches = 0


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
