"""Second-order factor math (counterpart of ``kfac_tpu/ops/factors.py``).

EMA updates, the device eigendecomposition, the Cholesky damped inverse,
eigen/inverse preconditioning and the kl-clip terms. Decompositions run in
f32. The Newton-Schulz solver and the batched forms come in a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kfac_tpu_torch.ops import klclip


def ema_update(
    running: torch.Tensor | None,
    new: torch.Tensor,
    alpha: float | torch.Tensor,
) -> torch.Tensor:
    """Running average ``alpha * running + (1 - alpha) * new``; a ``None``
    running value starts from the identity."""
    if running is None:
        running = torch.eye(new.shape[0], dtype=new.dtype, device=new.device)
    return alpha * running + (1.0 - alpha) * new


class EigenDecomp(NamedTuple):
    """Eigendecomposition of a symmetric PSD factor: eigenvectors ``q``
    (d, d) and eigenvalues ``d`` clamped >= 0 (d,)."""

    q: torch.Tensor
    d: torch.Tensor


def compute_eigh(factor: torch.Tensor) -> EigenDecomp:
    """Eigendecompose a symmetric factor in f32 on its own device
    (``torch.linalg.eigh``), eigenvalues clamped >= 0."""
    if not factor.dtype.is_floating_point:
        raise TypeError(f'compute_eigh needs a real float factor, got {factor.dtype}')
    d, q = torch.linalg.eigh(factor.float())
    return EigenDecomp(q=q, d=torch.clamp(d, min=0.0))


def compute_inverse(
    factor: torch.Tensor, damping: float | torch.Tensor
) -> torch.Tensor:
    """Tikhonov-damped explicit inverse in f32, via Cholesky."""
    f = factor.float()
    eye = torch.eye(f.shape[0], dtype=f.dtype, device=f.device)
    return torch.cholesky_inverse(torch.linalg.cholesky(f + damping * eye))


def damped_inverse(
    factor: torch.Tensor,
    damping: float | torch.Tensor,
    solver: str = 'cholesky',
) -> torch.Tensor:
    """Solver-dispatched damped inverse. Only ``'cholesky'`` is ported;
    ``'newton_schulz'`` and ``'auto'`` raise until their kernels land."""
    if solver in ('newton_schulz', 'auto'):
        raise NotImplementedError(
            f'inverse_solver={solver!r} needs the Newton-Schulz kernels, '
            'which are not ported yet'
        )
    if solver != 'cholesky':
        raise ValueError(f'unknown inverse solver {solver!r}')
    return compute_inverse(factor, damping)


def eigen_preconditioned_grad(
    grad: torch.Tensor,
    a: EigenDecomp,
    g: EigenDecomp,
    damping: float | torch.Tensor,
) -> torch.Tensor:
    """``qg @ [(qg^T grad qa) / (dg (x) da + damping)] @ qa^T`` for a
    (d_out, d_in) gradient."""
    grad_dtype = grad.dtype
    grad = grad.to(a.q.dtype)
    v1 = g.q.T @ grad @ a.q
    v2 = v1 / (torch.outer(g.d, a.d) + damping)
    return (g.q @ v2 @ a.q.T).to(grad_dtype)


def prediv_eigenvalues(
    a: EigenDecomp,
    g: EigenDecomp,
    damping: float | torch.Tensor,
) -> torch.Tensor:
    """Precomputed ``1 / (dg (x) da + damping)`` (d_out, d_in)."""
    return 1.0 / (torch.outer(g.d, a.d) + damping)


def inverse_preconditioned_grad(
    grad: torch.Tensor,
    a_inv: torch.Tensor,
    g_inv: torch.Tensor,
) -> torch.Tensor:
    """Precondition via explicit inverses: ``g_inv @ grad @ a_inv``."""
    grad_dtype = grad.dtype
    grad = grad.to(a_inv.dtype)
    return (g_inv @ grad @ a_inv).to(grad_dtype)


def kl_clip_scale(
    vg_sum: torch.Tensor,
    kl_clip: float | torch.Tensor,
) -> torch.Tensor:
    """Gradient scale ``min(1, sqrt(kl_clip / |vg_sum|))``, 1 where the sum
    is zero. Stays on the device: no host sync."""
    vg_abs = torch.abs(vg_sum)
    zero = vg_abs == 0.0
    safe = torch.where(zero, torch.ones_like(vg_abs), vg_abs)
    scale = torch.clamp(torch.sqrt(kl_clip / safe), max=1.0)
    return torch.where(zero, torch.ones_like(scale), scale)


def kl_clip_terms(
    pmat: torch.Tensor,
    gmat: torch.Tensor,
    lr: float | torch.Tensor,
) -> torch.Tensor:
    """One layer's kl-clip term ``sum(pmat * gmat) * lr^2`` in f32, the
    multiply-reduce on the kl-clip kernel."""
    return klclip.klclip_dot(pmat, gmat) * (lr ** 2)


def kl_clip_apply(pmat: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Apply the kl-clip scale to one preconditioned gradient:
    ``pmat_f32 * scale`` on the kl-clip kernel, cast back to ``pmat``'s
    dtype."""
    return klclip.klclip_scale(pmat, scale).to(pmat.dtype)
