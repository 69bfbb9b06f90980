"""Second-order factor math (counterpart of ``kfac_tpu/ops/factors.py``).

EMA updates, the device eigendecomposition, the damped inverse by Cholesky
or Newton-Schulz, eigen/inverse preconditioning and the kl-clip terms.
Decompositions run in f32. The batched forms come in a later slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from kfac_tpu_torch.ops import klclip
from kfac_tpu_torch.ops import newton_schulz as ns_lib


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


# Residual above which an f32 inverse is unusable for preconditioning: 'auto'
# re-solves by Cholesky, and a warm start that ends above it restarts cold
# (the JAX package's value).
NS_FALLBACK_RESIDUAL = 5e-2


class NewtonSchulzInfo(NamedTuple):
    """Result of :func:`newton_schulz_inverse_info`: the damped
    ``inverse`` (f32), the 0-d f32 ``residual`` ``||I - M X||_F / sqrt(d)``
    of that inverse, and the ``iterations`` run."""

    inverse: torch.Tensor
    residual: torch.Tensor
    iterations: int


def newton_schulz_inverse_info(
    factor: torch.Tensor,
    damping: float | torch.Tensor,
    max_iters: int = 40,
    tol: float = 1e-6,
    differentiable: bool = False,
    x0: torch.Tensor | None = None,
) -> NewtonSchulzInfo:
    """Damped inverse ``(factor + damping I)^-1`` by Newton-Schulz,
    ``X <- X (2I - M X)``, each iteration one :func:`fused_ns_step`.

    Semantics of the JAX function of the same name:

    - cold start ``X0 = I / ||M||_inf`` (Gershgorin), ``M X0 = M /
      ||M||_inf`` without a product;
    - ``x0`` (the previous inverse) warm-starts only if its own residual is
      below 0.5, else the cold start runs; its ``M @ x0`` is the first
      cached ``M X``;
    - the loop runs while ``k < max_iters``, the residual is above ``tol``
      and below the previous one (which starts at +inf), so a NaN residual
      stops it.

    One repair: a warm start that ends with its residual above
    :data:`NS_FALLBACK_RESIDUAL` runs again from the cold start, and
    ``iterations`` counts both runs. The 0.5 safeguard bounds the RMS of
    ``I - M x0``'s eigenvalues, but the iteration converges only if all of
    them lie inside the unit disc; a factor that grew in a few directions
    since ``x0`` passes the safeguard and diverges there, and the JAX
    function returns that iterate (at the flagship LM's step-100 refresh,
    cadence 10/100, 26 of 72 factors ended above the threshold, up to
    1.70, on an H100). Every warm start that ends at or below the
    threshold returns what the JAX function returns.

    ``lax.while_loop`` becomes a host loop that reads each iteration's
    residual: one device sync per iteration, at inverse refreshes only.
    ``differentiable=True`` (the fixed-trip scan) is not ported and raises.
    Each call adds one to ``newton_schulz_inverse_info.starts['warm']``,
    ``['cold']`` or ``['warm_restarted']``.
    """
    if differentiable:
        raise NotImplementedError(
            'newton_schulz_inverse_info(differentiable=True) is not ported yet'
        )
    m = factor.float()
    d = m.shape[-1]
    eye = torch.eye(d, dtype=m.dtype, device=m.device)
    m = m + damping * eye

    def residual(mx):
        return torch.linalg.norm(eye - mx) / math.sqrt(d)

    def iterate(x, mx):
        resid = residual(mx)
        value, prev, k = float(resid), math.inf, 0
        while k < max_iters and value > tol and value < prev:
            x, mx, resid = ns_lib.fused_ns_step(m, x, mx)
            prev, value, k = value, float(resid), k + 1
        return x, resid, k

    warm_iters = 0
    if x0 is not None:
        # safeguarded warm start: the m @ x0 product doubles as mx0
        x = x0.float()
        mx = m @ x
        if float(residual(mx)) < 0.5:
            x, resid, warm_iters = iterate(x, mx)
            if float(resid) <= NS_FALLBACK_RESIDUAL:
                newton_schulz_inverse_info.starts['warm'] += 1
                return NewtonSchulzInfo(x, resid, warm_iters)
    newton_schulz_inverse_info.starts['warm_restarted' if warm_iters else 'cold'] += 1
    lam_max = torch.max(torch.sum(torch.abs(m), dim=-1))  # Gershgorin bound
    x, resid, k = iterate(eye / lam_max, m / lam_max)
    return NewtonSchulzInfo(x, resid, warm_iters + k)


newton_schulz_inverse_info.starts = {'warm': 0, 'cold': 0, 'warm_restarted': 0}


def newton_schulz_inverse(
    factor: torch.Tensor,
    damping: float | torch.Tensor,
    iters: int = 40,
    tol: float = 1e-6,
    differentiable: bool = False,
    x0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Newton-Schulz damped inverse (see :func:`newton_schulz_inverse_info`)."""
    return newton_schulz_inverse_info(
        factor, damping, max_iters=iters, tol=tol,
        differentiable=differentiable, x0=x0,
    ).inverse


def damped_inverse(
    factor: torch.Tensor,
    damping: float | torch.Tensor,
    solver: str = 'cholesky',
    iters: int = 40,
    x0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Solver-dispatched damped inverse in f32: ``'cholesky'``,
    ``'newton_schulz'`` (warm-started from ``x0`` when given) or ``'auto'``
    (Newton-Schulz, then Cholesky when its residual is not at or below
    :data:`NS_FALLBACK_RESIDUAL`, NaN included; each such factor adds one
    to ``damped_inverse.cholesky_fallbacks``). Cholesky ignores ``x0``."""
    if solver == 'newton_schulz':
        return newton_schulz_inverse(factor, damping, iters=iters, x0=x0)
    if solver == 'auto':
        info = newton_schulz_inverse_info(factor, damping, max_iters=iters, x0=x0)
        if float(info.residual) <= NS_FALLBACK_RESIDUAL:
            return info.inverse
        damped_inverse.cholesky_fallbacks += 1
        return compute_inverse(factor, damping)
    if solver != 'cholesky':
        raise ValueError(f'unknown inverse solver {solver!r}')
    return compute_inverse(factor, damping)


damped_inverse.cholesky_fallbacks = 0


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
    is zero. Stays on the device: no host sync. The engine gets it from the
    grouped kl-clip dot (:func:`kfac_tpu_torch.ops.klclip.klclip_dot_many`),
    whose plain version this is."""
    return klclip.kl_clip_scale_plain(vg_sum, kl_clip)


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


def kl_clip_apply_many_(
    pmats: list[torch.Tensor], scale: torch.Tensor
) -> list[torch.Tensor]:
    """:func:`kl_clip_apply` of every layer's preconditioned gradient in one
    launch of the kl-clip scale kernel, in place: the f32 contiguous
    ``pmats`` are scaled themselves (the engine's own temporaries; the JAX
    package's version is functional), others through an f32 copy cast back
    to their dtype. Returns the scaled tensors."""
    f32 = [p.float().contiguous() for p in pmats]
    klclip.klclip_scale_many(f32, scale, in_place=True)
    return [x.to(p.dtype) for x, p in zip(f32, pmats)]
