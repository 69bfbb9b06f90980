"""Second-order factor math (counterpart of ``kfac_tpu/ops/factors.py``).

EMA updates, the eigendecomposition (on the device, or by LAPACK on the
host), the damped inverse by Cholesky or Newton-Schulz, eigen/inverse
preconditioning and the kl-clip terms. Decompositions run in f32.

The distributed engine's stores are (L, d, d) stacks: the Cholesky
inverse and the preconditioning products take a leading slot axis, and
:func:`newton_schulz_inverse_stacked` and
:func:`batched_damped_inverse_auto` are the stacked solvers (the JAX
package vmaps the per-matrix ones).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
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


def effective_alpha(
    alpha: float | torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """Evidence-weighted EMA decay ``1 - (1 - alpha) * w``: a capture of
    weight ``w`` in [0, 1] moves the running factor by ``(1 - alpha) * w``,
    not at all for a starved capture (``w = 0``), by the plain EMA step at
    ``w = 1``. The one formula behind the traffic-weighted factor updates
    of both engines; ``w`` stays on the device."""
    return 1.0 - (1.0 - alpha) * w


class EigenDecomp(NamedTuple):
    """Eigendecomposition of a symmetric PSD factor: eigenvectors ``q``
    (d, d) and eigenvalues ``d`` clamped >= 0 (d,)."""

    q: torch.Tensor
    d: torch.Tensor


EIGH_IMPLS = ('device', 'host', 'eig_host')


def batched_eigh(factor: torch.Tensor, impl: str = 'device') -> tuple[torch.Tensor, torch.Tensor]:
    """``(eigenvalues, eigenvectors)`` of a (..., d, d) symmetric stack, in
    f32, on the factor's device.

    ``impl='device'`` is ``torch.linalg.eigh`` (the JAX package's
    ``'xla'``); ``'host'`` is ``numpy.linalg.eigh`` (LAPACK) on a host copy;
    ``'eig_host'`` is the general ``numpy.linalg.eig`` on a host copy, real
    parts, pairs sorted by eigenvalue ascending: the reference's handling of
    factors that drift non-symmetric (a robustness corner; the factors here
    are symmetric by construction). A half-precision factor is upcast to
    f32 first; a non-float one raises.

    A matrix of the stack with a non-finite entry decomposes to all NaN, as
    the JAX eigh leaves it NaN, chosen on the device (no host read): it is
    replaced by the identity before the solver, which on the card raises
    on a NaN matrix (cuSOLVER's error 65), and its outputs by NaN after.
    """
    if not factor.dtype.is_floating_point:
        raise TypeError(
            f'batched_eigh requires a real floating factor stack; got {factor.dtype}'
        )
    if impl not in EIGH_IMPLS:
        raise ValueError(f"unknown eigh impl {impl!r}: 'device', 'host', or 'eig_host'")
    f = factor.float()
    finite = torch.isfinite(f).all(dim=-1).all(dim=-1)[..., None]
    eye = torch.eye(f.shape[-1], dtype=f.dtype, device=f.device)
    w, v = _eigh(torch.where(finite[..., None], f, eye), impl)
    nan = float('nan')
    return torch.where(finite, w, nan), torch.where(finite[..., None], v, nan)


def _eigh(f: torch.Tensor, impl: str) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`batched_eigh` of a finite f32 stack."""
    if impl == 'device':
        return torch.linalg.eigh(f)
    m = f.detach().cpu().numpy()
    if impl == 'host':
        w, v = np.linalg.eigh(m)
    else:
        w, v = np.linalg.eig(m)
        w, v = np.real(w), np.real(v)
        order = np.argsort(w, axis=-1)
        w = np.take_along_axis(w, order, -1)
        v = np.take_along_axis(v, order[..., None, :], -1)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(f.device) for x in (w, v)
    )


def compute_eigh(
    factor: torch.Tensor, impl: str = 'device', inv_dtype: torch.dtype = torch.float32
) -> EigenDecomp:
    """Eigendecompose a symmetric factor in f32 by :func:`batched_eigh`'s
    ``impl`` (a half-precision factor upcast first), eigenvalues clamped
    >= 0, both cast to ``inv_dtype``."""
    d, q = batched_eigh(factor, impl)
    return EigenDecomp(q=q.to(inv_dtype), d=torch.clamp(d, min=0.0).to(inv_dtype))


def compute_inverse(
    factor: torch.Tensor, damping: float | torch.Tensor
) -> torch.Tensor:
    """Tikhonov-damped explicit inverse in f32, via Cholesky, of a (d, d)
    factor or each slot of an (L, d, d) stack (``damping`` a scalar, or
    (L,) for a stack).

    A damped factor that is not positive definite gives an all-NaN inverse,
    as the JAX function's ``cho_factor`` does, chosen on the device from
    ``cholesky_ex``'s ``info`` (no host read), so the health sentinel can
    roll it back. A half-precision factor is upcast first; the engines
    cast the inverse to their ``inv_dtype``."""
    f = factor.float()
    eye = torch.eye(f.shape[-1], dtype=f.dtype, device=f.device)
    chol, info = torch.linalg.cholesky_ex(f + _slot_scalar(damping, f) * eye)
    ok = (info == 0)[..., None, None]
    # a failed factorization's partial L is swapped for I before the solve
    inv = torch.cholesky_inverse(torch.where(ok, chol, eye))
    return torch.where(ok, inv, torch.full_like(inv, float('nan')))


def stacked_by_shape(mats: list[torch.Tensor]):
    """``(indices, stack)`` for each shape among ``mats``: the positions of
    the matrices of that shape, in order, and the matrices stacked (one
    copy), so a per-matrix computation runs once a shape."""
    groups: dict[tuple[int, ...], list[int]] = {}
    for k, m in enumerate(mats):
        groups.setdefault(tuple(m.shape), []).append(k)
    for idx in groups.values():
        yield idx, torch.stack([mats[k] for k in idx])


def gershgorin_condition_bound(
    factor: torch.Tensor, damping: float | torch.Tensor
) -> torch.Tensor:
    """Upper bound on cond(factor + damping I) of a PSD factor: the
    largest absolute row sum of ``factor + damping I`` (Gershgorin) over
    ``damping``, in f32.

    A ``(..., d, d)`` stack gives ``(...,)``; ``damping`` broadcasts (a
    scalar, or one per matrix). The denominator is floored at f32 ``tiny``
    and the quotient capped at f32 ``max``, so damping 0 saturates at a
    huge finite bound instead of inf or 0/0; a NaN factor gives NaN (which
    fails the health threshold's comparison).
    """
    f = factor.float()
    if isinstance(damping, torch.Tensor):
        d = damping.float()
    else:  # a fill on the device: no copy from the host
        d = torch.full((), damping, dtype=torch.float32, device=f.device)
    eye = torch.eye(f.shape[-1], dtype=torch.float32, device=f.device)
    m = f + d[..., None, None] * eye
    lam_max = torch.amax(torch.sum(torch.abs(m), dim=-1), dim=-1)
    fi = torch.finfo(torch.float32)
    return torch.clamp(lam_max / torch.clamp(d, min=fi.tiny), max=fi.max)


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
    stopping rule: one device sync per iteration, at inverse refreshes
    only. ``differentiable=True`` (the fixed-trip scan) is not ported and
    raises. Each call adds one to ``newton_schulz_inverse_info.starts['warm']``,
    ``['cold']`` or ``['warm_restarted']``. The solve is
    :func:`newton_schulz_inverse_stacked` of a stack of one, in f32 (a
    half-precision factor and ``x0`` upcast).
    """
    if differentiable:
        raise NotImplementedError(
            'newton_schulz_inverse_info(differentiable=True) is not ported yet'
        )
    info = newton_schulz_inverse_stacked(
        factor[None], damping, max_iters=max_iters, tol=tol,
        x0=None if x0 is None else x0[None],
    )
    return NewtonSchulzInfo(info.inverse[0], info.residual[0], int(info.iterations[0]))


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
    """Solver-dispatched damped inverse in f32 (a half-precision factor
    upcast first; the engines cast it to their ``inv_dtype``): ``'cholesky'``,
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


class StackedNewtonSchulzInfo(NamedTuple):
    """Result of :func:`newton_schulz_inverse_stacked`, per slot of an (L,
    d, d) stack: the damped ``inverse`` (L, d, d) f32 and its ``residual``
    (L,) f32 on the stack's device; on the host, the ``iterations`` run
    (L,) int32 (both runs of a restarted slot), ``warm`` (L,) bool (the
    safeguard kept the slot's ``x0``) and ``restarted`` (L,) bool (a warm
    start that ended above :data:`NS_FALLBACK_RESIDUAL` and ran again
    cold)."""

    inverse: torch.Tensor
    residual: torch.Tensor
    iterations: torch.Tensor
    warm: torch.Tensor
    restarted: torch.Tensor


def newton_schulz_inverse_stacked(
    stack: torch.Tensor,
    damping: float | torch.Tensor,
    max_iters: int = 40,
    tol: float = 1e-6,
    x0: torch.Tensor | None = None,
    live: torch.Tensor | None = None,
) -> StackedNewtonSchulzInfo:
    """:func:`newton_schulz_inverse_info` of every slot of an (L, d, d)
    stack at once, as the JAX package's ``vmap`` of it: each slot runs its
    own stopping rule, and a slot whose rule has fired keeps its iterate,
    residual and count while the others iterate on. ``damping`` is a
    scalar or (L,); ``x0`` (L, d, d) warm-starts each slot behind its own
    safeguard; ``live`` (L,) bool, when given, marks the slots to solve,
    and the others (a store's padding) never iterate and return their
    start.

    Each iteration is one launch of :func:`~kfac_tpu_torch.ops.
    newton_schulz.fused_ns_step_stacked` over the whole stack, its
    ``active`` mask the slots still running (no mask when every slot runs;
    a stack of one goes through :func:`~kfac_tpu_torch.ops.newton_schulz.
    fused_ns_step`, the 2-D launch), and one host read, the (L,)
    residuals: the stopping rules run on the host. The port's repair of
    the warm start holds per slot: a warm start that ends above
    :data:`NS_FALLBACK_RESIDUAL` runs again from the cold start. Each
    live slot adds one to ``newton_schulz_inverse_info.starts``.
    """
    m = stack.float()
    slots, d = m.shape[0], m.shape[-1]
    eye = torch.eye(d, dtype=m.dtype, device=m.device)
    m = m + _slot_scalar(damping, m) * eye
    live = [True] * slots if live is None else live.tolist()

    def residual(mx):
        return torch.linalg.matrix_norm(eye - mx) / math.sqrt(d)

    def cold():
        lam_max = torch.amax(torch.sum(torch.abs(m), dim=-1), dim=-1)  # Gershgorin bounds
        return eye / lam_max[:, None, None], m / lam_max[:, None, None]

    def iterate(x, mx, eligible):
        """The eligible slots to their own stops: (x, resid, its values
        on the host, iterations)."""
        resid = residual(mx)
        values, prev, k = resid.tolist(), [math.inf] * slots, [0] * slots
        while True:
            active = [
                e and n < max_iters and tol < v < p
                for e, n, v, p in zip(eligible, k, values, prev)
            ]
            if not any(active):
                return x, resid, values, k
            prev = [v if a else p for a, v, p in zip(active, values, prev)]
            k = [n + a for n, a in zip(k, active)]
            if all(active):  # no mask; a stack of one is the 2-D launch
                if slots == 1:
                    x, mx, resid = (t[None] for t in ns_lib.fused_ns_step(m[0], x[0], mx[0]))
                else:
                    x, mx, resid = ns_lib.fused_ns_step_stacked(m, x, mx)
            else:
                mask = torch.tensor(active, device=m.device)
                x_new, mx_new, r_new = ns_lib.fused_ns_step_stacked(m, x, mx, mask)
                keep = mask[:, None, None]
                x = torch.where(keep, x_new, x)
                mx = torch.where(keep, mx_new, mx)
                resid = torch.where(mask, r_new, resid)
            values = resid.tolist()  # the iteration's one host read

    warm = [False] * slots
    if x0 is not None:
        # safeguarded warm start: the m @ x0 product doubles as mx0
        x = x0.float()
        mx = m @ x
        safe = residual(mx) < 0.5
        warm = safe.tolist()
    if not all(warm):
        cold_x, cold_mx = cold()
        if any(warm):
            keep = safe[:, None, None]
            x, mx = torch.where(keep, x, cold_x), torch.where(keep, mx, cold_mx)
        else:
            x, mx = cold_x, cold_mx
    warm = [w and v for w, v in zip(warm, live)]
    x, resid, values, k = iterate(x.contiguous(), mx.contiguous(), live)
    restarted = [w and not v <= NS_FALLBACK_RESIDUAL for w, v in zip(warm, values)]
    starts = newton_schulz_inverse_info.starts
    starts['warm'] += sum(warm) - sum(restarted)
    starts['warm_restarted'] += sum(restarted)
    starts['cold'] += sum(live) - sum(warm)
    if any(restarted):
        xc, rc, _, kc = iterate(*(t.contiguous() for t in cold()), restarted)
        again = torch.tensor(restarted, device=m.device)
        x = torch.where(again[:, None, None], xc, x)
        resid = torch.where(again, rc, resid)
        k = [n + c for n, c in zip(k, kc)]
    return StackedNewtonSchulzInfo(
        x, resid, torch.tensor(k, dtype=torch.int32), torch.tensor(warm), torch.tensor(restarted)
    )


def batched_damped_inverse_auto(
    stack: torch.Tensor,
    damping: float | torch.Tensor,
    iters: int = 40,
    x0: torch.Tensor | None = None,
    live: torch.Tensor | None = None,
) -> torch.Tensor:
    """The ``'auto'`` inverse of every slot of an (L, d, d) stack, paying
    the Cholesky only when Newton-Schulz fails (the JAX function of the
    same name): the stacked Newton-Schulz solve, then, if some live slot's
    residual is not at or below :data:`NS_FALLBACK_RESIDUAL` (NaN
    included; one host read), the batched Cholesky inverse of the stack,
    taken at those slots. Each such slot adds one to
    ``damped_inverse.cholesky_fallbacks``."""
    info = newton_schulz_inverse_stacked(stack, damping, max_iters=iters, x0=x0, live=live)
    bad = ~(info.residual <= NS_FALLBACK_RESIDUAL)
    if live is not None:
        bad = bad & live
    n_bad = int(bad.sum())
    if not n_bad:
        return info.inverse
    damped_inverse.cholesky_fallbacks += n_bad
    return torch.where(bad[:, None, None], compute_inverse(stack, damping), info.inverse)


def _slot_scalar(value: float | torch.Tensor, like: torch.Tensor):
    """A scalar as it is, or an (L,) tensor shaped (L, 1, 1) to scale the
    slots of an (L, d, d) stack."""
    if isinstance(value, torch.Tensor) and value.ndim == 1:
        return value.to(like.dtype)[:, None, None]
    return value


def eigen_preconditioned_grad(
    grad: torch.Tensor,
    a: EigenDecomp,
    g: EigenDecomp,
    damping: float | torch.Tensor,
) -> torch.Tensor:
    """``qg @ [(qg^T grad qa) / (dg (x) da + damping)] @ qa^T`` for a
    (d_out, d_in) gradient, or for each slot of (L, d_out, d_in) with
    stacked decompositions (batched products; ``damping`` scalar or
    (L,))."""
    grad_dtype = grad.dtype
    grad = grad.to(a.q.dtype)
    v1 = g.q.mT @ grad @ a.q
    v2 = v1 / (g.d[..., :, None] * a.d[..., None, :] + _slot_scalar(damping, v1))
    return (g.q @ v2 @ a.q.mT).to(grad_dtype)


def prediv_eigenvalues(
    a: EigenDecomp,
    g: EigenDecomp,
    damping: float | torch.Tensor,
) -> torch.Tensor:
    """Precomputed ``1 / (dg (x) da + damping)`` (d_out, d_in), or (L,
    d_out, d_in) from stacked eigenvalues."""
    outer = g.d[..., :, None] * a.d[..., None, :]
    return 1.0 / (outer + _slot_scalar(damping, outer))


def inverse_preconditioned_grad(
    grad: torch.Tensor,
    a_inv: torch.Tensor,
    g_inv: torch.Tensor,
) -> torch.Tensor:
    """Precondition via explicit inverses: ``g_inv @ grad @ a_inv``, for
    one matrix or each slot of a stack."""
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
