"""Curvature capture: A and G statistics from one forward and backward
(counterpart of ``kfac_tpu/layers/capture.py``).

The JAX package taps layers with a flax interceptor and a ``custom_vjp``
identity; here the same statistics come from hooks:

- **A**: a forward pre-hook on each registered layer takes its input,
  detached, and reduces it to the (d_in+1)^2 covariance at once, so no
  activation is kept.
- **G**: a forward hook registers a tensor hook on the layer output; in the
  backward pass it receives ``ybar = dL/dy`` and adds
  ``get_cov(ybar.reshape(-1, d_out))``, the value the JAX g-tap emits, so
  the same mean-loss scaling applies.

Repeated calls of one layer add up and are divided by the call count. A
routed layer (a weighted helper) sums ``w_i F_i`` instead, with ``w_i``
the call's live-row fraction (from the input for A, from the cotangent for
G), and divides by the summed weights, floored at :data:`WEIGHT_FLOOR`: a
call that saw no token adds nothing. A LoRA unit's ``down`` and ``up``
children each add their role's block to the unit's block-diagonal sums,
and each counts as one call. The hooks exist only inside the capture
call: a step without capture pays nothing for them.

Tensor-parallel layers (``parallel.tensor_parallel``) give the global
layer's statistics, as the JAX capture does under pjit: a column-parallel
layer's output cotangents and a row-parallel layer's inputs (any sharded
input) are gathered over the model group along the feature axis before
the covariance (the bias column is appended once, after the gather); the
replicated sides stay local. Every rank of a model group then holds the
same statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn as nn

from kfac_tpu_torch.layers import helpers as helpers_lib
from kfac_tpu_torch.layers import registry as registry_lib
from kfac_tpu_torch.parallel import collectives

# Floor of the traffic-weight divisors: a starved layer keeps factor 0 and
# weight 0 (the weighted EMA then ignores it) instead of dividing 0 / 0.
WEIGHT_FLOOR = 1e-8


@dataclasses.dataclass
class CapturedStats:
    """Per-batch factor statistics: name -> A and name -> G matrices.

    ``w`` holds the evidence weights in [0, 1] of routed layers (their
    mean live-row fraction): the engines decay such a layer's factors by
    ``1 - (1 - alpha) * w``, so a capture in which an expert saw no token
    leaves them as they were. A layer absent from ``w`` weighs 1.

    ``wg`` holds the same layers' G-side weights (the cotangents' live
    fraction), which the JAX capture divides by and drops: the port keeps
    them so that a data-parallel engine can normalize the ranks' summed G
    by the global live count (absent: the layer's ``w``)."""

    a: dict[str, torch.Tensor]
    g: dict[str, torch.Tensor]
    w: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    wg: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def scaled(self, grad_scale: torch.Tensor | float) -> 'CapturedStats':
        """The statistics of a scaled loss, unscaled (AMP loss scaling): G
        is quadratic in the cotangents, so it divides by
        ``grad_scale**2``; A and the weights stay as they are."""
        s2 = grad_scale**2
        return CapturedStats(
            a=self.a, g={n: v / s2 for n, v in self.g.items()}, w=self.w, wg=self.wg,
        )


def weighted_average(
    sums: dict[str, torch.Tensor],
    counts: dict[str, int],
    weights: dict[str, torch.Tensor] | None = None,
) -> dict[str, torch.Tensor]:
    """Average per-call accumulator sums into per-capture factors: a
    weighted layer's by its summed weight (floored at
    :data:`WEIGHT_FLOOR`), the others' by their call count."""
    weights = weights or {}
    return {
        n: v / torch.clamp(weights[n], min=WEIGHT_FLOOR).to(v.dtype) if n in weights
        else v / counts[n]
        for n, v in sums.items()
    }


def named_grads(model: nn.Module) -> dict[str, torch.Tensor]:
    """``{parameter name: grad}`` for every parameter that has one."""
    return {
        n: p.grad for n, p in model.named_parameters() if p.grad is not None
    }


def value_and_grad(
    model: nn.Module, loss_fn: Callable[..., Any], has_aux: bool = False
) -> Callable[..., tuple[Any, dict[str, torch.Tensor]]]:
    """``f(*args) -> (loss, grads)``: one forward and backward of
    ``loss_fn`` with no capture, grads keyed by parameter name. With
    ``has_aux`` ``loss_fn`` returns ``(loss, aux)`` and ``f`` returns
    ``((loss, aux), grads)``."""

    def run(*args: Any, **kwargs: Any):
        model.zero_grad(set_to_none=True)
        out = loss_fn(*args, **kwargs)
        loss, aux = out if has_aux else (out, None)
        loss.backward()
        value = (loss.detach(), aux) if has_aux else loss.detach()
        return value, named_grads(model)

    return run


def _traffic_scaled(stats: CapturedStats) -> CapturedStats:
    """Weighted layers' factors times their capture weight, so that summed
    micro-captures divide back to the traffic-weighted mean."""
    return CapturedStats(
        a={n: v * stats.w[n] if n in stats.w else v for n, v in stats.a.items()},
        g={n: v * stats.w[n] if n in stats.w else v for n, v in stats.g.items()},
        w=stats.w,
    )


def accumulate_stats(
    acc: CapturedStats | None, new: CapturedStats
) -> CapturedStats:
    """Sum statistics across gradient-accumulation micro-steps; divide with
    :func:`average_stats` before ``update_factors``. Weighted layers add
    ``w_i F_i`` and their weights."""
    new = _traffic_scaled(new)
    if acc is None:
        return new
    return CapturedStats(
        a={n: acc.a[n] + new.a[n] for n in acc.a},
        g={n: acc.g[n] + new.g[n] for n in acc.g},
        w={n: acc.w[n] + new.w[n] for n in acc.w},
    )


def average_stats(acc: CapturedStats, num_steps: int) -> CapturedStats:
    """Average accumulated statistics over ``num_steps`` micro-steps: a
    weighted layer's by its summed weight (the traffic-weighted mean, as
    one capture over the micro-batches together would give, up to each
    one's own normalization), with the mean weight as its ``w`` (and
    ``wg``: its G was averaged by the same weights)."""

    def div(n, v):
        if n in acc.w:
            return v / torch.clamp(acc.w[n], min=WEIGHT_FLOOR)
        return v / num_steps

    w = {n: v / num_steps for n, v in acc.w.items()}
    return CapturedStats(
        a={n: div(n, v) for n, v in acc.a.items()},
        g={n: div(n, v) for n, v in acc.g.items()},
        w=w, wg=dict(w),
    )


class CurvatureCapture:
    """Wraps a loss function to also emit per-layer curvature statistics.

    Usage::

        cap = CurvatureCapture(registry)
        (loss, aux), grads, stats = cap.value_stats_and_grad(loss_fn)(batch)

    ``loss_fn(*args)`` runs the registered model and returns a scalar loss
    (or ``(loss, aux)`` with ``has_aux=True``).
    """

    def __init__(self, registry: registry_lib.Registry):
        self.registry = registry

    def value_stats_and_grad(
        self,
        loss_fn: Callable[..., Any],
        has_aux: bool = False,
    ) -> Callable[..., Any]:
        """``f(*args) -> ((loss, aux), grads, CapturedStats)``; grads are
        keyed by parameter name."""
        registry = self.registry

        def run(*args: Any, **kwargs: Any):
            a_sums: dict[str, torch.Tensor] = {}
            g_sums: dict[str, torch.Tensor] = {}
            a_w: dict[str, torch.Tensor] = {}  # weighted layers' summed weights
            g_w: dict[str, torch.Tensor] = {}
            counts: dict[str, int] = {}

            def accumulate(sums, name, value):
                sums[name] = sums[name] + value if name in sums else value

            def post_hook_for(g_hook):
                def post_hook(_mod, _inputs, output):
                    if output.requires_grad:
                        output.register_hook(g_hook)

                return post_hook

            def layer_hooks(name, helper):
                mod = registry.modules[name]
                kind = getattr(mod, 'parallel', None)
                if kind and helper.weighted:
                    raise NotImplementedError(
                        f'{name}: routed capture of a tensor-parallel layer is not ported yet'
                    )

                def pre_hook(_mod, inputs):
                    a = inputs[0].detach()
                    if kind and a.shape[-1] != mod.in_features:  # a sharded input
                        a = collectives.gather_features(a, mod.group)
                    fac = helper.get_a_factor(a)
                    if helper.weighted:
                        w = helper.capture_weight(a)
                        fac = fac * w
                        accumulate(a_w, name, w)
                    accumulate(a_sums, name, fac)
                    counts[name] = counts.get(name, 0) + 1

                def g_hook(ybar):
                    if kind == 'column':
                        ybar = collectives.gather_features(ybar, mod.group)
                    accumulate(g_sums, name, helper.g_factor_for_sum(ybar))
                    if helper.weighted:
                        accumulate(g_w, name, helper.g_capture_weight(ybar))

                return pre_hook, post_hook_for(g_hook)

            def role_hooks(unit, role, helper):
                def pre_hook(_mod, inputs):
                    accumulate(a_sums, unit, helper.role_a_factor(role, inputs[0].detach()))
                    counts[unit] = counts.get(unit, 0) + 1

                def g_hook(ybar):
                    accumulate(g_sums, unit, helper.role_g_factor(role, ybar))

                return pre_hook, post_hook_for(g_hook)

            hooked = []
            for name, helper in registry.layers.items():
                if not isinstance(helper, helpers_lib.LoRAHelper):
                    hooked.append((registry.modules[name], layer_hooks(name, helper)))
            for unit, role in registry.taps.values():
                child = getattr(registry.modules[unit], role)
                hooked.append((child, role_hooks(unit, role, registry.layers[unit])))
            handles = []
            try:
                for mod, (pre_hook, post_hook) in hooked:
                    handles.append(mod.register_forward_pre_hook(pre_hook))
                    handles.append(mod.register_forward_hook(post_hook))
                registry.model.zero_grad(set_to_none=True)
                out = loss_fn(*args, **kwargs)
                loss, aux = out if has_aux else (out, None)
                loss.backward()
            finally:
                for h in handles:
                    h.remove()
            stats = CapturedStats(
                a=weighted_average(a_sums, counts, a_w),
                g=weighted_average({n: g_sums[n] for n in a_sums}, counts, g_w),
                w={n: v / counts[n] for n, v in a_w.items()},
                wg={n: v / counts[n] for n, v in g_w.items()},
            )
            return (loss.detach(), aux), named_grads(registry.model), stats

        return run
