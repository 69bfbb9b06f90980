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

Repeated calls of one layer add up and are divided by the call count. The
hooks exist only inside the capture call: a step without capture pays
nothing for them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn as nn

from kfac_tpu_torch.layers import registry as registry_lib


@dataclasses.dataclass
class CapturedStats:
    """Per-batch factor statistics: name -> A and name -> G matrices.
    (The JAX package's evidence weights ``w`` belong to routed layers,
    which come in a later slice.)"""

    a: dict[str, torch.Tensor]
    g: dict[str, torch.Tensor]


def weighted_average(
    sums: dict[str, torch.Tensor], counts: dict[str, int]
) -> dict[str, torch.Tensor]:
    """Average per-call accumulator sums into per-capture factors by the
    call count. (Routed layers, which divide by a summed evidence weight
    instead, come in a later slice.)"""
    return {n: v / counts[n] for n, v in sums.items()}


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


def accumulate_stats(
    acc: CapturedStats | None, new: CapturedStats
) -> CapturedStats:
    """Sum statistics across gradient-accumulation micro-steps; divide by
    their count with :func:`average_stats` before ``update_factors``.
    (Routed layers, which accumulate ``w_i F_i``, come in a later slice.)"""
    if acc is None:
        return new
    return CapturedStats(
        a={n: acc.a[n] + new.a[n] for n in acc.a},
        g={n: acc.g[n] + new.g[n] for n in acc.g},
    )


def average_stats(acc: CapturedStats, num_steps: int) -> CapturedStats:
    """Average accumulated statistics over ``num_steps`` micro-steps."""
    return CapturedStats(
        a={n: v / num_steps for n, v in acc.a.items()},
        g={n: v / num_steps for n, v in acc.g.items()},
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
            counts: dict[str, int] = {}

            def accumulate(sums, name, fac):
                sums[name] = sums[name] + fac if name in sums else fac

            def make_hooks(name, helper):
                def pre_hook(_mod, inputs):
                    accumulate(a_sums, name, helper.get_a_factor(inputs[0].detach()))
                    counts[name] = counts.get(name, 0) + 1

                def g_hook(ybar):
                    accumulate(g_sums, name, helper.get_g_factor(ybar))

                def post_hook(_mod, _inputs, output):
                    if output.requires_grad:
                        output.register_hook(g_hook)

                return pre_hook, post_hook

            handles = []
            try:
                for name, mod in registry.modules.items():
                    pre_hook, post_hook = make_hooks(name, registry.layers[name])
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
                a=weighted_average(a_sums, counts),
                g=weighted_average({n: g_sums[n] for n in a_sums}, counts),
            )
            return (loss.detach(), aux), named_grads(registry.model), stats

        return run
