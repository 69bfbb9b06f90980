"""Model analysis: discover the supported layers of a module tree
(counterpart of ``kfac_tpu/layers/registry.py``): ``nn.Linear`` (routed
or not), 2-D convolutions (``nn.Conv2d`` and the port's flax-padded
``SameConv2d``), and LoRA units (a module whose class sets
``_kfac_lora_unit = True``, registered once for its adapter pair).

Layers are named by their module path joined with '/', which for the
port's models equals the flax module path of the JAX package's
(``block0/attn/q_proj``), so the two registries pair one to one.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Iterable, Mapping

import torch
import torch.nn as nn

from kfac_tpu_torch.device import resolve_device
from kfac_tpu_torch.layers import helpers
from kfac_tpu_torch.models.layers import SameConv2d


def path_name(path: Iterable[str]) -> str:
    return '/'.join(path)


def any_match(query: str, patterns: list[re.Pattern[str]]) -> bool:
    """True if any pattern fully matches the query."""
    return any(p.fullmatch(query) is not None for p in patterns)


@dataclasses.dataclass(frozen=True)
class Registry:
    """Result of model analysis.

    ``layers`` maps registry name -> its LayerHelper; ``modules`` maps it to the
    registered ``nn.Module``; ``param_paths`` maps it to the module's
    parameter-name prefix in ``model.named_parameters()`` (``block0.attn.
    q_proj``). ``model`` is the analysed module tree. ``taps`` maps the
    name of a child that captures for a registered unit (a LoRA unit's
    ``down`` and ``up``) to ``(unit name, role)``; the unit module itself
    has no hooks.
    """

    model: nn.Module
    layers: dict[str, helpers.LayerHelper]
    modules: dict[str, nn.Module]
    param_paths: dict[str, str]
    taps: dict[str, tuple[str, str]] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.layers)

    def names(self) -> list[str]:
        return list(self.layers)


def _conv_padding(module: nn.Conv2d) -> Any:
    """The padding a conv applies, in the helper's form; None for a
    padding the patches do not reproduce (a mode other than zeros)."""
    if isinstance(module, SameConv2d):
        return 'SAME'
    if module.padding_mode != 'zeros':
        return None  # flax's CIRCULAR and REFLECT, likewise left out
    if isinstance(module.padding, str):  # torch's 'same' (stride 1) is flax's rule
        return module.padding.upper()
    ph, pw = module.padding
    return ((ph, ph), (pw, pw))


def make_helper(
    module: nn.Module, name: str, factor_dtype: torch.dtype = torch.float32
) -> helpers.LayerHelper | None:
    """A helper for a supported module, else None. As the JAX package, it
    leaves out grouped and dilated convolutions, and those whose padding
    its patches cannot reproduce; ``nn.Conv1d`` and ``nn.Conv3d`` are not
    2-D. ``factor_dtype`` is the helper's."""
    if isinstance(module, nn.Linear):
        return helpers.DenseHelper(
            name=name,
            has_bias=module.bias is not None,
            in_features=module.in_features,
            out_features=module.out_features,
            factor_dtype=factor_dtype,
        )
    if isinstance(module, nn.Conv2d):
        padding = _conv_padding(module)
        if module.groups != 1 or tuple(module.dilation) != (1, 1) or padding is None:
            return None
        return helpers.Conv2dHelper(
            name=name,
            has_bias=module.bias is not None,
            in_channels=module.in_channels,
            out_channels=module.out_channels,
            kernel_size=tuple(module.kernel_size),
            strides=tuple(module.stride),
            padding=padding,
            factor_dtype=factor_dtype,
        )
    return None


def _leaves(node: Any):
    if isinstance(node, Mapping):
        for value in node.values():
            yield from _leaves(value)
    else:
        yield node


def _mask_value(mask: Any, path: tuple[str, ...], name: str) -> bool:
    """The trainability a mask gives the layer at module path ``path``.

    The mask is a nested dict of bools over ``named_modules()`` path
    components, with the parameter names (``weight``, ``bias``) below a
    layer, and prefix semantics, as the JAX package's optax-style pytree:
    a bool at a prefix covers everything beneath it, and a path the mask
    does not mention is trainable. A layer whose own subtree mixes True
    and False raises: K-FAC preconditions a layer's weight and bias
    jointly.
    """
    node = mask
    for key in path:
        if isinstance(node, bool):
            return node
        if not isinstance(node, Mapping):
            raise TypeError(
                f'mask node at a prefix of layer {name!r} is '
                f'{type(node).__name__}; expected a bool or a mapping '
                '(a prefix tree of bools over module paths)'
            )
        if key not in node:
            return True
        node = node[key]
    if isinstance(node, bool):
        return node
    values = {bool(v) for v in _leaves(node)}
    if not values:
        return True
    if len(values) > 1:
        raise ValueError(
            f'mask splits layer {name!r} into trainable and frozen '
            'leaves; K-FAC preconditions a layer jointly, so mask whole '
            'layers (a bool at the layer path or a uniform subtree)'
        )
    return values.pop()


def is_trainable(mask: Any, param_name: str) -> bool:
    """Whether ``mask`` leaves the parameter ``param_name`` (a
    ``named_parameters()`` name) trainable: the same mask, read at one
    parameter, so an optimizer freezes what the registry drops."""
    if mask is None:
        return True
    return _mask_value(mask, tuple(param_name.split('.')), param_name)


def masked_registry(registry: Registry, mask: Any) -> Registry:
    """``registry`` without the layers ``mask`` freezes (``mask=None``
    returns it as it is). A frozen layer gets no capture hooks, no factors
    and no metrics keys, and its gradients pass through the preconditioner
    unchanged, as an unregistered layer's do (see :func:`_mask_value` for
    the mask's form). A LoRA unit reads the mask at its adapters (``down``,
    ``up``), which must agree; its ``base`` is never preconditioned, so
    freezing it does not freeze the unit."""
    if mask is None:
        return registry
    keep = []
    for name, prefix in registry.param_paths.items():
        path = tuple(prefix.split('.'))
        if isinstance(registry.layers[name], helpers.LoRAHelper):
            roles = {
                role: _mask_value(mask, path + (role,), name)
                for role in helpers.LoRAHelper.ROLES
            }
            if len(set(roles.values())) > 1:
                raise ValueError(
                    f'mask freezes one adapter of LoRA unit {name!r} but '
                    f'not the other ({roles}); the pair preconditions as '
                    'one unit, so mask both the same way'
                )
            trainable = roles['down']
        else:
            trainable = _mask_value(mask, path, name)
        if trainable:
            keep.append(name)
    return dataclasses.replace(
        registry,
        layers={n: registry.layers[n] for n in keep},
        modules={n: registry.modules[n] for n in keep},
        param_paths={n: registry.param_paths[n] for n in keep},
        taps={t: (u, r) for t, (u, r) in registry.taps.items() if u in keep},
    )


def register_model(
    model: nn.Module,
    skip_layers: list[str] | None = None,
    device: str | torch.device = 'cuda',
    mask: Any = None,
    routed_layers: list[str] | None = None,
    factor_dtype: torch.dtype = torch.float32,
) -> Registry:
    """Walk ``model`` and return its K-FAC registry.

    ``skip_layers`` are regexes matched against both the layer's path name
    and its lower-cased class name. Layers come in module-definition order,
    which for the port's models is their call order. ``device`` is where
    the model must lie (``'cuda'`` unless the caller passes another).
    ``mask`` drops the layers it freezes (:func:`masked_registry`).

    ``routed_layers`` (regexes over the layer path, dense layers only)
    mark row-masked layers, MoE experts whose unrouted input rows are zero,
    for routed capture: factors over the live rows only, captures weighted
    by their live fraction (``routed_layers=[r'.*expert\\d+_(up|down)']``
    for ``models/moe.py``). A pattern that matches a non-dense layer, or
    no layer at all, raises.

    A module whose class sets ``_kfac_lora_unit = True``
    (:class:`kfac_tpu_torch.models.lora.LoRADense`) registers as one unit
    with block-diagonal factors over its adapter pair
    (:class:`~kfac_tpu_torch.layers.helpers.LoRAHelper`); its ``down`` and
    ``up`` children capture for it (``Registry.taps``), and no module under
    it registers on its own.

    ``factor_dtype`` is every helper's (the dtype of the capture's
    covariances; the engines store their factors in their own
    ``factor_dtype``).

    A module whose class sets ``_kfac_own_capture = True`` (an expert
    parallel block, ``parallel.expert_parallel.EPSwitchFFN``) is left out
    with everything under it: it captures its own layers
    (``expert_parallel.register_model`` merges its registry in).
    """
    device = resolve_device(device)
    for p in model.parameters():
        if p.device.type != device.type:
            raise ValueError(
                f'model parameters are on {p.device}, not on {device}'
            )
    skip_patterns = [re.compile(p) for p in (skip_layers or [])]
    routed_patterns = [re.compile(p) for p in (routed_layers or [])]
    layers: dict[str, helpers.LayerHelper] = {}
    modules: dict[str, nn.Module] = {}
    param_paths: dict[str, str] = {}
    taps: dict[str, tuple[str, str]] = {}
    units: list[str] = []  # parameter prefixes of the registered units
    for prefix, mod in model.named_modules():
        if not prefix:
            continue
        name = path_name(prefix.split('.'))
        cls_name = type(mod).__name__.lower()
        if any_match(name, skip_patterns) or any_match(cls_name, skip_patterns):
            continue
        if any(prefix.startswith(u + '.') for u in units):
            continue  # the unit's children belong to its helper
        if getattr(type(mod), '_kfac_own_capture', False):
            units.append(prefix)  # an EP block registers and captures its own layers
            continue
        if getattr(type(mod), '_kfac_lora_unit', False):
            layers[name] = helpers.LoRAHelper(
                name=name, has_bias=False, in_features=mod.down.in_features,
                rank=int(mod.rank), out_features=int(mod.features),
                factor_dtype=factor_dtype,
            )
            modules[name] = mod
            param_paths[name] = prefix
            for role in helpers.LoRAHelper.ROLES:
                taps[f'{name}/{role}'] = (name, role)
            units.append(prefix)
            continue
        helper = make_helper(mod, name, factor_dtype)
        if helper is not None:
            if any_match(name, routed_patterns):
                if not isinstance(helper, helpers.DenseHelper):
                    raise ValueError(
                        f'routed_layers matched {name!r}, which is not a '
                        'dense layer (routed capture is defined for '
                        'row-masked dense inputs only)'
                    )
                helper = dataclasses.replace(helper, routed=True)
            layers[name] = helper
            modules[name] = mod
            param_paths[name] = prefix
    unmatched = [
        p.pattern for p in routed_patterns if not any(p.fullmatch(n) for n in layers)
    ]
    if unmatched:
        raise ValueError(
            f'routed_layers patterns {unmatched} matched no registered '
            'layer: a typo here silently reverts the expert layers to the '
            'approximate shared-normalization capture, so it is an error. '
            f'Registered layers: {sorted(layers)}'
        )
    return masked_registry(Registry(
        model=model, layers=layers, modules=modules, param_paths=param_paths, taps=taps,
    ), mask)


def slice_layer_grads(
    grads: dict[str, torch.Tensor],
    registry: Registry,
) -> dict[str, dict[str, torch.Tensor]]:
    """Each registered layer's grads, keyed by local parameter name, from a
    ``named_parameters``-keyed dict."""
    out: dict[str, dict[str, torch.Tensor]] = {}
    for name, prefix in registry.param_paths.items():
        helper, module = registry.layers[name], registry.modules[name]
        out[name] = {
            local: grads[f'{prefix}.{local}'] for local in helper.param_names(module)
        }
    return out


def merge_layer_grads(
    grads: dict[str, torch.Tensor],
    layer_grads: dict[str, dict[str, torch.Tensor]],
    registry: Registry,
) -> dict[str, torch.Tensor]:
    """A new grads dict with the layers' grads replaced (``grads`` is left
    as it was)."""
    out = dict(grads)
    for name, value in layer_grads.items():
        prefix = registry.param_paths[name]
        for local, g in value.items():
            out[f'{prefix}.{local}'] = g
    return out


def merge_registries(*registries: Registry) -> Registry:
    """The union of disjoint registries of one model (say, the model's own
    and a registry of some of its blocks registered apart), so that one
    engine preconditions every layer. A layer name in two of them raises,
    as does a registry over another model (parameter paths are relative to
    the model)."""
    if not registries:
        raise ValueError('merge_registries needs at least one registry')
    model = registries[0].model
    layers: dict[str, helpers.LayerHelper] = {}
    modules: dict[str, nn.Module] = {}
    paths: dict[str, str] = {}
    taps: dict[str, tuple[str, str]] = {}
    for r in registries:
        if r.model is not model:
            raise ValueError('registries over different models do not merge')
        overlap = set(layers) & set(r.layers)
        if overlap:
            raise ValueError(
                f'layer names collide across registries: {sorted(overlap)}'
            )
        layers.update(r.layers)
        modules.update(r.modules)
        paths.update(r.param_paths)
        taps.update(r.taps)
    return Registry(model=model, layers=layers, modules=modules, param_paths=paths, taps=taps)
