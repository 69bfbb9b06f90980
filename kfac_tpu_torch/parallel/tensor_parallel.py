"""Tensor-parallel (Megatron-style) layers and their sharding rules
(counterpart of ``kfac_tpu/parallel/tensor_parallel.py``).

Under pjit the JAX package's rules are PartitionSpecs and XLA inserts the
collectives; here they are explicit. A rule names the axis of a parameter
that shards over the grid's ``model`` axis (:class:`ShardSpec`), and
:func:`shard_params` swaps each ``nn.Linear`` the rules shard for a
:class:`ColumnParallelLinear` (output features sharded, bias with them)
or a :class:`RowParallelLinear` (input features sharded, bias
replicated), which hold only this rank's shard and keep the parameter
names. Their conjugate collectives are autograd functions
(``parallel.collectives``): the column input is the identity forward and
an all-reduce backward, the row output an all-reduce forward and the
identity backward. The activations between a column and a row layer stay
sharded, as under GSPMD. Explicit modules, not DTensor: the capture hooks
and the kernels take plain local tensors.

K-FAC sees the global layer: the modules keep the full ``in_features``
and ``out_features`` (so ``register_model`` gives full-width helpers), the
capture gathers a column layer's output cotangents and a row layer's
inputs over the model group before the covariance, and
``DistributedKFAC`` preconditions the gathered gradient and keeps the
local shard. Register the model, and build its optimizer, after
sharding it.
"""

from __future__ import annotations

import re
import warnings as _warnings
from typing import Any, Mapping, NamedTuple, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from kfac_tpu_torch.layers import helpers as helpers_lib
from kfac_tpu_torch.parallel import collectives
from kfac_tpu_torch.warnings import ExperimentalFeatureWarning


class ShardSpec(NamedTuple):
    """The axis of a parameter sharded over the grid's ``model`` axis, or
    None (replicated): the port's counterpart of a PartitionSpec over
    ``model``. A torch ``nn.Linear`` weight is (out, in), so the JAX
    kernel's ``P(None, 'model')`` is ``ShardSpec(0)`` here and ``P('model',
    None)`` is ``ShardSpec(1)``."""

    dim: int | None = None


REPLICATED = ShardSpec(None)

# (path regex, spec) over parameter paths joined with '/' -- first match
# wins; default replicated.
TRANSFORMER_TP_RULES: tuple[tuple[str, ShardSpec], ...] = (
    # column-parallel: shard output features
    (r'.*(q_proj|k_proj|v_proj|mlp_up)/weight', ShardSpec(0)),
    (r'.*(q_proj|k_proj|v_proj|mlp_up)/bias', ShardSpec(0)),
    # row-parallel: shard input features; bias replicated
    (r'.*(out_proj|mlp_down)/weight', ShardSpec(1)),
    # output head: vocab-sharded
    (r'.*lm_head/weight', ShardSpec(0)),
)


class UnshardedParamWarning(ExperimentalFeatureWarning):
    """A parameter matched no TP rule and stays replicated."""


def _param_names(params: Any) -> list[str]:
    if isinstance(params, nn.Module):
        return [n for n, _ in params.named_parameters()]
    return list(params)


def param_specs(
    params: Any, rules: Sequence[tuple[str, ShardSpec]] = TRANSFORMER_TP_RULES
) -> dict[str, ShardSpec]:
    """``{parameter name: ShardSpec}`` for a module's parameters (or a
    ``state_dict``'s keys) from path-regex rules over the names joined with
    '/'."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_for(name: str) -> ShardSpec:
        path = name.replace('.', '/')
        for pat, spec in compiled:
            if pat.fullmatch(path):
                return spec
        return REPLICATED

    return {n: spec_for(n) for n in _param_names(params)}


def _layer_specs(kind: str) -> dict[str, ShardSpec]:
    """weight/bias specs of one layer of a parallel kind: column shards the
    output features (axis 0 of a dense or conv weight; the bias with them),
    row the input features (axis 1; the bias replicated, added after the
    partial sums are reduced)."""
    if kind == 'column':
        return {'weight': ShardSpec(0), 'bias': ShardSpec(0)}
    if kind == 'row':
        return {'weight': ShardSpec(1), 'bias': REPLICATED}
    return {'weight': REPLICATED, 'bias': REPLICATED}


def derive_layer_kinds(
    registry: Any, overrides: Sequence[tuple[str, str]] | None = None
) -> dict[str, str]:
    """Per-registered-layer parallel kind: 'column', 'row', or 'replicated'.

    ``overrides`` are (layer-name regex, kind) pairs and take precedence.
    The others get the shard-the-wide-side default: expanding layers (out
    > in) are column-parallel, contracting layers (out < in) row-parallel,
    square layers replicated.
    """
    compiled = [(re.compile(pat), kind) for pat, kind in (overrides or [])]
    for _, kind in compiled:
        if kind not in ('column', 'row', 'replicated'):
            raise ValueError(f'unknown parallel kind {kind!r}')
    kinds: dict[str, str] = {}
    for name, helper in registry.layers.items():
        kind = next((k for pat, k in compiled if pat.fullmatch(name)), None)
        if kind is None:
            d_out = helper.g_factor_shape[0]
            d_in = helper.a_factor_shape[0] - int(helper.has_bias)
            kind = 'column' if d_out > d_in else 'row' if d_out < d_in else 'replicated'
        kinds[name] = kind
    return kinds


def registry_param_specs(
    params: Any,
    registry: Any,
    overrides: Sequence[tuple[str, str]] | None = None,
    warn_unmatched: bool = True,
) -> dict[str, ShardSpec]:
    """``{parameter name: ShardSpec}`` derived from the K-FAC registry, for
    any registered model. Parameters of no registered layer (embeddings,
    norms, skipped layers) stay replicated; with ``warn_unmatched`` one
    :class:`UnshardedParamWarning` lists them."""
    kinds = derive_layer_kinds(registry, overrides)
    by_prefix = {
        registry.param_paths[name]: _layer_specs(kind)
        for name, kind in kinds.items()
    }
    specs: dict[str, ShardSpec] = {}
    unmatched: list[str] = []
    for name in _param_names(params):
        prefix, _, leaf = name.rpartition('.')
        layer = by_prefix.get(prefix)
        if layer is not None and leaf in layer:
            specs[name] = layer[leaf]
        else:
            specs[name] = REPLICATED
            unmatched.append(name.replace('.', '/'))
    if warn_unmatched and unmatched:
        shown = ', '.join(unmatched[:5])
        more = f' (+{len(unmatched) - 5} more)' if len(unmatched) > 5 else ''
        _warnings.warn(
            f'{len(unmatched)} params matched no TP rule and stay replicated: {shown}{more}',
            UnshardedParamWarning,
            stacklevel=2,
        )
    return specs


# ------------------------------------------------------------- the layers


class _ParallelLinear(nn.Linear):
    """A linear layer holding this rank's shard of a (out, in) weight;
    ``in_features`` and ``out_features`` stay the full layer's."""

    parallel = ''
    shard_dims: dict[str, int] = {}

    def __init__(self, linear: nn.Linear, group: Any, size: int, index: int):
        nn.Module.__init__(self)
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.group, self.size, self.index = group, size, index
        for leaf in ('weight', 'bias'):
            full = getattr(linear, leaf)
            if full is None:
                self.register_parameter(leaf, None)
                continue
            dim = self.shard_dims.get(leaf)
            if dim is not None:
                if full.shape[dim] % size:
                    raise ValueError(
                        f'a {self.parallel}-parallel layer of {tuple(full.shape)} does not '
                        f'split into {size} equal shards along axis {dim}'
                    )
                full = shard_of(full, dim, index, size)
            setattr(self, leaf, nn.Parameter(full.detach().clone()))


class ColumnParallelLinear(_ParallelLinear):
    """Output features sharded over the model group: ``y_m = x W_m^T +
    b_m``, the input replicated (its gradient summed over the group). A
    sharded input (the output of another column-parallel layer) is
    gathered first."""

    parallel = 'column'
    shard_dims = {'weight': 0, 'bias': 0}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_features:
            x = collectives.gather_from_model(x, self.group)
        return F.linear(collectives.copy_to_model(x, self.group), self.weight, self.bias)


class RowParallelLinear(_ParallelLinear):
    """Input features sharded over the model group: the partial products
    summed over the group, then the replicated bias. A replicated input
    (the output of another row-parallel layer) is sliced first."""

    parallel = 'row'
    shard_dims = {'weight': 1}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] == self.in_features:
            x = collectives.scatter_to_model(x, self.group)
        y = collectives.reduce_from_model(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


def layer_kind(module: nn.Module) -> str | None:
    """'column', 'row', or None for a module that is not tensor-parallel."""
    return getattr(module, 'parallel', None) or None


def sharded_param_names(model: nn.Module) -> dict[str, tuple[nn.Module, int]]:
    """``{parameter name: (its parallel module, sharded axis)}`` of the
    parameters that hold a shard."""
    out = {}
    for prefix, mod in model.named_modules():
        for leaf, dim in getattr(mod, 'shard_dims', {}).items() if layer_kind(mod) else ():
            if getattr(mod, leaf) is not None:
                out[f'{prefix}.{leaf}' if prefix else leaf] = (mod, dim)
    return out


def _swap(model: nn.Module, grid: Any, specs: Mapping[str, ShardSpec]) -> nn.Module:
    """Replace every ``nn.Linear`` whose specs shard it by its parallel
    module over ``grid``'s model group, in place."""
    if grid.model == 1:
        return model
    linears = set()
    for prefix, mod in list(model.named_modules()):
        if type(mod) is not nn.Linear:
            continue
        linears.update({f'{prefix}.weight', f'{prefix}.bias'})
        w = specs.get(f'{prefix}.weight', REPLICATED)
        b = specs.get(f'{prefix}.bias', REPLICATED) if mod.bias is not None else None
        if w.dim is None:
            if b not in (None, REPLICATED):
                raise ValueError(f'{prefix}: a sharded bias needs a column-parallel weight')
            continue
        cls = {0: ColumnParallelLinear, 1: RowParallelLinear}.get(w.dim)
        if cls is None:
            raise ValueError(f'{prefix}.weight: a linear weight shards along axis 0 or 1, not {w.dim}')
        if b is not None and b.dim != cls.shard_dims.get('bias'):
            raise ValueError(
                f'{prefix}: a {cls.parallel}-parallel layer\'s bias is '
                f'{"sharded with its outputs" if cls is ColumnParallelLinear else "replicated"}'
            )
        parent, _, leaf = prefix.rpartition('.')
        setattr(model.get_submodule(parent), leaf, cls(mod, grid.model_group, grid.model, grid.m))
    others = [n for n, s in specs.items() if s.dim is not None and n not in linears]
    if others:
        raise NotImplementedError(
            f'tensor parallelism shards nn.Linear layers only; the rules also shard {others}'
        )
    return model


def shard_params(
    model: nn.Module,
    grid: Any,
    rules: Sequence[tuple[str, ShardSpec]] = TRANSFORMER_TP_RULES,
    params: Mapping[str, torch.Tensor] | None = None,
) -> nn.Module:
    """Shard ``model`` over ``grid``'s ``model`` axis by the rules, in
    place: each sharded ``nn.Linear`` becomes its parallel module holding
    this rank's shard. ``params`` (a full ``state_dict``, for example
    ``convert.from_flax_params`` of flax weights) is loaded first.
    Returns the model."""
    if params is not None:
        model.load_state_dict(params)
    return _swap(model, grid, param_specs(model, rules))


def shard_params_from_registry(
    model: nn.Module,
    grid: Any,
    registry: Any,
    overrides: Sequence[tuple[str, str]] | None = None,
    warn_unmatched: bool = True,
    params: Mapping[str, torch.Tensor] | None = None,
) -> nn.Module:
    """:func:`shard_params` with the rules derived from ``registry`` (a
    registry of the unsharded model; register the sharded one afresh)."""
    if params is not None:
        model.load_state_dict(params)
    specs = registry_param_specs(model, registry, overrides, warn_unmatched)
    for name, layer_helper in registry.layers.items():
        prefix = registry.param_paths[name]
        if not isinstance(layer_helper, helpers_lib.DenseHelper) and any(
            specs.get(f'{prefix}.{leaf}', REPLICATED).dim is not None for leaf in ('weight', 'bias')
        ):
            raise NotImplementedError(
                f'{name}: tensor parallelism shards dense layers only '
                f'({type(layer_helper).__name__}; override its kind to replicated)'
            )
    return _swap(model, grid, specs)


def gather_params(
    model: nn.Module, values: Mapping[str, torch.Tensor] | None = None
) -> dict[str, torch.Tensor]:
    """The full ``state_dict`` of a sharded model, on every rank of each
    model group (a collective: every rank calls): each shard gathered over
    its module's group along its sharded axis. ``values`` (say, the
    parameters' grads, keyed by parameter name) are gathered in its
    place."""
    sharded = sharded_param_names(model)
    out = {}
    for name, value in (model.state_dict() if values is None else values).items():
        if name in sharded:
            mod, dim = sharded[name]
            parts = [torch.empty_like(value) for _ in range(mod.size)]
            dist.all_gather(parts, value.contiguous(), group=mod.group)
            value = torch.cat(parts, dim=dim)
        out[name] = value.detach()
    return out


def shard_of(full: torch.Tensor, dim: int, index: int, size: int) -> torch.Tensor:
    """Shard ``index`` of ``size`` equal shards of ``full`` along ``dim``."""
    per = full.shape[dim] // size
    return full.narrow(dim, index * per, per)


def shard_params_like(
    model: nn.Module, values: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """The inverse of :func:`gather_params`: ``values`` (full tensors keyed
    by parameter name) with each sharded parameter's entry cut to this
    rank's shard; the others pass through."""
    sharded = sharded_param_names(model)
    out = dict(values)
    for name, (mod, dim) in sharded.items():
        if name in out:
            out[name] = shard_of(out[name], dim, mod.index, mod.size).contiguous()
    return out
