"""Expert parallelism: the switch FFN's all-to-all dispatch over the grid's
``expert`` axis with exact per-expert K-FAC capture (counterpart of
``kfac_tpu/parallel/expert_parallel.py``).

The JAX package runs the block in a ``shard_map`` over the mesh and lets
its transposes insert the reductions; here each rank runs its part and the
collectives are explicit:

- **Layout**: :class:`EPSwitchFFN` has ``MoEMLP``'s names (``router``,
  ``expert{e}_up``, ``expert{e}_down``), but a rank holds only its own
  experts, ``num_experts / expert`` consecutive ones (its index on the
  expert axis times that); the router is replicated. Tokens shard over the
  data and expert axes jointly (``TrainGrid.local_tokens``).
- **Dispatch**: each rank packs its tokens into per-expert buffers of ``C
  = ceil(capacity_factor * T_local / E)`` slots, filled in arrival order
  (the JAX package's one-hot cumsum; a token past its expert's capacity
  drops to the residual path), by gathering each slot's token row. One
  ``all_to_all_single`` over the expert group sends each rank's buffers
  to their experts' ranks, which then hold ``(E_local, expert * C, d)``
  with the slots concatenated in peer rank order, as ``lax.all_to_all``'s
  ``concat_axis=1`` does; the inverse exchange brings the outputs back.
  Both are an autograd function whose backward is the same exchange
  (``collectives.all_to_all``).
- **Capture** (inside :func:`combined_value_stats_and_grad`): an expert's
  A comes from its received buffer with the bias one on live slots only,
  summed over the data group (the ranks with this rank's experts) and
  divided by the global live count; the router's A and G are dense over
  every token, summed over the data and expert axes and divided by the
  global token count; an expert's G is ``sum_live g g^T`` over its
  received rows, summed over the data group, over the global live count
  (tensor hooks on the stacked expert outputs); its evidence weight is the
  live count over the global token count, the same for up and down.
  Every count stays on the device: a capture step reads nothing on the
  host. The covariances are ``ops.cov.get_cov``'s (the ``sym_cov``
  kernel on a CUDA tensor).

:func:`combined_value_stats_and_grad` spans the hook capture of the
registered layers and any number of EP blocks in one backward. It
differentiates the rank's loss over the number of token ranks, so that
the cotangents are those of the global mean loss, as under the JAX
package's global arrays, and returns the global loss, the global
gradients (each rank's parameters': the router's and the other
replicated layers' summed over every token rank, an expert's over its
data group) and the global statistics.

:class:`ExpertParallelKFAC` preconditions with that: the dense engine over
the rank's layers (the replicated ones and its experts), whose factors,
decompositions and gradients of an expert stay on the ranks that hold it.
Its kl-clip sum spans every layer of the model: the experts' terms are
summed over the expert group on the device before the scale is taken.
Under tensor parallelism the Megatron layers' gradients are gathered over
the model group, preconditioned whole and sliced back to the rank's shard.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from kfac_tpu_torch.layers import capture as capture_lib
from kfac_tpu_torch.layers import helpers as helpers_lib
from kfac_tpu_torch.layers import registry as registry_lib
from kfac_tpu_torch.ops import cov
from kfac_tpu_torch.parallel import collectives
from kfac_tpu_torch.parallel import tensor_parallel as tp_lib

EXPERT_AXIS = 'expert'


def _lecun_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's ``lecun_normal`` (truncated at +-2 std) in place, as
    ``TransformerLM.reset_parameters`` draws it."""
    std = 1.0 / math.sqrt(weight.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def _size(group: Any) -> int:
    return dist.get_world_size(group)


def _sum_(t: torch.Tensor, group: Any) -> torch.Tensor:
    """``t`` summed over ``group`` in place (nothing on a group of one)."""
    if _size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


class _Capture:
    """One EP block's statistics of one capture: ``a`` in the forward, ``g``
    from the tensor hooks in the backward, ``w`` the experts' evidence
    weights; ``calls`` the block's invocations."""

    def __init__(self):
        self.calls = 0
        self.a: dict[str, torch.Tensor] = {}
        self.g: dict[str, torch.Tensor] = {}
        self.w: dict[str, torch.Tensor] = {}


class EPSwitchFFN(nn.Module):
    """Expert-parallel top-1 (switch) FFN over a grid with an expert axis.

    ``capacity_factor`` sizes each expert's LOCAL slot buffer as
    ``ceil(capacity_factor * local_tokens / num_experts)``; the global
    capacity of an expert is that times the expert axis's size. Tokens past
    it drop to the residual path (switch semantics; ``capacity_factor >=
    num_experts`` can never drop). ``name_prefix`` prefixes the block's
    layer names (``'block1/moe/'`` in a ``TransformerLM``), which must be
    distinct across the blocks of one capture.

    ``seed`` draws the weights as ``MoEMLP`` draws them (the router, then
    each expert's up and down projection, flax's initializers), keeping
    this rank's experts: a dense ``MoEMLP`` and an EP block from one
    generator hold the same experts. The block then lives on
    ``grid.device``; ``seed=None`` leaves it undrawn on the CPU for its
    owner (``TransformerLM(ep_mesh=...)``) to draw and place.
    """

    _kfac_own_capture = True  # register_model leaves the block to its own capture

    def __init__(
        self,
        grid: Any,
        d_model: int,
        num_experts: int,
        mlp_ratio: int = 4,
        capacity_factor: float = 1.0,
        expert_axis: str = EXPERT_AXIS,
        name_prefix: str = '',
        seed: int | None = 0,
    ):
        super().__init__()
        if expert_axis != EXPERT_AXIS or getattr(grid, 'expert', 1) == 1:
            raise ValueError(
                f'mesh has no {expert_axis!r} axis; build it with '
                'train_mesh(expert=N) (the axis is only added for N > 1)'
            )
        ep = grid.expert
        if num_experts % ep != 0:
            raise ValueError(
                f'num_experts={num_experts} not divisible by the '
                f'{expert_axis!r} axis size {ep}'
            )
        if grid.seq != 1:
            raise NotImplementedError(
                'EPSwitchFFN on a grid with a seq axis is not ported to kfac_tpu_torch yet'
            )
        self.grid = grid
        self.d_model = d_model
        self.num_experts = num_experts
        self.mlp_ratio = mlp_ratio
        self.capacity_factor = capacity_factor
        self.expert_axis = expert_axis
        self.name_prefix = name_prefix
        self.e_loc = num_experts // ep
        self.first = grid.e * self.e_loc
        h = mlp_ratio * d_model
        self.router = nn.Linear(d_model, num_experts)
        for e in self.local_experts:
            self.add_module(f'expert{e}_up', nn.Linear(d_model, h))
            self.add_module(f'expert{e}_down', nn.Linear(h, d_model))
        self._capture: _Capture | None = None
        if seed is not None:  # else the owner draws and places the weights
            self.reset_parameters(torch.Generator().manual_seed(seed))
            self.to(grid.device)

    @property
    def local_experts(self) -> range:
        """The global indices of this rank's experts."""
        return range(self.first, self.first + self.e_loc)

    def expert(self, e: int) -> tuple[nn.Linear, nn.Linear]:
        return getattr(self, f'expert{e}_up'), getattr(self, f'expert{e}_down')

    def capacity(self, tokens: int) -> int:
        """Local slots an expert for ``tokens`` local tokens."""
        return max(1, math.ceil(self.capacity_factor * tokens / self.num_experts))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw the block's weights from ``generator`` in ``MoEMLP``'s
        order, every expert's (another rank's into a scratch tensor) so
        that the stream matches; biases zero."""
        h = self.mlp_ratio * self.d_model
        _lecun_(self.router.weight, generator)
        self.router.bias.zero_()
        for e in range(self.num_experts):
            if e in self.local_experts:
                up, down = self.expert(e)
                for lin in (up, down):
                    _lecun_(lin.weight, generator)
                    lin.bias.zero_()
            else:
                _lecun_(torch.empty(h, self.d_model), generator)
                _lecun_(torch.empty(self.d_model, h), generator)

    # ------------------------------------------------------------ naming

    def layer_names(self) -> tuple[str, list[str], list[str]]:
        """``(router, ups, downs)``: the block's layer names on this rank
        (its experts only)."""
        pre = self.name_prefix
        return (
            f'{pre}router',
            [f'{pre}expert{e}_up' for e in self.local_experts],
            [f'{pre}expert{e}_down' for e in self.local_experts],
        )

    def registry(self, model: nn.Module | None = None) -> registry_lib.Registry:
        """The block's registry on this rank: the router and this rank's
        experts (routed: exact per-expert statistics), over ``model`` (a
        module tree holding the block; None: the block itself), so that it
        merges with ``register_model(model)``'s."""
        model = self if model is None else model
        prefix = next((p for p, m in model.named_modules() if m is self), None)
        if prefix is None:
            raise ValueError('the EP block is not a module of the given model')
        base = f'{prefix}.' if prefix else ''
        router, ups, downs = self.layer_names()
        layers: dict[str, helpers_lib.LayerHelper] = {}
        modules: dict[str, nn.Module] = {}
        paths: dict[str, str] = {}
        d, h = self.d_model, self.mlp_ratio * self.d_model
        layers[router] = helpers_lib.DenseHelper(
            name=router, has_bias=True, in_features=d, out_features=self.num_experts,
        )
        modules[router], paths[router] = self.router, f'{base}router'
        for e, up_name, down_name in zip(self.local_experts, ups, downs):
            up, down = self.expert(e)
            layers[up_name] = helpers_lib.DenseHelper(
                name=up_name, has_bias=True, in_features=d, out_features=h, routed=True,
            )
            layers[down_name] = helpers_lib.DenseHelper(
                name=down_name, has_bias=True, in_features=h, out_features=d, routed=True,
            )
            modules[up_name], paths[up_name] = up, f'{base}expert{e}_up'
            modules[down_name], paths[down_name] = down, f'{base}expert{e}_down'
        return registry_lib.Registry(model=model, layers=layers, modules=modules, param_paths=paths)

    # ------------------------------------------------------------- apply

    def _slots(self, idx: torch.Tensor, cap: int) -> torch.Tensor:
        """(T,) flat slot ``expert * C + arrival rank`` of each token in the
        local buffers, ``E * C`` for a dropped one: the JAX package's
        ``cumsum(one_hot) * one_hot - 1`` over the flat tokens."""
        onehot = F.one_hot(idx, self.num_experts)
        pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
        return torch.where(pos < cap, idx * cap + pos, self.num_experts * cap)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: this rank's (B, S, d) tokens; returns the block's output
        for them. Inside :func:`combined_value_stats_and_grad` it also
        captures the block's statistics."""
        box = self._capture
        if box is not None:
            if box.calls:
                raise ValueError(
                    f'EP block {self.name_prefix!r} called more than once per loss '
                    'evaluation; use one EPSwitchFFN (distinct name_prefix) per block'
                )
            box.calls += 1
        grid = self.grid
        lead, d = x.shape[:-1], x.shape[-1]
        t = math.prod(lead)
        e_tot, e_loc, ep = self.num_experts, self.e_loc, grid.expert
        cap = self.capacity(t)
        xf = x.reshape(t, d)
        router, ups, downs = self.layer_names()

        logits = self.router(xf)
        if box is not None:
            t_glob = t * grid.stat_world  # the token ranks: data x expert
            logits.register_hook(self._g_tap(box, router, grid.stat_group, float(t_glob)))
        probs = torch.softmax(logits.float(), dim=-1)
        idx = torch.argmax(probs, dim=-1)
        gate = torch.gather(probs, -1, idx[:, None]).to(x.dtype)

        # local dispatch: each slot's token row (an empty slot the zero row t)
        flat = self._slots(idx, cap)
        src = torch.full((e_tot * cap + 1,), t, dtype=torch.long, device=x.device)
        src = src.scatter(0, flat, torch.arange(t, device=x.device))[:-1]
        used = (src < t).to(x.dtype).view(e_tot, cap)
        x_pad = torch.cat([xf, xf.new_zeros((1, d))])
        bufs = x_pad.index_select(0, src).view(e_tot, cap, d)

        # to the experts: split E over the expert axis, concatenate the slots
        def to_experts(v):
            v = collectives.all_to_all(v, grid.expert_group)  # (ep * e_loc, C, ...)
            v = v.view(ep, e_loc, *v.shape[1:]).transpose(0, 1)
            return v.reshape(e_loc, ep * cap, *v.shape[3:])

        bufs = to_experts(bufs)  # (E_loc, R, d)
        with torch.no_grad():
            live = to_experts(used)  # (E_loc, R)
        experts = [self.expert(e) for e in self.local_experts]
        up_lin = torch.stack([F.linear(bufs[i], up.weight, up.bias) for i, (up, _) in enumerate(experts)])
        hcur = F.gelu(up_lin, approximate='tanh') * live[..., None]
        dn_lin = torch.stack([
            F.linear(hcur[i], down.weight, down.bias) for i, (_, down) in enumerate(experts)
        ])
        if box is not None:
            live_n = self._capture_a(box, xf, bufs, hcur, live, t)
            up_lin.register_hook(self._expert_g_tap(box, ups, live_n))
            dn_lin.register_hook(self._expert_g_tap(box, downs, live_n))

        # back to the tokens: the inverse exchange, then each token's slot
        y = dn_lin.view(e_loc, ep, cap, d).transpose(0, 1).reshape(ep * e_loc, cap, d)
        y = collectives.all_to_all(y, grid.expert_group).reshape(e_tot * cap, d)
        y = torch.cat([y, y.new_zeros((1, d))]).index_select(0, flat)
        return (y * gate).reshape(*lead, d)

    @torch.no_grad()
    def _capture_a(self, box, xf, bufs, hcur, live, t) -> torch.Tensor:
        """The block's A factors and evidence weights into ``box``; returns
        the (E_loc,) global live counts, floored at 1."""
        grid = self.grid
        router, ups, downs = self.layer_names()
        ones = live[..., None].float()
        a_up = [cov.get_cov(cov.with_column(bufs[i].float(), ones[i]), scale=1.0)
                for i in range(self.e_loc)]
        a_dn = [cov.get_cov(cov.with_column(hcur[i].float(), ones[i]), scale=1.0)
                for i in range(self.e_loc)]
        # one all-reduce over the data group: live counts, every expert's A
        flat, specs = collectives.concat_flat([live.float().sum(-1)] + a_up + a_dn)
        parts = collectives.split_flat(_sum_(flat, grid.dp_group), specs)
        live_raw, a_up, a_dn = parts[0], parts[1:1 + self.e_loc], parts[1 + self.e_loc:]
        live_n = torch.clamp(live_raw, min=1.0)
        t_glob = float(t * grid.stat_world)
        a_router = _sum_(cov.get_cov(cov.append_bias_ones(xf.detach().float()), scale=1.0),
                         grid.stat_group)
        box.a[router] = a_router / t_glob
        w_live = live_raw / t_glob
        for i in range(self.e_loc):
            box.a[ups[i]] = a_up[i] / live_n[i]
            box.a[downs[i]] = a_dn[i] / live_n[i]
            box.w[ups[i]] = w_live[i]
            box.w[downs[i]] = w_live[i]
        return live_n

    @staticmethod
    def _g_tap(box, name, group, t_glob) -> Callable:
        """The router's G: ``sum g g^T`` over every token, summed over the
        token ranks, over the global token count."""

        def hook(ybar):
            box.g[name] = _sum_(cov.get_cov(ybar.detach().float(), scale=1.0), group) / t_glob

        return hook

    def _expert_g_tap(self, box, names, live_n) -> Callable:
        """The experts' G: ``sum_live g g^T`` of each one's received rows
        (a dead slot's cotangent is zero), summed over the data group, over
        its global live count."""
        group = self.grid.dp_group

        def hook(ybar):
            ybar = ybar.detach().float()
            gs = torch.stack([cov.get_cov(ybar[i], scale=1.0) for i in range(self.e_loc)])
            gs = _sum_(gs, group) / live_n[:, None, None]
            for i, n in enumerate(names):
                box.g[n] = gs[i]

        return hook

    def expert_param_names(self, prefix: str = '') -> list[str]:
        """The parameter names (under ``prefix``) of this rank's experts."""
        base = f'{prefix}.' if prefix else ''
        return [
            f'{base}expert{e}_{role}.{leaf}'
            for e in self.local_experts for role in ('up', 'down') for leaf in ('weight', 'bias')
        ]


def ep_blocks(model: nn.Module) -> list[tuple[str, EPSwitchFFN]]:
    """``(prefix, block)`` of every EP block of ``model``, in module order."""
    return [(p, m) for p, m in model.named_modules() if isinstance(m, EPSwitchFFN)]


def register_model(model: nn.Module, **kwargs: Any) -> registry_lib.Registry:
    """``register_model(model, **kwargs)`` (which leaves EP blocks out)
    merged with each EP block's registry over ``model``: every layer this
    rank preconditions."""
    base = registry_lib.register_model(model, **kwargs)
    return registry_lib.merge_registries(base, *(b.registry(model) for _, b in ep_blocks(model)))


def _grid_of(ffns: Sequence[EPSwitchFFN]) -> Any:
    grids = {id(f.grid) for f in ffns}
    if len(grids) > 1:
        raise ValueError('the EP blocks of one capture must share one grid')
    return ffns[0].grid if ffns else None


def _reduce_hook_stats(stats: capture_lib.CapturedStats, grid: Any) -> capture_lib.CapturedStats:
    """The token ranks' statistics of the hook-captured layers from this
    rank's (each from the global loss's cotangents over its own rows): the
    mean over the stat group, a weighted layer's ``sum w F / sum w`` with
    the mean weight, in one all-reduce."""
    names = list(stats.a)
    if not names or _size(grid.stat_group) == 1:
        return stats
    routed = [n for n in names if n in stats.w]
    wa = {n: stats.w[n].float() for n in routed}
    wg = {n: stats.wg.get(n, stats.w[n]).float() for n in routed}
    sent = [stats.a[n] * wa[n] if n in wa else stats.a[n] for n in names]
    sent += [stats.g[n] * wg[n] if n in wg else stats.g[n] for n in names]
    sent += [wa[n] for n in routed] + [wg[n] for n in routed]
    flat, specs = collectives.concat_flat(sent)
    parts = collectives.split_flat(_sum_(flat, grid.stat_group), specs)
    k, r, world = len(names), len(routed), float(grid.stat_world)
    sum_wa = dict(zip(routed, parts[2 * k:2 * k + r]))
    sum_wg = dict(zip(routed, parts[2 * k + r:]))
    floor = capture_lib.WEIGHT_FLOOR

    def avg(n, v, weights):
        return v / torch.clamp(weights[n], min=floor) if n in weights else v / world

    return capture_lib.CapturedStats(
        a={n: avg(n, v, sum_wa) for n, v in zip(names, parts[:k])},
        g={n: avg(n, v, sum_wg) for n, v in zip(names, parts[k:2 * k])},
        w={n: sum_wa[n] / world for n in routed},
        wg={n: sum_wg[n] / world for n in routed},
    )


def reduce_grads(
    grads: dict[str, torch.Tensor], grid: Any, model: nn.Module | None,
    ffns: Sequence[tuple[str, EPSwitchFFN]], extra: Sequence[torch.Tensor] = (),
) -> tuple[dict[str, torch.Tensor], list[torch.Tensor]]:
    """The global gradients from this rank's (of the global mean loss):
    an expert's summed over its data group, a tensor-parallel shard's over
    the stat group, every other parameter's over every rank divided by the
    model axis (its model ranks hold the same), so that it is bitwise the
    same on every rank. Flat buffers, one all-reduce a kind; ``extra``
    tensors (the loss) ride with the replicated parameters and come back
    reduced as they are."""
    expert = {n for prefix, f in ffns for n in f.expert_param_names(prefix)}
    sharded = set(tp_lib.sharded_param_names(model)) if model is not None else set()

    def kind(n):
        return 'expert' if n in expert else 'sharded' if n in sharded else 'replicated'

    groups = {'expert': (grid.dp_group, 1), 'sharded': (grid.stat_group, 1),
              'replicated': (grid.group, grid.model)}
    out, extras = dict(grads), list(extra)
    for k, (group, div) in groups.items():
        names = [n for n in grads if kind(n) == k]
        more = extras if k == 'replicated' else []
        if names or more:
            summed = collectives.all_reduce_sum_flat([grads[n] for n in names] + more, group)
            summed = [v / div if div != 1 else v for v in summed]
            out.update(zip(names, summed))
            if more:
                extras = summed[len(names):]
    return out, extras


def combined_value_stats_and_grad(
    loss_fn: Callable[..., torch.Tensor],
    registry: registry_lib.Registry | None = None,
    ep_ffns: Sequence[EPSwitchFFN] = (),
    model: nn.Module | None = None,
) -> Callable[..., Any]:
    """One backward spanning the hook capture of ``registry``'s layers and
    any number of EP blocks. ``loss_fn(*args, ffns)`` computes this rank's
    mean loss over its own tokens; the i-th EP block runs as ``ffns[i](x)``
    (or inside ``model``, which calls its blocks itself), exactly once.
    Each block needs a distinct ``name_prefix``.

    Returns ``run(*args, capture=True) -> ((loss, None), grads,
    CapturedStats)``: the
    global mean loss, the global grads keyed by parameter name (``model``'s,
    else ``registry.model``'s and the blocks' own under their prefix with
    '/' as '.'; :func:`reduce_grads`) and the merged global statistics
    (hook layers averaged as ``capture.weighted_average`` does and reduced
    over the token ranks; the blocks' already normalized in-body). Without
    EP blocks it is the rank's own capture, unreduced. ``capture=False``
    (a step off the factor cadence) runs the same loss and grads with no
    hook and no in-body statistics, and returns None for them."""
    prefixes = [f.name_prefix for f in ep_ffns]
    if len(set(prefixes)) != len(prefixes):
        raise ValueError(f'EP FFN name_prefixes must be distinct, got {prefixes}')
    grid = _grid_of(ep_ffns)
    model = model if model is not None else (registry.model if registry is not None else None)
    owned = {id(m) for _, m in ep_blocks(model)} if model is not None else set()
    hooked = None
    if registry is not None:  # the blocks' own layers capture in-body, not by hooks
        inside = {id(m) for f in ep_ffns for m in f.modules()}
        keep = [n for n in registry.layers if id(registry.modules[n]) not in inside]
        if keep:
            hooked = registry_lib.Registry(
                model=registry.model, layers={n: registry.layers[n] for n in keep},
                modules={n: registry.modules[n] for n in keep},
                param_paths={n: registry.param_paths[n] for n in keep},
                taps={k: v for k, v in registry.taps.items() if v[0] in keep},
            )
    loose = [f for f in ep_ffns if id(f) not in owned]  # blocks outside ``model``

    def named(f):
        return f.name_prefix.replace('/', '.')

    def run(*args: Any, capture: bool = True, **kwargs: Any):
        boxes = [_Capture() for _ in ep_ffns]
        token_ranks = float(grid.stat_world) if grid is not None else 1.0
        if model is not None:
            model.zero_grad(set_to_none=True)
        for f, box in zip(ep_ffns, boxes):
            f.zero_grad(set_to_none=True)
            f._capture = box if capture else None
        taps = capture_lib.Taps(hooked) if hooked and capture else None
        try:
            with taps if taps is not None else contextlib.nullcontext():
                loss = loss_fn(*args, list(ep_ffns), **kwargs)
                missing = [prefixes[i] for i, b in enumerate(boxes) if capture and not b.calls]
                if missing:
                    raise ValueError(
                        f'EP block(s) {missing} were never called by loss_fn; every ffn '
                        'in ep_ffns must run exactly once per loss evaluation'
                    )
                (loss / token_ranks).backward()
        finally:
            for f in ep_ffns:
                f._capture = None
        grads = {}  # every parameter in one order on every rank (zero where it got none)
        if model is not None:
            grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                     for n, p in model.named_parameters()}
        for f in loose:
            grads.update({f'{named(f)}{n}': p.grad for n, p in f.named_parameters()
                          if p.grad is not None})
        stats = taps.stats() if taps is not None else capture_lib.CapturedStats(a={}, g={})
        loss = loss.detach()
        if grid is not None:
            if capture:
                stats = _reduce_hook_stats(stats, grid)
            ffn_names = [(p, f) for p, f in ep_blocks(model)] if model is not None else []
            ffn_names += [(named(f).rstrip('.'), f) for f in loose]
            grads, (total,) = reduce_grads(
                grads, grid, model, ffn_names, extra=[loss.float().reshape(1)])
            loss = (total[0] / token_ranks).to(loss.dtype)
        if not capture:
            return (loss, None), grads, None
        a, g, w = dict(stats.a), dict(stats.g), dict(stats.w)
        for box in boxes:
            a.update(box.a)
            g.update(box.g)
            w.update(box.w)
        return (loss, None), grads, capture_lib.CapturedStats(a=a, g=g, w=w, wg=dict(stats.wg))

    return run


@dataclasses.dataclass
class ExpertParallelKFAC:
    """K-FAC over an expert-parallel model: the dense engine ``config``
    (a :class:`~kfac_tpu_torch.KFACPreconditioner` over the rank's
    registry, :func:`register_model`) on the global grads and statistics
    of :func:`combined_value_stats_and_grad`.

    The replicated layers' state is the same on every rank; an expert's
    factors and decompositions live on the ranks that hold it. The kl-clip
    sum spans every layer of the model: the experts' terms (``ffns``'
    layers) are summed over the expert group on the device. On a grid with
    a model axis the tensor-parallel layers' grads are gathered, whole
    layers preconditioned, and the rank's shards returned.
    """

    config: Any
    grid: Any
    ffns: Sequence[EPSwitchFFN] = ()

    def __post_init__(self) -> None:
        self.registry = self.config.registry
        expert_layers = {n for f in self.ffns for n in f.layer_names()[1] + f.layer_names()[2]}
        self._expert_mask = torch.tensor(
            [n in expert_layers for n in self.registry.layers], dtype=torch.bool,
            device=self.config.device,
        )
        self._sharded = tp_lib.sharded_param_names(self.registry.model)

    @property
    def device(self) -> torch.device:
        return self.config.device

    def init(self):
        return self.config.init()

    def vg_reduce(self, terms: torch.Tensor, vg_sum: torch.Tensor) -> torch.Tensor:
        """The whole model's kl-clip sum: the replicated layers' terms and
        the experts' summed over the expert group (on the device)."""
        mask = self._expert_mask
        experts = torch.where(mask, terms, torch.zeros_like(terms)).sum().reshape(1)
        others = torch.where(mask, torch.zeros_like(terms), terms).sum()
        return others + _sum_(experts, self.grid.expert_group)[0]

    def step(self, state, grads, stats, loss=None):
        """One step of the dense engine with the model-wide kl-clip; the
        grads and statistics are :func:`combined_value_stats_and_grad`'s."""
        full = tp_lib.gather_params(self.registry.model, grads) if self._sharded else grads
        state, new = self.config.step(state, full, stats, loss=loss, vg_reduce=self.vg_reduce)
        if self._sharded:
            new = tp_lib.shard_params_like(self.registry.model, new)
        return state, new

    def describe(self) -> str:
        ep = self.grid.expert
        return '\n'.join([
            f'ExpertParallelKFAC: {len(self.registry.layers)} layers on this rank '
            f'({int(self._expert_mask.sum())} of them experts) over expert {ep} x '
            f'model {self.grid.model} x data {self.grid.world_size}; kl-clip summed '
            'over the expert group',
            self.config.describe(),
        ])
