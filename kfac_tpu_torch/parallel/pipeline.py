"""Pipeline parallelism with K-FAC: the GPipe and 1F1B schedules over
point-to-point sends (counterpart of ``kfac_tpu/parallel/pipeline.py``).

The JAX package stacks the stages' parameters on a leading axis sharded
over the mesh's ``pipe`` axis and runs every stage as one traced scan;
here each rank of a :class:`~kfac_tpu_torch.parallel.mesh.PipelineGrid`
holds only its own stage's blocks, runs the schedule's ticks for that
stage, and hands activations and cotangents to its neighbours with
``batch_isend_irecv`` (``collectives.exchange``). The embedding, the final
norm and the bias-free head are replicated; the stage's statistics and
gradients reduce over its data group, never over the pipe.

- **GPipe**: microbatches enter at stage 0 and are handed on; each
  stage's forward keeps its inputs and outputs (with ``remat``, each stage
  application under ``torch.utils.checkpoint``, so only the inputs), then
  the backward runs the microbatches in reverse, each receiving its
  output's cotangent from the next stage and sending its input's to the
  previous one. The last stage computes the head and the loss.
- **1F1B**: at tick ``t`` stage ``s`` runs the forward of microbatch ``t -
  s`` (no graph kept) and the backward of microbatch ``t - (2S - 2 - s)``,
  which recomputes the stage forward from a ring of ``2S - 1`` saved
  inputs with the capture hooks attached; the last stage computes head,
  loss and cotangent inside the tick. Each tick's sends and receives, both
  directions, are posted together. The fill and drain bubbles, which the
  JAX package computes on zeros and masks, are skipped; the statistics
  divide by the same counts.
- **Capture**: A once per microbatch (the stage forward that keeps a
  graph: GPipe's forward, 1F1B's recompute; a checkpoint's recompute adds
  none), G from the cotangents of the global mean loss (each rank's head
  loss is its tokens' NLL sum over the global token count), both summed
  over the microbatches (on the card each microbatch after the first
  added into the stage's running sum by the fused ``sym_cov_ema`` with
  beta 1) and the data group and divided by ``M * dp``, as the JAX package
  divides by its summed tick counts.

:class:`PipelineKFAC` keeps each stage's K-FAC state on its ranks (the
reference's MEM-OPT among pipe peers): the dense engine over the stage's
registry, whose eigendecompositions (or inverses) are spread round-robin
over the stage's data peers and shared by a sum over the data group; the
kl-clip sum is all-reduced over the pipe on the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings as _warnings
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.utils.checkpoint

from kfac_tpu_torch import enums
from kfac_tpu_torch.hyperparams import resolve
from kfac_tpu_torch.layers import capture as capture_lib
from kfac_tpu_torch.layers import registry as registry_lib
from kfac_tpu_torch.models import transformer as transformer_lib
from kfac_tpu_torch.ops import factors as factors_lib
from kfac_tpu_torch.ops import losses
from kfac_tpu_torch.parallel import collectives
from kfac_tpu_torch.parallel import tensor_parallel as tp_lib
from kfac_tpu_torch.warnings import ExperimentalFeatureWarning

SCHEDULES = ('gpipe', '1f1b', 'interleaved')
# StageBlocks' Megatron pairing: q/k/v and mlp_up column-parallel, out_proj
# and mlp_down row-parallel (the JAX package's default tp_overrides)
STAGE_TP_OVERRIDES = (
    (r'.*(q_proj|k_proj|v_proj|mlp_up)', 'column'),
    (r'.*(out_proj|mlp_down)', 'row'),
)


class StageBlocks(nn.Module):
    """A pipeline stage: ``blocks_per_stage`` transformer blocks
    (``block0``, ``block1``, ...)."""

    def __init__(
        self, blocks_per_stage: int, d_model: int, num_heads: int, mlp_ratio: int = 4,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.blocks_per_stage = blocks_per_stage
        for i in range(blocks_per_stage):
            self.add_module(f'block{i}', transformer_lib.Block(d_model, num_heads, mlp_ratio, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.blocks_per_stage):
            x = getattr(self, f'block{i}')(x)
        return x


@torch.no_grad()
def _draw(module: nn.Module, generator: torch.Generator) -> None:
    """``TransformerLM.reset_parameters``' draws for ``module``'s dense
    layers and LayerNorms, in module order."""
    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            std = 1.0 / math.sqrt(mod.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


class _Off:
    """The schedule's capture switch when nothing is captured."""

    active = False


class PipelinedLM(nn.Module):
    """Decoder LM with its blocks pipelined over ``grid``'s pipe axis.

    Each rank holds the embedding, ``pos_embed``, ``ln_f``, the bias-free
    ``lm_head`` and its own stage (``stage``): :class:`StageBlocks` of
    ``num_layers / n_stages`` blocks, or ``stage_module()``, a factory of
    any module mapping ``(B, S, d_model)`` to itself. ``seed`` draws the
    weights in ``TransformerLM``'s order (embedding, positions, the stages
    in order, ``ln_f``, the head), so stage ``s`` holds blocks ``s * k`` to
    ``(s + 1) * k - 1`` of the ``TransformerLM`` of that seed.

    ``n_microbatches`` must divide the batch, and the data axis each
    microbatch. ``schedule`` is ``'gpipe'`` or ``'1f1b'`` (``'interleaved'``
    raises: it is :class:`~kfac_tpu_torch.parallel.interleaved_scan.
    InterleavedPipelinedLM`'s); ``remat`` checkpoints each GPipe stage
    application.
    ``skip_layers`` and ``routed_layers`` go to the stage's
    ``register_model`` (a routed layer inside a stage raises
    ``NotImplementedError``, as in the JAX package). On a grid with a
    model axis the stage's layers shard by ``tp_overrides`` (default: the
    Megatron pairing) and the head is vocab-parallel. ``params`` (this
    stage's full ``state_dict``) is loaded in place of the drawn weights,
    before any sharding.
    """

    def __init__(
        self,
        grid: Any,
        vocab_size: int,
        d_model: int,
        num_heads: int,
        num_layers: int,
        n_microbatches: int = 4,
        mlp_ratio: int = 4,
        max_len: int = 2048,
        dtype: torch.dtype = torch.float32,
        remat: bool = True,
        schedule: str = 'gpipe',
        skip_layers: Sequence[str] | None = None,
        tp_overrides: Sequence[tuple[str, str]] = STAGE_TP_OVERRIDES,
        stage_module: Callable[[], nn.Module] | None = None,
        routed_layers: Sequence[str] | None = None,
        seed: int = 0,
        params: dict[str, torch.Tensor] | None = None,
    ):
        super().__init__()
        _warnings.warn(
            'pipeline-parallel K-FAC is experimental (the reference flags its '
            'pipeline support the same way)',
            ExperimentalFeatureWarning,
            stacklevel=2,
        )
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}: 'gpipe', '1f1b', or 'interleaved'")
        if schedule == 'interleaved' and not self._executes_interleaved():
            raise ValueError(
                "the 'interleaved' schedule requires InterleavedPipelinedLM "
                '(parallel/interleaved_scan.py)'
            )
        self.grid = grid
        self.schedule = schedule
        # logical stages: pipe ranks x chunks a rank (1 here; the interleaved
        # subclass's virtual_chunks), so the stage modules and the registry
        # are built once
        self.n_stages = grid.n_stages * self._chunks_per_rank()
        self.n_microbatches = n_microbatches
        self.d_model = d_model
        self.dtype = dtype
        self.remat = remat
        device = grid.device
        if stage_module is None:
            if num_layers % self.n_stages != 0:
                raise ValueError('num_layers must divide evenly into stages')
            per = num_layers // self.n_stages

            def stage_module():
                return StageBlocks(per, d_model, num_heads, mlp_ratio, dtype)

        gen = torch.Generator().manual_seed(seed)
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.empty(max_len, d_model))
        with torch.no_grad():
            self.embed.weight.normal_(0.0, 1.0, generator=gen)
            self.pos_embed.normal_(0.0, 0.02, generator=gen)
        mine = []
        for s in range(self.n_stages):  # every stage's draws, this rank's kept
            stage = stage_module()
            _draw(stage, gen)
            if s % grid.n_stages == grid.stage:  # logical stage s = c * p + rank
                mine.append(stage)
        self.stage = self._stage_of(mine)
        x = torch.zeros((1, 8, d_model), dtype=dtype)
        with torch.no_grad():
            out_shape = tuple(mine[0](x).shape)
        if out_shape != tuple(x.shape):
            raise ValueError(
                f'stage module must map (B, S, {d_model}) to itself (pipeline stages '
                f'chain), got output shape {out_shape}'
            )
        self.ln_f = nn.LayerNorm(d_model, eps=transformer_lib.LN_EPS)
        self.lm_head = nn.Linear(d_model, vocab_size, bias=False)
        _draw(self.ln_f, gen)
        _draw(self.lm_head, gen)
        if params is not None:  # a whole stage's (convert.from_flax_pipeline_params)
            self.load_state_dict(params)
        self.to(device)
        self.skip_layers = list(skip_layers or [])
        self.routed_layers = list(routed_layers or [])
        self.stage_registry = self._register()
        weighted = [n for n, h in self.stage_registry.layers.items() if h.weighted]
        if weighted:
            raise NotImplementedError(
                f'routed (traffic-weighted) layers {weighted} are not supported inside '
                'pipeline stages; the pipeline capture keeps equal-weight averaging'
            )
        if grid.model > 1:
            self._shard(tp_overrides)
        # the first point-to-point call of a group must involve all its
        # ranks under NCCL: one collective over the pipe group first
        if grid.n_stages > 1:
            dist.all_reduce(torch.zeros(1, device=device), group=grid.pipe_group)

    def _chunks_per_rank(self) -> int:
        """Model chunks a pipeline rank holds (1 here; the interleaved
        subclass returns ``virtual_chunks``)."""
        return 1

    def _executes_interleaved(self) -> bool:
        """Whether this class runs the single-slot interleaved schedule."""
        return False

    def _stage_of(self, mine: list[nn.Module]) -> nn.Module:
        """This rank's ``stage`` module from its logical stages' modules
        (one here)."""
        return mine[0]

    def _register(self) -> registry_lib.Registry:
        return registry_lib.register_model(
            self.stage, skip_layers=self.skip_layers, device=self.grid.device,
            routed_layers=self.routed_layers or None,
        )

    def _shard(self, tp_overrides) -> None:
        """Shard the stage's layers over the model axis by the registry's
        kinds (``tp_overrides`` first) and the head by its vocabulary;
        re-register the sharded stage."""
        grid = self.grid
        specs = tp_lib.registry_param_specs(
            self.stage, self.stage_registry, overrides=tp_overrides, warn_unmatched=False,
        )
        if not any(s.dim is not None for s in specs.values()):
            _warnings.warn(
                f'model axis has {grid.model} shards but NO stage parameter matched a '
                'tensor-parallel rule: all stage weights are fully replicated over the model '
                "axis. Pass tp_overrides mapping your stage layer names to 'column'/'row' "
                '(square layers are never sharded by the shape heuristic).',
                tp_lib.UnshardedParamWarning,
                stacklevel=3,
            )
        tp_lib.shard_params_from_registry(
            self.stage, grid, self.stage_registry, overrides=tp_overrides, warn_unmatched=False,
        )
        tp_lib.shard_params(self, grid, rules=((r'lm_head/weight', tp_lib.ShardSpec(0)),))
        self.stage_registry = self._register()

    # ------------------------------------------------------------ batches

    def local_microbatches(self, batch: Any) -> Any:
        """Each tensor of a global ``(B, ...)`` batch as this rank's
        ``(M, B / (M * dp), ...)``: the microbatches' rows, each split over
        the data axis (the JAX package's ``P(None, data)`` feed)."""
        m, dp, d = self.n_microbatches, self.grid.dp, self.grid.data

        def take(x):
            b = x.shape[0]
            if b % m:
                raise ValueError(f'batch {b} not divisible by {m} microbatches')
            if (b // m) % dp:
                raise ValueError(
                    f'per-microbatch batch {b // m} not divisible by the data-parallel world {dp}'
                )
            per = b // m // dp
            return x.reshape(m, b // m, *x.shape[1:])[:, d * per:(d + 1) * per]

        return tuple(take(x) for x in batch) if isinstance(batch, (tuple, list)) else take(batch)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens) + self.pos_embed[: tokens.shape[-1]]
        return x.to(self.dtype)

    def _logits(self, y: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.ln_f(y.float()))

    def _nll(self, y: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        head = self.lm_head
        if getattr(head, 'parallel', None) == 'column':  # vocab-sharded
            per = head.weight.shape[0]
            return losses.vocab_parallel_nll(self._logits(y), targets, head.group, head.index * per)
        return losses.vocab_parallel_nll(self._logits(y), targets)

    def _peer(self, stage: int) -> int:
        return self.grid.rank_of(stage)

    def _buffer(self, like_shape) -> torch.Tensor:
        return torch.empty(like_shape, dtype=self.dtype, device=self.grid.device)

    # ------------------------------------------------------------ forward

    @torch.no_grad()
    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        """Pipelined forward of a global ``(B, S)`` batch: this rank's
        logits ``(M, B / (M * dp), S, V)`` (:meth:`local_microbatches`'
        rows; the last stage's, sent to every stage by one all-reduce over
        the pipe)."""
        grid = self.grid
        tok = self.local_microbatches(tokens)
        m, s = self.n_microbatches, grid.stage
        shape = tok.shape[1:] + (self.d_model,)
        outs = []
        for i in range(m):
            if s == 0:
                x = self._embed(tok[i])
            else:
                x = self._buffer(shape)
                collectives.exchange([], [(x, self._peer(s - 1))])
            y = self.stage(x)
            if s < self.n_stages - 1:
                collectives.exchange([(y, self._peer(s + 1))], [])
            else:
                outs.append(self._logits(y))
        v = self.lm_head.weight.shape[0]  # this rank's vocab (shard)
        logits = torch.stack(outs) if outs else torch.zeros(
            (m, *tok.shape[1:], v), device=grid.device
        )
        if self.n_stages > 1:
            dist.all_reduce(logits, group=grid.pipe_group)
        return logits

    # --------------------------------------------------------------- loss

    def loss_and_stats(
        self, batch: Any, capture: bool = True,
    ) -> tuple[torch.Tensor, dict, capture_lib.CapturedStats | None]:
        """``(loss, grads, stats)`` of a global ``(tokens, targets)``
        batch in one pass of the schedule: the global mean loss (on every
        rank), the global grads of this rank's parameters keyed by
        parameter name (the stage's summed over its data group; the
        embedding's, positions', ``ln_f``'s and the head's over every rank)
        and the stage's statistics (summed over the microbatches and the
        data group, divided by ``M * dp``). ``capture=False`` (a step off
        the factor cadence) attaches no hook and returns None for the
        statistics."""
        tokens, targets = self.local_microbatches(batch)
        self.zero_grad(set_to_none=True)
        total = float(targets.numel() * self.grid.dp)
        taps = capture_lib.Taps(self.stage_registry) if capture else None
        run = self._schedule_fn()
        with taps if capture else contextlib.nullcontext():
            loss = run(tokens, targets, total, taps or _Off())
        return self._reduce(loss, taps)

    def _schedule_fn(self) -> Callable:
        """The schedule's body: ``run(tokens, targets, total, taps) ->
        loss``."""
        return self._gpipe if self.schedule == 'gpipe' else self._one_f_one_b

    def _feed(self, tokens: torch.Tensor):
        """Stage 0's embedded microbatches and a leaf view of them (the
        schedule's inputs; the embedding's backward runs once, at the
        end, from the collected input cotangents)."""
        feed = self._embed(tokens)
        return feed, feed.detach()

    def _gpipe(self, tokens, targets, total, taps) -> torch.Tensor:
        grid = self.grid
        s, last, m = grid.stage, self.n_stages - 1, self.n_microbatches
        shape = tokens.shape[1:] + (self.d_model,)
        feed, leaf = self._feed(tokens) if s == 0 else (None, None)
        xs, ys = [], []
        for i in range(m):
            if s == 0:
                x = leaf[i].clone().requires_grad_(True)
            else:
                x = self._buffer(shape)
                collectives.exchange([], [(x, self._peer(s - 1))])
                x.requires_grad_(True)
            taps.active = True
            if self.remat:
                y = torch.utils.checkpoint.checkpoint(self.stage, x, use_reentrant=False)
            else:
                y = self.stage(x)
            taps.active = False  # a checkpoint's recompute adds no A
            if s < last:
                collectives.exchange([(y.detach(), self._peer(s + 1))], [])
            xs.append(x)
            ys.append(y)
        loss = torch.zeros((), device=grid.device)
        xbars = [None] * m
        for i in reversed(range(m)):
            if s == last:
                lval = self._nll(ys[i], targets[i]).sum() / total
                lval.backward()
                loss = loss + lval.detach()
            else:
                ybar = self._buffer(shape)
                collectives.exchange([], [(ybar, self._peer(s + 1))])
                torch.autograd.backward(ys[i], ybar)
            if s > 0:
                collectives.exchange([(xs[i].grad, self._peer(s - 1))], [])
            else:
                xbars[i] = xs[i].grad
            ys[i] = xs[i] = None
        if s == 0:
            feed.backward(torch.stack(xbars))
        return loss

    def _one_f_one_b(self, tokens, targets, total, taps) -> torch.Tensor:
        grid = self.grid
        n, s, m = self.n_stages, grid.stage, self.n_microbatches
        last = n - 1
        shape = tokens.shape[1:] + (self.d_model,)
        ring = [None] * (2 * n - 1)
        feed, leaf = self._feed(tokens) if s == 0 else (None, None)
        xbars = [None] * m
        loss = torch.zeros((), device=grid.device)
        x_recv = g_recv = ybar_local = None
        for t in range(m + 2 * n - 2):
            sends = []
            # forward slot: microbatch t - s, no graph kept
            m_f = t - s
            if 0 <= m_f < m:
                x_in = leaf[m_f] if s == 0 else x_recv
                taps.active = False
                with torch.no_grad():
                    y = self.stage(x_in)
                ring[m_f % len(ring)] = x_in
                if s == last:  # the head, the loss and the cotangent, in this tick
                    y = y.requires_grad_(True)
                    lval = self._nll(y, targets[m_f]).sum() / total
                    lval.backward()
                    loss = loss + lval.detach()
                    ybar_local = y.grad
                else:
                    sends.append((y, self._peer(s + 1)))
            # backward slot: microbatch t - (2S - 2 - s), the forward recomputed
            m_b = t - (2 * n - 2 - s)
            if 0 <= m_b < m:
                x = ring[m_b % len(ring)].detach().requires_grad_(True)
                ring[m_b % len(ring)] = None
                ybar = ybar_local if s == last else g_recv
                taps.active = True
                y = self.stage(x)
                taps.active = False
                torch.autograd.backward(y, ybar)
                if s > 0:
                    sends.append((x.grad, self._peer(s - 1)))
                else:
                    xbars[m_b] = x.grad
            # the next tick's inputs, posted with this tick's sends
            recvs = []
            x_recv = g_recv = None
            if s > 0 and 0 <= t + 1 - s < m:
                x_recv = self._buffer(shape)
                recvs.append((x_recv, self._peer(s - 1)))
            if s < last and 0 <= t + 1 - (2 * n - 2 - s) < m:
                g_recv = self._buffer(shape)
                recvs.append((g_recv, self._peer(s + 1)))
            collectives.exchange(sends, recvs)
        if s == 0:
            feed.backward(torch.stack(xbars))
        return loss

    def _reduce(self, loss, taps) -> tuple[torch.Tensor, dict, capture_lib.CapturedStats]:
        """The schedule's sums made global: stage grads and statistics over
        the data group (one flat all-reduce), the loss and the replicated
        grads over every rank (zero where a rank did not compute them; the
        model ranks hold copies, so divided by the model axis), a
        vocab-sharded head over the ranks of its shard."""
        grid = self.grid
        # every parameter in one order on every rank (zero where this rank
        # computed none)
        grads = {
            n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in self.named_parameters()
        }
        stats = taps.stats() if taps is not None else capture_lib.CapturedStats(a={}, g={})
        names = list(stats.a)
        stage = [n for n in grads if n.startswith('stage.')]
        sharded_head = getattr(self.lm_head, 'parallel', None) == 'column'
        head = ['lm_head.weight'] if sharded_head else []
        rest = [n for n in grads if n not in stage and n not in head]
        dp = float(grid.dp)
        parts = collectives.all_reduce_sum_flat(
            [grads[n] for n in stage] + [stats.a[n] for n in names] + [stats.g[n] for n in names],
            grid.dp_group,
        )
        out = dict(zip(stage, parts))
        k = len(stage)
        a = {n: v / dp for n, v in zip(names, parts[k:k + len(names)])}
        g = {n: v / dp for n, v in zip(names, parts[k + len(names):])}
        summed = collectives.all_reduce_sum_flat(
            [grads[n] for n in rest] + [loss.reshape(1)], grid.group
        )
        div = float(grid.model)
        out.update({n: v / div for n, v in zip(rest, summed)})
        if head:
            out['lm_head.weight'] = collectives.all_reduce_sum(
                [grads['lm_head.weight']], grid.groups['shard']
            )[0]
        loss = summed[-1][0] / div
        return loss, out, capture_lib.CapturedStats(a=a, g=g) if taps is not None else None


@dataclasses.dataclass
class PipelineKFAC:
    """K-FAC for a :class:`PipelinedLM`'s stage layers.

    ``config`` is a :class:`~kfac_tpu_torch.KFACPreconditioner` over
    ``model.stage_registry``; its state is this rank's stage's (a dense
    ``KFACState``), so each stage decomposes and preconditions only its
    own layers, with no traffic across stages but the kl-clip sum (one
    all-reduce over the pipe group, on the device). Each stage's
    decompositions are spread round-robin over its data peers (layer ``i``
    on data rank ``i % dp``) and shared by one sum over the data group.
    EIGEN and INVERSE (Cholesky or Newton-Schulz) are both supported.
    """

    config: Any
    model: PipelinedLM

    def __post_init__(self) -> None:
        cfg = self.config
        if cfg.prediv_eigenvalues:
            raise NotImplementedError('prediv_eigenvalues is not supported by PipelineKFAC')
        for knob in ('health', 'metrics', 'flight', 'async_inverse', 'offload'):
            if getattr(cfg, knob) not in (None, False):
                raise NotImplementedError(f'{knob} on PipelineKFAC is not ported to kfac_tpu_torch yet')
        self.grid = self.model.grid
        self.mesh = self.grid
        self.registry = self.model.stage_registry
        self.n_stages = self.model.n_stages
        self.world = self.grid.total_devices
        self._eigen = cfg.compute_method == enums.ComputeMethod.EIGEN
        self._sharded = tp_lib.sharded_param_names(self.model.stage)

    @property
    def device(self) -> torch.device:
        return self.grid.device

    def init(self):
        return self.config.init()

    def _decompose(self, state):
        """The stage's decompositions from its factors: layer ``i`` on data
        rank ``i % dp``, the others' slots zero, then one sum over the data
        group (without data peers, the dense engine's refresh)."""
        cfg, dp = self.config, self.grid.dp
        if dp == 1:
            return cfg.update_inverses(state)
        damping = resolve(cfg.damping, state.step)
        fields = ('qa', 'qg', 'da', 'dg') if self._eigen else ('a_inv', 'g_inv')
        slots = []
        for i, n in enumerate(self.registry.layers):
            mine = i % dp == self.grid.data
            if not mine:
                slots += [torch.zeros_like(getattr(state, f)[n]) for f in fields]
            elif self._eigen:
                adec = factors_lib.compute_eigh(state.a[n], cfg.eigh_impl, cfg.inv_dtype)
                gdec = factors_lib.compute_eigh(state.g[n], cfg.eigh_impl, cfg.inv_dtype)
                slots += [adec.q, gdec.q, adec.d, gdec.d]
            else:
                slots += [
                    factors_lib.damped_inverse(
                        f, damping, cfg.inverse_solver, cfg.newton_schulz_iters, x0=prev,
                    ).to(cfg.inv_dtype)
                    for f, prev in ((state.a[n], state.a_inv[n]), (state.g[n], state.g_inv[n]))
                ]
        summed = collectives.all_reduce_sum_flat(slots, self.grid.dp_group)
        names = list(self.registry.layers)
        k = len(fields)
        return dataclasses.replace(state, **{
            f: {n: summed[i * k + j] for i, n in enumerate(names)} for j, f in enumerate(fields)
        })

    def _vg_reduce(self, terms: torch.Tensor, vg_sum: torch.Tensor) -> torch.Tensor:
        """Every stage's kl-clip sum: this stage's, all-reduced over the
        pipe group on the device."""
        if self.grid.n_stages == 1:
            return vg_sum
        return collectives.all_reduce_sum([vg_sum.reshape(1)], self.grid.pipe_group)[0][0]

    def step(self, state, grads: dict[str, torch.Tensor], stats: capture_lib.CapturedStats | None):
        """Update the stage's factors and decompositions on their cadences
        and precondition its grads (the ``stage.``-prefixed entries of
        ``grads``, :meth:`PipelinedLM.loss_and_stats`'); the other grads
        pass through."""
        cfg = self.config
        step = state.step
        if stats is not None and step % resolve(cfg.factor_update_steps, step) == 0:
            state = cfg.update_factors(state, stats)
        if step % resolve(cfg.inv_update_steps, step) == 0:
            state = self._decompose(state)
        stage = {n[len('stage.'):]: g for n, g in grads.items() if n.startswith('stage.')}
        if self._sharded:
            stage = tp_lib.gather_params(self.model.stage, stage)
        new = cfg.precondition(state, stage, vg_reduce=self._vg_reduce)
        if self._sharded:
            new = tp_lib.shard_params_like(self.model.stage, new)
        out = dict(grads)
        out.update({f'stage.{n}': g for n, g in new.items()})
        return dataclasses.replace(state, step=step + 1), out

    def rematerialize(self, state):
        """Recompute the decompositions from the stored factors (a
        checkpoint restore: only the step and the factors are durable)."""
        return self._decompose(state)

    def describe(self) -> str:
        """Registration and placement."""
        return '\n'.join([
            f'PipelineKFAC: {len(self.registry.layers)} layers per rank x {self.grid.n_stages} '
            f'ranks ({self.n_stages} logical stages; pipe {self.grid.n_stages} x data '
            f'{self.grid.dp} x model {self.grid.model}), '
            'placement=MEM-OPT among pipe peers (stage-local state), decomposition '
            f'round-robin over dp={self.grid.dp}, method={self.config.compute_method.name}',
            self.config.describe(),
        ])

    def extract_factors(self, state) -> dict[str, dict[str, torch.Tensor]]:
        """This stage's per-layer factors (portable across pipeline engines
        of the same stage count)."""
        return self.config.extract_factors(state)

    def insert_factors(self, state, factors):
        """Inverse of :meth:`extract_factors`; call :meth:`rematerialize`
        afterwards."""
        return self.config.insert_factors(state, factors)

    def topology(self) -> dict[str, Any]:
        return {
            'engine': 'PipelineKFAC', 'n_stages': self.n_stages, 'dp': self.grid.dp,
            'model': self.grid.model, 'stage': self.grid.stage,
            'virtual_chunks': self.model._chunks_per_rank(),
        }
