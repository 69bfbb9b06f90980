"""Transformer LM trainer with K-FAC (counterpart of
``examples/train_language_model.py``, the reference's
``torch_language_model.py``).

Every branch of the JAX script: the dense engine in one process; under a
launcher, ``DistributedKFAC`` over ``train_mesh`` with tensor parallelism
(``--model-shards``, Megatron layouts) and sequence parallelism
(``--seq-shards``, ring attention); ``--bf16``; ``--resume`` from the
latest epoch checkpoint of ``--checkpoint-dir``; and ``--pipeline-stages``
(``PipelinedLM`` under ``gpipe`` or ``1f1b``, ``InterleavedPipelinedLM``
under ``interleaved`` with ``--virtual-chunks``; the remaining ranks are a
stage's data peers) with ``PipelineKFAC``. The optimizer is global-norm
clip 1.0, then SGD with momentum on the warmup-and-decay schedule, applied
to the preconditioned grads. The data is ``corpus.npy`` from
``--data-dir``, else the seeded Zipf stream; each rank of a data-parallel
world loads only its rows of each batch (the per-rank loader).

Usage::

    python -m kfac_tpu_torch.examples.train_language_model --epochs 1 --limit-steps 20
    python -m kfac_tpu_torch.examples.train_language_model --device cpu --d-model 32 \\
        --num-heads 4 --num-layers 2 --seq-len 16 --batch-size 8 --limit-steps 3
    torchrun --nproc-per-node 4 -m kfac_tpu_torch.examples.train_language_model \\
        --pipeline-stages 2 --pipeline-schedule interleaved --virtual-chunks 3
"""

from __future__ import annotations

import argparse
import math
from typing import Any, Callable

import torch
import torch.distributed as dist

from kfac_tpu_torch import data
from kfac_tpu_torch.device import resolve_device
from kfac_tpu_torch.examples import common
from kfac_tpu_torch.hyperparams import resolve
from kfac_tpu_torch.layers.registry import register_model
from kfac_tpu_torch.models import TransformerLM, lm_loss
from kfac_tpu_torch.parallel import tensor_parallel
from kfac_tpu_torch.training import Trainer, TrainState


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='Transformer LM + K-FAC')
    p.add_argument('--d-model', type=int, default=256)
    p.add_argument('--num-heads', type=int, default=8)
    p.add_argument('--num-layers', type=int, default=4)
    p.add_argument('--seq-len', type=int, default=256)
    p.add_argument('--vocab-size', type=int, default=8192)
    p.add_argument('--model-shards', type=int, default=1)
    p.add_argument('--seq-shards', type=int, default=1)
    p.add_argument('--pipeline-stages', type=int, default=0,
                   help='pipeline the transformer blocks over this many stages (the remaining '
                        'ranks become data-parallel peers)')
    p.add_argument('--pipeline-microbatches', type=int, default=4)
    p.add_argument('--pipeline-schedule', choices=['gpipe', '1f1b', 'interleaved'], default='1f1b',
                   help="'interleaved' runs the single-slot virtual-stage schedule (--virtual-chunks "
                        'model chunks per rank; microbatches must be a multiple of the stage count)')
    p.add_argument('--virtual-chunks', type=int, default=2,
                   help='model chunks per pipeline rank under --pipeline-schedule=interleaved')
    common.add_train_args(p)
    common.add_kfac_args(p)
    common.add_metrics_args(p)
    return p.parse_args(argv)


def steps_per_epoch(args, tokens) -> int:
    steps = (len(tokens) - 1) // (args.seq_len * args.batch_size)
    if args.limit_steps:
        steps = min(steps, args.limit_steps)
    return steps


def run_epochs(args, tokens, step_fn, device, start_epoch=0, on_epoch_end=None, rank=0, world=1):
    """The epoch loop: this rank's rows of each batch of the corpus windows
    (``seed + epoch``), ``--limit-steps``, ``step_fn(batch) -> loss`` (the
    global mean), perplexity a epoch. Returns ``{'ppl', 'losses',
    'epoch_losses'}``."""
    timer = common.Timer()
    writer = common.MetricsWriter(getattr(args, 'metrics_csv', None))
    ppl, losses, epoch_losses = float('inf'), [], []
    for epoch in range(start_epoch, args.epochs):
        lm = common.Metric()
        batches = data.lm_batches(tokens, args.batch_size, args.seq_len, args.seed + epoch,
                                  rank=rank, world=world)
        for step, (xb, yb) in enumerate(batches):
            if args.limit_steps and step >= args.limit_steps:
                break
            batch = (torch.from_numpy(xb).long().to(device), torch.from_numpy(yb).long().to(device))
            loss = float(step_fn(batch))
            losses.append(loss)
            lm.update(loss, xb.size)
        ppl = float(math.exp(min(20.0, lm.avg)))
        epoch_losses.append(lm.avg)
        common.log(f'epoch {epoch}: train_loss={lm.avg:.4f} ppl={ppl:.1f} elapsed={timer.elapsed():.1f}s')
        writer.write_many(epoch, {'train_loss': lm.avg, 'ppl': ppl, 'elapsed_s': timer.elapsed()})
        if on_epoch_end is not None:
            on_epoch_end(epoch)
    writer.close()
    return {'ppl': ppl, 'losses': losses, 'epoch_losses': epoch_losses}


def norm_groups_of(model, grid) -> list:
    """The tensor-parallel shards' grads sum over the model axis in the
    global norm."""
    sharded = tensor_parallel.sharded_param_names(model)
    if not sharded:
        return []
    params = dict(model.named_parameters())
    return [([params[n] for n in sharded], [grid.model_group])]


def run(args: argparse.Namespace, init_params: Callable[[Any], dict] | None = None) -> dict:
    """Train as the flags say. ``init_params(grid)`` (``grid`` None in one
    process, else the rank's training or pipeline grid) gives the model's
    initial ``state_dict`` (a pipeline rank's: its stage or chunks), in
    place of the weights drawn from ``--seed``. Returns ``{'ppl', 'losses',
    'epoch_losses', ...}``: the final perplexity, every step's loss and each
    epoch's mean (the dense path adds ``loader_rows``, the ``(world,
    rank)`` of the row blocks its loader read)."""
    device = resolve_device(args.device)
    if args.pipeline_stages:
        return _pipeline_run(args, device, init_params)
    made = common.distributed_init(device)
    try:
        return _dense_run(args, device, init_params)
    finally:
        if made:
            dist.destroy_process_group()


def _dense_run(args, device, init_params) -> dict:
    from kfac_tpu_torch.parallel import train_mesh

    grid = None
    if dist.is_initialized():
        world = dist.get_world_size()
        dp = world // (args.model_shards * args.seq_shards)
        frac = common.strategy_fraction(args.kfac_strategy, dp)
        grid = train_mesh(frac, model=args.model_shards, seq=args.seq_shards, device=device)
    elif args.model_shards > 1 or args.seq_shards > 1:
        raise SystemExit('--model-shards and --seq-shards need a world of ranks (torchrun)')
    tokens, vocab = data.lm_corpus(args.data_dir, args.vocab_size)
    sp = args.seq_shards > 1
    model = TransformerLM(
        vocab_size=vocab, d_model=args.d_model, num_heads=args.num_heads,
        num_layers=args.num_layers, max_len=args.seq_len, seed=args.seed, device=device,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        ring_mesh=grid if sp else None, ring_axis='seq' if sp else None,
    )
    if init_params is not None:
        model.load_state_dict(init_params(grid))
    if args.model_shards > 1:
        tensor_parallel.shard_params(model, grid)
    registry = register_model(model, skip_layers=args.kfac_skip_layers, device=device)
    common.log(f'registered {len(registry.layers)} K-FAC layers; '
               f'world {common.world_size()} (model {args.model_shards}, seq {args.seq_shards})')
    loss = lm_loss(model)

    def loss_fn(model_state, batch):
        return loss(batch), model_state

    lr = common.make_lr_schedule(args.lr, steps_per_epoch(args, tokens), args.epochs,
                                 args.warmup_epochs, args.lr_decay)
    kfac = common.build_kfac(args, registry, grid, lr=lr, device=device)
    optimizer = common.ChainSGD(model.parameters(), lr, momentum=args.momentum, clip_norm=1.0,
                                norm_groups=norm_groups_of(model, grid))
    # the per-rank loader: each rank reads its row block of every batch
    # (with --no-kfac every rank trains on the whole batch: no engine
    # averages the grads)
    rows = grid.token_rows if grid is not None and kfac is not None else (1, 0)
    trainer = Trainer(model, optimizer, loss_fn, kfac=kfac, device=device,
                      local_batches=grid is not None)
    state = trainer.init()
    start_epoch = 0
    if args.resume and args.checkpoint_dir:
        restored = common.restore_checkpoint(args.checkpoint_dir, kfac, ('model', 'optimizer'))
        if restored is not None:
            kstate, extra, start_epoch = restored
            model.load_state_dict(extra['model'])
            optimizer.load_state_dict(extra['optimizer'])
            state = TrainState(kstate)
            trainer.resume(state)
    box = {'state': state}

    def step_fn(batch):
        box['state'], loss_value = trainer.step(box['state'], batch)
        return loss_value

    def on_epoch_end(epoch):
        if args.checkpoint_dir:
            common.save_checkpoint(
                args.checkpoint_dir, box['state'].kfac_state,
                {'model': model.state_dict(), 'optimizer': optimizer.state_dict()}, epoch,
                kfac_engine=kfac,
            )
        common.log_inverse_residuals(args, kfac, box['state'].kfac_state)

    out = run_epochs(args, tokens, step_fn, device, start_epoch, on_epoch_end,
                     rank=rows[1], world=rows[0])
    out.update(trainer=trainer, state=box['state'], loader_rows=rows)
    return out


def _pipeline_run(args, device, init_params) -> dict:
    """The pipeline path: the stages' state on their ranks (MEM-OPT among
    pipe peers), loss, grads and statistics from one pass of the schedule;
    each rank loads the whole batch (every stage's microbatches are cut from
    it)."""
    from kfac_tpu_torch.parallel import (
        InterleavedPipelinedLM, PipelinedLM, PipelineKFAC, pipeline_mesh,
    )

    if args.seq_shards > 1:
        raise SystemExit(
            '--pipeline-stages does not compose with --seq-shards; sequence parallelism requires '
            'the non-pipelined path'
        )
    made = common.distributed_init(device, need_group=True)
    try:
        grid = pipeline_mesh(args.pipeline_stages, model=args.model_shards, device=device)
        tokens, vocab = data.lm_corpus(args.data_dir, args.vocab_size)
        kw = dict(
            vocab_size=vocab, d_model=args.d_model, num_heads=args.num_heads,
            num_layers=args.num_layers, n_microbatches=args.pipeline_microbatches,
            max_len=args.seq_len, dtype=torch.bfloat16 if args.bf16 else torch.float32,
            skip_layers=tuple(args.kfac_skip_layers), seed=args.seed,
            params=init_params(grid) if init_params is not None else None,
        )
        if args.pipeline_schedule == 'interleaved':
            model = InterleavedPipelinedLM(grid, virtual_chunks=args.virtual_chunks, **kw)
        else:
            model = PipelinedLM(grid, schedule=args.pipeline_schedule, **kw)
        common.log(
            f'pipeline: {args.pipeline_stages} ranks x data {grid.dp} x model {grid.model}, '
            f'{args.pipeline_microbatches} microbatches, schedule={args.pipeline_schedule} '
            f'({model.n_stages} logical stages); {len(model.stage_registry.layers)} K-FAC layers a rank'
        )
        lr = common.make_lr_schedule(args.lr, steps_per_epoch(args, tokens), args.epochs,
                                     args.warmup_epochs, args.lr_decay)
        cfg = common.build_kfac(args, model.stage_registry, lr=lr, device=device, verbose_dump=False)
        engine = PipelineKFAC(cfg, model) if cfg is not None else None
        if engine is not None and args.kfac_verbose:
            common.log(engine.describe())
        named = dict(model.named_parameters())
        sharded = set(tensor_parallel.sharded_param_names(model))
        stage = [n for n in named if n.startswith('stage.')]
        groups = [
            ([named[n] for n in stage if n not in sharded], [grid.pipe_group]),
            ([named[n] for n in stage if n in sharded], [grid.model_group, grid.pipe_group]),
            ([named[n] for n in sharded if n not in stage], [grid.model_group]),
        ]
        optimizer = common.ChainSGD(model.parameters(), lr, momentum=args.momentum, clip_norm=1.0,
                                    norm_groups=[g for g in groups if g[0]])
        box = {'state': engine.init() if engine is not None else None}
        start_epoch = 0
        if args.resume and args.checkpoint_dir and engine is not None:
            restored = common.restore_checkpoint(args.checkpoint_dir, engine, ('model', 'optimizer'))
            if restored is not None:
                box['state'], extra, start_epoch = restored
                model.load_state_dict(extra['model'])
                optimizer.load_state_dict(extra['optimizer'])

        def step_fn(batch):
            # statistics only on the factor cadence (the JAX script takes
            # them every step and its engine reads them on the cadence)
            capture = engine is not None and box['state'].step % resolve(
                cfg.factor_update_steps, box['state'].step) == 0
            loss, grads, stats = model.loss_and_stats(batch, capture=capture)
            if engine is not None:
                box['state'], grads = engine.step(box['state'], grads, stats)
            for n, p in named.items():
                p.grad = grads[n]
            optimizer.step()
            return loss

        def on_epoch_end(epoch):
            if args.checkpoint_dir and engine is not None:
                common.save_checkpoint(
                    args.checkpoint_dir, box['state'],
                    {'model': model.state_dict(), 'optimizer': optimizer.state_dict()}, epoch,
                    kfac_engine=engine,
                )

        out = run_epochs(args, tokens, step_fn, device, start_epoch, on_epoch_end)
        out['model'] = model
        out['state'] = box['state']
        return out
    finally:
        if made:
            dist.destroy_process_group()


def main(argv=None) -> float:
    """Train from flags; returns the final perplexity."""
    return run(parse_args(argv))['ppl']


if __name__ == '__main__':
    main()
