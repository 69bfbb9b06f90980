"""CIFAR-10 ResNet trainer with K-FAC (counterpart of
``examples/train_cifar_resnet.py``, the reference's
``torch_cifar10_resnet.py``).

ResNet-20, -32 or -56 with its BatchNorm statistics in the Trainer's
``model_state``; SGD with momentum and weight decay on the warmup-and-decay
schedule, applied to the preconditioned grads. Under a launcher
(``torchrun``) one rank drives each card and ``--kfac-strategy`` picks the
KAISA gradient-worker fraction of ``DistributedKFAC`` (COMM-OPT,
HYBRID-OPT, MEM-OPT); each rank loads only its rows of each batch. On a
real ``cifar10.npz`` in ``--data-dir`` the training images are augmented
(crop and flip) and then normalized, in the reference's order; without one
the data is the shape-faithful synthetic set. ``--native-loader`` takes the
batches from the C++ prefetch loader (``kfac_tpu_torch/csrc/loader.cpp``,
built with g++ at first use; a failed build raises). ``--resume`` restarts
at the epoch after the latest checkpoint of ``--checkpoint-dir``.

Usage::

    python -m kfac_tpu_torch.examples.train_cifar_resnet --model resnet32 --epochs 2
    python -m kfac_tpu_torch.examples.train_cifar_resnet --device cpu --batch-size 16 --limit-steps 2
    torchrun --nproc-per-node 4 -m kfac_tpu_torch.examples.train_cifar_resnet --kfac-strategy hybrid-opt
"""

from __future__ import annotations

import argparse
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from kfac_tpu_torch import data
from kfac_tpu_torch.device import resolve_device
from kfac_tpu_torch.examples import common
from kfac_tpu_torch.layers.registry import register_model
from kfac_tpu_torch.models import layers as layers_lib
from kfac_tpu_torch.models import resnet
from kfac_tpu_torch.training import Trainer, TrainState


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='CIFAR-10 ResNet + K-FAC')
    p.add_argument('--model', choices=('resnet20', 'resnet32', 'resnet56'), default='resnet20')
    p.add_argument('--native-loader', action='store_true',
                   help='use the C++ prefetching batch loader (kfac_tpu_torch/csrc/loader.cpp)')
    common.add_train_args(p)
    common.add_kfac_args(p)
    common.add_metrics_args(p)
    return p.parse_args(argv)


def nchw(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy NHWC batch as an NCHW tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(device)


def run_resnet(
    args, device: torch.device, model_fn: Callable[[], torch.nn.Module], splits, real_data: bool,
    norm: tuple[np.ndarray, np.ndarray], loss: Callable, num_classes: int,
    init_params: Callable[[Any], tuple[dict, dict]] | None = None, normalize_eval: bool = False,
) -> dict:
    """The ResNet trainers' loop (both scripts): the model from
    ``model_fn()`` (or ``init_params(grid)``'s ``(state_dict,
    model_state)``), the engine from the flags over the KAISA grid of the
    launcher's world (dense in one process), SGD with weight decay, this
    rank's rows of each batch, then the test accuracy (batches of the test
    split, capped with ``--limit-steps``) a epoch. Returns ``{'acc',
    'losses', 'epoch_losses', 'img_per_s'}``."""
    from kfac_tpu_torch.parallel import kaisa_mesh

    if args.bf16:
        raise NotImplementedError('--bf16 ResNets are not ported to kfac_tpu_torch yet')
    (x_train, y_train), (x_test, y_test) = splits
    grid = None
    if dist.is_initialized():
        grid = kaisa_mesh(common.strategy_fraction(args.kfac_strategy, dist.get_world_size()),
                          device=device)
    augment = real_data if args.augment is None else args.augment
    model = model_fn()
    model_state = layers_lib.initial_model_state(model, device)
    if init_params is not None:
        params, model_state = init_params(grid)
        model.load_state_dict(params)
    registry = register_model(model, skip_layers=args.kfac_skip_layers, device=device)
    common.log(f'registered {len(registry.layers)} K-FAC layers on {common.world_size()} ranks '
               f'({args.kfac_strategy})')
    steps = len(x_train) // args.batch_size
    if args.limit_steps:
        steps = min(steps, args.limit_steps)
    lr = common.make_lr_schedule(args.lr, steps, args.epochs, args.warmup_epochs, args.lr_decay)
    kfac = common.build_kfac(args, registry, grid, lr=lr, device=device)
    optimizer = common.ChainSGD(model.parameters(), lr, momentum=args.momentum,
                                weight_decay=args.weight_decay)

    def loss_fn(ms, batch):
        xb, yb = batch
        logits, new_ms = model(xb, ms, train=True)
        return loss(logits, yb, num_classes), new_ms

    trainer = Trainer(model, optimizer, loss_fn, kfac=kfac, device=device,
                      local_batches=grid is not None and kfac is not None)
    state = trainer.init(model_state)
    start_epoch = 0
    if args.resume and args.checkpoint_dir:
        restored = common.restore_checkpoint(args.checkpoint_dir, kfac,
                                             ('model', 'optimizer', 'model_state'))
        if restored is not None:
            kstate, extra, start_epoch = restored
            model.load_state_dict(extra['model'])
            optimizer.load_state_dict(extra['optimizer'])
            state = TrainState(kstate, {k: {n: t.to(device) for n, t in v.items()}
                                        for k, v in extra['model_state'].items()})
            trainer.resume(state)
    rank, world = (grid.dp_rank, grid.world_size) if trainer.local_batches else (0, 1)
    epoch_batches = common.make_epoch_batches(
        args, x_train, y_train, augment, start_epoch=start_epoch,
        normalize_stats=norm if real_data else None, rank=rank, world=world,
    )
    writer = common.MetricsWriter(args.metrics_csv)
    acc_val, losses, epoch_losses, img_per_s = 0.0, [], [], 0.0
    try:
        for epoch in range(start_epoch, args.epochs):
            timer = common.Timer()
            train_loss = common.Metric()
            n_steps = 0
            for step, (xb, yb) in enumerate(epoch_batches(epoch)):
                if args.limit_steps and step >= args.limit_steps:
                    break
                batch = (nchw(xb, device), torch.from_numpy(yb).long().to(device))
                state, value = trainer.step(state, batch)
                value = float(value)
                losses.append(value)
                train_loss.update(value, len(xb))
                n_steps += 1
            img_per_s = n_steps * args.batch_size / max(timer.elapsed(), 1e-9)
            acc = common.Metric()
            with torch.no_grad():
                for eval_step, (xb, yb) in enumerate(data.batches(x_test, y_test, args.batch_size, 0)):
                    if args.limit_steps and eval_step >= args.limit_steps:
                        break
                    if normalize_eval and real_data:
                        xb = data.normalize(xb, *norm)
                    logits, _ = model(nchw(xb, device), state.model_state, train=False)
                    acc.update(common.accuracy(logits, torch.from_numpy(yb).to(device)), len(xb))
            acc_val = acc.avg
            epoch_losses.append(train_loss.avg)
            common.log(f'epoch {epoch}: train_loss={train_loss.avg:.4f} test_acc={acc_val:.4f} '
                       f'{img_per_s:.1f} img/s')
            writer.write_many(epoch, {'train_loss': train_loss.avg, 'test_acc': acc_val,
                                      'img_per_s': img_per_s})
            common.log_inverse_residuals(args, kfac, state.kfac_state)
            if args.checkpoint_dir:
                common.save_checkpoint(
                    args.checkpoint_dir, state.kfac_state,
                    {'model': model.state_dict(), 'optimizer': optimizer.state_dict(),
                     'model_state': state.model_state}, epoch, kfac_engine=kfac,
                )
    finally:
        writer.close()
        if epoch_batches.loader is not None:
            epoch_batches.loader.close()
    return {'acc': acc_val, 'losses': losses, 'epoch_losses': epoch_losses, 'img_per_s': img_per_s,
            'trainer': trainer, 'state': state}


def run(args: argparse.Namespace, init_params=None) -> dict:
    """Train as the flags say; ``init_params(grid) -> (state_dict,
    model_state)`` replaces the weights drawn from ``--seed``."""
    device = resolve_device(args.device)
    if device.type == 'cuda':
        torch.backends.cudnn.allow_tf32 = False  # f32 convolutions, as the matmuls
    made = common.distributed_init(device)
    try:
        real_data = data.cifar_on_disk(args.data_dir)
        (x_train, y_train), (x_test, y_test) = data.cifar10(args.data_dir)
        if real_data:  # the training split normalizes a batch at a time, after augmenting
            x_test = data.normalize(x_test, data.CIFAR10_MEAN, data.CIFAR10_STD)
        return run_resnet(
            args, device,
            lambda: getattr(resnet, args.model)(num_classes=10, seed=args.seed, device=device),
            ((x_train, y_train), (x_test, y_test)), real_data,
            (data.CIFAR10_MEAN, data.CIFAR10_STD), common.cross_entropy_loss, 10, init_params,
        )
    finally:
        if made:
            dist.destroy_process_group()


def main(argv=None) -> float:
    """Train from flags; returns the final test accuracy."""
    return run(parse_args(argv))['acc']


if __name__ == '__main__':
    main()
