"""ImageNet-class ResNet trainer with K-FAC (counterpart of
``examples/train_imagenet_resnet.py``, the reference's
``torch_imagenet_resnet.py``).

ResNet-50 (or a CIFAR-style depth for small images), label-smoothing loss,
the reference's K-FAC cadence defaults (factors every 10 steps, inverses
every 100). Data from ``--data-dir`` (``imagenet_{x,y}_{train,test}.npy``,
x memory-mapped, or ``imagenet.npz``) with per-batch normalization, else
ImageNet-shaped synthetic images. The loop, the engines, the per-rank
loader, ``--native-loader`` and ``--resume`` are the CIFAR trainer's
(:func:`kfac_tpu_torch.examples.train_cifar_resnet.run_resnet`); each
epoch prints the images a second of its training steps.

Usage::

    python -m kfac_tpu_torch.examples.train_imagenet_resnet --batch-size 32 --limit-steps 20
    python -m kfac_tpu_torch.examples.train_imagenet_resnet --device cpu --arch resnet20 \\
        --image-size 32 --batch-size 8 --limit-steps 1
"""

from __future__ import annotations

import argparse
import functools

import torch
import torch.distributed as dist

from kfac_tpu_torch import data
from kfac_tpu_torch.device import resolve_device
from kfac_tpu_torch.examples import common
from kfac_tpu_torch.examples.train_cifar_resnet import run_resnet
from kfac_tpu_torch.models import resnet


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='ImageNet ResNet-50 + K-FAC')
    p.add_argument('--image-size', type=int, default=224)
    p.add_argument('--arch', default='resnet50', choices=['resnet50', 'resnet20', 'resnet32', 'resnet56'],
                   help='resnet50 is the reference configuration; the CIFAR-style depths are for '
                        'smoke tests and small-image runs')
    p.add_argument('--label-smoothing', type=float, default=0.1)
    p.add_argument('--native-loader', action='store_true',
                   help='C++ prefetch loader; reads memory-mapped imagenet_x_train.npy directly from '
                        'disk with in-worker crop/flip augmentation')
    common.add_train_args(p)
    common.add_kfac_args(p)
    common.add_metrics_args(p)
    return p.parse_args(argv)


def run(args: argparse.Namespace, init_params=None) -> dict:
    """Train as the flags say; ``init_params(grid) -> (state_dict,
    model_state)`` replaces the weights drawn from ``--seed``."""
    device = resolve_device(args.device)
    if device.type == 'cuda':
        torch.backends.cudnn.allow_tf32 = False  # f32 convolutions, as the matmuls
    made = common.distributed_init(device)
    try:
        real_data = data.imagenet_on_disk(args.data_dir)
        splits = data.imagenet_like(
            args.data_dir, image_size=args.image_size,
            n_train=max(args.batch_size * 8, 1024), n_test=args.batch_size * 2,
        )
        # x may be a read-only memmap: normalization happens a batch at a time
        return run_resnet(
            args, device,
            lambda: getattr(resnet, args.arch)(num_classes=1000, seed=args.seed, device=device),
            splits, real_data, (data.IMAGENET_MEAN, data.IMAGENET_STD),
            functools.partial(common.label_smoothing_loss, smoothing=args.label_smoothing), 1000,
            init_params, normalize_eval=True,
        )
    finally:
        if made:
            dist.destroy_process_group()


def main(argv=None) -> float:
    """Train from flags; returns the final test accuracy."""
    return run(parse_args(argv))['acc']


if __name__ == '__main__':
    main()
