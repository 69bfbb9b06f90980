"""The bench's ResNet stage on the port (counterpart of ``run_resnet_stage``
in ``bench.py``, which this module does not import).

Run::

    python -m kfac_tpu_torch.bench_resnet --config {resnet32_cifar,resnet50_imagenet} [--device cuda]

Configurations (the bench's): ``resnet32_cifar`` (ResNet-32, batch 256,
32x32x3, 10 classes) and ``resnet50_imagenet`` (ResNet-50, batch 32,
224x224x3, 1000 classes), on one seeded batch (images from seed 0, labels
from seed 1, weights from seed 2), with the BatchNorm statistics in the
Trainer's ``model_state``. It times SGD(0.1, momentum 0.9) through
``Trainer(kfac=None).step`` and the same optimizer under a
``KFACPreconditioner`` (EIGEN, damping 0.003, lr 0.1, factors every 10
steps, inverses every 100) through ``Trainer.step``: 5 warm-up steps, then
100 timed steps (5..104), so the window holds 10 captures and the refresh
at step 100. It reports images/s of each, ``vs_baseline`` (SGD step time
over K-FAC's) and the peak device memory of each run.

MFU is against the H100 SXM's f32 peak outside the tensor cores (67
TFLOP/s), from an analytic count: ``2 N Ho Wo C_out C_in kh kw`` for each
convolution plus ``2 N d_in d_out`` for the head, times 3 for the forward
and the backward (BatchNorm, ReLU, the pools and K-FAC's own work do not
count). The JAX bench takes XLA's cost model instead.

The port runs in f32, with cuDNN's TF32 off (``torch.backends.cudnn.
allow_tf32 = False``, set here): the JAX bench picks bf16 on a TPU, but the
port's kernel wrappers take f32 only.

Prints the card's name and power limit (``nvidia-smi``) on CUDA, then one
JSON line. On the CPU the kernels' plain versions run; its times are the
CPU's and no MFU is given.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any

import torch
import torch.nn as nn

from kfac_tpu_torch.bench_lm import PEAK_FLOPS, nvidia_smi
from kfac_tpu_torch.device import resolve_device
from kfac_tpu_torch.layers.registry import register_model
from kfac_tpu_torch.models import layers as layers_lib
from kfac_tpu_torch.models import resnet
from kfac_tpu_torch.preconditioner import KFACPreconditioner
from kfac_tpu_torch.training import Trainer

RESNET_CONFIGS = {
    'resnet32_cifar': dict(arch='resnet32', batch=256, hw=32, classes=10),
    'resnet50_imagenet': dict(arch='resnet50', batch=32, hw=224, classes=1000),
}
KFAC_KW = dict(damping=0.003, lr=0.1, factor_update_steps=10, inv_update_steps=100)


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def resnet_batch(cfg: dict, device: torch.device, batch: int | None = None):
    """Images (N, 3, hw, hw) from seed 0 and labels from seed 1."""
    n = cfg['batch'] if batch is None else batch
    x = torch.randn(n, 3, cfg['hw'], cfg['hw'], generator=torch.Generator().manual_seed(0))
    y = torch.randint(0, cfg['classes'], (n,), generator=torch.Generator().manual_seed(1))
    return x.to(device), y.to(device)


def resnet_trainer(cfg: dict, device: torch.device, kfac: bool, seed: int = 2, **kfac_kw: Any) -> Trainer:
    """The configuration's ResNet, weights from ``seed``, under K-FAC (the
    bench's settings, ``kfac_kw`` over them) or plain SGD."""
    model = getattr(resnet, cfg['arch'])(num_classes=cfg['classes'], seed=seed, device=device)
    engine = None
    if kfac:
        reg = register_model(model, device=device)
        engine = KFACPreconditioner(reg, device=device, **{**KFAC_KW, **kfac_kw})
    return Trainer(
        model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        resnet.classification_loss(model), kfac=engine, device=device,
    )


def conv_flops(model: nn.Module, x: torch.Tensor) -> float:
    """The analytic FLOPs of one training step on ``x`` (module
    docstring): each convolution's and the head's multiply-adds, from the
    output shapes of one forward, times 2, times 3."""
    total = 0

    def hook(mod, inputs, out):
        nonlocal total
        if isinstance(mod, nn.Conv2d):
            total += 2 * out.numel() * mod.weight[0].numel()
        else:
            total += 2 * out.numel() * mod.in_features

    handles = [
        m.register_forward_hook(hook) for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))
    ]
    try:
        with torch.no_grad():
            model(x, layers_lib.initial_model_state(model, x.device), train=False)
    finally:
        for h in handles:
            h.remove()
    return 3.0 * total


def time_steps(trainer: Trainer, batch, warmup: int, iters: int) -> tuple[float, float, int]:
    """(seconds per step over steps ``warmup .. warmup + iters - 1``, the
    last loss, the peak device memory in bytes, 0 on the CPU)."""
    device = trainer.device
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    state = trainer.init(layers_lib.initial_model_state(trainer.model, device))
    for _ in range(warmup):
        state, loss = trainer.step(state, batch)
    _sync(device)
    start = time.perf_counter()
    for _ in range(iters):
        state, loss = trainer.step(state, batch)
    _sync(device)
    seconds = (time.perf_counter() - start) / iters
    peak = torch.cuda.max_memory_allocated(device) if device.type == 'cuda' else 0
    return seconds, float(loss), peak


def run_resnet_stage(
    config_name: str,
    device: str | torch.device = 'cuda',
    warmup: int = 5,
    iters: int = 100,
    batch: int | None = None,
) -> dict[str, Any]:
    """Measure SGD vs K-FAC ResNet throughput at one configuration
    (``batch`` overrides its batch: a cut for a quick run); returns the
    record."""
    device = resolve_device(device)
    cfg = RESNET_CONFIGS[config_name]
    on_cuda = device.type == 'cuda'
    if on_cuda:
        torch.backends.cudnn.allow_tf32 = False
    n = cfg['batch'] if batch is None else batch
    result: dict[str, Any] = {
        'stage': config_name,
        'platform': 'gpu' if on_cuda else 'cpu',
        'device_kind': torch.cuda.get_device_name(device) if on_cuda else 'cpu',
        'model_config': f'{cfg["arch"]}_b{n}_{cfg["hw"]}px',
        'window': dict(warmup=warmup, iters=iters),
        'dtype': 'float32',
        'cudnn_allow_tf32': torch.backends.cudnn.allow_tf32,
        'matmul_allow_tf32': torch.backends.cuda.matmul.allow_tf32,
    }
    data = resnet_batch(cfg, device, n)
    t_sgd, sgd_loss, sgd_peak = time_steps(resnet_trainer(cfg, device, kfac=False), data, warmup, iters)
    kfac_trainer = resnet_trainer(cfg, device, kfac=True)
    t_kfac, kfac_loss, kfac_peak = time_steps(kfac_trainer, data, warmup, iters)
    flops = conv_flops(kfac_trainer.model, data[0])
    result.update(
        n_kfac_layers=len(kfac_trainer.kfac.registry),
        sgd_images_per_sec=n / t_sgd,
        kfac_images_per_sec=n / t_kfac,
        value=n / t_kfac,
        vs_baseline=t_sgd / t_kfac,
        step_ms=dict(sgd=t_sgd * 1e3, kfac=t_kfac * 1e3),
        last_loss=dict(sgd=sgd_loss, kfac=kfac_loss),
        peak_memory_bytes=dict(sgd=sgd_peak, kfac=kfac_peak),
        flops_per_step=flops,
        mfu=flops / t_kfac / PEAK_FLOPS[torch.float32][0] if on_cuda else None,
        sgd_mfu=flops / t_sgd / PEAK_FLOPS[torch.float32][0] if on_cuda else None,
        mfu_peak=PEAK_FLOPS[torch.float32][1] if on_cuda else None,
        compute_method=kfac_trainer.kfac.compute_method.name,
    )
    return result


def main(argv: list[str] | None = None) -> dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--config', choices=sorted(RESNET_CONFIGS), default='resnet32_cifar')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--warmup', type=int, default=5)
    parser.add_argument('--iters', type=int, default=100)
    parser.add_argument('--batch', type=int, default=None, help='override the batch (a cut)')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == 'cuda':
        print(nvidia_smi(), flush=True)
    record = run_resnet_stage(args.config, device, args.warmup, args.iters, args.batch)
    print(json.dumps(record), flush=True)
    return record


if __name__ == '__main__':
    main()
