"""Time to target quality, K-FAC against the same first-order baseline:
the ``digits_mlp``, ``digits_cnn`` and ``cifar_resnet20`` tasks of
``tools/bench_accuracy.py``, on the port.

Protocol (the JAX tool's): SGD with momentum, and the same optimizer with
its gradients preconditioned by K-FAC, from the same initial weights, with
the same learning rate and batches; the test metric every ``eval_every``
steps. The target is the worse of the two final values, so both runs
reach it and no hand-set threshold favours either; a run whose final value
is not finite cannot set it and never counts as reaching it. Reported:
steps and seconds to the target (the clock starts after a warm-up on a
scratch model and stops during evaluation), their K-FAC/SGD ratios, and
both curves.

The tasks (the JAX tool's, uncut):

- ``digits_mlp``: an MLP with one hidden layer of 64, batch 100, lr 0.1,
  600 steps, damping 0.003, cadence 5/25;
- ``digits_cnn``: ``SmallCNN`` (two SAME convs, 16 and 32 filters, the
  second of stride 2, and a dense head) on the 8x8 digits, batch 100,
  lr 0.02, 600 steps, damping 0.01, cadence 5/25;
- ``cifar_resnet20``: ResNet-20 with its BatchNorm statistics in the
  Trainer's ``model_state``, on 12,800 synthetic CIFAR-10 images (the JAX
  package's class-conditional set; real CIFAR is not in the repository),
  2,000 test images, batch 128, lr 0.02, 400 steps, an evaluation every
  20, damping 0.1, cadence 5/25.

Usage::

    python -m kfac_tpu_torch.bench_accuracy                  # digits_mlp, on the card
    python -m kfac_tpu_torch.bench_accuracy --task digits_cnn --device cpu

Prints one JSON line per curve and one with the result, whose keys are the
JAX tool's. ``char_lm`` is not ported yet.

``lora_finetune`` is the JAX tool's gate of that name, not a race: the
frozen-backbone LoRA fine-tune (:mod:`kfac_tpu_torch.examples.finetune_lora`,
300 steps) must reach a loss of 0.2. The JAX tool reads the last
mini-batch's loss, which the recipe's late K-FAC spikes (single batches at
0.5-2.3 between batches near 0.05) make a coin flip: the JAX example
itself ends at 0.227 at seed 2, and the loss over the whole training set
at the final weights is no steadier (0.204 at the port's seed 0 on the
CPU). This gate reads the median of the last ``LORA_WINDOW`` steps' batch
losses (``window_median_loss``), and reports the last batch's
(``final_loss``, ``final_batch_under_target``) and the training set's
(``train_loss``) beside it. One line with ``gate``, those, ``loss_target``
and ``passed``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from kfac_tpu_torch import data
from kfac_tpu_torch.device import resolve_device
from kfac_tpu_torch.layers.registry import register_model
from kfac_tpu_torch.models import MLP
from kfac_tpu_torch.models import layers as layers_lib
from kfac_tpu_torch.models import resnet
from kfac_tpu_torch.preconditioner import KFACPreconditioner
from kfac_tpu_torch.training import Trainer


def _log(msg: str) -> None:
    print(f'[acc] {msg}', file=sys.stderr, flush=True)


def nll_loss(model: torch.nn.Module):
    """``loss_fn(model_state, (x, y)) -> (mean cross-entropy, model_state)``
    as the JAX task writes it: log-softmax against one-hot labels."""

    def loss_fn(ms, batch):
        x, y = batch
        logits = model(x)
        onehot = F.one_hot(y.long(), logits.shape[-1]).to(logits.dtype)
        return -torch.mean(torch.sum(F.log_softmax(logits, dim=-1) * onehot, dim=-1)), ms

    return loss_fn


class SmallCNN(torch.nn.Module):
    """The JAX tool's ``SmallCNN`` on (N, 1, 8, 8): a 3x3 SAME conv of 16,
    ReLU, a 3x3 SAME stride-2 conv of 32, ReLU, a dense head over the
    (h, w, c)-ordered features (flax's NHWC flatten), flax's auto-names
    (``Conv_0``, ``Conv_1``, ``Dense_0``) and initializers from ``seed``."""

    def __init__(self, num_classes: int = 10, seed: int = 0, device: str | torch.device = 'cuda'):
        super().__init__()
        self.Conv_0 = layers_lib.SameConv2d(1, 16, 3)
        self.Conv_1 = layers_lib.SameConv2d(16, 32, 3, 2)
        self.Dense_0 = torch.nn.Linear(32 * 4 * 4, num_classes)
        resnet.reset_parameters(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.Conv_1(torch.relu(self.Conv_0(x))))
        return self.Dense_0(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


def _accuracy(logits: torch.Tensor, y: torch.Tensor) -> float:
    return float((torch.argmax(logits, -1) == y).float().mean())


def task_digits(arch: str = 'mlp', device: str | torch.device = 'cuda') -> dict[str, Any]:
    """``_task_digits(arch)``: the digits on ``device``, batch 100, 600
    steps, an evaluation every 17, cadence 5/25; ``'mlp'``: an MLP with
    one hidden layer of 64, lr 0.1, damping 0.003; ``'cnn'``:
    :class:`SmallCNN` on the 8x8 images, lr 0.02, damping 0.01."""
    device = resolve_device(device)
    (xtr, ytr), (xte, yte) = data.digits()
    if arch == 'cnn':
        xtr, xte = xtr.reshape(-1, 1, 8, 8), xte.reshape(-1, 1, 8, 8)
        model = lambda seed: SmallCNN(10, seed=seed, device=device)  # noqa: E731
        lr, damping = 0.02, 0.01
    else:
        model = lambda seed: MLP(64, features=(64,), num_classes=10, seed=seed, device=device)  # noqa: E731
        lr, damping = 0.1, 0.003
    xte_t = torch.from_numpy(xte).to(device)
    yte_t = torch.from_numpy(yte).to(device)

    @torch.no_grad()
    def evaluate(model, model_state) -> float:
        return _accuracy(model(xte_t), yte_t)

    return dict(
        name=f'digits_{arch}', device=device, model=model, model_state=lambda model: None,
        loss=nll_loss, evaluate=evaluate,
        data=(torch.from_numpy(xtr).to(device), torch.from_numpy(ytr).to(device)),
        batch=100, lr=lr, higher_better=True, metric='test_acc',
        max_steps=600, eval_every=17,
        kfac_kwargs=dict(damping=damping, factor_update_steps=5, inv_update_steps=25),
    )


def task_digits_mlp(device: str | torch.device = 'cuda') -> dict[str, Any]:
    return task_digits('mlp', device)


def task_digits_cnn(device: str | torch.device = 'cuda') -> dict[str, Any]:
    return task_digits('cnn', device)


def task_cifar_resnet20(device: str | torch.device = 'cuda') -> dict[str, Any]:
    """``_task_cifar_resnet20`` on its synthetic branch: ResNet-20 on
    12,800 synthetic CIFAR-10 training images and 2,000 test images
    (NCHW), batch 128, lr 0.02, 400 steps, an evaluation every 20 (with the
    running statistics), damping 0.1, cadence 5/25."""
    device = resolve_device(device)
    (xtr, ytr), (xte, yte) = data.cifar10(n_train=12800, n_test=2000)

    def nchw(x):
        return torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(device)

    xte_t, yte_t = nchw(xte), torch.from_numpy(yte).to(device)

    @torch.no_grad()
    def evaluate(model, model_state) -> float:
        logits, _ = model(xte_t, model_state, train=False)
        return _accuracy(logits, yte_t)

    return dict(
        name='cifar_resnet20', device=device,
        model=lambda seed: resnet.resnet20(num_classes=10, seed=seed, device=device),
        model_state=lambda model: layers_lib.initial_model_state(model, device),
        loss=resnet.classification_loss, evaluate=evaluate,
        data=(nchw(xtr), torch.from_numpy(ytr).to(device)),
        batch=128, lr=0.02, higher_better=True, metric='test_acc',
        max_steps=400, eval_every=20,
        kfac_kwargs=dict(damping=0.1, factor_update_steps=5, inv_update_steps=25),
    )


LORA_WINDOW = 50  # the lora_finetune gate's window: the last sixth of its 300 steps


def run_lora_gate(device: str | torch.device = 'cuda', seed: int = 0,
                  loss_target: float = 0.2) -> dict[str, Any]:
    """The frozen-backbone LoRA fine-tune must reach ``loss_target``, the
    median of its last ``LORA_WINDOW`` batch losses: the mask and LoRA-unit
    path trains end to end, not just registers."""
    from kfac_tpu_torch.examples import finetune_lora

    device = resolve_device(device)
    _log('lora_finetune: running kfac_tpu_torch.examples.finetune_lora')
    run = finetune_lora.run(finetune_lora.parse_args(
        ['--steps', '300', '--seed', str(seed), '--device', str(device)]))
    final, median = run['losses'][-1], float(np.median(run['losses'][-LORA_WINDOW:]))
    out = {
        'gate': 'lora_finetune',
        'window_median_loss': round(median, 4),
        'window': LORA_WINDOW,
        'final_loss': round(final, 4),
        'train_loss': round(run['train_loss'], 4),
        'loss_target': loss_target,
        'held_out_accuracy': round(run['accuracy'], 4),
        'final_batch_under_target': bool(np.isfinite(final) and final <= loss_target),
        'passed': bool(np.isfinite(median) and median <= loss_target),
    }
    print(json.dumps(out), flush=True)
    return out


def task_lora_finetune(device: str | torch.device = 'cuda') -> dict[str, Any]:
    """The ``lora_finetune`` gate (:func:`run_lora_gate`)."""
    return dict(name='lora_finetune', device=device, gate=run_lora_gate)


TASKS = {
    'digits_mlp': task_digits_mlp,
    'digits_cnn': task_digits_cnn,
    'cifar_resnet20': task_cifar_resnet20,
    'lora_finetune': task_lora_finetune,
}


def build_trainer(task: dict[str, Any], use_kfac: bool, seed: int = 0, model=None) -> Trainer:
    """The task's Trainer: SGD(lr, momentum 0.9), preconditioned by K-FAC
    with ``use_kfac``; ``model`` (else the task's model from ``seed``)."""
    device = task['device']
    if model is None:
        model = task['model'](seed)
    kfac = None
    if use_kfac:
        reg = register_model(model, device=device)
        kfac = KFACPreconditioner(reg, lr=task['lr'], device=device, **task['kfac_kwargs'])
    return Trainer(
        model, torch.optim.SGD(model.parameters(), lr=task['lr'], momentum=0.9),
        task['loss'](model), kfac=kfac, device=device,
    )


def batch_at(task: dict[str, Any], i: int):
    """Batch ``i``: the training set in order, wrapping around."""
    xtr, ytr = task['data']
    bsz = task['batch']
    j = (i % (len(xtr) // bsz)) * bsz
    return xtr[j:j + bsz], ytr[j:j + bsz]


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run_one(task: dict[str, Any], use_kfac: bool, seed: int = 0) -> list[tuple]:
    """Train ``max_steps`` steps; the curve ``[(step, seconds, metric),
    ...]`` at every evaluation. Two steps (a capture step and a plain one)
    and an evaluation first run on a scratch model, so kernel builds and
    library set-up stay off the clock, as XLA compiles do in the JAX tool."""
    scratch = build_trainer(task, use_kfac, seed)
    state = scratch.init(task['model_state'](scratch.model))
    for i in range(2):
        state, _ = scratch.step(state, batch_at(task, i))
    task['evaluate'](scratch.model, state.model_state)
    del scratch, state

    trainer = build_trainer(task, use_kfac, seed)
    state = trainer.init(task['model_state'](trainer.model))
    device = task['device']
    curve = []
    _sync(device)
    t0 = time.perf_counter()
    for i in range(task['max_steps']):
        state, _ = trainer.step(state, batch_at(task, i))
        if (i + 1) % task['eval_every'] == 0:
            _sync(device)
            wall = time.perf_counter() - t0
            te0 = time.perf_counter()
            m = task['evaluate'](trainer.model, state.model_state)
            t0 += time.perf_counter() - te0  # evaluation off the clock
            curve.append((i + 1, round(wall, 3), round(m, 4)))
    return curve


def steps_to_target(curve, target, higher_better):
    """(step, seconds) of the first evaluation at or past ``target``."""
    for step, wall, m in curve:
        if (m >= target) if higher_better else (m <= target):
            return step, wall
    return None, None


def run_task(
    device: str | torch.device = 'cuda', seed: int = 0, name: str = 'digits_mlp'
) -> dict[str, Any]:
    """Both runs of task ``name``, the self-calibrating target and the
    ratios; prints the curves and the result as JSON lines."""
    task = TASKS[name](device)
    if 'gate' in task:
        return task['gate'](device, seed)
    name = task['name']
    _log(f'{name}: SGD run')
    sgd_curve = run_one(task, use_kfac=False, seed=seed)
    print(json.dumps({'task': name, 'phase': 'sgd_curve', 'curve': sgd_curve}), flush=True)
    _log(f'{name}: K-FAC run')
    kfac_curve = run_one(task, use_kfac=True, seed=seed)
    print(json.dumps({'task': name, 'phase': 'kfac_curve', 'curve': kfac_curve}), flush=True)
    return summarize(task, sgd_curve, kfac_curve)


def summarize(task: dict[str, Any], sgd_curve, kfac_curve) -> dict[str, Any]:
    """The result of two curves: the target is the worse final of the
    finite ones; a diverged run (non-finite final) does not reach it."""
    hb = task['higher_better']
    final_sgd, final_kfac = sgd_curve[-1][2], kfac_curve[-1][2]
    diverged = [
        side for side, v in (('sgd', final_sgd), ('kfac', final_kfac))
        if not np.isfinite(v)
    ]
    finite = [v for v in (final_sgd, final_kfac) if np.isfinite(v)]
    if len(finite) == 2:
        target = min(finite) if hb else max(finite)
    elif finite:
        target = finite[0]
    else:
        target = float('nan')
    s_steps, s_wall = steps_to_target(sgd_curve, target, hb)
    k_steps, k_wall = steps_to_target(kfac_curve, target, hb)
    if 'sgd' in diverged:
        s_steps = s_wall = None
    if 'kfac' in diverged:
        k_steps = k_wall = None
    out = {
        'task': task['name'],
        'metric': task['metric'],
        'target': target,
        'final_sgd': final_sgd,
        'final_kfac': final_kfac,
        'sgd_steps_to_target': s_steps,
        'sgd_seconds_to_target': s_wall,
        'kfac_steps_to_target': k_steps,
        'kfac_seconds_to_target': k_wall,
        'step_ratio': round(k_steps / s_steps, 3) if s_steps and k_steps else None,
        'time_ratio': round(k_wall / s_wall, 3) if s_wall and k_wall else None,
        'diverged': diverged,
        'sgd_curve': sgd_curve,
        'kfac_curve': kfac_curve,
    }
    print(json.dumps({k: v for k, v in out.items() if not k.endswith('_curve')}), flush=True)
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--task', default='digits_mlp', choices=sorted(TASKS))
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    kind = torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'
    _log(f'device: {device} ({kind})')
    if device.type == 'cuda':
        torch.backends.cudnn.allow_tf32 = False  # f32 convolutions, as matmuls
    run_task(device, args.seed, args.task)
    return 0


if __name__ == '__main__':
    sys.exit(main())
