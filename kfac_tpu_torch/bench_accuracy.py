"""Time to target quality, K-FAC against the same first-order baseline:
the ``digits_mlp`` task of ``tools/bench_accuracy.py``, on the port.

Protocol (the JAX tool's): SGD with momentum, and the same optimizer with
its gradients preconditioned by K-FAC, from the same initial weights, with
the same learning rate and batches; the test accuracy every
``eval_every`` steps. The target is the worse of the two final accuracies,
so both runs reach it and no hand-set threshold favours either; a run
whose final value is not finite cannot set it and never counts as reaching
it. Reported: steps and seconds to the target (the clock starts after a
warm-up on a scratch model and stops during evaluation), their K-FAC/SGD
ratios, and both curves.

Usage::

    python -m kfac_tpu_torch.bench_accuracy            # on the card
    python -m kfac_tpu_torch.bench_accuracy --device cpu

Prints one JSON line per curve and one with the result, whose keys are the
JAX tool's. ``digits_cnn``, ``char_lm`` and ``cifar_resnet20`` wait for the
port's convolution helper and models.
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


def task_digits_mlp(device: str | torch.device = 'cuda') -> dict[str, Any]:
    """``_task_digits('mlp')``: the digits on ``device``, an MLP with one
    hidden layer of 64, batch 100, lr 0.1, 600 steps, an evaluation every
    17, K-FAC damping 0.003 and cadence 5/25."""
    device = resolve_device(device)
    (xtr, ytr), (xte, yte) = data.digits()
    xte_t = torch.from_numpy(xte).to(device)
    yte_t = torch.from_numpy(yte).to(device)

    @torch.no_grad()
    def evaluate(model) -> float:
        return float((torch.argmax(model(xte_t), -1) == yte_t).float().mean())

    return dict(
        name='digits_mlp', device=device,
        model=lambda seed: MLP(64, features=(64,), num_classes=10, seed=seed, device=device),
        loss=nll_loss, evaluate=evaluate,
        data=(torch.from_numpy(xtr).to(device), torch.from_numpy(ytr).to(device)),
        batch=100, lr=0.1, higher_better=True, metric='test_acc',
        max_steps=600, eval_every=17,
        kfac_kwargs=dict(damping=0.003, factor_update_steps=5, inv_update_steps=25),
    )


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
    state = scratch.init()
    for i in range(2):
        state, _ = scratch.step(state, batch_at(task, i))
    task['evaluate'](scratch.model)
    del scratch, state

    trainer = build_trainer(task, use_kfac, seed)
    state = trainer.init()
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
            m = task['evaluate'](trainer.model)
            t0 += time.perf_counter() - te0  # evaluation off the clock
            curve.append((i + 1, round(wall, 3), round(m, 4)))
    return curve


def steps_to_target(curve, target, higher_better):
    """(step, seconds) of the first evaluation at or past ``target``."""
    for step, wall, m in curve:
        if (m >= target) if higher_better else (m <= target):
            return step, wall
    return None, None


def run_task(device: str | torch.device = 'cuda', seed: int = 0) -> dict[str, Any]:
    """Both runs of the ``digits_mlp`` task, the self-calibrating target and
    the ratios; prints the curves and the result as JSON lines."""
    task = task_digits_mlp(device)
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
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    kind = torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'
    _log(f'device: {device} ({kind})')
    run_task(device, args.seed)
    return 0


if __name__ == '__main__':
    sys.exit(main())
