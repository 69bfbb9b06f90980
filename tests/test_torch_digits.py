"""The port's ``digits_mlp`` loop against the JAX package's.

- The digits loader equals ``examples.data.digits()`` bit for bit.
- The MLP's forward matches the flax ``MLP(features=(64,))`` under
  converted weights, within 1e-6 of the logits' max.
- The first 60 steps of the task's K-FAC and SGD runs
  (``tools/bench_accuracy.py``'s ``_task_digits('mlp')``: batch 100, lr 0.1,
  SGD with momentum 0.9, damping 0.003, cadence 5/25, so captures at 0, 5,
  ... and refreshes at 0, 25 and 50) give losses within 1e-5 relative of
  the JAX Trainer's, fed the same batches from the same weights.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kfac_tpu
from examples import data as jax_data
from kfac_tpu import training as jtraining
from kfac_tpu.models import MLP as FlaxMLP
from kfac_tpu_torch import bench_accuracy, convert, data
from kfac_tpu_torch.models import MLP

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, 'tools'))
import bench_accuracy as jax_bench  # noqa: E402

STEPS = 60


def flax_params(seed=0):
    (xtr, _), _ = jax_data.digits()
    return FlaxMLP(features=(64,), num_classes=10).init(
        jax.random.PRNGKey(seed), jnp.asarray(xtr[:8])
    )['params']


def test_digits_loader_equals_the_jax_loader_bitwise():
    for (x, y), (jx, jy) in zip(data.digits(), jax_data.digits()):
        assert x.dtype == jx.dtype and y.dtype == jy.dtype
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_mlp_forward_matches_flax():
    params = flax_params()
    _, (xte, _) = data.digits()
    want = np.asarray(FlaxMLP(features=(64,), num_classes=10).apply({'params': params}, xte))
    model = MLP(64, features=(64,), num_classes=10, device='cpu')
    model.load_state_dict(convert.from_flax_params(jax.device_get(params)))
    got = model(torch.from_numpy(xte)).detach().numpy()
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))


def test_mlp_draws_flax_initializers():
    model = MLP(64, features=(64,), num_classes=10, seed=3, device='cpu')
    w = model.dense0.weight.detach()
    std = 1.0 / np.sqrt(64)  # lecun_normal: variance 1/fan_in
    assert abs(float(w.std()) - std) < 0.1 * std
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978
    assert float(model.head.bias.detach().abs().max()) == 0.0
    assert [n for n, _ in model.named_parameters()] == [
        'dense0.weight', 'dense0.bias', 'head.weight', 'head.bias'
    ]


def jax_losses(use_kfac, params):
    task = jax_bench._task_digits('mlp')
    kfac = None
    if use_kfac:
        reg = kfac_tpu.register_model(task['model'], task['example'])
        kfac = kfac_tpu.KFACPreconditioner(registry=reg, lr=task['lr'], **task['kfac_kwargs'])
    trainer = jtraining.Trainer(
        loss_fn=task['loss_fn'], optimizer=optax.sgd(task['lr'], momentum=0.9), kfac=kfac,
    )
    xtr, ytr = task['data']
    bsz, n = task['batch'], len(xtr) // task['batch']
    state = trainer.init(params)
    losses = []
    for i in range(STEPS):
        j = (i % n) * bsz
        state, loss = trainer.step(state, (xtr[j:j + bsz], ytr[j:j + bsz]))
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize('use_kfac', [True, False], ids=['kfac', 'sgd'])
def test_first_steps_match_the_jax_loop(use_kfac):
    params = flax_params()
    want = jax_losses(use_kfac, params)
    task = bench_accuracy.task_digits_mlp('cpu')
    model = MLP(64, features=(64,), num_classes=10, device='cpu')
    model.load_state_dict(convert.from_flax_params(jax.device_get(params)))
    trainer = bench_accuracy.build_trainer(task, use_kfac, model=model)
    state = trainer.init()
    got = []
    for i in range(STEPS):
        state, loss = trainer.step(state, bench_accuracy.batch_at(task, i))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    if use_kfac:
        assert state.kfac_state.step == STEPS


def test_steps_to_target_and_summary_follow_the_jax_rules():
    curve = [(17, 0.1, 0.5), (34, 0.2, 0.9), (51, 0.3, 0.95)]
    for target in (0.9, 0.95, 0.99):
        assert bench_accuracy.steps_to_target(curve, target, True) == jax_bench._steps_to_target(
            curve, target, True
        )
    task = {'name': 'digits_mlp', 'higher_better': True, 'metric': 'test_acc'}
    nan_curve = [(17, 0.1, 0.5), (34, 0.2, float('nan'))]
    out = bench_accuracy.summarize(task, curve, nan_curve)
    assert out['diverged'] == ['kfac'] and out['target'] == 0.95
    assert out['kfac_steps_to_target'] is None and out['sgd_steps_to_target'] == 51
    out = bench_accuracy.summarize(task, curve, curve[:2] + [(51, 0.25, 0.97)])
    assert out['target'] == 0.95 and out['step_ratio'] == 1.0 and out['time_ratio'] == round(0.25 / 0.3, 3)
