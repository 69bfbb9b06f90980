"""The port's ResNets, their Trainer loop and the conv accuracy tasks
against the JAX package's.

Weights come from flax's ``init`` (then moved off flax's initial values
by numpy noise, so BatchNorm's zero-initialised scales do not hide a
branch) and are carried over with ``convert.from_flax_params``; the
running statistics with ``convert.from_flax_batch_stats``; inputs from a
numpy seed, NHWC on the JAX side and NCHW on the port's. Tolerances:

- forward logits, grads and new ``batch_stats`` against flax: rtol 1e-5
  with atol 1e-6 x max for ``CifarResNet(depth=8)`` (grads rtol 1e-4 with
  atol 1e-5 x the largest grad: BatchNorm's backward sums in another
  order). The ImageNet family's flax reference is itself less exact: its
  f32 grads sit up to 3.4e-4 of the largest from the port's f64 ones, the
  port's f32 grads 2.5e-6 (its logits 6.3e-6 of max, the port's 7.5e-7),
  as XLA's CPU reductions add 8,192 stem positions one after another; so
  there the port is held against flax at atol 1e-5 x max (logits, stats)
  and 1e-3 x the largest grad, and against its own f64 run at rtol 1e-4
  with atol 1e-5 x max (both models);
- three ``Trainer`` steps: losses rtol 1e-5; factors rtol 1e-5 with atol
  1e-6 x max; eigenvalues and the damped inverse each decomposition gives
  (``Q diag(1 / (d + damping)) Q^T``, which does not depend on the basis
  chosen inside a repeated eigenvalue) rtol 1e-4 with atol 1e-5 x max;
  parameter updates rtol 1e-4 with atol 1e-4 x the largest update;
- the ``digits_cnn`` loop: losses rtol 1e-5 over its first 30 steps;
- the synthetic datasets: bitwise.
"""

import fcntl
import os
import pathlib
import pickle
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kfac_tpu
from examples import data as jax_data
from kfac_tpu import training as jtraining
from kfac_tpu.models import resnet as jresnet
from kfac_tpu_torch import bench_accuracy, bench_resnet, convert, data
from kfac_tpu_torch.layers import registry
from kfac_tpu_torch.models import layers as layers_lib
from kfac_tpu_torch.models import resnet
from kfac_tpu_torch.preconditioner import KFACPreconditioner
from kfac_tpu_torch.training import Trainer

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / 'tools'))
import bench_accuracy as jax_bench  # noqa: E402

TRAINER_KFAC = dict(damping=0.01, lr=0.1, factor_update_steps=1, inv_update_steps=2)
TRAINER_STEPS = 3


def close(got, want, rtol=1e-5, atol_rel=1e-6, msg=''):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * float(np.max(np.abs(want))), err_msg=msg
    )


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def perturbed(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32), tree
    )


def jax_batch_stats(tree, seed):
    """Running statistics away from flax's zeros and ones (variances > 0)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.2 * np.abs(rng.standard_normal(a.shape)).astype(np.float32), tree
    )


def flat_stats(ms):
    return {f'{k}/{f}': v for k, d in ms.items() for f, v in d.items()}


# (flax model, port model, image size, atol x max against flax: logits
# and stats, grads). The ImageNet family runs at 64 px: at 32 px its last
# BatchNorm sees one position of each of the 2 images, where the fast
# variance E[x^2] - E[x]^2 cancels, and both packages' f32 logits sit
# ~1e-3 of max from the port's f64 ones.
MODELS = {
    'cifar8': (
        lambda: jresnet.CifarResNet(depth=8), lambda: resnet.CifarResNet(depth=8, device='cpu'),
        32, (1e-6, 1e-5),
    ),
    'imagenet1111': (
        lambda: jresnet.ImageNetResNet(stage_sizes=(1, 1, 1, 1), num_classes=10),
        lambda: resnet.ImageNetResNet(stage_sizes=(1, 1, 1, 1), num_classes=10, device='cpu'),
        64, (1e-5, 1e-3),
    ),
}


@pytest.fixture(scope='module', params=sorted(MODELS))
def model_pair(request):
    """The flax model's forward, grads and new statistics at batch 2
    (train and eval), and the port's of the same weights and inputs."""
    jmake, tmake, size, atols = MODELS[request.param]
    jm = jmake()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    w = rng.standard_normal((2, 10)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), train=True)
    params = perturbed(jax.device_get(variables['params']), 2)
    stats = jax_batch_stats(jax.device_get(variables['batch_stats']), 3)

    def jloss(p):
        out, upd = jm.apply({'params': p, 'batch_stats': stats}, jnp.asarray(x), train=True,
                            mutable=['batch_stats'])
        return jnp.sum(out * w), (out, upd['batch_stats'])

    (_, (out, new_stats)), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    evals = jm.apply({'params': params, 'batch_stats': stats}, jnp.asarray(x), train=False)
    port = {}
    for dtype in (torch.float32, torch.float64):
        tm = tmake()
        tm.load_state_dict(convert.from_flax_params(params))
        tm.to(dtype)
        ms = {k: {f: v.to(dtype) for f, v in d.items()} for k, d in convert.from_flax_batch_stats(stats).items()}
        tout, tnew = tm(nchw(x).to(dtype), ms, train=True)
        (tout * torch.from_numpy(w).to(dtype)).sum().backward()
        with torch.no_grad():
            teval, same = tm(nchw(x).to(dtype), ms, train=False)
        port[dtype] = dict(
            out=tout.detach().double(), eval=teval.double(), stats=flat_stats(tnew),
            grads={n: p.grad.double() for n, p in tm.named_parameters()}, eval_state_unchanged=same is ms,
        )
    return dict(
        jax=dict(out=np.asarray(out), eval=np.asarray(evals),
                 grads=convert.from_flax_params(jax.device_get(grads)),
                 stats=flat_stats(convert.from_flax_batch_stats(jax.device_get(new_stats)))),
        torch=port[torch.float32], f64=port[torch.float64], atols=atols,
    )


def test_forward_matches_flax(model_pair):
    atol = model_pair['atols'][0]
    close(model_pair['torch']['out'], model_pair['jax']['out'], atol_rel=atol)
    close(model_pair['torch']['eval'], model_pair['jax']['eval'], atol_rel=atol)
    assert model_pair['torch']['eval_state_unchanged']


def close_grads(got, want, atol_rel):
    assert set(got) == set(want)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=1e-4, atol=atol_rel * scale, err_msg=name)


def test_grads_match_flax(model_pair):
    close_grads(model_pair['torch']['grads'], model_pair['jax']['grads'], model_pair['atols'][1])


def test_new_batch_stats_match_flax(model_pair):
    want, got = model_pair['jax']['stats'], model_pair['torch']['stats']
    assert set(got) == set(want)
    for key, v in want.items():
        close(got[key], v, atol_rel=model_pair['atols'][0], msg=key)


def test_f32_matches_the_ports_f64_run(model_pair):
    f32, f64 = model_pair['torch'], model_pair['f64']
    close(f32['out'], f64['out'], rtol=1e-4, atol_rel=1e-5)
    close_grads(f32['grads'], f64['grads'], 1e-5)
    for key, v in f64['stats'].items():
        close(f32['stats'][key], v, rtol=1e-4, atol_rel=1e-5, msg=key)


def test_resnet_draws_flax_initializers():
    model = resnet.CifarResNet(depth=20, seed=3, device='cpu')
    w = model.stage2_block0.conv1.weight.detach()  # fan_in 32 * 3 * 3
    std = 1.0 / np.sqrt(32 * 9)
    assert abs(float(w.std()) - std) < 0.1 * std
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978
    assert float(model.bn0.weight.detach().min()) == 1.0
    assert float(model.head.bias.detach().abs().max()) == 0.0
    bottleneck = resnet.resnet50(device='cpu').stage0_block0
    assert float(bottleneck.bn3.weight.detach().abs().max()) == 0.0
    keys = list(layers_lib.initial_model_state(model, 'cpu'))
    assert keys[:3] == ['bn0', 'stage0_block0/bn1', 'stage0_block0/bn2']
    with pytest.raises(ValueError, match='initial_model_state'):
        model(torch.zeros(1, 3, 8, 8), None)


@pytest.fixture(scope='module')
def trainer_runs():
    """:func:`run_trainers` once per test run: under pytest-xdist the first
    worker to need it computes it under a file lock and leaves it in the
    temporary directory, keyed by the run's id, for the others (as
    ``tests/test_torch_kaisa.py``'s worlds)."""
    uid = os.environ.get('PYTEST_XDIST_TESTRUNUID')
    if uid is None:
        return run_trainers()
    path = os.path.join(tempfile.gettempdir(), f'kfac_torch_resnet_trainers_{uid}.pkl')
    with open(path + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            with open(path, 'rb') as f:
                return pickle.load(f)
        out = run_trainers()
        with open(path + '.tmp', 'wb') as f:
            pickle.dump(out, f)
        os.replace(path + '.tmp', path)
        return out


def run_trainers():
    """Three Trainer steps of ``CifarResNet(depth=8)`` at 8x8, batch 4,
    cadence 1/2 (captures at 0, 1, 2; refreshes at 0 and 2), on each
    package from the same weights and statistics."""
    rng = np.random.default_rng(4)
    batches = [
        (rng.standard_normal((4, 8, 8, 3)).astype(np.float32), rng.integers(0, 10, 4).astype(np.int32))
        for _ in range(TRAINER_STEPS)
    ]
    jm = jresnet.CifarResNet(depth=8)
    variables = jm.init(jax.random.PRNGKey(5), jnp.asarray(batches[0][0]), train=True)
    params = jax.device_get(variables['params'])
    stats = jax.device_get(variables['batch_stats'])

    def jloss(p, ms, b):
        xx, yy = b
        logits, upd = jm.apply({'params': p, 'batch_stats': ms}, xx, train=True, mutable=['batch_stats'])
        onehot = jax.nn.one_hot(yy, 10)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1)), upd['batch_stats']

    jreg = kfac_tpu.register_model(jm, jnp.asarray(batches[0][0]), train=False)
    jt = jtraining.Trainer(
        loss_fn=jloss, optimizer=optax.sgd(0.1, momentum=0.9),
        kfac=kfac_tpu.KFACPreconditioner(registry=jreg, **TRAINER_KFAC),
    )
    js, jl = jt.init(params, stats), []
    for x, y in batches:
        js, loss = jt.step(js, (jnp.asarray(x), jnp.asarray(y)))
        jl.append(float(loss))

    tm = resnet.CifarResNet(depth=8, device='cpu')
    tm.load_state_dict(convert.from_flax_params(params))
    treg = registry.register_model(tm, device='cpu')
    tt = Trainer(
        tm, torch.optim.SGD(tm.parameters(), lr=0.1, momentum=0.9), resnet.classification_loss(tm),
        kfac=KFACPreconditioner(treg, device='cpu', **TRAINER_KFAC), device='cpu',
    )
    ts, tl = tt.init(convert.from_flax_batch_stats(stats)), []
    for x, y in batches:
        ts, loss = tt.step(ts, (nchw(x), torch.from_numpy(y)))
        tl.append(float(loss))
    return dict(jax=(js, jl, params), torch=(ts, tl, tm), names=(jreg.names(), treg.names()))


def test_trainer_losses_and_statistics_match_jax(trainer_runs):
    (js, jl, _), (ts, tl, _) = trainer_runs['jax'], trainer_runs['torch']
    names, tnames = trainer_runs['names']
    assert tnames == names and len(names) == 8
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    want = flat_stats(convert.from_flax_batch_stats(jax.device_get(js.model_state)))
    got = flat_stats(ts.model_state)
    for key, v in want.items():
        close(got[key], v, msg=key)


def test_trainer_factors_match_jax(trainer_runs):
    js, ts = trainer_runs['jax'][0].kfac_state, trainer_runs['torch'][0].kfac_state
    assert ts.step == int(js.step) == TRAINER_STEPS
    for side in ('a', 'g'):
        for name, want in getattr(js, side).items():
            close(getattr(ts, side)[name], want, msg=f'{side} {name}')


def test_trainer_decompositions_match_jax(trainer_runs):
    js, ts = trainer_runs['jax'][0].kfac_state, trainer_runs['torch'][0].kfac_state
    damping = TRAINER_KFAC['damping']
    for qf, df in (('qa', 'da'), ('qg', 'dg')):
        for name in getattr(js, qf):
            jq, jd = np.asarray(getattr(js, qf)[name]), np.asarray(getattr(js, df)[name])
            tq, td = getattr(ts, qf)[name].numpy(), getattr(ts, df)[name].numpy()
            close(td, jd, rtol=1e-4, atol_rel=1e-5, msg=f'{df} {name}')
            close((tq / (td + damping)) @ tq.T, (jq / (jd + damping)) @ jq.T,
                  rtol=1e-4, atol_rel=1e-5, msg=f'{qf} {name}')


def test_trainer_parameters_match_jax(trainer_runs):
    (js, _, init), (_, _, tm) = trainer_runs['jax'], trainer_runs['torch']
    init_t = convert.from_flax_params(init)
    want = {n: w.numpy() - init_t[n].numpy() for n, w in convert.from_flax_params(jax.device_get(js.params)).items()}
    got = tm.state_dict()
    scale = max(float(np.max(np.abs(w))) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy() - init_t[name].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_synthetic_sets_equal_the_jax_loaders_bitwise():
    for got, want in zip(data.synthetic_classification(40, (4, 4, 3), 7, seed=3),
                         jax_data.synthetic_classification(40, (4, 4, 3), 7, seed=3)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for (x, y), (jx, jy) in zip(data.cifar10(n_train=64, n_test=16), jax_data.cifar10(None, n_train=64, n_test=16)):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


CNN_STEPS = 30


@pytest.mark.parametrize('use_kfac', [True, False], ids=['kfac', 'sgd'])
def test_digits_cnn_first_steps_match_the_jax_loop(use_kfac):
    """``_task_digits('cnn')`` (batch 100, lr 0.02, damping 0.01, cadence
    5/25: captures at 0, 5, ..., refreshes at 0 and 25) on both packages
    from the same weights and batches."""
    task = jax_bench._task_digits('cnn')
    params = task['model'].init(jax.random.PRNGKey(0), task['example'])['params']
    kfac = None
    if use_kfac:
        reg = kfac_tpu.register_model(task['model'], task['example'])
        kfac = kfac_tpu.KFACPreconditioner(registry=reg, lr=task['lr'], **task['kfac_kwargs'])
    jt = jtraining.Trainer(loss_fn=task['loss_fn'], optimizer=optax.sgd(task['lr'], momentum=0.9), kfac=kfac)
    xtr, ytr = task['data']
    bsz, n = task['batch'], len(xtr) // task['batch']
    js, want = jt.init(params), []
    for i in range(CNN_STEPS):
        j = (i % n) * bsz
        js, loss = jt.step(js, (xtr[j:j + bsz], ytr[j:j + bsz]))
        want.append(float(loss))

    ttask = bench_accuracy.task_digits_cnn('cpu')
    model = bench_accuracy.SmallCNN(device='cpu')
    model.load_state_dict(convert.from_flax_params(jax.device_get(params)))
    tt = bench_accuracy.build_trainer(ttask, use_kfac, model=model)
    ts, got = tt.init(), []
    for i in range(CNN_STEPS):
        ts, loss = tt.step(ts, bench_accuracy.batch_at(ttask, i))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_cifar_resnet20_task_trains_and_evaluates_with_running_statistics():
    task = bench_accuracy.task_cifar_resnet20('cpu')
    xtr, ytr = task['data']
    assert tuple(xtr.shape) == (12800, 3, 32, 32) and task['batch'] == 128
    (jx, jy), _ = jax_data.cifar10(None, n_train=12800, n_test=2000)
    np.testing.assert_array_equal(xtr[:8].numpy(), jx[:8].transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(ytr.numpy(), jy)
    trainer = bench_accuracy.build_trainer(task, use_kfac=True)
    assert len(trainer.kfac.registry) == 20
    state = trainer.init(task['model_state'](trainer.model))
    for i in range(2):
        state, loss = trainer.step(state, bench_accuracy.batch_at(task, i))
        assert np.isfinite(float(loss))
    assert float(state.model_state['bn0']['mean'].abs().sum()) > 0
    acc = task['evaluate'](trainer.model, state.model_state)
    assert 0.0 <= acc <= 1.0


def test_bench_resnet_counts_flops_and_reports_its_keys():
    cfg = bench_resnet.RESNET_CONFIGS['resnet32_cifar']
    model = resnet.resnet32(device='cpu')
    x, _ = bench_resnet.resnet_batch(cfg, torch.device('cpu'), batch=2)
    # ResNet-32 at 32 px: 69.0 M multiply-adds an image (convs and head)
    macs = 16 * 27 * 1024 + 5 * 2 * 16 * 144 * 1024 + 32 * 144 * 256 + (2 * 5 - 1) * 32 * 288 * 256 \
        + 64 * 288 * 64 + (2 * 5 - 1) * 64 * 576 * 64 + 64 * 10
    assert bench_resnet.conv_flops(model, x) == 3 * 2 * 2 * macs
    out = bench_resnet.run_resnet_stage('resnet32_cifar', 'cpu', warmup=1, iters=1, batch=4)
    assert out['n_kfac_layers'] == 32 and out['mfu'] is None
    assert out['kfac_images_per_sec'] > 0 and np.isfinite(out['last_loss']['kfac'])
