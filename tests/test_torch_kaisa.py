"""The port's KAISA engine against the JAX package's ``DistributedKFAC``.

Worlds of W = 1, 2 and 4 gloo ranks on the CPU (``spawn_world``; each
world runs once per test process, every case in it, and each assertion
below is its own test). The JAX engine runs on ``kaisa_mesh(frac,
devices=jax.devices()[:W])`` over the 8 virtual CPU devices of
``tests/conftest.py``, on the global batch; each rank of the port takes
its own row block of it (the rank bodies, ``tests/torch_kaisa_ranks.py``,
import no JAX). Weights and batches are drawn with numpy (or by flax's
``init``) and carried over with ``convert.from_flax_params``.

The cases are the port's of ``tests/parallel/test_kaisa_distributed.py``
at every fraction each world allows. Tolerances:

- preconditioned grads against the JAX engine's and the port's dense
  engine's: rtol 1e-4 with atol 1e-5 x the largest (f32 sums in another
  order through a refresh and kl-clip); the same on every rank, bitwise;
- factor stacks (the G scale under a sharded batch) against the JAX
  engine's: rtol 1e-5 with atol 1e-6 x max; inverses and eigenvalues:
  rtol 1e-4 with atol 1e-5 x max; inverse residuals: atol 1e-6, and
  below ``NS_FALLBACK_RESIDUAL``;
- the layout (resident slots per rank, buckets, stores, memory, comms):
  exact;
- engine-internal comparisons, the JAX test's: transports rtol 1e-6
  (atol 1e-7), solvers Newton-Schulz/Cholesky rtol 5e-3 (atol 5e-5),
  'auto'/Newton-Schulz and prediv rtol 1e-4 (atol 1e-6), size classes
  rtol 2e-4 (atol 1e-6);
- Trainer.step against the JAX Trainer: losses rtol 1e-5; parameter
  updates rtol 1e-4 with atol 1e-4 x the largest update.

The sentinel, metrics and flight recorder (the port's of
``tests/test_health.py``'s stacked cases, ``tests/test_observability.py``'s
and ``tests/test_flight_recorder.py``'s distributed ones) at every fraction,
EIGEN on ALLREDUCE and INVERSE on ALLREDUCE_BUCKETED: health counters
exact against the JAX engine and the port's dense engine; metric scalars
and flight rows rtol 1e-4 with atol 1e-6; the observability tensors
bitwise equal on every rank. Checkpoints (``tests/test_aux.py``'s and
``tests/test_resilience.py``'s distributed cases): layout manifests exact
against the JAX engine's; a restore's factors bitwise (its own layout) or
rtol 1e-6 (a migration); its preconditioned grads against the saved
engine's and against the JAX oracle (``checkpoint._factors_from_saved`` of
the port's stacks, ``insert_factors``, ``rematerialize``) with the
preconditioned-grads tolerance; a resumed run's losses and parameters
bitwise its interrupted run's continued in memory. The JAX package's
``_migrate_restore`` itself is not called: its raw read fails under the
installed orbax (ROADMAP queue 3).
"""

import concurrent.futures
import fcntl
import functools
import os
import pickle
import tempfile
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kfac_tpu
import torch_kaisa_ranks as ranks
from kfac_tpu import checkpoint as jcheckpoint
from kfac_tpu import health as jhealth
from kfac_tpu import tracing as jtracing
from kfac_tpu import training as jtraining
from kfac_tpu.models import MLP as JaxMLP
from kfac_tpu.models import TransformerLM as JaxLM
from kfac_tpu.models import lm_loss as jax_lm_loss
from kfac_tpu.observability import flight_recorder as jflight
from kfac_tpu.observability import metrics as jmetrics
from kfac_tpu.ops import factors as jfactors
from kfac_tpu.parallel import DistributedKFAC as JaxDistributedKFAC
from kfac_tpu.parallel import kaisa_mesh as jax_kaisa_mesh
from kfac_tpu.parallel import mesh as jmesh
from kfac_tpu.parallel.kaisa import size_class as jax_size_class
from kfac_tpu_torch import assignment, convert
from kfac_tpu_torch.models import resnet
from kfac_tpu_torch.ops import factors
from kfac_tpu_torch.parallel import spawn_world
from kfac_tpu_torch.parallel.kaisa import size_class

NS = dict(compute_method='inverse', inverse_solver='newton_schulz')
# the observed engine's variants at every fraction: both methods, both transports
OBSERVE_VARIANTS = (
    ('eigen', dict(compute_method='eigen', allreduce_method='allreduce')),
    ('inverse', dict(NS, allreduce_method='allreduce_bucketed')),
)
# the Trainer paths held against the JAX Trainer's, by world
TRAINER_PATHS = {1: ('step',), 2: ('step', 'scan_steps', 'step_accumulate'), 4: ('step',)}
EIGEN = dict(compute_method='eigen')
RESNET_STEPS = 3


def rng(seed):
    return np.random.default_rng(seed)


@functools.cache
def flax_models():
    """The flax twins of the rank bodies' models: {name: (module,
    registry, loss_fn(params, batch), params, global batch)}."""
    import flax.linen as nn

    class Wide(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.relu(nn.Dense(16, name='p')(x))
            x = nn.relu(nn.Dense(16, name='q')(x))
            return nn.Dense(4, name='r')(x)

    class Hetero(nn.Module):
        @nn.compact
        def __call__(self, x):
            for i, f in enumerate((19, 23, 21)):
                x = nn.relu(nn.Dense(f, name=f'l{i}')(x))
            return nn.Dense(5, name='l3')(x)

    out = {}
    for name, module, batch in (
        ('mlp', JaxMLP(features=(16, 12), num_classes=5),
         (rng(1).normal(size=(32, 6)), rng(2).normal(size=(32, 5)))),
        ('wide', Wide(), (rng(3).normal(size=(16, 16)), rng(4).normal(size=(16, 4)))),
        ('hetero', Hetero(), (rng(5).normal(size=(16, 13)), rng(6).normal(size=(16, 5)))),
    ):
        batch = tuple(b.astype(np.float32) for b in batch)
        params = module.init(jax.random.PRNGKey(0), jnp.asarray(batch[0]))['params']
        reg = kfac_tpu.register_model(module, jnp.asarray(batch[0]))

        def loss(p, b, module=module):
            return jnp.mean((module.apply({'params': p}, b[0]) - b[1]) ** 2)

        out[name] = (module, reg, loss, jax.device_get(params), batch)
    lm = JaxLM(**ranks.LM_CFG)
    tokens = rng(7).integers(0, ranks.LM_CFG['vocab_size'], (8, 16)).astype(np.int32)
    batch = (tokens, np.roll(tokens, -1, axis=1))
    params = lm.init(jax.random.PRNGKey(1), jnp.asarray(tokens))['params']
    reg = kfac_tpu.register_model(lm, jnp.asarray(tokens), skip_layers=['lm_head'])
    out['lm'] = (lm, reg, jax_lm_loss(lm), jax.device_get(params), batch)
    return out


def lm_batches(n):
    out = []
    for i in range(n):
        t = rng(20 + i).integers(0, ranks.LM_CFG['vocab_size'], (8, 16)).astype(np.int32)
        out.append((t, np.roll(t, -1, axis=1)))
    return out


def jax_cfg(reg, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return kfac_tpu.KFACPreconditioner(registry=reg, **kw)


def host(state):
    """A JAX DistKFACState's fields as numpy global stacks."""
    return {
        f: {k: np.asarray(v) for k, v in getattr(state, f).items()}
        for f in ('a', 'g', 'qa', 'qg', 'da', 'dg', 'dgda', 'a_inv', 'g_inv')
    } | {'step': int(state.step), 'inv_damping': float(state.inv_damping)}


def jax_poisoned(stats, layer=ranks.POISON):
    """``testing/faults.poison_stats(stats, layer, side='a', kind='nan')``."""
    a = dict(stats.a)
    a[layer] = a[layer] + jnp.float32(np.nan)
    return kfac_tpu.CapturedStats(a=a, g=dict(stats.g), w=dict(stats.w))


def torch_grads(jgrads):
    """A flax grads pytree in the port's ``named_parameters`` names."""
    return {k: v.numpy() for k, v in convert.from_flax_params(jax.device_get(jgrads)).items()}


def middle(fracs):
    return fracs[len(fracs) // 2]


def colocate_frac(world):
    """The smallest fraction that is not MEM-OPT (colocate_factors=False
    needs two gradient workers or one rank)."""
    fracs = assignment.candidate_fractions(world)
    return next(f for f in reversed(fracs) if world == 1 or world * f > 1)


def run_world(world):
    """The JAX references and the port world's results for ``world``."""
    models = flax_models()
    devices = jax.devices()[:world]
    fracs = assignment.candidate_fractions(world)
    ref = {'mesh': {}, 'step': {}}
    spec = {
        'weights': {
            n: {k: v.numpy() for k, v in convert.from_flax_params(m[3]).items()}
            for n, m in models.items()
        },
        'batches': {n: m[4] for n, m in models.items()},
        'train_batches': {'mlp': [models['mlp'][4]] * 12, 'lm': lm_batches(3)},
        'cases': [('multihost', 'multihost', {})],
    }

    def capture(name):
        _, reg, loss, params, batch = models[name]
        run = kfac_tpu.CurvatureCapture(reg).value_stats_and_grad(
            lambda p, b: (loss(p, b), None), has_aux=True
        )
        (value, _), grads, stats = run(params, tuple(jnp.asarray(b) for b in batch))
        ref.setdefault('loss', {})[name] = np.float32(value)
        return grads, stats

    mlp_grads, mlp_stats = capture('mlp')
    for frac in fracs:
        mesh = jax_kaisa_mesh(frac, devices=devices)
        ref['mesh'][frac] = (jmesh.grad_workers(mesh), jmesh.n_cols(mesh))
        for method, kw in (('eigen', EIGEN), ('inverse', NS)):
            dk = JaxDistributedKFAC(config=jax_cfg(models['mlp'][1], **kw, **ranks.STEP_KW), mesh=mesh)
            step = jax.jit(dk.step)
            s1, g1 = step(dk.init(), mlp_grads, mlp_stats)
            entry = {
                'grads': torch_grads(g1),
                'state': host(s1),
                'memory': dk.memory_usage(s1),
                'comms': dk.comms_report(),
                'buckets': [tuple(b) for b in dk.buckets],
                'stores': ([tuple(sb) for sb in dk.a_store], [tuple(sb) for sb in dk.g_store]),
                'resident': {
                    key: {
                        d.id: (idx[0].start or 0, idx[0].stop or arr.shape[0])
                        for d, idx in arr.sharding.devices_indices_map(arr.shape).items()
                    }
                    for key, arr in (s1.qa if method == 'eigen' else s1.a_inv).items()
                },
            }
            if method == 'inverse':
                entry['residuals'] = jax.tree_util.tree_map(np.asarray, dk.inverse_residuals(s1))
                if frac == fracs[-1]:
                    s2, g2 = step(s1, mlp_grads, mlp_stats)
                    ref['convert'] = {'grads': torch_grads(g2), 'state': host(s2)}
            ref['step'][method, frac] = entry
            spec['cases'].append(
                (f'{method}-{frac}', 'step', dict(frac=frac, **kw, **ranks.STEP_KW))
            )
    low, mid = fracs[-1], middle(fracs)
    spec['cases'].append((
        'convert', 'convert',
        dict(frac=low, jax_state=ref['step']['inverse', low]['state'], **NS, **ranks.STEP_KW),
    ))
    spec['cases'].append(('lm-step', 'step', dict(frac=low, model='lm', **EIGEN, **ranks.STEP_KW)))
    spec['cases'].append(('solvers', 'variants', dict(frac=mid, model='mlp', variants={
        'newton_schulz': dict(NS, damping=0.01, kl_clip=None),
        'cholesky': dict(compute_method='inverse', inverse_solver='cholesky', damping=0.01, kl_clip=None),
        'auto': dict(compute_method='inverse', inverse_solver='auto', damping=0.01, kl_clip=None),
        'eigen': dict(EIGEN, damping=0.01, kl_clip=None),
        'prediv': dict(EIGEN, damping=0.01, kl_clip=None, prediv_eigenvalues=True),
    })))
    # colocate_factors=False on the Wide model, against the JAX engine
    cfrac = colocate_frac(world)

    def colocate_refs():
        wgrads, wstats = capture('wide')
        ref['colocate'] = {}
        for method, kw in (('eigen', EIGEN), ('inverse', NS)):
            dk = JaxDistributedKFAC(
                config=jax_cfg(models['wide'][1], **kw, **ranks.STEP_KW, colocate_factors=False),
                mesh=jax_kaisa_mesh(cfrac, devices=devices),
            )
            _, g = jax.jit(dk.step)(dk.init(), wgrads, wstats)
            ref['colocate'][method] = torch_grads(g)

    spec['cases'].append(('colocate', 'variants', dict(frac=cfrac, model='wide', variants={
        m: dict(kw, colocate_factors=False, **ranks.STEP_KW) for m, kw in (('eigen', EIGEN), ('inverse', NS))
    })))
    if world > 1:
        spec['cases'].append(('memopt', 'variants', dict(frac=fracs[-1], model='mlp', variants={
            'not_colocated': dict(colocate_factors=False),
        })))
    spec['cases'].append(('classes', 'variants', dict(frac=1.0, model='hetero', variants={
        f'g{g}': dict(damping=0.01, kl_clip=0.001, bucket_granularity=g) for g in (128, 1)
    })))
    spec['cases'].append(('unexecuted', 'unexecuted', dict(frac=mid)))
    # the compressed stat transport at the smallest fraction (W = 4:
    # MEM-OPT), held against world 1's (tests/test_torch_compression.py)
    spec['cases'].append(('compressed', 'compressed', dict(frac=low, comps={'int8': 'int8'})))
    for name, kw in (
        ('allreduce', dict(allreduce_method='allreduce')),
        ('bucketed', dict(allreduce_method='allreduce_bucketed')),
        ('chunked', dict(allreduce_method='allreduce_bucketed', allreduce_bucket_cap_mb=1e-4)),
    ):
        spec['cases'].append((
            f'transport-{name}', 'train',
            dict(frac=mid, model='mlp', steps=4, kw=dict(ranks.STEP_KW, **kw)),
        ))
    for frac in fracs:
        spec['cases'].append((
            f'loss-{frac}', 'train',
            dict(frac=frac, model='mlp', steps=12, kw=dict(damping=0.003, lr=0.05)),
        ))
    # three steps of the LM through the Trainer against the JAX Trainer:
    # Trainer.step on every world; on two ranks also scan_steps and
    # step_accumulate (each batch in two micro-batches)
    lm, reg, loss, params, _ = models['lm']
    paths = TRAINER_PATHS[world]

    def trainer_refs():
        ref['trainer'] = {'init': spec['weights']['lm']}
        for path in paths:
            dk = JaxDistributedKFAC(
                config=jax_cfg(reg, **ranks.TRAINER_KW), mesh=jax_kaisa_mesh(low, devices=devices)
            )
            trainer = jtraining.Trainer(
                loss_fn=lambda p, ms, b: (loss(p, b), ms), optimizer=optax.sgd(0.1, momentum=0.9),
                kfac=dk,
            )
            state, losses = trainer.init(params), []
            batches = [tuple(jnp.asarray(x) for x in b) for b in spec['train_batches']['lm']]
            if path == 'step':
                for b in batches:
                    state, value = trainer.step(state, b)
                    losses.append(float(value))
            elif path == 'scan_steps':
                state, values = trainer.scan_steps(state, tuple(jnp.stack(x) for x in zip(*batches)))
                losses = [float(v) for v in values]
            else:
                for b in batches:
                    micro = [tuple(x[:4] for x in b), tuple(x[4:] for x in b)]
                    state, value = trainer.step_accumulate(state, micro)
                    losses.append(float(value))
            ref['trainer'][path] = {
                'losses': losses,
                'params': {
                    k: v.numpy()
                    for k, v in convert.from_flax_params(jax.device_get(state.params)).items()
                },
            }

    spec['cases'].append((
        'trainer', 'train', dict(frac=low, model='lm', steps=3, kw=ranks.TRAINER_KW, paths=paths),
    ))
    if world == 2:
        # the ResNet through the Trainer against the port's dense engine
        # (BatchNorm moments over the global batch: 2 images a rank)
        g = rng(11)
        spec['resnet'] = {
            'weights': {
                k: v.numpy() for k, v in resnet.CifarResNet(depth=8, seed=3, device='cpu').state_dict().items()
            },
            'batches': [
                (g.standard_normal((4, 3, 8, 8)).astype(np.float32), g.integers(0, 10, 4).astype(np.int64))
                for _ in range(RESNET_STEPS)
            ],
        }
        spec['cases'].append(('resnet', 'resnet', dict(frac=low, steps=RESNET_STEPS)))
    # the sentinel, metrics and flight recorder against the JAX engine
    root = tempfile.mkdtemp(prefix=f'kfac_torch_kaisa_w{world}_')
    for frac in fracs:
        for method, kw in OBSERVE_VARIANTS:
            spec['cases'].append((f'observe-{method}-{frac}', 'observe', dict(frac=frac, **kw)))
    spec['cases'][-1][2]['root'] = os.path.join(root, 'observe')

    def observe_refs():
        ref['observe'] = {}
        for frac in fracs:
            for method, kw in OBSERVE_VARIANTS:
                dk = JaxDistributedKFAC(
                    config=jax_cfg(models['mlp'][1], health=jhealth.HealthConfig(**ranks.OBS_HEALTH),
                                   **ranks.OBS_KW, **kw),
                    mesh=jax_kaisa_mesh(frac, devices=devices),
                )
                step, state, steps = jax.jit(dk.step), dk.init(), []
                for i in range(ranks.OBS_STEPS):
                    st = jax_poisoned(mlp_stats) if i == 1 else mlp_stats
                    state, g = step(state, mlp_grads, st, loss=ref['loss']['mlp'])
                    steps.append({'grads': torch_grads(g), 'health': jtracing.health_counters(state)})
                ref['observe'][frac, method] = {
                    'steps': steps,
                    'drain': jmetrics.MetricsCollector(include_health=False).drain(state),
                    'ring': jflight.drain_flight(state),
                }

    def manifest_refs():
        # checkpoints: the manifests of the engines the port saves and restores
        ref['manifest'] = {}
        for name, frac_, kw in (('mid', mid, {}), ('mid128', mid, dict(bucket_granularity=128))):
            dk = JaxDistributedKFAC(
                config=jax_cfg(models['mlp'][1], **ranks.CKPT_KW, **kw),
                mesh=jax_kaisa_mesh(frac_, devices=devices),
            )
            ref['manifest'][name] = jcheckpoint.layout_manifest(dk)
        ref['mlp_grads'] = jax.device_get(mlp_grads)

    spec['cases'].append(('checkpoint', 'checkpoint', dict(frac=mid, root=os.path.join(root, 'ckpt'))))
    spec['cases'].append(('manager', 'manager', dict(frac=mid, root=os.path.join(root, 'mgr'))))
    # the world's processes run while this one computes the references the
    # spec does not carry
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = pool.submit(
            spawn_world, ranks.run_cases, world, 'gloo', 'cpu', args=(spec,), timeout_s=300
        )
        for refs in (colocate_refs, trainer_refs, observe_refs, manifest_refs):
            refs()
        results = pending.result()
    return ref, results, fracs


def jax_oracle(world, target, factors, step, health):
    """The JAX engine's preconditioned grads after ``insert_factors`` of
    ``factors``, the step, ``rematerialize`` and the port's health
    counters: the dense engine for ``'to_dense'``, else the
    ``DistributedKFAC`` the port restored into."""
    _, reg, _, _, _ = flax_models()['mlp']
    kw = dict(ranks.CKPT_KW, health=jhealth.HealthConfig(warn=False))
    if target == 'granularity':
        kw['bucket_granularity'] = 128
    engine = jax_cfg(reg, **kw)
    if target != 'to_dense':
        fracs = assignment.candidate_fractions(world)
        engine = JaxDistributedKFAC(
            config=engine, mesh=jax_kaisa_mesh(middle(fracs), devices=jax.devices()[:world])
        )
    state = engine.insert_factors(engine.init(), factors)
    state = engine.rematerialize(state._replace(step=jnp.asarray(step, jnp.int32)))
    names = list(reg.layers)
    state = state._replace(health=jhealth.HealthState(
        skipped_steps=jnp.int32(health['health/skipped_steps']),
        damping_mult={n: jnp.float32(health[f'health/{n}/damping_mult']) for n in names},
        **{f: {n: jnp.int32(health[f'health/{n}/{f}']) for n in names}
           for f in ('quarantined', 'bad_inv', 'quarantine_events')},
    ))
    mlp_grads = world_run(world)[0]['mlp_grads']
    return torch_grads(engine.precondition(state, mlp_grads))


_WORLDS: dict[int, tuple] = {}


def world_run(world):
    """:func:`run_world` once per test run: under pytest-xdist the first
    worker to need a world computes it under a file lock and leaves it in
    the temporary directory, keyed by the run's id, for the others."""
    if world in _WORLDS:
        return _WORLDS[world]
    uid = os.environ.get('PYTEST_XDIST_TESTRUNUID')
    if uid is None:
        _WORLDS[world] = run_world(world)
        return _WORLDS[world]
    path = os.path.join(tempfile.gettempdir(), f'kfac_torch_kaisa_{uid}_w{world}.pkl')
    with open(path + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            with open(path, 'rb') as f:
                _WORLDS[world] = pickle.load(f)
        else:
            _WORLDS[world] = run_world(world)
            with open(path + '.tmp', 'wb') as f:
                pickle.dump(_WORLDS[world], f)
            os.replace(path + '.tmp', path)
    return _WORLDS[world]


def pytest_generate_tests(metafunc):
    if 'frac' in metafunc.fixturenames:
        metafunc.parametrize('frac', assignment.candidate_fractions(metafunc.cls.W))


def close(got, want, rtol=1e-4, atol_rel=1e-5, msg=''):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * float(np.max(np.abs(want))), err_msg=msg
    )


def close_grads(got, want, rtol=1e-4, atol_rel=1e-5):
    assert set(got) == set(want)
    scale = max(float(np.max(np.abs(w))) for w in want.values())
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, rtol=rtol, atol=atol_rel * scale, err_msg=n)


def test_size_class_matches_jax():
    for g in (1, 100, 128, 256):
        for d in range(0, 700):
            assert size_class(d, g) == jax_size_class(d, g)
    assert size_class(65, 100) == 100 and size_class(513, 256) == 768


def test_kaisa_mesh_needs_a_process_group():
    from kfac_tpu_torch.parallel import kaisa_mesh

    with pytest.raises(RuntimeError, match='init_process_group'):
        kaisa_mesh(1.0, device='cpu')


@pytest.mark.parametrize(
    'knob', ['async_inverse', 'auto_layout', 'offload', 'stat_compression', 'compile_watch']
)
def test_later_slice_knobs_raise(knob):
    # compile_watch raises in the config already; health, metrics and
    # flight are ported (WorldCases below), and so are async_inverse,
    # offload and stat_compression since (tests/test_torch_compression.py
    # and tests/test_torch_async_inverse.py drive them in gloo worlds):
    # DistributedKFAC no longer refuses them
    from kfac_tpu_torch.layers import registry
    from kfac_tpu_torch.parallel import DistributedKFAC, kaisa
    from kfac_tpu_torch.preconditioner import KFACPreconditioner

    reg = registry.register_model(torch.nn.Sequential(torch.nn.Linear(3, 2)), device='cpu')
    if knob in ('async_inverse', 'offload', 'stat_compression'):
        value = {'async_inverse': 'sliced', 'offload': True, 'stat_compression': 'int8'}[knob]
        cfg = KFACPreconditioner(
            reg, device='cpu', inv_update_steps=2, factor_update_steps=2,
            allreduce_method='allreduce_bucketed', **{knob: value},
        )
        assert getattr(cfg, knob) is not None and knob not in kaisa._LATER_SLICE_KNOBS
        return
    kw = {} if knob == 'auto_layout' else {knob: True}
    with pytest.raises(NotImplementedError, match='not ported'):
        cfg = KFACPreconditioner(reg, device='cpu', inv_update_steps=2, factor_update_steps=2, **kw)
        DistributedKFAC(cfg, auto_layout='plan.json' if knob == 'auto_layout' else None)


class WorldCases:
    W = 0

    @pytest.fixture(scope='class')
    def run(self):
        return world_run(self.W)

    def test_mesh_shape_matches_jax(self, run, frac):
        ref, results, _ = run
        topo = results[0][f'eigen-{frac}']['topology']
        assert tuple(topo['mesh_shape']) == ref['mesh'][frac]
        assert topo['process_count'] == self.W and topo['backend'] == 'gloo'

    def test_buckets_and_stores_pad_to_the_world(self, run, frac):
        ref, results, _ = run
        got = results[0][f'eigen-{frac}']
        want = ref['step']['eigen', frac]
        assert got['buckets'] == want['buckets'] and got['stores'] == want['stores']
        for b in got['buckets']:
            assert b[4] % self.W == 0

    @pytest.mark.parametrize('method', ['eigen', 'inverse'])
    def test_grads_match_jax_and_dense(self, run, frac, method):
        ref, results, _ = run
        got = [r[f'{method}-{frac}']['grads'] for r in results]
        close_grads(got[0], ref['step'][method, frac]['grads'])
        close_grads(got[0], results[0][f'{method}-{frac}']['dense_grads'])
        for other in got[1:]:  # every rank preconditions the same grads
            assert all(np.array_equal(other[n], got[0][n]) for n in got[0])

    @pytest.mark.parametrize('method', ['eigen', 'inverse'])
    def test_factor_stacks_match_jax(self, run, frac, method):
        # the G scale under a sharded batch: each rank's G is world^2 the
        # global one's, and the engine's reduction divides it out
        ref, results, _ = run
        got = results[0][f'{method}-{frac}']['state']
        want = ref['step'][method, frac]['state']
        for side in ('a', 'g'):
            assert set(got[side]) == set(want[side])
            for key, w in want[side].items():
                close(got[side][key], w, rtol=1e-5, atol_rel=1e-6, msg=f'{side} {key}')

    @pytest.mark.parametrize('method', ['eigen', 'inverse'])
    def test_decompositions_match_jax(self, run, frac, method):
        ref, results, _ = run
        got = results[0][f'{method}-{frac}']['state']
        want = ref['step'][method, frac]['state']
        fields = ('da', 'dg') if method == 'eigen' else ('a_inv', 'g_inv')
        for field in fields:
            for key, w in want[field].items():
                close(got[field][key], w, msg=f'{field} {key}')

    @pytest.mark.parametrize('method', ['eigen', 'inverse'])
    def test_resident_layout_matches_jax(self, run, frac, method):
        # which rank holds which slots of each decomposition
        ref, results, _ = run
        want = ref['step'][method, frac]['resident']
        field = 'qa' if method == 'eigen' else 'a_inv'
        for rank, res in enumerate(results):
            r = res[f'{method}-{frac}']
            for key, by_device in want.items():
                assert r['column_range'][key] == by_device[rank]
                lo, hi = by_device[rank]
                assert r['local_shapes'][field][key][0] == hi - lo

    def test_memory_usage_matches_jax(self, run, frac):
        ref, results, _ = run
        for method in ('eigen', 'inverse'):
            want = ref['step'][method, frac]['memory']
            for res in results:
                assert res[f'{method}-{frac}']['memory'] == want

    def test_describe_names_the_rank_that_holds_each_slot(self, run, frac):
        _, results, _ = run
        r0 = results[0][f'eigen-{frac}']
        dump = r0['describe']
        assert 'NOT the executed placement' in dump and 'executed placement' in dump
        placement = dump.split('executed placement')[1].split('cost-model view')[0]
        slots = {}
        for sb in r0['stores'][0]:
            slots['a', sb[0]] = sb
        for sb in r0['stores'][1]:
            slots['g', sb[0]] = sb
        for side in ('a', 'g'):
            for sb in r0['stores'][0 if side == 'a' else 1]:
                key, layers = sb[0], sb[1]
                for i, name in enumerate(layers):
                    claimed = r0['slot_device'][side][name]
                    lo, hi = results[claimed][f'eigen-{frac}']['factor_range'][key]
                    assert lo <= i < hi, (name, side, claimed)
                    line = next(
                        ln for ln in placement.splitlines() if ln.strip().startswith(name + ':')
                    )
                    assert f'{side.upper()} slot {key}[{i}] -> rank {claimed}' in line

    def test_comms_report_matches_jax(self, run, frac):
        ref, results, _ = run
        assert results[0][f'eigen-{frac}']['comms'] == ref['step']['eigen', frac]['comms']

    def test_inverse_residuals_match_jax(self, run, frac):
        ref, results, _ = run
        want = ref['step']['inverse', frac]['residuals']
        got = results[0][f'inverse-{frac}']['residuals']
        for side in ('a', 'g'):
            for key, w in want[side].items():
                np.testing.assert_allclose(got[side][key], w, atol=1e-6)
                assert np.all(got[side][key] < jfactors.NS_FALLBACK_RESIDUAL)
        assert 'INVERSE' in results[0][f'eigen-{frac}']['residuals_raise']

    def test_convert_round_trip_and_a_warm_step(self, run):
        ref, results, fracs = run
        jstate = ref['step']['inverse', fracs[-1]]['state']
        for res in results:
            back = res['convert']['roundtrip']
            for field in ('a', 'g', 'a_inv', 'g_inv'):
                for key, w in jstate[field].items():
                    assert np.array_equal(back[field][key], w)
        got = results[0]['convert']
        close_grads(got['grads'], ref['convert']['grads'])
        for field in ('a', 'g'):
            for key, w in ref['convert']['state'][field].items():
                close(got['state'][field][key], w, rtol=1e-5, atol_rel=1e-6)
        for field in ('a_inv', 'g_inv'):
            for key, w in ref['convert']['state'][field].items():
                close(got['state'][field][key], w)
        for side in got['residuals'].values():
            for r in side.values():
                assert np.all(r < jfactors.NS_FALLBACK_RESIDUAL)

    def test_lm_step_matches_dense(self, run):
        _, results, _ = run
        got = results[0]['lm-step']
        close_grads(got['grads'], got['dense_grads'])
        assert len(got['buckets']) == 3  # q/k/v/out, mlp_up, mlp_down

    def test_newton_schulz_matches_cholesky_and_auto_takes_one_branch(self, run):
        _, results, _ = run
        v = results[0]['solvers']
        close_grads(v['newton_schulz']['grads'], v['cholesky']['grads'], rtol=5e-3, atol_rel=5e-5)
        close_grads(v['auto']['grads'], v['newton_schulz']['grads'], rtol=1e-4, atol_rel=1e-6)
        assert v['auto']['cholesky_fallbacks'] == 0

    def test_prediv_matches_plain_and_is_accounted(self, run):
        _, results, _ = run
        v = results[0]['solvers']
        close_grads(v['prediv']['grads'], v['eigen']['grads'], rtol=1e-4, atol_rel=1e-6)
        assert v['prediv']['fields']['dgda'] and not v['prediv']['fields']['da']
        # the fused grid is counted with the G side, as in the JAX engine
        dgda = sum(v['prediv']['local_bytes']['dgda'].values())
        qg = sum(v['prediv']['local_bytes']['qg'].values())
        assert dgda > 0 and v['prediv']['memory']['g_inverses'] == qg + dgda

    def test_colocate_factors_false_placement_and_numerics(self, run):
        ref, results, _ = run
        v = results[0]['colocate']
        for method in ('eigen', 'inverse'):
            a_keys, g_keys = v[method]['stores']
            assert a_keys == ['a17'] and sorted(g_keys) == ['g16', 'g4']
            assert v[method]['slots']['a']['r'] == ('a17', 2)
            assert v[method]['slots']['g']['r'] == ('g4', 0)
            close_grads(v[method]['grads'], ref['colocate'][method])
            for other in results[1:]:
                g = other['colocate'][method]['grads']
                assert all(np.array_equal(g[n], v[method]['grads'][n]) for n in g)

    def test_size_classes_collapse_shapes_exactly(self, run):
        _, results, _ = run
        v = results[0]['classes']
        assert v['g128']['buckets'] < v['g1']['buckets']
        close_grads(v['g128']['grads'], v['g1']['grads'], rtol=2e-4, atol_rel=1e-6)

    def test_unexecuted_layer_keeps_its_factors(self, run):
        _, results, _ = run
        factors_after = results[0]['unexecuted']
        np.testing.assert_allclose(factors_after['dense1']['a'], np.eye(17), atol=1e-6)
        np.testing.assert_allclose(factors_after['dense1']['g'], np.eye(12), atol=1e-6)
        assert np.abs(factors_after['dense0']['a'] - np.eye(7)).max() > 0

    @pytest.mark.parametrize('transport', ['bucketed', 'chunked'])
    def test_bucketed_transport_matches_the_default(self, run, transport):
        _, results, _ = run
        want = results[0]['transport-allreduce']['step']
        got = results[0][f'transport-{transport}']['step']
        np.testing.assert_allclose(got['losses'], want['losses'], rtol=1e-6)
        for n, w in want['params'].items():
            np.testing.assert_allclose(got['params'][n], w, rtol=1e-6, atol=1e-7)

    def test_loss_decreases(self, run, frac):
        _, results, _ = run
        losses = results[0][f'loss-{frac}']['step']['losses']
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
        for other in results[1:]:  # every rank updates the same parameters
            theirs = other[f'loss-{frac}']['step']
            assert theirs['losses'] == losses
            assert all(
                np.array_equal(theirs['params'][n], p)
                for n, p in results[0][f'loss-{frac}']['step']['params'].items()
            )

    def test_trainer_step_matches_jax(self, run):
        self.check_trainer_path(run, 'step')

    def check_trainer_path(self, run, path):
        ref, results, _ = run
        got = results[0]['trainer'][path]
        want = ref['trainer'][path]
        np.testing.assert_allclose(got['losses'], want['losses'], rtol=1e-5)
        init = ref['trainer']['init']
        delta = {n: want['params'][n] - init[n] for n in want['params']}
        scale = max(float(np.max(np.abs(d))) for d in delta.values())
        for n, d in delta.items():
            np.testing.assert_allclose(
                got['params'][n] - init[n], d, rtol=1e-4, atol=1e-4 * scale, err_msg=n
            )
        for other in results[1:]:
            theirs = other['trainer'][path]['params']
            assert all(np.array_equal(theirs[n], got['params'][n]) for n in theirs)

    # ---------------------------------------- sentinel, metrics, flight

    @pytest.mark.parametrize('method', ['eigen', 'inverse'])
    def test_health_counters_match_jax_exactly(self, run, frac, method):
        ref, results, _ = run
        want = ref['observe'][frac, method]['steps']
        for res in results:
            got = res[f'observe-{method}-{frac}']['steps']
            for i, (g, w) in enumerate(zip(got, want)):
                assert g['health'] == w['health'], (i, g['health'], w['health'])

    @pytest.mark.parametrize('method', ['eigen', 'inverse'])
    def test_quarantine_rolls_back_and_the_degraded_layer_bypasses(self, run, frac, method):
        # tests/test_health.py's stacked rollback and degradation bypass:
        # the poisoned factor keeps its step-0 value, its damping goes 10x
        # then decays to 5x, its layer is degraded (raw gradient) on step 1
        # only; every step's grads as the JAX engine's
        ref, results, _ = run
        got = results[0][f'observe-{method}-{frac}']['steps']
        np.testing.assert_array_equal(got[1]['poisoned_a'], got[0]['poisoned_a'])
        assert np.abs(got[2]['poisoned_a'] - got[1]['poisoned_a']).max() > 0
        h = [s['health'] for s in got]
        p = ranks.POISON
        assert [x[f'health/{p}/damping_mult'] for x in h] == [1.0, 10.0, 5.0]
        assert [x[f'health/{p}/quarantined'] for x in h] == [0, 1, 0]
        assert [x[f'health/{p}/bad_inv'] for x in h] == [0, 1, 0]
        assert h[2][f'health/{p}/quarantine_events'] == 1
        for i, w in enumerate(ref['observe'][frac, method]['steps']):
            close_grads(got[i]['grads'], w['grads'])

    @pytest.mark.parametrize('method', ['eigen', 'inverse'])
    def test_metrics_and_flight_ring_match_jax_and_dense(self, run, frac, method):
        ref, results, _ = run
        got = results[0][f'observe-{method}-{frac}']
        for want in (ref['observe'][frac, method], got['dense']):
            assert set(got['drain']) == set(want['drain'])
            for k, w in want['drain'].items():
                np.testing.assert_allclose(got['drain'][k], w, rtol=1e-4, atol=1e-6, err_msg=k)
            assert [r['step'] for r in got['ring']] == [r['step'] for r in want['ring']]
            for g, w in zip(got['ring'], want['ring']):
                assert set(g) == set(w)
                for k, v in w.items():
                    np.testing.assert_allclose(g[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
        for g, w in zip(got['steps'], got['dense']['steps']):
            assert g['health'] == w['health']

    @pytest.mark.parametrize('method', ['eigen', 'inverse'])
    def test_observability_state_is_bitwise_equal_on_every_rank(self, run, frac, method):
        _, results, _ = run
        want = results[0][f'observe-{method}-{frac}']['tensors']
        for res in results[1:]:
            got = res[f'observe-{method}-{frac}']['tensors']
            for field, tensors in want.items():
                for name, w in tensors.items():
                    assert np.array_equal(got[field][name], w, equal_nan=True), (field, name)
        assert 'health: skip_nonfinite' in results[0][f'observe-{method}-{frac}']['describe']

    def test_postmortem_on_a_degrade_saves_one_emergency_checkpoint(self, run):
        # tests/test_flight_recorder.py's distributed postmortem: on the
        # degrade every rank enters the emergency save (one rotation
        # entry), and rank 0 alone writes the bundle, comms.json included
        _, results, fracs = run
        case = f'observe-inverse-{fracs[-1]}'
        for rank, res in enumerate(results):
            assert res[case]['rotation'] == [2]  # the state after step 1
            bundles = res[case]['bundles']
            if rank:
                assert bundles == []
                continue
            names = [b[0] for b in bundles]
            assert len(names) == 1 and 'quarantine-degrade' in names[0]
            assert {'comms.json', 'factors.json', 'health.json', 'MANIFEST.json'} <= set(bundles[0][1])

    # ------------------------------------------------------ checkpoints

    def test_checkpoint_manifests_match_jax(self, run):
        ref, results, _ = run
        for res in results:
            got = res['checkpoint']
            for mine, theirs in ((got['manifest'], ref['manifest']['mid']),
                                 (got['granularity']['manifest'], ref['manifest']['mid128'])):
                assert jcheckpoint._layout_view(mine) == jcheckpoint._layout_view(theirs)
                assert mine['compute_method'] == theirs['compute_method']

    def test_checkpoint_round_trip_restores_its_own_layout(self, run):
        # tests/test_aux.py's distributed round trip: no warning, the
        # blocks bitwise, the counters verbatim, the extras rank 0 wrote
        _, results, _ = run
        for res in results:
            got, src = res['checkpoint']['same'], res['checkpoint']['source']
            assert got['warnings'] == [] and got['blocks_equal']
            assert got['step'] == src['step'] == 2 and got['health'] == src['health']
            assert got['health'][f'health/{ranks.POISON}/quarantine_events'] == 1
            np.testing.assert_array_equal(got['extra']['w'], np.arange(3.0))
            close_grads(got['grads'], src['grads'])

    @pytest.mark.parametrize('target', ['granularity', 'to_dense', 'from_dense'])
    def test_checkpoint_migrates_and_matches_the_jax_oracle(self, run, target):
        # tests/test_aux.py's migrations: the JAX warning, the factors and
        # counters carried, the preconditioned grads as the saved engine's
        # and as the JAX engine's insert_factors + rematerialize
        ref, results, _ = run
        got = results[0]['checkpoint'][target]
        assert any('migrating through per-layer factors' in w for w in got['warnings'])
        if target == 'from_dense':
            src_factors, src_health = got['source'], got['source_health']
            durable, saved_man = {'a': {n: f['a'] for n, f in src_factors.items()},
                                  'g': {n: f['g'] for n, f in src_factors.items()}}, got['source_manifest']
        else:
            src = results[0]['checkpoint']['source']
            src_factors, src_health = src['factors'], src['health']
            durable, saved_man = src['stacks'], results[0]['checkpoint']['manifest']
            if target == 'granularity':
                close_grads(got['grads'], src['grads'])
        assert got['health'] == src_health
        for n, f in src_factors.items():
            for side in ('a', 'g'):
                np.testing.assert_allclose(got['factors'][n][side], f[side], rtol=1e-6)
        factors = jcheckpoint._factors_from_saved(durable, saved_man)
        want = jax_oracle(self.W, target, factors, got['step'], got['health'])
        close_grads(got['grads'], want)

    def test_checkpoint_migration_refusals_name_the_cause(self, run):
        _, results, _ = run
        for res in results:
            assert 'factor migration requires identical layer sets' in res['checkpoint']['layer_set']
            assert 'factors cannot migrate across layer widths' in res['checkpoint']['width']

    def test_save_factors_loads_into_another_layout(self, run):
        _, results, _ = run
        got = results[0]['checkpoint']
        # the file holds factors and the step only: the counters start fresh
        loaded = got['factors_file']
        for n, f in got['source']['factors'].items():
            for side in ('a', 'g'):
                np.testing.assert_array_equal(loaded['factors'][n][side], f[side])
        assert loaded['step'] == 2
        assert loaded['health'][f'health/{ranks.POISON}/damping_mult'] == 1.0
        assert all(np.isfinite(g).all() for g in loaded['grads'].values())

    # ----------------------------------------------------------- manager

    def test_trainer_sigterm_on_one_rank_preempts_every_rank_and_resumes_bitwise(self, run):
        # the last rank signals itself before step 3: every rank saves one
        # emergency checkpoint at step 4 (LATEST on it), the restore gives
        # every rank the saved parameters bitwise, and two more steps are
        # bitwise the interrupted run's continued in memory
        _, results, _ = run
        for res in results:
            got = res['manager']
            assert got['preempted'][:2] == ('SIGTERM', 4)
            assert got['losses'] and len(got['losses']) == 3
            assert got['restored_step'] == 4 and got['rotation'][0] == 4
            assert got['resumed'] == got['oracle'] and got['resumed_params_equal']
            # rebind_engine to the dense engine restores the same checkpoint
            assert got['rebound']['step'] == 4 and got['rebound']['engine'] == 'KFACPreconditioner'
            assert got['rebound']['params_equal']
            assert any('migrating' in w for w in got['rebound']['warnings'])
            for n, p in got['saved_params'].items():
                assert np.array_equal(got['restored_params'][n], p)
                assert np.array_equal(results[0]['manager']['restored_params'][n], p)
        assert results[0]['manager']['latest'] == 4

    def test_coordination_defers_off_cadence_and_agrees_on_the_step(self, run):
        # tests/test_resilience.py's deferred and agreed step, on real
        # ranks: rank 0's SIGUSR1 waits for the cadence (one process acts
        # at once), then every rank saves at the largest step; the last
        # rank's SIGTERM preempts every rank as SIGTERM
        _, results, _ = run
        for rank, res in enumerate(results):
            got = res['manager']['agree']
            if self.W == 1:
                assert got['off_cadence'].endswith('step_00000003/ckpt') and got['pending'] is None
                assert got['agreed_path'] is None
            else:
                assert got['off_cadence'] is None
                assert got['pending'] == ('SIGUSR1' if rank == 0 else None)
                assert got['agreed_path'].endswith('step_00000008/ckpt')
            assert got['preempted'][:2] == ('SIGTERM', 12)
            assert got['preempted'][2].endswith('step_00000012/ckpt')
        assert results[0]['manager']['agree']['latest'] == (3 if self.W == 1 else 8)

    def test_elastic_restore_dense_and_stacked_via_manager(self, run):
        _, results, _ = run
        for res in results:
            got = res['manager']['elastic']
            assert got['step'] == got['back_step'] == 2
            assert any('migrating' in w for w in got['warnings'])
            assert any('migrating' in w for w in got['back_warnings'])
            for n, f in got['source'].items():
                for side in ('a', 'g'):
                    np.testing.assert_allclose(got['stacked'][n][side], f[side], rtol=1e-6)
                    np.testing.assert_allclose(got['back'][n][side], f[side], rtol=1e-6)

    def test_restore_engine_overrides_the_manager_granularity(self, run):
        _, results, _ = run
        got = results[0]['manager']['override']
        assert got['step'] == 2 and got['binding_kept']
        assert any('migrating' in w for w in got['warnings'])
        for n, f in got['source'].items():
            for side in ('a', 'g'):
                np.testing.assert_allclose(got['restored'][n][side], f[side], rtol=1e-6)


    def test_multihost_helpers_read_the_group(self, run):
        # the world's size, each rank's index, and the gathered array in
        # rank order on every rank (exact)
        _, results, _ = run
        want = np.array([[r, 10.0 * r + 0.5] for r in range(self.W)], np.float32)
        for rank, res in enumerate(results):
            got = res['multihost']
            assert (got['count'], got['index']) == (self.W, rank)
            np.testing.assert_array_equal(got['gathered'], want)

    def test_multihost_votes_agree_on_every_rank(self, run):
        # rank r votes code r % 2 + 1 at step 100 - r: the max of each;
        # a decision holds only when every rank votes True
        _, results, _ = run
        for res in results:
            got = res['multihost']
            assert tuple(got['emergency']) == (min(self.W, 2), 100)
            assert got['all_true'] is True and got['last_false'] is False

    def test_assert_same_step_raises_only_on_a_mismatch(self, run):
        # each rank reports its own rank as the step: every rank raises,
        # naming all the steps, once there are two
        _, results, _ = run
        for res in results:
            mismatch = res['multihost']['mismatch']
            if self.W == 1:
                assert mismatch is None
            else:
                assert mismatch is not None and str(list(range(self.W))) in mismatch


class TestWorld1(WorldCases):
    W = 1


class MultiRankCases(WorldCases):
    def test_elastic_restore_onto_half_the_world_and_back(self, run):
        # tests/test_aux.py's elastic restart: the checkpoint of W ranks
        # onto a subgroup of W / 2 and, after a step there, back onto W;
        # each leg preconditions as the engine it came from
        _, results, _ = run
        shrunk = results[0]['checkpoint']['shrunk']
        close_grads(shrunk['grads'], results[0]['checkpoint']['source']['grads'])
        assert shrunk['step'] == 2 and results[0]['checkpoint']['shrunk_stepped']['step'] == 3
        for res in results:
            grown = res['checkpoint']['grown']
            assert grown['step'] == 3
            assert grown['health'] == results[0]['checkpoint']['shrunk_stepped']['health']
            close_grads(grown['grads'], results[0]['checkpoint']['shrunk_stepped']['grads'])

    def test_mem_opt_requires_colocated_factors(self, run):
        _, results, _ = run
        for res in results:
            assert 'MEM-OPT' in res['memopt']['not_colocated']['raises']


class TestWorld2(MultiRankCases):
    W = 2

    @pytest.mark.parametrize('path', ['scan_steps', 'step_accumulate'])
    def test_trainer_paths_match_jax(self, run, path):
        self.check_trainer_path(run, path)

    def test_resnet_trainer_matches_the_dense_engine(self, run):
        # CifarResNet(depth=8) through the Trainer, 3 steps at cadence 1/2
        # on 2 ranks (2 images each, BatchNorm over the global 4): losses
        # rtol 1e-5 of the dense engine's on the global batch, parameter
        # updates rtol 1e-4 with atol 1e-4 x the largest, running
        # statistics rtol 1e-5 with atol 1e-6 x max; every rank's
        # parameters and statistics bitwise rank 0's
        _, results, _ = run
        dense, kaisa = results[0]['resnet']['dense'], results[0]['resnet']['kaisa']
        assert kaisa['layers'] == 8 and all(np.isfinite(kaisa['losses']))
        np.testing.assert_allclose(kaisa['losses'], dense['losses'], rtol=1e-5)
        weights = resnet.CifarResNet(depth=8, seed=3, device='cpu').state_dict()
        delta = {n: dense['params'][n] - weights[n].numpy() for n in dense['params']}
        scale = max(float(np.max(np.abs(d))) for d in delta.values())
        for n, d in delta.items():
            np.testing.assert_allclose(
                kaisa['params'][n] - weights[n].numpy(), d, rtol=1e-4, atol=1e-4 * scale, err_msg=n
            )
        for key, stats in dense['model_state'].items():
            for f, v in stats.items():
                np.testing.assert_allclose(
                    kaisa['model_state'][key][f], v, rtol=1e-5, atol=1e-6 * np.max(np.abs(v)),
                    err_msg=f'{key}/{f}',
                )
        for other in results[1:]:
            theirs = other['resnet']['kaisa']
            assert theirs['losses'] == kaisa['losses']
            assert all(np.array_equal(theirs['params'][n], p) for n, p in kaisa['params'].items())
            assert all(
                np.array_equal(theirs['model_state'][k][f], v)
                for k, s in kaisa['model_state'].items() for f, v in s.items()
            )


class TestWorld4(MultiRankCases):
    W = 4

    def test_compressed_step_within_one_quantum_of_w1(self, run):
        from test_torch_compression import assert_within_one_quantum

        _, results, _ = run
        w1 = world_run(1)[1][0]['compressed']['int8']
        assert_within_one_quantum(w1, [r['compressed']['int8'] for r in results])
        # the transport's collectives: a reduce-scatter and two all-gathers a chunk
        assert results[0]['compressed']['int8']['counter']['collectives'] == 3 * len(w1['plan'])
