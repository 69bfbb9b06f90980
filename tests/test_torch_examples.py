"""The port's training entry points against the JAX package's: the flag
groups and the schedule of ``examples/common.py``, the data functions of
``examples/data.py`` with the per-rank loader, the three example trainers,
the native prefetch loader, the ``char_lm`` tasks of
``tools/bench_accuracy.py`` and the plain flash partials at head dims 16
and 64.

The JAX scripts run in this process on the virtual CPU devices (eight:
their ``DistributedKFAC`` and pipeline meshes span them); their per-step
losses are read from ``examples.common.Metric.update``, which each script
calls once a step. The port's scripts run with the JAX initial weights
carried over by ``convert`` (their ``run(args, init_params)``), in one
process, and in a gloo world of two ranks (rank bodies in
``tests/torch_examples_ranks.py``, JAX-free; once per test run under a
file lock) for the interleaved pipeline, the per-rank loader and the
model and sequence shards.

Tolerances: data functions, loaders, tables and flag defaults exact; the
learning-rate schedule exact (both in float32); the LM script's per-step
losses rtol 1e-5 against the JAX script in one process and on the
interleaved pipeline, and rtol 1e-4 for the data-parallel, tensor- and
sequence-parallel worlds against the JAX script's ``DistributedKFAC``
(the KAISA tests' tolerance between worlds), the returned perplexity rtol
1e-4; a resumed run equal to the
uninterrupted one (rtol 1e-7); the ResNet scripts' first step's loss rtol
1e-5 and the second's rtol 1e-4 (the ResNet trajectory amplifies f32
rounding: ``tests/test_torch_resnet.py``); the ``char_lm`` model's loss
and three K-FAC steps rtol 1e-5; the plain flash partials against
``attend_partials_einsum`` rtol 1e-5 with atol 1e-6 x max.
"""

import argparse
import fcntl
import json
import os
import pickle
import sys
import tempfile
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_examples_ranks as ranks
from examples import common as jcommon
from examples import data as jdata
from kfac_tpu.utils import native_loader as jnative
from kfac_tpu_torch import bench_accuracy, convert, data
from kfac_tpu_torch.examples import common, train_cifar_resnet, train_imagenet_resnet
from kfac_tpu_torch.examples import train_language_model
from kfac_tpu_torch.ops import flash_attention
from kfac_tpu_torch.parallel import spawn_world
from kfac_tpu_torch.utils import native_loader

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

warnings.filterwarnings('ignore', message='pipeline-parallel K-FAC is experimental')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))


class _Parsed(Exception):
    pass


def jax_defaults(module, monkeypatch):
    """The JAX script's parsed defaults: its parser is built inside
    ``main``, which parses and then calls ``common.distributed_init``."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        ns = real(self, args, namespace)
        seen['ns'] = ns
        return ns

    def stop():
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, 'parse_args', parse)
    monkeypatch.setattr(jcommon, 'distributed_init', stop)
    with pytest.raises(_Parsed):
        module.main([])
    monkeypatch.undo()
    return vars(seen['ns'])


@pytest.mark.parametrize('script', ['train_language_model', 'train_cifar_resnet', 'train_imagenet_resnet'])
def test_flag_defaults_equal_jax(script, monkeypatch):
    import importlib

    want = jax_defaults(importlib.import_module(f'examples.{script}'), monkeypatch)
    port = {'train_language_model': train_language_model, 'train_cifar_resnet': train_cifar_resnet,
            'train_imagenet_resnet': train_imagenet_resnet}[script]
    got = vars(port.parse_args([]))
    assert got.pop('device') == 'cuda'
    assert got == want


@pytest.mark.parametrize('args', [
    (0.1, 7, 3, 1, [0.5, 0.75]), (0.05, 10, 2, 0.5, [0.3, 0.3, 0.9]), (1.0, 3, 4, 0, []),
    (0.1, 1, 1, 1, [0.0]),
])
def test_lr_schedule_equals_jax_at_every_step(args):
    j, p = jcommon.make_lr_schedule(*args), common.make_lr_schedule(*args)
    for i in range(int(args[1] * args[2]) + 3):
        assert p(i) == float(j(np.int32(i))), i


def test_strategy_fraction_and_losses_equal_jax():
    for name in ('comm-opt', 'mem-opt', 'hybrid-opt'):
        for world in (1, 2, 4):
            assert common.strategy_fraction(name, world) == jcommon.strategy_fraction(name, world)
    with pytest.raises(ValueError, match='exceed'):
        common.strategy_fraction('comm-opt', 0)
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(8, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 8).astype(np.int32)
    t_logits, t_labels = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(float(common.cross_entropy_loss(t_logits, t_labels, 10)),
                               float(jcommon.cross_entropy_loss(logits, labels, 10)), rtol=1e-6)
    np.testing.assert_allclose(float(common.label_smoothing_loss(t_logits, t_labels, 10, 0.1)),
                               float(jcommon.label_smoothing_loss(logits, labels, 10, 0.1)), rtol=1e-6)
    assert common.accuracy(t_logits, t_labels) == jcommon.accuracy(jnp.asarray(logits), jnp.asarray(labels))


def test_chain_sgd_is_optax(tmp_path):
    """clip_by_global_norm(1.0) + sgd(schedule, 0.9), and
    add_decayed_weights + sgd, over three steps of fixed grads."""
    import optax

    rng = np.random.default_rng(1)
    params = {'a': rng.normal(size=(4, 3)).astype(np.float32), 'b': rng.normal(size=5).astype(np.float32)}
    grads = [{k: (3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    sched = common.make_lr_schedule(0.1, 2, 2, 1, [0.5])
    jsched = jcommon.make_lr_schedule(0.1, 2, 2, 1, [0.5])
    for kw, chain in (
        (dict(clip_norm=1.0), optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(jsched, momentum=0.9))),
        (dict(weight_decay=5e-4), optax.chain(optax.add_decayed_weights(5e-4), optax.sgd(jsched, momentum=0.9))),
    ):
        tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
        opt = common.ChainSGD(tp.values(), sched, momentum=0.9, **kw)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        js = chain.init(jp)
        for g in grads:
            for k, p in tp.items():
                p.grad = torch.from_numpy(g[k])
            opt.step()
            upd, js = chain.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
            jp = optax.apply_updates(jp, upd)
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        state = opt.state_dict()
        other = common.ChainSGD(tp.values(), sched, momentum=0.9, **kw)
        other.load_state_dict(state)
        assert other.count == 3


# ------------------------------------------------------------------- data


def test_lm_corpus_on_disk_and_zipf_equal_jax(tmp_path):
    toks = (np.arange(5000) * 7 % 61).astype(np.int32)
    np.save(tmp_path / 'corpus.npy', toks)
    for meta in ({'size': 64, 'max_token': 60}, {'size': 61}, None):
        vpath = tmp_path / 'vocab.json'
        if vpath.exists():
            vpath.unlink()
        if meta is not None:
            vpath.write_text(json.dumps(meta))
        (got, gv), (want, wv) = data.lm_corpus(str(tmp_path)), jdata.lm_corpus(str(tmp_path))
        assert isinstance(got, np.memmap) and gv == wv
        np.testing.assert_array_equal(got, want)
    vpath.write_text(json.dumps({'size': 60, 'max_token': 60}))
    with pytest.raises(ValueError, match='vocab.json'):
        jdata.lm_corpus(str(tmp_path))
    with pytest.raises(ValueError, match='vocab.json'):
        data.lm_corpus(str(tmp_path))
    (got, gv), (want, wv) = data.lm_corpus(None, 512, n_tokens=20000, seed=3), jdata.lm_corpus(
        None, 512, n_tokens=20000, seed=3)
    assert gv == wv
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('world', [1, 2, 4])
def test_lm_batches_per_rank_rows_are_the_global_batch(world):
    toks = (np.arange(20000) * 13 % 97).astype(np.int32)
    want = list(jdata.lm_batches(toks, 8, 16, seed=7))
    per = [list(data.lm_batches(toks, 8, 16, seed=7, rank=r, world=world)) for r in range(world)]
    assert all(len(p) == len(want) > 0 for p in per)
    for i, (wx, wy) in enumerate(want):
        np.testing.assert_array_equal(np.concatenate([p[i][0] for p in per]), wx)
        np.testing.assert_array_equal(np.concatenate([p[i][1] for p in per]), wy)
        assert per[0][i][0].dtype == wx.dtype


@pytest.mark.parametrize('world', [1, 2, 4])
def test_batches_per_rank_rows_are_the_global_batch(world):
    x = np.random.default_rng(0).normal(size=(70, 3)).astype(np.float32)
    y = np.arange(70).astype(np.int32)
    for drop_last in (True, False) if world == 1 else (True,):
        want = list(jdata.batches(x, y, 8, 5, drop_last=drop_last))
        per = [list(data.batches(x, y, 8, 5, drop_last=drop_last, rank=r, world=world))
               for r in range(world)]
        assert all(len(p) == len(want) for p in per)
        for i, (wx, wy) in enumerate(want):
            np.testing.assert_array_equal(np.concatenate([p[i][0] for p in per]), wx)
            np.testing.assert_array_equal(np.concatenate([p[i][1] for p in per]), wy)
    with pytest.raises(ValueError, match='split'):
        next(data.batches(x, y, 8, 5, rank=0, world=3))


def test_augment_and_normalize_equal_jax():
    x = np.random.default_rng(2).normal(size=(6, 8, 8, 3)).astype(np.float32)
    for pad, flip in ((4, True), (2, False)):
        got = data.augment_images(x, np.random.default_rng(9), pad, flip)
        np.testing.assert_array_equal(got, jdata.augment_images(x, np.random.default_rng(9), pad, flip))
    np.testing.assert_array_equal(data.normalize(x, data.CIFAR10_MEAN, data.CIFAR10_STD),
                                  jdata.normalize(x, jdata.CIFAR10_MEAN, jdata.CIFAR10_STD))
    np.testing.assert_array_equal(data.IMAGENET_MEAN, jdata.IMAGENET_MEAN)
    np.testing.assert_array_equal(data.IMAGENET_STD, jdata.IMAGENET_STD)


def test_cifar_and_imagenet_loaders_equal_jax(tmp_path):
    for got, want in zip(data.cifar10(None, 40, 10), jdata.cifar10(None, 40, 10)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(3)
    npz = {'x_train': rng.normal(size=(12, 32, 32, 3)), 'y_train': rng.integers(0, 10, 12),
           'x_test': rng.normal(size=(4, 32, 32, 3)), 'y_test': rng.integers(0, 10, 4)}
    np.savez(tmp_path / 'cifar10.npz', **npz)
    np.savez(tmp_path / 'imagenet.npz', **npz)
    assert data.cifar_on_disk(str(tmp_path)) and jdata.cifar_on_disk(str(tmp_path))
    for d in (str(tmp_path), None):
        kw = dict(image_size=16, n_train=20, n_test=6, num_classes=7)
        for a, b in ((data.cifar10(d, 40, 10), jdata.cifar10(d, 40, 10)),
                     (data.imagenet_like(d, **kw), jdata.imagenet_like(d, **kw))):
            for got, want in zip(a, b):
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)
    for split in ('train', 'test'):
        np.save(tmp_path / f'imagenet_x_{split}.npy', npz[f'x_{split}'].astype(np.float32))
        np.save(tmp_path / f'imagenet_y_{split}.npy', npz[f'y_{split}'])
    assert data.imagenet_on_disk(str(tmp_path)) == jdata.imagenet_on_disk(str(tmp_path)) is True
    assert data.imagenet_on_disk(None) == jdata.imagenet_on_disk(None) is False
    got, want = data.imagenet_like(str(tmp_path)), jdata.imagenet_like(str(tmp_path))
    assert isinstance(got[0][0], np.memmap)
    for a, b in zip(got, want):
        for g, w in zip(a, b):
            np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------- native loader


@pytest.mark.parametrize('augment', [None, {'pad': 4, 'flip': True}])
def test_prefetch_loader_yields_jaxs_batches(augment):
    """Same seed, augmentation and start epoch: the same batches; a loader
    started at epoch 1 yields the first one's second epoch."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, 40).astype(np.int32)
    mine = native_loader.PrefetchLoader(x, y, batch_size=8, seed=11, augment=augment)
    theirs = jnative.PrefetchLoader(x, y, batch_size=8, seed=11, augment=augment)
    later = native_loader.PrefetchLoader(x, y, batch_size=8, seed=11, augment=augment, start_epoch=1)
    try:
        firsts = []
        for epoch in range(2):
            got, want = list(mine.epoch_batches()), list(theirs.epoch_batches())
            assert len(got) == len(want) == 5
            for (gx, gy), (wx, wy) in zip(got, want):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gy, wy)
            firsts.append(got)
        for (gx, gy), (wx, wy) in zip(later.epoch_batches(), firsts[1]):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    finally:
        mine.close()
        theirs.close()
        later.close()
    assert native_loader.library_path().exists()


def test_native_loader_build_failure_raises(monkeypatch, tmp_path):
    """No quiet fallback: a loader that cannot be built raises, and so does
    a script asked for it."""
    monkeypatch.setattr(native_loader, '_lib', None)
    monkeypatch.setattr(native_loader, 'SOURCE', tmp_path / 'broken.cpp')
    (tmp_path / 'broken.cpp').write_text('this is not C++\n')
    monkeypatch.setattr(native_loader, 'BUILD_DIR', tmp_path / 'build')
    x = np.zeros((16, 4, 4, 3), np.float32)
    with pytest.raises(native_loader.NativeLoaderUnavailable, match='g\\+\\+'):
        native_loader.PrefetchLoader(x, np.zeros(16, np.int32), batch_size=8)
    args = argparse.Namespace(native_loader=True, batch_size=8, seed=0)
    with pytest.raises(native_loader.NativeLoaderUnavailable):
        common.make_epoch_batches(args, x, np.zeros(16, np.int32), augment=False)


# --------------------------------------------------------------- the scripts


def record_steps(monkeypatch):
    """The JAX scripts' per-step values: each ``Metric.update``."""
    seen = []
    real = jcommon.Metric.update

    def update(self, value, n=1):
        seen.append(float(value))
        return real(self, value, n)

    monkeypatch.setattr(jcommon.Metric, 'update', update)
    return seen


LM_ARGV = ['--epochs', '1', '--batch-size', '8', '--seq-len', '16', '--d-model', '32',
           '--num-heads', '4', '--num-layers', '2', '--vocab-size', '128', '--limit-steps', '3',
           '--kfac-factor-update-steps', '1', '--kfac-inv-update-steps', '2']


def jax_lm_params(argv):
    from kfac_tpu.models import TransformerLM

    a = train_language_model.parse_args(argv)
    model = TransformerLM(vocab_size=a.vocab_size, d_model=a.d_model, num_heads=a.num_heads,
                          num_layers=a.num_layers, max_len=a.seq_len, dtype=jnp.float32)
    sample = jnp.zeros((a.batch_size, a.seq_len), jnp.int32)
    return jax.device_get(model.init(jax.random.PRNGKey(a.seed), sample)['params'])


def test_lm_script_matches_jax_dense(monkeypatch):
    """Three steps in one process (the dense engine) against the JAX script
    (its DistributedKFAC over the eight CPU devices) from the same weights:
    per-step losses and the returned perplexity."""
    from examples import train_language_model as jlm

    seen = record_steps(monkeypatch)
    want_ppl = jlm.main(LM_ARGV)
    want = seen[:3]
    monkeypatch.undo()
    params = jax_lm_params(LM_ARGV)
    got = train_language_model.run(train_language_model.parse_args(LM_ARGV + ['--device', 'cpu']),
                                   init_params=lambda grid: convert.from_flax_params(params))
    np.testing.assert_allclose(got['losses'], want, rtol=1e-5)
    np.testing.assert_allclose(got['ppl'], want_ppl, rtol=1e-4)


class _Interrupted(Exception):
    pass


@pytest.mark.parametrize('pipeline', [False, True], ids=['dense', 'interleaved_p1'])
def test_lm_script_resume_equals_the_uninterrupted_run(tmp_path, monkeypatch, pipeline):
    """A two-epoch run under --checkpoint-dir interrupted after epoch 0's
    checkpoint, then the same command with --resume: epoch 1's losses are
    the uninterrupted run's (the epoch boundary is an inverse refresh, so
    the restore's rematerialized decompositions are the ones the
    uninterrupted run computes there)."""
    base = LM_ARGV[2:] + ['--device', 'cpu', '--limit-steps', '2', '--epochs', '2']
    if pipeline:  # one rank, three chunks: the pipeline checkpoints
        base += ['--num-layers', '3', '--pipeline-stages', '1', '--pipeline-schedule', 'interleaved',
                 '--virtual-chunks', '3']
    whole = train_language_model.run(train_language_model.parse_args(base))
    ckpt = str(tmp_path / 'ckpt')
    save = common.save_checkpoint

    def save_then_stop(*args, **kwargs):
        save(*args, **kwargs)
        raise _Interrupted

    monkeypatch.setattr(common, 'save_checkpoint', save_then_stop)
    with pytest.raises(_Interrupted):
        train_language_model.run(train_language_model.parse_args(['--checkpoint-dir', ckpt] + base))
    monkeypatch.undo()
    assert common.latest_checkpoint(ckpt)[1] == 0
    resumed = train_language_model.run(train_language_model.parse_args(
        ['--checkpoint-dir', ckpt, '--resume'] + base))
    assert common.latest_checkpoint(ckpt)[1] == 1
    np.testing.assert_allclose(resumed['losses'], whole['losses'][2:], rtol=1e-7)
    np.testing.assert_allclose(resumed['ppl'], whole['ppl'], rtol=1e-7)


def test_lm_script_refuses_pipeline_with_seq_shards():
    with pytest.raises(SystemExit, match='seq-shards'):
        train_language_model.run(train_language_model.parse_args(
            LM_ARGV + ['--device', 'cpu', '--pipeline-stages', '2', '--seq-shards', '2']))


PIPE_ARGV = ['--epochs', '1', '--batch-size', '16', '--seq-len', '16', '--d-model', '32',
             '--num-heads', '4', '--num-layers', '4', '--vocab-size', '128', '--limit-steps', '3',
             '--kfac-factor-update-steps', '1', '--kfac-inv-update-steps', '2',
             '--pipeline-stages', '2', '--pipeline-schedule', 'interleaved', '--virtual-chunks', '2']
WORLD_ARGV = ['--epochs', '1', '--batch-size', '8', '--seq-len', '16', '--d-model', '32',
              '--num-heads', '4', '--num-layers', '2', '--vocab-size', '128', '--limit-steps', '3',
              '--kfac-factor-update-steps', '1', '--kfac-inv-update-steps', '2',
              '--kfac-strategy', 'hybrid-opt']


# the script's tensor- and sequence-parallel branches on two ranks
SHARDED = {'tp': ['--model-shards', '2'], 'sp': ['--seq-shards', '2']}


def jax_pipe_params(argv):
    from kfac_tpu.parallel import InterleavedPipelinedLM
    from kfac_tpu.parallel.mesh import pipeline_mesh

    a = train_language_model.parse_args(argv)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        plm = InterleavedPipelinedLM(
            mesh=pipeline_mesh(n_stages=a.pipeline_stages), vocab_size=a.vocab_size,
            d_model=a.d_model, num_heads=a.num_heads, num_layers=a.num_layers,
            n_microbatches=a.pipeline_microbatches, max_len=a.seq_len,
            virtual_chunks=a.virtual_chunks,
        )
    return jax.device_get(plm.init(jax.random.PRNGKey(a.seed)))


def locked_world(tag, fn):
    uid = os.environ.get('PYTEST_XDIST_TESTRUNUID')
    if uid is None:
        return fn()
    path = os.path.join(tempfile.gettempdir(), f'kfac_torch_examples_{tag}_{uid}.pkl')
    with open(path + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            with open(path, 'rb') as f:
                return pickle.load(f)
        out = fn()
        with open(path + '.tmp', 'wb') as f:
            pickle.dump(out, f)
        os.replace(path + '.tmp', path)
        return out


def run_world():
    spec = {
        'interleaved': dict(argv=PIPE_ARGV, params=jax_pipe_params(PIPE_ARGV), pipeline=True),
        'hybrid': dict(argv=WORLD_ARGV, params=jax_lm_params(WORLD_ARGV)),
    }
    for name, flags in SHARDED.items():
        spec[name] = dict(argv=LM_ARGV + flags, params=jax_lm_params(LM_ARGV + flags))
    return spawn_world(ranks.run, 2, 'gloo', 'cpu', args=(spec,), timeout_s=600)


@pytest.fixture(scope='module')
def world():
    return locked_world('world', run_world)


def test_lm_script_interleaved_pipeline_matches_jax(world, monkeypatch):
    """--pipeline-stages 2 --pipeline-schedule interleaved on two gloo
    ranks against the JAX script's InterleavedPipelinedLM from the same
    weights: every rank's per-step losses and perplexity."""
    from examples import train_language_model as jlm

    seen = record_steps(monkeypatch)
    want_ppl = jlm.main(PIPE_ARGV)
    want = seen[:3]
    for r in range(2):
        np.testing.assert_allclose(world[r]['interleaved']['losses'], want, rtol=1e-5)
        np.testing.assert_allclose(world[r]['interleaved']['ppl'], want_ppl, rtol=1e-4)


def test_lm_script_per_rank_loader_matches_jax(world, monkeypatch):
    """--kfac-strategy hybrid-opt on two gloo ranks: each rank's loader read
    its row block, the blocks concatenated are the global batch, and the
    losses follow the JAX script's."""
    from examples import train_language_model as jlm

    seen = record_steps(monkeypatch)
    jlm.main(WORLD_ARGV)
    want = seen[:3]
    a = train_language_model.parse_args(WORLD_ARGV)
    tokens, _ = jdata.lm_corpus(None, a.vocab_size)
    batches = jdata.lm_batches(tokens, a.batch_size, a.seq_len, a.seed)
    for i, (gx, _) in zip(range(3), batches):
        np.testing.assert_array_equal(np.concatenate([world[r]['hybrid']['rows'][i] for r in range(2)]), gx)
    for r in range(2):
        assert world[r]['hybrid']['loader_rows'] == (2, r)
        np.testing.assert_allclose(world[r]['hybrid']['losses'], want, rtol=1e-4)


RESNET_ARGV = ['--epochs', '1', '--batch-size', '16', '--limit-steps', '2',
               '--kfac-factor-update-steps', '1', '--kfac-inv-update-steps', '1']


def jax_resnet_variables(name, argv, num_classes, image_size):
    from kfac_tpu.models import resnet as jresnet

    model = getattr(jresnet, name)(num_classes=num_classes, dtype=jnp.float32)
    sample = jnp.zeros((16, image_size, image_size, 3), jnp.float32)
    return jax.device_get(model.init(jax.random.PRNGKey(42), sample, train=True))


@pytest.mark.parametrize('script', ['cifar', 'imagenet'])
def test_resnet_scripts_match_jax(script, monkeypatch):
    """Two steps of each ResNet script on its synthetic data from the JAX
    weights and batch statistics: the losses of the JAX script."""
    if script == 'cifar':
        from examples import train_cifar_resnet as jscript

        argv, port, name, classes, size = RESNET_ARGV, train_cifar_resnet, 'resnet20', 10, 32
    else:
        from examples import train_imagenet_resnet as jscript

        argv = RESNET_ARGV + ['--arch', 'resnet20', '--image-size', '16']
        port, name, classes, size = train_imagenet_resnet, 'resnet20', 1000, 16
    seen = record_steps(monkeypatch)
    jscript.main(argv)
    want = seen[:2]
    monkeypatch.undo()
    variables = jax_resnet_variables(name, argv, classes, size)

    def init(grid):
        return (convert.from_flax_params(variables['params']),
                convert.from_flax_batch_stats(variables['batch_stats']))

    got = port.run(port.parse_args(argv + ['--device', 'cpu']), init_params=init)
    np.testing.assert_allclose(got['losses'][0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got['losses'][1], want[1], rtol=1e-4)


# ------------------------------------------------------------------ char_lm


def test_char_lm_corpus_and_data_equal_jax():
    import bench_accuracy as jbench

    np.testing.assert_array_equal(bench_accuracy.docs_corpus(), jbench._docs_corpus())
    for depth in ('small', 'deep'):
        task = jbench._task_char_lm(depth)
        (xtr, ytr), (xte, yte) = bench_accuracy.char_lm_data(bench_accuracy.CHAR_LM[depth]['seq'])
        np.testing.assert_array_equal(xtr, np.asarray(task['data'][0]))
        np.testing.assert_array_equal(ytr, np.asarray(task['data'][1]))
        port = bench_accuracy.task_char_lm('cpu', depth)
        for key in ('batch', 'lr', 'higher_better', 'metric', 'max_steps', 'eval_every',
                    'register_kwargs', 'kfac_kwargs'):
            assert port[key] == task[key], key
        # the same widths, heads and depth: the JAX parameters load as they are
        model = port['model'](0)
        jparams = task['model'].init(jax.random.PRNGKey(0), task['example'])['params']
        want = {k: tuple(v.shape) for k, v in convert.from_flax_params(jax.device_get(jparams)).items()}
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
        assert task['model'].num_heads == 4 and model.get_submodule('block0.attn').num_heads == 4


@pytest.mark.parametrize('depth', ['small', 'deep'])
def test_char_lm_three_kfac_steps_match_jax(depth):
    """The task's model from the JAX weights: the held-out loss, then three
    K-FAC steps of the task's Trainer (cadence 1/2 here, so the factors and
    a refresh run) against the JAX Trainer's."""
    import bench_accuracy as jbench
    import kfac_tpu
    import optax
    from kfac_tpu import training

    task = jbench._task_char_lm(depth)
    variables = task['model'].init(jax.random.PRNGKey(0), task['example'])
    reg = kfac_tpu.register_model(task['model'], task['example'], **task['register_kwargs'])
    kw = dict(task['kfac_kwargs'], factor_update_steps=1, inv_update_steps=2)
    trainer = training.Trainer(loss_fn=task['loss_fn'], optimizer=optax.sgd(task['lr'], momentum=0.9),
                               kfac=kfac_tpu.KFACPreconditioner(registry=reg, lr=task['lr'], **kw))
    state = trainer.init(variables['params'])
    xtr, ytr = task['data']
    want = []
    for i in range(3):
        state, loss = trainer.step(state, (xtr[16 * i:16 * i + 16], ytr[16 * i:16 * i + 16]))
        want.append(float(loss))
    want_eval = float(task['evaluate'](state.params, None))

    port = bench_accuracy.task_char_lm('cpu', depth)
    port['kfac_kwargs'] = kw
    model = port['model'](0)
    model.load_state_dict(convert.from_flax_params(jax.device_get(variables['params'])))
    ptrainer = bench_accuracy.build_trainer(port, True, model=model)
    pstate = ptrainer.init()
    got = []
    for i in range(3):
        pstate, loss = ptrainer.step(pstate, bench_accuracy.batch_at(port, i))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(port['evaluate'](model, None), want_eval, rtol=1e-5)


# -------------------------------------------------------- flash head dims


@pytest.mark.parametrize('shape', [(16, 64, 4, 16), (2, 100, 3, 16), (2, 96, 8, 64), (1, 40, 2, 64)])
@pytest.mark.parametrize('offsets', [(0, 0), (64, 0), (0, 32)])
def test_plain_flash_partials_at_head_dims_16_and_64_match_jax(shape, offsets):
    from kfac_tpu.ops import pallas_attention

    rng = np.random.default_rng(sum(shape))
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    got = flash_attention.attend_partials_einsum(
        *(torch.from_numpy(t) for t in (q, k, v)), offsets[0], offsets[1], True)
    want = pallas_attention.attend_partials_einsum(q, k, v, offsets[0], offsets[1], True)
    assert shape[-1] in flash_attention.HEAD_DIMS
    for g, w in zip(got, want):
        w = np.asarray(w).reshape(g.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6 * float(np.abs(w).max()))


@pytest.mark.parametrize('name', sorted(SHARDED))
def test_lm_script_model_and_seq_shards_match_jax(world, monkeypatch, name):
    """--model-shards 2 (Megatron layouts) and --seq-shards 2 (ring
    attention) on two gloo ranks against the JAX script with the same flags
    (its mesh over the eight CPU devices): every rank's per-step losses."""
    from examples import train_language_model as jlm

    seen = record_steps(monkeypatch)
    jlm.main(LM_ARGV + SHARDED[name])
    want = seen[:3]
    for r in range(2):
        assert world[r][name]['loader_rows'] == (1, 0)
        np.testing.assert_allclose(world[r][name]['losses'], want, rtol=1e-4)
