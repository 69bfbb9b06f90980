"""The port's Trainer against the JAX package's, from the same weights.

Both run the bench's LM loop at a small size (batch 2, seq 32, d_model 64,
2 layers, 4 heads, vocab 128) with SGD(0.1, momentum 0.9), weights carried
over by ``convert.from_flax_params``. Tolerances, as in
``test_torch_preconditioner.py``: losses rtol 1e-5; parameter updates rtol
1e-4 with atol 1e-4 x the largest update; factors rtol 1e-4 with atol
1e-4 x the factor's max.
"""

import fcntl
import logging
import os
import pickle
import tempfile
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kfac_tpu
from kfac_tpu import tracing as jtracing
from kfac_tpu import training as jtraining
from kfac_tpu import warnings as jwarnings
from kfac_tpu.layers import capture as jcapture
from kfac_tpu.models import TransformerLM as JaxLM
from kfac_tpu.models import lm_loss as jax_lm_loss
from kfac_tpu.observability import ledger as jledger
from kfac_tpu_torch import convert, tracing
from kfac_tpu_torch import warnings as twarnings
from kfac_tpu_torch.layers import capture, registry
from kfac_tpu_torch.models import TransformerLM, lm_loss
from kfac_tpu_torch.observability import ledger
from kfac_tpu_torch.preconditioner import KFACPreconditioner
from kfac_tpu_torch.training import Trainer, TrainState

CFG = dict(vocab_size=128, d_model=64, num_heads=4, num_layers=2, max_len=32)
STEPS = 12
# capture steps at 0 and 10, refreshes at 0, 5 and 10
KFAC = dict(damping=0.003, lr=0.1, factor_update_steps=10, inv_update_steps=5)
# accumulation: capture on even steps, so micro-batches run both branches
ACCUM_KFAC = dict(damping=0.003, lr=0.1, factor_update_steps=2, inv_update_steps=2)


def tokens(seed, batch=2):
    t = np.random.default_rng(seed).integers(0, CFG['vocab_size'], (batch, 32)).astype(np.int32)
    return t, np.roll(t, -1, axis=1)


def close(got, want, rtol=1e-4, atol_rel=1e-4, msg=''):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * float(np.max(np.abs(want))), err_msg=msg
    )


def close_params(got, jax_params, init_params):
    """Each parameter's update since ``init_params``, rtol 1e-4 with atol
    1e-4 x the largest update of any parameter (as the preconditioner test
    scales grads by the step's max): some updates are rounding noise, as the
    key biases', whose gradient is zero in exact arithmetic."""
    init = convert.from_flax_params(init_params)
    want = {
        n: w.numpy() - init[n].numpy()
        for n, w in convert.from_flax_params(jax.device_get(jax_params)).items()
    }
    scale = max(float(np.max(np.abs(w))) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name].detach().numpy() - init[name].numpy(), w, rtol=1e-4,
            atol=1e-4 * scale, err_msg=name,
        )


def close_factors(tstate, jstate):
    for tside, jside in ((tstate.a, jstate.a), (tstate.g, jstate.g)):
        assert set(tside) == set(jside)
        for name, want in jside.items():
            close(tside[name], want, msg=name)


def jax_trainer(kfac_kw):
    t, _ = tokens(0)
    model = JaxLM(**CFG)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(t))['params']
    loss = jax_lm_loss(model)
    kfac = None
    if kfac_kw is not None:
        reg = kfac_tpu.register_model(model, jnp.asarray(t), skip_layers=['lm_head'])
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')  # inverse cadence not a multiple
            kfac = kfac_tpu.KFACPreconditioner(registry=reg, **kfac_kw)
    trainer = jtraining.Trainer(
        loss_fn=lambda p, ms, b: (loss(p, b), ms),
        optimizer=optax.sgd(0.1, momentum=0.9), kfac=kfac,
    )
    return trainer, trainer.init(params), jax.device_get(params)


def torch_trainer(init_params, kfac_kw):
    model = TransformerLM(**CFG, device='cpu')
    if init_params is not None:
        model.load_state_dict(convert.from_flax_params(init_params))
    kfac = None
    if kfac_kw is not None:
        reg = registry.register_model(model, skip_layers=['lm_head'], device='cpu')
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            kfac = KFACPreconditioner(reg, **kfac_kw, device='cpu')
    loss = lm_loss(model)
    trainer = Trainer(
        model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        lambda ms, b: (loss(b), ms), kfac=kfac, device='cpu',
    )
    return trainer, trainer.init(), model


def jbatch(seed):
    return tuple(jnp.asarray(x) for x in tokens(seed))


def tbatch(seed):
    return tuple(torch.from_numpy(x).long() for x in tokens(seed))


@pytest.mark.parametrize('kfac_kw', [KFAC, None], ids=['kfac', 'sgd'])
def test_step_matches_jax(kfac_kw):
    jt, js, init = jax_trainer(kfac_kw)
    tt, ts, model = torch_trainer(init, kfac_kw)
    jl, tl = [], []
    for i in range(STEPS):
        js, l = jt.step(js, jbatch(i))
        jl.append(float(l))
        ts, l = tt.step(ts, tbatch(i))
        assert l.shape == () and l.device.type == 'cpu'
        tl.append(float(l))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    close_params(model.state_dict(), js.params, init)
    if kfac_kw is None:
        assert ts.kfac_state is None and js.kfac_state is None
    else:
        assert ts.kfac_state.step == int(js.kfac_state.step) == STEPS
        close_factors(ts.kfac_state, js.kfac_state)


def test_scan_steps_matches_jax():
    jt, js, init = jax_trainer(KFAC)
    tt, ts, model = torch_trainer(init, KFAC)
    seeds = range(STEPS)
    js, jl = jt.scan_steps(
        js, tuple(jnp.stack([jbatch(i)[k] for i in seeds]) for k in range(2))
    )
    ts, tl = tt.scan_steps(
        ts, tuple(torch.stack([tbatch(i)[k] for i in seeds]) for k in range(2))
    )
    assert tl.shape == (STEPS,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    close_params(model.state_dict(), js.params, init)
    close_factors(ts.kfac_state, js.kfac_state)
    # the host cadence stays aligned after the loop: step 12 is no capture
    assert tt._step_count == STEPS and not tt._capture_now()


@pytest.fixture(scope='module')
def accumulation_runs():
    """:func:`run_accumulation` once per test run: under pytest-xdist the
    first worker to need it computes it under a file lock and leaves it in
    the temporary directory, keyed by the run's id, for the others (as
    ``tests/test_torch_kaisa.py``'s worlds)."""
    uid = os.environ.get('PYTEST_XDIST_TESTRUNUID')
    if uid is None:
        return run_accumulation()
    path = os.path.join(tempfile.gettempdir(), f'kfac_torch_training_accumulation_{uid}.pkl')
    with open(path + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            with open(path, 'rb') as f:
                return pickle.load(f)
        out = run_accumulation()
        with open(path + '.tmp', 'wb') as f:
            pickle.dump(out, f)
        os.replace(path + '.tmp', path)
        return out


def run_accumulation():
    """Three ``step_accumulate`` steps over two micro-batches, then one
    incremental step that accumulates a micro-batch, drops it with
    ``reset_batch`` and applies two others, on each package."""
    micro = [[2 * i, 2 * i + 1] for i in range(3)]
    jt, js, init = jax_trainer(ACCUM_KFAC)
    tt, ts, model = torch_trainer(init, ACCUM_KFAC)
    out = {'jax': {'losses': []}, 'torch': {'losses': []}}
    for seeds in micro:
        js, l = jt.step_accumulate(js, [jbatch(s) for s in seeds])
        out['jax']['losses'].append(float(l))
        ts, l = tt.step_accumulate(ts, [tbatch(s) for s in seeds])
        out['torch']['losses'].append(float(l))
    out['jax']['params'] = jax.device_get(js.params)
    out['torch']['params'] = {k: v.clone() for k, v in model.state_dict().items()}
    out['torch']['factors'] = ts.kfac_state
    out['jax']['factors'] = jax.device_get(js.kfac_state)
    for trainer, state, batch, side in ((jt, js, jbatch, 'jax'), (tt, ts, tbatch, 'torch')):
        trainer.accumulate_microbatch(state, batch(50))
        trainer.reset_batch()
        mb_losses = [float(trainer.accumulate_microbatch(state, batch(s))) for s in (51, 52)]
        state, l = trainer.apply_accumulated(state)
        out[side].update(mb_losses=mb_losses, loss=float(l), state=state)
    out['model'], out['init'] = model, init
    return out


def test_step_accumulate_matches_jax(accumulation_runs):
    jax_run, torch_run = accumulation_runs['jax'], accumulation_runs['torch']
    np.testing.assert_allclose(torch_run['losses'], jax_run['losses'], rtol=1e-5)
    close_params(torch_run['params'], jax_run['params'], accumulation_runs['init'])
    # step 2 captured: factors averaged over both micro-batches
    assert torch_run['factors'].step == 3
    close_factors(torch_run['factors'], jax_run['factors'])


def test_incremental_accumulation_matches_jax(accumulation_runs):
    jax_run, torch_run = accumulation_runs['jax'], accumulation_runs['torch']
    np.testing.assert_allclose(torch_run['mb_losses'], jax_run['mb_losses'], rtol=1e-5)
    np.testing.assert_allclose(torch_run['loss'], jax_run['loss'], rtol=1e-5)
    np.testing.assert_allclose(torch_run['loss'], np.mean(torch_run['mb_losses']), rtol=1e-6)
    close_params(accumulation_runs['model'].state_dict(), jax_run['state'].params,
                 accumulation_runs['init'])
    assert torch_run['state'].kfac_state.step == 4


def test_step_accumulate_scan_equals_step_accumulate():
    stacked = tuple(torch.stack([tbatch(s)[k] for s in (0, 1)]) for k in range(2))
    results = []
    for scan in (False, True):
        trainer, state, model = torch_trainer(None, ACCUM_KFAC)
        if scan:
            state, loss = trainer.step_accumulate_scan(state, stacked)
        else:
            state, loss = trainer.step_accumulate(state, [tbatch(0), tbatch(1)])
        results.append((loss, model.state_dict(), state.kfac_state.a))
    (l0, p0, a0), (l1, p1, a1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(a0[k], a1[k]) for k in a0)


def small_trainer(kfac_kw=None, engine=None, **kw):
    """A one-layer trainer; ``engine(kfac)`` may wrap the preconditioner."""
    model = torch.nn.Sequential(torch.nn.Linear(4, 3))
    reg = registry.register_model(model, device='cpu')
    kfac = KFACPreconditioner(reg, device='cpu', **(kfac_kw or {}))

    def loss_fn(ms, batch):
        return model(batch).square().mean(), ms

    return Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1), loss_fn,
                   kfac=engine(kfac) if engine else kfac, device='cpu', **kw)


@pytest.mark.parametrize('knob', ['checkpoints', 'auto_layout', 'fleet'])
def test_later_slice_knobs_raise(knob, tmp_path):
    if knob == 'checkpoints':
        # ported since: the trainer binds the manager instead of raising
        from kfac_tpu_torch.resilience import CheckpointManager

        mgr = CheckpointManager(tmp_path, install_signals=())
        trainer = small_trainer(checkpoints=mgr)
        assert mgr.engine is trainer.kfac
        assert mgr.extras_of == trainer.checkpoint_extras
        with pytest.raises(ValueError, match='requires a kfac'):
            Trainer(trainer.model, trainer.optimizer, trainer.loss_fn, device='cpu', checkpoints=mgr)
        return
    with pytest.raises(NotImplementedError, match=knob):
        small_trainer(**{knob: object()})


def test_health_skip_nonfinite_raises():
    # skip_nonfinite raised before the sentinel was ported; now a Trainer
    # takes it, and, as the JAX Trainer does, gates only a state that
    # carries health counters: this engine's state has none, so even a
    # non-finite step goes through
    model = torch.nn.Sequential(torch.nn.Linear(4, 3))
    reg = registry.register_model(model, device='cpu')
    calls = []
    engine = SimpleNamespace(
        registry=reg, factor_update_steps=1, init=lambda: SimpleNamespace(step=0),
        step=lambda state, grads, stats: (calls.append(stats) or state, grads),
        health=SimpleNamespace(skip_nonfinite=True, warn=False),
    )
    trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1),
                      lambda ms, b: (model(b).sum(), ms), kfac=engine, device='cpu')
    state, loss = trainer.step(trainer.init(), torch.full((2, 4), float('nan')))
    assert len(calls) == 1 and torch.isnan(loss)


def test_misuse_raises():
    trainer = small_trainer()
    state = trainer.init()
    x = torch.ones(2, 4)
    with pytest.raises(ValueError, match='no pending'):
        trainer.apply_accumulated(state)
    trainer.accumulate_microbatch(state, x)
    with pytest.raises(ValueError, match='pending'):
        trainer.step_accumulate(state, [x])
    other = torch.nn.Linear(4, 3)
    with pytest.raises(ValueError, match='another model'):
        Trainer(other, torch.optim.SGD(other.parameters(), lr=0.1),
                lambda ms, b: (other(b).sum(), ms), kfac=trainer.kfac, device='cpu')
    sgd = Trainer(other, torch.optim.SGD(other.parameters(), lr=0.1),
                  lambda ms, b: (other(b).sum(), ms), device='cpu')
    with pytest.raises(ValueError, match='requires a kfac'):
        sgd.step_accumulate(sgd.init(), [x])


def test_kfac_step_gets_the_loss_when_it_takes_one():
    seen = []

    def engine(kfac):
        def step(state, grads, stats, loss=None):
            seen.append(loss)
            return kfac.step(state, grads, stats)

        return SimpleNamespace(registry=kfac.registry, init=kfac.init, step=step,
                               factor_update_steps=1)

    trainer = small_trainer(engine=engine)
    state, loss = trainer.step(trainer.init(), torch.ones(2, 4))
    assert len(seen) == 1 and seen[0] is loss


def test_resume_aligns_the_cadence_with_a_restored_state():
    trainer = small_trainer(kfac_kw=dict(factor_update_steps=3, inv_update_steps=3))
    state = trainer.init()
    state.kfac_state.step = 7
    trainer.resume(state)
    assert not trainer._capture_now()  # 7 % 3
    state.kfac_state.step = 9
    trainer.resume(state)
    assert trainer._capture_now()


# ------------------------------------------------------------ tracing


@pytest.fixture
def clean_traces():
    tracing.clear_trace()
    jtracing.clear_trace()
    yield
    tracing.clear_trace()
    jtracing.clear_trace()
    tracing.force_sync(False)
    jtracing.force_sync(False)


def test_trace_table_matches_jax(clean_traces, caplog):
    for mod in (tracing, jtracing):
        work = mod.trace(name='stage')(lambda x: x + 1)
        for i in range(5):
            work(i)
        mod.trace()(lambda: None)()
        assert mod.scope('in_step')(lambda: 3)() == 3
    ours, theirs = tracing.get_trace(), jtracing.get_trace()
    assert set(ours) == set(theirs) == {'stage', '<lambda>'}
    assert len(tracing._func_traces['stage']) == len(jtracing._func_traces['stage']) == 5
    times = tracing._func_traces['stage']
    assert tracing.get_trace(average=False)['stage'] == pytest.approx(sum(times))
    assert tracing.get_trace(max_history=2)['stage'] == pytest.approx(sum(times[-2:]) / 2)
    with caplog.at_level(logging.INFO, logger=tracing.logger.name):
        tracing.log_trace()
    assert [r.getMessage().split(':')[1] for r in caplog.records] == [' <lambda>', ' stage']
    tracing.clear_trace()
    assert tracing.get_trace() == {}


def test_force_sync_and_trainer_entries_are_traced(clean_traces, monkeypatch):
    synced = []
    monkeypatch.setattr(tracing, '_block_all', synced.append)
    assert not tracing.sync_forced()
    tracing.force_sync(True)
    assert tracing.sync_forced()
    trainer = small_trainer()
    state, _ = trainer.step(trainer.init(), torch.ones(2, 4))
    state, _ = trainer.scan_steps(state, torch.ones(3, 2, 4))
    trainer.step_accumulate(state, [torch.ones(2, 4)])
    assert set(tracing.get_trace()) == {
        'trainer/step', 'trainer/scan_steps', 'trainer/step_accumulate'
    }
    assert len(synced) == 3 and isinstance(synced[0][0], TrainState)
    assert trainer.step.__kfac_scope__ == 'trainer/step'


def test_block_all_finds_every_tensor():
    x = torch.ones(2)
    tree = ({'a': [x, 3]}, TrainState(kfac_state=None, model_state=(x,)))
    assert len(list(tracing._tensors(tree))) == 2
    tracing._block_all(tree)  # CPU tensors: nothing to wait for


# ---------------------------------------------------- ledger and warnings


def test_run_header_matches_jax_ledger():
    assert ledger.LEDGER_SCHEMA == jledger.LEDGER_SCHEMA
    assert ledger.run_header('abc', 'metrics') == jledger.run_header('abc', 'metrics')
    run_id = ledger.new_run_id()
    assert len(run_id) == 12 and int(run_id, 16) >= 0
    trainer = small_trainer(run_id='r1')
    assert trainer.run_header('metrics') == jledger.run_header('r1', 'metrics')
    assert len(small_trainer().run_id) == 12


@pytest.mark.parametrize(
    'channel,args,category',
    [
        ('health', ('layer0', 3, 'quarantined', 'bad inverse'), 'NumericalHealthWarning'),
        ('layout', ('fingerprint mismatch', 'world 8 vs 4'), 'LayoutPlanWarning'),
        ('fleet', ('retune', 'drift'), 'FleetWarning'),
    ],
)
def test_warning_channels_match_jax(channel, args, category):
    messages = []
    for mod in (twarnings, jwarnings):
        getattr(mod, f'reset_{channel}_warnings')()
        with pytest.warns(getattr(mod, category)) as record:
            assert getattr(mod, f'warn_{channel}_event')(*args)
        assert not getattr(mod, f'warn_{channel}_event')(*args)  # once per key
        getattr(mod, f'reset_{channel}_warnings')()
        messages.append(str(record[0].message))
    assert messages[0] == messages[1]


def test_accumulate_and_average_stats_match_jax():
    rng = np.random.default_rng(3)
    names = ('l0', 'l1')
    raw = [
        {n: (rng.standard_normal((3, 3)).astype(np.float32),
             rng.standard_normal((2, 2)).astype(np.float32)) for n in names}
        for _ in range(3)
    ]
    tacc = jacc = None
    for step in raw:
        tacc = capture.accumulate_stats(tacc, capture.CapturedStats(
            a={n: torch.from_numpy(v[0]) for n, v in step.items()},
            g={n: torch.from_numpy(v[1]) for n, v in step.items()},
        ))
        jacc = jcapture.accumulate_stats(jacc, jcapture.CapturedStats(
            a={n: jnp.asarray(v[0]) for n, v in step.items()},
            g={n: jnp.asarray(v[1]) for n, v in step.items()},
            w={},
        ))
    tavg, javg = capture.average_stats(tacc, 3), jcapture.average_stats(jacc, 3)
    for side in ('a', 'g'):
        for n in names:
            close(getattr(tavg, side)[n], getattr(javg, side)[n], rtol=1e-6, atol_rel=1e-7)
