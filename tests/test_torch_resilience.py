"""The port's checkpoint autopilot (``kfac_tpu_torch.resilience``), one
counterpart for each dense case of ``tests/test_resilience.py``.

Rotation invariants (fresh step dirs, atomic LATEST pointer, keep-N
pruning), the signal machinery (flag-only handlers, exit outranks continue,
storms dropped during a save), ``on_step``'s emergency flush, torn-write
fallback through this file's own corruption helper, retry and backoff, the
``Trainer``'s periodic saves and resume continuity, the postmortem's
emergency checkpoint, and a real ``kill -TERM`` of
``kfac_tpu_torch.resilience.worker`` followed by a second process that
resumes.
"""

import gc
import json
import os
import signal as signal_mod
import subprocess
import sys
import time
import warnings as warnings_mod

import numpy as np
import pytest
import torch

from kfac_tpu_torch import checkpoint, health
from kfac_tpu_torch.layers import capture, registry
from kfac_tpu_torch.models import MLP
from kfac_tpu_torch.observability import flight_recorder
from kfac_tpu_torch.preconditioner import KFACPreconditioner
from kfac_tpu_torch.resilience import CheckpointManager, Preempted, signals
from kfac_tpu_torch.training import Trainer
from kfac_tpu_torch.warnings import CheckpointResilienceWarning

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CORRUPTIONS = ('truncate', 'delete', 'metadata', 'torn_latest')


def corrupt_checkpoint(path: str, mode: str = 'truncate') -> str:
    """Corrupt a committed port checkpoint directory, deterministically.

    ``truncate`` cuts the payload (the largest file) to half, ``delete``
    removes it, ``metadata`` removes the commit marker (the checkpoint no
    longer looks committed), ``torn_latest`` tears the rotation's LATEST
    pointer (``path`` is then the rotation root): truncated to half, four
    garbage bytes appended. Returns the victim's path.
    """
    if mode not in CORRUPTIONS:
        raise ValueError(f'unknown corruption mode {mode!r}; expected one of {CORRUPTIONS}')
    if not os.path.isdir(path):
        raise FileNotFoundError(f'checkpoint dir {path!r} does not exist')
    if mode == 'torn_latest':
        victim = os.path.join(path, 'LATEST')
        size = os.path.getsize(victim)  # FileNotFoundError without a pointer
        with open(victim, 'r+b') as f:
            f.truncate(size // 2)
            f.seek(0, os.SEEK_END)
            f.write(b'\xde\xad\xbe\xef')
        return victim
    if mode == 'metadata':
        victim = os.path.join(path, checkpoint.COMMIT_MARKER)
        os.remove(victim)
        return victim
    files = sorted(os.listdir(path), key=lambda n: (-os.path.getsize(os.path.join(path, n)), n))
    victim = os.path.join(path, files[0])
    if mode == 'delete':
        os.remove(victim)
    else:
        with open(victim, 'r+b') as f:
            f.truncate(os.path.getsize(victim) // 2)
    return victim


@pytest.fixture(autouse=True)
def _clean_signal_state():
    signals.reset()
    yield
    signals.reset()


def _data():
    r = np.random.default_rng(1)
    x = r.standard_normal((32, 6)).astype(np.float32)
    y = np.tanh(x @ r.standard_normal((6, 4))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _dense_setup(**kfac_kw):
    model = MLP(6, (8,), 4, seed=0, device='cpu')
    reg = registry.register_model(model, device='cpu')
    kfac = KFACPreconditioner(reg, kl_clip=None, device='cpu', **kfac_kw)
    return model, _data(), kfac


def _loss(model):
    return lambda ms, b: (torch.mean((model(b[0]) - b[1]) ** 2), ms)


def _run_steps(kfac, model, batch, state=None, steps=1, poison=None):
    run = capture.CurvatureCapture(kfac.registry).value_stats_and_grad(
        lambda b: torch.mean((model(b[0]) - b[1]) ** 2)
    )
    state = kfac.init() if state is None else state
    for _ in range(steps):
        (_, _), grads, stats = run(batch)
        if poison is not None:
            stats.a[poison] = stats.a[poison] * 1e12
        state, pg = kfac.step(state, grads, stats, loss=torch.tensor(1.0))
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= 0.05 * pg[n]
    return state


def _precondition(kfac, state, model, batch):
    (_, _), grads, _ = capture.CurvatureCapture(kfac.registry).value_stats_and_grad(
        lambda b: torch.mean((model(b[0]) - b[1]) ** 2)
    )(batch)
    return kfac.precondition(state, grads)


# ------------------------------------------------------------------ rotation


def test_rotation_keep_and_atomic_latest_pointer(tmp_path):
    model, batch, kfac = _dense_setup()
    mgr = CheckpointManager(
        tmp_path, engine=kfac, save_interval_steps=2, keep=2, install_signals=(),
    )
    state = None
    for _ in range(6):
        state = _run_steps(kfac, model, batch, state=state)
        mgr.on_step(state)
    mgr.finalize()
    # saved on cadence at steps 2, 4, 6; keep=2 pruned step 2
    assert mgr.rotation_steps() == [6, 4]
    assert mgr.latest_step() == 6
    with open(tmp_path / 'LATEST') as f:
        assert f.read().strip() == 'step_00000006'
    assert not os.path.exists(mgr.step_dir(2))
    for s in (4, 6):
        assert mgr._is_committed(s)
        assert os.path.exists(mgr.checkpoint_path(s) + '.manifest.json')
    # no temporary sibling is left behind
    assert sorted(os.listdir(mgr.step_dir(6))) == ['ckpt', 'ckpt.manifest.json']


def test_restore_latest_roundtrip_and_empty_rotation(tmp_path):
    model, batch, kfac = _dense_setup()
    state = _run_steps(kfac, model, batch, steps=2)
    mgr = CheckpointManager(tmp_path, engine=kfac, install_signals=(), async_save=False)
    path = mgr.save(state)
    result = mgr.restore_latest()
    assert result.step == 2 and result.path == path and result.extra == {}
    assert torch.equal(result.state.a['head'], state.a['head'])
    p1 = _precondition(kfac, state, model, batch)
    p2 = _precondition(kfac, result.state, model, batch)
    for n in p1:
        torch.testing.assert_close(p1[n], p2[n], rtol=1e-5, atol=1e-7)
    # an empty rotation: None; a manager without an engine cannot restore
    assert CheckpointManager(tmp_path / 'e', engine=kfac, install_signals=()).restore_latest() is None
    with pytest.raises(ValueError, match='engine'):
        CheckpointManager(tmp_path / 'other', install_signals=()).restore_latest()


# the newest payload torn (or its marker gone, or LATEST torn, or both): the
# walk restores the newest intact entry
@pytest.mark.parametrize('modes,restored', [
    (('truncate',), 1), (('delete',), 1), (('metadata',), 1),
    (('torn_latest',), 2), (('torn_latest', 'truncate'), 1),
])
def test_restore_falls_back_past_torn_checkpoint(tmp_path, modes, restored):
    model, batch, kfac = _dense_setup()
    mgr = CheckpointManager(tmp_path, engine=kfac, install_signals=(), async_save=False, keep=3)
    state = _run_steps(kfac, model, batch)
    mgr.save(state)
    state = _run_steps(kfac, model, batch, state=state)
    newest = mgr.save(state)
    assert mgr.latest_step() == 2
    for mode in modes:
        victim = corrupt_checkpoint(str(tmp_path) if mode == 'torn_latest' else newest, mode)
        if mode == 'torn_latest':
            assert victim == os.path.join(str(tmp_path), 'LATEST')
            assert mgr.latest_step() is None  # garbage reads as no pointer
    if restored == 1:
        with pytest.warns(CheckpointResilienceWarning, match='falling back'):
            result = mgr.restore_latest()
    else:
        result = mgr.restore_latest()
    assert result.step == restored and result.state.step == restored
    assert result.path == mgr.checkpoint_path(restored)
    # rate-limited per path: a second walk stays quiet about the same corpse
    with warnings_mod.catch_warnings():
        warnings_mod.simplefilter('error', CheckpointResilienceWarning)
        assert mgr.restore_latest().step == restored


def test_corrupt_checkpoint_rejects_unknown_mode(tmp_path):
    with pytest.raises(ValueError, match='unknown corruption mode'):
        corrupt_checkpoint(str(tmp_path), mode='bitflip')
    with pytest.raises(FileNotFoundError):
        corrupt_checkpoint(str(tmp_path / 'nope'), mode='truncate')
    with pytest.raises(FileNotFoundError):
        corrupt_checkpoint(str(tmp_path), mode='torn_latest')  # no LATEST


def test_restore_latest_every_candidate_corrupt_returns_none(tmp_path):
    model, batch, kfac = _dense_setup()
    mgr = CheckpointManager(tmp_path, engine=kfac, install_signals=(), async_save=False, keep=3)
    state, paths = None, []
    for _ in range(3):
        state = _run_steps(kfac, model, batch, state=state)
        paths.append(mgr.save(state))
    assert mgr.rotation_steps() == [3, 2, 1]
    for path in paths:
        corrupt_checkpoint(path, mode='truncate')
    with warnings_mod.catch_warnings(record=True) as caught:
        warnings_mod.simplefilter('always')
        assert mgr.restore_latest() is None
    unusable = [w for w in caught if isinstance(w.message, CheckpointResilienceWarning)
                and 'unusable' in str(w.message)]
    assert len(unusable) == 3
    with warnings_mod.catch_warnings():
        warnings_mod.simplefilter('error', CheckpointResilienceWarning)
        assert mgr.restore_latest() is None


# ------------------------------------------------------ checkpoint.py policy


def test_save_overwrite_policy(tmp_path):
    model, batch, kfac = _dense_setup()
    state = _run_steps(kfac, model, batch)
    path = str(tmp_path / 'ckpt')
    checkpoint.save(path, state, engine=kfac)
    with pytest.raises(ValueError, match='overwrite=True'):
        checkpoint.save(path, state)
    with pytest.raises(ValueError, match='ckpt'):
        checkpoint.save(path, state)
    state2 = _run_steps(kfac, model, batch, state=state)
    checkpoint.save(path, state2, engine=kfac, overwrite=True)
    restored, _ = checkpoint.restore(path, kfac)
    assert restored.step == 2
    assert sorted(os.listdir(tmp_path)) == ['ckpt', 'ckpt.manifest.json']


def test_async_handle_context_manager_and_dropped_handle(tmp_path):
    model, batch, kfac = _dense_setup()
    state = _run_steps(kfac, model, batch)
    path = str(tmp_path / 'actx')
    with checkpoint.save(path, state, engine=kfac, wait=False) as handle:
        pass
    # __exit__ waited: checkpoint durable and manifest written
    assert os.path.exists(path + '.manifest.json')
    assert checkpoint.restore(path, kfac)[0].step == 1
    handle.wait_until_finished()  # idempotent
    handle = checkpoint.save(str(tmp_path / 'adrop'), state, engine=kfac, wait=False)
    writer = handle._writer
    with pytest.warns(ResourceWarning, match='wait_until_finished'):
        del handle
        gc.collect()
    writer.join(timeout=60)
    assert not writer.is_alive()
    # the write committed, its manifest never came
    assert checkpoint.is_committed(str(tmp_path / 'adrop'))
    assert not os.path.exists(str(tmp_path / 'adrop') + '.manifest.json')


def test_restore_without_manifest_warns(tmp_path):
    model, batch, kfac = _dense_setup()
    state = _run_steps(kfac, model, batch)
    path = str(tmp_path / 'bare')
    checkpoint.save(path, state)  # no engine= -> no manifest sidecar
    with pytest.warns(CheckpointResilienceWarning, match='manifest'):
        restored, _ = checkpoint.restore(path, kfac)
    assert restored.step == 1


# ------------------------------------------------------------------- signals


def test_signal_flag_priority_and_uninstall():
    before_term = signal_mod.getsignal(signal_mod.SIGTERM)
    before_usr1 = signal_mod.getsignal(signal_mod.SIGUSR1)
    with signals.install():
        assert signals.preemption_requested() is None
        os.kill(os.getpid(), signal_mod.SIGUSR1)
        assert signals.preemption_requested() == 'SIGUSR1'
        os.kill(os.getpid(), signal_mod.SIGTERM)
        assert signals.preemption_requested() == 'SIGTERM'
        os.kill(os.getpid(), signal_mod.SIGUSR1)  # cannot demote an exit
        assert signals.preemption_requested() == 'SIGTERM'
        assert signals.consume() == 'SIGTERM'
        assert signals.preemption_requested() is None
    assert signal_mod.getsignal(signal_mod.SIGTERM) is before_term
    assert signal_mod.getsignal(signal_mod.SIGUSR1) is before_usr1
    with pytest.raises(ValueError, match='SIGHUP'):
        signals.install(['SIGHUP'])


def test_signal_storm_redelivery_during_save_is_dropped():
    with signals.install():
        with signals.save_in_flight('SIGTERM'):
            for _ in range(3):
                os.kill(os.getpid(), signal_mod.SIGTERM)
            assert signals.preemption_requested() is None
        assert signals.preemption_requested() is None
        with signals.save_in_flight('SIGUSR1'):
            os.kill(os.getpid(), signal_mod.SIGUSR1)  # re-delivery: dropped
            assert signals.preemption_requested() is None
            os.kill(os.getpid(), signal_mod.SIGTERM)  # escalation: latched
            assert signals.preemption_requested() == 'SIGTERM'
            os.kill(os.getpid(), signal_mod.SIGUSR1)
            assert signals.preemption_requested() == 'SIGTERM'
        assert signals.consume() == 'SIGTERM'
    with pytest.raises(ValueError, match='SIGHUP'):
        with signals.save_in_flight('SIGHUP'):
            pass
    with signals.save_in_flight('SIGTERM'):
        assert signals.save_in_flight_signal() == 'SIGTERM'
        signals.reset()
        assert signals.save_in_flight_signal() is None


def test_save_emergency_idempotent_under_stacked_sigterm(tmp_path):
    model, batch, kfac = _dense_setup()
    state = _run_steps(kfac, model, batch)
    with CheckpointManager(tmp_path, engine=kfac, save_interval_steps=None, async_save=False) as mgr:
        calls = []
        real_save = mgr.save

        def storming_save(state, step=None, block=True, extra=None):
            calls.append(step)
            os.kill(os.getpid(), signal_mod.SIGTERM)
            os.kill(os.getpid(), signal_mod.SIGTERM)
            return real_save(state, step=step, block=block, extra=extra)

        mgr.save = storming_save
        with pytest.warns(CheckpointResilienceWarning, match='emergency'):
            path = mgr.save_emergency(state, reason='SIGTERM')
        assert calls == [1] and path == mgr.checkpoint_path(1)
        assert signals.preemption_requested() is None  # the storm was absorbed
        # a SIGTERM during a save for another reason still latches
        with pytest.warns(CheckpointResilienceWarning):
            mgr.save_emergency(state, reason='degrade', step=2)
        assert calls == [1, 2]
        assert signals.preemption_requested() == 'SIGTERM'
        signals.reset()


def test_save_emergency_reuses_committed_step(tmp_path):
    model, batch, kfac = _dense_setup()
    state = _run_steps(kfac, model, batch)
    mgr = CheckpointManager(tmp_path, engine=kfac, install_signals=(), async_save=False)
    path = mgr.save(state)
    sentinel = os.path.join(mgr.step_dir(1), 'sentinel')
    open(sentinel, 'w').close()
    with pytest.warns(CheckpointResilienceWarning):
        assert mgr.save_emergency(state, reason='test') == path
    assert os.path.exists(sentinel)


def test_on_step_sigusr1_continues_and_sigterm_preempts_after_durable_save(tmp_path):
    model, batch, kfac = _dense_setup()
    state = _run_steps(kfac, model, batch)
    with CheckpointManager(tmp_path, engine=kfac, save_interval_steps=None) as mgr:
        assert mgr.on_step(state) is None  # no signal, periodic disabled
        os.kill(os.getpid(), signal_mod.SIGUSR1)
        with pytest.warns(CheckpointResilienceWarning):
            path = mgr.on_step(state)
        assert path == mgr.checkpoint_path(1) and mgr.latest_step() == 1
        assert signals.preemption_requested() is None  # consumed
        assert mgr.on_step(state) is None  # training continues
        state = _run_steps(kfac, model, batch, state=state)
        os.kill(os.getpid(), signal_mod.SIGTERM)
        with pytest.warns(CheckpointResilienceWarning), pytest.raises(Preempted, match='SIGTERM') as exc:
            mgr.on_step(state)
        assert exc.value.step == 2 and exc.value.path == mgr.checkpoint_path(2)
        # by the time Preempted unwinds, the checkpoint is durable
        assert mgr.latest_step() == 2
        assert mgr.restore_latest().step == 2


def test_sigterm_during_an_async_write_leaves_latest_durable(tmp_path, monkeypatch):
    """A slow async write is in flight when SIGTERM lands: the emergency save
    first finishes and commits it, then writes its own step, and LATEST never
    names anything but a committed checkpoint."""
    model, batch, kfac = _dense_setup()
    write = checkpoint._write_committed
    seen = []

    def slow_write(path, payload):
        time.sleep(0.3)
        write(path, payload)

    monkeypatch.setattr(checkpoint, '_write_committed', slow_write)
    with CheckpointManager(tmp_path, engine=kfac, save_interval_steps=2) as mgr:
        state = None
        for _ in range(2):
            state = _run_steps(kfac, model, batch, state=state)
            mgr.on_step(state)
        assert mgr._pending is not None and mgr.latest_step() is None  # in flight
        os.kill(os.getpid(), signal_mod.SIGTERM)
        state = _run_steps(kfac, model, batch, state=state)
        seen.append(mgr.latest_step())
        with pytest.warns(CheckpointResilienceWarning), pytest.raises(Preempted):
            mgr.on_step(state)
        assert mgr.latest_step() == 3
        assert mgr._is_committed(2) and mgr._is_committed(3)
    assert seen == [None]


def test_one_process_agreement_is_the_identity():
    from kfac_tpu_torch.parallel import multihost

    assert multihost.agree_emergency(2, 5) == (2, 5)
    assert multihost.agree_decision(True) and not multihost.agree_decision(False)
    multihost.barrier('x')
    multihost.assert_same_step(3)


def test_prune_removes_stale_uncommitted_dirs(tmp_path):
    model, batch, kfac = _dense_setup()
    state = _run_steps(kfac, model, batch)
    mgr = CheckpointManager(tmp_path, engine=kfac, install_signals=(), async_save=False)
    os.makedirs(os.path.join(mgr.step_dir(0), 'ckpt'))  # a crashed attempt
    os.makedirs(os.path.join(mgr.step_dir(9), 'ckpt'))  # maybe in flight
    mgr.save(state)
    assert not os.path.exists(mgr.step_dir(0))
    assert os.path.exists(mgr.step_dir(9))
    assert mgr.latest_step() == 1


# ------------------------------------------------------------ retry/backoff


def test_retry_backoff_and_exhaustion(tmp_path, monkeypatch):
    model, batch, kfac = _dense_setup()
    state = _run_steps(kfac, model, batch)
    sleeps = []
    mgr = CheckpointManager(
        tmp_path, engine=kfac, install_signals=(), async_save=False,
        backoff_base=0.5, backoff_max=8.0, sleep=sleeps.append,
    )
    real_save, calls = checkpoint.save, {'n': 0}

    def flaky(*args, **kwargs):
        calls['n'] += 1
        if calls['n'] <= 2:
            raise OSError('simulated transient I/O failure')
        return real_save(*args, **kwargs)

    monkeypatch.setattr(checkpoint, 'save', flaky)
    with pytest.warns(CheckpointResilienceWarning, match='retry'):
        mgr.save(state)
    assert calls['n'] == 3 and sleeps == [0.5, 1.0]
    monkeypatch.undo()
    assert mgr.restore_latest().step == 1

    sleeps.clear()
    mgr = CheckpointManager(
        tmp_path / 'x', engine=kfac, install_signals=(), async_save=False,
        max_retries=1, backoff_base=0.5, sleep=sleeps.append,
    )

    def always_fail(*args, **kwargs):
        raise OSError('disk on fire')

    monkeypatch.setattr(checkpoint, 'save', always_fail)
    with pytest.warns(CheckpointResilienceWarning, match='retry'):
        with pytest.raises(OSError, match='disk on fire'):
            mgr.save(state)
    assert sleeps == [0.5]


def test_async_write_failure_retries_the_same_snapshot(tmp_path, monkeypatch):
    model, batch, kfac = _dense_setup()
    state = _run_steps(kfac, model, batch)
    write, calls = checkpoint._write_committed, []

    def fails_once(path, payload):
        calls.append(path)
        if len(calls) == 1:
            raise OSError('transient')
        write(path, payload)

    monkeypatch.setattr(checkpoint, '_write_committed', fails_once)
    sleeps = []
    mgr = CheckpointManager(tmp_path, engine=kfac, install_signals=(), sleep=sleeps.append)
    mgr.save(state)  # async
    with pytest.warns(CheckpointResilienceWarning, match='retry'):
        mgr.finalize()
    assert len(calls) == 2 and sleeps == [0.5]
    assert mgr.latest_step() == 1 and mgr.restore_latest().step == 1


# -------------------------------------------------------- Trainer lifecycle


def _trainer(directory, seed=0, interval=2):
    model = MLP(6, (8,), 4, seed=seed, device='cpu')
    kfac = KFACPreconditioner(registry.register_model(model, device='cpu'), kl_clip=None, device='cpu')
    mgr = CheckpointManager(directory, engine=kfac, save_interval_steps=interval, keep=2,
                            install_signals=())
    opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    return Trainer(model, opt, _loss(model), kfac=kfac, checkpoints=mgr, device='cpu'), mgr


def test_trainer_periodic_saves_and_resume_continuity(tmp_path):
    batch = _data()
    trainer, mgr = _trainer(tmp_path)
    extras = []
    bound = trainer.checkpoint_extras
    mgr.extras_of = lambda s: extras.append(s) or bound(s)
    state = trainer.init()
    losses = []
    for i in range(5):
        state, loss = trainer.step(state, batch)
        losses.append(float(loss))
        if i == 3:
            at_4 = {k: v.clone() for k, v in trainer.model.state_dict().items()}
            mom_4 = [trainer.optimizer.state[p]['momentum_buffer'].clone()
                     for p in trainer.model.parameters()]
            a_4 = {n: v.clone() for n, v in state.kfac_state.a.items()}
    mgr.finalize()
    assert len(extras) == 2  # the extras are read on the two save steps only
    assert mgr.latest_step() == 4 and mgr.rotation_steps() == [4, 2]

    trainer2, mgr2 = _trainer(tmp_path, seed=7)  # other weights, restored over
    resumed = trainer2.restore_latest()
    assert resumed.kfac_state.step == 4 and trainer2._step_count == 4
    assert all(torch.equal(v, at_4[k]) for k, v in trainer2.model.state_dict().items())
    assert all(torch.equal(trainer2.optimizer.state[p]['momentum_buffer'], m)
               for p, m in zip(trainer2.model.parameters(), mom_4))
    assert all(torch.equal(resumed.kfac_state.a[n], a_4[n]) for n in a_4)
    # continuity: the resumed run's next step is the original run's 5th
    resumed, loss5 = trainer2.step(resumed, batch)
    np.testing.assert_allclose(float(loss5), losses[4], rtol=1e-6)
    assert trainer2._step_count == 5 and resumed.kfac_state.step == 5
    # an empty rotation hands the caller back to a fresh start
    trainer3, _ = _trainer(tmp_path / 'empty')
    assert trainer3.restore_latest() is None


@pytest.mark.parametrize('entry', ['scan_steps', 'step_accumulate', 'step_accumulate_scan',
                                   'apply_accumulated'])
def test_every_trainer_entry_drives_the_autopilot(tmp_path, entry):
    x, y = _data()
    trainer, mgr = _trainer(tmp_path)
    state = trainer.init()
    for _ in range(2):
        if entry == 'scan_steps':
            state, _ = trainer.scan_steps(state, (x[None], y[None]))
        elif entry == 'step_accumulate':
            state, _ = trainer.step_accumulate(state, [(x[:16], y[:16]), (x[16:], y[16:])])
        elif entry == 'step_accumulate_scan':
            state, _ = trainer.step_accumulate_scan(state, (x.view(2, 16, 6), y.view(2, 16, 4)))
        else:
            trainer.accumulate_microbatch(state, (x, y))
            state, _ = trainer.apply_accumulated(state)
    mgr.finalize()
    assert mgr.rotation_steps() == [2] and mgr.latest_step() == 2


def test_rebind_engine_moves_the_manager_and_resyncs(tmp_path):
    trainer, mgr = _trainer(tmp_path)
    state = trainer.init()
    for _ in range(2):
        state, _ = trainer.step(state, _data())
    mgr.finalize()
    other = KFACPreconditioner(trainer.kfac.registry, kl_clip=None, device='cpu',
                               compute_method='inverse')
    trainer.rebind_engine(other)
    assert mgr.engine is other and trainer._step_count is None
    # the compute method is not part of the durable layout: the EIGEN
    # checkpoint restores into the INVERSE engine, which steps on
    state = trainer.restore_latest()
    assert state.kfac_state.a_inv and trainer._step_count == 2
    state, _ = trainer.step(state, _data())
    assert trainer._step_count == 3 and state.kfac_state.step == 3


def test_postmortem_degrade_flushes_emergency_checkpoint(tmp_path):
    model, batch, _ = _dense_setup()
    kfac = KFACPreconditioner(
        registry.register_model(model, device='cpu'), kl_clip=None, flight=8, device='cpu',
        health=health.HealthConfig(warn=False, degrade_after=1),
    )
    mgr = CheckpointManager(tmp_path / 'rot', engine=kfac, install_signals=(), async_save=False,
                            save_interval_steps=None)
    pm = flight_recorder.PostmortemWriter(tmp_path / 'pms', engine=kfac, checkpoint_manager=mgr)
    state = _run_steps(kfac, model, batch)
    assert pm.observe(state) is None
    assert mgr.latest_step() is None  # healthy steps save nothing
    state = _run_steps(kfac, model, batch, state=state, poison='head')
    with pytest.warns(CheckpointResilienceWarning, match='degrade'):
        bundle = pm.observe(state)
    assert bundle is not None and 'degrade' in os.path.basename(bundle)
    man = json.load(open(os.path.join(bundle, 'MANIFEST.json')))
    assert man['emergency_checkpoint'] == mgr.checkpoint_path(2)
    assert mgr.latest_step() == 2
    # the quarantine rolled the poisoned factor back: the checkpoint restores
    result = mgr.restore_latest()
    assert result.step == 2 and int(result.state.health.bad_inv[1]) == 1


# --------------------------------------------------------------- subprocess


def _events(text):
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith('{'):
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


def _worker(ckpt_dir, *args):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH', ''))
    return [sys.executable, '-m', 'kfac_tpu_torch.resilience.worker', ckpt_dir, *args,
            '--device', 'cpu'], env


def test_subprocess_sigterm_leaves_resumable_checkpoint(tmp_path):
    """A real ``kill -TERM`` of a training process: it exits 0 with a durable
    emergency checkpoint, and a second process resumes from exactly that step
    and trains on. Each process has 120 s."""
    ckpt_dir = str(tmp_path / 'rot')
    cmd, env = _worker(ckpt_dir, '1000', '2', '0.05')
    err_path = tmp_path / 'worker.err'
    with open(err_path, 'w') as errf:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=errf, text=True, env=env,
                                cwd=str(tmp_path))
        events = []
        try:
            for line in proc.stdout:
                events.extend(_events(line))
                if events and events[-1].get('event') == 'step' and events[-1]['step'] >= 3:
                    proc.send_signal(signal_mod.SIGTERM)
                    break
            out, _ = proc.communicate(timeout=120)
        finally:
            proc.kill()
    events.extend(_events(out))
    assert proc.returncode == 0, err_path.read_text()[-4000:]
    pre = [e for e in events if e.get('event') == 'preempted']
    assert pre, events
    assert pre[0]['signal'] == 'SIGTERM'
    saved = pre[0]['saved_step']
    assert saved >= 3 and pre[0]['latest'] == saved
    last_step = max(e['step'] for e in events if e.get('event') == 'step')
    assert saved in (last_step, last_step + 1)  # the step the signal landed in

    cmd, env = _worker(ckpt_dir, str(saved + 2), '2')
    done_run = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=str(tmp_path),
                              timeout=120)
    assert done_run.returncode == 0, done_run.stderr[-4000:]
    ev2 = _events(done_run.stdout)
    start = next(e for e in ev2 if e['event'] == 'start')
    done = next(e for e in ev2 if e['event'] == 'done')
    assert start['resumed_step'] == saved
    assert done['final_step'] == saved + 2
    # one of the two extra steps hit the interval-2 cadence, and its
    # finalized periodic save moved the pointer past the emergency one
    assert done['latest'] > saved


def test_subprocess_sigterm_to_one_rank_preempts_the_distributed_worker(tmp_path):
    """A real ``kill -TERM`` of one rank of a two-rank gloo world
    (``worker --world 2``, a ``DistributedKFAC`` at fraction 0.5): every
    rank saves the one agreed emergency checkpoint and exits, and a second
    world resumes from its step. Each world has 120 s."""
    ckpt_dir = str(tmp_path / 'rot')
    cmd, env = _worker(ckpt_dir, '1000', '2', '0.05')
    cmd += ['--world', '2', '--frac', '0.5']
    err_path = tmp_path / 'worker.err'
    with open(err_path, 'w') as errf:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=errf, text=True, env=env,
                                cwd=str(tmp_path))
        events = []
        try:
            for line in proc.stdout:
                events.extend(_events(line))
                pids = {e['rank']: e['pid'] for e in events if e.get('event') == 'start'}
                steps = [e['step'] for e in events if e.get('event') == 'step']
                if len(pids) == 2 and steps and steps[-1] >= 3:
                    os.kill(pids[1], signal_mod.SIGTERM)
                    break
            out, _ = proc.communicate(timeout=120)
        finally:
            proc.kill()
    events.extend(_events(out))
    assert proc.returncode == 0, err_path.read_text()[-4000:]
    pre = sorted((e for e in events if e.get('event') == 'preempted'), key=lambda e: e['rank'])
    assert [e['rank'] for e in pre] == [0, 1], events
    assert {e['signal'] for e in pre} == {'SIGTERM'}
    saved = pre[0]['saved_step']
    assert pre[1]['saved_step'] == saved and pre[0]['latest'] == saved

    cmd, env = _worker(ckpt_dir, str(saved + 2), '2')
    cmd += ['--world', '2', '--frac', '0.5']
    done_run = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=str(tmp_path),
                              timeout=120)
    assert done_run.returncode == 0, done_run.stderr[-4000:]
    ev2 = _events(done_run.stdout)
    assert sorted(e['resumed_step'] for e in ev2 if e['event'] == 'start') == [saved, saved]
    done = [e for e in ev2 if e['event'] == 'done']
    assert len(done) == 2 and {e['final_step'] for e in done} == {saved + 2}
