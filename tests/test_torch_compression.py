"""The port's compressed stat transport and cold-factor offload against the
JAX package's (``kfac_tpu.compression``; the port of
``tests/test_compression.py``).

- Quantization: ``quantize_blockwise``'s payload (its bytes) and scales
  bitwise the JAX function's, int8 and fp8, block sizes 1, 7 and 256 at
  lengths 1, 255, 256 and 1000; the round trip within ``error_bound``; an
  all-zero block exact; ``wire_bytes`` equal.
- Configuration: every shorthand, and every refusal with the JAX
  package's message.
- The dense engine's offload: a ``Trainer``'s losses and factors bitwise
  with offload on and off, its counters equal to the JAX Trainer's over the
  same 17 steps, a spilled state refused by ``save``, and the autopilot's
  save inside a spill window equal to a save of the resident state.
- ``DistributedKFAC`` in gloo worlds of 1 and 2 CPU ranks (rank bodies in
  ``tests/torch_kaisa_ranks.py``; each world runs once per test run, every
  case in it). At W = 1 one step's preconditioned grads (atol 1e-5 x the
  largest) and residuals (atol 1e-6) against the JAX engine's, at each
  wire. At W = 2 the port against its own W = 1 step on the same global
  batch: the ranks' f32 partial sums round differently from one sum, so a
  factor element may land one quantum away, its block's scale times ``1 -
  factor_decay`` (and the residual one scale); everything else within f32
  rounding. The JAX tests' wire ratio (>= 3x) and one-step closeness to the
  f32 wire, the 40-step int8 run within 5 % of the f32 wire's final loss,
  the checkpoints (residuals bitwise through a round trip, a
  pre-compression checkpoint restoring zeros, a compressed one refused by
  an engine without compression; a W = 2 save restored at W = 1 with the
  JAX engine's replicated residual, the slices in rank order), offload
  bitwise with it off at W = 2 and ``comms_report()['offload']`` equal to
  the JAX engine's, and ``convert.from_jax_dist_state`` of a JAX state
  with residuals and a shadow, stepped once against the JAX engine.
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
from kfac_tpu import training as jtraining
from kfac_tpu.compression import config as jconfig
from kfac_tpu.compression import offload as joffload
from kfac_tpu.compression import quant as jquant
from kfac_tpu.models import MLP as FlaxMLP
from kfac_tpu.parallel import DistributedKFAC as JaxDistributedKFAC
from kfac_tpu.parallel import kaisa_mesh as jax_kaisa_mesh
from kfac_tpu_torch import checkpoint, compression, convert
from kfac_tpu_torch.compression import config as tconfig
from kfac_tpu_torch.compression import offload as toffload
from kfac_tpu_torch.compression import quant as tquant
from kfac_tpu_torch.layers import registry
from kfac_tpu_torch.models import MLP
from kfac_tpu_torch.parallel import spawn_world
from kfac_tpu_torch.preconditioner import KFACPreconditioner
from kfac_tpu_torch.resilience import CheckpointManager
from kfac_tpu_torch.training import Trainer

DTYPES = ('int8', 'fp8')


def rng(seed):
    return np.random.default_rng(seed)


def raw_bytes(x):
    """The bytes of a JAX array or a torch tensor, as uint8."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


# ------------------------------------------------------------ quantization


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('block_size', [1, 7, 256])
@pytest.mark.parametrize('n', [1, 255, 256, 1000])
def test_quantize_bitwise_jax_and_round_trip_within_bound(dtype, block_size, n):
    x = (rng(n * 31 + block_size).standard_normal(n) * 3.0).astype(np.float32)
    x[: n // 3] *= 1e-3  # blocks of very different scales
    jp, js = jquant.quantize_blockwise(jnp.asarray(x), dtype, block_size)
    tp, ts = tquant.quantize_blockwise(torch.from_numpy(x), dtype, block_size)
    assert tp.dtype == tquant.wire_dtype(dtype) and tuple(tp.shape) == (n,)
    assert np.array_equal(raw_bytes(tp), raw_bytes(jp))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    deq = tquant.dequantize_blockwise(tp, ts, n, block_size).numpy()
    assert np.array_equal(deq, np.asarray(jquant.dequantize_blockwise(jp, js, n, block_size)))
    for b in range(ts.shape[0]):
        blk = slice(b * block_size, min((b + 1) * block_size, n))
        amax = float(np.max(np.abs(x[blk])))
        assert float(np.max(np.abs(deq[blk] - x[blk]))) <= tquant.error_bound(amax, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_all_zero_block_is_exact(dtype):
    x = np.zeros(300, np.float32)
    x[280:] = rng(0).standard_normal(20)  # the second block is not zero
    p, s = tquant.quantize_blockwise(torch.from_numpy(x), dtype, 256)
    assert float(s[0]) == 1.0
    deq = tquant.dequantize_blockwise(p, s, 300, 256).numpy()
    assert np.array_equal(deq[:256], np.zeros(256, np.float32))


def test_wire_bytes_equal_jax():
    for elements in (1, 119, 256, 257, 100_000):
        for dtype in DTYPES:
            for bs in (1, 7, 256):
                assert tquant.wire_bytes(elements, dtype, bs) == jquant.wire_bytes(elements, dtype, bs)
    assert tquant.error_bound(2.54, 'int8') == jquant.error_bound(2.54, 'int8')
    assert tquant.error_bound(16.0, 'fp8') == jquant.error_bound(16.0, 'fp8')


# ------------------------------------------------------------ configuration


def small_registries():
    jreg = kfac_tpu.register_model(FlaxMLP(features=(8,), num_classes=4), jnp.zeros((2, 6)))
    treg = registry.register_model(MLP(6, (8,), 4, device='cpu'), device='cpu')
    return jreg, treg


def both(fn_j, fn_t):
    """The exception (type, message) each side raises, or their results."""
    out = []
    for fn in (fn_j, fn_t):
        try:
            out.append(('ok', fn()))
        except (TypeError, ValueError) as err:
            out.append((type(err).__name__, str(err)))
    return out


def test_config_shorthands_match_jax():
    for value in (None, False, True, 'int8', 'fp8'):
        j = jconfig.as_compression_config(value)
        t = tconfig.as_compression_config(value)
        assert (j is None) == (t is None)
        if j is not None:
            assert (t.dtype, t.block_size, t.error_feedback) == (j.dtype, j.block_size, j.error_feedback)
    for value in (None, False, True, 2, 7):
        j = jconfig.as_offload_config(value)
        t = tconfig.as_offload_config(value)
        assert (j is None) == (t is None)
        if j is not None:
            assert (t.min_cold_steps, t.prefetch_lead) == (j.min_cold_steps, j.prefetch_lead)
    jreg, treg = small_registries()
    kw = dict(allreduce_method='allreduce_bucketed', stat_compression=True, offload=2)
    t = KFACPreconditioner(treg, device='cpu', **kw)
    assert t.stat_compression == tconfig.CompressionConfig()
    assert t.offload == tconfig.OffloadConfig(min_cold_steps=2)
    off = KFACPreconditioner(treg, device='cpu', stat_compression=None, offload=False)
    assert off.stat_compression is None and off.offload is None and off._offload_manager is None


@pytest.mark.parametrize('case', [
    'dtype', 'block_size', 'min_cold_steps', 'prefetch_lead', 'compression_type', 'offload_type',
])
def test_config_refusals_carry_jax_messages(case):
    calls = {
        'dtype': lambda lib: lib.CompressionConfig(dtype='int4'),
        'block_size': lambda lib: lib.CompressionConfig(block_size=0),
        'min_cold_steps': lambda lib: lib.OffloadConfig(min_cold_steps=0),
        'prefetch_lead': lambda lib: lib.OffloadConfig(prefetch_lead=-1),
        'compression_type': lambda lib: lib.as_compression_config(3.5),
        'offload_type': lambda lib: lib.as_offload_config('often'),
    }[case]
    j, t = both(lambda: calls(jconfig), lambda: calls(tconfig))
    assert j[0] != 'ok' and j == t


@pytest.mark.parametrize('case', ['no_bucketed', 'sliced', 'callable_factor', 'callable_inv'])
def test_engine_refusals_carry_jax_messages(case):
    jreg, treg = small_registries()
    kw = {
        'no_bucketed': dict(stat_compression='int8'),
        'sliced': dict(offload=True, async_inverse='sliced', inv_update_steps=4),
        'callable_factor': dict(offload=True, factor_update_steps=lambda s: 8),
        'callable_inv': dict(offload=True, inv_update_steps=lambda s: 8),
    }[case]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        j, t = both(lambda: kfac_tpu.KFACPreconditioner(registry=jreg, **kw),
                    lambda: KFACPreconditioner(treg, device='cpu', **kw))
    assert j[0] == 'ValueError' and j == t


def test_package_exports_match_jax():
    import kfac_tpu.compression as jpkg

    assert sorted(compression.__all__) == sorted(jpkg.__all__)


# ------------------------------------------------------------ dense offload

OFFLOAD_STEPS = 17


def offload_data():
    r = rng(1)
    x = r.standard_normal((64, 6)).astype(np.float32)
    y = np.tanh(x @ r.standard_normal((6, 4))).astype(np.float32)
    return x, y


@functools.cache
def jax_offload_run(offload):
    """The JAX Trainer's ``OFFLOAD_STEPS`` steps (tests/test_compression.py's
    ``_trainer_losses`` on the port's MLP): losses, factors, counters."""
    x, y = offload_data()
    model = FlaxMLP(features=(8,), num_classes=4)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    reg = kfac_tpu.register_model(model, jnp.asarray(x))
    kfac = kfac_tpu.KFACPreconditioner(
        registry=reg, damping=1e-3, lr=0.1, factor_update_steps=8, inv_update_steps=8,
        offload=offload,
    )

    def loss_fn(p, model_state, batch):
        return jnp.mean((model.apply({'params': p}, batch[0]) - batch[1]) ** 2), model_state

    trainer = jtraining.Trainer(loss_fn=loss_fn, optimizer=optax.sgd(0.05), kfac=kfac)
    state = trainer.init(params)
    losses = []
    for _ in range(OFFLOAD_STEPS):
        state, value = trainer.step(state, (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(value))
    stats = None if kfac._offload_manager is None else dict(kfac._offload_manager.stats)
    return losses, jax.device_get(params), stats


def port_offload_trainer(offload, checkpoints=None):
    x, y = offload_data()
    _, jparams, _ = jax_offload_run(None)
    model = MLP(6, (8,), 4, device='cpu')
    model.load_state_dict(convert.from_flax_params(jparams))
    kfac = KFACPreconditioner(
        registry.register_model(model, device='cpu'), device='cpu', damping=1e-3, lr=0.1,
        factor_update_steps=8, inv_update_steps=8, offload=offload,
    )
    trainer = Trainer(
        model, torch.optim.SGD(model.parameters(), lr=0.05),
        lambda ms, b: (torch.mean((model(b[0]) - b[1]) ** 2), ms), kfac=kfac, device='cpu',
        checkpoints=checkpoints,
    )
    return trainer, (torch.from_numpy(x), torch.from_numpy(y))


def port_offload_run(offload, steps=OFFLOAD_STEPS):
    trainer, batch = port_offload_trainer(offload)
    state, losses, spilled = trainer.init(), [], []
    for _ in range(steps):
        state, value = trainer.step(state, batch)
        losses.append(float(value))
        spilled.append(toffload.is_spilled(state.kfac_state))
    return trainer, state, losses, spilled


def test_offload_bit_identical_and_counters_match_jax():
    off = jconfig.OffloadConfig(min_cold_steps=2, prefetch_lead=1)
    jlosses, _, jstats = jax_offload_run(off)
    _, state_off, base, _ = port_offload_run(None)
    trainer, state, losses, spilled = port_offload_run(tconfig.OffloadConfig(2, 1))
    assert losses == base  # bitwise
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert any(spilled) and not spilled[-1]
    stats = trainer.kfac._offload_manager.stats
    assert stats == jstats
    assert stats['prefetch_hits'] > 0 and stats['prefetch_misses'] == 0
    for side in ('a', 'g'):
        for n, v in getattr(state_off.kfac_state, side).items():
            assert torch.equal(getattr(state.kfac_state, side)[n], v)


def test_offload_without_prefetch_lead_misses_as_jax():
    _, _, jstats = jax_offload_run(jconfig.OffloadConfig(min_cold_steps=3, prefetch_lead=0))
    trainer, _, losses, _ = port_offload_run(tconfig.OffloadConfig(3, 0))
    assert trainer.kfac._offload_manager.stats == jstats
    assert jstats['prefetch_misses'] > 0 and jstats['prefetch_hits'] == 0
    assert losses == port_offload_run(None)[2]


def test_spilled_state_is_refused_by_save_and_host_view_is_resident(tmp_path):
    trainer, batch = port_offload_trainer(2)
    state, _ = trainer.step(trainer.init(), batch)
    kfac = trainer.kfac
    # step 3 with f = c = 8: the next use is step 8, five steps away: spill
    spilled = toffload.pump(kfac, state.kfac_state, step=3)
    assert toffload.is_spilled(spilled) and kfac.memory_usage(spilled)['a_factors'] == 0
    with pytest.raises(ValueError, match='spilled') as err:
        checkpoint.save(str(tmp_path / 'ckpt'), spilled, engine=kfac)
    with pytest.raises(ValueError) as jerr:
        kfac_tpu.checkpoint.durable_state(jax_spilled_state())
    assert str(err.value) == str(jerr.value)
    view = kfac._offload_manager.host_view(spilled)
    assert not toffload.is_spilled(view)
    for side in ('a', 'g'):
        for n, v in getattr(state.kfac_state, side).items():
            assert torch.equal(getattr(view, side)[n], v)
    restored = kfac._offload_manager.restore(spilled)
    assert not toffload.is_spilled(restored) and kfac._offload_manager.stats['prefetch_misses'] == 1


def jax_spilled_state():
    """A JAX dense state spilled by its offload manager."""
    jreg, _ = small_registries()
    kfac = kfac_tpu.KFACPreconditioner(
        registry=jreg, factor_update_steps=8, inv_update_steps=8, offload=2,
    )
    return joffload.pump(kfac, kfac.init(), step=3)


def test_autopilot_save_in_a_spill_window_equals_the_resident_state(tmp_path):
    # f = c = 8, min_cold_steps 2: steps 1-6 run spilled; the save of step 4
    # lands inside the window and must hold the factors bitwise
    mgr = CheckpointManager(str(tmp_path / 'rot'), save_interval_steps=4, async_save=False,
                            install_signals=())
    trainer, batch = port_offload_trainer(tconfig.OffloadConfig(2, 1), checkpoints=mgr)
    ref, ref_batch = port_offload_trainer(None)
    state, ref_state = trainer.init(), ref.init()
    for _ in range(5):
        state, _ = trainer.step(state, batch)
        ref_state, _ = ref.step(ref_state, ref_batch)
    assert toffload.is_spilled(state.kfac_state)
    assert mgr.latest_step() == 4
    loaded = torch.load(os.path.join(mgr.checkpoint_path(4), checkpoint.PAYLOAD), weights_only=True)
    for side in ('a', 'g'):
        for n, v in getattr(ref_state.kfac_state, side).items():
            assert torch.equal(loaded['kfac'][side][n], v)
    mgr.close()


def test_scan_steps_restores_the_factors_and_stays_resident():
    trainer, batch = port_offload_trainer(tconfig.OffloadConfig(2, 1))
    state = trainer.init()
    for _ in range(3):
        state, _ = trainer.step(state, batch)
    assert toffload.is_spilled(state.kfac_state)
    stacked = tuple(torch.stack([b] * 3) for b in batch)
    state, _ = trainer.scan_steps(state, stacked)
    assert not toffload.is_spilled(state.kfac_state)
    assert trainer.kfac._offload_manager.stats['restores'] == 1


def test_rematerialize_resets_the_manager():
    trainer, batch = port_offload_trainer(2)
    state = trainer.init()
    for _ in range(3):
        state, _ = trainer.step(state, batch)
    mgr = trainer.kfac._offload_manager
    assert mgr.spilled
    resident = mgr.host_view(state.kfac_state)
    trainer.kfac.rematerialize(resident)
    assert not mgr.spilled and mgr._host is None


# --------------------------------------------------- DistributedKFAC worlds

COMPS = {'f32': None, 'int8': 'int8', 'fp8': 'fp8'}
CONVERGE_STEPS = 40
CONVERT_STEPS = 5  # the JAX state converted is mid-window, its shadow half built


@functools.cache
def flax_mlp():
    module = FlaxMLP(features=(16, 12), num_classes=5)
    batch = tuple(b.astype(np.float32) for b in (rng(1).normal(size=(16, 6)), rng(2).normal(size=(16, 5))))
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(batch[0]))['params']
    reg = kfac_tpu.register_model(module, jnp.asarray(batch[0]))

    def loss(p, b):
        return jnp.mean((module.apply({'params': p}, b[0]) - b[1]) ** 2)

    run = kfac_tpu.CurvatureCapture(reg).value_stats_and_grad(
        lambda p, b: (loss(p, b), None), has_aux=True
    )
    return module, reg, run, jax.device_get(params), batch


def jax_engine(world, frac, **kw):
    _, reg, _, _, _ = flax_mlp()
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        cfg = kfac_tpu.KFACPreconditioner(registry=reg, **kw)
    return JaxDistributedKFAC(config=cfg, mesh=jax_kaisa_mesh(frac, devices=jax.devices()[:world]))


def jax_grads_stats(batch):
    _, _, run, params, _ = flax_mlp()
    (_, _), grads, stats = run(params, tuple(jnp.asarray(b) for b in batch))
    return grads, stats


def torch_grads(jgrads):
    return {k: v.numpy() for k, v in convert.from_flax_params(jax.device_get(jgrads)).items()}


def close_grads(got, want, atol_rel):
    assert set(got) == set(want)
    scale = max(float(np.max(np.abs(w))) for w in want.values())
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, rtol=0, atol=atol_rel * scale, err_msg=n)


def jax_convert_state(world, frac):
    """A JAX engine (int8 wire, sliced refresh) ``CONVERT_STEPS`` steps in,
    and its next step's grads, residuals and factors."""
    _, _, _, _, batch = flax_mlp()
    dk = jax_engine(world, frac, **ranks.COMP_KW, stat_compression='int8',
                    async_inverse='sliced', factor_update_steps=2, inv_update_steps=8)
    grads, stats = jax_grads_stats(batch)
    step = jax.jit(dk.step)
    state = dk.init()
    for _ in range(CONVERT_STEPS):
        state, _ = step(state, grads, stats)
    nxt, pg = step(state, grads, stats)
    return state, {
        'grads': torch_grads(pg),
        'comp_ef': {k: np.asarray(v) for k, v in nxt.comp_ef.items()},
        'progress': int(state.shadow.progress),
    }


def world_spec(world, root):
    """The JAX references of a ``world``-rank gloo world's cases and the
    spec of the port's cases."""
    _, _, _, params, batch = flax_mlp()
    fracs = [1.0] if world == 1 else [1.0, 0.5]
    twin = ranks.Twin()
    with torch.no_grad():
        for i, p in enumerate(twin.parameters()):
            p.copy_(torch.from_numpy(rng(60 + i).normal(size=tuple(p.shape)).astype(np.float32) * 0.3))
    spec = {
        'weights': {'mlp': {k: v.numpy() for k, v in convert.from_flax_params(params).items()},
                    'twin': {k: v.detach().numpy() for k, v in twin.state_dict().items()}},
        'batches': {'mlp': batch, 'twin': tuple(
            rng(70 + i).normal(size=(16, 8)).astype(np.float32) for i in range(2))},
        'async_batches': [
            tuple(b.astype(np.float32) for b in (rng(40 + i).normal(size=(16, 6)),
                                                  rng(80 + i).normal(size=(16, 5))))
            for i in range(3 * ranks.ASYNC_N + 1)
        ],
        'cases': [],
    }
    ref = {'convert': {}}
    for frac in fracs:
        spec['cases'].append((f'compressed-{frac}', 'compressed', dict(frac=frac, comps=COMPS)))
        for mode in (None, 'sliced', 'host'):
            spec['cases'].append((f'async-{mode}-{frac}', 'async', dict(frac=frac, mode=mode)))
        jstate, ref['convert'][frac] = jax_convert_state(world, frac)
        spec['cases'].append((f'convert-{frac}', 'convert_knobs', dict(
            frac=frac, jax_state=jstate, **ranks.COMP_KW, stat_compression='int8',
            async_inverse='sliced', factor_update_steps=2, inv_update_steps=8,
        )))
    for mode in (None, 'sliced'):
        spec['cases'].append((f'fault-{mode}', 'async', dict(
            frac=fracs[-1], mode=mode, poison_step=2 * ranks.ASYNC_N,
            health=ranks.HealthConfig(warn=False),
        )))
    restore_from = None if world == 2 else os.path.join(root, 'w2', 'int8')
    spec['cases'].append(('checkpoint', 'comp_checkpoint', dict(
        frac=fracs[-1], root=os.path.join(root, f'w{world}'), restore_from=restore_from,
    )))
    # one layout at both worlds: the restore reads the slices, not a migration
    spec['cases'].append(('checkpoint-twin', 'comp_checkpoint', dict(
        frac=1.0, root=os.path.join(root, f'twin{world}'), model='twin',
        restore_from=None if world == 2 else os.path.join(root, 'twin2', 'int8'),
    )))
    if world == 2:
        spec['cases'] += [
            ('converge', 'converge', dict(frac=1.0, steps=CONVERGE_STEPS)),
            ('offload', 'offload', dict(frac=0.5)),
        ]
    return ref, spec


def run_worlds(root):
    """``{world: (JAX references, the port's results by rank, spec)}``: the
    W = 2 world first (the W = 1 world restores its checkpoints), the W = 1
    references computed while the W = 2 world's processes run."""
    ref2, spec2 = world_spec(2, root)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = pool.submit(
            spawn_world, ranks.run_cases, 2, 'gloo', 'cpu', args=(spec2,), timeout_s=300
        )
        ref1, spec1 = world_spec(1, root)
        out2 = pending.result()
    out1 = spawn_world(ranks.run_cases, 1, 'gloo', 'cpu', args=(spec1,), timeout_s=300)
    return {2: (ref2, out2, spec2), 1: (ref1, out1, spec1)}


_WORLDS: dict[int, tuple] = {}


def knob_worlds():
    """Both worlds once per test run (W = 2 first: the W = 1 world restores
    its checkpoint); under pytest-xdist the first worker computes them under
    a file lock and leaves them in the temporary directory, keyed by the
    run's id, for the others."""
    if _WORLDS:
        return _WORLDS
    uid = os.environ.get('PYTEST_XDIST_TESTRUNUID')

    def compute():
        return run_worlds(tempfile.mkdtemp(prefix='kfac_knobs_'))

    if uid is None:
        _WORLDS.update(compute())
        return _WORLDS
    path = os.path.join(tempfile.gettempdir(), f'kfac_torch_knobs_{uid}.pkl')
    with open(path + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            with open(path, 'rb') as f:
                _WORLDS.update(pickle.load(f))
        else:
            _WORLDS.update(compute())
            with open(path + '.tmp', 'wb') as f:
                pickle.dump(dict(_WORLDS), f)
            os.replace(path + '.tmp', path)
    return _WORLDS


@functools.cache
def jax_compressed(comp):
    """The JAX engine's step from ``init`` at W = 1 on the spec batch."""
    _, _, _, _, batch = flax_mlp()
    dk = jax_engine(1, 1.0, **ranks.COMP_KW, stat_compression=comp)
    grads, stats = jax_grads_stats(batch)
    state, pg = jax.jit(dk.step)(dk.init(), grads, stats)
    return {
        'grads': torch_grads(pg),
        'comp_ef': None if state.comp_ef is None else {k: np.asarray(v) for k, v in state.comp_ef.items()},
        'factors': {f: {k: np.asarray(v) for k, v in getattr(state, f).items()} for f in ('a', 'g')},
        'comms': dk.comms_report()['stat_transport'],
    }


def ef_head(ef, plan):
    """Each chunk's whole residual, trimmed to its elements, and the tail
    the padding holds."""
    return {k: v[: plan[int(k[1:])]['elements']] for k, v in ef.items()}, \
        {k: v[plan[int(k[1:])]['elements']:] for k, v in ef.items()}


@pytest.mark.parametrize('comp', list(COMPS))
def test_w1_step_matches_jax(comp):
    got = knob_worlds()[1][1][0]['compressed-1.0'][comp]
    want = jax_compressed(COMPS[comp])
    close_grads(got['grads'], want['grads'], 1e-5)
    if comp == 'f32':
        assert got['comp_ef'] is None and want['comp_ef'] is None
        return
    head, tail = ef_head(got['comp_ef'], got['plan'])
    assert set(head) == set(want['comp_ef'])
    for k, w in want['comp_ef'].items():
        np.testing.assert_allclose(head[k], w, rtol=0, atol=1e-6)
        assert not np.any(tail[k])
    assert got['counter']['collectives'] == 0  # one rank: no collective
    # the JAX package's keys, and the port's collectives beside them
    comms = dict(got['comms'])
    assert comms.pop('port_collectives')['ops'] == []
    assert comms == want['comms']


def quantum_allowance(rows_w1, plan, block_size, scale_factor):
    """Per element of the packed chunks, its block's int8 scale (amax /
    127 of the W = 1 rows) times ``scale_factor``."""
    out = []
    for c in plan:
        rows = rows_w1[: c['elements']]
        rows_w1 = rows_w1[c['elements']:]
        nb = -(-c['elements'] // block_size)
        pad = np.pad(np.abs(rows), (0, nb * block_size - c['elements'])).reshape(nb, block_size)
        out.append(np.repeat(pad.max(axis=1) / 127.0, block_size)[: c['elements']] * scale_factor)
    return np.concatenate(out)


def packed(factors, stores):
    """The packed upper triangles of the factor stacks in the transport's
    order: each store's live slots, A stores then G stores."""
    out = []
    for side, key, n_layers in stores:
        for m in factors[side][key][:n_layers]:
            out.append(m[np.triu_indices(m.shape[0])])
    return np.concatenate(out)


def assert_within_one_quantum(w1, ranks_res):
    """Every rank's int8 step (``case_compressed``) against the W = 1
    one on the same global batch: each factor element within one quantum
    of its block (the scale, amax / 127 of the W = 1 rows, times ``1 -
    factor_decay``) and each residual element within one scale, plus f32
    slack; the factors bitwise alike on every rank."""
    alpha = 0.95  # the default factor_decay; the factors start at identity
    new1 = packed(w1['factors'], w1['stores'])
    eye = packed({s: {k: np.broadcast_to(np.eye(v.shape[-1], dtype=np.float32), v.shape)
                      for k, v in w1['factors'][s].items()} for s in ('a', 'g')}, w1['stores'])
    rows = (new1 - alpha * eye) / (1 - alpha)  # the dequantized global rows
    allow = quantum_allowance(rows, w1['plan'], 256, (1 - alpha) * 1.001) + 1e-6 * np.abs(new1).max()
    ef_allow = quantum_allowance(rows, w1['plan'], 256, 1.001) + 1e-6
    head1, _ = ef_head(w1['comp_ef'], w1['plan'])
    for got in ranks_res:
        new2 = packed(got['factors'], got['stores'])
        assert np.all(np.abs(new2 - new1) <= allow)
        head2, _ = ef_head(got['comp_ef'], got['plan'])
        diff = np.abs(np.concatenate(list(head2.values())) - np.concatenate(list(head1.values())))
        assert np.all(diff <= ef_allow)
    for side in ('a', 'g'):
        for k, v in ranks_res[0]['factors'][side].items():
            for got in ranks_res[1:]:
                assert np.array_equal(got['factors'][side][k], v)


@pytest.mark.parametrize('frac', [1.0, 0.5])
def test_w2_compressed_step_within_one_quantum_of_w1(frac):
    worlds = knob_worlds()
    assert_within_one_quantum(worlds[1][1][0]['compressed-1.0']['int8'],
                              [r[f'compressed-{frac}']['int8'] for r in worlds[2][1]])


@pytest.mark.parametrize('frac', [1.0, 0.5])
def test_w2_compressed_collectives_move_fewer_bytes_than_the_f32_all_reduce(frac):
    res = knob_worlds()[2][1][0][f'compressed-{frac}']
    f32, int8 = res['f32']['counter'], res['int8']['counter']
    comms = res['int8']['comms']
    assert int8['collectives'] == 3 * len(res['int8']['plan']) == len(comms['port_collectives']['ops'])
    assert int8['buffer_bytes'] == comms['port_collectives']['buffer_bytes']
    # ring traffic a rank sends: reduce-scatter (W-1)/W of the f32 chunk
    # plus the all-gathers' payload and scales, against 2 (W-1)/W of it
    assert int8['ring_bytes'] < f32['ring_bytes']


@pytest.mark.parametrize('world', [1, 2])
def test_compressed_step_close_to_f32_and_ef_carried(world):
    res = knob_worlds()[world][1][0]['compressed-1.0']
    for n, w in res['f32']['grads'].items():  # the JAX test's tolerance
        np.testing.assert_allclose(res['int8']['grads'][n], w, atol=2e-3, rtol=2e-2, err_msg=n)
    for name in ('int8', 'fp8'):
        assert sum(float(np.abs(v).sum()) for v in res[name]['comp_ef'].values()) > 0.0


def test_wire_ratio_clears_3x():
    comms = knob_worlds()[2][1][0]['compressed-1.0']['int8']['comms']
    assert comms['compression']['ratio'] >= 3.0
    assert comms['wire_bytes'] * 3 <= comms['raw_bytes']
    assert comms['bytes'] == comms['wire_bytes']
    f32 = knob_worlds()[2][1][0]['compressed-1.0']['f32']['comms']
    assert f32['wire_bytes'] == f32['raw_bytes'] == f32['bytes'] and f32['compression'] is None
    assert 'port_collectives' not in f32


def test_int8_error_feedback_convergence_parity():
    res = knob_worlds()[2][1][0]['converge']
    l32, l8 = res['f32'][-1], res['int8'][-1]
    assert np.isfinite(l8) and res['int8'][-1] < res['int8'][0]
    assert abs(l8 - l32) <= 0.05 * max(abs(l32), 1e-8)


@pytest.mark.parametrize('world', [1, 2])
def test_comp_ef_checkpoint_round_trip_and_toggles(world):
    for res in knob_worlds()[world][1]:
        got = res['checkpoint']
        for k, v in got['saved_int8'].items():
            assert np.array_equal(got['round_trip'][k], v)
        assert got['saved_f32'] is None
        assert sum(float(np.abs(v).sum()) for v in got['pre_compression'].values()) == 0.0
        assert 'stat_compression' in got['into_f32']


def test_w2_checkpoint_restored_at_w1_migrates_as_jax():
    # the W = 2 stores pad each layer's slot to two, the W = 1 ones to one:
    # another layout, so the restore migrates through per-layer factors,
    # and the JAX package's migration leaves the residuals at init()'s zeros
    w2 = knob_worlds()[2][1][0]['checkpoint']
    w1 = knob_worlds()[1][1][0]['checkpoint']['cross_world']
    stores = knob_worlds()[1][1][0]['compressed-1.0']['int8']['stores']
    assert sum(float(np.abs(v).sum()) for v in w2['saved_int8'].values()) > 0.0
    assert set(w1['comp_ef']) == set(w2['saved_int8'])
    assert all(not np.any(v) for v in w1['comp_ef'].values())
    assert np.array_equal(packed(w1['factors'], stores), packed(w2['factors_int8'], stores))


def test_w2_checkpoint_restored_at_w1_in_one_layout_keeps_the_residual():
    # the slices of the W = 2 save, in rank order, are the JAX engine's
    # replicated residual; W = 1 takes it whole, its padding zero
    w2 = knob_worlds()[2][1][0]['checkpoint-twin']
    w1 = knob_worlds()[1][1][0]['checkpoint-twin']['cross_world']
    n = {k: int(np.flatnonzero(v).max()) + 1 for k, v in w2['saved_int8'].items()}
    for k, v in w2['saved_int8'].items():
        assert np.array_equal(w1['comp_ef'][k][:n[k]], v[:n[k]]) and not np.any(w1['comp_ef'][k][n[k]:])
    for side in ('a', 'g'):
        for k, v in w2['factors_int8'][side].items():
            assert np.array_equal(w1['factors'][side][k], v)


def test_offload_bitwise_at_w2_and_comms_match_jax():
    res = knob_worlds()[2][1]
    dk = jax_engine(2, 0.5, damping=1e-3, lr=0.1, factor_update_steps=8, inv_update_steps=8,
                    offload=jconfig.OffloadConfig(min_cold_steps=2, prefetch_lead=1))
    want = dk.comms_report()['offload']
    for r in res:
        got = r['offload']
        assert got['on']['losses'] == got['off']['losses']
        for n, v in got['off']['params'].items():
            assert np.array_equal(got['on']['params'][n], v)
        assert any(got['on']['spilled']) and got['off']['comms'] is None
        assert 'spilled' in got['refused'] and not got['host_view_spilled']
        stats = got['on']['stats']
        assert stats['prefetch_hits'] > 0 and stats['prefetch_misses'] == 0
        assert got['on']['comms'] == dict(want, **stats)
    assert res[0]['offload']['on']['stats'] == res[1]['offload']['on']['stats']


@pytest.mark.parametrize('world', [1, 2])
def test_from_jax_dist_state_carries_residuals_and_shadow(world):
    ref, results, _ = knob_worlds()[world]
    frac = 1.0
    want = ref['convert'][frac]
    for res in results:
        got = res[f'convert-{frac}']
        assert got['carried']['progress'] == want['progress']
        close_grads(got['grads'], want['grads'], 1e-5)
        head, tail = ef_head(got['comp_ef'], knob_worlds()[1][1][0]['compressed-1.0']['int8']['plan'])
        for k, w in want['comp_ef'].items():
            np.testing.assert_allclose(head[k], w, rtol=0, atol=1e-6)
            assert not np.any(tail[k])


def test_from_jax_kfac_state_of_an_offload_engine_resident_and_spilled():
    jreg, treg = small_registries()
    jk = kfac_tpu.KFACPreconditioner(registry=jreg, factor_update_steps=8, inv_update_steps=8,
                                     offload=2)
    tk = KFACPreconditioner(treg, device='cpu', factor_update_steps=8, inv_update_steps=8,
                            offload=2)
    resident = jk.init()
    state = convert.from_jax_kfac_state(resident, tk)
    assert not toffload.is_spilled(state)
    for n, v in resident.a.items():
        assert np.array_equal(state.a[n].numpy(), np.asarray(v))
    with pytest.raises(ValueError, match='spilled'):
        convert.from_jax_kfac_state(joffload.pump(jk, resident, step=3), tk)
