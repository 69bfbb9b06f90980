"""The port's metrics, flight recorder and sinks against the JAX package's.

- ``metric_keys`` equal to the JAX schema for every family toggle; the
  knob normalisation (``True``, an int capacity, a config) the same.
- The bench's LM loop at a small size (batch 2, seq 32, d_model 64, 2
  layers) through both Trainers from the same weights with health,
  metrics and a flight ring of 8 on, 12 steps: drained scalars within
  1e-5 relative (a factor's Gershgorin bounds within 1e-5 of its
  ``lmax``), staleness and health counters exact; the rings' records the
  same steps and keys, wrapped at their capacity.
- ``gershgorin_condition_bound`` and ``gershgorin_bounds`` against JAX's at
  damping 0, 1e-3 and NaN; the norm variant's plain version against JAX's
  per-layer norms.
- ``JSONLWriter`` writes the JAX writer's bytes; ``tools/kfac_inspect.py``
  reads the port's JSONL and a port ``PostmortemWriter`` bundle, whose
  files and manifest keys are the JAX writer's.
"""

import json
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kfac_tpu
from kfac_tpu import health as jhealth
from kfac_tpu import training as jtraining
from kfac_tpu.models import TransformerLM as JaxLM
from kfac_tpu.models import lm_loss as jax_lm_loss
from kfac_tpu.observability import flight_recorder as jflight
from kfac_tpu.observability import metrics as jmetrics
from kfac_tpu.observability import sinks as jsinks
from kfac_tpu.ops import factors as jfactors
from kfac_tpu_torch import convert, health
from kfac_tpu_torch.layers import registry
from kfac_tpu_torch.models import TransformerLM, lm_loss
from kfac_tpu_torch.observability import flight_recorder, metrics, sinks
from kfac_tpu_torch.ops import factors, klclip
from kfac_tpu_torch.preconditioner import KFACPreconditioner
from kfac_tpu_torch.training import Trainer

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, 'tools'))
import kfac_inspect  # noqa: E402

CFG = dict(vocab_size=128, d_model=64, num_heads=4, num_layers=2, max_len=32)
STEPS = 12
CAPACITY = 8
# captures at 0, 4 and 8; refreshes at 0 and 6
KFAC = dict(damping=0.003, lr=0.1, factor_update_steps=4, inv_update_steps=6, metrics=True,
            flight=CAPACITY)


def tokens(seed):
    t = np.random.default_rng(seed).integers(0, CFG['vocab_size'], (2, 32)).astype(np.int32)
    return t, np.roll(t, -1, axis=1)


@pytest.mark.parametrize(
    'cfg_kw',
    [dict(), dict(grad_norms=False), dict(factor_bounds=False), dict(staleness=False),
     dict(grad_norms=False, factor_bounds=False)],
)
def test_metric_keys_match_jax(cfg_kw):
    names = ['block0/attn/q_proj', 'head']
    assert metrics.metric_keys(metrics.MetricsConfig(**cfg_kw), names) == jmetrics.metric_keys(
        jmetrics.MetricsConfig(**cfg_kw), names
    )
    ms = metrics.init_metrics(metrics.MetricsConfig(**cfg_kw), names, 'cpu')
    jms = jmetrics.init_metrics(jmetrics.MetricsConfig(**cfg_kw), names)
    assert ms.keys == jms.keys
    np.testing.assert_array_equal(ms.scalars.numpy(), np.asarray(jms.scalars))
    with pytest.raises(ValueError):
        metrics.MetricsConfig(grad_norms=False, factor_bounds=False, staleness=False)


def small_registry():
    return registry.register_model(torch.nn.Sequential(torch.nn.Linear(4, 3)), device='cpu')


@pytest.mark.parametrize(
    'kw,want',
    [(dict(flight=5), (5, True)), (dict(flight=True), (64, True)), (dict(metrics=True), (None, True)),
     (dict(metrics=False, flight=False), (None, False))],
)
def test_knobs_normalise_as_in_jax(kw, want):
    kfac = KFACPreconditioner(small_registry(), device='cpu', **kw)
    capacity = None if kfac.flight is None else kfac.flight.capacity
    assert (capacity, kfac.metrics is not None) == want
    state = kfac.init()
    assert (state.flight is not None) == (capacity is not None)
    if capacity is not None:
        assert state.flight.scalars.shape == (capacity, len(state.metrics.keys))
    for bad in (dict(metrics='yes'), dict(flight='yes'), dict(health='yes')):
        with pytest.raises(TypeError):
            KFACPreconditioner(small_registry(), device='cpu', **bad)


def trainers():
    """The JAX and the port's Trainer over the small LM from the same
    weights, health (no warnings), metrics and a ring of CAPACITY on."""
    t, _ = tokens(0)
    model = JaxLM(**CFG)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(t))['params']
    jreg = kfac_tpu.register_model(model, jnp.asarray(t), skip_layers=['lm_head'])
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')  # inverse cadence not a multiple
        jk = kfac_tpu.KFACPreconditioner(
            registry=jreg, health=jhealth.HealthConfig(warn=False), **KFAC
        )
        jloss = jax_lm_loss(model)
        jt = jtraining.Trainer(
            loss_fn=lambda p, ms, b: (jloss(p, b), ms), optimizer=optax.sgd(0.1, momentum=0.9),
            kfac=jk,
        )
        tmodel = TransformerLM(**CFG, device='cpu')
        tmodel.load_state_dict(convert.from_flax_params(jax.device_get(params)))
        tk = KFACPreconditioner(
            registry.register_model(tmodel, skip_layers=['lm_head'], device='cpu'),
            health=health.HealthConfig(warn=False), device='cpu', **KFAC,
        )
    tloss = lm_loss(tmodel)
    tt = Trainer(tmodel, torch.optim.SGD(tmodel.parameters(), lr=0.1, momentum=0.9),
                 lambda ms, b: (tloss(b), ms), kfac=tk, device='cpu')
    return jt, jt.init(params), tt, tt.init()


@pytest.fixture(scope='module')
def runs():
    """Both Trainers after STEPS steps on the same batches."""
    jt, js, tt, ts = trainers()
    for i in range(STEPS):
        js, _ = jt.step(js, tuple(jnp.asarray(x) for x in tokens(i)))
        ts, _ = tt.step(ts, tuple(torch.from_numpy(x).long() for x in tokens(i)))
    return jt, js, tt, ts


def close_records(got, want):
    # the metric keys in schema order; the JAX health dicts come out of its
    # jitted step with their layers sorted, so the health keys compare as a set
    assert sorted(got) == sorted(want)
    assert [k for k in got if not k.startswith('health/')] == [
        k for k in want if not k.startswith('health/')
    ]
    for k, w in want.items():
        g = got[k]
        if isinstance(w, int) or k.startswith(('factor_staleness/', 'inv_staleness/', 'health/')) \
                or k in ('step', 'process_index'):
            assert g == w, k
        elif k.startswith(('factor_lmin/', 'factor_lmax/')):
            side, layer = k.split('/', 2)[1:]
            scale = abs(want[f'factor_lmax/{side}/{layer}'])
            assert abs(g - w) <= 1e-5 * scale, k
        else:
            assert abs(g - w) <= 1e-5 * abs(w), (k, g, w)


def test_drained_scalars_match_jax(runs):
    _, js, _, ts = runs
    want = jmetrics.MetricsCollector().drain(js)
    got = metrics.MetricsCollector().drain(ts)
    close_records(got, want)
    assert got['step'] == STEPS
    # staleness: refreshes at 0 and 6, captures at 0, 4 and 8, the last step 11
    layer = 'block0/attn/q_proj'
    assert got[f'factor_staleness/{layer}'] == 3.0 and got[f'inv_staleness/{layer}'] == 5.0
    assert got['health/skipped_steps'] == 0


def test_flight_rings_match_jax_and_wrap(runs):
    _, js, _, ts = runs
    want = jflight.drain_flight(js)
    got = flight_recorder.drain_flight(ts)
    assert [r['step'] for r in got] == list(range(STEPS - CAPACITY, STEPS))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close_records(g, w)
        assert 'loss' in g and flight_recorder.skew_ratio(g, 'loss') == 0.0


def test_flight_ring_records_and_drains_like_jax():
    keys = ('kl_clip_scale', 'x')
    ring = flight_recorder.init_flight(flight_recorder.FlightRecorderConfig(capacity=3), keys, 'cpu')
    jring = jflight.init_flight(jflight.FlightRecorderConfig(capacity=3), keys)
    for step in range(7):
        vals = np.float32([1.0 / (step + 1), step])
        loss = None if step == 5 else np.float32(step * 0.5)
        ring = flight_recorder.record(
            ring, step, torch.from_numpy(vals), loss=None if loss is None else torch.tensor(loss),
            grad_norm=torch.tensor(np.float32(step + 2)),
        )
        jring = jflight.record(
            jring, jnp.int32(step), jnp.asarray(vals),
            loss=None if loss is None else jnp.asarray(loss), grad_norm=jnp.float32(step + 2),
        )
    got, want = flight_recorder.drain_flight(ring), jflight.drain_flight(jring)
    assert got == want
    assert [r['step'] for r in got] == [4, 5, 6] and 'loss' not in got[1]


def test_gershgorin_condition_bound_matches_jax():
    # rtol 1e-6: row sums in another order than XLA's
    r = np.random.default_rng(0)
    a = np.float32(r.standard_normal((3, 30, 6)))
    f = np.einsum('bni,bnj->bij', a, a) / 30
    f[2, 1, 1] = np.nan
    for damping in (0.0, 1e-3, float('nan')):
        got = factors.gershgorin_condition_bound(torch.from_numpy(f), damping)
        want = jfactors.gershgorin_condition_bound(jnp.asarray(f), damping)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        assert np.isnan(got.numpy()[2])  # a NaN factor fails closed
    # lam_max / tiny overflows above lam_max ~ 4: capped at f32 max
    big = np.float32(10) * f[0]
    assert float(factors.gershgorin_condition_bound(torch.from_numpy(big), 0.0)) == float(
        jfactors.gershgorin_condition_bound(jnp.asarray(big), 0.0)
    ) == float(np.finfo(np.float32).max)
    per_matrix = np.float32([0.0, 1e-3, 1.0])
    got = factors.gershgorin_condition_bound(torch.from_numpy(f[0]), torch.tensor(1e-3))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(jfactors.gershgorin_condition_bound(f[0], 1e-3)),
                               rtol=1e-6)
    got = factors.gershgorin_condition_bound(torch.from_numpy(f), torch.from_numpy(per_matrix))
    want = jfactors.gershgorin_condition_bound(jnp.asarray(f), jnp.asarray(per_matrix))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_gershgorin_bounds_match_jax():
    # within 1e-6 of lmax: row sums in another order than XLA's
    r = np.random.default_rng(1)
    mats = [np.float32(r.standard_normal((d, d))) for d in (5, 7, 5, 3)]
    mats = [m + m.T for m in mats]
    lmin, lmax = metrics.gershgorin_bounds_each([torch.from_numpy(m) for m in mats])
    for k, m in enumerate(mats):
        wmin, wmax = (float(x) for x in jmetrics.gershgorin_bounds(jnp.asarray(m)))
        assert abs(float(lmin[k]) - wmin) <= 1e-6 * wmax and abs(float(lmax[k]) - wmax) <= 1e-6 * wmax
    stack = np.stack([mats[0], mats[2]])
    got = [float(x) for x in metrics.gershgorin_bounds(torch.from_numpy(stack))]
    want = [float(x) for x in jmetrics.gershgorin_bounds(jnp.asarray(stack))]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * want[1])


def test_norm_variant_plain_matches_jax_norms():
    r = np.random.default_rng(2)
    shapes = [(64, 65), (10, 65), (7, 3)]
    ps = [np.float32(r.standard_normal(s)) for s in shapes]
    gs = [np.float32(r.standard_normal(s)) for s in shapes]
    tp, tg = [torch.from_numpy(x) for x in ps], [torch.from_numpy(x) for x in gs]
    terms, vg, scale, g_sq, p_sq = klclip.klclip_dot_norms_many(tp, tg, 0.1, 0.001)
    for x, y in zip((terms, vg, scale), klclip.klclip_dot_many(tp, tg, 0.1, 0.001)):
        assert torch.equal(x, y)
    for k, (p, g) in enumerate(zip(ps, gs)):
        want_g = float(jnp.sqrt(jnp.sum(jnp.asarray(g) * jnp.asarray(g))))
        want_p = float(jnp.sqrt(jnp.sum(jnp.asarray(p) * jnp.asarray(p))))
        assert abs(float(torch.sqrt(g_sq[k])) - want_g) <= 1e-6 * want_g
        assert abs(float(torch.sqrt(p_sq[k])) - want_p) <= 1e-6 * want_p
    assert klclip.klclip_dot_norms_many.launches == 0  # CPU tensors: the plain version


def test_jsonl_writer_writes_the_jax_bytes(tmp_path):
    records = [{'step': 1, 'kl_clip_scale': 0.5, 'grad_norm/a': np.float32(2.0)},
               {}, {'step': 2, 'x': torch.tensor(3.5)}]
    header = {'kind': 'run_header', 'run_id': 'r1', 'schema': 1, 'stream': 'metrics'}
    with sinks.JSONLWriter(tmp_path / 'port.jsonl', run_header=header) as w:
        for rec in records:
            w.write(rec)
    with jsinks.JSONLWriter(tmp_path / 'jax.jsonl', run_header=header) as w:
        for rec in records:
            w.write({k: (float(v) if isinstance(v, torch.Tensor) else v) for k, v in rec.items()})
    assert (tmp_path / 'port.jsonl').read_bytes() == (tmp_path / 'jax.jsonl').read_bytes()


def test_kfac_inspect_reads_the_port_jsonl(runs, tmp_path, capsys):
    _, js, _, ts = runs
    path = tmp_path / 'metrics.jsonl'
    with sinks.JSONLWriter(path) as w:
        for rec in flight_recorder.drain_flight(ts):
            w.write(rec)
    jpath = tmp_path / 'jax.jsonl'
    with jsinks.JSONLWriter(jpath) as w:
        for rec in jflight.drain_flight(js):
            w.write(rec)
    got = kfac_inspect.analyze(kfac_inspect.load_jsonl(str(path)))
    want = kfac_inspect.analyze(kfac_inspect.load_jsonl(str(jpath)))
    assert got['n_records'] == CAPACITY and got['steps'] == [STEPS - CAPACITY, STEPS - 1]
    assert [e['kind'] for e in got['events']] == [e['kind'] for e in want['events']]
    assert kfac_inspect.main(['--json', str(path)]) == 0
    assert json.loads(capsys.readouterr().out)['n_records'] == CAPACITY


def test_postmortem_bundle_matches_the_jax_layout(runs, tmp_path, capsys):
    jt, js, tt, ts = runs
    # a skipped step in both: a skip event for each writer
    jk, tk = jt.kfac, tt.kfac
    js = js._replace(kfac_state=jhealth.mark_skipped(js.kfac_state))
    ts.kfac_state = health.mark_skipped(ts.kfac_state)
    ours = flight_recorder.PostmortemWriter(tmp_path / 'port', engine=tk, run_id='r1')
    theirs = jflight.PostmortemWriter(tmp_path / 'jax', engine=jk, run_id='r1')
    bundle = ours.observe(ts)
    jbundle = theirs.observe(js)
    assert bundle is not None and jbundle is not None
    assert os.path.basename(bundle) == os.path.basename(jbundle)
    assert ours.observe(ts) is None  # once per event
    man = json.load(open(os.path.join(bundle, 'MANIFEST.json')))
    jman = json.load(open(os.path.join(jbundle, 'MANIFEST.json')))
    assert sorted(man) == sorted(jman)
    assert set(man['files']) == set(jman['files']) - {'comms.json', 'compile_events.jsonl',
                                                      'compile_memory.json'}
    assert man['reason'] == jman['reason'] == 'skip' and man['step'] == jman['step']
    assert sorted(man['record']) == sorted(jman['record'])
    h = json.load(open(os.path.join(bundle, 'health.json')))
    assert h == json.load(open(os.path.join(jbundle, 'health.json')))
    f = json.load(open(os.path.join(bundle, 'factors.json')))
    jf = json.load(open(os.path.join(jbundle, 'factors.json')))
    assert sorted(f) == sorted(jf) and sorted(f[next(iter(f))]) == sorted(jf[next(iter(jf))])
    assert open(os.path.join(bundle, 'describe.txt')).read() == open(
        os.path.join(jbundle, 'describe.txt')).read()
    loaded = kfac_inspect.load_bundle(bundle)
    assert loaded['manifest']['reason'] == 'skip' and len(loaded['history']) == CAPACITY
    assert kfac_inspect.main([bundle]) == 0
    assert 'postmortem bundle' in capsys.readouterr().out


def test_memory_usage_matches_jax(runs):
    jt, js, tt, ts = runs
    assert tt.kfac.memory_usage(ts.kfac_state) == jt.kfac.memory_usage(js.kfac_state)


def test_convert_carries_health_and_metrics_mid_run(runs):
    jt, js, tt, _ = runs
    jk = js.kfac_state
    ts = convert.from_jax_kfac_state(jk, tt.kfac)
    assert ts.step == int(jk.step) == STEPS
    np.testing.assert_array_equal(ts.metrics.scalars.numpy(), np.asarray(jk.metrics.scalars))
    np.testing.assert_array_equal(ts.metrics.last_factor_step.numpy(), np.asarray(jk.metrics.last_factor_step))
    np.testing.assert_array_equal(ts.metrics.last_inv_step.numpy(), np.asarray(jk.metrics.last_inv_step))
    from kfac_tpu import tracing as jtracing
    from kfac_tpu_torch import tracing

    assert tracing.health_counters(ts) == jtracing.health_counters(jk)
    assert int(ts.flight.steps.max()) == -1  # the ring starts empty
