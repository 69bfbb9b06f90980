"""The port's numerical-health sentinel against the JAX package's.

- Each transition (``quarantine_update``, ``inversion_update``,
  ``is_degraded``, ``factor_ok``, ``all_finite``, ``mark_skipped``), the
  config's validation, the key schema and the host snapshot, on seeded
  inputs: equal (the per-layer dicts of the JAX state are the port's (L,)
  vectors in registry order).
- The fault scenarios from one engine state (the JAX state carried over by
  ``convert.from_jax_kfac_state``), fed the same grads and statistics, under
  EIGEN and INVERSE + Newton-Schulz: a factor update past the quarantine
  threshold (rolled back, damping escalated), and ``degrade_after``
  quarantined refreshes (the layer bypassed): factors, ``damping_mult``,
  ``quarantined``, ``quarantine_events``, ``bad_inv`` equal; factors rtol
  1e-5; preconditioned grads within 1e-5 of the step's max.
- A poisoned batch through both Trainers with ``skip_nonfinite``: skipped,
  nothing moves, ``skipped_steps`` equal; losses rtol 1e-5.
- With every damping multiplier at 1, the health path's grads equal the
  health-off path's bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kfac_tpu
from kfac_tpu import health as jhealth
from kfac_tpu import training as jtraining
from kfac_tpu.layers import capture as jcapture
from kfac_tpu.models import MLP as FlaxMLP
from kfac_tpu_torch import convert, health, tracing
from kfac_tpu_torch import warnings as twarnings
from kfac_tpu_torch.layers import capture, registry
from kfac_tpu_torch.models import MLP
from kfac_tpu_torch.preconditioner import KFACPreconditioner
from kfac_tpu_torch.training import Trainer

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

IN, HIDDEN, OUT = 6, 8, 5
NAMES = ['dense0', 'head']
FACTOR_DIMS = {'dense0': (IN + 1, HIDDEN), 'head': (HIDDEN + 1, OUT)}


def rng(seed):
    return np.random.default_rng(seed)


def t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------- transitions


def jax_counters(mult, quarantined, bad_inv, events, skipped=0):
    names = [f'l{i}' for i in range(len(mult))]
    return jhealth.HealthState(
        skipped_steps=jnp.asarray(skipped, jnp.int32),
        damping_mult={n: jnp.float32(v) for n, v in zip(names, mult)},
        quarantined={n: jnp.int32(v) for n, v in zip(names, quarantined)},
        bad_inv={n: jnp.int32(v) for n, v in zip(names, bad_inv)},
        quarantine_events={n: jnp.int32(v) for n, v in zip(names, events)},
    )


def torch_counters(mult, quarantined, bad_inv, events, skipped=0):
    i32 = torch.int32
    return health.HealthState(
        names=tuple(f'l{i}' for i in range(len(mult))),
        skipped_steps=torch.tensor(skipped, dtype=i32),
        damping_mult=t(np.float32(mult)),
        quarantined=torch.tensor(quarantined, dtype=i32),
        bad_inv=torch.tensor(bad_inv, dtype=i32),
        quarantine_events=torch.tensor(events, dtype=i32),
    )


def seeded_counters(seed, n=9):
    r = rng(seed)
    return dict(
        mult=np.float32(np.exp(r.uniform(0, 14, n))),
        quarantined=r.integers(0, 4, n).tolist(),
        bad_inv=r.integers(0, 7, n).tolist(),
        events=r.integers(0, 9, n).tolist(),
    )


CONFIGS = [
    dict(),
    dict(damping_escalation=3.0, damping_decay=0.25, max_damping_mult=50.0, degrade_after=1),
    dict(degrade_after=5, quarantine_threshold=None),
]


@pytest.mark.parametrize('cfg_kw', CONFIGS)
@pytest.mark.parametrize('seed', [0, 1])
def test_transitions_match_jax(cfg_kw, seed):
    c = seeded_counters(seed)
    ok = rng(seed + 10).random(len(c['mult'])) < 0.5
    tcfg, jcfg = health.HealthConfig(**cfg_kw), jhealth.HealthConfig(**cfg_kw)
    got = health.quarantine_update(
        tcfg, t(ok), t(c['mult']), torch.tensor(c['quarantined'], dtype=torch.int32),
        torch.tensor(c['events'], dtype=torch.int32),
    )
    want = jhealth.quarantine_update(
        jcfg, jnp.asarray(ok), jnp.asarray(c['mult']), jnp.asarray(c['quarantined'], jnp.int32),
        jnp.asarray(c['events'], jnp.int32),
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == {np.dtype('float32'): torch.float32, np.dtype('int32'): torch.int32}[w.dtype]
    got = health.inversion_update(
        tcfg, t(ok), torch.tensor(c['quarantined'], dtype=torch.int32),
        torch.tensor(c['bad_inv'], dtype=torch.int32),
    )
    want = jhealth.inversion_update(
        jcfg, jnp.asarray(ok), jnp.asarray(c['quarantined'], jnp.int32),
        jnp.asarray(c['bad_inv'], jnp.int32),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        health.is_degraded(tcfg, torch.tensor(c['bad_inv'])).numpy(),
        np.asarray(jhealth.is_degraded(jcfg, jnp.asarray(c['bad_inv']))),
    )


def test_factor_ok_matches_jax():
    r = rng(3)
    a = r.standard_normal((6, 40, 5)).astype(np.float32)
    f = np.einsum('bni,bnj->bij', a, a) / 40
    f[1] *= 1e9  # past the threshold at this damping
    f[2, 0, 1] = np.nan
    f[3, 2, 2] = np.inf
    f[4] *= 1e5
    damping = np.float32([1e-3, 1e-3, 1e-3, 1e-3, 1.0, 0.0])
    for threshold in (1e8, None, 50.0):
        got = health.factor_ok(t(f), t(damping), threshold)
        want = jhealth.factor_ok(jnp.asarray(f), jnp.asarray(damping), threshold)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_all_finite_matches_jax():
    r = rng(4)
    tree = {'a': r.standard_normal((3, 4)).astype(np.float32), 'b': [np.float32(2.0)]}
    for poison in (None, np.nan, np.inf, -np.inf):
        x = {k: (np.array(v, copy=True) if k == 'a' else v) for k, v in tree.items()}
        if poison is not None:
            x['a'][1, 2] = poison
        tx = {'a': t(x['a']), 'b': [torch.tensor(x['b'][0])], 'i': torch.tensor([1, 2])}
        jx = {'a': jnp.asarray(x['a']), 'b': [jnp.asarray(x['b'][0])], 'i': jnp.asarray([1, 2])}
        assert bool(health.all_finite(tx, torch.tensor(1.0))) == bool(
            jhealth.all_finite(jx, jnp.asarray(1.0))
        )


@pytest.mark.parametrize(
    'kw',
    [dict(damping_escalation=1.0), dict(damping_decay=1.0), dict(damping_decay=0.0),
     dict(max_damping_mult=5.0), dict(degrade_after=0), dict(quarantine_threshold=1.0)],
)
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as ours:
        health.HealthConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        jhealth.HealthConfig(**kw)
    assert str(ours.value) == str(theirs.value)
    assert dataclasses.asdict(health.HealthConfig()) == dataclasses.asdict(jhealth.HealthConfig())


def test_keys_summary_and_counters_match_jax():
    c = seeded_counters(5, n=4)
    cfg_t, cfg_j = health.HealthConfig(), jhealth.HealthConfig()
    ours = torch_counters(c['mult'], c['quarantined'], c['bad_inv'], c['events'], skipped=3)
    theirs = jax_counters(c['mult'], c['quarantined'], c['bad_inv'], c['events'], skipped=3)
    names = list(ours.names)
    assert health.health_metric_keys(names) == jhealth.health_metric_keys(names)
    assert health.summary(cfg_t, ours) == jhealth.summary(cfg_j, theirs)
    from kfac_tpu import tracing as jtracing

    got, want = tracing.health_counters(ours), jtracing.health_counters(theirs)
    assert got == want and list(got) == list(want)
    assert set(got) == set(health.health_metric_keys(names))


def test_check_and_warn_emits_once_per_layer_and_cause():
    c = seeded_counters(6, n=3)
    c['events'] = [0, 2, 1]
    c['bad_inv'] = [0, 1, 4]
    twarnings.reset_health_warnings()
    ours = torch_counters(c['mult'], c['quarantined'], c['bad_inv'], c['events'])
    with pytest.warns(twarnings.NumericalHealthWarning) as caught:
        snap = health.check_and_warn(health.HealthConfig(), ours, step=7)
    messages = sorted(str(w.message) for w in caught)
    assert len(messages) == 3  # l1 and l2 quarantined, l2 degraded
    assert snap['layers']['l2']['status'] == 'degraded'
    with warnings_as_errors():
        health.check_and_warn(health.HealthConfig(), ours, step=8)  # rate-limited
    twarnings.reset_health_warnings()


class warnings_as_errors:
    def __enter__(self):
        import warnings

        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter('error')

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)


def test_mark_skipped_matches_jax():
    kfac = engines('eigen')[1]
    state = kfac.init()
    skipped = health.mark_skipped(health.mark_skipped(state))
    assert skipped.step == 2 and int(skipped.health.skipped_steps) == 2
    assert skipped.a is state.a
    jk = engines('eigen')[0]
    js = jhealth.mark_skipped(jhealth.mark_skipped(jk.init()))
    assert int(js.step) == skipped.step and int(js.health.skipped_steps) == 2


# ---------------------------------------------------------- fault scenarios


def engines(method, **kw):
    """The JAX and the port's engine over the same MLP (6 -> 8 -> 5), health
    on, cadence 1/1."""
    opts = dict(
        damping=0.003, lr=0.1, factor_update_steps=1, inv_update_steps=1,
        health=kw.pop('health', True), **kw,
    )
    if method == 'inverse':
        opts.update(compute_method='inverse', inverse_solver='newton_schulz')
    else:
        opts.update(compute_method='eigen')
    jopts = dict(opts)
    if jopts['health'] is True:
        jopts['health'] = jhealth.HealthConfig(warn=False)
    if opts['health'] is True:
        opts['health'] = health.HealthConfig(warn=False)
    jreg = kfac_tpu.register_model(FlaxMLP(features=(HIDDEN,), num_classes=OUT), jnp.zeros((2, IN)))
    treg = registry.register_model(MLP(IN, (HIDDEN,), OUT, device='cpu'), device='cpu')
    assert list(jreg.layers) == list(treg.layers) == NAMES
    return kfac_tpu.KFACPreconditioner(registry=jreg, **jopts), KFACPreconditioner(treg, device='cpu', **opts)


def step_inputs(seed, poison=None):
    """(JAX grads, port grads, JAX stats, port stats) of one step; the
    ``poison`` layer's A statistic scaled by 1e12."""
    r = rng(seed)
    jgrads = {
        'dense0': {'kernel': r.standard_normal((IN, HIDDEN)), 'bias': r.standard_normal(HIDDEN)},
        'head': {'kernel': r.standard_normal((HIDDEN, OUT)), 'bias': r.standard_normal(OUT)},
    }
    jgrads = jax.tree_util.tree_map(lambda x: np.float32(x) * 0.1, jgrads)
    a, g = {}, {}
    for n, (da, dg) in FACTOR_DIMS.items():
        xa, xg = r.standard_normal((30, da)), r.standard_normal((30, dg))
        a[n], g[n] = np.float32(xa.T @ xa / 30), np.float32(xg.T @ xg / 30)
    if poison is not None:
        a[poison] = a[poison] * np.float32(1e12)
    jstats = jcapture.CapturedStats({k: jnp.asarray(v) for k, v in a.items()},
                                    {k: jnp.asarray(v) for k, v in g.items()})
    tstats = capture.CapturedStats({k: t(v) for k, v in a.items()}, {k: t(v) for k, v in g.items()})
    tgrads = {k: v.clone() for k, v in convert.from_flax_params(jgrads).items()}
    return jax.tree_util.tree_map(jnp.asarray, jgrads), tgrads, jstats, tstats


def assert_states_match(ts, js, tgrads, jgrads):
    assert ts.step == int(js.step)
    for n in NAMES:
        for side in ('a', 'g'):
            want = np.asarray(getattr(js, side)[n])
            np.testing.assert_allclose(getattr(ts, side)[n].numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.max(np.abs(want)), err_msg=f'{side} {n}')
    jh = js.health
    for field in ('damping_mult', 'quarantined', 'bad_inv', 'quarantine_events'):
        want = np.array([np.asarray(getattr(jh, field)[n]) for n in NAMES])
        np.testing.assert_array_equal(getattr(ts.health, field).numpy(), want, err_msg=field)
    assert int(ts.health.skipped_steps) == int(jh.skipped_steps)
    want = convert.from_flax_params(jax.device_get(jgrads))
    scale = max(float(np.max(np.abs(w.numpy()))) for w in want.values())
    for name, w in want.items():
        assert float((tgrads[name] - w).abs().max()) <= 1e-5 * scale, name


@pytest.mark.parametrize('method', ['eigen', 'inverse'])
def test_quarantine_then_degrade_match_jax(method):
    jk, tk = engines(method)
    js = jk.init()
    ts = convert.from_jax_kfac_state(js, tk)
    # two healthy steps, one capture past the threshold, then quarantined
    # captures and refreshes until the layer degrades, then a healthy one
    plan = [None, None, 'head', 'head', 'head', 'head', None]
    seen_degraded = False
    for i, poison in enumerate(plan):
        jg, tg, jst, tst = step_inputs(i, poison)
        js, jout = jk.step(js, jg, jst)
        ts, tout = tk.step(ts, tg, tst)
        assert_states_match(ts, js, tout, jout)
        if poison is not None:
            assert int(ts.health.quarantined[1]) > 0
        if int(ts.health.bad_inv[1]) >= 3:
            seen_degraded = True
    h = ts.health
    assert seen_degraded
    assert float(h.damping_mult[1]) > 1.0 and int(h.quarantine_events[1]) == 4
    assert int(h.quarantine_events[0]) == 0


@pytest.mark.parametrize('method', ['eigen', 'inverse'])
def test_health_at_unit_multiplier_equals_health_off(method):
    _, on = engines(method)
    _, off = engines(method, health=None)
    s_on, s_off = on.init(), off.init()
    for i in range(3):
        _, tg, _, tst = step_inputs(20 + i)
        s_on, g_on = on.step(s_on, tg, tst)
        s_off, g_off = off.step(s_off, tg, tst)
        assert float(s_on.health.damping_mult.max()) == 1.0
        for n in g_on:
            assert torch.equal(g_on[n], g_off[n]), n


# ----------------------------------------------------------- skip-step


def test_poisoned_batch_is_skipped_as_in_jax():
    r = rng(7)
    x = np.float32(r.standard_normal((16, IN)))
    y = r.integers(0, OUT, 16).astype(np.int32)
    flax = FlaxMLP(features=(HIDDEN,), num_classes=OUT)
    params = flax.init(jax.random.PRNGKey(0), jnp.asarray(x[:2]))['params']

    def jloss(p, ms, b):
        logits = flax.apply({'params': p}, b[0])
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * jax.nn.one_hot(b[1], OUT), -1)), ms

    jk = kfac_tpu.KFACPreconditioner(
        registry=kfac_tpu.register_model(flax, jnp.asarray(x[:2])), damping=0.003, lr=0.1,
        factor_update_steps=2, inv_update_steps=2, health=jhealth.HealthConfig(warn=False),
    )
    jt = jtraining.Trainer(loss_fn=jloss, optimizer=optax.sgd(0.1, momentum=0.9), kfac=jk)
    model = MLP(IN, (HIDDEN,), OUT, device='cpu')
    model.load_state_dict(convert.from_flax_params(jax.device_get(params)))

    def tloss(ms, b):
        logits = model(b[0])
        onehot = torch.nn.functional.one_hot(b[1].long(), OUT).float()
        return -torch.mean(torch.sum(torch.log_softmax(logits, -1) * onehot, -1)), ms

    tk = KFACPreconditioner(
        registry.register_model(model, device='cpu'), damping=0.003, lr=0.1,
        factor_update_steps=2, inv_update_steps=2, health=health.HealthConfig(warn=False),
        device='cpu',
    )
    tt = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), tloss,
                 kfac=tk, device='cpu')
    js, ts = jt.init(params), tt.init()
    jl, tl = [], []
    for i in range(6):
        xb = np.array(x[(i % 2) * 8:(i % 2) * 8 + 8], copy=True)
        if i == 3:
            xb[0, 0] = np.nan
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            momentum = {n: tt.optimizer.state[p]['momentum_buffer'].clone()
                        for n, p in model.named_parameters()}
            factors = {n: a.clone() for n, a in ts.kfac_state.a.items()}
        yb = y[(i % 2) * 8:(i % 2) * 8 + 8]
        js, l = jt.step(js, (jnp.asarray(xb), jnp.asarray(yb)))
        jl.append(float(l))
        ts, l = tt.step(ts, (t(xb), t(yb)))
        tl.append(float(l))
        if i == 3:
            assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
            assert all(torch.equal(tt.optimizer.state[p]['momentum_buffer'], momentum[n])
                       for n, p in model.named_parameters())
            assert all(torch.equal(a, factors[n]) for n, a in ts.kfac_state.a.items())
    assert int(ts.kfac_state.health.skipped_steps) == int(js.kfac_state.health.skipped_steps) == 1
    assert ts.kfac_state.step == int(js.kfac_state.step) == 6
    finite = [i for i in range(6) if i != 3]
    np.testing.assert_allclose([tl[i] for i in finite], [jl[i] for i in finite], rtol=1e-5)
    assert np.isnan(tl[3]) and np.isnan(jl[3])
    assert tt.check_health(ts)['skipped_steps'] == 1
