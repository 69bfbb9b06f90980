"""The port's checkpoint module against the JAX package's.

Both engines run the same MLP (6 -> 8 -> 4, flax weights converted with
``convert``) for three steps on one seeded batch, each with its own capture;
then:

- JAX ``checkpoint.save`` + ``restore`` and the port's give the same durable
  content (step, factors, health counters) and the same preconditioned grads
  on the next batch, under EIGEN, INVERSE + Cholesky, INVERSE +
  Newton-Schulz and EIGEN with the health sentinel;
- ``save_factors`` files move both ways through numpy: the port's ``.npz``
  into JAX's ``insert_factors`` + ``rematerialize``, JAX's
  ``extract_factors`` written in the port's layout into the port's
  ``load_factors``;
- ``convert.from_jax_durable`` continues a JAX run in the port;
- ``rematerialize`` of a live state is the JAX engine's: Newton-Schulz
  warm-starts from the current inverses, and with the health sentinel a
  layer whose factor went bad keeps its last good inverse;
- the health counters round-trip, the sentinel toggled on or off between
  save and restore, as in the JAX package;
- an async save holds the values of its call, whatever changes after.

Tolerances are those of ``tests/test_torch_preconditioner.py``: factors
(and inverses) rtol 1e-4 with atol 1e-4 x each one's max; preconditioned grads rtol
1e-4 with atol 1e-4 x the step's max |grad|. Health counters are equal.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kfac_tpu
from kfac_tpu import checkpoint as jcheckpoint
from kfac_tpu import health as jhealth
from kfac_tpu.models import MLP as FlaxMLP
from kfac_tpu_torch import checkpoint, convert, health
from kfac_tpu_torch.layers import capture, registry
from kfac_tpu_torch.models import MLP
from kfac_tpu_torch.ops import factors
from kfac_tpu_torch.preconditioner import KFACPreconditioner
from kfac_tpu_torch.warnings import CheckpointResilienceWarning

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

IN, HIDDEN, OUT = 6, 8, 4
NAMES = ['dense0', 'head']
STEPS = 3
CONFIGS = {
    'eigen': dict(compute_method='eigen'),
    'inverse-cholesky': dict(compute_method='inverse', inverse_solver='cholesky'),
    'inverse-newton-schulz': dict(compute_method='inverse', inverse_solver='newton_schulz'),
    'eigen-health': dict(compute_method='eigen', health=True),
}


def batch(seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((32, IN)).astype(np.float32)
    y = np.tanh(x @ r.standard_normal((IN, OUT))).astype(np.float32)
    return x, y


class Pair:
    """The JAX and the port's engine over one MLP, from the same weights;
    ``step`` takes one capture step in both, each with its own capture, and
    an SGD(0.05) update of its weights."""

    def __init__(self, health_on=False, poison=None, **kw):
        opts = dict(damping=0.003, lr=0.1, **kw)
        x, _ = batch(0)
        self.flax = FlaxMLP(features=(HIDDEN,), num_classes=OUT)
        self.params = self.flax.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
        self.jk = kfac_tpu.KFACPreconditioner(
            registry=kfac_tpu.register_model(self.flax, jnp.asarray(x)),
            health=jhealth.HealthConfig(warn=False) if health_on else None, **opts,
        )
        self.model = MLP(IN, (HIDDEN,), OUT, device='cpu')
        self.model.load_state_dict(convert.from_flax_params(jax.device_get(self.params)))
        self.tk = KFACPreconditioner(
            registry.register_model(self.model, device='cpu'),
            health=health.HealthConfig(warn=False) if health_on else None,
            device='cpu', **opts,
        )
        self.poison = poison
        self.js, self.ts = self.jk.init(), self.tk.init()

    def jax_grads_stats(self, seed):
        x, y = batch(seed)

        def loss(p, b):
            return jnp.mean((self.flax.apply({'params': p}, b[0]) - b[1]) ** 2)

        (_, _), grads, stats = kfac_tpu.CurvatureCapture(self.jk.registry).value_stats_and_grad(
            loss
        )(self.params, (jnp.asarray(x), jnp.asarray(y)))
        return grads, stats

    def step(self, seed, poison=False):
        grads, stats = self.jax_grads_stats(seed)
        x, y = batch(seed)
        (_, _), tgrads, tstats = capture.CurvatureCapture(self.tk.registry).value_stats_and_grad(
            lambda b: torch.mean((self.model(b[0]) - b[1]) ** 2)
        )((torch.from_numpy(x), torch.from_numpy(y)))
        if poison:
            stats.a['head'] = stats.a['head'] * 1e12
            tstats.a['head'] = tstats.a['head'] * 1e12
        self.js, jpg = self.jk.step(self.js, grads, stats)
        self.ts, tpg = self.tk.step(self.ts, tgrads, tstats)
        self.params = jax.tree_util.tree_map(lambda p, g: p - 0.05 * g, self.params, jpg)
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p -= 0.05 * tpg[n]

    def grads_on(self, seed):
        """The next batch's raw grads (JAX's, and converted for the port)."""
        grads, stats = self.jax_grads_stats(seed)
        return grads, convert.from_flax_params(jax.device_get(grads)), stats


def assert_factors_close(tfac, jfac, what=''):
    for side in ('a', 'g'):
        for n in NAMES:
            want = np.asarray(jfac[side][n])
            np.testing.assert_allclose(
                np.asarray(tfac[side][n]), want, rtol=1e-4,
                atol=1e-4 * float(np.max(np.abs(want))), err_msg=f'{what} {side} {n}',
            )


def assert_pgrads_close(tpg, jpg):
    want = convert.from_flax_params(jax.device_get(jpg))
    scale = max(float(w.abs().max()) for w in want.values())
    for n, w in want.items():
        np.testing.assert_allclose(
            tpg[n].numpy(), w.numpy(), rtol=1e-4, atol=1e-4 * scale, err_msg=n,
        )


def jax_health(jh):
    return {
        'skipped_steps': int(jh.skipped_steps),
        **{f: [float(np.asarray(getattr(jh, f)[n])) for n in NAMES]
           for f in ('damping_mult', 'quarantined', 'bad_inv', 'quarantine_events')},
    }


def port_health(th):
    return {
        'skipped_steps': int(th.skipped_steps),
        **{f: [float(v) for v in getattr(th, f).tolist()]
           for f in ('damping_mult', 'quarantined', 'bad_inv', 'quarantine_events')},
    }


# ---------------------------------------------------------- save / restore


@pytest.mark.parametrize('config', list(CONFIGS), ids=list(CONFIGS))
def test_save_restore_matches_jax(tmp_path, config):
    kw = dict(CONFIGS[config])
    pair = Pair(health_on=kw.pop('health', False), **kw)
    for i in range(STEPS):
        pair.step(i, poison=pair.tk.health is not None and i == 1)
    jcheckpoint.save(str(tmp_path / 'jax'), pair.js, engine=pair.jk)
    jrest, _ = jcheckpoint.restore(str(tmp_path / 'jax'), pair.jk)
    extra = {'model': pair.model.state_dict()}
    checkpoint.save(str(tmp_path / 'port'), pair.ts, extra=extra, engine=pair.tk)
    trest, textra = checkpoint.restore(str(tmp_path / 'port'), pair.tk)

    # the port's round trip is exact, its extras included
    td, saved = checkpoint.durable_state(trest), checkpoint.durable_state(pair.ts)
    assert td['step'] == saved['step'] == STEPS
    for side in ('a', 'g'):
        assert all(torch.equal(td[side][n], saved[side][n]) for n in NAMES)
    assert all(torch.equal(textra['model'][k], v) for k, v in extra['model'].items())
    # the same durable content as JAX's round trip
    jd = jcheckpoint.durable_state(jrest)
    assert int(jd['step']) == td['step']
    assert_factors_close(td, jd)
    assert ('health' in td) == ('health' in jd) == (pair.tk.health is not None)
    if 'health' in td:
        assert port_health(trest.health) == jax_health(jrest.health)
        assert max(port_health(trest.health)['quarantine_events']) == 1
    # the same preconditioned grads on the next batch
    jgrads, tgrads, _ = pair.grads_on(STEPS)
    assert_pgrads_close(pair.tk.precondition(trest, tgrads), pair.jk.precondition(jrest, jgrads))
    # the manifests carry the same keys and layout
    tman = json.load(open(str(tmp_path / 'port') + '.manifest.json'))
    jman = json.load(open(str(tmp_path / 'jax') + '.manifest.json'))
    assert set(tman) == set(jman)
    assert set(tman['topology']) == set(jman['topology'])
    assert {k: tman[k] for k in ('format', 'engine', 'compute_method')} == {
        k: jman[k] for k in ('format', 'engine', 'compute_method')
    }


def test_restore_rejects_another_layout_corrupt_factors_and_torn_writes(tmp_path):
    pair = Pair()
    pair.step(0)
    path = str(tmp_path / 'ck')
    checkpoint.save(path, pair.ts, engine=pair.tk)
    man = json.load(open(path + '.manifest.json'))
    with open(path + '.manifest.json', 'w') as f:
        json.dump(dict(man, engine='DistributedKFAC', bucket_granularity=128), f)
    # another layout migrates through per-layer factors, with the JAX
    # package's warning (its refusals: tests/test_torch_kaisa.py)
    with pytest.warns(UserWarning, match='migrating through per-layer factors'):
        migrated, _ = checkpoint.restore(path, pair.tk)
    assert all(torch.equal(migrated.a[n], pair.ts.a[n]) for n in pair.ts.a)
    # a non-finite factor is named by its layer
    bad = checkpoint.durable_state(pair.ts)
    bad['a'] = dict(bad['a'], head=bad['a']['head'].clone())
    bad['a']['head'][0, 0] = float('nan')
    pair.ts.a['head'], good = bad['a']['head'], pair.ts.a['head']
    checkpoint.save(str(tmp_path / 'nan'), pair.ts, engine=pair.tk)
    with pytest.raises(ValueError, match="layer 'head' contains 1 non-finite"):
        checkpoint.restore(str(tmp_path / 'nan'), pair.tk)
    pair.ts.a['head'] = good[:-1, :-1].clone()
    checkpoint.save(str(tmp_path / 'shape'), pair.ts, engine=pair.tk)
    with pytest.raises(ValueError, match="layer 'head' has shape"):
        checkpoint.restore(str(tmp_path / 'shape'), pair.tk)
    # a directory without its commit marker never restores
    os.remove(os.path.join(str(tmp_path / 'shape'), checkpoint.COMMIT_MARKER))
    with pytest.raises(ValueError, match='not committed'):
        checkpoint.restore(str(tmp_path / 'shape'), pair.tk)


# ------------------------------------------------------ portable factors


@pytest.mark.parametrize('config', ['eigen', 'inverse-newton-schulz'])
def test_save_factors_moves_both_ways_through_numpy(tmp_path, config):
    pair = Pair(**CONFIGS[config])
    for i in range(STEPS):
        pair.step(i)
    jgrads, tgrads, _ = pair.grads_on(STEPS)

    # the port's .npz into JAX's insert_factors + rematerialize
    path = str(tmp_path / 'port.npz')
    checkpoint.save_factors(path, pair.tk, pair.ts)
    assert os.path.exists(path + '.manifest.json')
    with np.load(path) as z:
        assert sorted(z.files) == sorted(['step'] + [f'factors/{n}/{s}' for n in NAMES for s in 'ag'])
        jstate = pair.jk.insert_factors(pair.jk.init(), {
            n: {s: jnp.asarray(z[f'factors/{n}/{s}']) for s in 'ag'} for n in NAMES
        })._replace(step=jnp.asarray(int(z['step']), jnp.int32))
    jstate = pair.jk.rematerialize(jstate)
    tstate = checkpoint.load_factors(path, pair.tk)
    assert tstate.step == int(jstate.step) == STEPS
    assert_pgrads_close(pair.tk.precondition(tstate, tgrads), pair.jk.precondition(jstate, jgrads))

    # JAX's extract_factors, written in the port's layout, into load_factors
    jf = pair.jk.extract_factors(pair.js)
    path = str(tmp_path / 'jax.npz')
    np.savez(path, step=np.int64(int(pair.js.step)), **{
        f'factors/{n}/{s}': np.asarray(jf[n][s]) for n in NAMES for s in 'ag'
    })
    tstate = checkpoint.load_factors(path, pair.tk)
    jstate = pair.jk.rematerialize(pair.jk.insert_factors(pair.jk.init(), jf)._replace(step=pair.js.step))
    assert tstate.step == STEPS
    assert_factors_close(checkpoint.durable_state(tstate), jcheckpoint.durable_state(pair.js))
    assert_pgrads_close(pair.tk.precondition(tstate, tgrads), pair.jk.precondition(jstate, jgrads))

    # another layer set is refused
    np.savez(path, step=np.int64(1), **{f'factors/head/{s}': np.asarray(jf['head'][s]) for s in 'ag'})
    with pytest.raises(ValueError, match='layer sets must be identical'):
        checkpoint.load_factors(path, pair.tk)


@pytest.mark.parametrize('config', ['eigen', 'inverse-newton-schulz', 'eigen-health'])
def test_from_jax_durable_continues_a_jax_run(config):
    kw = dict(CONFIGS[config])
    pair = Pair(health_on=kw.pop('health', False), **kw)
    for i in range(STEPS):
        pair.step(i, poison=pair.tk.health is not None and i == 1)
    durable = jax.device_get(jcheckpoint.durable_state(pair.js))
    tstate = convert.from_jax_durable(durable, pair.tk)
    # JAX's own restore path: the durable slice into init(), rematerialized
    # (Newton-Schulz starts cold there too), its counters kept
    jstate = pair.jk.insert_factors(pair.jk.init(), pair.jk.extract_factors(pair.js))
    jstate = pair.jk.rematerialize(jstate._replace(step=pair.js.step))
    if pair.js.health is not None:
        jstate = jstate._replace(health=pair.js.health)
        assert port_health(tstate.health) == jax_health(pair.js.health)
    assert tstate.step == STEPS
    # one more capture step in both, from the same grads and statistics
    jgrads, tgrads, jstats = pair.grads_on(STEPS)
    tstats = capture.CapturedStats(
        {n: torch.from_numpy(np.array(v)) for n, v in jstats.a.items()},
        {n: torch.from_numpy(np.array(v)) for n, v in jstats.g.items()},
    )
    jstate, jpg = pair.jk.step(jstate, jgrads, jstats)
    tstate, tpg = pair.tk.step(tstate, tgrads, tstats)
    assert tstate.step == int(jstate.step) == STEPS + 1
    assert_pgrads_close(tpg, jpg)
    assert_factors_close(checkpoint.durable_state(tstate), jcheckpoint.durable_state(jstate))


# ------------------------------------------------------- rematerialize

# (engine options, health on, the head's A factor before the call: None
# keeps it, else that multiple of the identity)
LIVE_CASES = {
    'newton-schulz': (CONFIGS['inverse-newton-schulz'], False, None),
    'cholesky-health-not-pd': (CONFIGS['inverse-cholesky'], True, -1.0),
    'newton-schulz-health-nan': (CONFIGS['inverse-newton-schulz'], True, float('nan')),
}


@pytest.mark.parametrize('case', list(LIVE_CASES))
def test_rematerialize_of_a_live_state_matches_jax(case):
    kw, health_on, bad = LIVE_CASES[case]
    pair = Pair(health_on=health_on, **kw)
    for i in range(STEPS):
        pair.step(i)
    js, ts = pair.js, pair.ts
    before = {k: getattr(ts, k)['head'].clone() for k in ('a_inv', 'g_inv')}
    if bad is not None:
        d = ts.a['head'].shape[0]
        ts = dataclasses.replace(ts, a=dict(ts.a, head=torch.eye(d) * bad))
        js = js._replace(a=dict(js.a, head=jnp.eye(d, dtype=jnp.float32) * bad))
    warm0 = factors.newton_schulz_inverse_info.starts['warm']
    trem, jrem = pair.tk.rematerialize(ts), pair.jk.rematerialize(js)
    for k in ('a_inv', 'g_inv'):
        for n in NAMES:
            want = np.asarray(getattr(jrem, k)[n])
            np.testing.assert_allclose(
                getattr(trem, k)[n].numpy(), want, rtol=1e-4,
                atol=1e-4 * float(np.max(np.abs(want))), err_msg=f'{k} {n}',
            )
    if bad is None:
        # every factor warm-started from its live inverse
        assert factors.newton_schulz_inverse_info.starts['warm'] - warm0 == 2 * len(NAMES)
    else:
        # the bad layer rolled back to its last good inverses, not to zeros
        assert all(torch.equal(getattr(trem, k)['head'], v) for k, v in before.items())
        assert port_health(trem.health) == jax_health(jrem.health)
        assert port_health(trem.health)['bad_inv'] == [0.0, 1.0]
    jgrads, tgrads, _ = pair.grads_on(STEPS)
    assert_pgrads_close(pair.tk.precondition(trem, tgrads), pair.jk.precondition(jrem, jgrads))


# ---------------------------------------------------------------- health


@pytest.mark.parametrize('saved_with,restored_with', [(True, True), (True, False), (False, True)])
def test_health_counters_round_trip_and_toggle_as_in_jax(tmp_path, saved_with, restored_with):
    pair = Pair(health_on=saved_with, compute_method='eigen')
    for i in range(STEPS):
        pair.step(i, poison=saved_with and i == 1)
    jcheckpoint.save(str(tmp_path / 'jax'), pair.js, engine=pair.jk)
    checkpoint.save(str(tmp_path / 'port'), pair.ts, engine=pair.tk)
    other = Pair(health_on=restored_with, compute_method='eigen')
    jrest, _ = jcheckpoint.restore(str(tmp_path / 'jax'), other.jk)
    trest, _ = checkpoint.restore(str(tmp_path / 'port'), other.tk)
    assert (trest.health is None) == (jrest.health is None) == (not restored_with)
    if restored_with:
        got, want = port_health(trest.health), jax_health(jrest.health)
        assert got == want
        # saved counters are kept; a checkpoint without them starts fresh
        fresh = port_health(other.tk.init().health)
        assert (got == fresh) == (not saved_with)
    assert_factors_close(checkpoint.durable_state(trest), jcheckpoint.durable_state(jrest))


# ----------------------------------------------------------------- async


def test_async_save_holds_the_values_of_its_call(tmp_path):
    pair = Pair()
    pair.step(0)
    opt = torch.optim.SGD(pair.model.parameters(), lr=0.1, momentum=0.9)
    for p in pair.model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    before_params = {k: v.clone() for k, v in pair.model.state_dict().items()}
    before_a = {n: v.clone() for n, v in pair.ts.a.items()}
    before_mom = [opt.state[p]['momentum_buffer'].clone() for p in pair.model.parameters()]
    path = str(tmp_path / 'async')
    handle = checkpoint.save(
        path, pair.ts, extra={'model': pair.model.state_dict(), 'optimizer': opt.state_dict()},
        engine=pair.tk, wait=False,
    )
    # in-place changes right after the call: the optimizer's step and the
    # factors' buffers
    opt.step()
    for a in pair.ts.a.values():
        a.mul_(2.0)
    handle.wait_until_finished()
    payload = torch.load(os.path.join(path, checkpoint.PAYLOAD), weights_only=True)
    assert all(torch.equal(payload['model'][k], v) for k, v in before_params.items())
    assert all(torch.equal(payload['kfac']['a'][n], v) for n, v in before_a.items())
    saved_mom = [payload['optimizer']['state'][i]['momentum_buffer'] for i in range(len(before_mom))]
    assert all(torch.equal(s, b) for s, b in zip(saved_mom, before_mom))
    assert not torch.equal(pair.ts.a['head'], before_a['head'])


def test_restore_extra_template_names_required_extras(tmp_path):
    pair = Pair()
    pair.step(0)
    path = str(tmp_path / 'ck')
    checkpoint.save(path, pair.ts, extra={'model': pair.model.state_dict(), 'note': 'x'})
    with pytest.warns(CheckpointResilienceWarning, match='manifest'):
        _, extra = checkpoint.restore(path, pair.tk, extra_template={'model': None})
    assert set(extra) == {'model'}
    with pytest.warns(CheckpointResilienceWarning), pytest.raises(ValueError, match='optimizer'):
        checkpoint.restore(path, pair.tk, extra_template={'optimizer': None})
    with pytest.raises(ValueError, match="'kfac'"):
        checkpoint.save(str(tmp_path / 'k'), pair.ts, extra={'kfac': 1})
