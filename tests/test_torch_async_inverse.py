"""The port's async inverse refresh against the JAX package's
(``kfac_tpu.async_inverse``, dense engine).

Engines over the MLP 6 -> 8 -> 5 (``dense0``, ``head``) at cadence 4/4
(``factor_update_steps == inv_update_steps``, the cadence at which the
sliced refresh is bit for bit the synchronous one a window back), fed the
same seeded gradients and statistics, kl-clip off:

- the config's normalisation and errors, the cadence-schedule refusal, and
  the slice plans, equal to the JAX package's;
- sliced EIGEN (with and without prediv, with and without health): bitwise
  one window behind the port's synchronous engine, and within the
  preconditioner test's tolerances of the JAX sliced engine (preconditioned
  grads and eigenvalues rtol 1e-4, atol 1e-4 x the max);
- sliced INVERSE (Cholesky, Newton-Schulz) against JAX at rtol 2e-2, atol
  2e-3 (the JAX test's: both warm-start from the active inverse);
- the host mode: preconditioned grads within rtol 5e-3, atol 1e-4 of the
  synchronous engine one window back (the JAX test's tolerance);
- ``inv_staleness`` advancing at the swap, a quarantined layer's shadow
  discarded, a mid-window checkpoint restore, a mid-window JAX state carried
  over, and the four Trainer paths in both modes against the JAX Trainer
  (losses rtol 1e-5).
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
from kfac_tpu import async_inverse as jasync
from kfac_tpu import health as jhealth
from kfac_tpu import training as jtraining
from kfac_tpu.async_inverse import host as jhost
from kfac_tpu.layers import capture as jcapture
from kfac_tpu.models import MLP as FlaxMLP
from kfac_tpu_torch import checkpoint, convert, health
from kfac_tpu_torch import async_inverse as tasync
from kfac_tpu_torch.async_inverse import host as thost
from kfac_tpu_torch.layers import capture, registry
from kfac_tpu_torch.models import MLP
from kfac_tpu_torch.observability import metrics as tmetrics
from kfac_tpu_torch.preconditioner import KFACPreconditioner
from kfac_tpu_torch.training import Trainer

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

N = 4  # the cadence window, factor == inverse
STEPS = 3 * N
IN, HIDDEN, OUT = 6, 8, 5
NAMES = ['dense0', 'head']
FACTOR_DIMS = {'dense0': (IN + 1, HIDDEN), 'head': (HIDDEN + 1, OUT)}
FIELDS = ('qa', 'qg', 'da', 'dg', 'dgda', 'a_inv', 'g_inv')


def rng(seed):
    return np.random.default_rng(seed)


def t(x):
    return torch.from_numpy(np.asarray(x))


def engines(mode, method='eigen', solver=None, prediv=False, health_on=False, max_slices=None,
            **kw):
    """(JAX engine, port engine) over the same MLP, cadence N/N."""
    opts = dict(
        damping=0.003, lr=0.1, kl_clip=None, factor_update_steps=N, inv_update_steps=N,
        compute_method=method, prediv_eigenvalues=prediv, **kw,
    )
    if solver is not None:
        opts['inverse_solver'] = solver
    jreg = kfac_tpu.register_model(FlaxMLP(features=(HIDDEN,), num_classes=OUT), jnp.zeros((2, IN)))
    treg = registry.register_model(MLP(IN, (HIDDEN,), OUT, device='cpu'), device='cpu')
    jmode = tmode = mode
    if max_slices is not None:
        jmode = jasync.AsyncInverseConfig(mode, max_slices)
        tmode = tasync.AsyncInverseConfig(mode, max_slices)
    jk = kfac_tpu.KFACPreconditioner(
        registry=jreg, health=jhealth.HealthConfig(warn=False) if health_on else None,
        async_inverse=jmode, **opts,
    )
    tk = KFACPreconditioner(
        treg, device='cpu', health=health.HealthConfig(warn=False) if health_on else None,
        async_inverse=tmode, **opts,
    )
    return jk, tk


def step_inputs(seed, poison=None):
    """(JAX grads, port grads, JAX stats, port stats) of one step; the
    ``poison`` layer's A statistic NaN."""
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
        a[poison] = a[poison] * np.float32(np.nan)
    jstats = jcapture.CapturedStats({k: jnp.asarray(v) for k, v in a.items()},
                                    {k: jnp.asarray(v) for k, v in g.items()})
    tstats = capture.CapturedStats({k: t(v) for k, v in a.items()}, {k: t(v) for k, v in g.items()})
    tgrads = {k: v.clone() for k, v in convert.from_flax_params(jgrads).items()}
    return jax.tree_util.tree_map(jnp.asarray, jgrads), tgrads, jstats, tstats


def decomps(state):
    return {f: dict(getattr(state, f)) for f in FIELDS}


def assert_bitwise(want, got, msg):
    for f in FIELDS:
        assert set(want[f]) == set(got[f]), (msg, f)
        for n in want[f]:
            assert torch.equal(want[f][n], got[f][n]), f'{msg}: {f}/{n}'


def close(got, want, rtol=1e-4, atol_rel=1e-4, msg=''):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * float(np.max(np.abs(want))), err_msg=msg
    )


def close_grads(tgrads, jgrads, rtol=1e-4, atol_rel=1e-4, msg=''):
    want = convert.from_flax_params(jax.device_get(jgrads))
    scale = max(float(np.max(np.abs(w.numpy()))) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(tgrads[name].numpy(), w.numpy(), rtol=rtol,
                                   atol=atol_rel * scale, err_msg=f'{msg} {name}')


def run_port_pair(sync, asy, mode='sliced', steps=STEPS):
    """Both port engines stepped in lockstep on the same inputs (the host
    mode pumped as the Trainer pumps); per step (sync state, async state)
    and the last step's grads."""
    ss, sa = sync.init(), asy.init()
    hist = []
    for i in range(steps):
        _, tg, _, tst = step_inputs(i)
        if mode == 'host':
            sa = thost.pump(asy, sa, step=i)
        ss, _ = sync.step(ss, tg, tst)
        sa, _ = asy.step(sa, tg, tst)
        hist.append((ss, sa))
    return hist, tg


def lag(s):
    """The synchronous step whose decompositions async step ``s`` applies."""
    return (s // N) * N - N


# ------------------------------------------------------------- configuration


def test_async_config_normalization_matches_jax():
    assert tasync.as_async_config(None) is None
    assert tasync.as_async_config(False) is None
    assert tasync.as_async_config(True) == tasync.AsyncInverseConfig()
    assert tasync.as_async_config('host') == tasync.AsyncInverseConfig(mode='host')
    cfg = tasync.AsyncInverseConfig(mode='sliced', max_slices=3)
    assert tasync.as_async_config(cfg) is cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jasync.AsyncInverseConfig('sliced', 3))
    for bad in (dict(mode='warp'), dict(max_slices=0)):
        with pytest.raises(ValueError) as ours:
            tasync.AsyncInverseConfig(**bad)
        with pytest.raises(ValueError) as theirs:
            jasync.AsyncInverseConfig(**bad)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(TypeError) as ours:
        tasync.as_async_config(3.5)
    with pytest.raises(TypeError) as theirs:
        jasync.as_async_config(3.5)
    assert str(ours.value) == str(theirs.value)


def test_async_rejects_cadence_schedule():
    treg = registry.register_model(MLP(IN, (HIDDEN,), OUT, device='cpu'), device='cpu')
    with pytest.raises(ValueError, match='static int'):
        KFACPreconditioner(treg, device='cpu', inv_update_steps=lambda s: 4, async_inverse='sliced')


@pytest.mark.parametrize('n_slices', [1, 2, 3, 4, 10])
def test_plan_slices_matches_jax(n_slices):
    units = [(('a', 'x'), 8.0), (('g', 'x'), 1.0), ('c', 1.0), (('a', 'y'), 6.0),
             ('e', 1.0), ('f', 1.0), (('g', 'y'), 6.0)]
    plan = tasync.plan_slices(units, n_slices)
    assert plan == jasync.plan_slices(units, n_slices)
    assert sorted(map(repr, (k for s in plan for k in s))) == sorted(repr(k) for k, _ in units)
    with pytest.raises(ValueError):
        tasync.plan_slices(units, 0)


@pytest.mark.parametrize('method,prediv,max_slices', [
    ('eigen', False, None), ('eigen', True, None), ('inverse', False, None), ('eigen', False, 3),
])
def test_engine_slice_plan_matches_jax(method, prediv, max_slices):
    jk, tk = engines('sliced', method, prediv=prediv, max_slices=max_slices)
    assert tk._async_slices == jk._async_slices
    assert tk._async_n_slices == jk._async_n_slices and tk._async_n_steps == N
    shadow = tk.init().shadow
    assert shadow.progress == 0
    jshadow = jk.init().shadow
    for f in FIELDS:
        assert sorted(getattr(shadow, f)) == sorted(getattr(jshadow, f)), f
        for n, v in getattr(shadow, f).items():
            assert tuple(v.shape) == getattr(jshadow, f)[n].shape and not v.any()


# ------------------------------------------------------------ sliced, EIGEN


SLICED_EIGEN = [
    dict(prediv=False, health_on=False), dict(prediv=True, health_on=False),
    dict(prediv=False, health_on=True),
]
SLICED_IDS = ['eigen', 'prediv', 'health']


@pytest.mark.parametrize('kw', SLICED_EIGEN, ids=SLICED_IDS)
def test_sliced_bit_identical_one_window_lag(kw):
    """The sliced engine's decompositions at step s are bit for bit the
    synchronous engine's at the previous boundary (window 0: the shared
    cold start)."""
    _, sync = engines(None, **kw)
    _, asy = engines('sliced', **kw)
    hist, _ = run_port_pair(sync, asy)
    for s in range(N):
        assert_bitwise(decomps(hist[s][0]), decomps(hist[s][1]), f'window-0 step {s}')
    for s in range(N, STEPS):
        assert_bitwise(decomps(hist[lag(s)][0]), decomps(hist[s][1]), f'async {s} vs sync {lag(s)}')
    assert hist[-1][1].shadow.progress == asy._async_n_slices


@pytest.mark.parametrize('kw', SLICED_EIGEN, ids=SLICED_IDS)
def test_sliced_matches_jax(kw):
    jk, tk = engines('sliced', **kw)
    js, ts = jk.init(), tk.init()
    jstep = jax.jit(jk.step)
    for i in range(STEPS):
        jg, tg, jst, tst = step_inputs(i)
        js, jout = jstep(js, jg, jst)
        ts, tout = tk.step(ts, tg, tst)
        close_grads(tout, jout, msg=f'step {i}')
        assert ts.shadow.progress == int(js.shadow.progress)
        for f in ('da', 'dg', 'dgda'):
            for n, v in getattr(ts, f).items():
                close(v, getattr(js, f)[n], msg=f'{f}/{n} step {i}')
        if kw['health_on']:
            for field in ('bad_inv', 'quarantined'):
                want = [int(getattr(js.health, field)[n]) for n in NAMES]
                assert getattr(ts.health, field).tolist() == want


@pytest.mark.parametrize('solver', ['cholesky', 'newton_schulz'])
def test_sliced_inverse_matches_jax(solver):
    """INVERSE: the swapped inverses against the JAX sliced engine's (both
    warm-start from the active inverse), and one window behind the port's
    synchronous engine, at the JAX test's rtol 2e-2, atol 2e-3."""
    jk, tk = engines('sliced', 'inverse', solver)
    _, sync = engines(None, 'inverse', solver)
    js, ts, ss = jk.init(), tk.init(), sync.init()
    jstep = jax.jit(jk.step)
    synced = []
    for i in range(STEPS):
        jg, tg, jst, tst = step_inputs(i)
        js, jout = jstep(js, jg, jst)
        ts, tout = tk.step(ts, tg, tst)
        ss, _ = sync.step(ss, tg, tst)
        synced.append(decomps(ss))
        for f in ('a_inv', 'g_inv'):
            for n in NAMES:
                np.testing.assert_allclose(getattr(ts, f)[n].numpy(), np.asarray(getattr(js, f)[n]),
                                           rtol=2e-2, atol=2e-3, err_msg=f'{f}/{n} step {i}')
                if i >= N:
                    np.testing.assert_allclose(getattr(ts, f)[n].numpy(),
                                               synced[lag(i)][f][n].numpy(), rtol=2e-2, atol=2e-3)
        close_grads(tout, jout, rtol=2e-2, atol_rel=2e-3, msg=f'step {i}')


# ---------------------------------------------------------------- host mode


@pytest.mark.parametrize('method,prediv', [('eigen', False), ('eigen', True), ('inverse', False)],
                         ids=['eigen', 'prediv', 'inverse'])
def test_host_preconditions_like_lagged_sync(method, prediv):
    """LAPACK's eigenvectors differ from the device's in sign, so the host
    mode is held to the preconditioner's action: its preconditioned grads
    equal the synchronous engine's one window back."""
    _, sync = engines(None, method, prediv=prediv)
    _, asy = engines('host', method, prediv=prediv)
    hist, grads = run_port_pair(sync, asy, mode='host')
    assert hist[-1][1].shadow is None
    for s in range(N, STEPS):
        ref = sync.precondition(hist[lag(s)][0], grads)
        got = asy.precondition(hist[s][1], grads)
        for n in ref:
            np.testing.assert_allclose(got[n].numpy(), ref[n].numpy(), rtol=5e-3, atol=1e-4,
                                       err_msg=f'step {s} {n}')


def test_host_worker_reset_drops_work_in_flight():
    _, asy = engines('host')
    state = asy.init()
    _, tg, _, tst = step_inputs(0)
    state, _ = asy.step(state, tg, tst)  # step 0 launches the first window
    worker = asy._async_worker
    assert worker.has_work()
    asy.rematerialize(state)
    assert worker.take(wait=True, timeout=30) is None
    # the next launch lands again
    for i in range(1, N + 1):
        state = thost.pump(asy, state, step=i)
        state, _ = asy.step(state, *step_inputs(i)[1::2])
    payload = worker.take(wait=True, timeout=30)
    assert payload is not None and payload['ready'] is None
    assert set(payload['fields']) == {'qa', 'qg', 'da', 'dg'}


def test_host_worker_error_surfaces_on_take():
    worker = thost.HostRefreshWorker(lambda x: 1 / x)
    worker.submit(0, None, 0)
    with pytest.raises(RuntimeError, match='host refresh failed'):
        worker.take(wait=True, timeout=30)
    worker.submit(4, None, 2.0)
    worker.submit(1, None, 4.0)  # an older window's job never replaces a newer result
    assert worker.take(wait=True, timeout=30) == 0.5


def test_host_worker_under_concurrent_submits_keeps_the_newest():
    """16 threads submit 50 jobs each with a tiny switch interval: every job
    is counted out (``take(wait=True)`` returns, nothing is left pending)
    and the newest window's result wins."""
    import sys
    import threading

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        worker = thost.HostRefreshWorker(lambda x: x)

        def submit(k):
            for j in range(50):
                worker.submit(50 * k + j, None, 50 * k + j)

        threads = [threading.Thread(target=submit, args=(k,)) for k in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
        assert worker.take(wait=True, timeout=30) == 799
        assert not worker.has_work()
    finally:
        sys.setswitchinterval(old)


# ------------------------------------------------------ staleness, quarantine


def test_inv_staleness_tracks_swap_not_schedule():
    _, asy = engines('sliced', metrics=True)
    collector = tmetrics.MetricsCollector()
    state = asy.init()
    staleness = []
    for i in range(STEPS):
        state, _ = asy.step(state, *step_inputs(i)[1::2])
        staleness.append(int(collector.drain(state)['inv_staleness/dense0']))
    assert staleness == [s % N for s in range(STEPS)]


def test_quarantined_layer_shadow_discarded_at_swap():
    """A layer quarantined at the boundary keeps its active decompositions
    and counts a bad inversion; the other layer swaps. Counters as JAX's."""
    jk, tk = engines('sliced', health_on=True)
    js, ts = jk.init(), tk.init()
    jstep = jax.jit(jk.step)
    for i in range(2 * N):
        jg, tg, jst, tst = step_inputs(i)
        js, _ = jstep(js, jg, jst)
        ts, _ = tk.step(ts, tg, tst)
    before = decomps(ts)
    jg, tg, jst, tst = step_inputs(2 * N, poison='dense0')
    js, _ = jstep(js, jg, jst)
    ts, _ = tk.step(ts, tg, tst)  # boundary: the swap runs
    after = decomps(ts)
    assert int(ts.health.quarantined[0]) == 1
    for f in ('qa', 'qg', 'da', 'dg'):
        assert torch.equal(before[f]['dense0'], after[f]['dense0']), f
    assert float((after['qa']['head'] - before['qa']['head']).abs().max()) > 0
    assert ts.health.bad_inv.tolist() == [1, 0]
    for field in ('bad_inv', 'quarantined', 'quarantine_events'):
        assert getattr(ts.health, field).tolist() == [int(getattr(js.health, field)[n]) for n in NAMES]


# -------------------------------------------------------------- checkpoints


def test_checkpoint_midwindow_restore_deterministic(tmp_path):
    """A restore mid-window rebuilds the active decompositions and an empty
    shadow, the same on every restore; the next boundary skips its swap,
    and the run steps on cleanly."""
    _, asy = engines('sliced')
    state = asy.init()
    for i in range(N + 2):
        state, _ = asy.step(state, *step_inputs(i)[1::2])
    assert state.shadow.progress > 0
    path = str(tmp_path / 'ck')
    checkpoint.save(path, state, engine=asy)
    r1, _ = checkpoint.restore(path, asy)
    r2, _ = checkpoint.restore(path, asy)
    assert_bitwise(decomps(r1), decomps(r2), 'mid-window restore')
    assert r1.shadow.progress == 0
    assert all(not v.any() for f in ('qa', 'qg', 'da', 'dg') for v in getattr(r1.shadow, f).values())
    assert_bitwise(decomps(asy.update_inverses(r1)), decomps(r1), 'restored slots torn')
    restored = decomps(r1)
    for i in range(N + 2, 2 * N + 1):
        r1, pg = asy.step(r1, *step_inputs(i)[1::2])
    # the boundary at 2N found 2 of 4 slices: no swap
    assert_bitwise(restored, decomps(r1), 'swap after a mid-window restore')
    for i in range(2 * N + 1, 3 * N + 1):
        r1, pg = asy.step(r1, *step_inputs(i)[1::2])
    assert float((r1.qa['head'] - restored['qa']['head']).abs().max()) > 0
    assert all(bool(torch.isfinite(v).all()) for v in pg.values())


def test_from_jax_state_carries_a_midwindow_shadow():
    jk, tk = engines('sliced', prediv=True)
    js = jk.init()
    jstep = jax.jit(jk.step)
    for i in range(N + 2):
        js, _ = jstep(js, *step_inputs(i)[::2])
    ts = convert.from_jax_kfac_state(js, tk)
    assert ts.shadow.progress == int(js.shadow.progress) == 2
    assert ts.shadow.damping == pytest.approx(float(js.shadow.damping))
    for i in range(N + 2, 3 * N):
        jg, tg, jst, tst = step_inputs(i)
        js, jout = jstep(js, jg, jst)
        ts, tout = tk.step(ts, tg, tst)
        close_grads(tout, jout, msg=f'step {i}')


# ---------------------------------------------------------------- Trainer


def regression(n=32):
    r = rng(1)
    x = r.standard_normal((n, IN)).astype(np.float32)
    y = np.tanh(x @ r.standard_normal((IN, OUT))).astype(np.float32)
    return x, y


def trainers(mode):
    """(JAX Trainer, its state, port Trainer, its state) from the same
    weights, SGD(0.05), cadence N/N."""
    x, _ = regression()
    fmodel = FlaxMLP(features=(HIDDEN,), num_classes=OUT)
    params = fmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    kw = dict(damping=0.003, kl_clip=None, inv_update_steps=N, factor_update_steps=N,
              async_inverse=mode)
    jreg = kfac_tpu.register_model(fmodel, jnp.asarray(x))

    def jloss(p, ms, batch):
        return jnp.mean((fmodel.apply({'params': p}, batch[0]) - batch[1]) ** 2), ms

    jt = jtraining.Trainer(loss_fn=jloss, optimizer=optax.sgd(0.05),
                           kfac=kfac_tpu.KFACPreconditioner(registry=jreg, **kw))
    model = MLP(IN, (HIDDEN,), OUT, device='cpu')
    model.load_state_dict(convert.from_flax_params(jax.device_get(params)))

    def tloss(ms, batch):
        return torch.mean((model(batch[0]) - batch[1]) ** 2), ms

    tt = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.05), tloss,
                 kfac=KFACPreconditioner(registry.register_model(model, device='cpu'),
                                         device='cpu', **kw), device='cpu')
    return jt, jt.init(params), tt, tt.init()


def batches(stacked=None):
    x, y = regression()
    jb, tb = (jnp.asarray(x), jnp.asarray(y)), (t(x), t(y))
    if stacked is None:
        return jb, tb
    return (tuple(jnp.broadcast_to(v, (stacked,) + v.shape) for v in jb),
            tuple(v.expand(stacked, *v.shape) for v in tb))


@pytest.mark.parametrize('mode', ['sliced', 'host'])
def test_trainer_step_path_matches_jax(mode):
    jt, js, tt, ts = trainers(mode)
    jb, tb = batches()
    jl, tl = [], []
    for _ in range(2 * N + 1):  # across two swap boundaries
        js, l = jt.step(js, jb)
        jl.append(float(l))
        ts, l = tt.step(ts, tb)
        tl.append(float(l))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]


@pytest.mark.parametrize('mode', ['sliced', 'host'])
def test_trainer_scan_path_matches_jax(mode):
    jt, js, tt, ts = trainers(mode)
    n = 2 * N + 1
    jb, tb = batches(n)
    js, jl = jt.scan_steps(js, jb)
    ts, tl = tt.scan_steps(ts, tb)
    # a second call pumps at its entry
    js, jl2 = jt.scan_steps(js, jb)
    ts, tl2 = tt.scan_steps(ts, tb)
    np.testing.assert_allclose(torch.cat([tl, tl2]).numpy(),
                               np.concatenate([np.asarray(jl), np.asarray(jl2)]), rtol=1e-5)
    assert ts.kfac_state.step == int(js.kfac_state.step) == 2 * n


@pytest.mark.parametrize('mode', ['sliced', 'host'])
def test_trainer_accumulate_paths_match_jax(mode):
    jt, js, tt, ts = trainers(mode)
    (jx, jy), (tx, ty) = batches()
    jm, tm = (jx.reshape(2, 16, -1), jy.reshape(2, 16, -1)), (tx.reshape(2, 16, -1), ty.reshape(2, 16, -1))
    jl, tl = [], []
    for _ in range(N + 1):  # eager micro-batch accumulation across a swap
        for k in range(2):
            jt.accumulate_microbatch(js, (jm[0][k], jm[1][k]))
            tt.accumulate_microbatch(ts, (tm[0][k], tm[1][k]))
        js, l = jt.apply_accumulated(js)
        jl.append(float(l))
        ts, l = tt.apply_accumulated(ts)
        tl.append(float(l))
    for _ in range(N + 1):  # the scanned accumulation
        js, l = jt.step_accumulate_scan(js, jm)
        jl.append(float(l))
        ts, l = tt.step_accumulate_scan(ts, tm)
        tl.append(float(l))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert ts.kfac_state.step == int(js.kfac_state.step) == 2 * (N + 1)


def test_jax_host_pump_is_the_reference():
    """The port's pump keeps the JAX pump's gate: nothing before the first
    boundary, nothing off a boundary."""
    jk, tk = engines('host')
    for pump, engine in ((jhost.pump, jk), (thost.pump, tk)):
        state = engine.init()
        assert pump(engine, state, step=0) is state
        assert pump(engine, state, step=N + 1) is state


# --------------------------------------------------------------- distributed
# The KAISA halves (tests/test_async_inverse.py's kaisa cases), in the gloo
# worlds of tests/test_torch_compression.py (W = 1 and 2): engines at fixed
# weights stepped on seeded per-step batches at cadence N/N, kl-clip off.

import functools  # noqa: E402
import types  # noqa: E402

import torch_kaisa_ranks as kranks  # noqa: E402
from kfac_tpu.parallel import DistributedKFAC as JaxDistributedKFAC  # noqa: E402
from kfac_tpu.parallel import kaisa_mesh as jax_kaisa_mesh  # noqa: E402
from kfac_tpu_torch.async_inverse import sliced as tsliced  # noqa: E402
from kfac_tpu_torch.parallel import kaisa as tkaisa  # noqa: E402
from test_torch_compression import flax_mlp, jax_engine, knob_worlds, torch_grads  # noqa: E402

KN = kranks.ASYNC_N


@functools.cache
def jax_kaisa_run(world, frac, mode, poison_step=None, health_on=False):
    """The JAX engine's run of the rank case ``async``: per step the
    preconditioned grads (port names) and the health counters."""
    _, reg, run, params, _ = flax_mlp()
    spec_batches = [
        tuple(b.astype(np.float32) for b in (rng(40 + i).normal(size=(16, 6)),
                                              rng(80 + i).normal(size=(16, 5))))
        for i in range(3 * KN + 1)
    ]
    dk = jax_engine(world, frac, async_inverse=mode,
                    health=jhealth.HealthConfig(warn=False) if health_on else None,
                    **kranks.ASYNC_KW)
    step = jax.jit(dk.step)
    state = dk.init()
    out = []
    for i, b in enumerate(spec_batches):
        (_, _), grads, stats = run(params, tuple(jnp.asarray(x) for x in b))
        if i == poison_step:
            a = dict(stats.a)
            a[kranks.POISON] = a[kranks.POISON] + jnp.float32(np.nan)
            stats = kfac_tpu.CapturedStats(a=a, g=dict(stats.g), w=dict(stats.w))
        if mode == 'host':
            state = jhost.pump(dk, state, step=i)
        state, pg = step(state, grads, stats)
        out.append({
            'grads': torch_grads(pg),
            'bad_inv': None if state.health is None else {
                n: int(v) for n, v in state.health.bad_inv.items()
            },
        })
    return out


def kaisa_rows(world, case):
    """Every rank's rows of a rank case of the knobs world."""
    return [r[case] for r in knob_worlds()[world][1]]


def flagship_registries():
    from kfac_tpu.models import TransformerLM as JaxLM
    from kfac_tpu_torch.models import TransformerLM

    cfg = dict(vocab_size=8192, d_model=512, num_heads=4, num_layers=6, max_len=512)
    jreg = kfac_tpu.register_model(JaxLM(**cfg), jnp.zeros((1, 8), jnp.int32), skip_layers=['lm_head'])
    with torch.device('meta'):
        model = TransformerLM(**cfg, device='meta')
    treg = registry.register_model(model, skip_layers=['lm_head'], device='meta')
    return jreg, treg


@pytest.mark.parametrize('world', [1, 4])
def test_kaisa_slice_plan_matches_jax_at_the_flagship(world):
    jreg, treg = flagship_registries()
    jk = JaxDistributedKFAC(
        config=kfac_tpu.KFACPreconditioner(registry=jreg, async_inverse='sliced',
                                           factor_update_steps=10, inv_update_steps=10,
                                           compute_method='eigen'),
        mesh=jax_kaisa_mesh(1.0, devices=jax.devices()[:world]),
    )
    buckets = tkaisa.build_buckets(treg, world, 1)
    a_store, g_store = tkaisa.build_stores(treg, world, 1, True, buckets)
    fake = types.SimpleNamespace(_prediv=False, buckets=buckets, a_store=a_store, g_store=g_store)
    units = tsliced.kaisa_units(fake)
    jax_units = jasync.sliced.kaisa_units(jk)
    assert units == jax_units
    assert tasync.plan_slices(units, min(10, len(units))) == jk._async_slices


@pytest.mark.parametrize('world,frac', [(1, 1.0), (2, 1.0), (2, 0.5)])
def test_kaisa_sliced_bit_identical_one_window_lag(world, frac):
    for sync, asy in zip(kaisa_rows(world, f'async-None-{frac}'),
                         kaisa_rows(world, f'async-sliced-{frac}')):
        sync, asy = sync['rows'], asy['rows']
        for s in range(len(asy)):
            lag = s if s < KN else (s // KN) * KN - KN
            for f, stacks in sync[lag]['decomps'].items():
                for k, v in stacks.items():
                    assert np.array_equal(asy[s]['decomps'][f][k], v), (s, f, k)


def test_kaisa_sliced_matches_jax_at_w1():
    got = kaisa_rows(1, 'async-sliced-1.0')[0]['rows']
    want = jax_kaisa_run(1, 1.0, 'sliced')
    for s, (g, w) in enumerate(zip(got, want)):
        ref = w['grads']
        scale = max(float(np.max(np.abs(v))) for v in ref.values())
        for n, v in ref.items():
            np.testing.assert_allclose(g['grads'][n], v, rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=f'step {s} {n}')


@pytest.mark.parametrize('world,frac', [(1, 1.0), (2, 1.0), (2, 0.5)])
def test_kaisa_host_preconditions_like_lagged_sync(world, frac):
    for sync, asy in zip(kaisa_rows(world, f'async-None-{frac}'),
                         kaisa_rows(world, f'async-host-{frac}')):
        for s in range(KN, len(asy['rows'])):
            for n, v in sync['rows'][s]['lagged'].items():
                np.testing.assert_allclose(asy['rows'][s]['grads'][n], v, rtol=5e-3, atol=1e-4,
                                           err_msg=f'step {s} {n}')


@pytest.mark.parametrize('world', [1, 2])
def test_kaisa_quarantined_slot_does_not_swap_and_bad_inv_matches_jax(world):
    frac = 1.0 if world == 1 else 0.5
    want = jax_kaisa_run(world, frac, 'sliced', poison_step=2 * KN, health_on=True)
    for res in kaisa_rows(world, 'fault-sliced'):
        rows, names = res['rows'], res['names']
        for s, (g, w) in enumerate(zip(rows, want)):
            assert [int(g['health']['bad_inv'][i]) for i in range(len(names))] == \
                [w['bad_inv'][n] for n in names], s
        # the boundary at 2N quarantines the poisoned layer's factors and
        # swaps every layer but that one
        before, after = rows[2 * KN - 1]['decomps'], rows[2 * KN]['decomps']
        for side in ('a', 'g'):
            for name in names:
                key, i = res['slots'][side][name]
                same = np.array_equal(before['q' + side][key][i], after['q' + side][key][i])
                assert same == (name == kranks.POISON), (side, name)
