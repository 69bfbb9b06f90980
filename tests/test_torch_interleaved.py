"""The port's interleaved pipeline against the JAX package: the schedule
tables of ``parallel/interleaved.py``, ``InterleavedPipelinedLM`` over
point-to-point sends, and ``PipelineKFAC``, ``convert`` and checkpoints on
it.

The tables are compared element for element on a grid of (p, v, m), with
the same errors for invalid ones. One gloo world of four CPU ranks (rank
bodies in ``tests/torch_interleaved_ranks.py``, JAX-free) runs the port's
cases on pipeline grids over subgroups of it (pipe 1, pipe 2, pipe 2 x
data 2, pipe 4), once per test run under a file lock. The JAX package runs
``InterleavedPipelinedLM`` on the virtual CPU devices at
``tests/parallel/test_interleaved_scan.py``'s sizes (vocab 64, d 32, 4
heads, max_len 16, M 4), each reference once per module; its rank-major
stage stack carries over with ``convert.from_flax_interleaved_params``.

Tolerances (``tests/test_torch_pipeline.py``'s): losses rtol 1e-5;
statistics rtol 1e-3 with atol 1e-5 (A) and 1e-6 (G) x max; grads rtol
1e-3 with atol 1e-6 x the max over all grads; the interleaved model
against the port's 1F1B at the same 4 logical stages rtol 2e-4 with atol
2e-6 x max for grads and 1e-4 with atol 1e-6 x max for statistics (the
JAX test's between its two schedules); the six-step training trajectory
rtol 1e-4 against the JAX engine; tick counts and tables exact.
"""

import fcntl
import os
import pickle
import tempfile
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kfac_tpu
import torch_interleaved_ranks as ranks
from kfac_tpu.parallel import interleaved as jinterleaved
from kfac_tpu.parallel import interleaved_scan as jscan
from kfac_tpu.parallel import pipeline as jpipeline
from kfac_tpu.parallel.mesh import pipeline_mesh as jax_pipeline_mesh
from kfac_tpu_torch import convert
from kfac_tpu_torch.parallel import interleaved, interleaved_scan, mesh as mesh_lib, pipeline
from kfac_tpu_torch.parallel import spawn_world

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

warnings.filterwarnings('ignore', message='pipeline-parallel K-FAC is experimental')

GEOM = ranks.GEOM


def close(got, want, rtol=1e-5, atol_rel=0.0, msg=''):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * float(np.max(np.abs(want))),
                               err_msg=msg)


def close_grads(got, want, rtol, atol_rel):
    scale = max(float(np.abs(v).max()) for v in want.values())
    for n, v in want.items():
        np.testing.assert_allclose(got[n], v, rtol=rtol, atol=atol_rel * scale, err_msg=n)


# ------------------------------------------------------------------ tables

GRID = [(p, v, m) for p in (1, 2, 4) for v in (1, 2, 3) for m in (p, 2 * p, 3 * p, 8) if m % p == 0]


@pytest.mark.parametrize('p,v', [(p, v) for p in (1, 2, 4) for v in (1, 2, 3)])
def test_single_slot_tables_equal_jax(p, v):
    for m in sorted({m for pp, vv, m in GRID if (pp, vv) == (p, v)}):
        got, want = interleaved.generate_single_slot(p, v, m), jinterleaved.generate_single_slot(p, v, m)
        np.testing.assert_array_equal(got.ops, want.ops)
        assert (got.ticks, got.ring, got.act_depth, got.cot_depth) == (
            want.ticks, want.ring, want.act_depth, want.cot_depth)
        assert got.bubble_slots() == want.bubble_slots() and got.p == want.p


@pytest.mark.parametrize('p,v', [(p, v) for p in (1, 2, 4) for v in (1, 2, 3)])
def test_two_slot_tables_equal_jax(p, v):
    for m in sorted({m for pp, vv, m in GRID if (pp, vv) == (p, v)}):
        got, want = interleaved.generate(p, v, m), jinterleaved.generate(p, v, m)
        np.testing.assert_array_equal(got.f, want.f)
        np.testing.assert_array_equal(got.b, want.b)
        assert got.ticks == want.ticks and got.bubble_slots() == want.bubble_slots()
        for k in range(3 * p * v):
            assert interleaved._chunk_of(k, p, v) == jinterleaved._chunk_of(k, p, v)
            assert interleaved._microbatch_of(k, p, v) == jinterleaved._microbatch_of(k, p, v)


@pytest.mark.parametrize('p,v,m', [(2, 2, 3), (4, 1, 2), (2, 0, 4), (2, 2, 0), (4, 2, -4)])
def test_tables_raise_as_jax(p, v, m):
    for fn in ('generate', 'generate_single_slot'):
        with pytest.raises(ValueError) as want:
            getattr(jinterleaved, fn)(p, v, m)
        with pytest.raises(ValueError) as got:
            getattr(interleaved, fn)(p, v, m)
        assert str(got.value) == str(want.value)


def test_logical_to_stack_is_jaxs():
    for p, v in ((1, 3), (2, 2), (4, 2), (2, 4), (4, 4)):
        assert [interleaved_scan.logical_to_stack(p, v, s) for s in range(p * v)] == [
            jscan.logical_to_stack(p, v, s) for s in range(p * v)]


# -------------------------------------------------------------- no world


def stub_grid(n_stages=2):
    return mesh_lib.PipelineGrid(n_stages=n_stages, dp=1, model=1, rank=0,
                                 device=torch.device('cpu'), group=None, groups={})


def test_interleaved_validates_config_as_jax():
    with pytest.raises(ValueError, match='virtual_chunks'):
        interleaved_scan.InterleavedPipelinedLM(stub_grid(), **GEOM, num_layers=4, virtual_chunks=0)
    with pytest.raises(ValueError, match='divide evenly'):
        interleaved_scan.InterleavedPipelinedLM(stub_grid(), **GEOM, num_layers=6, virtual_chunks=2)
    with pytest.raises(ValueError, match='multiple'):
        interleaved_scan.InterleavedPipelinedLM(stub_grid(), **GEOM, num_layers=4, n_microbatches=3,
                                                virtual_chunks=2)
    with pytest.raises(ValueError, match='InterleavedPipelinedLM'):
        pipeline.PipelinedLM(stub_grid(), **GEOM, num_layers=4, schedule='interleaved')


def test_interleaved_apply_raises_and_chunks_follow_the_seed():
    """``apply`` refuses as the JAX class's does; a one-rank model's chunks
    are the logical stages, drawn in TransformerLM's order."""
    model = interleaved_scan.InterleavedPipelinedLM(stub_grid(1), **GEOM, num_layers=3,
                                                    virtual_chunks=3, seed=5)
    assert model.schedule == 'interleaved' and model.n_stages == 3
    with pytest.raises(NotImplementedError, match='loss_and_stats'):
        model.apply(torch.zeros(4, 8, dtype=torch.long))
    plain = pipeline.PipelinedLM(stub_grid(1), **GEOM, num_layers=3, seed=5)
    for c in range(3):
        got = model.stage.chunk(c).block0.attn.q_proj.weight
        assert torch.equal(got, getattr(plain.stage, f'block{c}').attn.q_proj.weight)
    assert list(model.stage_registry.layers)[0].startswith('chunk0/block0/')
    report = model.tick_report()
    assert report['ring'] == 2 * 0 + 2 * 1 + 1
    assert report['bubble_slots'] == jinterleaved.generate_single_slot(1, 3, 4).bubble_slots()


# ------------------------------------------------------------------ the world

CASES = {
    'p1_v3': dict(grid='p1', kind='stats', v=3, layers=3, micro=4, batch=(8, 16)),
    'p2_v2': dict(grid='p2', kind='stats', v=2, layers=4, micro=4, batch=(8, 16)),
    'p2_v2_dp2': dict(grid='p2_dp2', kind='stats', v=2, layers=4, micro=4, batch=(8, 16)),
    'base_p4': dict(grid='p4', kind='stats', base=True, layers=4, micro=4, batch=(8, 16)),
    'train_p2_v2': dict(grid='p2', kind='train', v=2, layers=4, micro=4, batch=(8, 16), steps=6),
    'train_p2_v2_dp2': dict(grid='p2_dp2', kind='train', v=2, layers=4, micro=4, batch=(8, 16),
                            steps=6),
    'checkpoint': dict(grid='p2', kind='checkpoint', v=2, layers=4, micro=4, batch=(8, 16)),
    'convert': dict(grid='p2', kind='convert', v=2, layers=4, micro=4, batch=(8, 16)),
}
JAX_DEVICES = {'p1': 1, 'p2': 2, 'p2_dp2': 4, 'p4': 4}


def tokens(shape, seed=1):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0, 64)).astype(np.int64)


def jax_model(case, grid=None):
    grid = grid or case['grid']
    n = ranks.GRIDS[grid][0]
    mesh = jax_pipeline_mesh(n_stages=n, devices=jax.devices()[:JAX_DEVICES[grid]])
    kw = dict(GEOM, num_layers=case['layers'], n_microbatches=case['micro'])
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        if case.get('base'):
            return jpipeline.PipelinedLM(mesh=mesh, schedule='1f1b', **kw)
        return jscan.InterleavedPipelinedLM(mesh=mesh, virtual_chunks=case['v'], **kw)


_JAX = {}


def jax_params(v, layers):
    """The JAX interleaved model's initial params (numpy), key 0: the same
    for every grid of that (p, v) logical stage count."""
    key = (v, layers)
    if key not in _JAX:
        case = dict(v=v, layers=layers, micro=4)
        grid = 'p1' if layers == v else 'p2'
        _JAX[key] = jax.device_get(jax_model(case, grid).init(jax.random.PRNGKey(0)))
    return _JAX[key]


def base_params():
    """The p2_v2 params with the stages in logical order (the 1F1B stack)."""
    params = dict(jax_params(2, 4))
    perm = np.array([interleaved_scan.logical_to_stack(2, 2, s) for s in range(4)])
    params['stages'] = jax.tree_util.tree_map(lambda a: np.asarray(a)[perm], params['stages'])
    return params


def jax_train(case, steps, record_at=None):
    """The JAX loop: loss_and_stats, PipelineKFAC.step, SGD at 0.1."""
    model = jax_model(case)
    params = jax_params(case['v'], case['layers'])
    cfg = kfac_tpu.KFACPreconditioner(registry=model.stage_registry, **ranks.KFAC)
    pk = jpipeline.PipelineKFAC(config=cfg, model=model)
    state = pk.init()
    tok = jnp.asarray(tokens(case['batch']))
    batch = (tok, jnp.roll(tok, -1, 1))

    @jax.jit
    def train_step(params, state):
        loss, grads, stats = model.loss_and_stats(params, batch)
        state, grads = pk.step(state, grads, stats)
        return jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params, grads), state, loss, grads

    losses, recorded, grads = [], None, None
    for i in range(steps):
        if record_at == i:
            recorded = (jax.device_get(params), jax.device_get(state))
        params, state, loss, grads = train_step(params, state)
        losses.append(float(loss))
    return dict(losses=losses, recorded=recorded, state=jax.device_get(state),
                grads=jax.device_get(grads))


_TRAIN = {}


def jax_train_run():
    """The JAX six-step run on pipe 2 (v 2), once per module; its params
    and state after step 3 are the ``convert`` case's start."""
    if not _TRAIN:
        _TRAIN.update(jax_train(CASES['train_p2_v2'], 6, record_at=3))
    return _TRAIN


def world_spec(root):
    spec = {}
    for name, case in CASES.items():
        case = dict(case)
        if case.get('base'):
            case['params'] = base_params()
        else:
            case['params'] = jax_params(case['v'], case['layers'])
        if name == 'convert':
            params, state = jax_train_run()['recorded']
            case.update(params=params, jax_state=state)
        case['tokens'] = tokens(case['batch'])
        case['root'] = root
        spec[name] = case
    return spec


def locked_world(tag, fn):
    uid = os.environ.get('PYTEST_XDIST_TESTRUNUID')
    if uid is None:
        return fn()
    path = os.path.join(tempfile.gettempdir(), f'kfac_torch_ilv_{tag}_{uid}.pkl')
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
    with tempfile.TemporaryDirectory(prefix='kfac_ilv_') as root:
        return spawn_world(ranks.run, 4, 'gloo', 'cpu', args=(world_spec(root),), timeout_s=600)


@pytest.fixture(scope='module')
def world():
    return locked_world('world', run_world)


def members(case):
    return ranks.GRIDS[case['grid']][1]


def port_name(jax_name, c):
    return f'chunk{c}/{jax_name}'


_STATS = {}


def jax_stats(name):
    """The JAX run of a stats case: loss, grads, stats, tick counts."""
    if name not in _STATS:
        case = CASES[name]
        model = jax_model(case)
        params = base_params() if case.get('base') else jax_params(case['v'], case['layers'])
        tok = jnp.asarray(tokens(case['batch']))
        batch = (tok, jnp.roll(tok, -1, 1))
        if case.get('base'):
            loss, grads, stats = jax.jit(model.loss_and_stats)(params, batch)
            ticks = None
        else:
            loss, grads, stats, ticks = jax.jit(model.loss_stats_and_ticks)(params, batch)
        _STATS[name] = (float(loss), jax.device_get(grads), jax.device_get(stats),
                        None if ticks is None else np.asarray(ticks), model)
    return _STATS[name]


def want_stage_grads(grads, p, v, r, base=False):
    """JAX stage grads of pipe rank ``r`` under the port's names."""
    out = {}
    if base:
        for k, t in convert.from_flax_params(jax.tree_util.tree_map(lambda a: a[r], grads['stages'])).items():
            out[f'stage.{k}'] = t.numpy()
        return out
    for c in range(v):
        sl = jax.tree_util.tree_map(lambda a: a[r * v + c], grads['stages'])
        for k, t in convert.from_flax_params(sl).items():
            out[f'stage.chunk{c}.{k}'] = t.numpy()
    return out


def want_replicated_grads(grads):
    out = {k: t.numpy() for k, t in convert.from_flax_params(
        {k: v for k, v in grads.items() if k not in ('stages', 'head')}).items()}
    out['lm_head.weight'] = np.asarray(grads['head']['kernel']).T
    return out


@pytest.mark.parametrize('name', ['p1_v3', 'p2_v2', 'p2_v2_dp2'])
def test_interleaved_matches_jax(world, name):
    """Loss, every grad, every statistic and the executed tick counts of
    each rank equal the JAX class's on the same weights and batch."""
    case = CASES[name]
    loss, grads, stats, ticks, model = jax_stats(name)
    p, v = ranks.GRIDS[case['grid']][0], case['v']
    rep = want_replicated_grads(grads)
    for r in members(case):
        got = world[r][name]
        stage, _ = world[r]['coords'][case['grid']]
        close(got['loss'], loss, rtol=1e-5)
        assert got['names'] == [port_name(n, c) for c in range(v) for n in model.stage_registry.layers]
        want = dict(rep, **want_stage_grads(grads, p, v, stage))
        close_grads(got['grads'], want, rtol=1e-3, atol_rel=1e-6)
        for c in range(v):
            for n in stats.a:
                close(got['a'][port_name(n, c)], np.asarray(stats.a[n])[stage * v + c],
                      rtol=1e-3, atol_rel=1e-5, msg=f'A {n} chunk {c}')
                close(got['g'][port_name(n, c)], np.asarray(stats.g[n])[stage * v + c],
                      rtol=1e-3, atol_rel=1e-6, msg=f'G {n} chunk {c}')
        np.testing.assert_array_equal(got['ticks'], ticks)
        assert got['report']['matches_schedule'], got['report']
        assert int(np.asarray(got['ticks'])[:, 2].sum()) == jinterleaved.generate_single_slot(
            p, v, case['micro']).bubble_slots()


def test_interleaved_equals_the_ports_1f1b_at_four_logical_stages(world):
    """The tests/parallel/test_interleaved_scan.py:49 identity on the port:
    pipe 2 x v 2 against the 1F1B PipelinedLM on pipe 4 over the same
    logical stages (rank r of pipe 4 holds logical stage r)."""
    ilv = {r: world[r]['p2_v2'] for r in (0, 1)}
    base = {r: world[r]['base_p4'] for r in range(4)}
    close(ilv[0]['loss'], base[0]['loss'], rtol=1e-5)
    scale = max(float(np.abs(v).max()) for v in base[0]['grads'].values())
    for s in range(4):
        r, c = s % 2, s // 2
        for k, want in base[s]['grads'].items():
            if k.startswith('stage.'):
                got = ilv[r]['grads'][f'stage.chunk{c}.{k[len("stage."):]}']
            else:  # replicated: every rank holds the global grad
                got = ilv[0]['grads'][k]
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-6 * scale, err_msg=k)
        for n, want in base[s]['a'].items():
            close(ilv[r]['a'][f'chunk{c}/{n}'], want, rtol=1e-4, atol_rel=1e-6, msg=n)
            close(ilv[r]['g'][f'chunk{c}/{n}'], base[s]['g'][n], rtol=1e-4, atol_rel=1e-6, msg=n)


@pytest.mark.parametrize('name', ['train_p2_v2', 'train_p2_v2_dp2'])
def test_pipeline_kfac_on_interleaved_matches_jax(world, name):
    """Six steps of PipelineKFAC and SGD: losses rtol 1e-4 against the JAX
    engine on the interleaved model; each rank's factors its chunks' JAX
    factors; the data peers' factors bitwise."""
    run = jax_train_run()
    case = CASES[name]
    for r in members(case):
        got = world[r][name]
        close(got['losses'], run['losses'], rtol=1e-4)
        stage, _ = world[r]['coords'][case['grid']]
        assert got['topology']['virtual_chunks'] == 2 and got['topology']['n_stages'] == 4
        for c in range(2):
            for n in run['state']['a']:
                close(got['a'][port_name(n, c)], np.asarray(run['state']['a'][n])[stage * 2 + c],
                      rtol=1e-3, atol_rel=1e-5, msg=f'A {n}')
    if name.endswith('dp2'):
        for r, peer in ((0, 1), (2, 3)):
            if world[r]['coords'][case['grid']][0] == world[peer]['coords'][case['grid']][0]:
                for k, v in world[r][name]['a'].items():
                    np.testing.assert_array_equal(v, world[peer][name]['a'][k])


def test_interleaved_checkpoint_round_trip(world):
    """A save at (p 2, v 2) restores at (p 2, v 2): the restored run's next
    step equals the original's; a (p 2, v 1) engine is refused."""
    for r in members(CASES['checkpoint']):
        got = world[r]['checkpoint']
        assert got['step'] == (3, 3) and got['a_equal'] and got['params_saved_equal']
        assert got['losses'][0] == got['losses'][1]
        assert got['refusal'] is not None and 'virtual_chunks' in got['refusal']


def test_convert_takes_over_the_jax_interleaved_state(world):
    """The JAX run's params and state after step 3 carried over by
    ``convert``: the port's step 4 loss and factors are the JAX run's."""
    run = jax_train_run()
    for r in members(CASES['convert']):
        got = world[r]['convert']
        stage, _ = world[r]['coords']['p2']
        assert got['step'] == 4
        close(got['loss'], run['losses'][3], rtol=1e-5)
    # the factors after the JAX run's step 4 are not recorded; its final
    # (step 6) state is two steps further, so hold step 4's against a fresh
    # JAX run of four steps
    four = jax_train(CASES['train_p2_v2'], 4)
    for r in members(CASES['convert']):
        got = world[r]['convert']
        stage, _ = world[r]['coords']['p2']
        for c in range(2):
            for n in four['state']['a']:
                close(got['a'][port_name(n, c)], np.asarray(four['state']['a'][n])[stage * 2 + c],
                      rtol=1e-4, atol_rel=1e-6, msg=f'A {n}')
