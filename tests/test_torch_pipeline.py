"""The port's pipeline against the JAX package: ``pipeline_mesh``,
``PipelinedLM`` under GPipe and 1F1B over point-to-point sends, and
``PipelineKFAC`` (every case of ``tests/parallel/test_pipeline.py``), with
the 1F1B-equals-GPipe case, the checkpoint round trip, the JAX state taken
over by ``convert`` and the kl-clip sum against the dense engine's.

One gloo world of four CPU ranks (rank bodies in
``tests/torch_ep_pp_ranks.py``, JAX-free) runs the port's cases on
pipeline grids over subgroups of it (1, 2 and 4 stages; pipe 2 x data 2;
pipe 2 x model 2; pipe 1 x data 4), once per test run under a file lock;
the pipe-4 and GPipe x TP cases, slow in the JAX suite, in a world of
their own. The JAX package runs at ``tests/parallel/conftest.py``'s
``TICK_GEOM`` (vocab 64, d 32, 4 heads, M 4, max_len 16) on the virtual
CPU devices, each reference once per module; its weights carry over with
``convert.from_flax_pipeline_params``.

Tolerances: logits rtol 2e-3 with atol 2e-4 (the JAX test's); losses rtol
1e-5; statistics rtol 1e-3 with atol 1e-5 (A) and 1e-6 (G) x max, grads rtol 1e-3 with atol 1e-6 x the max over all grads (the JAX test's
against the dense capture); GPipe against 1F1B rtol 2e-4 with atol 2e-6 x
that max for grads and
1e-4 with atol 1e-6 x max for statistics (the JAX test's); training
trajectories rtol 1e-4 against the JAX engine (six steps of EMA factors,
eigendecompositions and kl-clip), 2e-4 between layouts (the JAX test's)
and 2e-3 between the EIGEN and INVERSE methods (the JAX test's); the
kl-clip sums rtol 1e-5.
"""

import fcntl
import os
import pickle
import tempfile
import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import kfac_tpu
import torch_ep_pp_ranks as ranks
from kfac_tpu.parallel import pipeline as jpipeline
from kfac_tpu.parallel.mesh import pipeline_mesh as jax_pipeline_mesh
from kfac_tpu_torch import convert
from kfac_tpu_torch.layers import capture, registry
from kfac_tpu_torch.models import TransformerLM, lm_loss
from kfac_tpu_torch.parallel import mesh as mesh_lib, pipeline, spawn_world
from kfac_tpu_torch.preconditioner import KFACPreconditioner

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

warnings.filterwarnings('ignore', message='pipeline-parallel K-FAC is experimental')

GEOM = dict(vocab_size=64, d_model=32, num_heads=4, max_len=16)


def close(got, want, rtol=1e-5, atol_rel=0.0, msg=''):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * float(np.max(np.abs(want))),
                               err_msg=msg)


def close_grads(got, want, rtol, atol_rel):
    """Each of ``want``'s grads, atol relative to the max over all of
    them (a key bias's gradient is zero up to rounding)."""
    scale = max(float(np.abs(v).max()) for v in want.values())
    for n, v in want.items():
        np.testing.assert_allclose(got[n], v, rtol=rtol, atol=atol_rel * scale, err_msg=n)


class JaxMLPStage(fnn.Module):
    """tests/parallel/test_pipeline.py's ``_MLPStage``."""

    width: int = 48

    @fnn.compact
    def __call__(self, x):
        h = fnn.relu(fnn.Dense(self.width, name='up')(x))
        return x + fnn.Dense(x.shape[-1], name='down')(h)


class JaxSquarePair(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        d = x.shape[-1]
        h = fnn.relu(fnn.Dense(d, name='first')(x))
        return x + fnn.Dense(d, name='second')(h)


JAX_STAGES = {'mlp': JaxMLPStage, 'square': JaxSquarePair}


def jax_mesh(grid):
    n, model, members = ranks.PP_GRIDS[grid]
    devices = jax.devices()[:len(members)]
    if grid in ('p1', 'p2', 'p4'):  # the JAX test's pipe-only _mesh
        return Mesh(np.asarray(devices).reshape(n), ('pipe',))
    return jax_pipeline_mesh(n_stages=n, model=model, devices=devices)


def jax_model(case, grid=None):
    kw = dict(GEOM, num_layers=case.get('layers', 2), n_microbatches=case.get('micro', 4),
              schedule=case.get('schedule', 'gpipe'))
    if 'stage' in case:
        kw['stage_module'] = JAX_STAGES[case['stage']]()
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return jpipeline.PipelinedLM(mesh=jax_mesh(grid or case['grid']), **kw)


def tokens(shape, seed=0):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0, 64)).astype(np.int64)


# the world's cases: each a grid of ranks.PP_GRIDS, a kind, the model's
# shape and its batch
CASES = {
    'forward_1_2': dict(grid='p1', kind='forward', layers=2, batch=(8, 16)),
    'forward_2_4': dict(grid='p2', kind='forward', layers=4, batch=(8, 16)),
    'stats_dense': dict(grid='p1', kind='stats', layers=2, micro=2, batch=(4, 16)),
    'train_2': dict(grid='p2', kind='train', layers=4, micro=4, batch=(8, 16), steps=6),
    'dp_pipe_only': dict(grid='p2', kind='train', layers=4, micro=2, batch=(8, 16), steps=5,
                         kfac=dict(factor_update_steps=2, inv_update_steps=2)),
    'dp_pipe_dp2': dict(grid='p2_dp2', kind='train', layers=4, micro=2, batch=(8, 16), steps=5,
                        kfac=dict(factor_update_steps=2, inv_update_steps=2)),
    'dp_stats': dict(grid='p1_dp4', kind='stats', layers=2, micro=2, batch=(16, 16)),
    'gpipe_dp2': dict(grid='p2_dp2', kind='stats', layers=2, micro=4, batch=(8, 16), seed=1),
    '1f1b_dp2': dict(grid='p2_dp2', kind='stats', layers=2, micro=4, batch=(8, 16), seed=1,
                     schedule='1f1b'),
    '1f1b_train': dict(grid='p2', kind='train', layers=2, micro=8, batch=(16, 16), steps=6,
                       schedule='1f1b'),
    'eigen': dict(grid='p2', kind='train', layers=2, micro=4, batch=(8, 16), steps=5,
                  kfac=dict(kl_clip=None)),
    'inverse_ns': dict(grid='p2', kind='train', layers=2, micro=4, batch=(8, 16), steps=5,
                       kfac=dict(kl_clip=None, compute_method='inverse',
                                 inverse_solver='newton_schulz')),
    'inverse_chol': dict(grid='p2', kind='train', layers=2, micro=4, batch=(8, 16), steps=5,
                         kfac=dict(kl_clip=None, compute_method='inverse')),
    'checkpoint': dict(grid='p2', kind='checkpoint', layers=2, micro=2, batch=(4, 16)),
    'tp_1f1b_dp': dict(grid='p2_dp2', kind='train', layers=2, micro=2, batch=(8, 16), steps=3,
                       schedule='1f1b'),
    'tp_1f1b_tp': dict(grid='p2_tp2', kind='train', layers=2, micro=2, batch=(8, 16), steps=3,
                       schedule='1f1b'),
    'custom_stage': dict(grid='p2', kind='train', layers=2, micro=2, batch=(8, 16), steps=6,
                         schedule='1f1b', stage='mlp'),
    'custom_tp': dict(grid='p2_tp2', kind='tp_overrides', layers=2, micro=2, batch=(8, 16),
                      stage='square'),
    'convert': dict(grid='p2', kind='convert', layers=4, micro=4, batch=(8, 16)),
}
SLOW_CASES = {
    'forward_4_4': dict(grid='p4', kind='forward', layers=4, batch=(8, 16)),
    'train_4': dict(grid='p4', kind='train', layers=4, micro=4, batch=(8, 16), steps=6),
    'tp_gpipe_dp': dict(grid='p2_dp2', kind='train', layers=2, micro=2, batch=(8, 16), steps=3),
    'tp_gpipe_tp': dict(grid='p2_tp2', kind='train', layers=2, micro=2, batch=(8, 16), steps=3),
}


def init_params(case):
    """The JAX model's initial params (numpy), key 1 as the JAX tests (a
    square-layer stage on the model axis warns that nothing shards: its
    JAX run has no overrides)."""
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return jax.device_get(jax_model(case).init(jax.random.PRNGKey(case.get('init', 1))))


def world_spec(cases, root):
    spec = {}
    for name, case in cases.items():
        case = dict(case)
        if name == 'convert':
            case.update(jax_run_3_steps())
        else:
            case['params'] = init_params(case)
        case['tokens'] = tokens(case['batch'], case.get('seed', 0))
        case['root'] = root
        spec[name] = case
    return spec


def jax_train(case, steps, kfac=None, record_at=None):
    """The JAX test's loop: loss_and_stats, PipelineKFAC.step, SGD at 0.1."""
    model = jax_model(case)
    params = model.init(jax.random.PRNGKey(1))
    cfg = kfac_tpu.KFACPreconditioner(registry=model.stage_registry, **ranks.PP_KFAC, **(kfac or {}))
    pk = jpipeline.PipelineKFAC(config=cfg, model=model)
    state = pk.init()
    tok = jnp.asarray(tokens(case['batch'], case.get('seed', 0)))
    batch = (tok, jnp.roll(tok, -1, 1))

    @jax.jit
    def train_step(params, state):
        loss, grads, stats = model.loss_and_stats(params, batch)
        state, grads = pk.step(state, grads, stats)
        return jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params, grads), state, loss

    losses, recorded = [], None
    for i in range(steps):
        if record_at == i:
            recorded = (jax.device_get(params), jax.device_get(state))
        params, state, loss = train_step(params, state)
        losses.append(float(loss))
    return losses, recorded, state


_TRAIN_2 = {}


def jax_train_2_run():
    """The JAX run of ``train_2`` (6 steps), once per module: its losses,
    its final state, and its params and state after step 3 (the
    ``convert`` case's start)."""
    if not _TRAIN_2:
        losses, (params, state3), state = jax_train(CASES['train_2'], 6, record_at=3)
        _TRAIN_2.update(losses=losses, params=params, jax_state=state3, state=state)
    return _TRAIN_2


def jax_run_3_steps():
    """The ``train_2`` JAX run's params and PipelineKFAC state after step 3."""
    run = jax_train_2_run()
    return {k: run[k] for k in ('params', 'jax_state')}


def locked_world(tag, fn):
    uid = os.environ.get('PYTEST_XDIST_TESTRUNUID')
    if uid is None:
        return fn()
    path = os.path.join(tempfile.gettempdir(), f'kfac_torch_pp_{tag}_{uid}.pkl')
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


def run_world(cases):
    with tempfile.TemporaryDirectory(prefix='kfac_pp_') as root:
        return spawn_world(ranks.run_pp, 4, 'gloo', 'cpu', args=(world_spec(cases, root),),
                           timeout_s=600)


@pytest.fixture(scope='module')
def world():
    """The fast cases' world, once per test run (under xdist the first
    worker to need it computes it under a file lock and leaves it for the
    others)."""
    return locked_world('fast', lambda: run_world(CASES))


@pytest.fixture(scope='module')
def world_slow():
    return locked_world('slow', lambda: run_world(SLOW_CASES))


def ranks_of(grid):
    return ranks.PP_GRIDS[grid][2]


def stage_of(out, rank, grid):
    return out[rank]['coords'][grid][0]


def sequential_logits(case):
    """The JAX test's oracle: the stages one after another, unpipelined."""
    model = jax_model(case)
    params = model.init(jax.random.PRNGKey(1))
    tok = jnp.asarray(tokens(case['batch']))
    x = model._embed(params, tok)
    for s in range(model.n_stages):
        sp = jax.tree_util.tree_map(lambda v: v[s], params['stages'])
        x = model.stage.apply({'params': sp}, x)
    x = model.ln_f.apply({'params': params['ln_f']}, x.astype(jnp.float32))
    return np.asarray(model.head.apply({'params': params['head']}, x)), model


def local_microbatch_rows(array, micro, dp, d):
    per = array.shape[0] // micro // dp
    return array.reshape(micro, array.shape[0] // micro, *array.shape[1:])[:, d * per:(d + 1) * per]


def check_forward(out, name, cases):
    case = cases[name]
    want, model = sequential_logits(case)
    for r in ranks_of(case['grid']):
        got = out[r][name]['logits']
        _, d, _ = out[r]['coords'][case['grid']]
        np.testing.assert_allclose(got, local_microbatch_rows(want, 4, 1, d), rtol=2e-3, atol=2e-4)


# ------------------------------------------------------------- no world needed


def stub_grid(n_stages=2, model=1):
    return mesh_lib.PipelineGrid(n_stages=n_stages, dp=1, model=model, rank=0,
                                 device=torch.device('cpu'), group=None, groups={})


def test_1f1b_rejects_unknown_schedule():
    with pytest.raises(ValueError):
        pipeline.PipelinedLM(stub_grid(), **GEOM, num_layers=2, schedule='2f2b')
    with pytest.raises(ValueError, match='interleaved'):
        pipeline.PipelinedLM(stub_grid(), **GEOM, num_layers=2, schedule='interleaved')


def test_pipeline_rejects_shape_changing_stage():
    with pytest.raises(ValueError, match='map'):
        pipeline.PipelinedLM(stub_grid(), **GEOM, num_layers=2, n_microbatches=2,
                             stage_module=lambda: torch.nn.Linear(32, 16))


def test_pipeline_rejects_a_routed_layer_inside_a_stage():
    with pytest.raises(NotImplementedError, match='routed'):
        pipeline.PipelinedLM(stub_grid(1), **GEOM, num_layers=2, routed_layers=[r'.*mlp_up'])


def test_pipeline_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match='init_process_group'):
        mesh_lib.pipeline_mesh(2, device='cpu')


def test_pipeline_kl_clip_sum_is_the_dense_engines(world):
    """The kl-clip sum each stage scales by (its terms all-reduced over the
    pipe) is the dense engine's over every block of the same weights and
    batch (the sequential LM)."""
    case = CASES['train_2']
    params = init_params(case)
    per = case['layers'] // 2
    full = {}
    for s in range(2):
        for k, v in convert.from_flax_pipeline_params(params, s).items():
            if k.startswith('stage.block'):
                b, rest = k[len('stage.block'):].split('.', 1)
                k = f'block{s * per + int(b)}.{rest}'
            full[k] = v
    lm = TransformerLM(**GEOM, num_layers=case['layers'], device='cpu')
    lm.load_state_dict(full)
    reg = registry.register_model(lm, skip_layers=['lm_head'], device='cpu')
    dense = KFACPreconditioner(reg, device='cpu', **ranks.PP_KFAC)
    tok = torch.from_numpy(tokens(case['batch']))
    (_, _), grads, stats = capture.CurvatureCapture(reg).value_stats_and_grad(lm_loss(lm))(
        (tok, torch.roll(tok, -1, dims=1)))
    seen = []
    dense.step(dense.init(), grads, stats, vg_reduce=lambda terms, vg: seen.append(vg) or vg)
    for r in ranks_of(case['grid']):
        close(world[r]['train_2']['vg'][0], float(seen[0]), rtol=1e-5)


# ------------------------------------------------------------------ the world


def test_pipeline_mesh_rank_order_follows_the_jax_reshape(world):
    for grid, (n, model, members) in ranks.PP_GRIDS.items():
        if grid in ('p1', 'p2', 'p4'):
            continue
        ids = np.vectorize(lambda d: d.id)(np.asarray(jax_mesh(grid).devices))  # (pipe, 1, dp, model)
        for r in members:
            stage, d, m = world[r]['coords'][grid]
            assert ids[stage, 0, d, m] == r, (grid, r)


@pytest.mark.parametrize('name', ['forward_1_2', 'forward_2_4'])
def test_pipeline_forward_matches_sequential(world, name):
    check_forward(world, name, CASES)


@pytest.mark.slow
def test_pipeline_forward_matches_sequential_four_stages(world_slow):
    check_forward(world_slow, 'forward_4_4', SLOW_CASES)


def dense_capture(case):
    """The JAX test's dense oracle: the single stage as a flat flax model
    under the interceptor capture."""
    model = jax_model(case)
    params = model.init(jax.random.PRNGKey(1))
    tok = jnp.asarray(tokens(case['batch']))
    tg = jnp.roll(tok, -1, 1)

    def flat_loss(stage_params, batch):
        tk, tgt = batch
        x = model._embed(params, tk)
        x = model.stage.apply({'params': stage_params}, x)
        x = model.ln_f.apply({'params': params['ln_f']}, x.astype(jnp.float32))
        logp = jax.nn.log_softmax(model.head.apply({'params': params['head']}, x), -1)
        return -jnp.mean(jnp.take_along_axis(logp, tgt[..., None], -1))

    cap = kfac_tpu.CurvatureCapture(model.stage_registry)
    sp0 = jax.tree_util.tree_map(lambda v: v[0], params['stages'])
    (loss0, _), grads0, stats0 = jax.jit(cap.value_stats_and_grad(flat_loss))(sp0, (tok, tg))
    return float(loss0), jax.device_get(grads0), jax.device_get(stats0), model


@pytest.mark.parametrize('name', ['stats_dense', 'dp_stats'])
def test_pipeline_stats_match_dense_capture(world, name):
    """Stage statistics (and under pipe 1 x data 4 the data reduction) equal
    the dense capture of the single-stage model on the whole batch."""
    case = CASES[name]
    loss0, grads0, stats0, model = dense_capture(case)
    for r in ranks_of(case['grid']):
        got = world[r][name]
        close(got['loss'], loss0, rtol=1e-5)
        assert got['names'] == list(model.stage_registry.layers)
        for n in stats0.a:
            assert got['shapes'][n] == model.stage_registry.layers[n].a_factor_shape
            close(got['stats']['a'][n], stats0.a[n], rtol=1e-3, atol_rel=1e-5, msg=f'A {n}')
            close(got['stats']['g'][n], stats0.g[n], rtol=1e-3, atol_rel=1e-6, msg=f'G {n}')
        want = {f'stage.{k}': v.numpy() for k, v in convert.from_flax_params(grads0).items()}
        close_grads(got['grads'], want, rtol=1e-3, atol_rel=1e-6)


def test_pipeline_kfac_training(world):
    run = jax_train_2_run()
    losses, state = run['losses'], run['state']
    assert losses[-1] < losses[0]
    for r in ranks_of('p2'):
        got = world[r]['train_2']
        close(got['losses'], losses, rtol=1e-4)
        # the stage-local state is the JAX stage slice's
        stage = stage_of(world, r, 'p2')
        for n, a in got['stage_a'].items():
            close(a, np.asarray(state['a'][n])[stage], rtol=1e-3, atol_rel=1e-5, msg=n)


@pytest.mark.slow
def test_pipeline_kfac_training_four_stages(world_slow):
    losses, _, _ = jax_train(SLOW_CASES['train_4'], 6)
    for r in ranks_of('p4'):
        close(world_slow[r]['train_4']['losses'], losses, rtol=1e-4)


def test_pipeline_dp_matches_pipe_only(world):
    """PP x DP (pipe 2 x data 2) follows the pipe-only run's trajectory on
    the same global batch, and both the JAX pipe-only run's."""
    want, _, _ = jax_train(CASES['dp_pipe_only'], 5, kfac=CASES['dp_pipe_only']['kfac'])
    for r in ranks_of('p2'):
        close(world[r]['dp_pipe_only']['losses'], want, rtol=1e-4)
    for r in ranks_of('p2_dp2'):
        close(world[r]['dp_pipe_dp2']['losses'], world[0]['dp_pipe_only']['losses'], rtol=2e-4)
    assert want[-1] < want[0]


def test_1f1b_matches_gpipe_loss_grads_stats(world):
    """1F1B and GPipe give the same loss, grads and statistics (pipe 2 x
    data 2), and GPipe's are the JAX GPipe's."""
    case = CASES['gpipe_dp2']
    model = jax_model(case)
    params = model.init(jax.random.PRNGKey(1))
    tok = jnp.asarray(tokens(case['batch'], 1))
    l_g, g_g, s_g = jax.device_get(jax.jit(model.loss_and_stats)(params, (tok, jnp.roll(tok, -1, 1))))
    for r in ranks_of('p2_dp2'):
        gp, ob = world[r]['gpipe_dp2'], world[r]['1f1b_dp2']
        stage = stage_of(world, r, 'p2_dp2')
        close(gp['loss'], float(l_g), rtol=1e-5)
        close(ob['loss'], gp['loss'], rtol=1e-5)
        close_grads(ob['grads'], gp['grads'], rtol=2e-4, atol_rel=2e-6)
        for n in gp['stats']['a']:
            close(ob['stats']['a'][n], gp['stats']['a'][n], rtol=1e-4, atol_rel=1e-6)
            close(ob['stats']['g'][n], gp['stats']['g'][n], rtol=1e-4, atol_rel=1e-6)
            close(gp['stats']['a'][n], np.asarray(s_g.a[n])[stage], rtol=1e-3, atol_rel=1e-5)
            close(gp['stats']['g'][n], np.asarray(s_g.g[n])[stage], rtol=1e-3, atol_rel=1e-6)
        want = {n: v.numpy() for n, v in convert.from_flax_pipeline_params(g_g, stage).items()}
        close_grads(gp['grads'], want, rtol=1e-3, atol_rel=1e-6)


def test_1f1b_kfac_training(world):
    """PipelineKFAC on the 1F1B schedule with 8 microbatches follows the
    JAX run."""
    want, _, _ = jax_train(CASES['1f1b_train'], 6)
    assert want[-1] < want[0]
    for r in ranks_of('p2'):
        got = world[r]['1f1b_train']['losses']
        assert all(np.isfinite(got))
        close(got, want, rtol=1e-4)


def test_pipeline_inverse_method_matches_eigen(world):
    """INVERSE (Newton-Schulz, Cholesky) and EIGEN solve the same damped
    system; EIGEN follows the JAX run."""
    want, _, _ = jax_train(CASES['eigen'], 5, kfac=CASES['eigen']['kfac'])
    for r in ranks_of('p2'):
        eig = world[r]['eigen']['losses']
        close(eig, want, rtol=1e-4)
        close(world[r]['inverse_ns']['losses'], eig, rtol=2e-3)
        close(world[r]['inverse_chol']['losses'], world[r]['inverse_ns']['losses'], rtol=2e-3)
        assert eig[-1] < eig[0]


def test_pipeline_checkpoint_roundtrip(world):
    """Each rank saves its stage's state and its parameters (sharded),
    restores them, the decompositions rematerialize, and the next step is
    the same; a restore into another stage count is refused."""
    for r in ranks_of('p2'):
        got = world[r]['checkpoint']
        assert got['step'][0] == got['step'][1] == 3
        assert got['a_equal'] and got['decomp_nonzero'] > 0
        assert got['params_saved_equal']
        assert got['losses'][0] == got['losses'][1]
        assert got['params_after'] == 0.0
        # another stage count, or a dense engine, is refused, as in JAX
        for msg in got['refusals']:
            assert msg is not None and 'identical pipeline layout' in msg


@pytest.mark.parametrize('schedule', ['1f1b', pytest.param('gpipe', marks=pytest.mark.slow)])
def test_tp_pp_matches_pp_dp_only(world, world_slow_if_needed, schedule):
    """Pipe 2 x model 2 follows pipe 2 x data 2 on the same global batch,
    and both the JAX pipe 2 x data 2 run."""
    out = world if schedule == '1f1b' else world_slow_if_needed
    case = dict(CASES['tp_1f1b_dp'], schedule=schedule)
    want, _, _ = jax_train(case, 3)
    tag = 'tp_1f1b' if schedule == '1f1b' else 'tp_gpipe'
    for r in range(4):
        close(out[r][f'{tag}_dp']['losses'], want, rtol=1e-4)
        close(out[r][f'{tag}_tp']['losses'], out[r][f'{tag}_dp']['losses'], rtol=2e-4)
    assert want[-1] < want[0]


@pytest.fixture
def world_slow_if_needed(request):
    if request.node.callspec.params.get('schedule') == 'gpipe':
        return request.getfixturevalue('world_slow')
    return None


def test_pipeline_custom_stage_module_trains(world):
    """A non-transformer stage pipelines under 1F1B with K-FAC, as the JAX
    run."""
    want, _, _ = jax_train(CASES['custom_stage'], 6)
    for r in ranks_of('p2'):
        got = world[r]['custom_stage']
        assert got['n_layers'] == 2
        assert set(got['stage_a']) == {'up', 'down'}
        close(got['losses'], want, rtol=1e-4)
    assert want[-1] < want[0]


def test_custom_stage_tp_overrides_shard_over_model_axis(world):
    for r in range(4):
        got = world[r]['custom_tp']
        assert got['warned'] and not got['warned_explicit']
        assert got['kinds'] == {'first': 'column', 'second': 'row'}
        assert got['first'] == (16, 32) and got['second'] == (32, 16)
        assert got['head'] == 'column'
        assert np.isfinite(got['loss']) and got['names'] == ['first', 'second']


def test_from_jax_pipeline_state_continues_the_jax_run(world):
    """The JAX run's params and PipelineKFAC state after step 3, taken over
    by ``convert``: the port's step 4 is the JAX step 4."""
    want = jax_train_2_run()['losses'][3]
    for r in ranks_of('p2'):
        got = world[r]['convert']
        close(got['loss'], want, rtol=1e-5)
        assert got['step'] == 4
