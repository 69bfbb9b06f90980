"""The port's expert parallelism against the JAX package: ``train_mesh``'s
expert axis, ``EPSwitchFFN``'s all-to-all dispatch and exact per-expert
capture, ``combined_value_stats_and_grad``, ``ExpertParallelKFAC`` with
its model-wide kl-clip, the MoE LM with EP blocks (alone and under tensor
parallelism), and routed capture of tensor-parallel experts
(``tests/test_moe.py::test_moe_expert_parallel_layout``).

One gloo world of four CPU ranks (rank bodies in
``tests/torch_ep_pp_ranks.py``, JAX-free) runs every port case, once per
test run under a file lock; the JAX package runs at its own tests' sizes
(``tests/parallel/test_expert_parallel.py``: E 4, D 8, B 8, S 4; the MoE
LM of ``tests/test_moe.py``) on four of the virtual CPU devices, so that
each rank's tokens are the JAX device's.

Tolerances: outputs rtol 1e-5 with atol 1e-6 x max|reference|; losses
rtol 1e-5; gradients and A / G factors rtol 2e-4 with atol 1e-6 x max
(the JAX test's, against the dense masked oracle); evidence weights atol
1e-6; the 20-step training losses rtol 1e-4; the engines' preconditioned
grads rtol 1e-3 with atol 1e-4 x the step's max (two EMA steps and an
eigendecomposition apart from the JAX engine); the kl-clip sums rtol
1e-5; replicated parameters bitwise across ranks.
"""

import fcntl
import os
import pickle
import tempfile

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kfac_tpu
import torch_ep_pp_ranks as ranks
from kfac_tpu.models import TransformerLM as JaxLM
from kfac_tpu.models import moe as jmoe
from kfac_tpu.ops import losses as jlosses
from kfac_tpu.parallel import EPSwitchFFN as JaxEP
from kfac_tpu.parallel import train_mesh as jax_train_mesh
from kfac_tpu.parallel.mesh import token_sharding
from kfac_tpu_torch import convert
from kfac_tpu_torch.parallel import expert_parallel, mesh as mesh_lib, spawn_world

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

E, D, B, S, RATIO = ranks.E, ranks.D, ranks.B, ranks.S, ranks.RATIO
DEVICES = 4


def close(got, want, rtol=1e-5, atol_rel=1e-6, msg=''):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * float(np.max(np.abs(want))),
                               err_msg=msg)


def flat_flax(grads, prefix=''):
    """A flax grads tree as the port's parameter-keyed numpy dict."""
    return {prefix + k: v.numpy() for k, v in convert.from_flax_params(jax.device_get(grads)).items()}


def inputs():
    """The JAX test's weights and batches (numpy)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    target = rng.normal(size=(B, S, D)).astype(np.float32)
    moe = jmoe.MoEMLP(num_experts=E, mlp_ratio=RATIO)
    moe_params = jax.device_get(moe.init(jax.random.PRNGKey(1), jnp.asarray(x))['params'])
    oracle = Oracle()
    combined = jax.device_get(oracle.init(jax.random.PRNGKey(1), jnp.asarray(x))['params'])
    tokens = rng.integers(0, 64, (8, 16)).astype(np.int64)
    lm = JaxLM(**ranks.MOE_LM)
    lm_params = jax.device_get(lm.init(jax.random.PRNGKey(1), jnp.asarray(tokens))['params'])
    return dict(
        x=x, target=target, train_target=np.tanh(np.roll(x, 1, axis=-1)),
        moe_params=moe_params, combined_params=combined, tokens=tokens,
        targets=np.roll(tokens, -1, axis=1), lm_params_flax=lm_params,
        lm_params={k: v.numpy() for k, v in convert.from_flax_params(lm_params).items()},
    )


class Oracle(fnn.Module):
    """tests/parallel/test_expert_parallel.py's oracle: a projection and
    two MoEMLPs."""

    @fnn.compact
    def __call__(self, x):
        x = fnn.Dense(D, name='proj')(x)
        x = jmoe.MoEMLP(num_experts=E, mlp_ratio=RATIO, name='moe0')(x)
        return jmoe.MoEMLP(num_experts=E, mlp_ratio=RATIO, name='moe1')(x)


def run_world():
    spec = {k: v for k, v in inputs().items() if k != 'lm_params_flax'}
    return spawn_world(ranks.run_ep, 4, 'gloo', 'cpu', args=(spec,), timeout_s=300)


@pytest.fixture(scope='module')
def world():
    """:func:`run_world` once per test run: under pytest-xdist the first
    worker to need it computes it under a file lock and leaves it in the
    temporary directory, keyed by the run's id, for the others."""
    uid = os.environ.get('PYTEST_XDIST_TESTRUNUID')
    if uid is None:
        return run_world()
    path = os.path.join(tempfile.gettempdir(), f'kfac_torch_ep_{uid}.pkl')
    with open(path + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            with open(path, 'rb') as f:
                return pickle.load(f)
        out = run_world()
        with open(path + '.tmp', 'wb') as f:
            pickle.dump(out, f)
        os.replace(path + '.tmp', path)
        return out


@pytest.fixture(scope='module')
def data():
    return inputs()


def jax_mesh(**kw):
    return jax_train_mesh(devices=jax.devices()[:DEVICES], **kw)


@pytest.fixture(scope='module')
def oracle(data):
    """The dense masked MoEMLP with routed capture on the global batch."""
    moe = jmoe.MoEMLP(num_experts=E, mlp_ratio=RATIO)
    x = jnp.asarray(data['x'])
    reg = kfac_tpu.register_model(moe, x, routed_layers=ranks.ROUTED)

    def loss(p, batch):
        xb, tb = batch
        return jnp.mean((moe.apply({'params': p}, xb) - tb) ** 2)

    run = jax.jit(kfac_tpu.CurvatureCapture(reg).value_stats_and_grad(loss))
    (l, _), g, s = run(data['moe_params'], (x, jnp.asarray(data['target'])))
    y = moe.apply({'params': data['moe_params']}, x)
    return dict(loss=float(l), grads=flat_flax(g), stats=jax.device_get(s), y=np.asarray(y))


def jax_ep_run(data, cf):
    """The JAX EP block at capacity ``cf`` on a data 2 x expert 2 mesh."""
    mesh = jax_mesh(expert=2)
    ep = JaxEP(mesh=mesh, num_experts=E, mlp_ratio=RATIO, capacity_factor=cf)
    ts = token_sharding(mesh)
    xs = jax.device_put(jnp.asarray(data['x']), ts)
    tgt = jax.device_put(jnp.asarray(data['target']), ts)
    y = jax.jit(lambda p, x: ep.apply(p, x))(data['moe_params'], xs)
    run = ep.value_stats_and_grad(lambda p, b, ffn: jnp.mean((ffn(p, b[0]) - b[1]) ** 2))
    (l, _), g, s = run(data['moe_params'], (xs, tgt))
    return dict(y=np.asarray(y), loss=float(l), grads=flat_flax(g), stats=jax.device_get(s))


def local_rows(world_out, rank, grid_name, array):
    blocks, index = world_out[rank]['coords'][grid_name]['rows']
    per = array.shape[0] // blocks
    return array[index * per:(index + 1) * per]


def check_capture(got, want, experts, tol=2e-4):
    close(got['loss'], want['loss'], rtol=1e-5)
    names = ['router'] + [f'expert{e}_{r}' for e in experts for r in ('up', 'down')]
    for n in names:
        for leaf in ('weight', 'bias'):
            close(got['grads'][f'{n}.{leaf}'], want['grads'][f'{n}.{leaf}'], rtol=tol,
                  msg=f'grad {n}.{leaf}')
        close(got['stats']['a'][n], want['stats'].a[n], rtol=tol, msg=f'A {n}')
        close(got['stats']['g'][n], want['stats'].g[n], rtol=tol, msg=f'G {n}')
    assert set(got['stats']['a']) == set(names)
    for n in names[1:]:
        np.testing.assert_allclose(got['stats']['w'][n], float(want['stats'].w[n]), atol=1e-6,
                                   err_msg=f'w {n}')


# ------------------------------------------------------------- no world needed


def test_ep_num_experts_must_divide_axis():
    grid = mesh_lib.TrainGrid(grad_workers=1, n_cols=1, rank=0, device=torch.device('cpu'),
                              group=None, col_groups=[], row_groups=[], expert=2)
    with pytest.raises(ValueError, match='not divisible'):
        expert_parallel.EPSwitchFFN(grid, D, 3)
    with pytest.raises(ValueError, match='no .expert. axis'):
        expert_parallel.EPSwitchFFN(mesh_lib.TrainGrid(
            grad_workers=1, n_cols=1, rank=0, device=torch.device('cpu'), group=None,
            col_groups=[], row_groups=[]), D, E)
    ffn = expert_parallel.EPSwitchFFN(grid, D, E, RATIO)
    with pytest.raises(ValueError, match='distinct'):
        expert_parallel.combined_value_stats_and_grad(lambda b, f: 0.0, ep_ffns=(ffn, ffn))


def test_ep_state_refuses_to_checkpoint(tmp_path):
    """Each rank holds its own experts' state: a checkpoint of it is not
    ported, and says so rather than writing rank 0's alone."""
    from kfac_tpu_torch import checkpoint
    from kfac_tpu_torch.preconditioner import KFACPreconditioner

    grid = mesh_lib.TrainGrid(grad_workers=1, n_cols=1, rank=0, device=torch.device('cpu'),
                              group=None, col_groups=[], row_groups=[], expert=2)
    ffn = expert_parallel.EPSwitchFFN(grid, D, E, RATIO)
    engine = expert_parallel.ExpertParallelKFAC(
        KFACPreconditioner(ffn.registry(), device='cpu'), grid, [ffn])
    with pytest.raises(NotImplementedError, match='expert-parallel'):
        checkpoint.save(str(tmp_path / 'ep'), engine.init(), engine=engine)


def test_ep_block_draws_the_dense_moe_weights():
    """From one seed the EP block holds the dense MoEMLP's router and its
    own experts (MoEMLP's draw order), on every expert index."""
    from kfac_tpu_torch.models import TransformerLM

    dense = TransformerLM(**ranks.MOE_LM, device='cpu', seed=3)
    for e_idx in range(2):
        grid = mesh_lib.TrainGrid(grad_workers=1, n_cols=1, rank=e_idx, device=torch.device('cpu'),
                                  group=None, col_groups=[], row_groups=[], expert=2)
        ep = TransformerLM(**ranks.MOE_LM, device='cpu', seed=3, ep_mesh=grid)
        want = dense.state_dict()
        got = ep.state_dict()
        assert set(got) < set(want)
        assert f'block1.moe.expert{2 * e_idx}_up.weight' in got
        assert 'block1.moe.expert{}_up.weight'.format(2 - 2 * e_idx) not in got
        for k, v in got.items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0)


# ------------------------------------------------------------------ the world


def test_train_mesh_expert_axis_and_token_sharding(world):
    """Every rank's coordinates and row block are the JAX mesh's device's:
    tokens shard over data and expert jointly; without ``expert`` the mesh
    has no expert axis."""
    shape = (B, S, D)
    for name, kw in ranks.EP_GRIDS.items():
        mesh = jax_mesh(**kw)
        if kw.get('expert', 1) > 1:
            assert mesh.shape['expert'] == kw['expert']
            assert 'expert' in token_sharding(mesh).spec[0]
        else:
            assert 'expert' not in mesh.shape
        ids = np.vectorize(lambda d: d.id)(np.asarray(mesh.devices))
        index = token_sharding(mesh).devices_indices_map(shape)
        for r in range(DEVICES):
            got = world[r]['coords'][name]
            dev = jax.devices()[r]
            pos = tuple(int(c) for c in np.argwhere(ids == dev.id)[0])
            assert tuple(got['coords']) == pos + (0,) * (5 - len(pos)), (name, r)
            blocks, i = got['rows']
            assert (index[dev][0].start or 0) == i * (B // blocks), (name, r)


def test_ep_forward_matches_dense_masked_moe(world, oracle):
    for r in range(DEVICES):
        close(world[r]['capture_ep2']['y'], local_rows(world, r, 'ep2', oracle['y']), rtol=2e-5,
              atol_rel=2e-6)


def test_ep_capacity_drops_are_finite_and_match_jax(world, data):
    want = jax_ep_run(data, 0.25)
    for r in range(DEVICES):
        y = world[r]['forward_drops']
        assert np.all(np.isfinite(y))
        close(y, local_rows(world, r, 'ep2', want['y']), rtol=2e-5, atol_rel=2e-6)


@pytest.mark.parametrize('layout', ['ep2', 'ep4', 'tp_ep'])
def test_ep_grads_and_stats_match_routed_interceptor_capture(world, oracle, layout):
    """Loss, grads, A, G and the evidence weights of the EP block equal the
    dense masked MoEMLP's routed capture, in each layout."""
    for r in range(DEVICES):
        got = world[r][f'capture_{layout}']
        check_capture(got, oracle, got['experts'])


def test_ep_drops_at_low_capacity_match_jax_ep(world, data):
    """At capacity 0.5 tokens drop: the slots (local cumsum, peer rank
    order) and so the drops, loss, grads and statistics are JAX's."""
    want = jax_ep_run(data, 0.5)
    for r in range(DEVICES):
        got = world[r]['capture_ep2_cf0.5']
        check_capture(got, want, got['experts'])


def test_ep_kfac_step_trains(world, data):
    """ExpertParallelKFAC over the EP capture follows the JAX loop (EP
    capture into the dense KFACPreconditioner) for 20 steps."""
    mesh = jax_mesh(expert=2)
    ep = JaxEP(mesh=mesh, num_experts=E, mlp_ratio=RATIO, capacity_factor=float(E))
    kfac = kfac_tpu.KFACPreconditioner(registry=ep.registry(D), **ranks.EP_TRAIN)
    run = ep.value_stats_and_grad(lambda p, b, ffn: jnp.mean((ffn(p, b[0]) - b[1]) ** 2))
    ts = token_sharding(mesh)
    batch = (jax.device_put(jnp.asarray(data['x']), ts),
             jax.device_put(jnp.asarray(data['train_target']), ts))

    @jax.jit
    def step(params, kstate, batch):
        (l, _), grads, stats = run(params, batch)
        kstate, pg = kfac.step(kstate, grads, stats)
        return jax.tree_util.tree_map(lambda p, g: p - 0.2 * g, params, pg), kstate, l

    params, kstate, losses = data['moe_params'], kfac.init(), []
    for _ in range(ranks.EP_TRAIN_STEPS):
        params, kstate, l = step(params, kstate, batch)
        losses.append(float(l))
    assert losses[-1] < losses[0] * 0.7
    for r in range(DEVICES):
        close(world[r]['train']['losses'], losses, rtol=1e-4)


def test_ep_kl_clip_sum_spans_every_expert_as_the_dense_engine(world):
    """The kl-clip sum every rank scales by is the dense engine's over the
    whole block (every expert's term reached every rank by the expert
    all-reduce), so the scale is too."""
    for r in range(DEVICES):
        got = world[r]['train']
        close(got['vg_step0'], got['dense_vg_step0'], rtol=1e-5)


def test_combined_capture_two_ep_blocks_plus_flax_layer(world, data):
    oracle = Oracle()
    x = jnp.asarray(data['x'])
    oreg = kfac_tpu.register_model(oracle, x, routed_layers=ranks.ROUTED)

    def oracle_loss(p, batch):
        xb, tb = batch
        return jnp.mean((oracle.apply({'params': p}, xb) - tb) ** 2)

    (l_ref, _), g_ref, s_ref = jax.jit(kfac_tpu.CurvatureCapture(oreg).value_stats_and_grad(
        oracle_loss))(data['combined_params'], (x, jnp.asarray(data['train_target'])))
    g_ref = flat_flax(g_ref)
    names = set()
    for r in range(DEVICES):
        got = world[r]['combined']
        close(got['loss'], float(l_ref), rtol=1e-5)
        assert got['hooked'] == ['proj']
        names |= set(got['merged'])
        for n, v in got['grads'].items():
            close(v, g_ref[n], rtol=5e-4, atol_rel=2e-6, msg=f'grad {n}')
        for n in got['stats']['a']:
            close(got['stats']['a'][n], s_ref.a[n], rtol=5e-4, atol_rel=2e-6, msg=f'A {n}')
            close(got['stats']['g'][n], s_ref.g[n], rtol=5e-4, atol_rel=2e-6, msg=f'G {n}')
    assert names == set(oreg.layers)  # the ranks' registries cover the oracle's


def test_combined_capture_rejects_double_call_and_uninvoked_block(world):
    for r in range(DEVICES):
        errors = world[r]['errors']
        assert 'more than once' in errors['double']
        assert 'never called' in errors['uninvoked']


def jax_dense_engine(data, steps, lr_sgd=0.1):
    """The JAX dense engine on the MoE LM with routed capture: each step's
    loss and preconditioned grads (as the port's keys)."""
    jm = JaxLM(**ranks.MOE_LM)
    tokens = jnp.asarray(data['tokens'])
    batch = (tokens, jnp.asarray(data['targets']))
    reg = kfac_tpu.register_model(jm, tokens, skip_layers=['lm_head'], routed_layers=ranks.ROUTED)
    kfac = kfac_tpu.KFACPreconditioner(registry=reg, **ranks.EP_LM_KW)

    def loss_fn(p, b):
        return jnp.mean(jlosses.vocab_parallel_nll(jm.apply({'params': p}, b[0]), b[1]))

    run = kfac_tpu.CurvatureCapture(reg).value_stats_and_grad(loss_fn)

    @jax.jit
    def step(params, kstate):
        (l, _), grads, stats = run(params, batch)
        kstate, pg = kfac.step(kstate, grads, stats)
        return jax.tree_util.tree_map(lambda p, g: p - lr_sgd * g, params, pg), kstate, l, pg

    params, kstate, out = data['lm_params_flax'], kfac.init(), []
    for _ in range(steps):
        params, kstate, l, pg = step(params, kstate)
        out.append((float(l), flat_flax(pg)))
    return out


@pytest.fixture(scope='module')
def dense_engine(data):
    return jax_dense_engine(data, 2)


def check_pgrads(got, want, names):
    scale = max(float(np.abs(v).max()) for v in want.values())
    for n in names:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-3, atol=1e-4 * scale, err_msg=n)


def test_moe_expert_parallel_layout_routed_capture_under_tp(world, dense_engine):
    """tests/test_moe.py::test_moe_expert_parallel_layout with the experts
    registered routed: expert_tp_overrides shards them Megatron-style on a
    data 2 x model 2 grid, routed capture takes live rows from the gathered
    rows, and one DistributedKFAC step equals the JAX dense engine's."""
    loss, want = dense_engine[0]
    for r in range(DEVICES):
        got = world[r]['routed_tp']
        assert got['kinds']['block1/moe/expert0_up'] == 'column'
        assert got['kinds']['block1/moe/expert0_down'] == 'row'
        close(got['loss'], loss, rtol=1e-5)
        check_pgrads(got['pgrads'], want, want)
        for n, w in got['w'].items():  # G-side weights from the gathered rows
            np.testing.assert_allclose(got['wg'][n], w, atol=1e-6, err_msg=n)


@pytest.mark.parametrize('layout', ['ep_lm', 'ep_lm_ep4'])
def test_moe_lm_with_ep_blocks_matches_the_dense_engine(world, dense_engine, layout):
    """The MoE LM with its MoE block expert-parallel (model 2 x expert 2,
    the other layers tensor-parallel; expert 4) under ExpertParallelKFAC:
    two steps' losses and preconditioned grads equal the JAX dense
    engine's on the dense masked LM (experts on their ranks), and the
    replicated parameters are bitwise equal on every rank."""
    for r in range(DEVICES):
        got = world[r][layout]
        for i, (loss, want) in enumerate(dense_engine):
            close(got['losses'][i], loss, rtol=1e-5)
            check_pgrads(got['pgrads'][i], want, got['pgrads'][i])
        assert got['experts'] and set(got['experts']) < set(dense_engine[0][1])
    for n, v in world[0][layout]['replicated'].items():
        for r in range(1, DEVICES):
            np.testing.assert_array_equal(world[r][layout]['replicated'][n], v, err_msg=n)
