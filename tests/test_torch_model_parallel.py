"""The port's tensor and sequence parallelism against the JAX package's.

One gloo world of four CPU ranks (``spawn_world``, rank bodies in
``tests/torch_model_parallel_ranks.py``, which import no JAX) runs every
case once per test run; under pytest-xdist the first worker to need it
computes it under a file lock and the others read it. The JAX package runs
on ``train_mesh(..., devices=jax.devices()[:4])`` of the 8 virtual CPU
devices, on the global arrays, at the sizes of
``tests/parallel/test_model_parallel.py`` (vocab 64, d 32, 4 heads, 2
layers). Inputs are drawn with numpy (weights by flax's ``init``) and
carried over with ``convert.from_flax_params``.

Tolerances:

- ring, zigzag and non-causal ring attention, outputs and input grads
  against the JAX ``make_context_parallel_attention``: rtol 1e-5 with atol
  1e-6 x the largest (the same partials merged in the same order);
- the vocab-parallel NLL: rtol 1e-6 on the loss, and on its gradient
  rtol 1e-6 with atol 1e-6 x the largest (the sum of exps summed over four
  shards in another order);
- the captured A and G of a registry-sharded net against the JAX
  capture's replicated oracle: the JAX test's rtol 1e-4 with atol 1e-5
  (A) and 1e-6 (G);
- three ``DistributedKFAC`` steps of the LM in each layout against the JAX
  engine's on ``train_mesh(0.5, model=2)`` (every layout's run is the same
  function of the global batch): losses rtol 1e-5; the last step's preconditioned grads rtol
  1e-4 with atol 1e-5 x the largest; the factor stacks rtol 1e-5 with atol
  1e-6 x max (the G scale under sequence shards); and against the port's
  own replicated run (the dense engine on the global batch) at the same
  tolerances;
- rank coordinates, the rules and kinds, ``zigzag_indices``: exact.
"""

import concurrent.futures
import fcntl
import functools
import os
import pickle
import tempfile
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kfac_tpu
import torch_model_parallel_ranks as ranks
from kfac_tpu.models import TransformerLM as JaxLM
from kfac_tpu.models import attention as jattention
from kfac_tpu.models import lm_loss as jax_lm_loss
from kfac_tpu.ops import losses as jlosses
from kfac_tpu.parallel import DistributedKFAC as JaxDistributedKFAC
from kfac_tpu.parallel import tensor_parallel as jtp
from kfac_tpu.parallel.mesh import token_sharding, train_mesh as jax_train_mesh
from kfac_tpu_torch import convert
from kfac_tpu_torch.layers import registry
from kfac_tpu_torch.models import TransformerLM, attention, lm_loss
from kfac_tpu_torch.parallel import mesh as mesh_lib
from kfac_tpu_torch.parallel import spawn_world
from kfac_tpu_torch.parallel import tensor_parallel as tp
from kfac_tpu_torch.preconditioner import KFACPreconditioner
from kfac_tpu_torch.training import Trainer

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

WORLD = 4
BATCH, SEQ = 8, 16


def rng(seed):
    return np.random.default_rng(seed)


def jax_mesh(name):
    kw = ranks.GRIDS[name]
    return jax_train_mesh(
        kw.get('frac', 1.0), model=kw.get('model', 1), seq=kw.get('seq', 1),
        devices=jax.devices()[:WORLD],
    )


@functools.cache
def flax_generic():
    import flax.linen as nn

    class Net(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.relu(nn.Dense(128, name='expander')(x))
            x = nn.Dense(32, name='contractor')(x)
            return nn.Dense(10, name='classify_out', use_bias=False)(x)

    m = Net()
    x = rng(1).normal(size=(16, 32)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[np.arange(16) % 10]
    params = jax.device_get(jax.jit(m.init)(jax.random.PRNGKey(1), jnp.asarray(x))['params'])
    return m, params, (x, y)


@functools.cache
def flax_lm():
    lm = JaxLM(**ranks.LM_CFG)
    tokens = rng(7).integers(0, ranks.LM_CFG['vocab_size'], (BATCH, SEQ)).astype(np.int32)
    params = jax.device_get(jax.jit(lm.init)(jax.random.PRNGKey(1), jnp.asarray(tokens))['params'])
    return params, (tokens, np.roll(tokens, -1, axis=1))


def spec_arrays():
    g = rng(11)
    q, k, v, dout = (g.normal(size=(2, SEQ, 4, 8)).astype(np.float32) for _ in range(4))
    logits = (3 * g.normal(size=(16, 64))).astype(np.float32)
    targets = g.integers(0, 64, (16,)).astype(np.int64)
    return dict(q=q, k=k, v=v, dout=dout), logits, targets


def jax_attention(qkv):
    """The JAX package's outputs and input grads of each attention case
    on the global arrays."""
    out = {}
    for name, (grid, causal) in ranks.ATTENTION.items():
        kw = ranks.GRIDS[grid]
        mesh = jax_mesh(grid)
        if kw.get('zigzag'):
            # the JAX zigzag ring traces only on a mesh of the seq axis alone
            # (its zero carry is varying over seq only; ROADMAP queue 3)
            mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:kw['seq']]), ('seq',))
        fn = jattention.make_context_parallel_attention(
            mesh, 'seq', causal=causal, num_heads=4, zigzag=kw.get('zigzag', False),
        )
        @jax.jit
        def with_grads(q, k, v, dout, fn=fn):
            o, vjp = jax.vjp(fn, q, k, v)
            return (o, *vjp(dout))

        got = with_grads(*(jnp.asarray(qkv[n]) for n in ('q', 'k', 'v', 'dout')))
        out[name] = {n: np.asarray(t) for n, t in zip(('out', 'dq', 'dk', 'dv'), got)}
    return out


def jax_lm_steps():
    """Losses, last preconditioned grads and factor stacks of the JAX
    engine on ``train_mesh(0.5, model=2)`` (TP under a 1 x 2 KAISA grid),
    plain SGD at 0.1. The JAX engine's run is the same function of the
    global batch in every layout (its ring against the dense LM:
    ``tests/parallel/test_model_parallel.py``), so one reference holds
    every port layout; the JAX ring itself is held by the attention
    cases."""
    params, (tokens, targets) = flax_lm()
    mesh = jax_mesh('c-0.5')
    m = JaxLM(**ranks.LM_CFG)
    reg = kfac_tpu.register_model(m, jnp.asarray(tokens))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        dk = JaxDistributedKFAC(
            config=kfac_tpu.KFACPreconditioner(registry=reg, **ranks.STEP_KW), mesh=mesh
        )
    run = kfac_tpu.CurvatureCapture(reg).value_stats_and_grad(jax_lm_loss(m))

    @jax.jit
    def step(params, state, batch):
        (l, _), grads, stats = run(params, batch)
        state, pg = dk.step(state, grads, stats)
        return jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params, pg), state, l, pg

    ts = token_sharding(mesh)
    batch = (jax.device_put(jnp.asarray(tokens), ts), jax.device_put(jnp.asarray(targets), ts))
    p, state, values = jtp.shard_params(params, mesh), dk.init(), []
    for _ in range(ranks.STEPS):
        p, state, value, pg = step(p, state, batch)
        values.append(float(value))
    return dict(
        losses=values,
        grads={k: v.numpy() for k, v in convert.from_flax_params(jax.device_get(pg)).items()},
        state={f: {k: np.asarray(v) for k, v in getattr(state, f).items()} for f in ('a', 'g')},
    )


def run_world():
    generic, gparams, gbatch = flax_generic()
    lm_params, lm_batch = flax_lm()
    qkv, logits, targets = spec_arrays()
    spec = dict(
        qkv=qkv, logits=logits, targets=targets,
        generic=dict(
            weights={k: v.numpy() for k, v in convert.from_flax_params(gparams).items()},
            batch=gbatch,
        ),
        lm=dict(
            weights={k: v.numpy() for k, v in convert.from_flax_params(lm_params).items()},
            batch=lm_batch,
        ),
    )
    # the world's processes run while this one computes the JAX references
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = pool.submit(
            spawn_world, ranks.run_cases, WORLD, 'gloo', 'cpu', args=(spec,), timeout_s=300
        )
        ref = jax_references(generic, gparams, gbatch, qkv)
        out = pending.result()
    return spec, ref, out


def jax_references(generic, gparams, gbatch, qkv):
    reg = kfac_tpu.register_model(generic, jnp.asarray(gbatch[0]))

    def jloss(params, batch):
        xb, yb = batch
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(generic.apply({'params': params}, xb)) * yb, -1))

    (_, _), _, stats = jax.jit(kfac_tpu.CurvatureCapture(reg).value_stats_and_grad(jloss))(
        gparams, tuple(jnp.asarray(b) for b in gbatch)
    )
    return dict(
        attention=jax_attention(qkv),
        capture=dict(a={k: np.asarray(v) for k, v in stats.a.items()},
                     g={k: np.asarray(v) for k, v in stats.g.items()}),
        steps=jax_lm_steps(),
    )


@pytest.fixture(scope='module')
def world():
    """:func:`run_world` once per test run, shared across xdist workers
    under a file lock (as ``tests/test_torch_moe.py``'s world)."""
    uid = os.environ.get('PYTEST_XDIST_TESTRUNUID')
    if uid is None:
        return run_world()
    path = os.path.join(tempfile.gettempdir(), f'kfac_torch_model_parallel_{uid}.pkl')
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


def close(got, want, rtol, atol_rel, msg=''):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol, atol=atol_rel * float(np.abs(want).max()), err_msg=msg
    )


# ------------------------------------------------------------ rules (no world)


def jax_spec_as_port(spec, ndim):
    """A JAX PartitionSpec over ``model`` as the port's ShardSpec of the
    matching torch parameter (a dense kernel (in, out) is weight (out,
    in))."""
    axes = tuple(spec)
    if 'model' not in axes:
        return tp.REPLICATED
    dim = axes.index('model')
    return tp.ShardSpec(ndim - 1 - dim if ndim == 2 else dim)


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def port_specs_of_jax(jspecs, params):
    """The JAX spec tree as ``{port parameter name: ShardSpec}``."""
    specs = dict(_walk(jspecs))
    out = {}
    for path, arr in _walk(params):
        nested = np.asarray(arr)
        for k in reversed(path):
            nested = {k: nested}
        (name,) = convert.from_flax_params(nested)
        out[name] = jax_spec_as_port(specs[path], np.asarray(arr).ndim)
    return out


def test_param_specs_match_jax_rules_on_the_lm():
    params, _ = flax_lm()
    want = port_specs_of_jax(jtp.param_specs(params), params)
    model = TransformerLM(**ranks.LM_CFG, device='cpu')
    got = tp.param_specs(model)
    assert got == want
    assert got['block0.attn.q_proj.weight'] == tp.ShardSpec(0)
    assert got['block0.attn.out_proj.weight'] == tp.ShardSpec(1)
    assert got['block0.attn.out_proj.bias'] == tp.REPLICATED
    assert got['block0.mlp_up.bias'] == tp.ShardSpec(0)
    assert got['embed.weight'] == tp.REPLICATED
    assert got['lm_head.weight'] == tp.ShardSpec(0)


@pytest.mark.parametrize('overrides', [None, [('classify_out', 'replicated')]])
def test_derived_kinds_and_specs_match_jax_on_a_generic_net(overrides):
    generic, params, (x, _) = flax_generic()
    jreg = kfac_tpu.register_model(generic, jnp.asarray(x))
    model = ranks.GenericNet()
    reg = registry.register_model(model, device='cpu')
    assert tp.derive_layer_kinds(reg, overrides) == jtp.derive_layer_kinds(jreg, overrides)
    got = tp.registry_param_specs(model, reg, overrides, warn_unmatched=False)
    want = port_specs_of_jax(
        jtp.registry_param_specs(params, jreg, overrides, warn_unmatched=False), params
    )
    assert got == want


def test_unknown_kind_raises_as_jax():
    reg = registry.register_model(ranks.GenericNet(), device='cpu')
    with pytest.raises(ValueError, match='unknown parallel kind'):
        tp.derive_layer_kinds(reg, [('expander', 'diagonal')])


def test_registry_rules_warn_on_unmatched_params():
    class WithNorm(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.wide = torch.nn.Linear(16, 64)
            self.normalizer = torch.nn.LayerNorm(64)
            self.narrow = torch.nn.Linear(64, 8)

    model = WithNorm()
    reg = registry.register_model(model, device='cpu')
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        tp.registry_param_specs(model, reg)
    msgs = [str(w.message) for w in rec if issubclass(w.category, tp.UnshardedParamWarning)]
    assert msgs and 'normalizer' in msgs[0]


def test_zigzag_indices_match_jax():
    for seq_len, n in ((16, 2), (16, 4), (32, 4), (24, 3)):
        perm, inv = attention.zigzag_indices(seq_len, n)
        jperm, jinv = jattention.zigzag_indices(seq_len, n)
        np.testing.assert_array_equal(perm, jperm)
        np.testing.assert_array_equal(inv, jinv)
        per = seq_len // n
        for j in range(n):
            np.testing.assert_array_equal(
                mesh_lib.shard_positions(seq_len, n, j, zigzag=True).numpy(), perm[j * per:(j + 1) * per]
            )
    with pytest.raises(ValueError):
        attention.zigzag_indices(10, 4)


def test_schedules_keep_the_causal_skips():
    # the ring attends src <= my; zigzag 2n + 1 attends on every shard
    for n in (1, 2, 4):
        for my in range(n):
            ring = attention.ring_schedule(n, my, 8)
            assert [len(a) for a in ring.attends] == [int(s <= my) for s in ring.sources]
            zz = attention.zigzag_schedule(n, my, 8)
            assert sum(len(a) for a in zz.attends) == 2 * n + 1
            assert len(zz.attends[0]) == 3


def test_one_process_schedule_equals_dense_causal_attention():
    # the schedules driven from a list of every shard's K/V blocks: what
    # chip_smoke.py composes on one card
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 16, 2, 8, generator=g) for _ in range(3))
    dense = attention.dense_causal_attention(q, k, v)
    for n in (2, 4):
        for zigzag in (False, True):
            pos = [mesh_lib.shard_positions(16, n, j, zigzag) for j in range(n)]
            out = torch.empty_like(dense)
            for my in range(n):
                make = attention.zigzag_schedule if zigzag else attention.ring_schedule
                sched = make(n, my, 16 // n)
                out[:, pos[my]] = attention.run_schedule(
                    q[:, pos[my]].contiguous(), sched,
                    lambda i: (k[:, pos[sched.sources[i]]].contiguous(), v[:, pos[sched.sources[i]]].contiguous()),
                )
            close(out, dense, 1e-5, 1e-6, f'n={n} zigzag={zigzag}')


def test_train_mesh_needs_a_process_group_and_no_expert_axis():
    import inspect

    assert inspect.signature(mesh_lib.train_mesh).parameters['device'].default == 'cuda'
    with pytest.raises(RuntimeError, match='init_process_group'):
        mesh_lib.train_mesh(model=2, device='cpu')
    with pytest.raises(NotImplementedError, match='expert'):
        mesh_lib.train_mesh(expert=2, device='cpu')


# ----------------------------------------------------------------- the world


def test_rank_coordinates_follow_the_jax_mesh(world):
    _, _, out = world
    for name in ranks.GRIDS:
        devices = jax_mesh(name).devices
        for r in range(WORLD):
            want = tuple(int(i) for i in np.argwhere(devices == jax.devices()[r])[0])
            assert out[r]['coords'][name] == want, (name, r)
    assert all('not divisible' in out[r]['model3_error'] for r in range(WORLD))


@pytest.mark.parametrize('case', list(ranks.ATTENTION))
def test_ring_attention_matches_jax(world, case):
    _, ref, out = world
    want = ref['attention'][case]
    for key in ('out', 'dq', 'dk', 'dv'):
        got = np.zeros_like(want[key])
        for r in range(WORLD):
            o = out[r]['attention'][case]
            lo, hi = o['heads']
            got[:, o['positions'], lo:hi] = o[key]
        close(got, want[key], 1e-5, 1e-6, f'{case} {key}')


def test_vocab_parallel_nll_and_grads_match_jax(world):
    spec, _, out = world
    logits, targets = jnp.asarray(spec['logits']), jnp.asarray(spec['targets'])

    def mean_nll(lg):
        return jnp.mean(jlosses.vocab_parallel_nll(lg, targets))

    want_loss, want_grad = jax.value_and_grad(mean_nll)(logits)
    got = np.zeros_like(np.asarray(want_grad))
    for r in range(WORLD):
        o = out[r]['loss']
        np.testing.assert_allclose(o['loss'], float(want_loss), rtol=1e-6)
        got[:, o['vocab'][0]:o['vocab'][1]] = o['grad']
    close(got, want_grad, 1e-6, 1e-6)


def test_captured_factors_of_column_and_row_layers_match_the_jax_oracle(world):
    _, ref, out = world
    for r in range(WORLD):
        got = out[r]['capture']
        assert got['kinds'] == {'expander': 'column', 'contractor': 'row', 'classify_out': 'row'}
        for name in ('expander', 'contractor', 'classify_out'):
            np.testing.assert_allclose(got['a'][name], ref['capture']['a'][name], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got['g'][name], ref['capture']['g'][name], rtol=1e-4, atol=1e-6)


@functools.cache
def port_replicated_run():
    """The port's dense engine on the global batch: its own replicated run."""
    params, batch = flax_lm()
    model = TransformerLM(**ranks.LM_CFG, device='cpu')
    model.load_state_dict(ranks.tensors(
        {k: v.numpy() for k, v in convert.from_flax_params(params).items()}
    ))
    reg = registry.register_model(model, device='cpu')
    loss = lm_loss(model)
    trainer = Trainer(
        model, torch.optim.SGD(model.parameters(), lr=0.1), lambda ms, b: (loss(b), ms),
        kfac=KFACPreconditioner(reg, device='cpu', **ranks.STEP_KW), device='cpu',
    )
    batch = tuple(torch.from_numpy(np.array(b)).long() for b in batch)
    state, values = trainer.init(), []
    for _ in range(ranks.STEPS):
        state, value = trainer.step(state, batch)
        values.append(float(value))
    return dict(losses=values, grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()})


@pytest.mark.parametrize('layout', list(ranks.LAYOUTS))
@pytest.mark.parametrize('against', ['jax', 'port_replicated'])
def test_distributed_kfac_steps_match(world, layout, against):
    _, ref, out = world
    want = ref['steps'] if against == 'jax' else port_replicated_run()
    scale = max(float(np.abs(g).max()) for g in want['grads'].values())
    for r in range(WORLD):
        got = out[r]['steps'][layout]
        np.testing.assert_allclose(got['losses'], want['losses'], rtol=1e-5)
        assert set(got['grads']) == set(want['grads'])
        for n, g in want['grads'].items():
            np.testing.assert_allclose(got['grads'][n], g, rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=f'{layout} rank {r} {n}')


@pytest.mark.parametrize('layout', list(ranks.LAYOUTS))
def test_factor_stacks_match_jax(world, layout):
    _, ref, out = world
    want = ref['steps']['state']
    for r in range(WORLD):
        got = out[r]['steps'][layout]['state']
        for side in ('a', 'g'):
            assert set(got[side]) == set(want[side])
            for key, w in want[side].items():
                close(got[side][key], w, 1e-5, 1e-6, f'{layout} {side} {key}')


@pytest.mark.parametrize('layout', list(ranks.LAYOUTS))
def test_parameters_bitwise_where_replicated_and_the_layout_reported(world, layout):
    _, _, out = world
    runs = [out[r]['steps'][layout] for r in range(WORLD)]
    coords = [out[r]['coords'][layout] for r in range(WORLD)]
    sharded = set(runs[0]['sharded'])
    kw = ranks.LAYOUTS[layout]
    assert bool(sharded) == (kw.get('model', 1) > 1)
    for n, v in runs[0]['params'].items():
        for r in range(1, WORLD):
            if n not in sharded or coords[r][2:] == coords[0][2:]:
                np.testing.assert_array_equal(runs[r]['params'][n], v, err_msg=f'{n} rank {r}')
    mesh = jax_mesh(layout)
    topo = runs[0]['topology']
    assert topo['mesh_axes'] == list(mesh.axis_names)
    assert topo['mesh_shape'] == [int(s) for s in mesh.devices.shape]
    assert runs[0]['total_devices'] == WORLD
    assert runs[0]['world'] == WORLD // (kw.get('model', 1) * kw.get('seq', 1))


def test_tp_knobs_raise_on_a_model_or_seq_grid():
    # a stand-in grid of 4 ranks (no process group is touched before the check)
    from kfac_tpu_torch.parallel import DistributedKFAC

    class Grid:
        device = torch.device('cpu')
        grad_workers, n_cols, world_size, total_devices = 1, 1, 1, 4

    from kfac_tpu_torch import checkpoint
    from kfac_tpu_torch.health import HealthConfig

    reg = registry.register_model(torch.nn.Sequential(torch.nn.Linear(3, 2)), device='cpu')
    for kw in (dict(stat_compression='int8', allreduce_method='allreduce_bucketed'),
               dict(offload=True), dict(async_inverse='sliced'), dict(metrics=True),
               dict(health=HealthConfig()), dict(flight=True)):
        cfg = KFACPreconditioner(reg, device='cpu', inv_update_steps=2, factor_update_steps=2, **kw)
        with pytest.raises(NotImplementedError, match='model or seq'):
            DistributedKFAC(cfg, Grid())
    # a distributed engine's checkpoint on such a grid (the layout is all
    # the save reads before it refuses)
    engine = types.SimpleNamespace(a_store=[], total_devices=4, world=1)
    with pytest.raises(NotImplementedError, match='model or seq'):
        checkpoint.save(os.path.join(tempfile.mkdtemp(), 'ckpt'),
                        types.SimpleNamespace(inv_damping=0.0), engine=engine)
