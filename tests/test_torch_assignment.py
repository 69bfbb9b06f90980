"""The port's KAISA assignment against ``kfac_tpu/assignment.py``.

Each function of ``kfac_tpu_torch/assignment.py`` runs on the inputs of
the cases of ``tests/test_assignment.py`` beside the JAX package's, and
must return the same values (exact: both are pure Python) and raise where
it raises; the properties those cases assert are held on the port's
results.
"""

import random

import pytest

from kfac_tpu import assignment as jassignment
from kfac_tpu import enums as jenums
from kfac_tpu_torch import assignment, enums


def work(n_layers, base=10.0):
    return {
        f'layer{i}': {'A': base * (i + 1), 'G': base * (i + 1) / 2}
        for i in range(n_layers)
    }


def random_work(seed=0, n=40):
    rng = random.Random(seed)
    return {
        f'l{i}': {'A': float(rng.randint(1, 100)) ** 3, 'G': float(rng.randint(1, 100)) ** 3}
        for i in range(n)
    }


def same_outcome(fn, jfn, *args, **kwargs):
    """Both functions' results, or both raise ValueError."""
    try:
        want = jfn(*args, **kwargs)
    except ValueError:
        with pytest.raises(ValueError):
            fn(*args, **kwargs)
        return None
    got = fn(*args, **kwargs)
    return got, want


@pytest.mark.parametrize('world,workers', [(8, 2), (8, 8), (8, 1), (4, 2), (12, 3), (8, 3)])
def test_grid_partitions_match_jax(world, workers):
    for name in ('partition_grad_workers', 'partition_grad_receivers'):
        out = same_outcome(getattr(assignment, name), getattr(jassignment, name), world, workers)
        if out is None:
            assert world % workers  # (8, 3) raises on both sides
            continue
        got, want = out
        assert got == want
    if world % workers == 0:
        cols = assignment.partition_grad_workers(world, workers)
        rows = assignment.partition_grad_receivers(world, workers)
        assert sorted(d for c in cols for d in c) == list(range(world))
        for r in rows:
            for c in cols:
                assert len(set(r) & set(c)) == 1


def test_grid_example_from_kaisa_paper():
    assert assignment.partition_grad_workers(8, 2) == [(0, 4), (1, 5), (2, 6), (3, 7)]
    assert assignment.partition_grad_receivers(8, 2) == [(0, 1, 2, 3), (4, 5, 6, 7)]


@pytest.mark.parametrize(
    'world,frac',
    [(8, 1.0), (8, 0.0), (8, 1 / 8), (8, 0.5), (8, 0.25), (1, 1.0), (8, 0.3), (8, -0.1),
     (8, 1.1), (8, 0.75), (8, 0.05), (0, 1.0)],
)
def test_fraction_validation_and_strategy_match_jax(world, frac):
    out = same_outcome(assignment.grad_worker_count, jassignment.grad_worker_count, world, frac)
    if out is not None:
        assert out[0] == out[1]
        got = assignment.strategy_for_fraction(world, frac)
        want = jassignment.strategy_for_fraction(world, frac)
        assert isinstance(got, enums.DistributedStrategy)
        assert got.name == want.name and got.value == want.value


@pytest.mark.parametrize('world', [1, 2, 4, 6, 8, 12])
def test_candidate_fractions_match_jax(world):
    assert assignment.candidate_fractions(world) == jassignment.candidate_fractions(world)


def test_enums_match_jax():
    for name in ('AllreduceMethod', 'AssignmentStrategy', 'ComputeMethod', 'DistributedStrategy'):
        assert {m.name: m.value for m in getattr(enums, name)} == {
            m.name: m.value for m in getattr(jenums, name)
        }


@pytest.mark.parametrize(
    'case',
    ['uniform', 'colocated', 'spread', 'group-constraint', 'deterministic', 'random'],
)
def test_greedy_assign_matches_jax(case):
    args = {
        'uniform': ({f'l{i}': {'A': 1.0, 'G': 1.0} for i in range(16)}, [tuple(range(4))], 4, True),
        'colocated': (work(6), [tuple(range(4))], 4, True),
        'spread': ({'big': {'A': 100.0, 'G': 100.0}}, [(0, 1)], 2, False),
        'group-constraint': (work(8), [(0, 2), (1, 3)], 4, False),
        'deterministic': (work(10), [(0, 1), (2, 3)], 4, True),
        'random': (random_work(), [(0, 4), (1, 5), (2, 6), (3, 7)], 8, False),
    }[case]
    got = assignment.greedy_assign(*args)
    assert got == jassignment.greedy_assign(*args)
    assert got == assignment.greedy_assign(*args)
    if case == 'uniform':
        loads = [0.0] * 4
        for layer, fs in got.items():
            for f, d in fs.items():
                loads[d] += args[0][layer][f]
        assert max(loads) == min(loads)
    if case == 'colocated':
        assert all(fs['A'] == fs['G'] for fs in got.values())
    if case == 'spread':
        assert {got['big']['A'], got['big']['G']} == {0, 1}
    if case == 'group-constraint':
        for fs in got.values():
            devs = set(fs.values())
            assert devs <= {0, 2} or devs <= {1, 3}


@pytest.mark.parametrize(
    'world,frac,colocate',
    [(8, 1.0, True), (8, 0.5, True), (8, 0.25, False), (8, 1 / 8, True), (4, 0.5, True),
     (1, 1.0, True), (4, 0.0, True), (4, 0.0, False), (8, 0.5, False)],
)
def test_kaisa_assignment_queries_match_jax(world, frac, colocate):
    w = random_work(1, 9) if not colocate else work(7)
    kw = dict(world_size=world, grad_worker_fraction=frac, colocate_factors=colocate)
    out = same_outcome(assignment.KAISAAssignment, jassignment.KAISAAssignment, w, **kw)
    if out is None:
        assert frac == 0.0 and not colocate  # MEM-OPT requires colocation
        return
    kaisa, jkaisa = out
    assert kaisa.mesh_shape() == jkaisa.mesh_shape()
    assert kaisa.strategy.name == jkaisa.strategy.name
    assert kaisa.broadcast_gradients() == jkaisa.broadcast_gradients()
    assert kaisa.broadcast_inverses() == jkaisa.broadcast_inverses()
    assert kaisa.get_layers() == jkaisa.get_layers()
    for layer in kaisa.get_layers():
        assert kaisa.get_factors(layer) == jkaisa.get_factors(layer)
        assert kaisa.grad_worker_group(layer) == jkaisa.grad_worker_group(layer)
        for factor in kaisa.get_factors(layer):
            assert kaisa.inv_worker(layer, factor) == jkaisa.inv_worker(layer, factor)
            assert kaisa.factor_group(layer, factor) == jkaisa.factor_group(layer, factor)
            assert kaisa.inv_worker(layer, factor) in kaisa.grad_worker_group(layer)
        for dev in range(world):
            assert kaisa.device_coords(dev) == jkaisa.device_coords(dev)
            assert kaisa.is_grad_worker(dev, layer) == jkaisa.is_grad_worker(dev, layer)
            assert kaisa.src_grad_worker(dev, layer) == jkaisa.src_grad_worker(dev, layer)
            assert kaisa.grad_receiver_group(dev, layer) == jkaisa.grad_receiver_group(dev, layer)


def test_greedy_balance_quality():
    w = random_work()
    kaisa = assignment.KAISAAssignment(w, world_size=8, grad_worker_fraction=0.5)
    loads = [0.0] * 8
    for layer in kaisa.get_layers():
        for f in kaisa.get_factors(layer):
            loads[kaisa.inv_worker(layer, f)] += w[layer][f]
    assert max(loads) < 2.0 * sum(loads) / len(loads)


@pytest.mark.parametrize('strategy', ['COMPUTE', 'MEMORY'])
def test_compute_work_costs_match_jax(strategy):
    class H:
        a_factor_shape = (10, 10)
        g_factor_shape = (4, 4)

    got = assignment.compute_work_costs({'l': H()}, enums.AssignmentStrategy[strategy])
    want = jassignment.compute_work_costs({'l': H()}, jenums.AssignmentStrategy[strategy])
    assert got == want == {
        'COMPUTE': {'l': {'A': 1000.0, 'G': 64.0}}, 'MEMORY': {'l': {'A': 100.0, 'G': 16.0}},
    }[strategy]
