"""The port's transport encoding against ``kfac_tpu/parallel/collectives.py``.

The cases of ``tests/parallel/test_collectives.py``: the triangle pack and
fill, the flat buffers, the byte-capped chunks and the host-side chunk
plan, each on the same inputs as the JAX functions. Values must be equal
exactly (packing moves values, it computes none); chunk boundaries and
plans must be the JAX package's. The collectives themselves run in
``tests/test_torch_kaisa.py``'s gloo worlds.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kfac_tpu.parallel import collectives as jcoll
from kfac_tpu_torch.parallel import collectives

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

JDT = {'f32': jnp.float32, 'bf16': jnp.bfloat16}
TDT = {'f32': torch.float32, 'bf16': torch.bfloat16}


def sym(n, seed=0):
    m = np.random.default_rng(seed).normal(size=(n, n)).astype(np.float32)
    return (m + m.T) / 2


@pytest.mark.parametrize('n', [1, 7, 33])
def test_triu_roundtrip_matches_jax(n):
    s = sym(n)
    packed = collectives.get_triu(torch.from_numpy(s))
    assert packed.shape == (n * (n + 1) // 2,)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jcoll.get_triu(jnp.asarray(s))))
    restored = collectives.fill_triu((n, n), packed)
    np.testing.assert_array_equal(
        restored.numpy(), np.asarray(jcoll.fill_triu((n, n), jnp.asarray(packed.numpy())))
    )
    np.testing.assert_array_equal(restored.numpy(), s)


def test_triu_rejects_nonsquare():
    with pytest.raises(ValueError):
        collectives.get_triu(torch.ones(3, 4))
    with pytest.raises(ValueError):
        jcoll.get_triu(jnp.ones((3, 4)))


@pytest.mark.parametrize('mixed', [False, True])
def test_concat_split_roundtrip_matches_jax(mixed):
    shapes = [(2, 3), (4,), (2, 2, 2)]
    dts = ['bf16', 'f32', 'f32'] if mixed else ['f32'] * 3
    arrays = [np.arange(np.prod(s), dtype=np.float32).reshape(s) + i for i, s in enumerate(shapes)]
    tensors = [torch.from_numpy(a).to(TDT[d]) for a, d in zip(arrays, dts)]
    flat, specs = collectives.concat_flat(tensors)
    jflat, jspecs = jcoll.concat_flat([jnp.asarray(a, JDT[d]) for a, d in zip(arrays, dts)])
    assert flat.shape == (6 + 4 + 8,) and flat.dtype == torch.float32
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat, np.float32))
    assert [(s, n) for s, n, _ in specs] == [(tuple(s), n) for s, n, _ in jspecs]
    back = collectives.split_flat(flat, specs)
    assert [b.dtype for b in back] == [t.dtype for t in tensors]
    for orig, rec in zip(tensors, back):
        assert torch.equal(orig, rec)


@pytest.mark.parametrize(
    'case', ['cap-200', 'oversized', 'uncapped', 'empty', 'promoted'],
)
def test_concat_flat_chunked_matches_jax(case):
    sizes, dts, cap = {
        'cap-200': ([25] * 4, ['f32'] * 4, 200),
        'oversized': ([10, 100, 10], ['f32'] * 3, 64),
        'uncapped': ([3, 4], ['f32'] * 2, None),
        'empty': ([], [], 128),
        'promoted': ([25, 25, 25], ['bf16', 'f32', 'bf16'], 180),
    }[case]
    arrays = [np.full((n,), i, np.float32) for i, n in enumerate(sizes)]
    tensors = [torch.from_numpy(a).to(TDT[d]) for a, d in zip(arrays, dts)]
    chunks = collectives.concat_flat_chunked(tensors, max_bytes=cap)
    jchunks = jcoll.concat_flat_chunked(
        [jnp.asarray(a, JDT[d]) for a, d in zip(arrays, dts)], max_bytes=cap
    )
    assert [c[0].numel() for c in chunks] == [int(c[0].size) for c in jchunks]
    back = collectives.split_flat_chunked(chunks)
    assert len(back) == len(tensors)
    for orig, rec in zip(tensors, back):
        assert rec.dtype == orig.dtype and torch.equal(orig, rec)
    specs = [(n, np.float32 if d == 'f32' else jnp.bfloat16) for n, d in zip(sizes, dts)]
    tspecs = [(n, TDT[d]) for n, d in zip(sizes, dts)]
    want = jcoll.plan_chunks(specs, max_bytes=cap)
    assert collectives.plan_chunks(tspecs, max_bytes=cap) == want
    assert [p['elements'] for p in want] == [c[0].numel() for c in chunks] if sizes else want == []


@given(
    sizes=st.lists(st.integers(1, 40), min_size=0, max_size=12),
    dtypes=st.lists(st.sampled_from(['f32', 'bf16']), min_size=12, max_size=12),
    cap=st.integers(16, 400),
)
@settings(max_examples=60, deadline=None)
def test_chunked_packing_properties_match_jax(sizes, dtypes, cap):
    """For any tensor list and byte cap: the JAX package's chunk
    boundaries and plan, values, dtypes and order kept, every multi-tensor
    chunk within the cap at the promoted dtype."""
    tensors = [
        torch.arange(n, dtype=torch.float32).to(TDT[d]) for n, d in zip(sizes, dtypes)
    ]
    chunks = collectives.concat_flat_chunked(tensors, max_bytes=cap)
    jchunks = jcoll.concat_flat_chunked(
        [jnp.arange(n, dtype=jnp.float32).astype(JDT[d]) for n, d in zip(sizes, dtypes)],
        max_bytes=cap,
    )
    assert [c[0].numel() for c in chunks] == [int(c[0].size) for c in jchunks]
    plan = collectives.plan_chunks([(n, TDT[d]) for n, d in zip(sizes, dtypes)], max_bytes=cap)
    jplan = jcoll.plan_chunks(
        [(n, np.float32 if d == 'f32' else jnp.bfloat16) for n, d in zip(sizes, dtypes)],
        max_bytes=cap,
    )
    assert plan == jplan
    back = collectives.split_flat_chunked(chunks)
    assert len(back) == len(tensors)
    for orig, rec in zip(tensors, back):
        assert rec.dtype == orig.dtype and torch.equal(orig, rec)
    for flat, specs in chunks:
        if len(specs) > 1:
            assert flat.numel() * flat.element_size() <= cap
