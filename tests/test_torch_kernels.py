"""The port's hand-written kernels against their plain versions on the card.

Marked ``cuda``: each test skips without a CUDA device (the kernels have
no CPU mode). This file imports neither JAX nor the JAX package, so it
runs on a machine with only PyTorch; there, run it without the JAX test
configuration::

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

Tolerances, the same as ``chip_smoke.py``'s, which also checks that each
one rejects the plain version at reduced precision (TF32 or bf16): the
covariance within 1e-5 x max|C| (8192-row f32 sums in another order),
exactly symmetric and identical from run to run (also unscaled, on
expert parallelism's received buffers and the pipeline's microbatch
rows); the covariance blended
into a symmetric running factor within 1e-5 x max|coeff a^T a| (the blend
scales the product's error by coeff, so the product is the reference) and
exactly symmetric; the kl-clip dot within 1e-7 x sum|p*g| and identical
from run to run, and grouped over layers within 1e-7 x sum of lr^2 sum|p*g|,
its scale bitwise the plain expression over its own terms, and with its
norm epilogue each sum(g*g) and sum(p*p) within 1e-6 of itself (against
f64), the dot's outputs bitwise those without norms; the kl-clip
scale bitwise equal to the plain version; the
attention partials within 1e-5 x max|x| of each output; the Newton-Schulz
step within 3e-5 x max of x_new and of mx_new and 3e-5 of the residual,
every output identical from run to run.
"""

import os

import pytest
import torch

from kfac_tpu_torch.ops import cov_ema, factors, flash_attention, klclip
from kfac_tpu_torch.ops import newton_schulz as ns_lib
from kfac_tpu_torch.ops import sym_cov as sym_cov_lib

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


# split (d ~ 512: pairs < SMs) and unsplit (d ~ 2048) plans, ragged N and D,
# N under one 32-row slab, the 16-byte copies (d % 4 == 0) and the 4-byte ones
@pytest.mark.cuda
@pytest.mark.parametrize(
    'shape',
    [(8192, 513), (1000, 70), (77, 2049), (8192, 512), (4096, 2048), (5, 130),
     (31, 2049), (77, 130), (300, 64), (1, 1)],
)
def test_sym_cov_kernel_matches_plain_on_card(cuda_device, shape):
    g = torch.Generator(cuda_device).manual_seed(0)
    a = torch.randn(shape, generator=g, device=cuda_device)
    got = sym_cov_lib.sym_cov(a)
    want = sym_cov_lib.sym_cov_plain(a)
    assert torch.equal(got, got.T)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(got, sym_cov_lib.sym_cov(a))  # no atomics: repeatable


# expert parallelism's received buffers (an expert's slots from every
# peer, the empty ones zero, the bias column one on live slots only, the
# sum unscaled) and the routers' G; the pipeline's microbatch rows
@pytest.mark.cuda
@pytest.mark.parametrize(
    'shape,live',
    [((2560, 512), 0.6), ((8192, 2048), 0.25), ((4096, 512), 0.5), ((1024, 513), 1.0),
     ((1024, 2049), 1.0), ((1024, 512), 1.0), ((1024, 2048), 1.0), ((2048, 4), 1.0),
     ((4096, 4), 1.0)],
)
def test_sym_cov_at_the_ep_and_pipeline_shapes_on_card(cuda_device, shape, live):
    from kfac_tpu_torch.ops import cov

    g = torch.Generator(cuda_device).manual_seed(1)
    a = torch.randn(shape, generator=g, device=cuda_device)
    if live < 1.0:
        used = (torch.arange(shape[0], device=cuda_device) < live * shape[0]).float()[:, None]
        a = cov.with_column(a * used, used)
    got = cov.get_cov(a, scale=1.0)
    want = sym_cov_lib.sym_cov_plain(a.contiguous(), 1.0)
    assert torch.equal(got, got.T)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


# the pipeline's running sum of a stage's microbatch covariances: the
# first by sym_cov, each later one added by sym_cov_ema at beta 1; 1024 rows
# at pipe 2 x dp 2, 2048 at dp 1
@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(1024, 513), (1024, 2049), (1024, 512), (1024, 2048),
                                   (2048, 513), (2048, 2049), (2048, 512), (2048, 2048)])
def test_microbatch_covariance_sums_on_card(cuda_device, shape):
    from kfac_tpu_torch.ops import cov

    g = torch.Generator(cuda_device).manual_seed(2)
    parts = [torch.randn(shape, generator=g, device=cuda_device) for _ in range(4)]
    acc = None
    for a in parts:
        acc = cov.add_cov(acc, a)
    want = sum(sym_cov_lib.sym_cov_plain(a) for a in parts)
    assert torch.equal(acc, acc.T)
    assert (acc - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(8192, 513), (512, 256), (77, 130), (1000, 70)])
def test_sym_cov_ema_kernel_matches_plain_on_card(cuda_device, shape):
    g = torch.Generator(cuda_device).manual_seed(4)
    a = torch.randn(shape, generator=g, device=cuda_device)
    f = sym_cov_lib.sym_cov_plain(torch.randn(shape, generator=g, device=cuda_device))
    n = shape[0]
    beta, coeff = 0.95, 0.05 / n
    before = cov_ema.sym_cov_ema.launches
    got = cov_ema.sym_cov_ema(f, a, beta, coeff)
    assert cov_ema.sym_cov_ema.launches == before + 1
    want = cov_ema.sym_cov_ema_plain(f, a, beta, coeff)
    assert torch.equal(got, got.T)
    assert (got - want).abs().max() <= 1e-5 * (coeff * (a.T @ a)).abs().max()
    cold = cov_ema.fused_cov_ema(None, a, beta)
    assert (cold - cov_ema.sym_cov_ema_plain(torch.eye(shape[1], device=cuda_device), a, beta, coeff)
            ).abs().max() <= 1e-5 * (coeff * (a.T @ a)).abs().max()


def test_flash_kernel_raises_for_a_head_dim_it_was_not_built_for():
    # checked before the device, so this runs without a card
    q = torch.zeros(1, 4, 1, 48, device='meta')
    with pytest.raises(ValueError, match='head dims'):
        flash_attention._flash_partials_kernel(q, q, q, 0, 0, True)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16], ids=['bf16', 'f16'])
def test_flash_16_bit_forms_raise_at_head_dim_16(dtype):
    # head dim 16 runs in f32 only; checked before the device
    q = torch.zeros(1, 4, 1, 16, device='meta', dtype=dtype)
    with pytest.raises(ValueError, match='float32 only'):
        flash_attention._flash_partials_kernel(q, q, q, 0, 0, True)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(512, 513), (37, 129), (3, 5)])
def test_klclip_kernels_match_plain_on_card(cuda_device, shape):
    g = torch.Generator(cuda_device).manual_seed(1)
    p = torch.randn(shape, generator=g, device=cuda_device)
    q = torch.randn(shape, generator=g, device=cuda_device)
    got = klclip.klclip_dot(p, q)
    assert torch.equal(got, klclip.klclip_dot(p, q))  # no atomics: repeatable
    assert abs(float(got - klclip.klclip_dot_plain(p, q))) <= 1e-7 * float((p * q).abs().sum())
    s = torch.tensor(0.3, device=cuda_device)
    assert torch.equal(klclip.klclip_scale(p, s), klclip.klclip_scale_plain(p, s))


@pytest.mark.cuda
def test_sym_cov_kernel_with_each_split_matches_plain_on_card(cuda_device):
    # one shape through splits from 1 to one slice per slab
    g = torch.Generator(cuda_device).manual_seed(5)
    a = torch.randn(200, 130, generator=g, device=cuda_device)
    want = sym_cov_lib.sym_cov_plain(a, 3.0)
    for slabs_per_split in (1, 2, 3, 4, 7):  # 200 rows are 7 slabs
        splits = -(-7 // slabs_per_split)
        p = sym_cov_lib.CovPlan(200, 130, splits, slabs_per_split * 32)
        got = torch.empty(130, 130, device=cuda_device)
        sym_cov_lib.launch(a, got, 3.0, p)
        assert torch.equal(got, got.T)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), splits


@pytest.mark.cuda
def test_sym_cov_ema_kernel_with_each_split_matches_plain_on_card(cuda_device):
    # one shape through splits from 1 to one slice per slab: the blend in
    # the main kernel's epilogue (1 slice) and in the reduce pass (more)
    g = torch.Generator(cuda_device).manual_seed(7)
    a = torch.randn(200, 130, generator=g, device=cuda_device)
    f = sym_cov_lib.sym_cov_plain(torch.randn(200, 130, generator=g, device=cuda_device))
    beta, coeff = 0.95, 0.05 / 200
    want = cov_ema.sym_cov_ema_plain(f, a, beta, coeff)
    tol = 1e-5 * (coeff * (a.T @ a)).abs().max()
    for slabs_per_split in (1, 2, 3, 4, 7):  # 200 rows are 7 slabs
        splits = -(-7 // slabs_per_split)
        p = sym_cov_lib.CovPlan(200, 130, splits, slabs_per_split * 32)
        got, again = (torch.empty(130, 130, device=cuda_device) for _ in range(2))
        cov_ema.launch(f, a, got, beta, coeff, p)
        cov_ema.launch(f, a, again, beta, coeff, p)
        assert torch.equal(got, got.T), splits
        assert torch.equal(got, again), splits  # no atomics: repeatable
        assert (got - want).abs().max() <= tol, splits


def scale_cases(device):
    """Tensors of numel 0 and 1, 2, 3 (mod 4), contiguous views that start
    off a 16-byte boundary, and 100 tensors (more than one launch's table)."""
    g = torch.Generator(device).manual_seed(6)
    base = torch.randn(40_000, generator=g, device=device)
    ragged = [
        torch.randn(s, generator=g, device=device) for s in ((37, 129), (5,), (3, 2), (4097,))
    ]
    views = [base[1:1 + 4099], base[2:2 + 8194].view(2, 4097), base[3:3 + 17]]
    many = [torch.randn(i % 7 * 600 + 1, generator=g, device=device) for i in range(100)]
    return {
        'ragged': ragged + [torch.empty(0, device=device)] + views,
        'single': [torch.randn(512, 513, generator=g, device=device)],
        'many': many,
    }


def offset_copy(p):
    """A copy of ``p`` at ``p``'s offset from a 16-byte boundary."""
    off = p.data_ptr() % 16 // 4
    return torch.empty(p.numel() + off, device=p.device)[off:].view(p.shape).copy_(p)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['ragged', 'single', 'many'])
def test_klclip_scale_many_is_bitwise_plain_on_card(cuda_device, case):
    ps = scale_cases(cuda_device)[case]
    s = torch.tensor(0.37, device=cuda_device)
    want = klclip.klclip_scale_many_plain(ps, s)
    before = klclip.klclip_scale.launches
    got = klclip.klclip_scale_many(ps, s)
    nonempty = sum(p.numel() > 0 for p in ps)
    assert klclip.klclip_scale.launches == before + -(-nonempty // klclip.TABLE_CAPACITY)
    for x, w in zip(got, want):
        assert torch.equal(x, w)
    # in place, as the engine calls it: the views keep their offsets
    copies = [offset_copy(p) for p in ps]
    same = klclip.klclip_scale_many(copies, s, in_place=True)
    for x, c, w in zip(same, copies, want):
        assert x is c and torch.equal(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize(
    'q_off,k_off,s,d',
    [(0, 0, 512, 128), (64, 0, 100, 128), (0, 256, 128, 128), (16, 0, 192, 128),
     (0, 0, 128, 32), (16, 0, 100, 32), (0, 0, 256, 256), (48, 0, 100, 256),
     (0, 128, 96, 256), (0, 0, 64, 16), (16, 0, 100, 16), (0, 64, 128, 16),
     (0, 0, 512, 64), (64, 0, 100, 64), (0, 256, 128, 64)],
)
def test_flash_kernel_matches_plain_on_card(cuda_device, q_off, k_off, s, d):
    g = torch.Generator(cuda_device).manual_seed(2)
    q, k, v = (torch.randn(2, s, 4, d, generator=g, device=cuda_device) for _ in range(3))
    got = flash_attention.flash_attention_partials(q, k, v, q_off, k_off, True)
    want = flash_attention.attend_partials_einsum(q, k, v, q_off, k_off, True)
    for x, w in zip(got, want):
        assert (x - w).abs().max() <= 1e-5 * w.abs().max().clamp(max=1e6) + 1e-6


@pytest.mark.cuda
def test_flash_kernel_raises_for_a_tensor_off_a_16_byte_boundary(cuda_device):
    # the kernel stages rows by 16-byte copies
    q = torch.zeros(2 * 64 * 4 * 128 + 1, device=cuda_device)[1:].view(2, 64, 4, 128)
    k = torch.zeros(2, 64, 4, 128, device=cuda_device)
    with pytest.raises(ValueError, match='16-byte'):
        flash_attention.flash_attention_partials(q, k, k, 0, 0, True)


@pytest.mark.cuda
@pytest.mark.parametrize('d', [513, 512, 130, 2049, 7])
def test_ns_kernel_matches_plain_on_card(cuda_device, d):
    # as the solver meets it: a damped factor, the Gershgorin start and two
    # plain iterations. A square `a` keeps the residual far from the f32
    # floor, where a relative tolerance on it would compare rounding noise.
    g = torch.Generator(cuda_device).manual_seed(3)
    a = torch.randn(d, d, generator=g, device=cuda_device)
    eye = torch.eye(d, device=cuda_device)
    m = a.T @ a / d + 0.003 * eye
    lam_max = m.abs().sum(-1).max()
    x, mx = eye / lam_max, m / lam_max
    for _ in range(2):
        x, mx, _ = ns_lib.fused_ns_step_plain(m, x, mx)
    before = ns_lib.fused_ns_step.launches
    got = ns_lib.fused_ns_step(m, x, mx)
    assert ns_lib.fused_ns_step.launches == before + 1
    want = ns_lib.fused_ns_step_plain(m, x, mx)
    for o, w in zip(got[:2], want[:2]):
        assert (o - w).abs().max() <= 3e-5 * w.abs().max()
    assert abs(float(got[2]) - float(want[2])) <= 3e-5 * float(want[2])
    again = ns_lib.fused_ns_step(m, x, mx)  # no atomics: repeatable
    assert all(torch.equal(o, p) for o, p in zip(got, again))


FLAGSHIP_PMATS = [(512, 513)] * 24 + [(2048, 513)] * 6 + [(512, 2049)] * 6


def grouped_dot_cases(device):
    """(ps, gs) lists: the flagship's 36 layers; g views 1-3 floats off a
    16-byte boundary and empty tensors; 100 pairs (two launches); the
    digits MLP's 2 layers."""
    g = torch.Generator(device).manual_seed(8)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    base = randn(40_000)
    ragged = [(37, 129), (0,), (4099,), (4099,), (4099,), (5,), (0, 3)]
    views = {2: base[1:1 + 4099], 3: base[2:2 + 4099], 4: base[3:3 + 4099]}
    return {
        'flagship': ([randn(*s) for s in FLAGSHIP_PMATS], [randn(*s) for s in FLAGSHIP_PMATS]),
        'offsets': ([randn(*s) for s in ragged],
                    [views[i] if i in views else randn(*s) for i, s in enumerate(ragged)]),
        'many': ([randn(i % 7 * 600 + 1) for i in range(100)],
                 [randn(i % 7 * 600 + 1) for i in range(100)]),
        'digits': ([randn(64, 65), randn(10, 65)], [randn(64, 65), randn(10, 65)]),
    }


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['flagship', 'offsets', 'many', 'digits'])
def test_klclip_dot_many_matches_plain_on_card(cuda_device, case):
    ps, gs = grouped_dot_cases(cuda_device)[case]
    lr, kl_clip = 0.1, 0.001
    before = klclip.klclip_dot.launches
    terms, vg, scale = klclip.klclip_dot_many(ps, gs, lr, kl_clip)
    assert klclip.klclip_dot.launches == before + -(-len(ps) // klclip.TABLE_CAPACITY)
    want_terms, want_vg, _ = klclip.klclip_dot_many_plain(ps, gs, lr, kl_clip)
    tol = 1e-7 * sum(float((p * g).abs().sum()) * lr ** 2 for p, g in zip(ps, gs))
    assert abs(float(vg - want_vg)) <= tol
    assert float((terms - want_terms).abs().max()) <= tol
    # the fold and the scale are the plain expressions over the kernel's terms
    vg_fold = sum(terms.unbind())
    assert torch.equal(vg, vg_fold)
    assert torch.equal(scale, factors.kl_clip_scale(vg_fold, kl_clip))
    again = klclip.klclip_dot_many(ps, gs, lr, kl_clip)  # no atomics: repeatable
    assert all(torch.equal(x, y) for x, y in zip((terms, vg, scale), again))


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['flagship', 'offsets', 'many', 'digits'])
def test_klclip_dot_norms_many_matches_plain_on_card(cuda_device, case):
    ps, gs = grouped_dot_cases(cuda_device)[case]
    lr, kl_clip = 0.1, 0.001
    before, dot_before = klclip.klclip_dot_norms_many.launches, klclip.klclip_dot.launches
    got = klclip.klclip_dot_norms_many(ps, gs, lr, kl_clip)
    assert klclip.klclip_dot_norms_many.launches == before + -(-len(ps) // klclip.TABLE_CAPACITY)
    assert klclip.klclip_dot.launches == dot_before
    # the dot's arithmetic is the instantiation's without norms, bit for bit
    for x, y in zip(got[:3], klclip.klclip_dot_many(ps, gs, lr, kl_clip)):
        assert torch.equal(x, y)
    g_sq, p_sq = got[3:]
    assert g_sq.shape == p_sq.shape == (len(ps),)
    for t, (p, g) in enumerate(zip(ps, gs)):
        for v, x in ((g_sq[t], g), (p_sq[t], p)):
            ref = float(torch.sum(x.double() ** 2))
            assert abs(float(v) - ref) <= 1e-6 * ref
    again = klclip.klclip_dot_norms_many(ps, gs, lr, kl_clip)  # no atomics: repeatable
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['zeros', 'binding', 'nan'])
def test_klclip_dot_many_scale_edges_on_card(cuda_device, kind):
    g = torch.Generator(cuda_device).manual_seed(9)
    ps = [torch.randn(40, 70, generator=g, device=cuda_device) for _ in range(3)]
    gs = [torch.randn(40, 70, generator=g, device=cuda_device) for _ in range(3)]
    kl_clip = 1e-9 if kind == 'binding' else 0.001
    if kind == 'zeros':
        gs = [torch.zeros_like(p) for p in ps]
    if kind == 'nan':
        ps[1][3, 5] = float('nan')
    terms, vg, scale = klclip.klclip_dot_many(ps, gs, 0.1, kl_clip)
    want = factors.kl_clip_scale(sum(terms.unbind()), kl_clip)
    if kind == 'nan':
        assert torch.isnan(vg) and torch.isnan(scale) and torch.isnan(want)
        return
    assert torch.equal(scale, want)
    if kind == 'zeros':
        assert float(vg) == 0.0 and float(scale) == 1.0
    else:
        assert 0.0 < float(scale) < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize('tile', [(128, 128), (128, 144), (64, 32)])
@pytest.mark.parametrize('d', [1, 7, 63, 129, 512, 513, 2048, 2049])
def test_ns_kernel_each_tile_matches_plain_on_card(cuda_device, monkeypatch, d, tile):
    # both built tiles at every width, whatever the plan would pick
    monkeypatch.setattr(ns_lib, 'plan', lambda d, sms: tile)
    g = torch.Generator(cuda_device).manual_seed(10)
    a = torch.randn(d, d, generator=g, device=cuda_device)
    eye = torch.eye(d, device=cuda_device)
    m = a.T @ a / d + 0.003 * eye
    lam_max = m.abs().sum(-1).max()
    x, mx = eye / lam_max, m / lam_max
    for _ in range(2):
        x, mx, _ = ns_lib.fused_ns_step_plain(m, x, mx)
    got = ns_lib.fused_ns_step(m, x, mx)
    want = ns_lib.fused_ns_step_plain(m, x, mx)
    for o, w in zip(got[:2], want[:2]):
        assert (o - w).abs().max() <= 3e-5 * w.abs().max()
    # at d = 1 the Gershgorin start is the inverse itself, so the residual
    # is f32 rounding: held to 1e-6 absolute there
    assert abs(float(got[2]) - float(want[2])) <= max(3e-5 * float(want[2]), 1e-6 * (d == 1))
    again = ns_lib.fused_ns_step(m, x, mx)  # no atomics: repeatable
    assert all(torch.equal(o, p) for o, p in zip(got, again))


@pytest.mark.cuda
def test_async_checkpoint_snapshot_precedes_in_place_updates_on_card(cuda_device, tmp_path):
    """``checkpoint.save(wait=False)`` enqueues its device-to-host copies on
    the current stream: an in-place update enqueued right after the call
    runs after them, so the files hold the values of the call."""
    import os
    from types import SimpleNamespace

    from kfac_tpu_torch import checkpoint

    g = torch.Generator(cuda_device).manual_seed(3)
    x = torch.randn(4096, 4096, generator=g, device=cuda_device)  # 64 MiB
    before = x.cpu()
    state = SimpleNamespace(step=3, a={'l': x}, g={'l': x[:64, :64]}, health=None)
    path = str(tmp_path / 'ck')
    handle = checkpoint.save(path, state, extra={'w': x}, wait=False)
    for _ in range(4):
        x.mul_(2.0)
    handle.wait_until_finished()
    payload = torch.load(os.path.join(path, checkpoint.PAYLOAD), weights_only=True)
    assert torch.equal(payload['w'], before)
    assert torch.equal(payload['kfac']['a']['l'], before)
    assert torch.equal(payload['kfac']['g']['l'], before[:64, :64])
    assert payload['kfac']['step'] == 3


def ns_stack(device, slots, d, seed):
    """(m, x, mx) of a stack as the stacked solver meets it: damped
    factors, the Gershgorin starts and two plain iterations."""
    g = torch.Generator(device).manual_seed(seed)
    a = torch.randn(slots, d, d, generator=g, device=device)
    eye = torch.eye(d, device=device)
    m = a.mT @ a / d + 0.003 * eye
    lam_max = m.abs().sum(-1).amax(-1)[:, None, None]
    x, mx = eye / lam_max, m / lam_max
    for _ in range(2):
        x, mx, _ = ns_lib.fused_ns_step_plain(m, x, mx)
    return m.contiguous(), x.contiguous(), mx.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize('slots,d', [(8, 513), (2, 2049), (8, 512), (3, 7), (5, 130)])
def test_ns_stacked_kernel_matches_plain_on_card(cuda_device, slots, d):
    # each slot within 3e-5 x max of its x_new and mx_new and 3e-5 of its
    # residual; one launch for the stack; repeatable bit for bit
    m, x, mx = ns_stack(cuda_device, slots, d, 11)
    before = ns_lib.fused_ns_step_stacked.launches
    got = ns_lib.fused_ns_step_stacked(m, x, mx)
    assert ns_lib.fused_ns_step_stacked.launches == before + 1
    want = ns_lib.fused_ns_step_plain(m, x, mx)
    for i in range(slots):
        for o, w in zip(got[:2], want[:2]):
            assert (o[i] - w[i]).abs().max() <= 3e-5 * w[i].abs().max()
        assert abs(float(got[2][i]) - float(want[2][i])) <= 3e-5 * float(want[2][i])
    again = ns_lib.fused_ns_step_stacked(m, x, mx)
    assert all(torch.equal(o, p) for o, p in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize('tile', [(128, 128), (128, 144), (64, 32)])
@pytest.mark.parametrize('d', [129, 513])
def test_ns_stacked_kernel_is_the_2d_launch_slot_by_slot_on_card(cuda_device, d, tile):
    # at one tile, each slot of the stack bitwise the 2-D launch on it
    m, x, mx = ns_stack(cuda_device, 3, d, 12)
    got = ns_lib.fused_ns_step_stacked(m, x, mx, tile=tile)
    for i in range(3):
        one = ns_lib.fused_ns_step(m[i].contiguous(), x[i].contiguous(), mx[i].contiguous(), tile=tile)
        assert torch.equal(got[0][i], one[0]) and torch.equal(got[1][i], one[1])
        assert torch.equal(got[2][i], one[2])


@pytest.mark.cuda
def test_ns_stacked_kernel_skips_inactive_slots_on_card(cuda_device):
    # the active slots bitwise the all-active launch's; the others' CTAs
    # return at once (their outputs are the caller's to keep)
    m, x, mx = ns_stack(cuda_device, 4, 130, 13)
    full = ns_lib.fused_ns_step_stacked(m, x, mx)
    active = torch.tensor([True, False, True, False], device=cuda_device)
    part = ns_lib.fused_ns_step_stacked(m, x, mx, active)
    for i in (0, 2):
        assert all(torch.equal(p[i], f[i]) for p, f in zip(part, full))
    with pytest.raises(ValueError):  # a CUDA tensor never takes the plain version
        ns_lib.fused_ns_step_stacked(m.double(), x.double(), mx.double())


# ------------------------------------------------- bf16 and f16 forms
# Their own tolerances, from the unit roundoff u (bf16 2^-8, f16 2^-11):
# sym_cov within 2u of max (one flip of the single rounding); flash on
# exact inputs acc bitwise and m, l within 1e-5 of max, on normal inputs
# acc within 2u of max (one rounding of each p at a tile's running max).
HALF_U = {torch.bfloat16: 2.0**-8, torch.float16: 2.0**-11}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16], ids=['bf16', 'f16'])
@pytest.mark.parametrize(
    'shape', [(8192, 513), (8192, 2049), (8192, 512), (8192, 2048), (1000, 70), (77, 130), (5, 3)],
)
def test_sym_cov_16_bit_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    g = torch.Generator(cuda_device).manual_seed(7)
    a = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    got = sym_cov_lib.sym_cov(a)
    want = sym_cov_lib.sym_cov_plain(a)
    assert got.dtype == dtype and torch.equal(got, got.T)
    assert torch.equal(got, sym_cov_lib.sym_cov(a))  # no atomics: repeatable
    err = (got.float() - want.float()).abs().max()
    assert err <= 2 * HALF_U[dtype] * want.float().abs().max()


def strided_views(a):
    """``a`` (n, d) as the 16-bit kernel reads it without a copy (rows 8
    values apart in a wider buffer), with rows a count apart that is not a multiple of 8, and as a
    column slice of a wider matrix off a 16-byte boundary (both copied)."""
    n, d = a.shape
    wide = torch.zeros(n, -(-d // 8) * 8 + 8, dtype=a.dtype, device=a.device)
    odd = torch.zeros(n, d + 3, dtype=a.dtype, device=a.device)
    off = torch.zeros(n, d + 2, dtype=a.dtype, device=a.device)
    return {
        'padded': wide[:, :d].copy_(a),
        'unaligned_stride': odd[:, :d].copy_(a),
        'column_slice': off[:, 1:d + 1].copy_(a),
    }


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16], ids=['bf16', 'f16'])
@pytest.mark.parametrize('shape', [(5, 3), (77, 130), (1000, 70), (8192, 2049), (8192, 513)])
def test_sym_cov_16_bit_kernel_on_row_strided_views_on_card(cuda_device, dtype, shape):
    # TMA-ready views read as they lie, the others through a padded copy:
    # every layout gives the contiguous input's bits
    g = torch.Generator(cuda_device).manual_seed(9)
    a = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    want = sym_cov_lib.sym_cov(a)
    plain = sym_cov_lib.sym_cov_plain(a)
    assert (want.float() - plain.float()).abs().max() <= 2 * HALF_U[dtype] * plain.float().abs().max()
    for name, view in strided_views(a).items():
        assert sym_cov_lib.tma_ready(view) == (name == 'padded'), name
        got = sym_cov_lib.sym_cov(view)
        assert torch.equal(got, got.T), name
        assert torch.equal(got, want), name
        assert torch.equal(got, sym_cov_lib.sym_cov(view)), name  # repeatable


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16], ids=['bf16', 'f16'])
def test_sym_cov_16_bit_kernel_with_each_walk_on_card(cuda_device, dtype):
    # one shape (6 tile pairs, 16 slabs) through walks from all pairs whole
    # to one slice per slab, on as many CTAs as the card has SMs and on 1
    g = torch.Generator(cuda_device).manual_seed(10)
    a = torch.randn(1000, 300, generator=g, device=cuda_device).to(dtype)
    want = sym_cov_lib.sym_cov_plain(a, 3.0).float()
    out = torch.empty(300, 300, dtype=dtype, device=cuda_device)
    sms = sym_cov_lib.sm_count(cuda_device.index or 0)
    for whole, split, slices, per in ((6, 0, 1, 1024), (4, 2, 2, 512), (3, 3, 5, 256),
                                      (0, 6, 16, 64), (5, 1, 3, 384)):
        for ctas in (sms, 1):
            p = sym_cov_lib.HalfPlan(1000, 300, ctas, whole, split, slices, per)
            sym_cov_lib.launch16(sym_cov_lib.half_input(a), out, 3.0, p)
            assert torch.equal(out, out.T), (whole, split, ctas)
            err = (out.float() - want).abs().max()
            assert err <= 2 * HALF_U[dtype] * want.abs().max(), (whole, split, ctas)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16], ids=['bf16', 'f16'])
@pytest.mark.parametrize('shape', [(8192, 513), (8192, 2048), (512, 256), (77, 130), (1000, 70), (5, 3)])
def test_sym_cov_ema_16_bit_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    # the blend of a 16-bit a into an f32 factor: within 1e-5 of max|coeff
    # a^T a| (the f32 form's tolerance; the products are exact in f32),
    # exactly symmetric, repeatable
    g = torch.Generator(cuda_device).manual_seed(11)
    a = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    f = sym_cov_lib.sym_cov_plain(torch.randn(shape, generator=g, device=cuda_device))
    beta, coeff = 0.95, 0.05 / shape[0]
    want = cov_ema.sym_cov_ema_plain(f, a, beta, coeff)
    before = cov_ema.sym_cov_ema.launches_by_dtype.get(dtype, 0)
    got = cov_ema.sym_cov_ema(f, a, beta, coeff)
    assert cov_ema.sym_cov_ema.launches_by_dtype[dtype] == before + 1
    assert got.dtype == torch.float32 and torch.equal(got, got.T)
    assert torch.equal(got, cov_ema.sym_cov_ema(f, a, beta, coeff))  # no atomics: repeatable
    tol = 1e-5 * (coeff * (a.float().T @ a.float())).abs().max()
    assert (got - want).abs().max() <= tol
    for view in strided_views(a).values():
        assert torch.equal(cov_ema.sym_cov_ema(f, view, beta, coeff), got)


def close_partials(got, want, dtype, exact):
    """acc bitwise (exact inputs) or within 2u of max|acc|; m and l within
    1e-5 of max over the rows that see a key, and equal (-1e30, 0) on the
    rows that see none."""
    seen = want[1] > flash_attention.NEG_INF / 2
    for x, w in zip(got[1:], want[1:]):
        assert torch.equal(x[~seen], w[~seen])
        if seen.any():
            assert (x[seen] - w[seen]).abs().max() <= 1e-5 * w[seen].abs().max()
    if exact:
        assert torch.equal(got[0], want[0])
    else:
        assert (got[0] - want[0]).abs().max() <= 2 * HALF_U[dtype] * want[0].abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16], ids=['bf16', 'f16'])
@pytest.mark.parametrize('inputs', ['exact', 'normal'])
@pytest.mark.parametrize(
    'q_off,k_off,s,d',
    [(0, 0, 512, 128), (64, 0, 100, 128), (0, 256, 128, 128), (16, 0, 192, 128),
     (0, 0, 128, 32), (16, 0, 100, 32), (0, 0, 256, 256), (48, 0, 100, 256),
     (0, 128, 96, 256), (256, 0, 256, 128), (448, 0, 64, 128), (0, 0, 512, 64),
     (64, 0, 100, 64), (0, 256, 128, 64)],
)
def test_flash_16_bit_kernel_at_ring_offsets_on_card(cuda_device, dtype, inputs, q_off, k_off, s, d):
    # the f32 test's offsets and the ring and zigzag steps of the flagship
    gen = torch.Generator().manual_seed(12)
    if inputs == 'exact':
        q, k, v = flash_attention.exact_inputs(2, s, 4, d, dtype, gen)
    else:
        q, k, v = (torch.randn(2, s, 4, d, generator=gen).to(dtype) for _ in range(3))
    q, k, v = (x.to(cuda_device) for x in (q, k, v))
    got = flash_attention.flash_attention_partials(q, k, v, q_off, k_off, True)
    want = flash_attention.attend_partials_rounded(q, k, v, q_off, k_off, True)
    close_partials(got, want, dtype, inputs == 'exact')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16], ids=['bf16', 'f16'])
@pytest.mark.parametrize('inputs', ['exact', 'normal'])
@pytest.mark.parametrize('d', [32, 64, 128, 256])
def test_flash_16_bit_kernel_matches_plain_on_card(cuda_device, dtype, inputs, d):
    gen = torch.Generator().manual_seed(8)
    if inputs == 'exact':
        q, k, v = flash_attention.exact_inputs(2, 300, 2, d, dtype, gen)
    else:
        q, k, v = (torch.randn(2, 300, 2, d, generator=gen).to(dtype) for _ in range(3))
    q, k, v = (x.to(cuda_device) for x in (q, k, v))
    got = flash_attention.flash_attention_partials(q, k, v, 0, 0, True)
    want = flash_attention.attend_partials_rounded(q, k, v, 0, 0, True)
    assert all(x.dtype == torch.float32 for x in got)
    for x, w in zip(got[1:], want[1:]):
        assert (x - w).abs().max() <= 1e-5 * w.abs().max()
    if inputs == 'exact':
        assert torch.equal(got[0], want[0])
    else:
        assert (got[0] - want[0]).abs().max() <= 2 * HALF_U[dtype] * want[0].abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.int32])
def test_16_bit_wrappers_raise_for_other_dtypes_on_card(cuda_device, dtype):
    a = torch.ones(64, 8, device=cuda_device, dtype=dtype)
    with pytest.raises(ValueError, match='float32, bfloat16 or float16'):
        sym_cov_lib.sym_cov(a)
    q = torch.ones(1, 16, 1, 32, device=cuda_device, dtype=dtype)
    with pytest.raises(ValueError, match='float32, bfloat16 or float16'):
        flash_attention.flash_attention_partials(q, q, q, 0, 0, True)
    mixed = torch.ones(1, 16, 1, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='one dtype'):
        flash_attention.flash_attention_partials(mixed, mixed.half(), mixed, 0, 0, True)
