"""The port's convolution K-FAC layers against the JAX package's.

Inputs come from numpy with a fixed seed and go through both packages,
NHWC on the JAX side and NCHW (the same arrays transposed) on the port's.

- Patches, conv A and G factors: rtol 1e-5 with atol 1e-6 x the
  reference's max (f32 sums in another order); patches exactly.
- ``Conv2dHelper``'s matricisation and its round trip: exact (a reshape
  against a transpose and reshape of the same numbers).
- Registry names and order, factor shapes and the unregistered cases:
  exact, on ``testing/models.py``'s ``TinyConvNet``, the accuracy gate's
  ``SmallCNN``, ``CifarResNet(depth=8)`` and ResNet-50 at 64 px.
- ``SameConv2d`` against flax's SAME ``nn.Conv``: rtol 1e-5 with atol
  1e-6 x max; ``padding=1`` is not flax's rule under stride 2.
"""

import os
import pathlib
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import kfac_tpu
from kfac_tpu.layers import helpers as jhelpers
from kfac_tpu.models import resnet as jresnet
from kfac_tpu.ops import cov as jcov
from kfac_tpu_torch import bench_accuracy, convert
from kfac_tpu_torch.layers import capture, helpers, registry
from kfac_tpu_torch.models import resnet
from kfac_tpu_torch.models.layers import SameConv2d
from kfac_tpu_torch.ops import cov
from testing.models import TinyConvNet as JaxTinyConvNet

# each xdist worker gets its share of the host's cores for torch: at the
# default (every core in every worker) the workers oversubscribe the host
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))))

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / 'tools'))
from bench_accuracy import SmallCNN as JaxSmallCNN  # noqa: E402

GEOMETRIES = [(s, p) for s in (1, 2) for p in ('SAME', 'VALID')]


def close(got, want, rtol=1e-5, atol_rel=1e-6):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * float(np.max(np.abs(want))))


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize('stride,padding', GEOMETRIES)
def test_patches_equal_jax(stride, padding):
    x = rand(0, 2, 9, 8, 3)  # odd height: SAME pads differ by dim
    want = jcov.extract_patches_nhwc(jnp.asarray(x), (3, 3), (stride, stride), padding)
    got = cov.extract_patches(nchw(x), (3, 3), (stride, stride), padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('has_bias', [True, False], ids=['bias', 'nobias'])
@pytest.mark.parametrize('stride,padding', GEOMETRIES)
def test_conv_a_factor_matches_jax(stride, padding, has_bias):
    x = rand(1, 3, 10, 10, 4)
    want = jcov.conv2d_a_factor(jnp.asarray(x), (3, 3), (stride, stride), padding, has_bias)
    got = cov.conv2d_a_factor(nchw(x), (3, 3), (stride, stride), padding, has_bias)
    close(got, want)
    assert torch.equal(got, got.T)


def test_conv_a_factor_with_explicit_pairs_matches_jax():
    x = rand(2, 2, 12, 12, 3)
    pads = ((3, 3), (3, 3))
    want = jcov.conv2d_a_factor(jnp.asarray(x), (7, 7), (2, 2), pads, False)
    close(cov.conv2d_a_factor(nchw(x), (7, 7), (2, 2), pads, False), want)


def test_conv_g_factor_matches_jax():
    g = rand(3, 3, 5, 4, 6)
    close(cov.conv2d_g_factor(nchw(g)), jcov.conv2d_g_factor(jnp.asarray(g)))


@pytest.mark.parametrize('size,stride', [(32, 2), (8, 2), (7, 2), (32, 1), (9, 3)])
def test_same_padding_is_flax_rule(size, stride):
    x = rand(4, 1, size, size, 2)
    k = rand(5, 3, 3, 2, 3)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (stride, stride), 'SAME',
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
    )
    conv = SameConv2d(2, 3, 3, stride, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
    got = conv(nchw(x)).detach().numpy().transpose(0, 2, 3, 1)
    close(got, want)
    if size % stride == 0 and stride == 2:  # (0, 1): torch's symmetric padding=1 is not it
        sym = F.conv2d(nchw(x), conv.weight, stride=stride, padding=1).detach().numpy()
        assert np.max(np.abs(sym.transpose(0, 2, 3, 1) - np.asarray(want))) > 1e-2


@pytest.mark.parametrize('has_bias', [True, False], ids=['bias', 'nobias'])
def test_conv_helper_matricises_as_jax_and_round_trips(has_bias):
    kh, kw, cin, cout = 3, 2, 4, 5
    kernel, bias = rand(6, kh, kw, cin, cout), rand(7, cout)
    jh = jhelpers.Conv2dHelper(
        name='c', has_bias=has_bias, in_channels=cin, out_channels=cout,
        kernel_size=(kh, kw), strides=(1, 1), padding='SAME',
    )
    th = helpers.Conv2dHelper(
        name='c', has_bias=has_bias, in_channels=cin, out_channels=cout,
        kernel_size=(kh, kw), strides=(1, 1), padding='SAME',
    )
    jgrads = {'kernel': jnp.asarray(kernel)}
    tgrads = {'weight': torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())}
    if has_bias:
        jgrads['bias'], tgrads['bias'] = jnp.asarray(bias), torch.from_numpy(bias)
    want = np.asarray(jh.grads_to_matrix(jgrads))
    got = th.grads_to_matrix(tgrads)
    np.testing.assert_array_equal(got.numpy(), want)
    assert th.a_factor_shape == jh.a_factor_shape and th.g_factor_shape == jh.g_factor_shape
    back = th.matrix_to_grads(got)
    assert set(back) == set(tgrads)
    for k, v in tgrads.items():
        assert torch.equal(back[k], v)
    jback = jh.matrix_to_grads(jnp.asarray(want))
    np.testing.assert_array_equal(back['weight'].numpy(), np.asarray(jback['kernel']).transpose(3, 2, 0, 1))


class TinyConvNet(nn.Module):
    """``testing/models.py``'s ``TinyConvNet`` (VALID convs, NHWC flatten)."""

    def __init__(self):
        super().__init__()
        self.conv1, self.conv2 = nn.Conv2d(1, 6, 5), nn.Conv2d(6, 16, 5)
        self.fc1, self.fc2 = nn.Linear(16 * 4 * 4, 32), nn.Linear(32, 10)

    def forward(self, x):
        x = F.avg_pool2d(torch.relu(self.conv1(x)), 2)
        x = F.avg_pool2d(torch.relu(self.conv2(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.fc2(torch.relu(self.fc1(x)))


def jax_summary(model, x, **kw):
    reg = kfac_tpu.register_model(model, x, **kw)
    return [(n, type(h).__name__, h.a_factor_shape, h.g_factor_shape) for n, h in reg.layers.items()]


def torch_summary(model):
    reg = registry.register_model(model, device='cpu')
    return [(n, type(h).__name__, h.a_factor_shape, h.g_factor_shape) for n, h in reg.layers.items()]


@pytest.mark.parametrize('name', ['tiny_conv', 'small_cnn', 'cifar8', 'resnet50'])
def test_registry_names_order_and_shapes_match_jax(name):
    if name == 'tiny_conv':
        want = jax_summary(JaxTinyConvNet(), jnp.ones((1, 28, 28, 1)))
        got = torch_summary(TinyConvNet())
    elif name == 'small_cnn':
        want = jax_summary(JaxSmallCNN(), jnp.ones((1, 8, 8, 1)))
        got = torch_summary(bench_accuracy.SmallCNN(device='cpu'))
    elif name == 'cifar8':
        want = jax_summary(jresnet.CifarResNet(depth=8), jnp.ones((1, 32, 32, 3)), train=False)
        got = torch_summary(resnet.CifarResNet(depth=8, device='cpu'))
    else:
        want = jax_summary(jresnet.resnet50(), jnp.ones((1, 64, 64, 3)), train=False)
        got = torch_summary(resnet.resnet50(device='cpu'))
        assert len(got) == 1 + 48 + 4 + 1
    assert got == want


class Unregistered(fnn.Module):
    """Flax convs the JAX registry leaves out, beside one it keeps."""

    @fnn.compact
    def __call__(self, x):
        x = fnn.Conv(4, (3, 3), name='kept')(x)
        x = fnn.Conv(4, (3, 3), feature_group_count=2, name='grouped')(x)
        x = fnn.Conv(4, (3, 3), kernel_dilation=2, name='dilated')(x)
        x = fnn.Conv(4, (3, 3), padding='CIRCULAR', name='circular')(x)
        x = fnn.Conv(4, (3, 3), padding='REFLECT', name='reflect')(x)
        y = fnn.Conv(4, (3,), name='conv1d')(x.reshape(x.shape[0], -1, 4))
        return y


class TorchUnregistered(nn.Module):
    def __init__(self):
        super().__init__()
        self.kept = SameConv2d(3, 4, 3)
        self.grouped = nn.Conv2d(4, 4, 3, padding=1, groups=2)
        self.dilated = nn.Conv2d(4, 4, 3, padding=2, dilation=2)
        self.circular = nn.Conv2d(4, 4, 3, padding=1, padding_mode='circular')
        self.reflect = nn.Conv2d(4, 4, 3, padding=1, padding_mode='reflect')
        self.conv1d = nn.Conv1d(4, 4, 3, padding=1)


def test_unregistered_convs_match_jax():
    want = kfac_tpu.register_model(Unregistered(), jnp.ones((1, 6, 6, 3))).names()
    got = registry.register_model(TorchUnregistered(), device='cpu').names()
    assert got == want == ['kept']


def test_registered_conv_helpers_carry_their_geometry():
    reg = registry.register_model(resnet.CifarResNet(depth=8, device='cpu'), device='cpu')
    h = reg.layers['stage1_block0/conv1']
    assert (h.kernel_size, h.strides, h.padding, h.has_bias) == ((3, 3), (2, 2), 'SAME', False)
    stem = registry.register_model(resnet.resnet50(device='cpu'), device='cpu').layers['conv0']
    assert (stem.kernel_size, stem.strides, stem.padding) == ((7, 7), (2, 2), ((3, 3), (3, 3)))
    same = registry.make_helper(nn.Conv2d(2, 2, 3, padding='same'), 'c')
    assert same.padding == 'SAME'


def test_capture_of_a_same_conv_takes_the_unpadded_input():
    """The conv's A hook sees the input before the SAME pad, and the
    factor equals JAX's of the same input: the stride-2 (0, 1) pad is
    applied once, by the patches."""
    x = rand(8, 2, 8, 8, 3)
    conv = SameConv2d(3, 4, 3, 2, bias=True)
    model = nn.Sequential()
    model.add_module('conv', conv)
    reg = registry.register_model(model, device='cpu')
    run = capture.CurvatureCapture(reg).value_stats_and_grad(lambda b: model(b).square().mean())
    _, _, stats = run(nchw(x))
    want = jcov.conv2d_a_factor(jnp.asarray(x), (3, 3), (2, 2), 'SAME', True)
    close(stats.a['conv'], want)


def test_convert_rejects_kernels_that_are_neither_dense_nor_2d_conv():
    with pytest.raises(ValueError, match='dense and 2-D conv'):
        convert.from_flax_params({'c': {'kernel': np.zeros((3, 2, 2))}})
    out = convert.from_flax_params({'c': {'kernel': rand(9, 3, 2, 4, 5)}})
    assert tuple(out['c.weight'].shape) == (5, 4, 3, 2)
