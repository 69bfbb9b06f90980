"""ResNets: CIFAR-style (20/32/56) and ImageNet-style (50) (counterpart of
``kfac_tpu/models/resnet.py``), NCHW.

Modules carry the flax paths (``conv0``, ``bn0``, ``stage{s}_block{b}/
conv1``, ``.../bn_proj``, ``head``) and are defined in call order, so the
registry's layer names and order are the JAX package's and
``kfac_tpu_torch.convert`` loads flax weights and ``batch_stats``
directly. Convolutions pad by flax's SAME rule (:class:`SameConv2d`), and
BatchNorm is flax's (:class:`BatchNorm`): the forward takes the running
statistics and returns them updated::

    logits, new_state = model(x, model_state, train=True)

``model_state`` is ``{batch_stats path: {'mean', 'var'}}``
(:func:`~kfac_tpu_torch.models.layers.initial_model_state`, or
``convert.from_flax_batch_stats``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from kfac_tpu_torch.device import resolve_device
from kfac_tpu_torch.models.layers import BatchNorm, BatchStats, SameConv2d, name_batch_norms


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (CIFAR ResNets), with the Option-A
    shortcut: where the shape changes, the identity strided and
    zero-padded on channels, parameter-free, so K-FAC sees only the
    convolutions."""

    def __init__(self, in_channels: int, filters: int, strides: int = 1):
        super().__init__()
        self.filters, self.strides = filters, strides
        self.conv1 = SameConv2d(in_channels, filters, 3, strides, bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = SameConv2d(filters, filters, 3, 1, bias=False)
        self.bn2 = BatchNorm(filters)

    def forward(self, x: torch.Tensor, stats: BatchStats) -> torch.Tensor:
        residual = x
        y = torch.relu(self.bn1(self.conv1(x), stats))
        y = self.bn2(self.conv2(y), stats)
        if residual.shape != y.shape:
            residual = residual[:, :, :: self.strides, :: self.strides]
            pad = self.filters - residual.shape[1]
            residual = F.pad(residual, (0, 0, 0, 0, pad // 2, pad - pad // 2))
        return torch.relu(y + residual)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck (ImageNet ResNets); a projection
    (``proj``, ``bn_proj``) where the shape changes; ``bn3`` starts at
    scale 0, as the flax block's."""

    def __init__(self, in_channels: int, filters: int, strides: int = 1):
        super().__init__()
        self.conv1 = SameConv2d(in_channels, filters, 1, bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = SameConv2d(filters, filters, 3, strides, bias=False)
        self.bn2 = BatchNorm(filters)
        self.conv3 = SameConv2d(filters, 4 * filters, 1, bias=False)
        self.bn3 = BatchNorm(4 * filters, scale_init=0.0)
        if in_channels != 4 * filters or strides != 1:
            self.proj = SameConv2d(in_channels, 4 * filters, 1, strides, bias=False)
            self.bn_proj = BatchNorm(4 * filters)

    def forward(self, x: torch.Tensor, stats: BatchStats) -> torch.Tensor:
        residual = x
        y = torch.relu(self.bn1(self.conv1(x), stats))
        y = torch.relu(self.bn2(self.conv2(y), stats))
        y = self.bn3(self.conv3(y), stats)
        if hasattr(self, 'proj'):
            residual = self.bn_proj(self.proj(residual), stats)
        return torch.relu(y + residual)


@torch.no_grad()
def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's defaults from ``generator``: lecun_normal kernels (a normal
    truncated at +-2 std, variance 1 / fan_in, fan_in = C_in * kh * kw
    for a conv), zero biases; a BatchNorm keeps its own scale (1, or 0)
    and zero bias."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()


class _ResNet(nn.Module):
    """Shared tail of both families: stem, stages, global mean pool,
    ``head``; weights drawn on the CPU from ``seed`` (flax's defaults),
    then moved to ``device`` (``'cuda'`` unless the caller passes
    another)."""

    def _finish(self, seed: int, device: str | torch.device) -> None:
        name_batch_norms(self)
        reset_parameters(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def _stem(self, x: torch.Tensor, stats: BatchStats) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, model_state: dict, train: bool = True) -> tuple[torch.Tensor, dict]:
        """``(logits, new model_state)`` of an NCHW batch; with ``train``
        the batch statistics normalise and the running ones move, else the
        running ones normalise and come back unchanged."""
        if model_state is None:
            raise ValueError(
                'the ResNet needs its running statistics: pass '
                'models.layers.initial_model_state(model, device) (Trainer.init(model_state=...))'
            )
        stats = BatchStats(model_state, train)
        x = self._stem(x, stats)
        for block in self.blocks:
            x = block(x, stats)
        logits = self.head(x.mean((2, 3)))
        return logits, (stats.new if train else model_state)

    @property
    def blocks(self) -> list[nn.Module]:
        return [m for n, m in self.named_children() if n.startswith('stage')]


class CifarResNet(_ResNet):
    """ResNet-(6n+2) for 32x32 inputs: n basic blocks in each of 3 stages
    of 16, 32 and 64 filters."""

    def __init__(self, depth: int = 20, num_classes: int = 10, seed: int = 0, device: str | torch.device = 'cuda'):
        super().__init__()
        if (depth - 2) % 6 != 0:
            raise ValueError('CIFAR ResNet depth must be 6n+2')
        n = (depth - 2) // 6
        self.conv0 = SameConv2d(3, 16, 3, bias=False)
        self.bn0 = BatchNorm(16)
        width = 16
        for stage, filters in enumerate((16, 32, 64)):
            for block in range(n):
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(f'stage{stage}_block{block}', BasicBlock(width, filters, strides))
                width = filters
        self.head = nn.Linear(width, num_classes)
        self._finish(seed, device)

    def _stem(self, x, stats):
        return torch.relu(self.bn0(self.conv0(x), stats))


class ImageNetResNet(_ResNet):
    """Bottleneck ResNet for 224x224 inputs (``stage_sizes`` (3, 4, 6, 3):
    ResNet-50): a 7x7 stride-2 stem padded (3, 3), a 3x3 stride-2 max pool
    padded (1, 1) with -inf, four stages of 64 to 512 filters."""

    def __init__(
        self,
        stage_sizes: Sequence[int] = (3, 4, 6, 3),
        num_classes: int = 1000,
        seed: int = 0,
        device: str | torch.device = 'cuda',
    ):
        super().__init__()
        self.conv0 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn0 = BatchNorm(64)
        width = 64
        for stage, (blocks, filters) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            for block in range(blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(f'stage{stage}_block{block}', BottleneckBlock(width, filters, strides))
                width = 4 * filters
        self.head = nn.Linear(width, num_classes)
        self._finish(seed, device)

    def _stem(self, x, stats):
        x = torch.relu(self.bn0(self.conv0(x), stats))
        return F.max_pool2d(x, 3, stride=2, padding=1)


def resnet20(**kw) -> CifarResNet:
    return CifarResNet(depth=20, **kw)


def resnet32(**kw) -> CifarResNet:
    return CifarResNet(depth=32, **kw)


def resnet56(**kw) -> CifarResNet:
    return CifarResNet(depth=56, **kw)


def resnet50(**kw) -> ImageNetResNet:
    return ImageNetResNet(stage_sizes=(3, 4, 6, 3), **kw)


def classification_loss(model: nn.Module):
    """``loss_fn(model_state, (x, y)) -> (mean cross-entropy, new
    model_state)`` of a model with batch statistics, training mode: the
    JAX tasks' log-softmax against one-hot labels."""

    def loss_fn(ms, batch):
        x, y = batch
        logits, new_ms = model(x, ms, train=True)
        logp = F.log_softmax(logits, dim=-1)
        onehot = F.one_hot(y.long(), logits.shape[-1]).to(logp.dtype)
        return -torch.mean(torch.sum(logp * onehot, dim=-1)), new_ms

    return loss_fn
