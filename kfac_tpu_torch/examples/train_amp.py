"""Float16 K-FAC training with dynamic loss scaling (counterpart of
``examples/train_amp.py``).

- The ConvNet computes in float16 (``SameConv2d`` and ``CastLinear`` with
  ``dtype=torch.float16``); its parameters stay float32 masters, and the
  K-FAC factors and decompositions are float32.
- The loss is computed in float32 on the upcast logits and multiplied by
  the scaler's scale before the backward, so the float16 cotangents stay
  in range.
- The grads are unscaled (``amp.unscale``) and so are the captured
  statistics (``CapturedStats.scaled``: G divides by ``scale**2``).
- A step whose grads hold an inf or a NaN is skipped: parameters,
  optimizer and K-FAC state stay as they were, and the K-FAC step counter
  does not advance. The scale halves on such a step and doubles after
  ``--growth-interval`` good steps, so a short run with a large initial
  scale overflows for real (the float16 maximum is 65504).

The JAX example decides apply or skip inside the compiled step
(``lax.cond``); eager PyTorch has no such branch, so the loop reads one
bool a step on the host (``all_finite``), its one host sync outside the
K-FAC step's own. The data is the synthetic CIFAR-10 of
``kfac_tpu_torch.data`` (seeded, nothing is downloaded).

Usage::

    python -m kfac_tpu_torch.examples.train_amp --steps 300 --growth-interval 50
    python -m kfac_tpu_torch.examples.train_amp --device cpu --steps 4 --batch-size 8
"""

from __future__ import annotations

import argparse

import torch
import torch.nn as nn
import torch.nn.functional as F

from kfac_tpu_torch import amp, data
from kfac_tpu_torch.device import resolve_device
from kfac_tpu_torch.layers.capture import CurvatureCapture
from kfac_tpu_torch.layers.registry import register_model
from kfac_tpu_torch.models.layers import CastLinear, SameConv2d
from kfac_tpu_torch.models.resnet import reset_parameters
from kfac_tpu_torch.preconditioner import KFACPreconditioner, set_grads


class ConvNet(nn.Module):
    """The JAX example's small BatchNorm-free CIFAR CNN computing in
    ``dtype``: three SAME 3x3 convs (32, 64 at stride 2, 64 at stride 2)
    with ReLU, a dense 128 with ReLU and a dense head of 10. Weights from
    ``torch.Generator().manual_seed(seed)`` with flax's defaults."""

    def __init__(self, dtype: torch.dtype = torch.float16, seed: int = 0,
                 device: str | torch.device = 'cuda'):
        super().__init__()
        self.conv0 = SameConv2d(3, 32, 3, dtype=dtype)
        self.conv1 = SameConv2d(32, 64, 3, 2, dtype=dtype)
        self.conv2 = SameConv2d(64, 64, 3, 2, dtype=dtype)
        self.dense0 = CastLinear(64 * 8 * 8, 128, dtype=dtype)
        self.head = CastLinear(128, 10, dtype=dtype)
        reset_parameters(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv0(x))
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        x = torch.relu(self.dense0(x.flatten(1)))
        return self.head(x)


def amp_step(model, kfac, opt, run, kstate, scaler, batch, growth_interval):
    """One loss-scaled step: capture under the scaled loss, then apply
    (unscaled grads and statistics through ``kfac.step`` and the
    optimizer) or skip, then adapt the scaler. Returns ``(kstate, scaler,
    loss, applied)``: the loss unscaled (on the device), ``applied`` the
    host bool of the step's one read."""
    scale = scaler.scale
    (l_scaled, _), grads, stats = run(batch, scale)
    finite = amp.all_finite(grads)
    applied = bool(finite)  # the loop's host read: eager PyTorch has no lax.cond
    if applied:
        kstate, pgrads = kfac.step(kstate, amp.unscale(grads, scale), stats.scaled(scale))
        set_grads(model, pgrads)
        opt.step()
    scaler = amp.update(scaler, finite, growth_interval=growth_interval)
    return kstate, scaler, l_scaled / scale, applied


def main(argv=None):
    p = argparse.ArgumentParser(description='fp16 AMP + K-FAC')
    p.add_argument('--steps', type=int, default=300)
    p.add_argument('--batch-size', type=int, default=128)
    p.add_argument('--lr', type=float, default=0.05)
    p.add_argument('--init-scale', type=float, default=2.0**16)
    p.add_argument('--growth-interval', type=int, default=50)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    (x_train, y_train), _ = data.cifar10(n_train=4096, n_test=256)
    x_all = torch.from_numpy(x_train).permute(0, 3, 1, 2).contiguous().to(device)
    y_all = torch.from_numpy(y_train).long().to(device)
    model = ConvNet(seed=args.seed, device=device)
    registry = register_model(model, device=device)
    kfac = KFACPreconditioner(
        registry, damping=0.003, lr=args.lr, factor_update_steps=1, inv_update_steps=10,
        device=device,
    )
    opt = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)

    def scaled_loss(batch, scale):
        xb, yb = batch
        # the loss in f32 on the upcast logits; the scale rides the loss
        return F.cross_entropy(model(xb).float(), yb) * scale

    run = CurvatureCapture(registry).value_stats_and_grad(scaled_loss)
    kstate, scaler = kfac.init(), amp.init(args.init_scale, device)
    n = len(x_train) // args.batch_size
    skipped = 0
    for i in range(args.steps):
        j = (i % n) * args.batch_size
        batch = (x_all[j:j + args.batch_size], y_all[j:j + args.batch_size])
        kstate, scaler, loss, applied = amp_step(
            model, kfac, opt, run, kstate, scaler, batch, args.growth_interval
        )
        if not applied:
            skipped += 1
            print(f'step {i}: OVERFLOW -> scale {float(scaler.scale):.0f}')
        elif i % 25 == 0:
            print(f'step {i}: loss={float(loss):.4f} scale={float(scaler.scale):.0f} '
                  f'skipped={skipped}')
    print(
        f'done: loss={float(loss):.4f} scale={float(scaler.scale):.0f} '
        f'skipped={skipped} kfac_steps={int(kstate.step)} of {args.steps}'
    )
    return float(loss), skipped, int(kstate.step)


if __name__ == '__main__':
    main()
