"""LoRA fine-tuning with K-FAC over the adapters, the backbone frozen
(counterpart of ``examples/finetune_lora.py``, without
``--export-posterior``).

1. Pretrain a dense backbone on the digits 0-4 with plain SGD.
2. Wrap its hidden projections in
   :class:`kfac_tpu_torch.models.LoRADense`, graft the pretrained weights
   into their ``base``, and freeze the backbone with one mask read twice:
   by ``register_model`` (the frozen layers get no hooks, no factors) and
   by the optimizer (the frozen parameters are left out of it, so they get
   no update). Fine-tune the adapters and the head on the digits 5-9,
   preconditioned by block-diagonal LoRA-unit K-FAC.

Usage::

    python -m kfac_tpu_torch.examples.finetune_lora --steps 300 --rank 8
    python -m kfac_tpu_torch.examples.finetune_lora --device cpu
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Any, Iterator

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from kfac_tpu_torch import data
from kfac_tpu_torch.device import resolve_device
from kfac_tpu_torch.layers import registry as registry_lib
from kfac_tpu_torch.models.lora import LoRADense
from kfac_tpu_torch.preconditioner import KFACPreconditioner
from kfac_tpu_torch.training import Trainer

# frozen: the backbone's base projections (the adapters and the head train)
FROZEN_MASK = {'dense0': {'base': False}, 'dense1': {'base': False}}


class Backbone(nn.Module):
    """Dense tower of two hidden layers of ``width`` with ReLU and a head,
    the JAX example's: its hidden projections are :class:`LoRADense` with
    ``rank > 0`` (rank 0 is the pretraining configuration). Parameters come
    from ``torch.Generator().manual_seed(seed)`` with flax's defaults."""

    def __init__(
        self,
        in_features: int = 64,
        width: int = 64,
        num_classes: int = 10,
        rank: int = 0,
        seed: int = 0,
        device: str | torch.device = 'cuda',
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        for i in range(2):
            d_in = in_features if i == 0 else width
            if rank > 0:
                layer = LoRADense(d_in, width, rank=rank, generator=gen)
            else:
                layer = nn.Linear(d_in, width)
                _lecun(layer, gen)
            self.add_module(f'dense{i}', layer)
        self.head = nn.Linear(width, num_classes)
        _lecun(self.head, gen)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            x = torch.relu(getattr(self, f'dense{i}')(x))
        return self.head(x)


@torch.no_grad()
def _lecun(layer: nn.Linear, gen: torch.Generator) -> None:
    std = 1.0 / math.sqrt(layer.in_features) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
    layer.bias.zero_()


def nll_loss(model: nn.Module):
    """``loss_fn(model_state, (x, y)) -> (mean cross-entropy,
    model_state)``: log-softmax against one-hot labels."""

    def loss_fn(ms, batch):
        x, y = batch
        logits = model(x)
        onehot = F.one_hot(y.long(), logits.shape[-1]).to(logits.dtype)
        return -torch.mean(torch.sum(F.log_softmax(logits, dim=-1) * onehot, dim=-1)), ms

    return loss_fn


@torch.no_grad()
def graft_pretrained(model: Backbone, pretrained: Backbone) -> None:
    """Copy a dense backbone's layers into a LoRA backbone: the hidden
    projections into the units' ``base``, the head as it is."""
    for i in range(2):
        getattr(model, f'dense{i}').base.load_state_dict(getattr(pretrained, f'dense{i}').state_dict())
    model.head.load_state_dict(pretrained.head.state_dict())


def freeze(model: nn.Module, mask: Any) -> list[nn.Parameter]:
    """Turn off the gradients of the parameters ``mask`` freezes and return
    the trainable ones, for the optimizer."""
    trainable = []
    for name, p in model.named_parameters():
        if registry_lib.is_trainable(mask, name):
            trainable.append(p)
        else:
            p.requires_grad_(False)
    return trainable


def finetune_trainer(
    model: Backbone, lr: float, damping: float, device: torch.device, mask: Any = FROZEN_MASK,
) -> Trainer:
    """The fine-tune's Trainer: the registry and the optimizer under one
    mask, K-FAC at cadence 1/10 over the LoRA units and the head, SGD(lr)
    on the trainable parameters."""
    registry = registry_lib.register_model(model, device=device, mask=mask)
    kfac = KFACPreconditioner(
        registry, damping=damping, lr=lr, factor_update_steps=1, inv_update_steps=10, device=device,
    )
    return Trainer(
        model, torch.optim.SGD(freeze(model, mask), lr=lr), nll_loss(model), kfac=kfac, device=device,
    )


def batches(rng: np.random.Generator, x: np.ndarray, y: np.ndarray, n: int, size: int,
            device: torch.device) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """``n`` batches of ``size`` rows drawn with replacement, as the JAX
    example draws them."""
    for _ in range(n):
        idx = rng.integers(0, len(x), size)
        yield torch.from_numpy(x[idx]).to(device), torch.from_numpy(y[idx]).to(device)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='LoRA + K-FAC fine-tuning')
    p.add_argument('--steps', type=int, default=300)
    p.add_argument('--pretrain-steps', type=int, default=200)
    p.add_argument('--rank', type=int, default=8)
    p.add_argument('--batch-size', type=int, default=128)
    p.add_argument('--lr', type=float, default=0.05)
    p.add_argument('--kfac-damping', type=float, default=0.003)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> dict[str, Any]:
    """Pretrain and fine-tune; returns ``pretrain_loss``, the fine-tune's
    per-step ``losses`` (each its batch's, before the step's update; device
    tensors read once, at the end), ``train_loss`` (the mean cross-entropy
    over every fine-tune training row at the final weights), the registered
    ``units`` and the held-out ``accuracy`` on 5-9."""
    device = resolve_device(args.device)
    (x_train, y_train), (x_test, y_test) = data.digits()
    # pretrain on classes 0-4, fine-tune on 5-9: a real distribution shift
    pre = y_train < 5
    x_ev = torch.from_numpy(x_test[y_test >= 5]).to(device)
    y_ev = torch.from_numpy(y_test[y_test >= 5]).to(device)
    rng = np.random.default_rng(args.seed)

    dense = Backbone(rank=0, seed=args.seed, device=device)
    tr = Trainer(dense, torch.optim.SGD(dense.parameters(), lr=args.lr), nll_loss(dense),
                 device=device)
    st = tr.init()
    for batch in batches(rng, x_train[pre], y_train[pre], args.pretrain_steps, args.batch_size, device):
        st, pretrain_loss = tr.step(st, batch)

    model = Backbone(rank=args.rank, seed=args.seed + 1, device=device)
    graft_pretrained(model, dense)
    tr = finetune_trainer(model, args.lr, args.kfac_damping, device)
    st = tr.init()
    losses = []
    for batch in batches(rng, x_train[~pre], y_train[~pre], args.steps, args.batch_size, device):
        st, loss = tr.step(st, batch)
        losses.append(loss)
    x_ft = torch.from_numpy(x_train[~pre]).to(device)
    y_ft = torch.from_numpy(y_train[~pre]).to(device)
    with torch.no_grad():
        acc = float((torch.argmax(model(x_ev), -1) == y_ev).float().mean())
        train_loss = float(nll_loss(model)(None, (x_ft, y_ft))[0])
    return dict(
        pretrain_loss=float(pretrain_loss), losses=torch.stack(losses).tolist(),
        train_loss=train_loss, units=sorted(tr.kfac.registry.layers), accuracy=acc,
    )


def main(argv: list[str] | None = None) -> float:
    """Run the fine-tune and print its summary; returns the final loss."""
    out = run(parse_args(argv))
    print(f'pretrain done: loss {out["pretrain_loss"]:.4f}')
    print(f'registered {len(out["units"])} K-FAC unit(s): {out["units"]}')
    print(f'fine-tune done: loss {out["losses"][-1]:.4f}, '
          f'training-set loss {out["train_loss"]:.4f}, '
          f'held-out accuracy {out["accuracy"]:.3f}')
    return out['losses'][-1]


if __name__ == '__main__':
    main()
    sys.exit(0)
