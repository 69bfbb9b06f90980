"""Device resolution shared by the port's entry points.

Entry points default to ``device='cuda'``. The CPU runs only when a
caller names it; a missing GPU is an error, never a silent CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = 'cuda') -> torch.device:
    """``torch.device`` for ``device``; raises if it is CUDA and no GPU is
    visible."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'kfac_tpu_torch runs on a CUDA device by default and none is '
            "available; pass device='cpu' to run the plain PyTorch versions "
            'on the CPU'
        )
    return dev
