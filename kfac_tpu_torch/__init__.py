"""kfac_tpu_torch: the PyTorch/CUDA port of kfac_tpu for NVIDIA Hopper.

The JAX package ``kfac_tpu`` is the reference; this package does the same
work in PyTorch, with hand-written CUDA and Triton kernels where the JAX
package has Pallas kernels. Entry points run on ``device='cuda'`` unless
the caller passes ``device='cpu'``.
"""

from kfac_tpu_torch import tracing, warnings
from kfac_tpu_torch.enums import ComputeMethod
from kfac_tpu_torch.layers.capture import CapturedStats, CurvatureCapture
from kfac_tpu_torch.layers.registry import Registry, register_model
from kfac_tpu_torch.preconditioner import (
    KFACPreconditioner,
    KFACState,
    default_compute_method,
    set_grads,
)
from kfac_tpu_torch.training import Trainer, TrainState

__all__ = [
    'CapturedStats',
    'ComputeMethod',
    'CurvatureCapture',
    'KFACPreconditioner',
    'KFACState',
    'Registry',
    'TrainState',
    'Trainer',
    'default_compute_method',
    'register_model',
    'set_grads',
    'tracing',
    'warnings',
]
