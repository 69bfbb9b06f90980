"""Async curvature refresh: double-buffered decompositions off the step's
path (counterpart of ``kfac_tpu/async_inverse``).

``config`` holds the model and its knobs, ``sliced`` the in-step sliced
backend, ``host`` the host-offloaded one, ``slots`` the shadow slots and
the slice planner.
"""

from kfac_tpu_torch.async_inverse.config import AsyncInverseConfig, as_async_config
from kfac_tpu_torch.async_inverse.slots import ShadowSlots, plan_slices

__all__ = ['AsyncInverseConfig', 'ShadowSlots', 'as_async_config', 'plan_slices']
