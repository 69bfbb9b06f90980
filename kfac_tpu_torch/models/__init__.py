"""Models of the port's main paths."""

from kfac_tpu_torch.models.mlp import MLP
from kfac_tpu_torch.models.transformer import TransformerLM, lm_loss

__all__ = ['MLP', 'TransformerLM', 'lm_loss']
