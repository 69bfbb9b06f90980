"""Models of the port's main path."""

from kfac_tpu_torch.models.transformer import TransformerLM, lm_loss

__all__ = ['TransformerLM', 'lm_loss']
