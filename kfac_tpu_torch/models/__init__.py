"""Models of the port's main paths and its model zoo."""

from kfac_tpu_torch.models.lora import LoRADense
from kfac_tpu_torch.models.mlp import MLP
from kfac_tpu_torch.models.moe import MoEMLP, load_balance_loss
from kfac_tpu_torch.models.transformer import TransformerLM, lm_loss

__all__ = ['LoRADense', 'MLP', 'MoEMLP', 'TransformerLM', 'load_balance_loss', 'lm_loss']
