"""The port's models: ``module_for(cfg)`` maps a config to its model
module (``init_params`` / ``forward``), as the JAX package's
``models.module_for`` does; the most derived config class wins."""
from skypilot_tpu_torch.config import LlamaConfig, MoEConfig


def module_for(cfg):
    """Model module implementing this config: models.moe for an
    MoEConfig, models.llama for any other LlamaConfig."""
    from skypilot_tpu_torch.models import llama, moe
    if isinstance(cfg, MoEConfig):
        return moe
    if isinstance(cfg, LlamaConfig):
        return llama
    raise TypeError(f'No model module for config type {type(cfg)!r}')
