"""The port's models: ``module_for(cfg)`` maps a config to its model
module (``init_params`` / ``forward``), as the JAX package's
``models.module_for`` does; the most derived config class wins."""
from skypilot_tpu_torch.config import LlamaConfig, MLAConfig, MoEConfig


def module_for(cfg):
    """Model module implementing this config: models.mla for an
    MLAConfig (a DeepSeekMoEConfig among them, which is an MLAConfig
    and not an MoEConfig), models.moe for an MoEConfig, models.llama for
    any other LlamaConfig."""
    from skypilot_tpu_torch.models import llama, mla, moe
    if isinstance(cfg, MLAConfig):
        return mla
    if isinstance(cfg, MoEConfig):
        return moe
    if isinstance(cfg, LlamaConfig):
        return llama
    raise TypeError(f'No model module for config type {type(cfg)!r}')
