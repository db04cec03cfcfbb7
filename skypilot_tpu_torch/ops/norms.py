"""RMSNorm with fp32 statistics (port of skypilot_tpu/ops/norms.py)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
             scale_plus_one: bool = False) -> torch.Tensor:
    """y = x / rms(x) * scale (``scale + 1`` for the Gemma family's
    zero-initialised norms), computed in fp32, returned in x.dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    s = scale.float()
    if scale_plus_one:
        s = s + 1.0
    return (xf * torch.rsqrt(var + eps) * s).to(x.dtype)
