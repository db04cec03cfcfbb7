"""RMSNorm with fp32 statistics (port of skypilot_tpu/ops/norms.py)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """y = x / rms(x) * scale, computed in fp32, returned in x.dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
