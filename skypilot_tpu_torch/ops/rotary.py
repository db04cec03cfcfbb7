"""Rotary position embeddings (port of skypilot_tpu/ops/rotary.py):
llama3 NTK-by-parts and yarn scaling, split-halves rotation."""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


def rope_frequencies(head_dim: int, positions: torch.Tensor,
                     theta: float = 10000.0, scaling=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape positions.shape + (head_dim // 2,), fp32, on
    positions' device. ``positions`` may be [S] or per-row [B, S].
    ``scaling``: a config.RopeScaling or a dict of its fields."""
    half = head_dim // 2
    dev = positions.device
    idx = torch.arange(half, dtype=torch.float32, device=dev)
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32, device=dev),
                      -idx / half)
    mscale = 1.0
    if scaling:
        if not isinstance(scaling, dict):
            scaling = dataclasses.asdict(scaling)
        factor = float(scaling['factor'])
        orig = float(scaling.get('original_max_position', 8192))
        if scaling.get('rope_type', 'llama3') == 'yarn':
            beta_fast = float(scaling.get('beta_fast', 32.0))
            beta_slow = float(scaling.get('beta_slow', 1.0))

            def correction_dim(num_rotations: float) -> float:
                return (half * math.log(orig /
                                        (num_rotations * 2 * math.pi))
                        / math.log(theta))

            low = max(math.floor(correction_dim(beta_fast)), 0)
            high = min(math.ceil(correction_dim(beta_slow)), half - 1)
            ramp = torch.clamp((idx - low) / max(high - low, 1e-3), 0.0, 1.0)
            freqs = freqs * (1 - ramp) + (freqs / factor) * ramp
            af = scaling.get('attention_factor')
            mscale = (float(af) if af is not None
                      else 0.1 * math.log(factor) + 1.0)
        else:
            low = float(scaling.get('low_freq_factor', 1.0))
            high = float(scaling.get('high_freq_factor', 4.0))
            wavelen = 2.0 * math.pi / freqs
            ratio = orig / wavelen
            smooth = torch.clamp((ratio - low) / (high - low), 0.0, 1.0)
            scaled = freqs / factor
            freqs = torch.where(ratio < low, scaled,
                                torch.where(ratio > high, freqs,
                                            (1 - smooth) * scaled
                                            + smooth * freqs))
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles) * mscale, torch.cos(angles) * mscale


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Rotate x [..., S, H, D] by per-position (sin, cos) [..., S, D/2]:
    out = [x1*cos - x2*sin, x2*cos + x1*sin], fp32, cast back."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    s = sin[..., None, :]
    c = cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)
