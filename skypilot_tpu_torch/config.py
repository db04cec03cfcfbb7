"""Llama-family configuration: the port of the config half of
skypilot_tpu/models/llama.py (``RopeScaling``, ``LlamaConfig``,
``PRESETS``), field for field, with torch dtypes and the same preset
names.

Every switch of the dense forward is implemented: the Llama/Qwen2 ones
(``qkv_bias``, ``tie_embeddings``, llama3/yarn ``rope_scaling``), the
Gemma-2/3 ones (``norm_plus_one``, the tanh-gelu MLP, ``embed_scale``,
the final and attention logit softcaps, ``post_norms``, the sliding
window and its layer pattern, ``qk_norm``, ``local_rope_theta``) and
the gpt-oss dense ones (``attn_sinks``, ``swiglu_limit``).
:func:`check_supported` refuses what the port does not have yet by
name: ``remat='dots'``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Rope scaling: 'llama3' (NTK by parts) or 'yarn'
    (ops/rotary.py implements both)."""
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192
    rope_type: str = 'llama3'
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: Optional[int] = None          # default dim // n_heads
    ffn_dim: int = 14336
    rope_theta: float = 500000.0
    rope_scaling: Optional[RopeScaling] = None  # accepts a dict in __init__
    rms_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16             # activation/compute dtype
    param_dtype: Any = torch.float32        # master param dtype
    remat: str = 'full'
    attention_impl: str = 'auto'
    ring_layout: str = 'seq'
    scan_layers: bool = True
    pipeline_stages: int = 1
    num_microbatches: int = 1
    qkv_bias: bool = False
    norm_plus_one: bool = False
    mlp_activation: str = 'silu'
    embed_scale: bool = False
    final_logit_softcap: Optional[float] = None
    attn_logit_softcap: Optional[float] = None
    post_norms: bool = False
    sliding_window: Optional[int] = None
    sliding_window_pattern: int = 2
    qk_norm: bool = False
    local_rope_theta: Optional[float] = None
    attn_sinks: bool = False
    swiglu_limit: Optional[float] = None

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.mlp_activation == 'gelu':
            # jax.nn.gelu's default: the tanh approximation (Gemma).
            return F.gelu(x, approximate='tanh')
        return F.silu(x)

    def glu(self, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
        """The gated-MLP inner product; with ``swiglu_limit`` the
        gpt-oss clamped variant (gate capped above, up clipped, gate
        activated with sigmoid(1.702 x), +1 on the linear term)."""
        if self.swiglu_limit is not None:
            limit = self.swiglu_limit
            gate = torch.clamp(gate, max=limit)
            up = torch.clamp(up, -limit, limit)
            return gate * torch.sigmoid(1.702 * gate) * (up + 1)
        return self.act(gate) * up

    def __post_init__(self):
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(self, 'rope_scaling',
                               RopeScaling(**self.rope_scaling))

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else (
            self.dim // self.n_heads)

    @property
    def num_params(self) -> int:
        a = 4 if self.n_kv_heads == self.n_heads else 2 + 2 * (
            self.n_kv_heads / self.n_heads)
        attn = int(a * self.dim * self.n_heads * self.hd)
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * self.hd
        mlp = 3 * self.dim * self.ffn_dim
        per_layer = attn + mlp + 2 * self.dim
        embed = self.vocab_size * self.dim * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + self.dim


PRESETS: Dict[str, LlamaConfig] = {
    'llama-debug': LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                               n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                               rope_theta=10000.0, remat='none'),
    'llama-1b': LlamaConfig(vocab_size=32768, dim=2048, n_layers=16,
                            n_heads=16, n_kv_heads=8, ffn_dim=7168,
                            max_seq_len=4096, tie_embeddings=True),
    'llama3-8b': LlamaConfig(vocab_size=128256, dim=4096, n_layers=32,
                             n_heads=32, n_kv_heads=8, ffn_dim=14336,
                             max_seq_len=8192,
                             rope_scaling=dict(factor=8.0, low_freq_factor=1.0,
                                               high_freq_factor=4.0,
                                               original_max_position=8192)),
    'llama3-70b': LlamaConfig(vocab_size=128256, dim=8192, n_layers=80,
                              n_heads=64, n_kv_heads=8, ffn_dim=28672,
                              max_seq_len=8192),
    'llama2-7b': LlamaConfig(vocab_size=32000, dim=4096, n_layers=32,
                             n_heads=32, n_kv_heads=32, ffn_dim=11008,
                             rope_theta=10000.0, max_seq_len=4096),
    'llama3.2-1b': LlamaConfig(vocab_size=128256, dim=2048, n_layers=16,
                               n_heads=32, n_kv_heads=8, ffn_dim=8192,
                               max_seq_len=8192, tie_embeddings=True,
                               rope_scaling=dict(factor=32.0,
                                                 low_freq_factor=1.0,
                                                 high_freq_factor=4.0,
                                                 original_max_position=8192)),
    'llama3.2-3b': LlamaConfig(vocab_size=128256, dim=3072, n_layers=28,
                               n_heads=24, n_kv_heads=8, ffn_dim=8192,
                               max_seq_len=8192, tie_embeddings=True,
                               rope_scaling=dict(factor=32.0,
                                                 low_freq_factor=1.0,
                                                 high_freq_factor=4.0,
                                                 original_max_position=8192)),
    'codellama-7b': LlamaConfig(vocab_size=32016, dim=4096, n_layers=32,
                                n_heads=32, n_kv_heads=32, ffn_dim=11008,
                                rope_theta=1e6, max_seq_len=16384),
    'qwen2-7b': LlamaConfig(vocab_size=152064, dim=3584, n_layers=28,
                            n_heads=28, n_kv_heads=4, ffn_dim=18944,
                            rope_theta=1e6, rms_eps=1e-6,
                            max_seq_len=32768, qkv_bias=True),
    'qwen2-72b': LlamaConfig(vocab_size=152064, dim=8192, n_layers=80,
                             n_heads=64, n_kv_heads=8, ffn_dim=29568,
                             rope_theta=1e6, rms_eps=1e-6,
                             max_seq_len=32768, qkv_bias=True),
    'qwen2.5-1.5b': LlamaConfig(vocab_size=151936, dim=1536, n_layers=28,
                                n_heads=12, n_kv_heads=2, ffn_dim=8960,
                                rope_theta=1e6, rms_eps=1e-6,
                                max_seq_len=32768, qkv_bias=True,
                                tie_embeddings=True),
    'gemma-7b': LlamaConfig(vocab_size=256000, dim=3072, n_layers=28,
                            n_heads=16, n_kv_heads=16, head_dim=256,
                            ffn_dim=24576, rope_theta=10000.0,
                            rms_eps=1e-6, max_seq_len=8192,
                            tie_embeddings=True, norm_plus_one=True,
                            mlp_activation='gelu', embed_scale=True),
    'gemma2-9b': LlamaConfig(vocab_size=256000, dim=3584, n_layers=42,
                             n_heads=16, n_kv_heads=8, head_dim=256,
                             ffn_dim=14336, rope_theta=10000.0,
                             rms_eps=1e-6, max_seq_len=8192,
                             tie_embeddings=True, norm_plus_one=True,
                             mlp_activation='gelu', embed_scale=True,
                             final_logit_softcap=30.0,
                             attn_logit_softcap=50.0, post_norms=True,
                             sliding_window=4096),
    'gemma3-12b': LlamaConfig(vocab_size=262208, dim=3840, n_layers=48,
                              n_heads=16, n_kv_heads=8, head_dim=256,
                              ffn_dim=15360, rope_theta=1e6,
                              rms_eps=1e-6, max_seq_len=32768,
                              tie_embeddings=True, norm_plus_one=True,
                              mlp_activation='gelu', embed_scale=True,
                              post_norms=True, qk_norm=True,
                              sliding_window=1024,
                              sliding_window_pattern=6,
                              local_rope_theta=10000.0),
}


def check_supported(cfg: LlamaConfig) -> None:
    """Raise NotImplementedError for a switch the port does not have."""
    if cfg.remat not in ('none', 'full'):
        raise NotImplementedError(
            f'remat={cfg.remat!r} is not ported yet: the port has the '
            f"'none' and 'full' layer recompute; 'dots' (save the matrix "
            f'products, recompute the rest) waits for ROADMAP Queue 1 item '
            f'4 (training slice)')


def get_config(name: str) -> LlamaConfig:
    if name not in PRESETS:
        raise ValueError(f'unknown model preset {name!r}; known: '
                         f'{sorted(PRESETS)}')
    return PRESETS[name]
