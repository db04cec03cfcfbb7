"""Model configurations: the port of the config halves of
skypilot_tpu/models/llama.py (``RopeScaling``, ``LlamaConfig``,
``PRESETS``), skypilot_tpu/models/moe.py (``MoEConfig``, its
``PRESETS`` as ``MOE_PRESETS``) and skypilot_tpu/models/mla.py
(``MLAConfig``, ``DeepSeekMoEConfig``, its ``PRESETS`` as
``MLA_PRESETS``), field for field, with torch dtypes and the same
preset names. :func:`get_config` resolves all three, as the JAX
package's ``models.get_config`` does.

Every switch of the dense forward is implemented: the Llama/Qwen2 ones
(``qkv_bias``, ``tie_embeddings``, llama3/yarn ``rope_scaling``), the
Gemma-2/3 ones (``norm_plus_one``, the tanh-gelu MLP, ``embed_scale``,
the final and attention logit softcaps, ``post_norms``, the sliding
window and its layer pattern, ``qk_norm``, ``local_rope_theta``) and
the gpt-oss dense ones (``attn_sinks``, ``swiglu_limit``).
:func:`check_supported` refuses what the port does not have yet by
name: ``remat='dots'``; on an MoE config ``qk_norm`` and
``post_norms``, which the JAX MoE layer refuses too (its layers have no
such norm params); and on an MLA config every dense switch its layers
do not read (the JAX MLA layer ignores them), ring attention and
pipeline stages, which the JAX MLA forward refuses. Ring attention
(``attention_impl='ring'``) runs for the dense family; an MoE config
refuses it (its router aux would need a mean across sequence shards),
and ``pipeline_stages > 1`` stays refused.
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


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    """Mixture-of-Experts decoder (Mixtral family, gpt-oss): Llama's
    attention block, then a routed SwiGLU FFN of ``n_experts`` experts,
    ``top_k`` a token, with a static per-expert capacity
    (models/moe.py)."""
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.02
    # Tokens are routed within fixed-size groups along the sequence
    # (GShard), so the dispatch tensors stay linear in S.
    router_group_size: int = 2048

    def _per_layer(self, experts: int) -> int:
        a = 2 + 2 * (self.n_kv_heads / self.n_heads)
        attn = int(a * self.dim * self.n_heads * self.hd)
        return (attn + experts * 3 * self.dim * self.ffn_dim +
                self.dim * self.n_experts + 2 * self.dim)

    def _embed(self) -> int:
        return self.vocab_size * self.dim * (1 if self.tie_embeddings else 2)

    @property
    def num_params(self) -> int:
        return (self.n_layers * self._per_layer(self.n_experts) +
                self._embed() + self.dim)

    @property
    def active_params(self) -> int:
        """Params touched per token (for MFU accounting)."""
        return (self.n_layers * self._per_layer(self.top_k) +
                self._embed() + self.dim)


_YARN_32 = dict(rope_type='yarn', factor=32.0, original_max_position=4096)

MOE_PRESETS: Dict[str, MoEConfig] = {
    'moe-debug': MoEConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                           rope_theta=10000.0, remat='none', n_experts=4,
                           top_k=2),
    'mixtral-8x7b': MoEConfig(vocab_size=32000, dim=4096, n_layers=32,
                              n_heads=32, n_kv_heads=8, ffn_dim=14336,
                              rope_theta=1e6, max_seq_len=32768, n_experts=8,
                              top_k=2),
    # ~1B-active MoE for single-chip benchmarking.
    'moe-1b': MoEConfig(vocab_size=32768, dim=1024, n_layers=12, n_heads=8,
                        n_kv_heads=4, ffn_dim=4096, max_seq_len=4096,
                        tie_embeddings=True, n_experts=8, top_k=2),
    # gpt-oss: MoE + alternating sliding-window/full attention + sinks +
    # clamped SwiGLU + YaRN rope + qkv bias, every switch from the config.
    'gptoss-debug': MoEConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=128, max_seq_len=128, rope_theta=10000.0, remat='none',
        n_experts=4, top_k=2, qkv_bias=True, attn_sinks=True,
        swiglu_limit=7.0, sliding_window=32, sliding_window_pattern=2,
        # Ample capacity: no routed token drops.
        capacity_factor=4.0,
        rope_scaling=dict(rope_type='yarn', factor=2.0,
                          original_max_position=64)),
    'gpt-oss-20b': MoEConfig(
        vocab_size=201088, dim=2880, n_layers=24, n_heads=64,
        n_kv_heads=8, head_dim=64, ffn_dim=2880, max_seq_len=131072,
        rope_theta=150000.0, n_experts=32, top_k=4, qkv_bias=True,
        attn_sinks=True, swiglu_limit=7.0, sliding_window=128,
        sliding_window_pattern=2, rope_scaling=_YARN_32),
    'gpt-oss-120b': MoEConfig(
        vocab_size=201088, dim=2880, n_layers=36, n_heads=64,
        n_kv_heads=8, head_dim=64, ffn_dim=2880, max_seq_len=131072,
        rope_theta=150000.0, n_experts=128, top_k=4, qkv_bias=True,
        attn_sinks=True, swiglu_limit=7.0, sliding_window=128,
        sliding_window_pattern=2, rope_scaling=_YARN_32),
}


@dataclasses.dataclass(frozen=True)
class MLAConfig(LlamaConfig):
    """DeepSeek-V2-style Multi-head Latent Attention dims
    (models/mla.py). n_kv_heads is ignored: the latent replaces the K/V
    heads."""
    kv_lora_rank: int = 512          # r: latent width
    qk_nope_head_dim: int = 128      # dn: non-rope q/k per head
    qk_rope_head_dim: int = 64       # dr: shared rope key width
    v_head_dim: int = 128            # dv: value width per head

    def _attn_params(self) -> int:
        D, H = self.dim, self.n_heads
        r, dn, dr, dv = (self.kv_lora_rank, self.qk_nope_head_dim,
                         self.qk_rope_head_dim, self.v_head_dim)
        return (D * H * (dn + dr)        # W_q
                + D * r + D * dr         # W_dkv, W_kr
                + r * H * dn             # W_uk
                + r * H * dv             # W_uv
                + H * dv * D)            # W_o

    def _embed(self) -> int:
        return self.vocab_size * self.dim * (1 if self.tie_embeddings else 2)

    @property
    def num_params(self) -> int:
        per_layer = self._attn_params() + 3 * self.dim * self.ffn_dim + \
            2 * self.dim
        return self.n_layers * per_layer + self._embed() + self.dim


@dataclasses.dataclass(frozen=True)
class DeepSeekMoEConfig(MLAConfig):
    """DeepSeek-V2/V3: MLA attention and a mixture-of-experts FFN with
    always-on SHARED experts beside the routed ones. ``ffn_dim`` is the
    per-expert width; the shared experts add ``n_shared_experts *
    ffn_dim`` of dense SwiGLU on every token. The routed half is
    models/moe.py's ``moe_ffn`` (the same fields as MoEConfig's)."""
    n_experts: int = 8
    top_k: int = 2
    n_shared_experts: int = 1
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.02
    router_group_size: int = 2048

    @property
    def num_params(self) -> int:
        D, F, E = self.dim, self.ffn_dim, self.n_experts
        ffn = (E * 3 * D * F                        # routed experts
               + self.n_shared_experts * 3 * D * F  # shared experts
               + D * E)                             # router
        per_layer = self._attn_params() + ffn + 2 * D
        return self.n_layers * per_layer + self._embed() + D


MLA_PRESETS: Dict[str, MLAConfig] = {
    'mla-debug': MLAConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                           n_kv_heads=4, ffn_dim=128, max_seq_len=128,
                           rope_theta=10000.0, remat='none',
                           kv_lora_rank=32, qk_nope_head_dim=16,
                           qk_rope_head_dim=8, v_head_dim=16),
    # DeepSeek-V2-Lite's attention geometry with a dense FFN.
    'deepseek-v2-lite': MLAConfig(vocab_size=102400, dim=2048, n_layers=27,
                                  n_heads=16, n_kv_heads=16, ffn_dim=10944,
                                  rope_theta=10000.0, max_seq_len=32768,
                                  kv_lora_rank=512, qk_nope_head_dim=128,
                                  qk_rope_head_dim=64, v_head_dim=128),
    'deepseek-moe-debug': DeepSeekMoEConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
        ffn_dim=64, max_seq_len=128, rope_theta=10000.0, remat='none',
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, n_experts=4, top_k=2, n_shared_experts=1,
        # Ample capacity: no routed token drops.
        capacity_factor=4.0),
    # DeepSeek-V2: MLA (r=512), 160 routed experts (1536 wide, top-6)
    # and 2 shared.
    'deepseek-v2': DeepSeekMoEConfig(
        vocab_size=102400, dim=5120, n_layers=60, n_heads=128,
        n_kv_heads=128, ffn_dim=1536, max_seq_len=32768,
        rope_theta=10000.0, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, n_experts=160, top_k=6,
        n_shared_experts=2),
    # Kimi-K2 (the DeepSeek-V3 architecture): 384 routed experts (2048
    # wide, top-8) and 1 shared, 64 heads, 61 layers.
    'kimi-k2': DeepSeekMoEConfig(
        vocab_size=163840, dim=7168, n_layers=61, n_heads=64,
        n_kv_heads=64, ffn_dim=2048, max_seq_len=131072,
        rope_theta=50000.0, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, n_experts=384, top_k=8,
        n_shared_experts=1),
}

# The dense switches an MLA layer does not read: (field, family).
_NOT_IN_MLA = (('qk_norm', 'Gemma-3'), ('post_norms', 'Gemma-2'),
               ('norm_plus_one', 'Gemma'), ('embed_scale', 'Gemma'),
               ('final_logit_softcap', 'Gemma-2'),
               ('attn_logit_softcap', 'Gemma-2'),
               ('sliding_window', 'Gemma-2/3, gpt-oss'),
               ('local_rope_theta', 'Gemma-3'), ('qkv_bias', 'Qwen2'),
               ('attn_sinks', 'gpt-oss'), ('swiglu_limit', 'gpt-oss'))


def check_supported(cfg: LlamaConfig) -> None:
    """Raise NotImplementedError for a switch the port does not have."""
    if cfg.remat not in ('none', 'full'):
        raise NotImplementedError(
            f'remat={cfg.remat!r} is not ported yet: the port has the '
            f"'none' and 'full' layer recompute; 'dots' (save the matrix "
            f'products, recompute the rest) waits for ROADMAP Queue 1 item '
            f'5 (training: what waits)')
    if isinstance(cfg, MoEConfig):
        for name, family in (('qk_norm', 'Gemma-3'), ('post_norms',
                                                      'Gemma-2')):
            if getattr(cfg, name):
                raise NotImplementedError(
                    f'{name} is a dense ({family}) feature; MoE layers have '
                    f'no such norm params')
        if cfg.attention_impl == 'ring':
            raise NotImplementedError(
                "attention_impl='ring' is not ported for MoE models: the "
                'router aux loss would need a global mean across sequence '
                'shards, which waits for ROADMAP Queue 1 item 8 '
                '(parallelism: ring in MoE)')
    if isinstance(cfg, MLAConfig):
        for name, family in _NOT_IN_MLA:
            if getattr(cfg, name):
                raise NotImplementedError(
                    f'{name} is a dense ({family}) feature; MLA layers do '
                    f'not read it')
        if cfg.attention_impl == 'ring' or cfg.pipeline_stages > 1:
            raise NotImplementedError(
                'ring attention and pipeline stages are not implemented '
                'for MLA models (the JAX MLA forward refuses both)')
    if cfg.pipeline_stages > 1:
        raise NotImplementedError(
            f'pipeline_stages={cfg.pipeline_stages} is not ported yet: the '
            f'port runs every layer as one stage on one card; the pipeline '
            f'schedule waits for ROADMAP Queue 1 item 8 (parallelism and '
            f'multi-process)')


def get_config(name: str) -> LlamaConfig:
    """A dense, MoE or MLA preset by name, normalised as the JAX package
    does (lower case, '_' read as '-')."""
    key = name.lower().replace('_', '-')
    presets = {**PRESETS, **MOE_PRESETS, **MLA_PRESETS}
    if key not in presets:
        raise ValueError(f'unknown model preset {name!r}; known: '
                         f'{sorted(presets)}')
    return presets[key]
