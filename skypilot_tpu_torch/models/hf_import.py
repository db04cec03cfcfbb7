"""HuggingFace checkpoint import: safetensors → the port's param tree
(port of skypilot_tpu/models/hf_import.py: ``_ARCHITECTURES``,
``config_from_hf``, ``_shard_files``, ``_load_tensors``, ``_expect``,
``params_from_hf``, ``load_hf_config``, ``load_hf_checkpoint``,
``hf_eos_ids``).

The port's param tree stacks layers on a leading [L] axis and keeps
projections [in, out] (models/llama.py multiplies ``h @ w``); HF stores
per-layer tensors and torch Linear weights [out, in]. So the import
gathers ``model.layers.{i}.*``, transposes each projection and stacks
once. RoPE is the split-halves convention on both sides: no head
permutation. Tensors are read by the port's own codec
(models/safetensors_io.py) in their stored dtype, so a bf16 checkpoint
stays bf16 unless ``dtype`` asks for a cast.

Supported architectures, as in JAX: LlamaForCausalLM (Llama 2/3/3.1/3.2,
CodeLlama), Qwen2ForCausalLM (q/k/v biases) and MixtralForCausalLM (the
port's MoEConfig: per-expert stacks and a router). Anything else raises
with the architecture's name.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from skypilot_tpu_torch.config import LlamaConfig, MoEConfig
from skypilot_tpu_torch.models import safetensors_io, weights

logger = logging.getLogger(__name__)

Params = Dict[str, Any]

# HF architecture → config overrides. Mixtral maps onto MoEConfig (see
# config_from_hf); its router softmaxes the top-k logits where the port
# softmaxes all and renormalises the top k: the shared denominator
# cancels, so the gate weights are the same.
_ARCHITECTURES = {
    'LlamaForCausalLM': {},
    'Qwen2ForCausalLM': {'qkv_bias': True},
    'MixtralForCausalLM': {},
}


def config_from_hf(hf_cfg: Dict[str, Any]) -> LlamaConfig:
    """An HF ``config.json`` dict → a LlamaConfig (an MoEConfig for
    Mixtral). Raises ValueError on an architecture or a rope type the
    port does not import, rather than serve wrong math."""
    archs = hf_cfg.get('architectures') or ['LlamaForCausalLM']
    arch = archs[0]
    if arch not in _ARCHITECTURES:
        raise ValueError(
            f'Unsupported HF architecture {arch!r}; supported: '
            f'{sorted(_ARCHITECTURES)}. (The MLA/DeepSeek family '
            f'imports via its own converter when added.)')
    rope_scaling = None
    rs = hf_cfg.get('rope_scaling')
    if rs:
        rope_type = rs.get('rope_type', rs.get('type', 'default'))
        if rope_type == 'llama3':
            rope_scaling = dict(
                factor=float(rs['factor']),
                low_freq_factor=float(rs.get('low_freq_factor', 1.0)),
                high_freq_factor=float(rs.get('high_freq_factor', 4.0)),
                original_max_position=int(
                    rs.get('original_max_position_embeddings', 8192)))
        elif rope_type not in ('default', None):
            raise ValueError(
                f'Unsupported rope_scaling type {rope_type!r} (supported: '
                f"'llama3', 'default'); refusing to import with wrong "
                f'position math.')
    kwargs: Dict[str, Any] = dict(
        vocab_size=int(hf_cfg['vocab_size']),
        dim=int(hf_cfg['hidden_size']),
        n_layers=int(hf_cfg['num_hidden_layers']),
        n_heads=int(hf_cfg['num_attention_heads']),
        n_kv_heads=int(hf_cfg.get('num_key_value_heads',
                                  hf_cfg['num_attention_heads'])),
        ffn_dim=int(hf_cfg['intermediate_size']),
        rope_theta=float(hf_cfg.get('rope_theta', 10000.0)),
        rope_scaling=rope_scaling,
        rms_eps=float(hf_cfg.get('rms_norm_eps', 1e-5)),
        max_seq_len=int(hf_cfg.get('max_position_embeddings', 8192)),
        tie_embeddings=bool(hf_cfg.get('tie_word_embeddings', False)),
    )
    if hf_cfg.get('head_dim'):
        kwargs['head_dim'] = int(hf_cfg['head_dim'])
    kwargs.update(_ARCHITECTURES[arch])
    if arch == 'MixtralForCausalLM':
        if hf_cfg.get('sliding_window'):
            # Mistral windows EVERY layer: a pattern past n_layers means
            # no layer is global under llama.window_active's rule.
            kwargs['sliding_window'] = int(hf_cfg['sliding_window'])
            kwargs['sliding_window_pattern'] = kwargs['n_layers'] + 1
        return MoEConfig(
            **kwargs,
            n_experts=int(hf_cfg['num_local_experts']),
            top_k=int(hf_cfg['num_experts_per_tok']),
            # HF routes every token (no capacity); 2.0 keeps drops
            # negligible in the static-capacity dispatch. Decode (S=1)
            # never drops.
            capacity_factor=2.0)
    return LlamaConfig(**kwargs)


def _shard_files(hf_dir: str) -> List[str]:
    """The safetensors shards: one file, or those an index names."""
    index = os.path.join(hf_dir, 'model.safetensors.index.json')
    if os.path.exists(index):
        with open(index, 'r', encoding='utf-8') as f:
            weight_map = json.load(f)['weight_map']
        return sorted({os.path.join(hf_dir, v)
                       for v in weight_map.values()})
    single = os.path.join(hf_dir, 'model.safetensors')
    if os.path.exists(single):
        return [single]
    raise FileNotFoundError(
        f'No model.safetensors(.index.json) under {hf_dir!r} — is this an '
        f'HF checkpoint directory? (.bin torch pickles are not supported; '
        f'convert to safetensors.)')


def _load_tensors(hf_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of every shard, on the CPU in its stored dtype
    (memory-mapped: pages are read when a tensor is used)."""
    tensors: Dict[str, torch.Tensor] = {}
    for path in _shard_files(hf_dir):
        tensors.update(safetensors_io.load_file(path))
    return tensors


def _expect(tensors: Dict[str, torch.Tensor], key: str,
            shape: Tuple[int, ...]) -> torch.Tensor:
    if key not in tensors:
        raise KeyError(f'HF checkpoint missing tensor {key!r}')
    t = tensors.pop(key)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{key}: shape {tuple(t.shape)} != expected '
                         f'{tuple(shape)} — config/weights mismatch')
    return t


def params_from_hf(tensors: Dict[str, torch.Tensor], cfg: LlamaConfig,
                   dtype: Optional[torch.dtype] = None,
                   device='cpu') -> Params:
    """Map HF tensor names onto the port's stacked-layer tree on
    ``device``. ``dtype``: a cast target (torch.float32 for training's
    masters, say); None keeps each tensor's stored dtype. Consumes
    ``tensors``; what is left unused is logged."""
    D, F, hd = cfg.dim, cfg.ffn_dim, cfg.hd
    H, KH, L, V = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers, cfg.vocab_size

    def put(t: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        t = t.to(device)
        t = t.t() if transpose else t
        return t.to(dtype) if dtype is not None else t

    def one(key: str, shape, transpose: bool = False) -> torch.Tensor:
        src = _expect(tensors, key, shape)
        out = put(src, transpose).contiguous()
        # Never hand back the file's memory map itself.
        return out.clone() if out.data_ptr() == src.data_ptr() else out

    def stack(fmt: str, shape, transpose: bool = False) -> torch.Tensor:
        return torch.stack([put(_expect(tensors, fmt.format(i=i), shape),
                                transpose) for i in range(L)])

    p = 'model.layers.{i}.'
    params: Params = {
        'embed': one('model.embed_tokens.weight', (V, D)),
        'layers': {
            'attn_norm': stack(p + 'input_layernorm.weight', (D,)),
            'wq': stack(p + 'self_attn.q_proj.weight', (H * hd, D), True),
            'wk': stack(p + 'self_attn.k_proj.weight', (KH * hd, D), True),
            'wv': stack(p + 'self_attn.v_proj.weight', (KH * hd, D), True),
            'wo': stack(p + 'self_attn.o_proj.weight', (D, H * hd), True),
        },
        'final_norm': one('model.norm.weight', (D,)),
    }
    if isinstance(cfg, MoEConfig):
        # Mixtral: a router a layer and per-expert SwiGLU (w1 = gate,
        # w3 = up, w2 = down in HF naming), stacked [L, E, in, out].
        E = cfg.n_experts

        def experts(name: str, shape) -> torch.Tensor:
            return torch.stack([torch.stack([
                put(_expect(tensors, f'model.layers.{i}.block_sparse_moe.'
                                     f'experts.{e}.{name}.weight', shape),
                    True) for e in range(E)]) for i in range(L)])

        params['layers'].update({
            'moe_norm': stack(p + 'post_attention_layernorm.weight', (D,)),
            'router': stack(p + 'block_sparse_moe.gate.weight', (E, D),
                            True),
            'w_gate': experts('w1', (F, D)),
            'w_up': experts('w3', (F, D)),
            'w_down': experts('w2', (D, F)),
        })
    else:
        params['layers'].update({
            'mlp_norm': stack(p + 'post_attention_layernorm.weight', (D,)),
            'w_gate': stack(p + 'mlp.gate_proj.weight', (F, D), True),
            'w_up': stack(p + 'mlp.up_proj.weight', (F, D), True),
            'w_down': stack(p + 'mlp.down_proj.weight', (D, F), True),
        })
    if cfg.qkv_bias:
        params['layers']['bq'] = stack(p + 'self_attn.q_proj.bias',
                                       (H * hd,))
        params['layers']['bk'] = stack(p + 'self_attn.k_proj.bias',
                                       (KH * hd,))
        params['layers']['bv'] = stack(p + 'self_attn.v_proj.bias',
                                       (KH * hd,))
    if not cfg.tie_embeddings:
        params['lm_head'] = one('lm_head.weight', (V, D), True)
    else:
        # Some exports store lm_head even when it is tied.
        tensors.pop('lm_head.weight', None)
    if tensors:
        logger.warning('HF import: %d unused tensors (e.g. %s) — ignored.',
                       len(tensors), sorted(tensors)[:8])
    return params


def load_hf_config(hf_dir: str) -> LlamaConfig:
    """The config alone (no tensor is read): for callers that need the
    architecture before deciding whether to load weights."""
    hf_dir = os.path.expanduser(hf_dir)
    cfg_path = os.path.join(hf_dir, 'config.json')
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(f'{cfg_path} not found — --hf-dir must '
                                f'point at an HF checkpoint directory.')
    with open(cfg_path, 'r', encoding='utf-8') as f:
        return config_from_hf(json.load(f))


def load_hf_checkpoint(hf_dir: str, dtype: Optional[torch.dtype] = None,
                       device='cpu') -> Tuple[LlamaConfig, Params]:
    """(config, params on ``device``) from an HF checkpoint directory.

        python -m skypilot_tpu_torch.serve.engine --hf-dir /path/to/ckpt
    """
    cfg = load_hf_config(hf_dir)
    hf_dir = os.path.expanduser(hf_dir)
    params = params_from_hf(_load_tensors(hf_dir), cfg, dtype=dtype,
                            device=device)
    n = sum(t.numel() for _, t in weights.tree_paths(params))
    logger.info('Imported HF checkpoint from %s: %s %.2fB params.', hf_dir,
                type(cfg).__name__, n / 1e9)
    return cfg, params


def hf_eos_ids(hf_dir: str) -> List[int]:
    """EOS token id(s) from generation_config.json, else config.json (HF
    stores an int or a list: llama-3 instruct lists both <|end_of_text|>
    and <|eot_id|>)."""
    for name in ('generation_config.json', 'config.json'):
        path = os.path.join(hf_dir, name)
        if not os.path.exists(path):
            continue
        with open(path, 'r', encoding='utf-8') as f:
            eos = json.load(f).get('eos_token_id')
        if eos is None:
            continue
        return list(eos) if isinstance(eos, list) else [int(eos)]
    return []
