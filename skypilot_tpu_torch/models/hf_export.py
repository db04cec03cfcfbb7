"""HF checkpoint export: the port's param tree → a safetensors directory
(port of skypilot_tpu/models/hf_export.py: ``_SIDECARS``,
``hf_tensors_from_params``, ``save_hf_checkpoint``,
``_minimal_hf_config``).

The inverse of models/hf_import.py ``params_from_hf``: un-stack the
leading [L] axis and transpose each projection back to torch's [out,
in], then write one ``model.safetensors`` with the port's own codec
(models/safetensors_io.py), each tensor in the dtype it has. Only the
dense Llama/Qwen2 families round-trip, as in JAX; anything else is
refused.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
from typing import Any, Dict, Optional

import torch

from skypilot_tpu_torch.config import LlamaConfig
from skypilot_tpu_torch.models import safetensors_io

logger = logging.getLogger(__name__)

# Sidecars copied verbatim from the source checkpoint when present: the
# tokenizer and the generation config make the exported dir servable.
_SIDECARS = ('config.json', 'generation_config.json', 'tokenizer.json',
             'tokenizer_config.json', 'special_tokens_map.json')


def hf_tensors_from_params(params, cfg: LlamaConfig
                           ) -> Dict[str, torch.Tensor]:
    """Flat HF-named tensors (torch layouts), on the params' device, in
    their dtypes, from the port's tree."""
    lay = params['layers']
    out: Dict[str, torch.Tensor] = {
        'model.embed_tokens.weight': params['embed'].detach(),
        'model.norm.weight': params['final_norm'].detach(),
    }

    def unstack(name: str, stacked: torch.Tensor, transpose: bool) -> None:
        for i in range(cfg.n_layers):
            t = stacked[i].detach()
            out[f'model.layers.{i}.{name}'] = (t.t().contiguous()
                                               if transpose else t)

    unstack('input_layernorm.weight', lay['attn_norm'], False)
    unstack('self_attn.q_proj.weight', lay['wq'], True)
    unstack('self_attn.k_proj.weight', lay['wk'], True)
    unstack('self_attn.v_proj.weight', lay['wv'], True)
    unstack('self_attn.o_proj.weight', lay['wo'], True)
    unstack('post_attention_layernorm.weight', lay['mlp_norm'], False)
    unstack('mlp.gate_proj.weight', lay['w_gate'], True)
    unstack('mlp.up_proj.weight', lay['w_up'], True)
    unstack('mlp.down_proj.weight', lay['w_down'], True)
    if cfg.qkv_bias:
        unstack('self_attn.q_proj.bias', lay['bq'], False)
        unstack('self_attn.k_proj.bias', lay['bk'], False)
        unstack('self_attn.v_proj.bias', lay['bv'], False)
    if not cfg.tie_embeddings:
        out['lm_head.weight'] = params['lm_head'].detach().t().contiguous()
    return out


def save_hf_checkpoint(params, cfg: LlamaConfig, out_dir: str,
                       source_dir: Optional[str] = None) -> str:
    """Write ``out_dir`` as an HF checkpoint directory: one
    ``model.safetensors`` (written to a temp file, then renamed into
    place) and the sidecars of ``source_dir`` when given; without a
    source ``config.json``, a minimal one is made from ``cfg`` (the
    tokenizer must then come from elsewhere)."""
    if type(cfg) is not LlamaConfig:
        raise ValueError(
            f'HF export supports the dense Llama/Qwen2 family only, got '
            f'{type(cfg).__name__} (the families hf_import reads).')
    out_dir = os.path.abspath(os.path.expanduser(out_dir))
    os.makedirs(out_dir, exist_ok=True)
    tensors = hf_tensors_from_params(params, cfg)
    tmp = os.path.join(out_dir, '.model.safetensors.tmp')
    safetensors_io.save_file(tensors, tmp, metadata={'format': 'pt'})
    os.replace(tmp, os.path.join(out_dir, 'model.safetensors'))

    copied = set()
    if source_dir:
        source_dir = os.path.abspath(os.path.expanduser(source_dir))
        for name in _SIDECARS:
            src = os.path.join(source_dir, name)
            if os.path.exists(src):
                shutil.copy2(src, os.path.join(out_dir, name))
                copied.add(name)
    if 'config.json' not in copied:
        with open(os.path.join(out_dir, 'config.json'), 'w',
                  encoding='utf-8') as f:
            json.dump(_minimal_hf_config(cfg), f, indent=1)
    n = sum(t.numel() for t in tensors.values())
    logger.info('Exported HF checkpoint to %s: %.2fB params, %d tensors.',
                out_dir, n / 1e9, len(tensors))
    return out_dir


def _minimal_hf_config(cfg: LlamaConfig) -> Dict[str, Any]:
    arch = 'Qwen2ForCausalLM' if cfg.qkv_bias else 'LlamaForCausalLM'
    out: Dict[str, Any] = {
        'architectures': [arch],
        'vocab_size': cfg.vocab_size,
        'hidden_size': cfg.dim,
        'num_hidden_layers': cfg.n_layers,
        'num_attention_heads': cfg.n_heads,
        'num_key_value_heads': cfg.n_kv_heads,
        'intermediate_size': cfg.ffn_dim,
        'rope_theta': cfg.rope_theta,
        'rms_norm_eps': cfg.rms_eps,
        'max_position_embeddings': cfg.max_seq_len,
        'tie_word_embeddings': cfg.tie_embeddings,
        'head_dim': cfg.hd,
    }
    if cfg.rope_scaling:
        # A RopeScaling dataclass after LlamaConfig.__post_init__.
        rs = (dataclasses.asdict(cfg.rope_scaling)
              if dataclasses.is_dataclass(cfg.rope_scaling)
              else dict(cfg.rope_scaling))
        rope_type = rs.get('rope_type', 'llama3')
        if rope_type == 'llama3':
            out['rope_scaling'] = {
                'rope_type': 'llama3',
                'factor': rs['factor'],
                'low_freq_factor': rs.get('low_freq_factor', 1.0),
                'high_freq_factor': rs.get('high_freq_factor', 4.0),
                'original_max_position_embeddings':
                    rs.get('original_max_position', 8192),
            }
        elif rope_type == 'yarn':
            # beta and attention_factor must round-trip: transformers'
            # defaults differ by model, and wrong betas load cleanly and
            # compute other RoPE frequencies.
            out['rope_scaling'] = {
                'rope_type': 'yarn',
                'factor': rs['factor'],
                'beta_fast': rs.get('beta_fast', 32.0),
                'beta_slow': rs.get('beta_slow', 1.0),
                'original_max_position_embeddings':
                    rs.get('original_max_position', 8192),
            }
            if rs.get('attention_factor') is not None:
                out['rope_scaling']['attention_factor'] = \
                    rs['attention_factor']
        else:
            raise NotImplementedError(
                f'HF export for rope_type {rope_type!r} is not wired; '
                f"supported: 'llama3', 'yarn'.")
    return out
