"""Fold trained LoRA adapters into base weights for serving (port of
skypilot_tpu/train/lora_merge.py).

    python -m skypilot_tpu_torch.train.lora_merge \\
        --hf-dir ~/ckpts/Llama-3.2-1B --lora-dir ~/ft/adapters \\
        --out ~/ft/merged

The output is an HF checkpoint directory (weights and the base's
tokenizer sidecars), written by the port's own exporter
(models/hf_export.py), which is what gets served. The merge runs on the
card unless ``--device cpu`` is asked for; the base keeps its stored
dtype (the merge itself is fp32, inside ``lora.merge_into``), so the
merged directory is the base's size.
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import List, Optional

import torch

from skypilot_tpu_torch.config import LlamaConfig
from skypilot_tpu_torch.models import hf_export, hf_import
from skypilot_tpu_torch.train import lora

logger = logging.getLogger('skypilot_tpu_torch.train.lora_merge')


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='skypilot_tpu_torch.train.lora_merge')
    parser.add_argument('--hf-dir', required=True,
                        help='Base HF checkpoint the adapters were trained '
                             'against.')
    parser.add_argument('--lora-dir', required=True,
                        help='Directory holding adapters.npz and lora.json '
                             '(trainer --lora-dir).')
    parser.add_argument('--out', required=True,
                        help='Output HF checkpoint directory.')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'.")
    return parser


def merge(hf_dir: str, lora_dir: str, out: str, device='cuda') -> str:
    """Load the base at its stored dtype onto ``device``, merge the
    adapters of ``lora_dir`` into it and export ``out``; returns the
    output directory. A family the exporter does not write (anything
    but dense Llama/Qwen2) is refused before any weight is read."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: lora_merge runs on the card '
                           'unless --device cpu is asked for')
    cfg = hf_import.load_hf_config(hf_dir)
    if type(cfg) is not LlamaConfig:
        raise SystemExit(
            f'lora_merge exports the dense Llama/Qwen2 family only; '
            f'{hf_dir} is {type(cfg).__name__}. (Serve MoE LoRA runs by '
            f'loading base + adapters directly.)')
    t0 = time.perf_counter()
    cfg, base = hf_import.load_hf_checkpoint(hf_dir, device=device)
    adapters, lcfg, step, _ = lora.load_adapters(lora_dir, device)
    with torch.no_grad():
        merged = lora.merge_into(base, adapters, lcfg)
    out = hf_export.save_hf_checkpoint(merged, cfg, out, source_dir=hf_dir)
    logger.info('Merged rank-%d adapters (step %d) into %s in %.1fs; serve '
                'with --hf-dir %s', lcfg.rank, step, out,
                time.perf_counter() - t0, out)
    return out


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    args = build_parser().parse_args(argv)
    merge(args.hf_dir, args.lora_dir, args.out, args.device)


if __name__ == '__main__':
    main()
