"""The port's training loop: config → (resume|init) → step loop →
checkpoints (port of skypilot_tpu/train/trainer.py on one card).

    python -m skypilot_tpu_torch.train.trainer --model llama-1b \\
        --batch-size 4 --seq-len 2048 --steps 100 --ckpt-dir ./ck

    python -m skypilot_tpu_torch.train.trainer --hf-dir ./Llama-3.2-1B \\
        --batch-size 4 --seq-len 2048 --steps 100 --ckpt-dir ./ft

Step-indexed input (data_service/spec.py: the synthetic stream, or a
corpus with ``--data``), periodic async checkpoints in the JAX
package's format, resume from the newest step, and a final save on
SIGTERM (a spot preemption notice). Every family the port serves
trains: dense Llama/Qwen2 and Gemma, MoE and MLA/DeepSeek (their router
aux joins the loss; train/train_lib.py). ``--hf-dir`` fine-tunes an HF
checkpoint (models/hf_import.py): its config replaces the preset (the
overrides still apply), and its weights, read in fp32 as the masters,
start a fresh run only; a resumed run restores its own checkpoint and
never reads them. The trainer runs on the card (``--device cuda``, the
default) and raises without one; tests pass ``device='cpu'``.

Not ported yet, and refused by name: meshes (``--mesh``), LoRA,
``--sft-data`` and ``--data-service``. Failpoints, spans and the
batch-wait histogram wait for a later slice too (ROADMAP Queue 1 item
5).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import signal
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

from skypilot_tpu_torch import config
from skypilot_tpu_torch.data import loader
from skypilot_tpu_torch.data_service import spec as spec_lib
from skypilot_tpu_torch.models import hf_import
from skypilot_tpu_torch.train import checkpoints, train_lib

logger = logging.getLogger('skypilot_tpu_torch.train.trainer')


@dataclasses.dataclass
class TrainerConfig:
    model: str = 'llama-debug'          # config.PRESETS name
    model_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    mesh: Dict[str, int] = dataclasses.field(default_factory=dict)
    batch_size: int = 8
    seq_len: int = 512
    total_steps: int = 100
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    log_every: int = 10
    data_path: Optional[str] = None     # None → synthetic tokens
    tokenizer: Optional[str] = None
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    # >0: also checkpoint whenever this many seconds passed since the
    # last save (the preemption-exposure bound on spot capacity).
    ckpt_time_interval: float = 0.0
    # >1: split each global batch into this many microbatches, run one
    # after another before one update (same update, less memory).
    grad_accum_steps: int = 1
    eval_data_path: Optional[str] = None
    eval_every: int = 50
    eval_batches: int = 8
    lora_rank: int = 0
    hf_dir: Optional[str] = None
    sft_data_path: Optional[str] = None
    data_service: Optional[str] = None
    device: str = 'cuda'


# What the JAX trainer has and the port does not yet, each with the
# ROADMAP Queue 1 item that brings it.
_UNPORTED = (
    ('mesh', '--mesh', 'item 8 (parallelism and multi-process)'),
    ('lora_rank', '--lora-rank (LoRA)', 'item 7 (fine-tuning and RL)'),
    ('sft_data_path', '--sft-data', 'item 5 (training: SFT data)'),
    ('data_service', '--data-service',
     'item 5 (training: the data-service client)'),
)


def _refuse_unported(tcfg: TrainerConfig) -> None:
    for field, flag, item in _UNPORTED:
        if getattr(tcfg, field):
            raise NotImplementedError(
                f'{flag} is not ported yet: it waits for ROADMAP Queue 1 '
                f'{item}')


class _PreemptionWatch(contextlib.AbstractContextManager):
    """SIGTERM (how a spot preemption notice reaches the task) → a flag
    the step loop checks at step boundaries, so the trainer writes one
    final checkpoint and exits cleanly. Installed only on the main
    thread (signal.signal raises elsewhere)."""

    def __init__(self):
        self._flag = threading.Event()
        self._prev = None

    def __enter__(self) -> '_PreemptionWatch':
        if threading.current_thread() is threading.main_thread():
            self._prev = signal.signal(
                signal.SIGTERM, lambda *_: self._flag.set())
        return self

    def __exit__(self, *exc) -> None:
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()


def _model_config(tcfg: TrainerConfig) -> config.LlamaConfig:
    cfg = config.get_config(tcfg.model)
    if tcfg.model_overrides:
        cfg = dataclasses.replace(cfg, **tcfg.model_overrides)
    return cfg


def _batch_iter(tcfg: TrainerConfig, vocab_size: int, start_step: int,
                device) -> Iterator[Dict[str, torch.Tensor]]:
    source = spec_lib.load_source(spec_lib.DatasetSpec(
        batch_size=tcfg.batch_size, seq_len=tcfg.seq_len,
        vocab_size=vocab_size, data_path=tcfg.data_path,
        tokenizer=tcfg.tokenizer))
    step = start_step
    while True:
        yield loader.to_device(source.batch_at_step(step), device)
        step += 1


def train(tcfg: TrainerConfig,
          params: Optional[train_lib.Params] = None) -> List[Dict[str, float]]:
    """Run the loop; returns the per-log-interval records (loss, grad
    norm, seconds per step, eval loss). ``params`` seeds a fresh run (no
    checkpoint to resume): bridged JAX params, say; default the
    ``hf_dir`` checkpoint's weights, else random from seed 0. The run
    updates them in place."""
    _refuse_unported(tcfg)
    device = torch.device(tcfg.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the trainer runs on the card '
                           "unless device='cpu' is asked for")
    load_base = None
    if tcfg.hf_dir:
        if params is not None:
            raise ValueError('params and hf_dir both seed the run: pass '
                             'one')
        cfg = hf_import.load_hf_config(tcfg.hf_dir)
        if tcfg.model_overrides:
            cfg = dataclasses.replace(cfg, **tcfg.model_overrides)
        logger.info('--hf-dir given: model config from %s (preset %r '
                    'ignored).', tcfg.hf_dir, tcfg.model)

        def load_base():
            # fp32: the optimizer's masters.
            return hf_import.load_hf_checkpoint(
                tcfg.hf_dir, dtype=torch.float32, device=device)[1]
    else:
        cfg = _model_config(tcfg)
    config.check_supported(cfg)
    if tcfg.batch_size % tcfg.grad_accum_steps != 0:
        raise ValueError(f'batch_size={tcfg.batch_size} must be divisible '
                         f'by grad_accum_steps={tcfg.grad_accum_steps}')
    tx = train_lib.default_optimizer(learning_rate=tcfg.learning_rate,
                                     warmup_steps=tcfg.warmup_steps,
                                     total_steps=tcfg.total_steps)
    ckpt = None
    start_step = 0
    if load_base is not None and (
            not tcfg.ckpt_dir or
            checkpoints.Checkpointer(tcfg.ckpt_dir).latest_step() is None):
        params = load_base()
    if tcfg.ckpt_dir:
        state, start_step, ckpt = checkpoints.restore_or_init(
            tcfg.ckpt_dir, cfg, tx, device, params)
    else:
        state = train_lib.init_train_state(cfg, tx, device, params=params)
    step_fn = train_lib.make_train_step(cfg, tx, tcfg.grad_accum_steps)
    batches = _batch_iter(tcfg, cfg.vocab_size, start_step, device)

    eval_fn = None
    if tcfg.eval_data_path:
        eval_tokens = loader.load_tokens(tcfg.eval_data_path, tcfg.tokenizer)
        eval_step = train_lib.make_eval_step(cfg)

        def eval_fn() -> float:
            # Fixed batches 0..K-1 of the eval corpus: comparable across
            # steps and across resumed runs.
            total = 0.0
            for i in range(tcfg.eval_batches):
                eb = loader.batch_at_step(eval_tokens, i, tcfg.batch_size,
                                          tcfg.seq_len)
                total += float(eval_step(state.params, loader.to_device(
                    {'tokens': eb}, device)))
            return total / tcfg.eval_batches

    history: List[Dict[str, float]] = []
    t_last = time.perf_counter()
    t_last_save = time.monotonic()
    steps_since_log = 0
    try:
        with _PreemptionWatch() as watch:
            for step in range(start_step, tcfg.total_steps):
                state, metrics = step_fn(state, next(batches))
                steps_since_log += 1
                do_log = ((step + 1) % tcfg.log_every == 0 or
                          step + 1 == tcfg.total_steps)
                do_eval = (eval_fn is not None and
                           (step + 1) % tcfg.eval_every == 0)
                if do_log or do_eval:
                    rec = {'step': step + 1}
                    if do_log:
                        loss = float(metrics['loss'])   # device sync point
                        now = time.perf_counter()
                        rec.update(loss=round(loss, 4),
                                   grad_norm=round(
                                       float(metrics['grad_norm']), 4),
                                   sec_per_step=round(
                                       (now - t_last) / steps_since_log, 4))
                    if do_eval:
                        rec['eval_loss'] = round(eval_fn(), 4)
                    t_last = time.perf_counter()    # exclude eval time
                    steps_since_log = 0
                    history.append(rec)
                    logger.info(json.dumps(rec))
                save_due = (step + 1) % tcfg.ckpt_every == 0 or (
                    tcfg.ckpt_time_interval > 0 and
                    time.monotonic() - t_last_save >= tcfg.ckpt_time_interval)
                if ckpt is not None and save_due:
                    ckpt.save(state, step + 1)
                    t_last_save = time.monotonic()
                if watch.preempted:
                    # Preemption notice: one synchronous final save.
                    if ckpt is not None:
                        ckpt.save(state, step + 1, wait=True)
                    logger.info(json.dumps(
                        {'step': step + 1, 'preempted': True,
                         'final_checkpoint': ckpt is not None}))
                    return history
            if ckpt is not None:
                ckpt.save(state, tcfg.total_steps)
    finally:
        if ckpt is not None:
            ckpt.close()     # async saves are durable before we return
    return history


def _parse_kv(items: List[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for item in items:
        k, v = item.split('=', 1)
        for cast in (int, float):
            try:
                out[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            out[k] = v
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog='skypilot_tpu_torch.train.trainer')
    parser.add_argument('--model', default='llama-debug')
    parser.add_argument('--model-override', action='append', default=[],
                        help='key=value on the model config (repeatable).')
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--seq-len', type=int, default=512)
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--lr', type=float, default=3e-4)
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--data', default=None)
    parser.add_argument('--tokenizer', default=None)
    parser.add_argument('--ckpt-dir', default=None)
    parser.add_argument('--ckpt-every', type=int, default=50)
    parser.add_argument('--ckpt-time-interval', type=float, default=0.0,
                        help='>0: also checkpoint every N seconds.')
    parser.add_argument('--grad-accum', type=int, default=1,
                        help='Accumulate grads over N microbatches per '
                             'optimizer step (lower peak memory).')
    parser.add_argument('--eval-data', default=None)
    parser.add_argument('--eval-every', type=int, default=50)
    parser.add_argument('--eval-batches', type=int, default=8)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'.")
    parser.add_argument('--hf-dir', default=None,
                        help='HF checkpoint to fine-tune from (config and '
                             'base weights; the preset is ignored).')
    # Flags of the JAX trainer that the port refuses by name.
    parser.add_argument('--mesh', default='')
    parser.add_argument('--lora-rank', type=int, default=0)
    parser.add_argument('--sft-data', default=None)
    parser.add_argument('--data-service', default=None)
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    args = build_parser().parse_args(argv)
    mesh = {}
    if args.mesh:
        for part in args.mesh.split(','):
            k, v = part.split('=')
            mesh[k] = int(v)
    train(TrainerConfig(
        model=args.model, model_overrides=_parse_kv(args.model_override),
        mesh=mesh, batch_size=args.batch_size, seq_len=args.seq_len,
        total_steps=args.steps, learning_rate=args.lr,
        log_every=args.log_every,
        data_path=args.data, tokenizer=args.tokenizer,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        ckpt_time_interval=args.ckpt_time_interval,
        grad_accum_steps=args.grad_accum, eval_data_path=args.eval_data,
        eval_every=args.eval_every, eval_batches=args.eval_batches,
        lora_rank=args.lora_rank, hf_dir=args.hf_dir,
        sft_data_path=args.sft_data, data_service=args.data_service,
        device=args.device))


if __name__ == '__main__':
    main()
