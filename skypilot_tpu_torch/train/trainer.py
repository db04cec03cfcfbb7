"""The port's training loop: config → (resume|init) → step loop →
checkpoints (port of skypilot_tpu/train/trainer.py on one card).

    python -m skypilot_tpu_torch.train.trainer --model llama-1b \\
        --batch-size 4 --seq-len 2048 --steps 100 --ckpt-dir ./ck

    python -m skypilot_tpu_torch.train.trainer --hf-dir ./Llama-3.2-1B \\
        --batch-size 4 --seq-len 2048 --steps 100 --ckpt-dir ./ft

    python -m skypilot_tpu_torch.train.trainer --hf-dir ./Llama-3.2-1B \\
        --lora-rank 16 --lora-dir ./adapters --batch-size 4 --seq-len 2048

    python -m skypilot_tpu_torch.train.trainer --hf-dir ./Llama-3.2-1B \\
        --sft-data chats.jsonl --lora-rank 16 --lora-dir ./adapters

    # One process per node of a gang (SkyPilot sets the three variables);
    # with no --mesh the params are fully sharded over every rank (fsdp):
    SKYTPU_COORDINATOR_ADDRESS=host0:8476 SKYTPU_NUM_PROCESSES=4 \\
    SKYTPU_NODE_RANK=$RANK python -m skypilot_tpu_torch.train.trainer \\
        --model llama3-8b --batch-size 8 --seq-len 2048

    SKYTPU_COORDINATOR_ADDRESS=host0:8476 SKYTPU_NUM_PROCESSES=2 \\
    SKYTPU_NODE_RANK=$RANK python -m skypilot_tpu_torch.train.trainer \\
        --model llama-1b --mesh sequence=2 --seq-len 65536 \\
        --model-override attention_impl=ring \\
        --model-override ring_layout=zigzag

Step-indexed input (data_service/spec.py: the synthetic stream, a corpus
with ``--data``, or chat conversations with ``--sft-data``, trained on
the assistant turns alone: data/sft.py), periodic async checkpoints in
the JAX package's format, resume from the newest step, and a final save
on SIGTERM (a spot preemption notice, or the ``trainer.preempt``
failpoint). Every family the port serves
trains: dense Llama/Qwen2 and Gemma, MoE and MLA/DeepSeek (their router
aux joins the loss; train/train_lib.py). ``--hf-dir`` fine-tunes an HF
checkpoint (models/hf_import.py): its config replaces the preset (the
overrides still apply), and its weights, read in fp32 as the masters,
start a fresh run only; a resumed run restores its own checkpoint and
never reads them. ``--lora-rank`` trains LoRA adapters over a frozen
base (train/lora.py): the base is the ``--hf-dir`` checkpoint at its
stored dtype, else the preset's seed-0 init; adapters, moments and step
save to and resume from ``--lora-dir`` (exclusive with ``--ckpt-dir``
and ``--grad-accum``, as in JAX); evaluation runs on the merged params.
``--sft-data`` with ``--hf-dir`` and no ``--tokenizer`` tokenizes with
the directory's tokenizer.json, which must exist: an HF fine-tune never
falls back to bytes. The trainer runs on the card (``--device cuda``,
the default) and raises without one; tests pass ``device='cpu'``.

Several processes: :func:`maybe_init_distributed` joins the gang that
SkyPilot's launch describes in ``SKYTPU_COORDINATOR_ADDRESS``,
``SKYTPU_NUM_PROCESSES`` and ``SKYTPU_NODE_RANK`` (the JAX trainer's
names; the backend from ``SKYTPU_TORCH_DIST_BACKEND``, parallel/mesh.py),
and ``--mesh`` lays the ranks out as in JAX: with none, JAX's
``MeshSpec()``, every rank on 'fsdp'. The port splits the batch over
('data', 'fsdp'), shards the params and their moments over 'fsdp'
(each rank draws, restores and updates only its shards:
train/train_lib.py), and splits the sequence over 'sequence' (ring
attention, ``--model-override attention_impl=ring``), so
``data=2,fsdp=2`` and ``fsdp=2,sequence=2`` train too; a mesh whose
'tensor', 'expert' or 'stage' comes to more than 1 is refused by name.
The batch must divide over data*fsdp, as in JAX. Every rank saves and
restores its own slices of each checkpoint (train/checkpoints.py);
rank 0 alone writes the log records, and at the end every rank checks
that the ranks holding the same shards ('data' and 'sequence'
replicas) hold the same bits (one ``replica`` record a rank: its
shard's digest and its peak memory).

Not ported yet, and refused by name: ``--data-service``, and
``--lora-rank`` on a mesh. The train.batch_wait span and the
batch-wait histogram wait for a later slice too (ROADMAP Queue 1 item
5).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import logging
import os
import signal
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

from skypilot_tpu_torch import config
from skypilot_tpu_torch.data import loader
from skypilot_tpu_torch.data_service import spec as spec_lib
from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.models import hf_import, module_for
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.train import checkpoints, lora, train_lib
from skypilot_tpu_torch.utils import failpoints, knobs

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
    lora_alpha: float = 32.0
    lora_targets: Optional[List[str]] = None    # None → lora.DEFAULT_TARGETS
    hf_dir: Optional[str] = None
    lora_dir: Optional[str] = None
    # Chat JSONL: train on the assistant turns (data/sft.py); exclusive
    # with data_path. chat_family None: the tokenizer's own.
    sft_data_path: Optional[str] = None
    chat_family: Optional[str] = None
    data_service: Optional[str] = None
    device: str = 'cuda'


# What the JAX trainer has and the port does not yet, each with the
# ROADMAP Queue 1 item that brings it.
_UNPORTED = (
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
    """SIGTERM (how a spot preemption notice reaches the task) and the
    deterministic ``trainer.preempt`` failpoint (chaos schedules) → a
    flag the step loop checks at step boundaries, so the trainer (or the
    rollout learner) writes one final checkpoint and exits cleanly.
    Installed only on the main thread (signal.signal raises
    elsewhere)."""

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
        if self._flag.is_set():
            return True
        if failpoints.ACTIVE:
            try:
                failpoints.fire('trainer.preempt')
            except failpoints.FailpointError:
                self._flag.set()
                return True
        return False


def maybe_init_distributed(device: torch.device) -> torch.device:
    """Join the gang's torch.distributed world when the launch made one
    (``SKYTPU_COORDINATOR_ADDRESS`` set and ``SKYTPU_NUM_PROCESSES`` >
    1, this process ``SKYTPU_NODE_RANK``, the JAX trainer's knobs).
    Returns this rank's device: on the card ``cuda:(LOCAL_RANK or 0) %
    device_count``."""
    coordinator = knobs.get_str('SKYTPU_COORDINATOR_ADDRESS')
    num_procs = knobs.get_int('SKYTPU_NUM_PROCESSES')
    device = mesh_lib.rank_device(device)
    if coordinator and num_procs > 1 and not dist.is_initialized():
        mesh_lib.init_distributed(coordinator, num_procs,
                                  knobs.get_int('SKYTPU_NODE_RANK'), device)
    return device


def _build_mesh(tcfg: TrainerConfig,
                cfg: config.LlamaConfig) -> mesh_lib.Mesh:
    """``--mesh`` over the world (JAX's ``MeshSpec(**mesh)``; default
    ``MeshSpec()``: 'fsdp' over every rank), refused
    (``train_lib.check_mesh``) before any process group is made where
    the port's step cannot run on it."""
    spec = mesh_lib.MeshSpec(**tcfg.mesh) if tcfg.mesh else \
        mesh_lib.MeshSpec()
    world = dist.get_world_size() if dist.is_initialized() else 1
    train_lib.check_mesh(cfg, mesh_lib.Mesh(spec.sizes(world), 0))
    return mesh_lib.build_mesh(spec)


def params_sha256(params: train_lib.Params) -> str:
    """sha256 of the params' bytes, leaf by leaf in the JAX tree order:
    equal on two ranks exactly when they hold the same bits (on an fsdp
    mesh each rank digests its own shards)."""
    h = hashlib.sha256()
    for leaf in train_lib.leaves(params):
        h.update(leaf.detach().contiguous().cpu().numpy().data)
    return h.hexdigest()


def check_replicas(params: train_lib.Params, device,
                   mesh: mesh_lib.Mesh) -> Dict[str, Any]:
    """Every rank's params digest, peak memory and kernel launches, as
    this rank's ``replica`` record; raises on every rank when two ranks
    that hold the same shards (one 'fsdp' index, the 'data' and
    'sequence' replicas) hold different bits."""
    digest = params_sha256(params)
    seen: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(seen, (mesh.coords['fsdp'], digest))
    rec = {'replica': dist.get_rank(), 'fsdp_index': mesh.coords['fsdp'],
           'params_sha256': digest,
           'kernel_launches': {n: k.launches
                               for n, k in build.kernels().items()}}
    if torch.device(device).type == 'cuda':
        rec['peak_memory_gb'] = round(
            torch.cuda.max_memory_allocated(device) / 1e9, 3)
    logger.info(json.dumps(rec))
    by_shard: Dict[int, set] = {}
    for index, d in seen:
        by_shard.setdefault(index, set()).add(d)
    if any(len(d) > 1 for d in by_shard.values()):
        raise RuntimeError(f'replicated params differ across ranks: '
                           f'(fsdp index, sha256) by rank {seen}')
    return rec


def _model_config(tcfg: TrainerConfig) -> config.LlamaConfig:
    cfg = config.get_config(tcfg.model)
    if tcfg.model_overrides:
        cfg = dataclasses.replace(cfg, **tcfg.model_overrides)
    return cfg


def _dataset_spec(tcfg: TrainerConfig,
                  vocab_size: int) -> spec_lib.DatasetSpec:
    """The trainer's input pipeline. With --sft-data and --hf-dir but no
    --tokenizer, the directory's tokenizer.json: load_tokenizer then
    raises if it is missing, rather than training the checkpoint on
    bytes."""
    tokenizer = tcfg.tokenizer
    if tcfg.sft_data_path and tokenizer is None and tcfg.hf_dir:
        tokenizer = os.path.join(os.path.expanduser(tcfg.hf_dir),
                                 'tokenizer.json')
    return spec_lib.DatasetSpec(
        batch_size=tcfg.batch_size, seq_len=tcfg.seq_len,
        vocab_size=vocab_size, data_path=tcfg.data_path,
        tokenizer=tokenizer, sft_data_path=tcfg.sft_data_path,
        chat_family=tcfg.chat_family)


def _batch_iter(tcfg: TrainerConfig, vocab_size: int, start_step: int,
                device, mesh: mesh_lib.Mesh
                ) -> Iterator[Dict[str, torch.Tensor]]:
    source = spec_lib.load_source(_dataset_spec(tcfg, vocab_size))
    step = start_step
    while True:
        yield loader.shard_batch(source.batch_at_step(step), mesh, device)
        step += 1


def train(tcfg: TrainerConfig,
          params: Optional[train_lib.Params] = None) -> List[Dict[str, float]]:
    """Run the loop; returns the per-log-interval records (loss, grad
    norm, seconds per step, eval loss). ``params`` seeds a fresh run (no
    checkpoint to resume): bridged JAX params, say; default the
    ``hf_dir`` checkpoint's weights, else random from seed 0. The run
    updates them in place. With ``lora_rank`` they are the frozen base,
    read only."""
    _refuse_unported(tcfg)
    device = torch.device(tcfg.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the trainer runs on the card '
                           "unless device='cpu' is asked for")
    owns_world = not dist.is_initialized()
    device = maybe_init_distributed(device)
    owns_world = owns_world and dist.is_initialized()
    try:
        return _train(tcfg, params, device)
    finally:
        if owns_world:
            dist.destroy_process_group()


def _train(tcfg: TrainerConfig, params: Optional[train_lib.Params],
           device: torch.device) -> List[Dict[str, float]]:
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
    mesh = _build_mesh(tcfg, cfg)
    multi = mesh.size > 1
    lead = mesh.rank == 0      # writes the log records
    if tcfg.sft_data_path and tcfg.data_path:
        raise ValueError('--sft-data and --data are exclusive (chat SFT vs '
                         'plain-corpus LM).')
    lora_mode = tcfg.lora_rank > 0
    if lora_mode and tcfg.ckpt_dir:
        raise ValueError('--lora-rank and --ckpt-dir are exclusive: LoRA '
                         'persists adapters to --lora-dir instead.')
    if lora_mode and tcfg.grad_accum_steps > 1:
        raise ValueError('--grad-accum is not supported with --lora-rank '
                         'yet; lower --batch-size instead (LoRA peak '
                         'memory is dominated by activations, same as the '
                         'full step).')
    if multi and lora_mode:
        raise NotImplementedError(
            '--lora-rank on a mesh is not ported: LoRA and GRPO meshes '
            'wait for ROADMAP Queue 1 item 8 (parallelism)')
    batch_shards = mesh.shape['data'] * mesh.shape['fsdp']
    if tcfg.batch_size % batch_shards != 0:
        raise ValueError(
            f'batch_size={tcfg.batch_size} must be divisible by '
            f'data*fsdp={batch_shards} (the batch-dim mesh axes).')
    local_rows = tcfg.batch_size // batch_shards
    if local_rows % tcfg.grad_accum_steps != 0:
        raise ValueError(f'batch_size={tcfg.batch_size} must be divisible '
                         f'by grad_accum_steps={tcfg.grad_accum_steps}'
                         + (f' on each of data*fsdp={batch_shards} ranks'
                            if batch_shards > 1 else ''))
    tx = train_lib.default_optimizer(learning_rate=tcfg.learning_rate,
                                     warmup_steps=tcfg.warmup_steps,
                                     total_steps=tcfg.total_steps)
    ckpt = None
    start_step = 0
    if lora_mode:
        lcfg = lora.LoRAConfig(
            rank=tcfg.lora_rank, alpha=tcfg.lora_alpha,
            targets=tuple(tcfg.lora_targets or lora.DEFAULT_TARGETS))
        if tcfg.hf_dir:
            # The frozen base keeps its stored dtype: merge_into does
            # its math in fp32 and casts back.
            params = hf_import.load_hf_checkpoint(tcfg.hf_dir,
                                                  device=device)[1]
        elif params is None:
            params = module_for(cfg).init_params(
                cfg, torch.Generator(device=device).manual_seed(0), device)
        base = params
        if tcfg.lora_dir and os.path.exists(os.path.join(
                os.path.expanduser(tcfg.lora_dir), 'adapters.npz')):
            state = lora.resume_state(tx, tcfg.lora_dir, lcfg, device)
            start_step = state.step
            logger.info('Resumed LoRA adapters at step %d from %s.',
                        start_step, tcfg.lora_dir)
        else:
            state = lora.init_lora_state(
                torch.Generator(device=device).manual_seed(1), base, lcfg,
                tx)
        lora_step = lora.make_lora_train_step(cfg, tx, lcfg)

        def step_fn(s, b):
            return lora_step(s, base, b)

        def eval_params():
            return lora.merge_into(base, state.adapters, lcfg)
    else:
        if load_base is not None and (
                not tcfg.ckpt_dir or
                checkpoints.Checkpointer(tcfg.ckpt_dir).latest_step() is None):
            params = load_base()
        if tcfg.ckpt_dir:
            state, start_step, ckpt = checkpoints.restore_or_init(
                tcfg.ckpt_dir, cfg, tx, device, params, mesh=mesh)
        else:
            state = train_lib.init_train_state(cfg, tx, device, params=params,
                                               mesh=mesh)
        step_fn = train_lib.make_train_step(cfg, tx, tcfg.grad_accum_steps,
                                            mesh)

        def eval_params():
            return state.params
    batches = _batch_iter(tcfg, cfg.vocab_size, start_step, device, mesh)
    # The router aux joins the record of a model that has one (its
    # means over the global batch: the same on every rank).
    has_aux = (not lora_mode and
               getattr(module_for(cfg), 'HAS_AUX', False))

    eval_fn = None
    if tcfg.eval_data_path:
        eval_tokens = loader.load_tokens(tcfg.eval_data_path, tcfg.tokenizer)
        eval_step = train_lib.make_eval_step(cfg, mesh)

        def eval_fn() -> float:
            # Fixed batches 0..K-1 of the eval corpus: comparable across
            # steps and across resumed runs.
            with torch.no_grad():
                p = eval_params()
            total = 0.0
            for i in range(tcfg.eval_batches):
                eb = loader.batch_at_step(eval_tokens, i, tcfg.batch_size,
                                          tcfg.seq_len)
                total += float(eval_step(p, loader.shard_batch(
                    {'tokens': eb}, mesh, device)))
            return total / tcfg.eval_batches

    def save_adapters() -> bool:
        if lora_mode and tcfg.lora_dir:
            lora.save_adapters(tcfg.lora_dir, state, lcfg)
            return True
        return False

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
                    rec: Dict[str, Any] = {'step': step + 1}
                    if do_log:
                        loss = float(metrics['loss'])   # device sync point
                        now = time.perf_counter()
                        rec.update(loss=round(loss, 4),
                                   grad_norm=round(
                                       float(metrics['grad_norm']), 4),
                                   sec_per_step=round(
                                       (now - t_last) / steps_since_log, 4))
                        if has_aux:
                            rec['aux'] = round(float(metrics['aux']), 6)
                    if do_eval:
                        rec['eval_loss'] = round(eval_fn(), 4)
                    t_last = time.perf_counter()    # exclude eval time
                    steps_since_log = 0
                    history.append(rec)
                    if lead:
                        logger.info(json.dumps(rec))
                timed_save = (
                    tcfg.ckpt_time_interval > 0 and
                    time.monotonic() - t_last_save >= tcfg.ckpt_time_interval)
                preempted = watch.preempted
                if multi:
                    # The ranks' clocks and signals differ: any rank's
                    # flag holds for all, so they save and stop together.
                    flags = torch.tensor([int(timed_save), int(preempted)],
                                         device=device)
                    dist.all_reduce(flags, op=dist.ReduceOp.MAX)
                    timed_save, preempted = (bool(f) for f in flags.tolist())
                save_due = (step + 1) % tcfg.ckpt_every == 0 or timed_save
                if ckpt is not None and save_due:
                    ckpt.save(state, step + 1)
                    t_last_save = time.monotonic()
                if save_due and save_adapters():
                    t_last_save = time.monotonic()
                if preempted:
                    # Preemption notice: one synchronous final save.
                    if ckpt is not None:
                        ckpt.save(state, step + 1, wait=True)
                    saved = save_adapters()
                    if lead:
                        logger.info(json.dumps(
                            {'step': step + 1, 'preempted': True,
                             'final_checkpoint': ckpt is not None or saved}))
                    return history
            if ckpt is not None:
                ckpt.save(state, tcfg.total_steps)
            if tcfg.total_steps % tcfg.ckpt_every != 0:
                # The in-loop cadence already saved on aligned totals.
                save_adapters()
        if multi:
            check_replicas(state.params, device, mesh)
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
    parser.add_argument('--lora-rank', type=int, default=0,
                        help='>0 trains LoRA adapters instead of full '
                             'params (train/lora.py).')
    parser.add_argument('--lora-alpha', type=float, default=32.0)
    parser.add_argument('--lora-targets', default=None,
                        help='Comma list of leaf names to adapt '
                             '(default: wq,wk,wv,wo).')
    parser.add_argument('--lora-dir', default=None,
                        help='Directory for adapters.npz (save/resume).')
    parser.add_argument('--sft-data', default=None,
                        help='JSONL of {"messages": [...]} conversations '
                             '(assistant-only loss, data/sft.py).')
    parser.add_argument('--chat-family', default=None,
                        choices=('llama3', 'chatml', 'plain'),
                        help="Chat template (default: from the "
                             "tokenizer's special tokens).")
    parser.add_argument('--mesh', default='',
                        help='Mesh axis sizes, e.g. data=2,fsdp=4 or '
                             'fsdp=2,sequence=4 (parallel/mesh.py '
                             'MeshSpec; default: fsdp over every rank).')
    # A flag of the JAX trainer that the port refuses by name.
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
        lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
        lora_targets=([t.strip() for t in args.lora_targets.split(',')
                       if t.strip()] if args.lora_targets else None),
        hf_dir=args.hf_dir, lora_dir=args.lora_dir,
        sft_data_path=args.sft_data, chat_family=args.chat_family,
        data_service=args.data_service,
        device=args.device))


if __name__ == '__main__':
    main()
