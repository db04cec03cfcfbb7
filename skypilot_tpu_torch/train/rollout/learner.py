"""Stable GRPO learner fed by the harvested rollout fleet (port of
skypilot_tpu/train/rollout/learner.py, on the card unless asked for the
CPU).

The learner is the plane's ONE stable node: it owns the policy
(``train/grpo`` update math over a ``train_lib.TrainState``, fp32
masters moved in place by the port's AdamW), publishes snapshots of its
params for the fleet through the chunked checkpoint format
(``train/checkpoints``: NO ad-hoc serialization anywhere in this plane),
and consumes trajectory groups from the dispatcher with every failure
mode contained:

  * **bounded prefetch** — a collect thread fills a bounded queue;
    a dead dispatcher connection is dropped and redialed under seeded
    backoff (drop-route-and-retry);
  * **staleness window** — every trajectory carries the snapshot
    version that generated it; groups older than ``max_staleness``
    versions are dropped (counted + journaled) instead of silently
    training on ancient behavior;
  * **graceful degradation** — losing ANY subset of workers slows
    trajectory arrival, so the learner steps slower; it stalls loudly
    (``RolloutStallError``) only when NOTHING arrives for the whole
    stall budget;
  * **replayable stream** — every consumed batch is journaled to a
    trajectory log BEFORE the update; :func:`replay_losses` over the
    same log reproduces the loss trajectory bit-equal on one device;
  * **clean preemption** — the learner runs under the trainer's
    ``_PreemptionWatch``: one synchronous final state save, a
    ``{"preempted": true}`` log line, resume via ``restore_newest``.

On the card one step runs kernel A on the reference scoring (when
``kl_coef > 0``) and twice in the update (its forward, and the
recompute of remat 'full'), ``n_layers`` launches each, and kernels C
and D once per layer in the update's backward; the warm-up runs one
update on a zero batch.

``mesh=None`` only: a mesh is refused by name (ROADMAP Queue 1 item 8),
as the trainer refuses ``--lora-rank`` on one.
"""
from __future__ import annotations

import collections
import functools
import glob
import json
import logging
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import module_for, weights
from skypilot_tpu_torch.observe import journal
from skypilot_tpu_torch.train import checkpoints, grpo, train_lib
from skypilot_tpu_torch.train.rollout import spec as spec_lib
from skypilot_tpu_torch.train.rollout import telemetry
from skypilot_tpu_torch.train.rollout.worker import check_device
from skypilot_tpu_torch.utils import backoff as backoff_lib
from skypilot_tpu_torch.utils import failpoints
from skypilot_tpu_torch.utils import framed
from skypilot_tpu_torch.utils import knobs

logger = logging.getLogger(__name__)

DEFAULT_STALL_BUDGET_S = knobs.get_float('SKYTPU_ROLLOUT_STALL_BUDGET')


class RolloutStallError(RuntimeError):
    """No trajectory arrived within the stall budget."""


# ------------------------------------------------------- shared pieces
# Module-level (not methods) so the live learner and the offline
# replay run the IDENTICAL assembly/update code — bit-equal replay is
# a property of sharing these functions, not of careful duplication.

def _grpo_pieces(spec: spec_lib.RolloutSpec, mesh, learning_rate: float,
                 total_steps: int):
    """(cfg, mod, gcfg, tx, update_fn, ref_lp_fn) for a spec.
    ``ref_lp_fn`` is the reference-logprob forward (None when the KL
    tether is off)."""
    if mesh is not None:
        raise NotImplementedError(
            'the rollout learner on a mesh is not ported yet: it waits '
            'for ROADMAP Queue 1 item 8 (pass mesh=None)')
    cfg = config.get_config(spec.model)
    if cfg.vocab_size != spec.vocab_size:
        raise ValueError(
            f'spec vocab_size={spec.vocab_size} disagrees with model '
            f'preset {spec.model!r} (vocab_size={cfg.vocab_size})')
    mod = module_for(cfg)
    gcfg = grpo.GRPOConfig(
        group_size=spec.group_size,
        max_new_tokens=spec.max_new_tokens,
        temperature=spec.temperature, clip_eps=spec.clip_eps,
        kl_coef=spec.kl_coef)
    tx = train_lib.default_optimizer(
        learning_rate=learning_rate, warmup_steps=1,
        total_steps=max(2, total_steps + 1))
    update = grpo.make_grpo_update(cfg, tx, gcfg, mod,
                                   use_ref=spec.kl_coef > 0.0)
    ref_lp_fn = None
    if spec.kl_coef > 0.0:
        ref_lp_fn = functools.partial(
            grpo.token_logprobs, cfg=cfg, mod=mod,
            temperature=spec.temperature)
    return cfg, mod, gcfg, tx, update, ref_lp_fn


def _copy_tree(params):
    """A real copy of a params tree (the update moves the policy's
    tensors in place)."""
    return weights.tree_unflatten(
        params, [t.detach().clone() for t in train_lib.leaves(params)])


def _init_state(spec: spec_lib.RolloutSpec, cfg, tx, device,
                init_params=None) -> train_lib.TrainState:
    """Fresh policy TrainState on ``device``: a copy of ``init_params``
    in fp32, else the preset's random init from ``spec.seed``."""
    params = None
    if init_params is not None:
        params = weights.tree_unflatten(init_params, [
            t.detach().to(device=device, dtype=torch.float32, copy=True)
            for t in train_lib.leaves(init_params)])
    return train_lib.init_train_state(
        cfg, tx, device,
        generator=torch.Generator(device=device).manual_seed(spec.seed),
        params=params)


def _assemble_batch(spec: spec_lib.RolloutSpec, gcfg,
                    groups: List[Dict[str, Any]], device='cpu'):
    """Trajectory groups → the ``make_grpo_update`` argument tuple, on
    ``device``.

    One group = one prompt's G completions (the GRPO baseline group);
    batches stack groups along the row dim ([B·G, ...]), exactly the
    shapes ``GRPOTrainer.rollout`` feeds the same update."""
    s, t, g = spec.prompt_len, spec.max_new_tokens, spec.group_size
    b = len(groups)
    prompts = np.stack([spec_lib.prompt_for(spec, int(grp['lease_id']))
                        for grp in groups])                    # [B, S]
    rep = np.repeat(prompts, g, axis=0)                        # [B·G, S]
    gens = np.concatenate(
        [np.asarray(grp['completions'], np.int32)
         for grp in groups], axis=0)                           # [B·G, T]
    behavior_lp = np.concatenate(
        [np.asarray(grp['behavior_lp'], np.float32)
         for grp in groups], axis=0)
    rewards = np.concatenate(
        [np.asarray(grp['rewards'], np.float32) for grp in groups],
        axis=0)
    seq = torch.from_numpy(np.concatenate([rep, gens], axis=1)).to(device)
    comp_idx = torch.from_numpy(
        np.broadcast_to(np.arange(t, dtype=np.int64) + s - 1,
                        (b * g, t)).copy()).to(device)
    mask = grpo.completion_mask(torch.from_numpy(gens).to(device),
                                spec.eos_id)
    adv = grpo.group_advantages(torch.from_numpy(rewards).to(device), g,
                                gcfg.adv_eps)
    return (seq, comp_idx, torch.from_numpy(behavior_lp).to(device), adv,
            mask)


def _log_path(log_dir: str, step: int) -> str:
    return os.path.join(log_dir, f'traj_{step:06d}.npz')


def _write_log_step(log_dir: str, step: int,
                    groups: List[Dict[str, Any]]) -> None:
    path = _log_path(log_dir, step)
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:   # file handle: savez won't append .npz
        np.savez(
            f,
            lease_ids=np.asarray([g['lease_id'] for g in groups],
                                 np.int64),
            versions=np.asarray([g['version'] for g in groups],
                                np.int64),
            completions=np.stack([g['completions'] for g in groups]),
            rewards=np.stack([g['rewards'] for g in groups]),
            behavior_lp=np.stack([g['behavior_lp'] for g in groups]))
    os.replace(tmp, path)   # a log step exists iff it is complete


def _read_log_step(path: str) -> List[Dict[str, Any]]:
    with np.load(path) as z:
        return [{'lease_id': int(z['lease_ids'][i]),
                 'version': int(z['versions'][i]),
                 'completions': z['completions'][i],
                 'rewards': z['rewards'][i],
                 'behavior_lp': z['behavior_lp'][i]}
                for i in range(z['lease_ids'].shape[0])]


def replay_losses(spec: spec_lib.RolloutSpec, log_dir: str, *,
                  learning_rate: float, total_steps: int,
                  mesh=None, device='cuda',
                  init_params=None) -> List[float]:
    """Re-run the learner's update sequence over a journaled
    trajectory log (the port's or the JAX learner's: one format). Same
    spec + same log + same initial params on the same device ⇒ the SAME
    update code sees the SAME inputs in the SAME order — the returned
    losses match the live run bit-for-bit. ``init_params`` (fp32) are
    the initial params of a learner that did not start from the preset's
    init at ``spec.seed`` (the JAX learner's, bridged)."""
    device = check_device(torch.device(device), 'learner')
    cfg, mod, gcfg, tx, update, ref_lp_fn = _grpo_pieces(
        spec, mesh, learning_rate, total_steps)
    state = _init_state(spec, cfg, tx, device, init_params)
    ref = _copy_tree(state.params) if ref_lp_fn is not None else None
    losses: List[float] = []
    for path in sorted(glob.glob(os.path.join(log_dir, 'traj_*.npz'))):
        groups = _read_log_step(path)
        batch = _assemble_batch(spec, gcfg, groups, device)
        ref_lp = _ref_logprobs(ref_lp_fn, ref, batch) \
            if ref is not None else None
        state, metrics = update(state, *batch, ref_lp=ref_lp)
        losses.append(float(metrics['loss']))
    return losses


@torch.no_grad()
def _ref_logprobs(ref_lp_fn, ref_params, batch) -> torch.Tensor:
    seq, comp_idx = batch[0], batch[1]
    lp_full, _ = ref_lp_fn(ref_params, seq)
    return lp_full.gather(1, comp_idx)


class RolloutLearner:
    """The stable node: collect → filter → update → publish, iterated."""

    def __init__(self, spec: spec_lib.RolloutSpec,
                 dispatcher_addr: Tuple[str, int], *,
                 total_steps: int,
                 groups_per_step: int = 2,
                 publish_every: int = 4,
                 max_staleness: int = 4,
                 learning_rate: float = 1e-4,
                 snapshot_max_to_keep: int = 4,
                 state_dir: Optional[str] = None,
                 traj_log_dir: Optional[str] = None,
                 mesh=None,
                 rpc_timeout: float = 10.0,
                 stall_budget_s: float = DEFAULT_STALL_BUDGET_S,
                 warmup: bool = True,
                 on_step=None,
                 device='cuda'):
        self.device = check_device(torch.device(device), 'learner')
        self.spec = spec
        self._addr = dispatcher_addr
        self.total_steps = total_steps
        self._groups_per_step = max(1, groups_per_step)
        self._publish_every = max(1, publish_every)
        self._max_staleness = max(0, max_staleness)
        self._rpc_timeout = rpc_timeout
        self._stall_budget_s = stall_budget_s
        self._warmup_wanted = warmup
        self._on_step = on_step
        self._stop = threading.Event()
        self._queue: 'queue.Queue[Dict[str, Any]]' = queue.Queue(
            maxsize=max(2, 4 * self._groups_per_step))
        (self._cfg, self._mod, self._gcfg, self._tx, self._update,
         self._ref_lp_fn) = _grpo_pieces(spec, mesh, learning_rate,
                                         total_steps)
        self.state = _init_state(spec, self._cfg, self._tx, self.device)
        # KL reference = the SEED-INITIAL policy, captured BEFORE any
        # checkpoint resume overwrites self.state — the tether anchors
        # to where training started, and replay_losses derives its
        # reference the same way (resume must not move the anchor or
        # the replay contract breaks).
        self._ref = (_copy_tree(self.state.params)
                     if spec.kl_coef > 0.0 else None)
        self.start_step = 0
        self._state_ckpt = None
        if state_dir:
            self._state_ckpt = checkpoints.Checkpointer(
                state_dir, max_to_keep=2)
            if self._state_ckpt.latest_step() is not None:
                restored, step = self._state_ckpt.restore_newest(
                    checkpoints.abstract_train_state(self._cfg, self._tx),
                    self.device)
                self.state = restored
                self.start_step = int(step)
                logger.info(f'rollout learner resumed at step '
                            f'{self.start_step} from {state_dir}')
        # Snapshot publishing: THE checkpoint format, size-bounded so
        # a week-long harvest cannot fill the disk (max_to_keep
        # retention on the snapshot dir).
        self._snap_ckpt = checkpoints.Checkpointer(
            spec.snapshot_dir, max_to_keep=snapshot_max_to_keep)
        self._version = -1
        self._traj_log_dir = traj_log_dir
        if traj_log_dir:
            os.makedirs(traj_log_dir, exist_ok=True)
        self._ctrl = framed.FramedClient(dispatcher_addr)
        self._collect_thread = threading.Thread(
            target=self._collect_loop, daemon=True,
            name='rollout-learner-collect')
        # Accounting the harness reads after a run.
        self.history: List[Dict[str, float]] = []
        self.step_walls: List[float] = []
        self.publish_s: List[float] = []
        self.samples_total = 0
        self.stale_dropped = 0
        self.staleness_seen: List[int] = []

    # ------------------------------------------------------- lifecycle

    def start(self) -> 'RolloutLearner':
        """Register the spec, publish the initial policy snapshot, and
        start collecting. Retries until the dispatcher answers (it may
        still be booting) within the stall budget."""
        deadline = time.monotonic() + self._stall_budget_s
        boff = backoff_lib.Backoff(base=0.2, cap=2.0,
                                   seed=self.spec.seed)
        last_err: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                self._ctrl.request(
                    {'op': 'put_spec', 'spec': self.spec.to_json()},
                    timeout=self._rpc_timeout)
                break
            except framed.RemoteError as e:
                if e.kind in ('spec', 'spec_mismatch'):
                    raise   # config refusal: retrying cannot heal it
                last_err = e
                boff.sleep()
            except (framed.ProtocolError, OSError) as e:
                last_err = e
                boff.sleep()
        else:
            raise RolloutStallError(
                f'dispatcher at {self._addr} unreachable for '
                f'{self._stall_budget_s}s: {last_err}')
        # Workers need a policy before the first lease is useful.
        self._publish(self.start_step // self._publish_every)
        self._collect_thread.start()
        if self._warmup_wanted:
            self._warmup()
        return self

    def _warmup(self) -> None:
        """Run the update once on a zero batch + THROWAWAY state before
        the loop starts, so the first real step pays no first-call
        set-up (library handles, kernel loads, allocator growth) while
        the fleet banks result_cap groups — which every throughput
        window that drains them would read as super-production-rate."""
        s, t, g = (self.spec.prompt_len, self.spec.max_new_tokens,
                   self.spec.group_size)
        b, dev = self._groups_per_step * g, self.device
        throwaway = _init_state(self.spec, self._cfg, self._tx, dev)
        zeros = (torch.zeros((b, s + t), dtype=torch.int32, device=dev),
                 torch.zeros((b, t), dtype=torch.int64, device=dev),
                 torch.zeros((b, t), dtype=torch.float32, device=dev),
                 torch.zeros((b,), dtype=torch.float32, device=dev),
                 torch.zeros((b, t), dtype=torch.float32, device=dev))
        ref_lp = (torch.zeros((b, t), dtype=torch.float32, device=dev)
                  if self._ref is not None else None)
        self._update(throwaway, *zeros, ref_lp=ref_lp)
        del throwaway
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()

    def close(self) -> None:
        self._stop.set()
        if self._collect_thread.is_alive():
            self._collect_thread.join(timeout=5.0)
        self._ctrl.close()
        if self._state_ckpt is not None:
            self._state_ckpt.close()
        self._snap_ckpt.close()

    def __enter__(self) -> 'RolloutLearner':
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------ publishing

    def _publish(self, version: int) -> bool:
        """Snapshot the CURRENT policy params as ``version`` and
        announce it. Failure (injected ``rollout.publish`` fault, a
        dispatcher blip) is contained: workers keep generating against
        the previous snapshot and the next cadence retries — freshness
        degrades, the run never dies."""
        try:
            if failpoints.ACTIVE:
                failpoints.fire('rollout.publish')
            t0 = time.perf_counter()
            self._snap_ckpt.save(self.state.params, version, wait=True)
            self.publish_s.append(time.perf_counter() - t0)
            self._ctrl.request({'op': 'publish', 'version': version},
                               timeout=self._rpc_timeout)
            self._version = max(self._version, version)
            return True
        except (failpoints.FailpointError, framed.ProtocolError,
                framed.RemoteError, OSError) as e:
            logger.warning(f'rollout learner: publish v{version} '
                           f'failed (fleet keeps v{self._version}): '
                           f'{e}')
            return False

    # ------------------------------------------------------ collecting

    def _collect_loop(self) -> None:
        conn: Optional[framed.FramedClient] = None
        boff = backoff_lib.Backoff(base=0.2, cap=2.0,
                                   seed=self.spec.seed ^ 0x5eed)
        # At-least-once bookkeeping: ack what we RECEIVED so the
        # dispatcher retires it, and dedupe re-deliveries (reply
        # arrived, ack lost) by lease_id — leases complete exactly
        # once, so the id is a sufficient key. The seen-set is
        # bounded: an id older than the window can never reappear
        # (the dispatcher re-delivers only its last reply's groups).
        ack: List[int] = []
        seen: 'collections.OrderedDict[int, None]' = (
            collections.OrderedDict())
        while not self._stop.is_set():
            try:
                if conn is None:
                    conn = framed.FramedClient(self._addr)
                reply, arrays = conn.request(
                    {'op': 'collect',
                     'max_n': 2 * self._groups_per_step,
                     'ack': ack},
                    timeout=self._rpc_timeout)
                metas = list(reply.get('trajectories') or [])
                ack = [int(m['lease_id']) for m in metas]
                if not metas:
                    if self._stop.wait(0.05):
                        return
                    continue
                for i, meta in enumerate(metas):
                    lease_id = int(meta['lease_id'])
                    if lease_id in seen:
                        continue   # re-delivery of an already-consumed group
                    seen[lease_id] = None
                    while len(seen) > 256:
                        seen.popitem(last=False)
                    traj = {'lease_id': lease_id,
                            'version': int(meta['version']),
                            'completions': arrays[f'completions_{i}'],
                            'rewards': arrays[f'rewards_{i}'],
                            'behavior_lp': arrays[f'behavior_lp_{i}']}
                    while not self._stop.is_set():
                        try:
                            self._queue.put(traj, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                boff.reset()
            except (framed.ProtocolError, framed.RemoteError, OSError,
                    KeyError) as e:
                # Drop the route, redial, retry — the dispatcher may
                # be restarting; its sqlite state survives.
                logger.warning(f'rollout learner collect failed: {e}')
                if conn is not None:
                    conn.close()
                    conn = None
                boff.sleep()
        if conn is not None:
            conn.close()

    def _gather(self) -> List[Dict[str, Any]]:
        """Block until a full batch of FRESH groups is available.
        Stale groups (version lag > max_staleness) are dropped and
        counted — the off-policy window is a hard bound, not advice.
        The stall deadline resets on every ACCEPTED group: the budget
        bounds uselessness, not batch-assembly time — a degraded
        fleet trickling one fresh group per minute is slow, while a
        fleet producing nothing (or nothing fresh) is stalled."""
        groups: List[Dict[str, Any]] = []
        deadline = time.monotonic() + self._stall_budget_s
        while len(groups) < self._groups_per_step:
            if self._stop.is_set():
                raise RolloutStallError('learner stopped mid-gather')
            try:
                traj = self._queue.get(timeout=0.2)
            except queue.Empty:
                if time.monotonic() >= deadline:
                    raise RolloutStallError(
                        f'no USABLE trajectory within the '
                        f'{self._stall_budget_s}s stall budget — '
                        f'fleet gone, or producing only stale '
                        f'groups?') from None
                continue
            lag = max(0, self._version - int(traj['version']))
            telemetry.STALENESS.observe(float(lag))
            self.staleness_seen.append(lag)
            if lag > self._max_staleness:
                telemetry.STALE_DROPPED.inc()
                self.stale_dropped += 1
                journal.record_event(
                    'rollout_stale_drop', 'learner',
                    data={'lease_id': traj['lease_id'],
                          'version': traj['version'],
                          'current': self._version})
                continue
            groups.append(traj)
            # Deadline resets on ACCEPTED groups only: a trickling
            # degraded fleet is slow, not stalled — but a fleet
            # producing nothing but too-stale groups can never make
            # progress and must still stall loudly.
            deadline = time.monotonic() + self._stall_budget_s
            telemetry.TRAJECTORIES.inc(role='learner')
        telemetry.QUEUE_DEPTH.set(float(self._queue.qsize()),
                                  role='learner')
        return groups

    # -------------------------------------------------------- stepping

    def run(self) -> List[Dict[str, float]]:
        """The learner loop. Returns per-step history (loss, reward,
        samples). Preemption (SIGTERM / ``trainer.preempt`` failpoint)
        exits cleanly with a final synchronous state save."""
        from skypilot_tpu_torch.train import trainer as trainer_mod
        with trainer_mod._PreemptionWatch() as watch:
            for step in range(self.start_step, self.total_steps):
                t0 = time.perf_counter()
                groups = self._gather()
                if self._traj_log_dir:
                    _write_log_step(self._traj_log_dir, step, groups)
                batch = _assemble_batch(self.spec, self._gcfg, groups,
                                        self.device)
                ref_lp = (_ref_logprobs(self._ref_lp_fn, self._ref,
                                        batch)
                          if self._ref is not None else None)
                self.state, metrics = self._update(self.state, *batch,
                                                   ref_lp=ref_lp)
                loss = float(metrics['loss'])    # waits for the device
                wall = time.perf_counter() - t0
                samples = len(groups) * self.spec.group_size
                self.samples_total += samples
                telemetry.SAMPLES.inc(samples)
                telemetry.STEP_SECONDS.observe(wall)
                self.step_walls.append(time.monotonic())
                rec = {'step': step + 1,
                       'loss': loss,
                       'mean_reward': float(np.mean(np.concatenate(
                           [g['rewards'] for g in groups]))),
                       'samples': samples,
                       'sec_per_step': round(wall, 4)}
                self.history.append(rec)
                logger.info(json.dumps(
                    {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in rec.items()}))
                if (step + 1) % self._publish_every == 0:
                    self._publish((step + 1) // self._publish_every)
                if self._state_ckpt is not None and \
                        (step + 1) % self._publish_every == 0:
                    self._state_ckpt.save(self.state, step + 1)
                if self._on_step is not None:
                    self._on_step(step)
                if watch.preempted:
                    if self._state_ckpt is not None:
                        self._state_ckpt.save(self.state, step + 1,
                                              wait=True)
                    logger.info(json.dumps(
                        {'step': step + 1, 'preempted': True,
                         'final_checkpoint':
                             self._state_ckpt is not None}))
                    return self.history
        if self._state_ckpt is not None:
            self._state_ckpt.save(self.state, self.total_steps,
                                  wait=True)
        return self.history

    # ------------------------------------------------------ accounting

    def report(self) -> Dict[str, Any]:
        """Run-level accounting the harness layers on top (the JAX
        report's keys, plus the seconds of each snapshot publish)."""
        stale = self.staleness_seen
        return {
            'steps': len(self.history),
            'samples_total': self.samples_total,
            'stale_dropped': self.stale_dropped,
            'staleness_p50': float(np.percentile(stale, 50))
            if stale else None,
            'staleness_p95': float(np.percentile(stale, 95))
            if stale else None,
            'snapshot_version': self._version,
            'publish_s': list(self.publish_s),
        }
