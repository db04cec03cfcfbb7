"""Harvestable rollout worker: leases in, trajectory groups out (port of
skypilot_tpu/train/rollout/worker.py, on the card unless asked for the
CPU).

A rollout worker holds NO state the learner depends on: its inputs
are the :class:`~skypilot_tpu_torch.train.rollout.spec.RolloutSpec` it
pulls from the dispatcher, the lease ids it is granted, and whatever
policy snapshot is newest in ``spec.snapshot_dir`` when it looks.
SIGKILL at ANY point (mid-generation, mid-submit, between heartbeats)
loses at most the leases it held, which the dispatcher reaps and
reassigns; nothing about the learner's stream is corrupted. That is what
makes the fleet harvestable: workers run as low-priority managed jobs on
spot capacity and preemption is an ordinary event, not a failure.

Policies are published in the chunked, digest-verified checkpoint format
(``train/checkpoints``) as fp32 params trees, and the worker restores
the newest on the host. It then casts, once per version, every leaf
the model casts at use (the projections, embeddings and biases) to the
compute dtype, keeps the leaves the model reads in fp32 (norm scales,
sinks, routers) as they are, and moves the tree to its device
(``decode.cast_params_for_compute``). The forward and ``generate`` on
that tree give the same bits as on the fp32 tree (the CPU tests hold
it), and kernel
A, which takes bf16 only, runs on the card: on generate's prompt
prefill and on the behaviour scoring (``grpo.token_logprobs``),
``n_layers`` launches each a group.

Per-lease determinism: the prompt AND the sampling RNG derive from
``(spec, lease_id)`` (a ``torch.Generator`` seeded with
``spec.lease_rng_seed``; generate's CUDA graph draws from that
generator), so a reassigned lease re-executed against the same snapshot
yields a byte-identical trajectory: at-least-once duplicates are literal
duplicates, and the dispatcher keeps the first.

``stats_path`` (``--stats-file``) keeps a JSON record of the worker's
accounting, rewritten after every restore and every served lease:
groups generated and when, generate and restore seconds, each kernel's
launches and peak device memory.
"""
from __future__ import annotations

import functools
import json
import logging
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import config
from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.models import decode, mla, module_for
from skypilot_tpu_torch.train import checkpoints, grpo
from skypilot_tpu_torch.train.rollout import spec as spec_lib
from skypilot_tpu_torch.train.rollout import telemetry
from skypilot_tpu_torch.utils import backoff as backoff_lib
from skypilot_tpu_torch.utils import failpoints
from skypilot_tpu_torch.utils import framed

logger = logging.getLogger(__name__)

# THE seed derivation for worker-style loops (utils/backoff owns it).
stable_seed = backoff_lib.stable_seed

def check_device(device: torch.device, role: str) -> torch.device:
    """``device`` as given, or RuntimeError when it is the card and
    there is none: no role of the plane falls back to the CPU."""
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'no CUDA device: the rollout {role} runs on '
                           f"the card unless device='cpu' (--device cpu) "
                           f'is asked for')
    return device


class RolloutWorker:
    """One stateless rollout process: heartbeat + lease/generate loop."""

    def __init__(self, dispatcher_addr: Tuple[str, int], *,
                 worker_id: Optional[str] = None,
                 heartbeat_interval: float = 2.0,
                 register_timeout: float = 60.0,
                 rpc_timeout: float = 10.0,
                 leases_per_round: int = 1,
                 device='cuda',
                 stats_path: Optional[str] = None):
        self.device = check_device(torch.device(device), 'worker')
        self.worker_id = worker_id or f'rw-{uuid.uuid4().hex[:8]}'
        self._dispatcher_addr = dispatcher_addr
        self._heartbeat_interval = heartbeat_interval
        self._register_timeout = register_timeout
        self._rpc_timeout = rpc_timeout
        self._leases_per_round = max(1, leases_per_round)
        self._stats_path = stats_path
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._spec: Optional[spec_lib.RolloutSpec] = None
        self._latest_version = -1     # newest announced by the learner
        self._held_version = -1       # version of the params we hold
        self._seed = stable_seed(self.worker_id)
        # Model state, built lazily on the run loop (model set-up must
        # not block registration/heartbeats).
        self._cfg = None
        self._mod = None
        self._dec = None
        self._params = None
        self._reward_fn = None
        self._lp_fn = None
        self._ckpt = None
        self._template = None
        # Accounting (the stats file).
        self.generated = 0
        self.generate_s: List[float] = []
        self.generated_at: List[float] = []   # time.monotonic() a group
        self.restore_s: List[float] = []
        # One persistent connection per owning thread (the framed
        # idiom): heartbeats must not share a socket with a main loop
        # that may be mid-request when the heartbeat fires.
        self._hb_conn = framed.FramedClient(dispatcher_addr)
        self._main_conn = framed.FramedClient(dispatcher_addr)
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name=f'{self.worker_id}-heartbeat')

    # ------------------------------------------------------- lifecycle

    def start(self) -> 'RolloutWorker':
        self._register(self._hb_conn, deadline_s=self._register_timeout)
        self._hb_thread.start()
        logger.info(f'rollout worker {self.worker_id} registered with '
                    f'dispatcher {self._dispatcher_addr[0]}:'
                    f'{self._dispatcher_addr[1]}')
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._hb_thread.is_alive():
            self._hb_thread.join(timeout=5.0)
        self._hb_conn.close()
        self._main_conn.close()

    def _register(self, conn: framed.FramedClient,
                  deadline_s: float) -> None:
        deadline = time.monotonic() + deadline_s
        boff = backoff_lib.Backoff(base=0.2, cap=2.0, seed=self._seed)
        last_err: Optional[Exception] = None
        while time.monotonic() < deadline and not self._stop.is_set():
            try:
                reply, _ = conn.request(
                    {'op': 'register', 'worker_id': self.worker_id},
                    timeout=self._rpc_timeout)
                self._adopt(reply)
                return
            except (framed.ProtocolError, framed.RemoteError,
                    OSError) as e:
                last_err = e
                boff.sleep()
        raise TimeoutError(
            f'rollout worker {self.worker_id} could not register with '
            f'dispatcher at {self._dispatcher_addr} within '
            f'{deadline_s}s: {last_err}')

    def _adopt(self, reply: Dict[str, Any]) -> None:
        with self._lock:
            version = int(reply.get('snapshot_version', -1))
            if version > self._latest_version:
                self._latest_version = version
            if self._spec is None and reply.get('spec') is not None:
                self._spec = spec_lib.RolloutSpec.from_json(
                    reply['spec'])

    # ------------------------------------------------------ heartbeats

    def _heartbeat_loop(self) -> None:
        boff = backoff_lib.Backoff(base=0.2, cap=5.0, seed=self._seed)
        while not self._stop.wait(self._heartbeat_interval):
            try:
                with self._lock:
                    have_spec = self._spec is not None
                reply, _ = self._hb_conn.request(
                    {'op': 'heartbeat', 'worker_id': self.worker_id,
                     'have_spec': have_spec},
                    timeout=self._rpc_timeout)
                if reply.get('resync'):
                    # Dispatcher declared us LOST: rejoin. Our old
                    # leases were reassigned — at-least-once makes the
                    # interim double-ownership harmless.
                    self._register(self._hb_conn,
                                   deadline_s=self._register_timeout)
                else:
                    self._adopt(reply)
                boff.reset()
            except (framed.ProtocolError, framed.RemoteError,
                    OSError, TimeoutError) as e:
                logger.warning(f'rollout worker {self.worker_id} '
                               f'heartbeat failed: {e}')
                boff.sleep()

    # ------------------------------------------------------ model side

    def _ensure_model(self) -> bool:
        """Build model/reward/checkpointer once a spec is known.
        Returns False while the spec has not arrived yet."""
        with self._lock:
            spec = self._spec
        if spec is None:
            return False
        if self._cfg is not None:
            return True
        cfg = config.get_config(spec.model)
        if cfg.vocab_size != spec.vocab_size:
            raise ValueError(
                f'spec vocab_size={spec.vocab_size} disagrees with '
                f'model preset {spec.model!r} '
                f'(vocab_size={cfg.vocab_size}) — the prompt stream '
                f'would sample tokens the model cannot embed')
        self._cfg = cfg
        self._mod = module_for(cfg)
        self._dec = mla if isinstance(cfg, config.MLAConfig) else decode
        self._reward_fn = grpo.resolve_reward(spec.reward, spec.eos_id)
        self._ckpt = checkpoints.Checkpointer(spec.snapshot_dir)
        # The restore target: shapes only, on the meta device.
        self._template = self._mod.init_params(cfg, None, 'meta')
        self._lp_fn = functools.partial(
            grpo.token_logprobs, cfg=cfg, mod=self._mod,
            temperature=spec.temperature)
        return True

    def _ensure_snapshot(self) -> bool:
        """Fetch the newest policy snapshot when the learner announced
        one newer than what we hold. Returns True iff params are
        usable. Fetch failures (corrupt mid-GC step, injected
        ``rollout.snapshot_fetch`` fault) keep the old params — a
        stale policy degrades freshness, not correctness; the learner's
        staleness window judges the result."""
        with self._lock:
            latest = self._latest_version
        if self._params is not None and self._held_version >= latest:
            return True
        if latest < 0:
            return self._params is not None
        try:
            if failpoints.ACTIVE:
                failpoints.fire('rollout.snapshot_fetch')
            t0 = time.perf_counter()
            # Restored on the host and cast there: the card never holds
            # the fp32 tree beside the version in use.
            restored, version = self._ckpt.restore_newest(self._template,
                                                          'cpu')
            if restored is None:
                # Announced but not visible HERE yet (fresh shared
                # mount, dispatcher restarted with persisted meta
                # while the dir was cleaned): not an error — keep
                # whatever we hold and look again next loop.
                return self._params is not None
            self._params = decode.cast_params_for_compute(
                restored, self._cfg, self.device)
            del restored
            self._held_version = int(version)
            self.restore_s.append(time.perf_counter() - t0)
            self._write_stats()
            logger.info(f'rollout worker {self.worker_id} holds policy '
                        f'snapshot v{self._held_version}')
            return True
        except (failpoints.FailpointError,
                checkpoints.CheckpointCorruptError, OSError,
                ValueError) as e:
            logger.warning(f'rollout worker {self.worker_id} snapshot '
                           f'fetch failed (keeping '
                           f'v{self._held_version}): {e}')
            return self._params is not None

    @torch.no_grad()
    def behavior_logprobs(self, prompts: torch.Tensor,
                          completions: torch.Tensor) -> torch.Tensor:
        """[G, T] fp32 log-probs of ``completions`` [G, T] after the
        fixed-length ``prompts`` [G, S] under the held snapshot, as the
        learner's ratio reads them: completion token j sits at sequence
        position S + j, scored by log-prob grid entry S + j - 1."""
        s, t = prompts.shape[1], completions.shape[1]
        seq = torch.cat([prompts, completions.to(prompts.dtype)], dim=1)
        lp_full, _ = self._lp_fn(self._params, seq)
        return lp_full[:, s - 1:s - 1 + t]

    def _generate(self, lease_id: int) -> Dict[str, np.ndarray]:
        """One trajectory group for ``lease_id``: G completions,
        rewards, and behavior log-probs under the HELD snapshot."""
        spec = self._spec
        s, t, g = spec.prompt_len, spec.max_new_tokens, spec.group_size
        prompt = spec_lib.prompt_for(spec, lease_id)
        rep = torch.from_numpy(np.repeat(prompt[None, :], g, axis=0)).to(
            self.device)
        rng = torch.Generator(device=self.device).manual_seed(
            spec_lib.lease_rng_seed(spec, lease_id))
        if failpoints.ACTIVE:
            failpoints.fire('rollout.generate')
        if spec.rollout_delay_s > 0:
            time.sleep(spec.rollout_delay_s)
        gen = self._dec.generate(
            self._params, rep, self._cfg, t, max_len=s + t,
            temperature=spec.temperature, eos_id=spec.eos_id,
            generator=rng)
        behavior_lp = self.behavior_logprobs(rep, gen)
        gen_np = gen.cpu().numpy()
        rewards = np.asarray(
            [self._reward_fn(prompt, gen_np[i]) for i in range(g)],
            np.float32)
        return {'completions': gen_np.astype(np.int32),
                'rewards': rewards,
                'behavior_lp': behavior_lp.float().cpu().numpy()}

    # ------------------------------------------------------- main loop

    def _request(self, obj: Dict[str, Any],
                 arrays: Optional[framed.Arrays] = None
                 ) -> Dict[str, Any]:
        reply, _ = self._main_conn.request(obj, arrays=arrays,
                                           timeout=self._rpc_timeout)
        return reply

    def run(self) -> None:
        """Lease → generate → submit until stopped. Every failure mode
        is contained: transient RPC errors back off and retry, resync
        re-registers, a failed generation releases its lease."""
        boff = backoff_lib.Backoff(base=0.2, cap=5.0, seed=self._seed)
        while not self._stop.is_set():
            try:
                if not self._ensure_model() or \
                        not self._ensure_snapshot():
                    if self._stop.wait(0.2):
                        return
                    continue
                reply = self._request(
                    {'op': 'lease', 'worker_id': self.worker_id,
                     'max_n': self._leases_per_round,
                     'spec_fp': self._spec.fingerprint()})
                if reply.get('resync'):
                    self._register(self._main_conn,
                                   deadline_s=self._register_timeout)
                    continue
                version = int(reply.get('snapshot_version', -1))
                with self._lock:
                    if version > self._latest_version:
                        self._latest_version = version
                leases = list(reply.get('leases') or [])
                if not leases:
                    # Backpressure (learner behind) or a drained job:
                    # idle briefly, stay registered.
                    if self._stop.wait(0.2):
                        return
                    continue
                for lease_id in leases:
                    if self._stop.is_set():
                        return
                    self._serve_lease(int(lease_id))
                boff.reset()
            except (framed.ProtocolError, framed.RemoteError,
                    OSError, TimeoutError) as e:
                logger.warning(f'rollout worker {self.worker_id} '
                               f'lease round failed: {e}')
                boff.sleep()

    def _serve_lease(self, lease_id: int) -> None:
        t0 = time.perf_counter()
        try:
            traj = self._generate(lease_id)
        except Exception as e:  # noqa: BLE001 — containment, see below
            # ANY generation/reward failure — injected fault, device
            # error, a user reward_fn raising on one completion —
            # hands the lease back NOW so a healthy worker picks it
            # up, and the worker lives on to serve the next lease.
            # One bad completion must cost one re-lease, never a
            # fleet member (the reaper's lease timeout would contain
            # a crash too, but slower and with a dead worker).
            logger.warning(f'rollout worker {self.worker_id} failed '
                           f'lease {lease_id}: {e!r}; releasing')
            try:
                self._request({'op': 'release',
                               'worker_id': self.worker_id,
                               'lease_id': lease_id})
            except (framed.ProtocolError, framed.RemoteError,
                    OSError):
                pass   # reaper's lease timeout is the backstop
            return
        wall = time.perf_counter() - t0
        telemetry.GENERATE_SECONDS.observe(wall)
        self.generated += 1
        self.generate_s.append(wall)
        self.generated_at.append(time.monotonic())
        self._write_stats()
        submit = {'op': 'submit', 'worker_id': self.worker_id,
                  'lease_id': lease_id,
                  'snapshot_version': self._held_version,
                  'spec_fp': self._spec.fingerprint()}
        for attempt in (0, 1):
            try:
                self._request(submit, arrays=traj)
                return
            except framed.RemoteError as e:
                # The dispatcher ANSWERED — it decided the lease's
                # fate (refusal or duplicate); retrying or releasing
                # would fight its decision.
                logger.warning(f'rollout worker {self.worker_id} '
                               f'submit of lease {lease_id} refused: '
                               f'{e}')
                return
            except (framed.ProtocolError, OSError,
                    TimeoutError) as e:
                # Transient wire failure: one reconnect-retry (the
                # trajectory in hand is real work), then hand the
                # lease back rather than stranding it LEASED until
                # the lease timeout.
                logger.warning(f'rollout worker {self.worker_id} '
                               f'submit of lease {lease_id} failed '
                               f'(attempt {attempt + 1}): {e}')
                if attempt == 0:
                    time.sleep(0.2)
        try:
            self._request({'op': 'release',
                           'worker_id': self.worker_id,
                           'lease_id': lease_id})
        except (framed.ProtocolError, framed.RemoteError, OSError,
                TimeoutError):
            pass   # reaper's lease timeout is the backstop

    # ------------------------------------------------------ accounting

    def stats(self) -> Dict[str, Any]:
        """The worker's accounting: groups generated, generate and
        restore seconds, when each group was done (``time.monotonic``,
        one clock for every process of the host), each registered
        kernel's launches in this process, peak device memory (None on
        the CPU)."""
        peak = (torch.cuda.max_memory_allocated(self.device) / 1e9
                if self.device.type == 'cuda' else None)
        return {'worker_id': self.worker_id, 'device': str(self.device),
                'generated': self.generated,
                'generate_s': self.generate_s,
                'generated_at': self.generated_at,
                'restore_s': self.restore_s,
                'held_version': self._held_version,
                'kernel_launches': {n: k.launches for n, k in
                                    build.kernels().items()},
                'peak_memory_gb': peak}

    def _write_stats(self) -> None:
        if self._stats_path is None:
            return
        tmp = self._stats_path + '.tmp'
        with open(tmp, 'w', encoding='utf-8') as f:
            json.dump(self.stats(), f)
        os.replace(tmp, self._stats_path)   # a reader never sees half
