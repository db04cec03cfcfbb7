"""Harvest-run harness: dispatcher + worker subprocesses + learner (port
of skypilot_tpu/train/rollout/harness.py: ``default_spec``,
``spawn_worker``, ``wait_alive`` and ``run_harvest``).

One entry point (:func:`run_harvest`) drives a complete harvested-RL
run on this host — in-process dispatcher and learner (so callers can
read the journal and the learner's accounting), REAL worker
subprocesses of ``python -m skypilot_tpu_torch.train.rollout worker``
(so SIGKILL means SIGKILL) — under a seeded kill/respawn schedule. The
CPU churn test and chip_smoke.py's harvest phase both run it.

The port's additions: ``device`` (the learner's and every worker's,
the card by default), ``stats_dir`` (each worker keeps its accounting
in ``<stats_dir>/<worker_id>.json``: groups generated, kernel launches,
peak memory, generate and restore seconds), ``snapshot_max_to_keep``,
and kills that land on lease holders: the kill of step K runs on a
thread that SIGKILLs each victim the moment it holds a freshly granted
lease (waiting a bounded time, while the learner steps on and so frees
the backlog that gates new leases), so that a kill orphans a lease for
the reaper to hand on. ``cost_per_sample`` is not ported:
it prices TPU capacity (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from skypilot_tpu_torch import config
from skypilot_tpu_torch.train.rollout import dispatcher as dispatcher_lib
from skypilot_tpu_torch.train.rollout import learner as learner_lib
from skypilot_tpu_torch.train.rollout import spec as spec_lib
from skypilot_tpu_torch.utils import framed

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

# How long a kill waits for a worker to hold a lease.
_VICTIM_WAIT_S = 30.0


def default_spec(run_dir: str, tag: str = 'run',
                 **overrides) -> spec_lib.RolloutSpec:
    """The tiny CPU-proxy job (llama-debug), with ``overrides``.

    ``snapshot_dir`` is TAG-scoped: two runs sharing one run_dir must
    not let the second run's workers restore the FIRST run's final
    policy (its step numbers sort newer than the fresh run's version
    0)."""
    fields = dict(
        model='llama-debug',
        reward='count_token:42',
        snapshot_dir=os.path.join(run_dir, f'snapshots-{tag}'),
        vocab_size=config.get_config('llama-debug').vocab_size,
        prompt_len=8, group_size=4, max_new_tokens=8,
        temperature=1.0, seed=0,
        # Pacing: the tiny model generates near-instantly on CPU, so
        # without a per-group cost the learner banks the whole run in
        # its prefetch buffer and worker churn is invisible. The delay
        # makes rollout capacity the bottleneck — kills visibly
        # degrade samples/sec, rejoin visibly restores it.
        rollout_delay_s=0.25)
    fields.update(overrides)
    return spec_lib.RolloutSpec(**fields)


# The spec reward of :func:`even_token_reward`, for a run at a real width.
EVEN_TOKEN_REWARD = ('skypilot_tpu_torch.train.rollout.harness:'
                     'even_token_reward')


def even_token_reward(prompt, completion) -> float:
    """Fraction of completion tokens with an even id: a proxy reward
    for random weights at any vocabulary. ``count_token:ID`` almost never
    fires over a real vocabulary, which leaves every advantage 0; about
    half of any completion's tokens are even, so each group's rewards
    vary and the update's policy-gradient term is exercised."""
    return float((np.asarray(completion) % 2 == 0).mean())


def spawn_worker(dispatcher_addr, worker_id: str, *,
                 heartbeat_interval: float = 0.3,
                 extra_env: Optional[Dict[str, str]] = None,
                 device: str = 'cuda',
                 stats_file: Optional[str] = None) -> subprocess.Popen:
    """A REAL rollout-worker subprocess of the port on ``device``."""
    env = {**os.environ, 'PYTHONPATH': _REPO}
    env.update(extra_env or {})
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.train.rollout',
           'worker',
           '--dispatcher', f'{dispatcher_addr[0]}:{dispatcher_addr[1]}',
           '--worker-id', worker_id,
           '--heartbeat-interval', str(heartbeat_interval),
           '--device', device]
    if stats_file is not None:
        cmd += ['--stats-file', stats_file]
    return subprocess.Popen(cmd, cwd=_REPO, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def wait_alive(dispatcher_addr, n: int, timeout: float = 90.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        reply, _ = framed.request(dispatcher_addr, {'op': 'stats'},
                                  timeout=5.0)
        if reply['workers'].get('ALIVE', 0) >= n:
            return
        time.sleep(0.1)
    raise TimeoutError(f'{n} rollout workers not ALIVE within '
                       f'{timeout}s')


def _window_rate(walls: List[float], lo: int, hi: int,
                 samples_per_step: float) -> Optional[float]:
    """samples/sec over completed steps [lo, hi) (wall = step-end
    monotonic stamps)."""
    span = walls[lo:hi]
    if len(span) < 2:
        return None
    dt = span[-1] - span[0]
    return (len(span) - 1) * samples_per_step / dt if dt > 0 else None


def _kill_holders(disp, procs: Dict[str, subprocess.Popen], n: int,
                  killed: List[str], dead_ts: Dict[str, float]) -> None:
    """SIGKILL ``n`` live workers, each while it holds a lease (the most
    recently granted first, so the kill lands mid-generation); after
    _VICTIM_WAIT_S, whichever live workers are left."""
    deadline = time.monotonic() + _VICTIM_WAIT_S
    while len(killed) < n:
        live = [w for w, p in procs.items()
                if p.poll() is None and w not in killed]
        if not live:
            return
        holders = [w for w in disp.lease_owners() if w in live]
        if holders:
            victim = holders[0]
        elif time.monotonic() >= deadline:
            victim = live[0]
        else:
            time.sleep(0.01)
            continue
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait(timeout=10)
        dead_ts[victim] = time.monotonic()
        killed.append(victim)


def run_harvest(run_dir: str, *,
                n_workers: int,
                total_steps: int,
                kill_at_step: Optional[int] = None,
                kill_count: int = 0,
                respawn_at_step: Optional[int] = None,
                groups_per_step: int = 2,
                publish_every: int = 4,
                max_staleness: int = 8,
                learning_rate: float = 1e-3,
                heartbeat_timeout: float = 1.5,
                lease_timeout: float = 20.0,
                max_outstanding: int = 6,
                result_cap: int = 4,
                stall_budget_s: float = 120.0,
                worker_env: Optional[Dict[str, str]] = None,
                spec_overrides: Optional[Dict[str, Any]] = None,
                tag: str = 'run',
                device: str = 'cuda',
                stats_dir: Optional[str] = None,
                snapshot_max_to_keep: int = 4) -> Dict[str, Any]:
    """One complete harvested run under a deterministic kill schedule.

    ``kill_at_step``: after the learner completes that step, SIGKILL
    ``kill_count`` workers (no goodbye — mid-generation, lease holders
    first). ``respawn_at_step``: spawn the same number of fresh workers
    after that step (capacity rejoins). Returns the run artifact:
    learner history, samples/sec windows, recovery time, per-role busy
    seconds, and the killed worker ids (journal evidence keys).
    """
    os.makedirs(run_dir, exist_ok=True)
    if stats_dir is not None:
        os.makedirs(stats_dir, exist_ok=True)
    spec = default_spec(run_dir, tag=tag, **(spec_overrides or {}))
    disp = dispatcher_lib.RolloutDispatcher(
        os.path.join(run_dir, f'dispatcher-{tag}.db'),
        heartbeat_timeout=heartbeat_timeout,
        lease_timeout=lease_timeout,
        # Tight backpressure: the buffer must not bank the run, or
        # worker churn would be invisible to the learner's cadence.
        max_outstanding=max_outstanding,
        result_cap=result_cap).start()
    procs: Dict[str, subprocess.Popen] = {}
    spawn_ts: Dict[str, float] = {}
    dead_ts: Dict[str, float] = {}
    killed: List[str] = []
    killer: Optional[threading.Thread] = None
    respawn_wall: Optional[float] = None

    def _spawn(i: int) -> None:
        wid = f'rw-{tag}-{i}'
        procs[wid] = spawn_worker(
            disp.addr, wid, extra_env=worker_env, device=device,
            stats_file=(os.path.join(stats_dir, f'{wid}.json')
                        if stats_dir is not None else None))
        spawn_ts[wid] = time.monotonic()

    learner = None
    try:
        learner = learner_lib.RolloutLearner(
            spec, disp.addr, total_steps=total_steps,
            groups_per_step=groups_per_step,
            publish_every=publish_every, max_staleness=max_staleness,
            learning_rate=learning_rate,
            snapshot_max_to_keep=snapshot_max_to_keep,
            traj_log_dir=os.path.join(run_dir, f'traj-{tag}'),
            stall_budget_s=stall_budget_s, device=device,
            on_step=lambda step: _schedule(step))

        def _schedule(step: int) -> None:
            nonlocal killer, respawn_wall
            if kill_at_step is not None and step + 1 == kill_at_step \
                    and killer is None:
                killer = threading.Thread(
                    target=_kill_holders, name='harvest-killer',
                    args=(disp, procs, kill_count, killed, dead_ts),
                    daemon=True)
                killer.start()
            if respawn_at_step is not None and \
                    step + 1 == respawn_at_step and \
                    respawn_wall is None and killer is not None:
                killer.join()
                base = len(procs)
                for j in range(len(killed)):
                    _spawn(base + j)
                respawn_wall = time.monotonic()

        t_start = time.monotonic()
        # Workers first: their boot overlaps the learner's put_spec +
        # initial publish + warm-up.
        for i in range(n_workers):
            _spawn(i)
        learner.start()
        wait_alive(disp.addr, n_workers)
        history = learner.run()
        duration = time.monotonic() - t_start
        if killer is not None:
            killer.join()
        kill_wall = max(dead_ts.values()) if dead_ts else None

        walls = learner.step_walls
        per_step = groups_per_step * spec.group_size
        sps_all = _window_rate(walls, 0, len(walls), per_step)
        pre = post = degraded = best_post = None
        recovery_s = None
        if kill_at_step is not None and killed:
            # Pre-kill rate over the steady approach to the kill —
            # the first steps drain whatever the fleet banked during
            # the learner's warm-up and would inflate the baseline.
            pre = _window_rate(walls, max(1, kill_at_step - 5),
                               kill_at_step, per_step)
            degraded = _window_rate(
                walls, kill_at_step,
                min(len(walls), kill_at_step + 6), per_step)
            # Post-rejoin rate = the steady tail (respawned workers
            # pay their boot before they contribute — that warm-up IS
            # part of recovery time, not of the recovered rate).
            post = _window_rate(walls, max(0, len(walls) - 5),
                                len(walls), per_step)
            # Recovery: kill → first moment the trailing 3-step rate
            # is back to >= 90% of the pre-kill rate; and the BEST
            # trailing window after the rejoin.
            best_post = None
            for i in range(kill_at_step + 3, len(walls)):
                rate = _window_rate(walls, i - 3, i + 1, per_step)
                if rate is None:
                    continue
                if pre and recovery_s is None and rate >= 0.9 * pre:
                    recovery_s = walls[i] - kill_wall
                if respawn_at_step is not None and \
                        i >= respawn_at_step + 1 and \
                        (best_post is None or rate > best_post):
                    best_post = rate
        now = time.monotonic()
        worker_busy_s = sum(
            (dead_ts.get(wid, now) - t0)
            for wid, t0 in spawn_ts.items())
        return {
            'tag': tag,
            'spec_fp': spec.fingerprint(),
            'spec': spec,
            'steps': len(history),
            'duration_s': round(duration, 3),
            'history': history,
            'report': learner.report(),
            'samples_total': learner.samples_total,
            'samples_per_sec': sps_all,
            'pre_kill_sps': pre,
            'degraded_sps': degraded,
            'post_rejoin_sps': post,
            'best_post_rejoin_sps': best_post,
            'recovery_s': recovery_s,
            'killed': killed,
            'kill_wall': kill_wall,
            'respawn_wall': respawn_wall,
            'step_walls': list(walls),
            'workers': list(procs),
            'learner_busy_s': duration,
            'worker_busy_s': worker_busy_s,
            'traj_log_dir': os.path.join(run_dir, f'traj-{tag}'),
            'losses': [h['loss'] for h in history],
        }
    finally:
        # Learner first (stops the collect thread's redial loop), on
        # EVERY exit path — a RolloutStallError must not leak a live
        # thread + open sockets into the calling process.
        if learner is not None:
            learner.close()
        if killer is not None:
            killer.join()
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in procs.values():
            if proc.poll() is None:
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10)
        disp.stop()
