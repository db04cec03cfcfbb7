"""The port's harvested-RL plane under worker churn, on the CPU: real
subprocesses of ``python -m skypilot_tpu_torch.train.rollout``.

The arc of tests/chaos/test_rollout_churn.py against the port's
dispatcher, learner and workers on llama-debug: three workers, two of
them SIGKILLed after step 4 and two fresh ones spawned after step 6. It
asserts only what suite contention cannot move:
  - the learner completes every step;
  - every killed worker is journaled ``rollout_worker_lost`` and its
    orphaned leases ``rollout_lease_reassign`` (reason
    heartbeat_timeout);
  - no inter-step gap reaches the stall budget;
  - replaying the trajectory log gives the live losses bit for bit.
Rates belong on the card (chip_smoke.py's harvest phase prints them).
Every listener takes port 0; the workers pace themselves with the JAX
harness's ``rollout_delay_s`` and run one intra-op thread each.

Then the CLI: the dispatcher's readiness line, its stats and a lease
surviving a restart on the same --db (the orphan sweep hands it back),
and one plane of three processes (dispatcher, worker, learner) with
``--device cpu``.
"""
import json
import os
import subprocess
import sys
import time

import pytest

from skypilot_tpu_torch.observe import journal
from skypilot_tpu_torch.train.rollout import harness
from skypilot_tpu_torch.train.rollout import learner as learner_lib
from skypilot_tpu_torch.utils import framed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOTAL_STEPS = 12
KILL_AT = 4
KILL_COUNT = 2
RESPAWN_AT = 6
HEARTBEAT_TIMEOUT = 2.5
LEARNING_RATE = 1e-3
STALL_BUDGET_S = 120.0
# One intra-op thread a worker: three model processes beside the suite.
WORKER_ENV = {'OMP_NUM_THREADS': '1', 'MKL_NUM_THREADS': '1'}


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv('SKYTPU_OBSERVE_DB', str(tmp_path / 'observe.db'))


def test_sigkill_two_workers_mid_run(tmp_path):
    art = harness.run_harvest(
        str(tmp_path), n_workers=3, total_steps=TOTAL_STEPS,
        kill_at_step=KILL_AT, kill_count=KILL_COUNT,
        respawn_at_step=RESPAWN_AT, heartbeat_timeout=HEARTBEAT_TIMEOUT,
        lease_timeout=15.0, learning_rate=LEARNING_RATE,
        stall_budget_s=STALL_BUDGET_S, tag='churn', device='cpu',
        worker_env=WORKER_ENV, stats_dir=str(tmp_path / 'stats'),
        spec_overrides={'kl_coef': 0.05})

    # Every step completed: losing 2 of 3 workers slowed the learner,
    # never stopped it.
    assert art['steps'] == TOTAL_STEPS
    assert len(art['killed']) == KILL_COUNT
    assert len(art['workers']) == 3 + KILL_COUNT

    # Journal evidence per kill (>= 1: a starved heartbeat on a loaded
    # host can cost a worker one more real reap and rejoin).
    lost = [e['entity'] for e in
            journal.query(kind='rollout_worker_lost', limit=200)]
    reassigns = [e for e in
                 journal.query(kind='rollout_lease_reassign', limit=200)
                 if e['entity'] in art['killed']]
    for wid in art['killed']:
        assert lost.count(wid) >= 1, (wid, lost)
        assert any(e['entity'] == wid and e['data']['leases']
                   for e in reassigns), (wid, reassigns)
    for ev in reassigns:
        assert ev['reason'] == 'heartbeat_timeout'

    # No step waited out the stall budget.
    gaps = [rec['sec_per_step'] for rec in art['history']]
    assert max(gaps) < STALL_BUDGET_S, gaps

    # Replay of the journaled stream is the live loss trajectory, bit
    # for bit: churn shifted WHEN trajectories arrived, never WHAT the
    # learner trained on.
    replayed = learner_lib.replay_losses(
        art['spec'], art['traj_log_dir'], learning_rate=LEARNING_RATE,
        total_steps=TOTAL_STEPS, device='cpu')
    assert replayed == art['losses']
    assert len(replayed) == TOTAL_STEPS and any(replayed)

    # Each worker's accounting: the killed ones generated before dying.
    for wid in art['killed']:
        with open(tmp_path / 'stats' / f'{wid}.json') as f:
            stats = json.load(f)
        assert stats['generated'] >= 1 and stats['device'] == 'cpu'


def _readiness(proc, n=20):
    for _ in range(n):
        line = proc.stdout.readline().strip()
        if line.startswith('{'):
            return json.loads(line)
    return None


def _cli(args, env, **kw):
    return subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.rollout', *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, **kw)


def _env(tmp_path):
    return {**os.environ, 'PYTHONPATH': REPO, **WORKER_ENV,
            'SKYTPU_OBSERVE_DB': str(tmp_path / 'cli-observe.db')}


def test_cli_dispatcher_readiness_stats_and_restart(tmp_path):
    env = _env(tmp_path)
    db = str(tmp_path / 'cli-disp.db')
    proc = _cli(['dispatcher', '--host', '127.0.0.1', '--port', '0',
                 '--db', db], env)
    try:
        ready = _readiness(proc)
        assert ready is not None and ready['role'] == 'dispatcher'
        addr = framed.parse_addr(ready['addr'])
        reply, _ = framed.request(addr, {'op': 'stats'}, timeout=10.0)
        assert reply['ok'] and reply['snapshot_version'] == -1
        # A lease survives a dispatcher restart (WAL sqlite).
        framed.request(addr, {'op': 'register', 'worker_id': 'w1'},
                       timeout=10.0)
        framed.request(addr, {'op': 'lease', 'worker_id': 'w1',
                              'max_n': 1}, timeout=10.0)
    finally:
        proc.terminate()
        proc.wait(timeout=10)
    proc2 = _cli(['dispatcher', '--host', '127.0.0.1', '--port', '0',
                  '--db', db, '--heartbeat-timeout', '1.0'], env)
    try:
        addr = framed.parse_addr(_readiness(proc2)['addr'])
        reply, _ = framed.request(addr, {'op': 'stats'}, timeout=10.0)
        assert sum(reply['leases'].values()) == 1
        # The restarted reaper hands back the lease its dead owner (w1
        # never heartbeats again) stranded.
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            reply, _ = framed.request(addr, {'op': 'stats'},
                                      timeout=10.0)
            if reply['leases'].get('PENDING'):
                break
            time.sleep(0.2)
        assert reply['leases'].get('PENDING') == 1
    finally:
        proc2.terminate()
        proc2.wait(timeout=10)


def test_cli_plane_of_three_processes(tmp_path):
    """dispatcher, worker and learner as `python -m
    skypilot_tpu_torch.train.rollout` processes with --device cpu: the
    learner's done line reports every step."""
    env = _env(tmp_path)
    procs = []
    try:
        disp = _cli(['dispatcher', '--host', '127.0.0.1', '--port', '0',
                     '--db', str(tmp_path / 'd.db')], env)
        procs.append(disp)
        addr = _readiness(disp)['addr']
        stats_file = str(tmp_path / 'w.json')
        procs.append(_cli(['worker', '--dispatcher', addr, '--worker-id',
                           'rw-cli', '--heartbeat-interval', '0.3',
                           '--device', 'cpu', '--stats-file', stats_file],
                          env))
        learner = _cli(['learner', '--dispatcher', addr, '--reward',
                        'count_token:42', '--snapshot-dir',
                        str(tmp_path / 'snaps'), '--steps', '3',
                        '--groups-per-step', '1', '--prompt-len', '8',
                        '--max-new-tokens', '8', '--publish-every', '2',
                        '--traj-log', str(tmp_path / 'traj'),
                        '--device', 'cpu'], env)
        procs.append(learner)
        out, _ = learner.communicate(timeout=180)
        assert learner.returncode == 0
        lines = [json.loads(l) for l in out.splitlines()
                 if l.startswith('{')]
        assert lines[0]['role'] == 'learner' and lines[0]['start_step'] == 0
        assert lines[-1]['done'] and lines[-1]['steps'] == 3
        assert lines[-1]['snapshot_version'] == 1
        assert len(os.listdir(tmp_path / 'traj')) == 3
        with open(stats_file) as f:
            assert json.load(f)['generated'] >= 3
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
