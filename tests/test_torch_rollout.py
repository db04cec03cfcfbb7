"""The port's harvested-RL plane (skypilot_tpu_torch/train/rollout/)
against the JAX package's, on the CPU.

Three kinds of test:
  - the assertions of tests/unit_tests/test_rollout.py, all of them,
    against the port's dispatcher, learner and worker (lease arc,
    redelivery, refused shapes, release, backpressure, a contained
    lease fault, the sticky spec fingerprint, monotonic publishes, the
    reaper's three arcs, the guarded setters, snapshot publish / fetch /
    retention, the staleness window, replay and preempt / resume, the
    KL anchor, contained worker faults);
  - parity with JAX: spec, prompts, lease seeds and fingerprints; the
    assembled batch; replay losses over a trajectory log the JAX
    learner wrote, from JAX's initial params carried across through
    models/weights.py; behaviour log-probs of forced completions;
    snapshots both ways;
  - the wire: a port worker and learner against the JAX dispatcher,
    and a JAX worker and learner against the port's.

Sampling is not compared across the packages (threefry and Philox draw
differently); per-lease determinism is a property within the port.

Tolerances (fp32 compute: both packages' ``get_config`` patched to an
fp32 llama-debug where the JAX numbers are compared):
  - prompts, lease seeds, fingerprints, completion masks, the assembled
    tokens and positions: exact; advantages: 1e-6 absolute;
  - behaviour log-probs: 2e-5 absolute (tests/test_torch_grpo.py's
    TOL_LP: two layers of fp32 products summed in other orders, then a
    logsumexp over the vocabulary);
  - replay losses over the JAX log: 2e-6 absolute at every step, on
    losses of 0.03-0.09 (the loss is a masked mean of O(1) ratio x
    advantage terms; AdamW carries the grads' fp32 rounding differences
    into the next step's params at lr x relative error; 5.6e-8 seen);
  - snapshots: bit-equal; the port's own replay: bit-equal.
"""
import dataclasses
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import models as jmodels
from skypilot_tpu.train import checkpoints as jcheckpoints
from skypilot_tpu.train import grpo as jgrpo
from skypilot_tpu.train.rollout import dispatcher as jdispatcher_lib
from skypilot_tpu.train.rollout import learner as jlearner_lib
from skypilot_tpu.train.rollout import spec as jspec_lib
from skypilot_tpu.train.rollout import worker as jworker_lib
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import decode, mla, module_for, weights
from skypilot_tpu_torch.observe import journal
from skypilot_tpu_torch.train import checkpoints, grpo, train_lib
from skypilot_tpu_torch.train.rollout import dispatcher as dispatcher_lib
from skypilot_tpu_torch.train.rollout import learner as learner_lib
from skypilot_tpu_torch.train.rollout import spec as spec_lib
from skypilot_tpu_torch.train.rollout import worker as worker_lib
from skypilot_tpu_torch.train.rollout.dispatcher import (RolloutLeaseStatus,
                                                         RolloutWorkerStatus)
from skypilot_tpu_torch.utils import failpoints
from skypilot_tpu_torch.utils import framed

VOCAB = 256   # llama-debug's vocab
TOL_ADV = 1e-6
TOL_LP = 2e-5
TOL_REPLAY = 2e-6


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv('SKYTPU_OBSERVE_DB', str(tmp_path / 'observe.db'))
    failpoints.reset()
    yield
    failpoints.reset()


@pytest.fixture
def fp32(monkeypatch):
    """Both packages' ``get_config`` give llama-debug in fp32 compute."""
    jget, tget = jmodels.get_config, config.get_config
    monkeypatch.setattr(jmodels, 'get_config', lambda name: dataclasses.replace(
        jget(name), dtype=jnp.float32))
    monkeypatch.setattr(config, 'get_config', lambda name: dataclasses.replace(
        tget(name), dtype=torch.float32))


def _spec(tmp_path, **overrides):
    fields = dict(model='llama-debug', reward='count_token:42',
                  snapshot_dir=str(tmp_path / 'snapshots'),
                  vocab_size=VOCAB, prompt_len=8, group_size=4,
                  max_new_tokens=8, seed=3)
    fields.update(overrides)
    return spec_lib.RolloutSpec(**fields)


def _jspec(spec):
    return jspec_lib.RolloutSpec(**spec.to_json())


def _traj_arrays(spec, value=1):
    g, t = spec.group_size, spec.max_new_tokens
    return {'completions': np.full((g, t), value, np.int32),
            'rewards': np.arange(g, dtype=np.float32),
            'behavior_lp': np.full((g, t), -1.0, np.float32)}


def _groups(spec, lease_ids, seed):
    """Trajectory groups with spread rewards and behaviour log-probs
    near a policy's (so ratios move and some clip)."""
    rng = np.random.default_rng(seed)
    g, t = spec.group_size, spec.max_new_tokens
    return [{'lease_id': int(l), 'version': 0,
             'completions': rng.integers(0, spec.vocab_size, (g, t))
             .astype(np.int32),
             'rewards': rng.random(g).astype(np.float32),
             'behavior_lp': (-np.log(spec.vocab_size) + 0.3 *
                             rng.standard_normal((g, t))).astype(np.float32)}
            for l in lease_ids]


class _Disp:
    """In-process port dispatcher + a one-shot client helper."""

    def __init__(self, tmp_path, **kwargs):
        kwargs.setdefault('heartbeat_timeout', 30.0)
        self.d = dispatcher_lib.RolloutDispatcher(
            str(tmp_path / 'disp.db'), **kwargs).start()

    def req(self, obj, arrays=None):
        return framed.request(self.d.addr, obj, arrays=arrays,
                              timeout=10.0)

    def register(self, wid):
        reply, _ = self.req({'op': 'register', 'worker_id': wid})
        return reply

    def lease(self, wid, n=1):
        reply, _ = self.req({'op': 'lease', 'worker_id': wid,
                             'max_n': n})
        return reply

    def submit(self, spec, wid, lease_id, version=0, arrays=None):
        reply, _ = self.req(
            {'op': 'submit', 'worker_id': wid, 'lease_id': lease_id,
             'snapshot_version': version},
            arrays=arrays or _traj_arrays(spec))
        return reply

    def stop(self):
        self.d.stop()


def _learner(spec, addr, **kw):
    kw.setdefault('warmup', False)
    kw.setdefault('device', 'cpu')
    return learner_lib.RolloutLearner(spec, addr, **kw)


def _worker(addr, wid):
    w = worker_lib.RolloutWorker(addr, worker_id=wid,
                                 heartbeat_interval=0.2,
                                 device='cpu').start()
    threading.Thread(target=w.run, daemon=True).start()
    return w


# ---------------------------------------------------------------- spec

class TestSpec:

    def test_json_round_trip_and_unknown_field_refusal(self, tmp_path):
        spec = _spec(tmp_path)
        clone = spec_lib.RolloutSpec.from_json(spec.to_json())
        assert clone == spec
        assert clone.fingerprint() == spec.fingerprint()
        with pytest.raises(ValueError, match='no fields'):
            spec_lib.RolloutSpec.from_json(
                {**spec.to_json(), 'mystery_knob': 1})
        with pytest.raises(TypeError, match='must be an object'):
            spec_lib.RolloutSpec.from_json([1])

    def test_prompts_are_pure_functions_of_lease_id(self, tmp_path):
        spec = _spec(tmp_path)
        a = spec_lib.prompt_for(spec, 7)
        b = spec_lib.prompt_for(spec, 7)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32 and a.shape == (spec.prompt_len,)
        assert a.min() >= 0 and a.max() < spec.vocab_size
        assert not np.array_equal(a, spec_lib.prompt_for(spec, 8))
        # Different job seed => different prompt stream.
        other = _spec(tmp_path, seed=4)
        assert not np.array_equal(a, spec_lib.prompt_for(other, 7))
        # RNG seeds: per-lease, distinct from each other.
        assert spec_lib.lease_rng_seed(spec, 7) != \
            spec_lib.lease_rng_seed(spec, 8)

    def test_singleton_groups_refused(self, tmp_path):
        with pytest.raises(ValueError, match='group_size'):
            _spec(tmp_path, group_size=1)

    @pytest.mark.parametrize('overrides', [
        {}, {'seed': 0, 'prompt_len': 64, 'vocab_size': 32768,
             'model': 'llama-1b', 'group_size': 8, 'max_new_tokens': 64,
             'kl_coef': 0.04}, {'seed': 2 ** 31 - 1, 'eos_id': 2,
                                'temperature': 0.7, 'rollout_delay_s': 0.25}])
    def test_prompts_seeds_and_fingerprints_equal_jax(self, tmp_path,
                                                       overrides):
        spec = _spec(tmp_path, **overrides)
        jspec = _jspec(spec)
        assert spec.to_json() == jspec.to_json()
        assert spec.fingerprint() == jspec.fingerprint()
        for lease_id in range(200):
            np.testing.assert_array_equal(
                spec_lib.prompt_for(spec, lease_id),
                jspec_lib.prompt_for(jspec, lease_id))
            assert spec_lib.lease_rng_seed(spec, lease_id) == \
                jspec_lib.lease_rng_seed(jspec, lease_id)
        for bad in ({'mystery_knob': 1}, {'group_size': 1}):
            with pytest.raises(ValueError) as mine:
                spec_lib.RolloutSpec.from_json({**spec.to_json(), **bad})
            with pytest.raises(ValueError) as theirs:
                jspec_lib.RolloutSpec.from_json({**spec.to_json(), **bad})
            assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------- lease lifecycle

class TestLeaseLifecycle:

    def test_lease_submit_collect_arc(self, tmp_path):
        spec = _spec(tmp_path)
        h = _Disp(tmp_path)
        try:
            assert h.register('w1')['ok']
            reply = h.lease('w1', n=2)
            assert reply['leases'] == [0, 1]
            sub = h.submit(spec, 'w1', 0, version=5)
            assert sub['accepted'] and not sub['duplicate']
            got, arrays = h.req({'op': 'collect', 'max_n': 4})
            assert [t['lease_id'] for t in got['trajectories']] == [0]
            assert got['trajectories'][0]['version'] == 5
            np.testing.assert_array_equal(
                arrays['completions_0'],
                _traj_arrays(spec)['completions'])
            # DONE is terminal: the duplicate (an at-least-once
            # re-execution) is dropped, not double-collected. The ack
            # retires the delivered group, so nothing remains.
            dup = h.submit(spec, 'w1', 0)
            assert dup['duplicate'] and not dup['accepted']
            got2, _ = h.req({'op': 'collect', 'max_n': 4,
                             'ack': [0]})
            assert got2['trajectories'] == []
        finally:
            h.stop()

    def test_collect_redelivers_unacked_groups(self, tmp_path):
        spec = _spec(tmp_path)
        h = _Disp(tmp_path)
        try:
            h.register('w1')
            h.lease('w1', n=2)
            h.submit(spec, 'w1', 0, version=1)
            h.submit(spec, 'w1', 1, version=1)
            got1, _ = h.req({'op': 'collect', 'max_n': 4})
            assert [t['lease_id'] for t in got1['trajectories']] \
                == [0, 1]
            # "Reply lost": the next collect carries no ack — both
            # groups come again (arrays included).
            got2, arrays2 = h.req({'op': 'collect', 'max_n': 4})
            assert [t['lease_id'] for t in got2['trajectories']] \
                == [0, 1]
            assert 'completions_1' in arrays2
            got3, _ = h.req({'op': 'collect', 'max_n': 4,
                             'ack': [0, 1]})
            assert got3['trajectories'] == []
        finally:
            h.stop()

    def test_bad_trajectory_shapes_refused(self, tmp_path):
        spec = _spec(tmp_path)
        h = _Disp(tmp_path)
        try:
            h.register('w1')
            h.lease('w1')
            bad = _traj_arrays(spec)
            bad['rewards'] = bad['rewards'][:-1]
            with pytest.raises(framed.RemoteError) as ei:
                h.submit(spec, 'w1', 0, arrays=bad)
            assert ei.value.kind == 'bad_trajectory'
            with pytest.raises(framed.RemoteError) as ei:
                h.req({'op': 'submit', 'worker_id': 'w1',
                       'lease_id': 0})
            assert ei.value.kind == 'bad_trajectory'
            with pytest.raises(framed.RemoteError) as ei:
                h.req({'op': 'no_such_op'})
            assert ei.value.kind == 'bad_op'
        finally:
            h.stop()

    def test_release_returns_lease_to_pool(self, tmp_path):
        h = _Disp(tmp_path)
        try:
            h.register('w1')
            h.register('w2')
            lease_id = h.lease('w1')['leases'][0]
            rel, _ = h.req({'op': 'release', 'worker_id': 'w1',
                            'lease_id': lease_id})
            assert rel['released']
            # Only the owner may release (w1 no longer owns it).
            rel2, _ = h.req({'op': 'release', 'worker_id': 'w1',
                             'lease_id': lease_id})
            assert not rel2['released']
            # The released lease is re-leased FIRST (oldest pending).
            assert lease_id in h.lease('w2', n=1)['leases']
        finally:
            h.stop()

    def test_backpressure_stops_minting(self, tmp_path):
        spec = _spec(tmp_path)
        h = _Disp(tmp_path, max_outstanding=8, result_cap=2)
        try:
            h.register('w1')
            granted = h.lease('w1', n=8)['leases']
            assert len(granted) == 2      # result_cap bounds minting
            assert h.d.result_backpressure() == 1.0
            for lease_id in granted:
                h.submit(spec, 'w1', lease_id)
            assert h.lease('w1', n=8)['leases'] == []   # backlog full
            h.req({'op': 'collect', 'max_n': 1})        # learner eats
            assert len(h.lease('w1', n=8)['leases']) == 1
        finally:
            h.stop()

    def test_lease_failpoint_is_contained(self, tmp_path):
        h = _Disp(tmp_path)
        try:
            h.register('w1')
            failpoints.arm('rollout.lease', once=True)
            with pytest.raises(framed.RemoteError):
                h.lease('w1')
            assert h.lease('w1')['leases'] == [0]   # next round fine
        finally:
            h.stop()

    def test_put_spec_sticky_fingerprint(self, tmp_path):
        spec = _spec(tmp_path)
        h = _Disp(tmp_path)
        try:
            reply, _ = h.req({'op': 'put_spec',
                              'spec': spec.to_json()})
            assert reply['spec_fp'] == spec.fingerprint()
            h.req({'op': 'put_spec', 'spec': spec.to_json()})
            other = _spec(tmp_path, seed=99)
            with pytest.raises(framed.RemoteError) as ei:
                h.req({'op': 'put_spec', 'spec': other.to_json()})
            assert ei.value.kind == 'spec_mismatch'
            with pytest.raises(framed.RemoteError) as ei:
                h.req({'op': 'put_spec', 'spec': {'model': 'x'}})
            assert ei.value.kind == 'spec'
            # A worker leasing or submitting for another job is refused.
            h.register('w1')
            with pytest.raises(framed.RemoteError) as ei:
                h.req({'op': 'lease', 'worker_id': 'w1',
                       'spec_fp': other.fingerprint()})
            assert ei.value.kind == 'spec_mismatch'
        finally:
            h.stop()

    def test_publish_versions_are_monotonic(self, tmp_path):
        h = _Disp(tmp_path)
        try:
            h.req({'op': 'publish', 'version': 3})
            reply, _ = h.req({'op': 'publish', 'version': 1})
            assert reply['snapshot_version'] == 3   # stale refused
            events = journal.query(kind='rollout_snapshot_publish',
                                   limit=10)
            assert [e['data']['version'] for e in events] == [3]
        finally:
            h.stop()


# ----------------------------------------------------- reaper arcs

class TestReaper:

    def test_dead_worker_leases_reassigned_with_journal(self, tmp_path):
        h = _Disp(tmp_path, heartbeat_timeout=0.4)
        try:
            h.register('w1')
            lease_id = h.lease('w1')['leases'][0]
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                stats, _ = h.req({'op': 'stats'})
                if stats['workers'].get('LOST'):
                    break
                time.sleep(0.05)
            assert stats['workers'] == {'LOST': 1}
            lost = journal.query(kind='rollout_worker_lost', limit=10)
            assert [e['entity'] for e in lost] == ['w1']
            reassigns = journal.query(kind='rollout_lease_reassign',
                                      limit=10)
            assert reassigns[0]['entity'] == 'w1'
            assert reassigns[0]['data']['leases'] == [lease_id]
            # A LOST worker's lease round answers resync, not leases.
            assert h.lease('w1').get('resync')
            h.register('w2')
            assert lease_id in h.lease('w2')['leases']
            conn = dispatcher_lib._connect(str(tmp_path / 'disp.db'))
            attempts = conn.execute(
                'SELECT attempts FROM leases WHERE lease_id = ?',
                (lease_id,)).fetchone()[0]
            assert attempts == 2
            # ...and the original owner's late submit still wins if it
            # lands first — at-least-once, first completion kept.
            assert h.register('w1')['rejoined']
            sub = h.submit(_spec(tmp_path), 'w1', lease_id)
            assert sub['accepted']
        finally:
            h.stop()

    def test_orphan_sweep_rescues_stranded_leases(self, tmp_path):
        h = _Disp(tmp_path, heartbeat_timeout=60.0)
        try:
            h.register('w1')
            lease_id = h.lease('w1')['leases'][0]
            conn = h.d._conn()
            old, changed = dispatcher_lib.set_rollout_worker_status(
                conn, 'w1', RolloutWorkerStatus.LOST,
                reason='simulated_crash')
            assert changed and old == 'ALIVE'
            h.d._reap_once()
            events = journal.query(kind='rollout_lease_reassign',
                                   limit=10)
            assert events and events[-1]['reason'] == 'orphan_sweep'
            assert events[-1]['data']['leases'] == [lease_id]
        finally:
            h.stop()

    def test_lease_timeout_reassigns_wedged_owner(self, tmp_path):
        h = _Disp(tmp_path, heartbeat_timeout=60.0, lease_timeout=0.3)
        try:
            h.register('w1')
            lease_id = h.lease('w1')['leases'][0]
            time.sleep(0.4)
            h.d._reap_once()
            events = journal.query(kind='rollout_lease_reassign',
                                   limit=10)
            assert events[-1]['reason'] == 'lease_timeout'
            assert events[-1]['data']['leases'] == [lease_id]
        finally:
            h.stop()


# ----------------------------------------------- guarded setter edges

class TestGuardedSetters:

    def test_done_is_terminal_and_entry_rules_hold(self, tmp_path):
        conn = dispatcher_lib._connect(str(tmp_path / 'sm.db'))
        assert dispatcher_lib.set_lease_status(
            conn, [(0, RolloutLeaseStatus.LEASED, 'w1')]) == []
        dispatcher_lib.set_lease_status(
            conn, [(0, RolloutLeaseStatus.PENDING, None)])
        applied = dispatcher_lib.set_lease_status(
            conn, [(0, RolloutLeaseStatus.LEASED, 'w1')])
        assert applied == [(0, 'PENDING', 'LEASED')]
        dispatcher_lib.set_lease_status(
            conn, [(0, RolloutLeaseStatus.DONE, None)])
        assert dispatcher_lib.set_lease_status(
            conn, [(0, RolloutLeaseStatus.PENDING, None)]) == []
        assert dispatcher_lib.set_lease_status(
            conn, [(0, RolloutLeaseStatus.LEASED, 'w2')]) == []
        old, changed = dispatcher_lib.set_rollout_worker_status(
            conn, 'ghost', RolloutWorkerStatus.LOST)
        assert not changed and old is None

    def test_failed_commit_rolls_the_edge_back(self, tmp_path):
        """An armed sqlite.commit failpoint is a commit that failed: the
        guarded setter's edge must not have happened."""
        conn = dispatcher_lib._connect(str(tmp_path / 'sm.db'))
        dispatcher_lib.set_lease_status(
            conn, [(0, RolloutLeaseStatus.PENDING, None)])
        with failpoints.armed('sqlite.commit', once=True):
            with pytest.raises(failpoints.FailpointError):
                dispatcher_lib.set_lease_status(
                    conn, [(0, RolloutLeaseStatus.LEASED, 'w1')])
        assert conn.execute('SELECT status FROM leases').fetchone() == \
            ('PENDING',)


# ------------------------------------------------------ policy plane

class TestPolicyPlane:
    """Snapshot publish/fetch + staleness + replay — the learner and
    worker halves meeting through the checkpoint format."""

    def test_snapshot_publish_fetch_and_retention(self, tmp_path):
        spec = _spec(tmp_path)
        h = _Disp(tmp_path)
        learner = None
        try:
            learner = _learner(spec, h.d.addr, total_steps=2,
                               snapshot_max_to_keep=2)
            learner.start()   # publishes v0
            learner._publish(1)
            learner._publish(2)
            snap = checkpoints.Checkpointer(spec.snapshot_dir)
            assert snap.all_steps() == [1, 2]   # v0 GC'd: retention
            stats, _ = h.req({'op': 'stats'})
            assert stats['snapshot_version'] == 2
            assert len(learner.report()['publish_s']) == 3
            cfg = config.get_config(spec.model)
            template = module_for(cfg).init_params(cfg, None, 'meta')
            restored, version = snap.restore_newest(template, 'cpu')
            assert version == 2
            live = train_lib.leaves(learner.state.params)
            fetched = train_lib.leaves(restored)
            assert len(live) == len(fetched)
            for a, b in zip(live, fetched):
                assert torch.equal(a.detach(), b)
            # A TrainState step does not restore as a params tree.
            with pytest.raises(ValueError, match='does not match'):
                checkpoints.Checkpointer(str(tmp_path / 'st')).save(
                    learner.state, 1, wait=True)
                checkpoints.Checkpointer(
                    str(tmp_path / 'st')).restore_newest(template, 'cpu')
        finally:
            if learner is not None:
                learner.close()
            h.stop()

    def test_stale_trajectories_dropped_at_the_window(self, tmp_path):
        spec = _spec(tmp_path)
        h = _Disp(tmp_path)
        learner = None
        try:
            learner = _learner(spec, h.d.addr, total_steps=2,
                               groups_per_step=1, max_staleness=2)
            learner.start()
            learner._version = 10   # as if 10 publishes happened
            stale = {'lease_id': 1, 'version': 7, **_traj_arrays(spec)}
            fresh = {'lease_id': 2, 'version': 9, **_traj_arrays(spec)}
            learner._queue.put(stale)
            learner._queue.put(fresh)
            groups = learner._gather()
            assert [g['lease_id'] for g in groups] == [2]
            assert learner.stale_dropped == 1
            drops = journal.query(kind='rollout_stale_drop', limit=10)
            assert drops[0]['data']['lease_id'] == 1
        finally:
            if learner is not None:
                learner.close()
            h.stop()

    def test_gather_stalls_loudly(self, tmp_path):
        spec = _spec(tmp_path)
        h = _Disp(tmp_path)
        learner = None
        try:
            learner = _learner(spec, h.d.addr, total_steps=1,
                               stall_budget_s=0.3)
            learner.start()
            with pytest.raises(learner_lib.RolloutStallError):
                learner._gather()
        finally:
            if learner is not None:
                learner.close()
            h.stop()

    def test_run_replay_bit_equal_and_preempt_resume(self, tmp_path):
        spec = _spec(tmp_path, kl_coef=0.05)
        h = _Disp(tmp_path)
        state_dir = str(tmp_path / 'state')
        log_dir = str(tmp_path / 'traj')
        learner = worker = None
        try:
            learner = _learner(spec, h.d.addr, total_steps=3,
                               groups_per_step=1, publish_every=2,
                               learning_rate=1e-3, state_dir=state_dir,
                               traj_log_dir=log_dir, stall_budget_s=90.0,
                               warmup=True)
            learner.start()
            worker = _worker(h.d.addr, 'rw-unit')
            history = learner.run()
            assert len(history) == 3
            live = [rec['loss'] for rec in history]
            assert os.path.isdir(log_dir) and \
                len(os.listdir(log_dir)) == 3
            replayed = learner_lib.replay_losses(
                spec, log_dir, learning_rate=1e-3, total_steps=3,
                device='cpu')
            assert replayed == live   # BIT-equal, not allclose
            assert worker.generated >= 3
            resumed = _learner(spec, h.d.addr, total_steps=5,
                               groups_per_step=1, state_dir=state_dir)
            assert resumed.start_step == 3
            for a, b in zip(train_lib.leaves(resumed.state.params),
                            train_lib.leaves(learner.state.params)):
                assert torch.equal(a, b)
            resumed.close()
        finally:
            if worker is not None:
                worker.stop()
            if learner is not None:
                learner.close()
            h.stop()

    @pytest.mark.parametrize('notice', ['sigterm', 'failpoint'])
    def test_preemption_saves_once_and_resumes(self, tmp_path, notice):
        """A preemption notice (SIGTERM on the main thread, or the
        trainer.preempt failpoint) ends the run at the step boundary
        with one synchronous final state save; a fresh learner resumes
        from it."""
        spec = _spec(tmp_path)
        h = _Disp(tmp_path)
        state_dir = str(tmp_path / 'state')
        learner = worker = None

        def on_step(step):
            if step == 0 and notice == 'sigterm':
                os.kill(os.getpid(), signal.SIGTERM)
        try:
            if notice == 'failpoint':
                failpoints.arm('trainer.preempt', once=True)
            learner = _learner(spec, h.d.addr, total_steps=4,
                               groups_per_step=1, publish_every=10,
                               state_dir=state_dir, on_step=on_step)
            learner.start()
            worker = _worker(h.d.addr, 'rw-pre')
            history = learner.run()
            assert [r['step'] for r in history] == [1]
            assert checkpoints.Checkpointer(state_dir).all_steps() == [1]
            resumed = _learner(spec, h.d.addr, total_steps=4,
                               groups_per_step=1, state_dir=state_dir)
            assert resumed.start_step == 1
            resumed.close()
        finally:
            if worker is not None:
                worker.stop()
            if learner is not None:
                learner.close()
            h.stop()

    def test_kl_reference_anchors_to_initial_policy_across_resume(
            self, tmp_path):
        spec = _spec(tmp_path, kl_coef=0.1)
        h = _Disp(tmp_path)
        first = resumed = None
        try:
            state_dir = str(tmp_path / 'state')
            first = _learner(spec, h.d.addr, total_steps=9,
                             state_dir=state_dir)
            params = first.state.params
            moved = train_lib.TrainState(
                step=first.state.step,
                params=weights.tree_unflatten(params, [
                    t.detach() + 1.0 for t in train_lib.leaves(params)]),
                opt_state=first.state.opt_state)
            first._state_ckpt.save(moved, 5, wait=True)
            resumed = _learner(spec, h.d.addr, total_steps=9,
                               state_dir=state_dir)
            assert resumed.start_step == 5
            for init_leaf, ref_leaf, state_leaf in zip(
                    train_lib.leaves(first._ref),
                    train_lib.leaves(resumed._ref),
                    train_lib.leaves(resumed.state.params)):
                assert torch.equal(ref_leaf, init_leaf)
                assert not torch.equal(ref_leaf, state_leaf.detach())
            batch = learner_lib._assemble_batch(
                spec, resumed._gcfg,
                [{'lease_id': 0, 'version': 0, **_traj_arrays(spec)}])
            ref_lp = learner_lib._ref_logprobs(
                resumed._ref_lp_fn, resumed._ref, batch)
            assert ref_lp.shape == (spec.group_size,
                                    spec.max_new_tokens)
            assert float(ref_lp.max()) <= 0.0
        finally:
            if first is not None:
                first.close()
            if resumed is not None:
                resumed.close()
            h.stop()

    def test_worker_contains_generate_and_fetch_faults(self, tmp_path):
        spec = _spec(tmp_path)
        h = _Disp(tmp_path)
        learner = worker = None
        try:
            learner = _learner(spec, h.d.addr, total_steps=2,
                               groups_per_step=1, publish_every=1,
                               stall_budget_s=90.0)
            learner.start()
            failpoints.arm('rollout.generate', prob=0.3, seed=11)
            failpoints.arm('rollout.snapshot_fetch', prob=0.3, seed=12)
            worker = _worker(h.d.addr, 'rw-fault')
            history = learner.run()
            assert len(history) == 2
            assert learner.samples_total == 2 * spec.group_size
            assert failpoints.hits('rollout.generate') >= 2
        finally:
            failpoints.reset()
            if worker is not None:
                worker.stop()
            if learner is not None:
                learner.close()
            h.stop()

    def test_roles_refuse_a_mesh_and_a_missing_card(self, tmp_path,
                                                    monkeypatch):
        spec = _spec(tmp_path)
        with pytest.raises(NotImplementedError, match='item 8'):
            _learner(spec, ('127.0.0.1', 1), total_steps=1,
                     mesh=object())
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            worker_lib.RolloutWorker(('127.0.0.1', 1))
        with pytest.raises(RuntimeError, match='no CUDA device'):
            learner_lib.RolloutLearner(spec, ('127.0.0.1', 1),
                                       total_steps=1)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            learner_lib.replay_losses(spec, str(tmp_path),
                                      learning_rate=1e-3, total_steps=1)


# ------------------------------------------------- parity with JAX

def _jax_tree(spec):
    """JAX's initial params for ``spec`` (its learner's _init_state)."""
    jcfg = jmodels.get_config(spec.model)
    return jax.device_get(jmodels.module_for(jcfg).init_params(
        jax.random.PRNGKey(spec.seed), jcfg))


@pytest.mark.parametrize('eos_id', [None, 5])
def test_assembled_batch_equals_jax(tmp_path, eos_id):
    spec = _spec(tmp_path, eos_id=eos_id)
    groups = _groups(spec, [3, 11, 4], seed=1)
    groups[0]['completions'][1, 2] = 5
    groups[1]['rewards'][:] = 0.5          # a zero-variance group
    gcfg = grpo.GRPOConfig(group_size=spec.group_size,
                           max_new_tokens=spec.max_new_tokens)
    jgcfg = jgrpo.GRPOConfig(group_size=spec.group_size,
                             max_new_tokens=spec.max_new_tokens)
    got = learner_lib._assemble_batch(spec, gcfg, groups)
    want = jlearner_lib._assemble_batch(_jspec(spec), jgcfg, groups)
    names = ('seq', 'comp_idx', 'behavior_lp', 'adv', 'mask')
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        if name == 'adv':
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=TOL_ADV)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    if eos_id is not None:
        assert got[4][1, 3:].sum() == 0 and got[4][1, :3].all()


def test_replay_losses_over_a_jax_log_equal_jax(tmp_path, fp32):
    """The JAX learner trains 4 steps (a KL reference) on fixed groups
    and writes its trajectory log; the port replays that log from JAX's
    initial params, bridged, and meets JAX's live losses at every
    step, as JAX's own replay does bit for bit."""
    spec = _spec(tmp_path, kl_coef=0.05, seed=0)
    jspec = _jspec(spec)
    log_dir = str(tmp_path / 'traj')
    h = _Disp(tmp_path)       # the JAX learner talks to the port's
    learner = None
    try:
        learner = jlearner_lib.RolloutLearner(
            jspec, h.d.addr, total_steps=4, groups_per_step=2,
            learning_rate=1e-3, traj_log_dir=log_dir, warmup=False,
            publish_every=2, stall_budget_s=60.0)
        learner.start()
        for g in _groups(spec, range(8), seed=2):
            learner._queue.put(g)
        history = learner.run()
        stats, _ = h.req({'op': 'stats'})
    finally:
        if learner is not None:
            learner.close()
        h.stop()
    live = [rec['loss'] for rec in history]
    assert len(live) == 4 and stats['snapshot_version'] == 2
    assert stats['spec_fp'] == spec.fingerprint()
    assert jlearner_lib.replay_losses(jspec, log_dir, learning_rate=1e-3,
                                      total_steps=4) == live
    tcfg = config.get_config(spec.model)
    init = weights.params_from_jax(_jax_tree(spec), tcfg, 'cpu',
                                   torch.float32)
    mine = learner_lib.replay_losses(spec, log_dir, learning_rate=1e-3,
                                     total_steps=4, device='cpu',
                                     init_params=init)
    assert len(mine) == 4
    np.testing.assert_allclose(mine, live, rtol=0, atol=TOL_REPLAY)
    assert max(abs(x) for x in live) > 10 * TOL_REPLAY
    # Replay from the port's own init is another trajectory.
    other = learner_lib.replay_losses(spec, log_dir, learning_rate=1e-3,
                                      total_steps=4, device='cpu')
    assert other != mine


def test_forced_behavior_logprobs_equal_jax(tmp_path, fp32):
    spec = _spec(tmp_path, temperature=0.8)
    jw = jworker_lib.RolloutWorker(('127.0.0.1', 1), worker_id='jw')
    pw = worker_lib.RolloutWorker(('127.0.0.1', 1), worker_id='pw',
                                  device='cpu')
    jw._spec, pw._spec = _jspec(spec), spec
    assert jw._ensure_model() and pw._ensure_model()
    tree = _jax_tree(spec)
    tcfg = config.get_config(spec.model)
    pw._params = decode.cast_params_for_compute(
        weights.params_from_jax(tree, tcfg, 'cpu', torch.float32), tcfg)
    rng = np.random.default_rng(4)
    s, t, g = spec.prompt_len, spec.max_new_tokens, spec.group_size
    for lease_id in (0, 9):
        rep = np.repeat(spec_lib.prompt_for(spec, lease_id)[None], g, 0)
        comp = rng.integers(0, VOCAB, (g, t)).astype(np.int32)
        mine = pw.behavior_logprobs(torch.from_numpy(rep),
                                    torch.from_numpy(comp))
        lp_full, _ = jw._lp_fn(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(np.concatenate([rep, comp], 1)))
        want = np.asarray(lp_full)[:, s - 1:s - 1 + t]
        assert mine.shape == (g, t) and mine.dtype == torch.float32
        np.testing.assert_allclose(mine.numpy(), want, rtol=0, atol=TOL_LP)
    pw.stop()     # jw never started: nothing of it to stop


def test_port_snapshot_restores_in_jax_and_jax_snapshot_in_port_worker(
        tmp_path):
    spec = _spec(tmp_path)
    h = _Disp(tmp_path)
    learner = None
    try:
        learner = _learner(spec, h.d.addr, total_steps=1)
        learner.start()            # the port publishes v0
    finally:
        if learner is not None:
            learner.close()
        h.stop()
    jcfg = jmodels.get_config(spec.model)
    abstract = jax.eval_shape(lambda: jmodels.module_for(jcfg).init_params(
        jax.random.PRNGKey(0), jcfg))
    restored, version = jcheckpoints.Checkpointer(
        spec.snapshot_dir).restore_newest(abstract)
    assert version == 0
    want = weights.tree_paths(learner.state.params)
    got = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert [jax.tree_util.keystr(k) for k, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())

    # The other way: a JAX snapshot (its learner's bare params tree) at
    # version 3, fetched by a port worker.
    tree = _jax_tree(spec)
    jdir = str(tmp_path / 'jax-snaps')
    with jcheckpoints.Checkpointer(jdir, async_save=False) as ck:
        ck.save(jax.tree.map(jnp.asarray, tree), 3, wait=True)
    pw = worker_lib.RolloutWorker(('127.0.0.1', 1), worker_id='pw',
                                  device='cpu')
    pw._spec = dataclasses.replace(spec, snapshot_dir=jdir)
    pw._latest_version = 3
    assert pw._ensure_model() and pw._ensure_snapshot()
    assert pw._held_version == 3 and len(pw.restore_s) == 1
    tcfg = config.get_config(spec.model)
    bridged = decode.cast_params_for_compute(
        weights.params_from_jax(tree, tcfg, 'cpu', torch.float32), tcfg)
    for a, b in zip(train_lib.leaves(pw._params), train_lib.leaves(bridged)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    pw.stop()


# ------------------------------------------------------- the wire

def test_port_worker_and_learner_against_the_jax_dispatcher(tmp_path):
    spec = _spec(tmp_path)
    d = jdispatcher_lib.RolloutDispatcher(str(tmp_path / 'jdisp.db'),
                                          heartbeat_timeout=30.0).start()
    learner = worker = None
    try:
        learner = _learner(spec, d.addr, total_steps=2,
                           groups_per_step=1, publish_every=1)
        learner.start()
        worker = _worker(d.addr, 'rw-port')
        history = learner.run()
        assert len(history) == 2
        stats, _ = framed.request(d.addr, {'op': 'stats'}, timeout=10.0)
        assert stats['snapshot_version'] == 2
        assert stats['spec_fp'] == spec.fingerprint()
        assert stats['leases'].get('DONE', 0) >= 2
        assert stats['workers'] == {'ALIVE': 1}
    finally:
        if worker is not None:
            worker.stop()
        if learner is not None:
            learner.close()
        d.stop()


def test_jax_worker_against_the_port_dispatcher_and_learner(tmp_path):
    """A JAX worker leases from the port's dispatcher, restores the
    port learner's snapshot and submits groups the port learner trains
    on."""
    spec = _spec(tmp_path)
    h = _Disp(tmp_path)
    learner = jw = None
    try:
        learner = _learner(spec, h.d.addr, total_steps=2,
                           groups_per_step=1)
        learner.start()
        jw = jworker_lib.RolloutWorker(h.d.addr, worker_id='rw-jax',
                                       heartbeat_interval=0.2).start()
        threading.Thread(target=jw.run, daemon=True).start()
        history = learner.run()
        assert len(history) == 2 and learner.samples_total == \
            2 * spec.group_size
        assert jw._held_version == 0
    finally:
        if jw is not None:
            jw.stop()
        if learner is not None:
            learner.close()
        h.stop()


# ------------------------------------------- the worker's compute cast

@pytest.mark.parametrize('name', ['llama-debug', 'moe-debug', 'mla-debug',
                                  'gptoss-debug', 'deepseek-moe-debug'])
def test_cast_once_equals_cast_at_use(name):
    """The compute cast (the worker's once a version, GRPOTrainer's once
    an iteration) gives the bits the model's cast at use gives, in every
    family: behaviour log-probs and sampled generations are equal on the
    fp32 masters and on the cast tree."""
    cfg = config.get_config(name)
    params = module_for(cfg).init_params(
        cfg, torch.Generator().manual_seed(1), 'cpu')
    cast = decode.cast_params_for_compute(params, cfg)
    assert any(t.dtype == torch.float32 for t in train_lib.leaves(cast))
    assert sum(t.numel() * t.element_size() for t in
               train_lib.leaves(cast)) < 0.6 * sum(
        t.numel() * t.element_size() for t in train_lib.leaves(params))
    prompt = torch.randint(0, cfg.vocab_size, (4, 8),
                           generator=torch.Generator().manual_seed(2),
                           dtype=torch.int32)
    dec = mla if isinstance(cfg, config.MLAConfig) else decode
    outs = []
    for tree in (params, cast):
        gen = dec.generate(tree, prompt, cfg, 6, max_len=14,
                           temperature=1.0,
                           generator=torch.Generator().manual_seed(3))
        seq = torch.cat([prompt, gen], 1)
        with torch.no_grad():
            lp, _ = grpo.token_logprobs(tree, seq, cfg, module_for(cfg))
        outs.append((gen, lp))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_same_lease_is_byte_identical_within_the_port(tmp_path):
    """One lease generated twice against one snapshot gives the same
    bytes (completions, rewards, behaviour log-probs); two leases
    differ."""
    spec = _spec(tmp_path, temperature=1.0)
    cfg = config.get_config(spec.model)
    with checkpoints.Checkpointer(spec.snapshot_dir) as ck:
        ck.save(module_for(cfg).init_params(
            cfg, torch.Generator().manual_seed(0), 'cpu'), 0, wait=True)
    pw = worker_lib.RolloutWorker(('127.0.0.1', 1), worker_id='pw',
                                  device='cpu')
    pw._spec, pw._latest_version = spec, 0
    assert pw._ensure_model() and pw._ensure_snapshot()
    a, b, c = pw._generate(5), pw._generate(5), pw._generate(6)
    for key in ('completions', 'rewards', 'behavior_lp'):
        assert a[key].tobytes() == b[key].tobytes(), key
    assert a['completions'].tobytes() != c['completions'].tobytes()
    assert a['completions'].shape == (spec.group_size, spec.max_new_tokens)
    pw.stop()


def test_metric_families_equal_jax():
    """Every skytpu_rollout_* family under JAX's name, kind, help,
    labels and buckets."""
    from skypilot_tpu.train.rollout import telemetry as jtelemetry
    from skypilot_tpu_torch.train.rollout import telemetry

    def families(mod):
        return {m.name: (m.kind, m.help_text, m._labelspec(),
                         getattr(m, 'buckets', None))
                for m in vars(mod).values()
                if hasattr(m, 'help_text') and hasattr(m, 'kind')}
    mine = families(telemetry)
    assert len(mine) == 10
    assert mine == families(jtelemetry)
    assert {m.name for m in telemetry.REGISTRY.metrics()} == set(mine)
