"""The rollout plane's metric families (a copy of
skypilot_tpu/train/rollout/telemetry.py: every ``skytpu_rollout_*``
family under the same name, help, labels and buckets).

One module owns every declaration: dispatcher, worker and learner all
import from here, so two copies of a declaration can never drift.
The families live on :data:`REGISTRY`, one per process (the JAX
package's process-wide default registry); ``REGISTRY.render()`` is
their Prometheus text exposition.
"""
from __future__ import annotations

from skypilot_tpu_torch.observe import metrics as metrics_lib

REGISTRY = metrics_lib.Registry()

WORKERS_UP = REGISTRY.gauge(
    'skytpu_rollout_workers_up',
    'Rollout workers currently ALIVE in the dispatcher registry')

LEASES = REGISTRY.counter(
    'skytpu_rollout_leases_total',
    'Prompt-lease events at the dispatcher',
    labels={'event': ('minted', 'leased', 'done', 'reassigned',
                      'duplicate', 'released')})

TRAJECTORIES = REGISTRY.counter(
    'skytpu_rollout_trajectories_total',
    'Completed trajectory groups by role (worker=submitted, '
    'learner=consumed)',
    labels={'role': ('worker', 'learner')})

SAMPLES = REGISTRY.counter(
    'skytpu_rollout_samples_total',
    'Completions consumed by the learner (trajectory groups x G)')

STALENESS = REGISTRY.histogram(
    'skytpu_rollout_staleness',
    'Snapshot-version lag (published - generating version) of each '
    'trajectory group at consumption',
    buckets=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0))

STALE_DROPPED = REGISTRY.counter(
    'skytpu_rollout_stale_dropped_total',
    'Trajectory groups dropped for exceeding the staleness window')

SNAPSHOT_VERSION = REGISTRY.gauge(
    'skytpu_rollout_snapshot_version',
    'Latest policy snapshot version announced to the dispatcher')

QUEUE_DEPTH = REGISTRY.gauge(
    'skytpu_rollout_queue_depth',
    'Buffered trajectory groups awaiting consumption',
    labels={'role': ('dispatcher', 'learner')})

STEP_SECONDS = REGISTRY.histogram(
    'skytpu_rollout_step_seconds',
    'Learner wall-clock per optimizer step (gather + update)')

GENERATE_SECONDS = REGISTRY.histogram(
    'skytpu_rollout_generate_seconds',
    'Worker wall-clock per trajectory group (generate + score)')
