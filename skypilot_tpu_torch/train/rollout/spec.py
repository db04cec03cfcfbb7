"""RolloutSpec: everything a stateless rollout worker needs (a copy of
skypilot_tpu/train/rollout/spec.py: ``RolloutSpec``, ``fingerprint``,
``prompt_for`` and ``lease_rng_seed``, the same numbers byte for byte,
so the two packages agree on every prompt and fingerprint).

The PROMPT of lease ``i`` is a pure function of ``(spec, i)``
(:func:`prompt_for`), and the sampling RNG a worker uses for lease
``i`` is seeded from ``(spec.seed, i)`` (:func:`lease_rng_seed`). So
reassigning a lease ships one integer, any worker can serve any lease,
and a duplicate execution of the same lease AGAINST THE SAME SNAPSHOT
produces byte-identical trajectories (first submission wins either
way: at-least-once is safe by construction). The port seeds a
``torch.Generator`` with that seed, the JAX package a threefry key, so
the two packages sample different completions from one lease.

Specs are fingerprinted (sha256 of canonical JSON) and ``from_json``
refuses unknown fields: two processes silently disagreeing about the
pipeline must fail loudly at the first RPC.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class RolloutSpec:
    """One harvested-RL job: model, reward, GRPO shape, snapshot dir.

    ``snapshot_dir`` must resolve on every worker (shared storage /
    mounted bucket — the same contract ``--ckpt-dir`` places on the
    trainer). ``vocab_size`` is explicit (not derived from the model
    preset) so the model-free dispatcher can describe prompts without
    importing the model stack.
    """
    model: str                     # models preset name
    reward: str                    # grpo.resolve_reward spec string
    snapshot_dir: str              # learner-published policy snapshots
    vocab_size: int
    prompt_len: int = 16
    group_size: int = 4            # completions per prompt (G)
    max_new_tokens: int = 16       # completion length (T, static)
    temperature: float = 1.0
    clip_eps: float = 0.2
    kl_coef: float = 0.0
    eos_id: Optional[int] = None
    seed: int = 0
    # Bench/chaos knob (the DatasetSpec.preprocess_delay_s precedent):
    # an artificial per-group generation cost, so "rollout capacity is
    # the bottleneck and worker churn is visible" holds on a CPU proxy
    # whose tiny model generates faster than real rollouts ever would.
    # Affects timing only, never trajectory content.
    rollout_delay_s: float = 0.0

    def __post_init__(self):
        if self.vocab_size <= 0:
            raise ValueError(f'vocab_size={self.vocab_size} must be > 0')
        if self.prompt_len <= 0 or self.max_new_tokens <= 0:
            raise ValueError('prompt_len and max_new_tokens must be > 0')
        if self.group_size < 2:
            raise ValueError(
                f'group_size={self.group_size} must be >= 2: the group '
                f'IS the GRPO baseline — a singleton group has zero '
                f'advantage by construction and learns nothing')

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> 'RolloutSpec':
        if not isinstance(obj, dict):
            raise TypeError(f'RolloutSpec JSON must be an object, '
                            f'got {type(obj).__name__}')
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(
                f'RolloutSpec has no fields {sorted(unknown)} — '
                f'version skew between learner and worker; upgrade '
                f'the older side')
        return cls(**obj)

    def fingerprint(self) -> str:
        blob = json.dumps(self.to_json(), sort_keys=True,
                          separators=(',', ':'))
        return hashlib.sha256(blob.encode('utf-8')).hexdigest()[:16]


def prompt_for(spec: RolloutSpec, lease_id: int) -> np.ndarray:
    """Lease ``i``'s prompt: ``[prompt_len]`` int32 in ``[0, vocab)``.

    numpy's seeded Generator on purpose: the dispatcher and any worker
    must agree on prompts without a model stack, and ``default_rng`` is
    stable across processes and platforms."""
    rng = np.random.default_rng(
        (np.uint64(spec.seed) << np.uint64(32)) ^ np.uint64(lease_id))
    return rng.integers(0, spec.vocab_size, size=spec.prompt_len,
                        dtype=np.int32)


def lease_rng_seed(spec: RolloutSpec, lease_id: int) -> int:
    """The seed a worker samples lease ``i``'s completions with —
    per-lease so duplicate executions against the same snapshot
    are byte-identical, offset from the prompt stream so prompts and
    samples never share a key."""
    digest = hashlib.sha256(
        f'{spec.seed}:{lease_id}:rollout'.encode('utf-8')).digest()
    return int.from_bytes(digest[:4], 'big')
