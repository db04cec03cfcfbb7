"""The port's typed ``SKYTPU_*`` knobs: the rows of the JAX package's
registry (skypilot_tpu/utils/knobs.py) that the port reads, under the
same names, types, defaults and enum choices, with the same parse
grammar and the same typed accessors.

It holds only the engine's rows, the KV handoff's two
(``SKYTPU_HANDOFF_TIMEOUT``, ``SKYTPU_HANDOFF_TTL``), the journal's two
(``SKYTPU_OBSERVE_DB``, ``SKYTPU_DISABLE_JOURNAL``),
``SKYTPU_FLIGHT_CAPACITY``, ``SKYTPU_FAILPOINTS``, ring attention's two
(``SKYTPU_RING_BWD_CHUNK``, ``SKYTPU_RING_BWD_FLASH``), the rollout
plane's five (``SKYTPU_ROLLOUT_*``), the gang's four
(``SKYTPU_COORDINATOR_ADDRESS``, ``SKYTPU_NUM_PROCESSES``,
``SKYTPU_NODE_RANK``, ``SKYTPU_JOB_ID``), ``SKYTPU_SERVE_PORT`` and the
multi-host control channel's four (``SKYTPU_MH_*``), plus one row of the port's own,
``SKYTPU_TORCH_DIST_BACKEND``: the JAX package has no process-group
backend to choose. An accessor reads the environment per call (a
knob read at import stays read at import: the call site decides) and
fails with :class:`KnobError`, naming the knob, on a malformed value
or an undeclared name. Empty counts as unset, except where ``''`` is
itself an enum choice.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Tuple

TYPES = ('int', 'float', 'bool', 'str', 'enum')

_TRUE = frozenset({'1', 'true', 'yes', 'on'})
_FALSE = frozenset({'0', 'false', 'no', 'off'})


class KnobError(ValueError):
    """A malformed or undeclared knob; the message names it."""


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    type: str
    default: Any
    subsystem: str
    doc: str
    choices: Tuple[str, ...] = ()


REGISTRY: Dict[str, Knob] = {}


def _declare(name: str, type: str, default: Any, subsystem: str,
             doc: str, *, choices: Tuple[str, ...] = ()) -> None:
    # pylint: disable=redefined-builtin
    if type not in TYPES:
        raise ValueError(f'{name}: unknown knob type {type!r}')
    if type == 'enum' and not choices:
        raise ValueError(f'{name}: enum knob needs choices')
    if name in REGISTRY:
        raise ValueError(f'duplicate knob declaration {name}')
    REGISTRY[name] = Knob(name, type, default, subsystem, doc, choices)


# ----------------------------------------------------------- engine
_declare('SKYTPU_ENGINE_MAX_BATCH', 'int', 8, 'engine',
         'Decode batch slots (engine admission width).')
_declare('SKYTPU_ENGINE_STEP_CHUNK', 'int', 8, 'engine',
         'Decode steps fused per host-loop iteration.')
_declare('SKYTPU_ENGINE_MAX_QUEUE', 'int', 64, 'engine',
         'Admission queue depth before 429 shedding.')
_declare('SKYTPU_ENGINE_PREFIX_CACHE', 'int', 4, 'engine',
         'Prefix-snapshot cache entries (0 disables).')
_declare('SKYTPU_ENGINE_SPEC_K', 'int', 4, 'engine',
         'Speculative-decoding draft length (0 disables).')
_declare('SKYTPU_ENGINE_SPEC_COOLDOWN', 'int', 16, 'engine',
         'Calls speculation sits out after a low-acceptance round.')
_declare('SKYTPU_ENGINE_PAGED', 'bool', True, 'engine',
         'Paged KV cache (the only layout the port serves).')
_declare('SKYTPU_ENGINE_PAGE_SIZE', 'int', 64, 'engine',
         'Tokens per KV page.')
_declare('SKYTPU_ENGINE_KV_PAGES', 'int', 0, 'engine',
         'Total KV pages (0 = every slot\'s worst case plus prefix '
         'headroom).')
_declare('SKYTPU_ENGINE_PREFILL_CHUNK', 'int', 256, 'engine',
         'Chunked-prefill chunk length (tokens).')
_declare('SKYTPU_ENGINE_RESURRECT_MAX', 'int', 2, 'engine',
         'Times a request that never sampled may be resubmitted after a '
         'failure reset before it fails.')
_declare('SKYTPU_ENGINE_ROLE', 'enum', '', 'engine',
         'Disaggregation role of this engine process.',
         choices=('', 'prefill', 'decode'))
_declare('SKYTPU_ENGINE_WARM_DISAGG', 'bool', False, 'engine',
         'Warm the page export/adopt programs (disagg pools).')
_declare('SKYTPU_ENGINE_HANDOFF_PORT', 'int', -1, 'engine',
         'KV-handoff listener port (-1 = HTTP port + 1000 convention, '
         '0 = disabled).')
_declare('SKYTPU_ENGINE_ATTN', 'enum', 'fused', 'engine',
         'Paged attention backend.',
         choices=('fused', 'pallas', 'gather'))
_declare('SKYTPU_ENGINE_KV_QUANT', 'enum', 'none', 'engine',
         'KV page-pool representation.',
         choices=('none', 'int8'))
_declare('SKYTPU_ENGINE_KV_IDLE_SPILL_S', 'float', 0.0, 'engine',
         'Seconds a prefix snapshot may sit unused before it spills to '
         'the host tier (0 disables).')
_declare('SKYTPU_ENGINE_KV_HOST_MB', 'int', 0, 'engine',
         'Host-RAM KV spill-tier budget in MiB (0 disables).')

# ----------------------------------------------------------- disagg
_declare('SKYTPU_HANDOFF_TIMEOUT', 'float', 30.0, 'disagg',
         'Whole-exchange deadline for one KV handoff send.')
_declare('SKYTPU_HANDOFF_TTL', 'float', 120.0, 'disagg',
         'Sweep age for staged handoffs whose continue never came.')

# ---------------------------------------------------------- observe
_declare('SKYTPU_FLIGHT_CAPACITY', 'int', 65536, 'observe',
         'Flight-recorder ring capacity (events).')
_declare('SKYTPU_OBSERVE_DB', 'str', '~/.skytpu/observe/journal.db',
         'observe', 'Journal/span sqlite path.')
_declare('SKYTPU_DISABLE_JOURNAL', 'bool', False, 'observe',
         'Drop journal writes (hermetic tests).')

# ---------------------------------------------------------- rollout
_declare('SKYTPU_ROLLOUT_HEARTBEAT_TIMEOUT', 'float', 10.0, 'rollout',
         'Dispatcher marks a rollout worker LOST after this silence.')
_declare('SKYTPU_ROLLOUT_LEASE_TIMEOUT', 'float', 120.0, 'rollout',
         'Prompt-lease reassignment age.')
_declare('SKYTPU_ROLLOUT_MAX_OUTSTANDING', 'int', 32, 'rollout',
         'Max outstanding leases per worker pool.')
_declare('SKYTPU_ROLLOUT_RESULT_CAP', 'int', 64, 'rollout',
         'Completed-trajectory buffer cap at the dispatcher.')
_declare('SKYTPU_ROLLOUT_STALL_BUDGET', 'float', 120.0, 'rollout',
         'Learner stall budget waiting on trajectory batches.')

# ------------------------------------------------------------ utils
_declare('SKYTPU_FAILPOINTS', 'str', '', 'utils',
         'Failpoint arming schedule (site=spec;...).')

# -------------------------------------------------------------- ops
_declare('SKYTPU_RING_BWD_CHUNK', 'int', 1024, 'ops',
         'Ring-attention backward KV chunk (HBM peak bound).')
_declare('SKYTPU_RING_BWD_FLASH', 'enum', '', 'ops',
         'Flash-kernel backward dispatch: auto / force / einsum-only.',
         choices=('', '1', '0'))

# --------------------------------------------- skylet / gang runtime
_declare('SKYTPU_NODE_RANK', 'int', 0, 'skylet',
         'Global rank of this gang member.')
_declare('SKYTPU_COORDINATOR_ADDRESS', 'str', None, 'skylet',
         'jax.distributed coordinator host:port.')
_declare('SKYTPU_NUM_PROCESSES', 'int', 1, 'skylet',
         'Total processes across all slices.')
_declare('SKYTPU_JOB_ID', 'str', None, 'skylet',
         'Job id of the owning gang.')

# ------------------------------------------------------------ serve
_declare('SKYTPU_SERVE_PORT', 'int', 8000, 'serve',
         'Engine HTTP port default for `skytpu serve`.')

# ------------------------------------------------------- multi-host
_declare('SKYTPU_MH_TOKEN', 'str', None, 'multihost',
         'Per-job random secret for the multi-host serve control '
         'channel; drawn once per gang by the slice driver.')
_declare('SKYTPU_MH_ALLOW_INSECURE_TOKEN', 'bool', False, 'multihost',
         'Loopback-debug escape hatch: accept the guessable job-id '
         'token instead of refusing to start.')
_declare('SKYTPU_MH_CONNECT_TIMEOUT', 'float', 120.0, 'multihost',
         'Follower connect budget to the leader control channel.')
_declare('SKYTPU_MH_SEND_TIMEOUT', 'float', 20.0, 'multihost',
         'Per-broadcast send budget; a follower wedged this long '
         'fails the replica.')

# ---------------------------------------------------- the port's own
_declare('SKYTPU_TORCH_DIST_BACKEND', 'enum', '', 'parallel',
         "torch.distributed backend ('' = nccl on a card, gloo on the "
         'CPU; gloo lets ranks share one card).',
         choices=('', 'nccl', 'gloo'))


def _lookup(name: str, want_type: str) -> Knob:
    knob = REGISTRY.get(name)
    if knob is None:
        raise KnobError(f'{name} is not a declared knob of the port '
                        f'(skypilot_tpu_torch/utils/knobs.py)')
    if knob.type != want_type:
        raise KnobError(f'{name} is declared {knob.type!r} but was read '
                        f'with the {want_type!r} accessor')
    return knob


def _parse(knob: Knob, raw: str) -> Any:
    """``raw`` (non-empty) → the typed value, or KnobError naming the
    knob."""
    if knob.type == 'int':
        try:
            return int(raw)
        except ValueError:
            raise KnobError(f'{knob.name}={raw!r} is not an integer') \
                from None
    if knob.type == 'float':
        try:
            return float(raw)
        except ValueError:
            raise KnobError(f'{knob.name}={raw!r} is not a number') \
                from None
    if knob.type == 'bool':
        low = raw.strip().lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise KnobError(f'{knob.name}={raw!r} is not a boolean (want one '
                        f'of 1/0/true/false/yes/no/on/off)')
    if knob.type == 'enum':
        val = raw.strip()
        if val not in knob.choices:
            raise KnobError(f'{knob.name}={raw!r} must be one of '
                            f'{knob.choices}')
        return val
    return raw


def _get(name: str, want_type: str) -> Any:
    knob = _lookup(name, want_type)
    raw = os.environ.get(name)
    if raw is None or raw == '':
        if raw == '' and knob.type == 'enum' and '' in knob.choices:
            return ''
        return knob.default
    return _parse(knob, raw)


def get_int(name: str) -> int:
    return _get(name, 'int')


def get_float(name: str) -> float:
    return _get(name, 'float')


def get_bool(name: str) -> bool:
    return _get(name, 'bool')


def get_str(name: str) -> str:
    return _get(name, 'str')


def get_enum(name: str) -> str:
    return _get(name, 'enum')
