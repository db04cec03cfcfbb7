"""Deterministic failpoint plane: named fault sites, armed on demand (a
copy of skypilot_tpu/utils/failpoints.py, less ``afire``: the port's
engine runs its batch loop on a thread, not on an event loop).

A failpoint is a named site in the code (``engine.step``,
``engine.admit``, ``engine.collect``) where a fault can be injected: an
exception raised, or a delay slept. When nothing is armed a site costs
one module-attribute truth test::

    from skypilot_tpu_torch.utils import failpoints
    ...
    if failpoints.ACTIVE:
        failpoints.fire('engine.step')

Arming, from the environment (parsed at import, the JAX grammar)::

    SKYTPU_FAILPOINTS='engine.step=once;engine.admit=every:3'
    SKYTPU_FAILPOINTS='engine.step=prob:0.5,seed:7;engine.collect=delay:0.2'

``site=term[,term...]`` with terms ``once``, ``every:N``, ``prob:P``
(seeded per site by ``seed:S``), ``delay:S`` (sleep instead of raise)
and ``max:N``; or programmatically::

    failpoints.arm('engine.step', once=True)
    with failpoints.armed('engine.admit', every=2, max_fires=1):
        ...

A firing raises :class:`FailpointError` (``.failpoint`` names the site)
unless the spec says ``delay`` or supplies an exception factory.
:func:`scan_sites` lists every site of the port without importing it.
"""
from __future__ import annotations

import contextlib
import os
import random
import re
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

from skypilot_tpu_torch.utils import knobs

# One attribute read on the hot path. False ⟺ no site armed; flips
# under _LOCK only. Reads are racy-by-design (a site armed mid-step
# takes effect at the next check) — that is fine for fault injection.
ACTIVE: bool = False

NAME_RE = re.compile(r'^[a-z0-9_]+(\.[a-z0-9_]+)+$')

ENV_VAR = 'SKYTPU_FAILPOINTS'

_LOCK = threading.Lock()


class FailpointError(RuntimeError):
    """The default injected fault. ``failpoint`` names the fired site,
    so recovery paths (and tests) can tell an injected fault from an
    organic one."""

    def __init__(self, failpoint: str):
        super().__init__(f'failpoint {failpoint!r} fired')
        self.failpoint = failpoint


class _Spec:
    """One armed site: mode + deterministic per-site RNG + counters."""

    __slots__ = ('name', 'every', 'prob', 'rng', 'delay', 'max_fires',
                 'exc', 'hits', 'fires')

    def __init__(self, name: str, *, once: bool = False,
                 every: Optional[int] = None, prob: Optional[float] = None,
                 seed: int = 0, delay: Optional[float] = None,
                 max_fires: Optional[int] = None,
                 exc: Optional[Callable[[str], BaseException]] = None):
        if not NAME_RE.match(name):
            raise ValueError(
                f'failpoint name {name!r} must be lowercase '
                f'unit.site[.subsite] (e.g. "engine.step")')
        if once:
            if max_fires is not None and max_fires != 1:
                raise ValueError('once conflicts with max')
            max_fires = 1
        if every is not None and prob is not None:
            raise ValueError(f'{name}: every and prob are exclusive')
        if every is not None and every < 1:
            raise ValueError(f'{name}: every must be >= 1')
        if prob is not None and not 0.0 <= prob <= 1.0:
            raise ValueError(f'{name}: prob must be in [0, 1]')
        if delay is not None and delay < 0:
            raise ValueError(f'{name}: delay must be >= 0')
        self.name = name
        self.every = every
        self.prob = prob
        # Per-site stream: two probabilistic sites never perturb each
        # other's draws, so a seeded run reproduces exactly even when
        # thread interleaving differs.
        self.rng = random.Random(seed) if prob is not None else None
        self.delay = delay
        self.max_fires = max_fires
        self.exc = exc
        self.hits = 0
        self.fires = 0

    def should_fire(self) -> bool:
        self.hits += 1
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.prob is not None:
            return self.rng.random() < self.prob
        if self.every is not None:
            return self.hits % self.every == 0
        return True


_ARMED: Dict[str, _Spec] = {}


def _recompute_active() -> None:
    global ACTIVE
    ACTIVE = bool(_ARMED)


def arm(name: str, *, once: bool = False, every: Optional[int] = None,
        prob: Optional[float] = None, seed: int = 0,
        delay: Optional[float] = None, max_fires: Optional[int] = None,
        exc: Optional[Callable[[str], BaseException]] = None) -> None:
    """Arm (or re-arm, resetting counters) one failpoint site."""
    spec = _Spec(name, once=once, every=every, prob=prob, seed=seed,
                 delay=delay, max_fires=max_fires, exc=exc)
    with _LOCK:
        _ARMED[name] = spec
        _recompute_active()


def disarm(name: str) -> None:
    with _LOCK:
        _ARMED.pop(name, None)
        _recompute_active()


def reset() -> None:
    """Disarm everything (test teardown)."""
    with _LOCK:
        _ARMED.clear()
        _recompute_active()


@contextlib.contextmanager
def armed(name: str, **kwargs) -> Iterator[None]:
    """Scoped arm for tests: restores the site's previous state."""
    with _LOCK:
        prev = _ARMED.get(name)
    arm(name, **kwargs)
    try:
        yield
    finally:
        with _LOCK:
            if prev is None:
                _ARMED.pop(name, None)
            else:
                _ARMED[name] = prev
            _recompute_active()


def _consume(name: str):
    """Evaluate one hit of an armed site under the lock. Returns None
    when nothing fires, else ``(delay, exc)`` for the caller to apply
    OUTSIDE the lock — a sleeping delay site must not serialize every
    other site, and a custom factory may do arbitrary work."""
    with _LOCK:
        spec = _ARMED.get(name)
        if spec is None:
            return None
        if not spec.should_fire():
            return None
        spec.fires += 1
        if spec.max_fires is not None and spec.fires >= spec.max_fires:
            _ARMED.pop(name, None)
            _recompute_active()
        return (spec.delay, spec.exc)


def fire(name: str) -> None:
    """The instrumented site. Call ONLY under ``if failpoints.ACTIVE:``
    — this function is deliberately not cheap (a lock, counters); the
    attribute guard is what keeps inactive hot paths free."""
    hit = _consume(name)
    if hit is None:
        return
    delay, exc = hit
    if delay is not None:
        time.sleep(delay)
        return
    raise (exc(name) if exc is not None else FailpointError(name))


def hits(name: str) -> int:
    """Times the armed site was evaluated (0 if not currently armed)."""
    with _LOCK:
        spec = _ARMED.get(name)
        return spec.hits if spec is not None else 0


def fires(name: str) -> int:
    with _LOCK:
        spec = _ARMED.get(name)
        return spec.fires if spec is not None else 0


# ------------------------------------------------------------- env parse

def parse_spec(text: str) -> Dict[str, Dict[str, object]]:
    """``site=term,...;site=...`` → {site: arm() kwargs}. Raises
    ValueError on malformed input — a typo'd chaos schedule must fail
    loudly, not silently inject nothing."""
    out: Dict[str, Dict[str, object]] = {}
    for part in text.split(';'):
        part = part.strip()
        if not part:
            continue
        if '=' not in part:
            raise ValueError(f'failpoint spec {part!r}: want site=mode')
        site, _, spec = part.partition('=')
        site = site.strip()
        kwargs: Dict[str, object] = {}
        for term in spec.split(','):
            term = term.strip()
            if not term:
                continue
            key, _, val = term.partition(':')
            try:
                if key == 'once' and not val:
                    kwargs['once'] = True
                elif key == 'every':
                    kwargs['every'] = int(val)
                elif key == 'prob':
                    kwargs['prob'] = float(val)
                elif key == 'seed':
                    kwargs['seed'] = int(val)
                elif key == 'delay':
                    kwargs['delay'] = float(val)
                elif key == 'max':
                    kwargs['max_fires'] = int(val)
                else:
                    raise ValueError(f'unknown term {term!r}')
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f'failpoint spec {part!r}: {e}') from None
        if not kwargs:
            raise ValueError(f'failpoint spec {part!r}: empty mode')
        out[site] = kwargs
    return out


def load_env() -> None:
    """Arm sites from ``SKYTPU_FAILPOINTS`` (idempotent; re-arms with
    fresh counters). Called at import and by server entrypoints so a
    chaos schedule set in the environment reaches detached processes."""
    text = knobs.get_str(ENV_VAR)
    if not text:
        return
    for site, kwargs in parse_spec(text).items():
        arm(site, **kwargs)


load_env()


# ------------------------------------------------------------- discovery

def scan_sites(root: Optional[str] = None) -> List[Dict[str, object]]:
    """AST-scan the port package for ``fire('<literal>')`` call sites —
    no imports, so listing works without torch or a server. Returns
    [{name, path, line}] sorted by name; a non-literal argument
    appears as ``<dynamic>``."""
    import ast
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fire_names = ('fire',)
    sites: List[Dict[str, object]] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d != '__pycache__' and
                             not d.startswith('.'))
        for fname in sorted(filenames):
            if not fname.endswith('.py'):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root).replace(os.sep, '/')
            if rel == 'utils/failpoints.py':
                continue
            try:
                with open(path, 'r', encoding='utf-8') as f:
                    tree = ast.parse(f.read(), filename=rel)
            except SyntaxError:
                continue
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call) and
                        isinstance(node.func, ast.Attribute) and
                        node.func.attr in fire_names):
                    continue
                base = node.func.value
                if not (isinstance(base, ast.Name) and
                        base.id in ('failpoints', 'failpoints_lib')):
                    continue
                arg = node.args[0] if node.args else None
                name = (arg.value if isinstance(arg, ast.Constant) and
                        isinstance(arg.value, str) else '<dynamic>')
                sites.append({'name': name, 'path': rel,
                              'line': node.lineno})
    sites.sort(key=lambda s: (s['name'], s['path'], s['line']))
    return sites

