"""Step checkpoints of the port's TrainState, or of a bare params tree,
in the JAX package's on-disk format (port of
skypilot_tpu/train/checkpoints.py: one card, or the ranks of a mesh).

Format (one directory per step), as the JAX ``Checkpointer`` writes it::

    <dir>/step_00000012/
        MANIFEST.json            # format 2: per array its tree path,
                                 # shape, dtype, spec, chunks + sha256
        arrays/a0003.p0000.c00.npy

The manifest's ``path`` keys and ``dtype`` strings are the ones the JAX
package writes for the same state (models/weights.py names them), so a
step saved by either package restores in the other. A bare params tree
(the harvested-RL learner's policy snapshots, train/rollout/) is saved
at its own paths, ``['embed']``, ``['layers']['wq']``..., with no
``.params`` prefix, as the JAX ``Checkpointer`` writes ``state.params``.
A Checkpointer given the model's config records each array's
PartitionSpec as JAX does (``spec``: the leaf's logical axes through
the default rules; the optimizer moments take the spec of the first
param leaf of their shape, JAX's ``shardings_like``); without one the
spec is null. The reader takes steps of any chunking and checks that
the chunks tile every array.

A mesh (the trainer's): the arrays are cut as JAX cuts them on that
mesh, and every rank writes the slices whose replica-0 shard it holds
(coordinate 0 on every mesh axis the array is not cut over), one chunk
file each, ``a<i>.p<rank>.c00.npy``, and its index
``chunks.p<rank>.json``; after a barrier rank 0 merges the indexes into
the manifest and publishes the step (the JAX multi-process protocol,
every rank's failure carried to the barriers). A moment held in its
param's layout but recorded in another (``shardings_like``) is gathered
over 'fsdp' one leaf at a time to cut it. On restore a rank reads only
the chunk files that cover its own slice of each array.

Durability, as in the JAX package: a step is written into a hidden temp
dir and renamed into place only after its manifest is durable, so a
killed save leaves nothing ``latest_step`` can see; restore verifies
every chunk's sha256 and raises :class:`CheckpointCorruptError` on a
truncated or altered file; :func:`restore_or_init` refuses a corrupt
newest step loudly, falls back to an older complete one, and raises
rather than re-initialising when none restores. Several processes save
synchronously (every rank returns after the step is durable) and check
that they restored the same step: a directory that is not shared
storage raises instead of letting the ranks diverge.
"""
from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import queue
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from skypilot_tpu_torch.config import LlamaConfig
from skypilot_tpu_torch.models import module_for, weights
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.train import train_lib

logger = logging.getLogger(__name__)

FORMAT_VERSION = 2
MANIFEST_NAME = 'MANIFEST.json'
_STEP_RE = re.compile(r'^step_(\d{8})$')
_TMP_PREFIX = '.tmp-step_'


class CheckpointCorruptError(RuntimeError):
    """A step directory exists but cannot be restored faithfully:
    malformed/missing manifest, missing chunk files, digest mismatch,
    or chunk coverage that does not tile the array."""


def abstract_train_state(cfg: LlamaConfig,
                         tx: train_lib.AdamW) -> train_lib.TrainState:
    """The TrainState's structure, shapes and dtypes on the meta device
    (no memory), from the config's model module: the restore target."""
    params = module_for(cfg).init_params(cfg, None, 'meta')
    return train_lib.TrainState(step=0, params=params,
                                opt_state=tx.init(params))


def _world() -> int:
    """The torch.distributed world's size (1 without one)."""
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def _agree(value: int, what: str, directory: str) -> None:
    """Raise on every rank unless every rank holds the same ``value``."""
    if _world() == 1:
        return
    seen: List[Any] = [None] * _world()
    dist.all_gather_object(seen, value)
    if len(set(seen)) > 1:
        raise FileNotFoundError(
            f'ranks disagree on the {what} under {directory!r}: {seen}; '
            f'a multi-process run needs its checkpoint directory on '
            f'storage every rank shares (a mounted bucket)')


def _step_dirname(step: int) -> str:
    return f'step_{step:08d}'


class _HashingWriter:
    """A file's ``write`` that hashes what goes through it: np.save
    streams a multi-GB leaf in bounded chunks, hashed as written, with
    no whole-file copy in memory."""

    def __init__(self, f):
        self._f = f
        self.sha256 = hashlib.sha256()

    def write(self, data) -> int:
        self.sha256.update(data)
        return self._f.write(data)


def _save_npy(path: str, array: np.ndarray) -> str:
    """Write ``array`` as the .npy file np.save makes; its sha256."""
    with open(path, 'wb') as f:
        writer = _HashingWriter(f)
        np.save(writer, array, allow_pickle=False)
    return writer.sha256.hexdigest()


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _leaves(tree) -> List[Tuple[str, Any]]:
    """(checkpoint path, leaf) of a TrainState, or of a bare params tree
    (its paths without the ``.params`` prefix)."""
    if isinstance(tree, train_lib.TrainState):
        return weights.train_state_leaves(tree)
    return weights.tree_paths(tree)


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().contiguous().cpu().numpy()
    return np.asarray(leaf, dtype=np.int32)


def layouts(cfg: LlamaConfig, bare: bool = False
            ) -> Dict[str, Tuple[tuple, tuple]]:
    """Checkpoint path → (the logical axes the port holds the array in,
    the ones the JAX checkpointer records it in) for every array of the
    config's TrainState (of its params alone when ``bare``); the counts
    and the step are absent (scalars). A param is held and recorded in
    its own axes; a moment is held in its param's and recorded in those
    of the first param leaf of its shape (JAX's ``shardings_like``)."""
    mod = module_for(cfg)
    axes = weights.tree_paths(mod.param_axes(cfg))
    shapes = [tuple(t.shape) for _, t in
              weights.tree_paths(mod.init_params(cfg, None, 'meta'))]
    first: Dict[tuple, tuple] = {}
    for (_, ax), shape in zip(axes, shapes):
        first.setdefault(shape, ax)
    out = {}
    for (path, ax), shape in zip(axes, shapes):
        out[('' if bare else '.params') + path] = (ax, ax)
        if not bare:
            for moment in ('mu', 'nu'):
                out[f'{weights.ADAM_PATH}.{moment}{path}'] = (ax,
                                                               first[shape])
    return out


def _rank() -> int:
    return dist.get_rank() if _world() > 1 else 0


def _all_ok(ok: bool) -> bool:
    """Every rank's ``ok``, and-ed (a barrier that carries a failure to
    every rank, so none waits forever on a rank that raised)."""
    if _world() == 1:
        return ok
    seen: List[Any] = [None] * _world()
    dist.all_gather_object(seen, bool(ok))
    return all(seen)


def _read_chunk(step_dir: str, step: int, chunk: Dict[str, Any]
                ) -> np.ndarray:
    """One chunk file, its digest and shape checked against the
    manifest."""
    try:
        with open(os.path.join(step_dir, chunk['file']), 'rb') as f:
            raw = f.read()
    except OSError as e:
        raise CheckpointCorruptError(
            f'step {step}: chunk {chunk["file"]} unreadable: {e}') from None
    if _sha256(raw) != chunk['sha256']:
        raise CheckpointCorruptError(
            f'step {step}: chunk {chunk["file"]} content digest '
            f'mismatch (truncated or corrupted on disk).')
    try:
        data = np.load(io.BytesIO(raw), allow_pickle=False)
    except ValueError as e:
        raise CheckpointCorruptError(
            f'step {step}: chunk {chunk["file"]} undecodable: {e}') from None
    if list(data.shape) != list(chunk['shape']):
        raise CheckpointCorruptError(
            f'step {step}: chunk {chunk["file"]} shape {data.shape} != '
            f'manifest {chunk["shape"]}.')
    return data


class Checkpointer:
    """Step-directory checkpoint manager with atomic completes.

    One writer per directory (the trainer). A single process's save
    copies the state to host memory at once (so the caller may go on
    updating it in place) and writes the files on a background thread
    unless asked to wait; ``wait()`` is the exit flush barrier. The
    newest ``max_to_keep`` steps stay. ``cfg`` (the model's config)
    lets the manifest record JAX's specs and, with a ``mesh``, the
    state be this rank's shards of it (train_lib.init_train_state on
    that mesh): each rank then saves and restores its own slices.
    """

    def __init__(self, directory: str, *, max_to_keep: Optional[int] = 3,
                 cfg: Optional[LlamaConfig] = None,
                 mesh: Optional[mesh_lib.Mesh] = None):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None and mesh.shape['fsdp'] > 1 and cfg is None:
            raise ValueError('a Checkpointer on an fsdp mesh needs the '
                             "model's cfg: its arrays are shards")
        self._layouts: Dict[bool, Dict[str, Tuple[tuple, tuple]]] = {}
        self._queue: 'queue.Queue[Optional[Tuple[int, list]]]' = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        # Stale temp dirs are swept on the first save, never on open: a
        # restore-only Checkpointer on a live directory must not delete
        # the trainer's in-progress save.
        self._swept_stale = False

    # ------------------------------------------------------------------
    def _layout(self, path: str, bare: bool):
        """(held axes, recorded axes) of the array at ``path``; ((), ())
        for a scalar, (None, None) without a cfg (whole, no spec)."""
        if self.cfg is None:
            return None, None
        if bare not in self._layouts:
            self._layouts[bare] = layouts(self.cfg, bare)
        return self._layouts[bare].get(path, ((), ()))

    def _sharded(self) -> bool:
        """Whether this rank's arrays are slices (a mesh describing the
        world, 'fsdp' above 1)."""
        return self.mesh is not None and self.mesh.shape['fsdp'] > 1

    def _owns(self, axes) -> bool:
        """Whether this rank writes its slice of an array recorded in
        ``axes``: it holds the slice's replica 0, coordinate 0 on every
        mesh axis the array is not cut over (rank 0 alone when no mesh
        describes the world)."""
        if self.mesh is None or self.mesh.size != _world():
            return _rank() == 0
        rules = sharding.Rules()
        used = {m for logical in (axes or ())
                for m in (rules.mesh_axes(logical) or ())}
        return all(self.mesh.coords[ax] == 0 for ax in mesh_lib.MESH_AXES
                   if ax not in used)

    def _box(self, shape, axes) -> Tuple[List[int], List[int]]:
        """This rank's (start, size) of an array of ``shape`` cut in
        ``axes`` on the mesh (the whole array without one)."""
        if not axes or self.mesh is None or self.mesh.size != _world():
            return [0] * len(shape), [int(d) for d in shape]
        return sharding.leaf_box(shape, axes, self.mesh)

    def save(self, state, step: Optional[int] = None,
             *, wait: bool = False) -> int:
        """Snapshot ``state`` (a TrainState, or a params tree, which then
        needs ``step``) to host memory and persist it as ``step``
        (default ``state.step``): in the background unless ``wait``. In
        a multi-process world every rank writes its slices synchronously
        and returns after the step is durable."""
        if step is None:
            step = state.step
        self._raise_pending_error()
        # One snapshot in flight at most, and a synchronous save never
        # races the worker on the same temp dir.
        self._queue.join()
        self._raise_pending_error()
        done = os.path.isdir(os.path.join(self.directory,
                                          _step_dirname(step)))
        if _world() > 1:
            _agree(done, f'completeness of step {step}', self.directory)
        if done:
            return step                # already complete: no snapshot
        arrays = self._snapshot(state)
        if _world() > 1:
            self._write_step(step, arrays)
        elif not wait:
            self._ensure_worker()
            self._queue.put((step, arrays))
        else:
            self._write_step(step, arrays)
        return step

    def _snapshot(self, state) -> List[Dict[str, Any]]:
        """Per array its record (path, shape, dtype, spec) and the
        slices this rank writes, copied to host memory: (start, data)."""
        bare = not isinstance(state, train_lib.TrainState)
        if self._sharded() and self.mesh.size != _world():
            raise ValueError(f'the mesh holds {self.mesh.size} ranks, the '
                             f'world {_world()}')
        out = []
        for path, leaf in _leaves(state):
            held, recorded = self._layout(path, bare)
            shape = list(weights.leaf_spec(leaf)[0])
            dim = sharding.fsdp_dim(held) if held else None
            if self._sharded() and dim is not None:
                shape[dim] *= self.mesh.shape['fsdp']
            chunks = []
            same = (not self._sharded() or
                    (sharding.fsdp_dim(recorded) if recorded else None) == dim)
            owns = self._owns(recorded)
            if same:
                if owns:
                    chunks.append((self._box(shape, recorded)[0],
                                   _host(leaf)))
            else:
                # Held cut one way, recorded another: the whole leaf,
                # gathered over 'fsdp' on every rank, then cut.
                whole = sharding.gather_whole(leaf, dim, self.mesh)
                if owns:
                    start, size = self._box(shape, recorded)
                    chunks.append((start, _host(whole[tuple(
                        slice(a, a + n) for a, n in zip(start, size))])))
                del whole
            out.append({'path': path, 'shape': shape,
                        'dtype': weights.leaf_spec(leaf)[1],
                        'spec': (None if recorded is None
                                 else sharding.spec_json(recorded)),
                        'chunks': chunks})
        return out

    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._worker = threading.Thread(
            target=self._worker_loop, name='ckpt-writer', daemon=True)
        self._worker.start()

    def _worker_loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                self._queue.task_done()
                return
            try:
                self._write_step(*job)
            except Exception as e:  # pylint: disable=broad-except
                # Surfaces at the next save()/wait()/close().
                with self._error_lock:
                    if self._error is None:
                        self._error = e
                logger.error('async checkpoint save of step %d failed: %s',
                             job[0], e)
            finally:
                self._queue.task_done()

    def _raise_pending_error(self) -> None:
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def _write_files(self, tmp_dir: str, arrays) -> List[Dict[str, Any]]:
        """This rank's chunk files; the arrays' records with them."""
        rank = _rank()
        records = []
        for i, rec in enumerate(arrays):
            chunks = []
            for j, (start, data) in enumerate(rec['chunks']):
                fname = f'arrays/a{i:04d}.p{rank:04d}.c{j:02d}.npy'
                chunks.append({'file': fname, 'start': list(start),
                               'shape': list(data.shape),
                               'sha256': _save_npy(os.path.join(
                                   tmp_dir, fname), data)})
            records.append({'path': rec['path'], 'shape': rec['shape'],
                            'dtype': rec['dtype'], 'spec': rec['spec'],
                            'chunks': chunks})
        return records

    def _sweep(self, tmp_dir: str) -> None:
        if not self._swept_stale:
            self._swept_stale = True
            for name in os.listdir(self.directory):
                if name.startswith(_TMP_PREFIX):
                    logger.warning('Removing stale in-progress checkpoint '
                                   '%r (a save was killed mid-write).', name)
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)
        shutil.rmtree(tmp_dir, ignore_errors=True)

    def _write_step(self, step: int, arrays) -> None:
        final_dir = os.path.join(self.directory, _step_dirname(step))
        tmp_dir = os.path.join(self.directory, f'{_TMP_PREFIX}{step:08d}')
        world = _world()
        if _rank() == 0:
            self._sweep(tmp_dir)
        if world > 1:
            dist.barrier()
        error: Optional[BaseException] = None
        records: List[Dict[str, Any]] = []
        try:
            os.makedirs(os.path.join(tmp_dir, 'arrays'), exist_ok=True)
            records = self._write_files(tmp_dir, arrays)
            if world > 1:
                with open(os.path.join(tmp_dir, f'chunks.p{_rank():04d}.json'),
                          'w', encoding='utf-8') as f:
                    json.dump({'arrays': records}, f)
        except OSError as e:
            if world == 1:
                raise
            # Carried to the barrier: a one-sided raise would leave the
            # other ranks waiting there forever.
            error = e
        if not _all_ok(error is None):
            raise error if error is not None else IOError(
                f'checkpoint step {step}: a peer rank failed writing its '
                f'slices; the save is aborted on every rank (the step '
                f'stays invisible).')
        commit_error: Optional[BaseException] = None
        if _rank() == 0:
            try:
                if world > 1:
                    records = _merge_chunk_indexes(tmp_dir)
                self._commit(step, tmp_dir, final_dir, records)
            except BaseException as e:  # pylint: disable=broad-except
                if world == 1:
                    raise
                commit_error = e
        if not _all_ok(commit_error is None):
            raise commit_error if commit_error is not None else IOError(
                f'checkpoint step {step}: the commit failed on rank 0; '
                f'the step was not published.')

    def _commit(self, step: int, tmp_dir: str, final_dir: str,
                records) -> None:
        manifest = {'format': FORMAT_VERSION, 'step': step,
                    'time': time.time(), 'process_count': _world(),
                    'mesh_axes': (dict(self.mesh.shape)
                                  if self.mesh is not None else None),
                    'arrays': records}
        mpath = os.path.join(tmp_dir, MANIFEST_NAME)
        with open(mpath + '.tmp', 'w', encoding='utf-8') as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mpath + '.tmp', mpath)
        # The commit point: a step exists iff this rename happened.
        os.replace(tmp_dir, final_dir)
        self._gc_steps()

    def _gc_steps(self) -> None:
        steps = self.all_steps()
        if self.max_to_keep is None or len(steps) <= self.max_to_keep:
            return
        for step in steps[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, _step_dirname(step)),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def restore_tree(self, template, step: int, device='cuda'):
        """Restore ``step`` into a TrainState shaped like ``template``
        (see :func:`abstract_train_state`), or into a params tree shaped
        like a params ``template`` (e.g. ``init_params(cfg, None,
        'meta')``), on ``device``: on an fsdp mesh this rank's slices.
        Verifies the manifest and every chunk digest it reads
        (CheckpointCorruptError); a tree, shape or dtype mismatch is a
        config mismatch (ValueError), not corruption."""
        bare = not isinstance(template, train_lib.TrainState)
        arrays = self._read_arrays(step, _leaves(template), bare=bare)
        if bare:
            return weights.tree_from_arrays(template, arrays, '', device)
        st, params, count, mu, nu = weights.train_state_from_arrays(
            template, arrays, device)
        for leaf in train_lib.leaves(params):
            leaf.requires_grad_(True)
        return train_lib.TrainState(
            step=st, params=params,
            opt_state=train_lib.OptState(count=count, mu=mu, nu=nu))

    def restore_params(self, cfg: LlamaConfig, device='cuda'
                       ) -> Tuple[train_lib.Params, int]:
        """(params, step) of the newest step that restores, the
        optimizer state never read: what a server needs of a trainer's
        checkpoint. Corrupt steps are refused loudly and skipped, as in
        :meth:`restore_newest`; FileNotFoundError when the directory
        holds no complete step."""
        template = module_for(cfg).init_params(cfg, None, 'meta')
        want = [('.params' + p, t) for p, t in weights.tree_paths(template)]
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(
                f'No complete checkpoint step under {self.directory}.')
        for step in reversed(steps):
            try:
                arrays = self._read_arrays(step, want, prefix='.params')
            except CheckpointCorruptError as e:
                logger.error('REFUSING corrupt checkpoint step %d: %s — '
                             'falling back to the next older complete '
                             'step.', step, e)
                continue
            return weights.tree_from_arrays(template, arrays, '.params',
                                            device), step
        raise CheckpointCorruptError(
            f'All {len(steps)} checkpoint step(s) under {self.directory} '
            f'failed integrity verification.')

    def _read_arrays(self, step: int, want, prefix: str = '',
                     bare: bool = True) -> Dict[str, np.ndarray]:
        """The arrays of ``step`` at the (path, leaf) pairs ``want``,
        which must be every array of the step whose path starts with
        ``prefix``; a missing, extra or differently shaped or typed
        array is a config mismatch (ValueError). On an fsdp mesh each
        array is this rank's slice, read from the chunks covering it."""
        step_dir = os.path.join(self.directory, _step_dirname(step))
        manifest = self._load_manifest(step_dir, step)
        by_path = {rec['path']: rec for rec in manifest['arrays']
                   if rec['path'].startswith(prefix)}
        missing = [p for p, _ in want if p not in by_path]
        extra = set(by_path) - {p for p, _ in want}
        if missing or extra:
            raise ValueError(
                f'Checkpoint step {step} tree does not match the restore '
                f'target: missing={missing[:5]} extra={sorted(extra)[:5]} '
                f'(model/optimizer config mismatch).')
        arrays = {}
        for path, leaf in want:
            rec = by_path[path]
            shape, dtype = weights.leaf_spec(leaf)
            if tuple(rec['shape']) != shape or rec['dtype'] != dtype:
                raise ValueError(
                    f'Checkpoint array {path} is {rec["dtype"]}'
                    f'{tuple(rec["shape"])}, restore target wants {dtype}'
                    f'{shape} — config mismatch.')
            held = (self._layout(path, bare)[0] if self._sharded()
                    else None)
            arrays[path] = _assemble_array(step_dir, step, rec,
                                           self._box(shape, held))
        return arrays

    def _load_manifest(self, step_dir: str, step: int) -> Dict[str, Any]:
        if not os.path.isdir(step_dir):
            raise FileNotFoundError(
                f'No checkpoint step {step} under {self.directory}.')
        try:
            with open(os.path.join(step_dir, MANIFEST_NAME),
                      encoding='utf-8') as f:
                manifest = json.load(f)
        except FileNotFoundError:
            raise CheckpointCorruptError(
                f'step {step}: no {MANIFEST_NAME} — save was interrupted '
                f'before commit; this step is partial.') from None
        except (ValueError, OSError) as e:
            raise CheckpointCorruptError(
                f'step {step}: unreadable manifest: {e}') from None
        if (not isinstance(manifest, dict) or
                manifest.get('format') != FORMAT_VERSION or
                not isinstance(manifest.get('arrays'), list)):
            raise CheckpointCorruptError(
                f'step {step}: manifest malformed or not format '
                f'{FORMAT_VERSION}.')
        return manifest

    def restore_newest(self, template, device='cuda'
                       ) -> Tuple[Optional[Any], Optional[int]]:
        """(tree, step) of the newest step that restores into
        ``template`` (a TrainState or a params tree, as
        :meth:`restore_tree`). Walks complete steps newest→oldest,
        refusing corrupt steps loudly and falling back. (None, None)
        when there are no steps; raises CheckpointCorruptError when
        steps exist but none restores."""
        steps = self.all_steps()
        if not steps:
            return None, None
        for step in reversed(steps):
            try:
                return self.restore_tree(template, step, device), step
            except CheckpointCorruptError as e:
                logger.error('REFUSING corrupt checkpoint step %d: %s — '
                             'falling back to the next older complete '
                             'step.', step, e)
        raise CheckpointCorruptError(
            f'All {len(steps)} checkpoint step(s) under {self.directory} '
            f'failed integrity verification; refusing to silently '
            f'reinitialize.')

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """Complete steps only (manifest present), ascending."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(m.group(1)) for m in map(_STEP_RE.match, names)
                      if m and os.path.isfile(os.path.join(
                          self.directory, m.group(0), MANIFEST_NAME)))

    def wait(self) -> None:
        """The exit flush barrier: block until async saves are durable."""
        self._queue.join()
        self._raise_pending_error()

    def close(self) -> None:
        self.wait()
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(None)
            self._worker.join(timeout=60)

    def __enter__(self) -> 'Checkpointer':
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _merge_chunk_indexes(tmp_dir: str) -> List[Dict[str, Any]]:
    """Every rank's ``chunks.p<rank>.json``, merged in rank order (each
    array's chunks from every rank), the index files removed."""
    merged: Dict[str, Dict[str, Any]] = {}
    for name in sorted(os.listdir(tmp_dir)):
        if not (name.startswith('chunks.p') and name.endswith('.json')):
            continue
        with open(os.path.join(tmp_dir, name), encoding='utf-8') as f:
            index = json.load(f)
        for rec in index['arrays']:
            have = merged.setdefault(rec['path'], dict(rec, chunks=[]))
            have['chunks'].extend(rec['chunks'])
        os.unlink(os.path.join(tmp_dir, name))
    return list(merged.values())


def _assemble_array(step_dir: str, step: int, rec: Dict[str, Any],
                    box: Optional[Tuple[List[int], List[int]]] = None
                    ) -> np.ndarray:
    """The slice ``box`` (start, size; default the whole array) of one
    array, from the chunk files that cover it, verifying that the
    manifest's chunks exactly tile the array (in bounds, pairwise
    disjoint, volumes summing to the array's) and every chunk read's
    digest; chunks outside the box are never opened."""
    shape = tuple(rec['shape'])
    boxes = []
    volume = 0
    for chunk in rec['chunks']:
        start, cshape = chunk.get('start'), chunk.get('shape')
        if (not isinstance(start, list) or not isinstance(cshape, list)
                or len(start) != len(shape) or len(cshape) != len(shape)
                or any(s < 0 or d < 0 or s + d > dim
                       for s, d, dim in zip(start, cshape, shape))):
            raise CheckpointCorruptError(
                f'step {step}: chunk {chunk.get("file")} geometry '
                f'start={start} shape={cshape} does not fit array '
                f'{rec["path"]} {shape}.')
        boxes.append((chunk.get('file'), start, cshape))
        volume += int(np.prod(cshape, dtype=np.int64))
    if volume != int(np.prod(shape, dtype=np.int64)):
        raise CheckpointCorruptError(
            f'step {step}: array {rec["path"]} chunks cover {volume} of '
            f'{int(np.prod(shape, dtype=np.int64))} elements.')
    for a in range(len(boxes)):
        for b in range(a + 1, len(boxes)):
            (_, sa, da), (_, sb, db) = boxes[a], boxes[b]
            if not any(sa[k] + da[k] <= sb[k] or sb[k] + db[k] <= sa[k]
                       for k in range(len(shape))):
                raise CheckpointCorruptError(
                    f'step {step}: chunks {boxes[a][0]} and {boxes[b][0]} '
                    f'of {rec["path"]} overlap.')
    lo, size = box if box is not None else ([0] * len(shape), list(shape))
    hi = [a + n for a, n in zip(lo, size)]
    dtype = np.dtype(rec['dtype'])
    out = None
    for chunk in rec['chunks']:
        c_lo = chunk['start']
        c_hi = [a + n for a, n in zip(c_lo, chunk['shape'])]
        if any(a >= d or c >= h for a, d, c, h in zip(c_lo, hi, lo, c_hi)):
            continue                   # outside this rank's slice
        data = _read_chunk(step_dir, step, chunk)
        if c_lo == lo and list(data.shape) == size and data.dtype == dtype:
            return data      # one chunk is the slice: no copy
        if out is None:
            out = np.empty(size, dtype)
        a = [max(x, y) for x, y in zip(c_lo, lo)]
        b = [min(x, y) for x, y in zip(c_hi, hi)]
        out[tuple(slice(x - y, z - y) for x, y, z in zip(a, lo, b))] = \
            data[tuple(slice(x - y, z - y) for x, y, z in zip(a, c_lo, b))]
    return out if out is not None else np.empty(size, dtype)


def restore_or_init(directory: str, cfg: LlamaConfig, tx: train_lib.AdamW,
                    device='cuda', params: Optional[train_lib.Params] = None,
                    mesh: Optional[mesh_lib.Mesh] = None
                    ) -> Tuple[train_lib.TrainState, int, Checkpointer]:
    """The trainer's resume entry point: the newest restorable step if
    there is one, else a fresh state (``params`` if given, else random
    from seed 0); on an fsdp ``mesh`` this rank's shards either way.
    Returns (state, start_step, ckpt)."""
    ckpt = Checkpointer(directory, cfg=cfg, mesh=mesh)
    latest = ckpt.latest_step()
    _agree(latest, 'newest checkpoint step', directory)
    if latest is not None:
        state, step = ckpt.restore_newest(abstract_train_state(cfg, tx),
                                          device)
        _agree(step, 'restored checkpoint step', directory)
        logger.info('Resumed from checkpoint step %d in %s.', step,
                    directory)
        return state, step, ckpt
    return train_lib.init_train_state(cfg, tx, device, params=params,
                                      mesh=mesh), 0, ckpt
