"""Step checkpoints of the port's TrainState, in the JAX package's
on-disk format (port of skypilot_tpu/train/checkpoints.py, single
process, one card).

Format (one directory per step), as the JAX ``Checkpointer`` writes it::

    <dir>/step_00000012/
        MANIFEST.json            # format 2: per array its tree path,
                                 # shape, dtype, spec, chunks + sha256
        arrays/a0003.p0000.c00.npy

The manifest's ``path`` keys and ``dtype`` strings are the ones the JAX
package writes for the same state (models/weights.py names them), so a
step saved by either package restores in the other. The port writes one
chunk per array; it reads steps of any chunking (a JAX run on a mesh
writes one chunk per shard) and checks that the chunks tile the array.

Durability, as in the JAX package: a step is written into a hidden temp
dir and renamed into place only after its manifest is durable, so a
killed save leaves nothing ``latest_step`` can see; restore verifies
every chunk's sha256 and raises :class:`CheckpointCorruptError` on a
truncated or altered file; :func:`restore_or_init` refuses a corrupt
newest step loudly, falls back to an older complete one, and raises
rather than re-initialising when none restores.
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

from skypilot_tpu_torch.config import LlamaConfig
from skypilot_tpu_torch.models import module_for, weights
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


def _step_dirname(step: int) -> str:
    return f'step_{step:08d}'


def _npy_bytes(array: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, array, allow_pickle=False)
    return buf.getvalue()


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().contiguous().cpu().numpy()
    return np.asarray(leaf, dtype=np.int32)


class Checkpointer:
    """Step-directory checkpoint manager with atomic completes.

    One writer per directory (the trainer). A save copies the state to
    host memory at once (so the caller may go on updating it in place)
    and writes the files on a background thread unless asked to wait.
    ``wait()`` is the exit flush barrier. The newest ``max_to_keep``
    steps stay.
    """

    def __init__(self, directory: str, *, max_to_keep: Optional[int] = 3):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._queue: 'queue.Queue[Optional[Tuple[int, list]]]' = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        # Stale temp dirs are swept on the first save, never on open: a
        # restore-only Checkpointer on a live directory must not delete
        # the trainer's in-progress save.
        self._swept_stale = False

    # ------------------------------------------------------------------
    def save(self, state: train_lib.TrainState, step: Optional[int] = None,
             *, wait: bool = False) -> int:
        """Snapshot ``state`` to host memory and persist it as ``step``
        (default ``state.step``): in the background unless ``wait``."""
        self._raise_pending_error()
        if step is None:
            step = state.step
        # One snapshot in flight at most, and a synchronous save never
        # races the worker on the same temp dir.
        self._queue.join()
        self._raise_pending_error()
        if os.path.isdir(os.path.join(self.directory, _step_dirname(step))):
            return step                # already complete: no snapshot
        arrays = [(path, _host(leaf))
                  for path, leaf in weights.train_state_leaves(state)]
        if not wait:
            self._ensure_worker()
            self._queue.put((step, arrays))
        else:
            self._write_step(step, arrays)
        return step

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

    def _write_step(self, step: int, arrays: List[Tuple[str, np.ndarray]]
                    ) -> None:
        final_dir = os.path.join(self.directory, _step_dirname(step))
        if not self._swept_stale:
            self._swept_stale = True
            for name in os.listdir(self.directory):
                if name.startswith(_TMP_PREFIX):
                    logger.warning('Removing stale in-progress checkpoint '
                                   '%r (a save was killed mid-write).', name)
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)
        tmp_dir = os.path.join(self.directory, f'{_TMP_PREFIX}{step:08d}')
        shutil.rmtree(tmp_dir, ignore_errors=True)
        os.makedirs(os.path.join(tmp_dir, 'arrays'))
        records = []
        for i, (path, data) in enumerate(arrays):
            fname = f'arrays/a{i:04d}.p0000.c00.npy'
            raw = _npy_bytes(data)
            with open(os.path.join(tmp_dir, fname), 'wb') as f:
                f.write(raw)
            records.append({
                'path': path, 'shape': list(data.shape),
                'dtype': str(data.dtype), 'spec': None,
                'chunks': [{'file': fname, 'start': [0] * data.ndim,
                            'shape': list(data.shape),
                            'sha256': _sha256(raw)}]})
        manifest = {'format': FORMAT_VERSION, 'step': step,
                    'time': time.time(), 'process_count': 1,
                    'mesh_axes': None, 'arrays': records}
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
    def restore_tree(self, template: train_lib.TrainState, step: int,
                     device='cuda') -> train_lib.TrainState:
        """Restore ``step`` into a TrainState shaped like ``template``
        (see :func:`abstract_train_state`), on ``device``. Verifies the
        manifest and every chunk digest (CheckpointCorruptError); a
        tree, shape or dtype mismatch is a config mismatch (ValueError),
        not corruption."""
        arrays = self._read_arrays(step, weights.train_state_leaves(template))
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

    def _read_arrays(self, step: int, want, prefix: str = ''
                     ) -> Dict[str, np.ndarray]:
        """The arrays of ``step`` at the (path, leaf) pairs ``want``,
        which must be every array of the step whose path starts with
        ``prefix``; a missing, extra or differently shaped or typed
        array is a config mismatch (ValueError)."""
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
            arrays[path] = _assemble_array(step_dir, step, rec)
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

    def restore_newest(self, template: train_lib.TrainState, device='cuda'
                       ) -> Tuple[Optional[train_lib.TrainState],
                                  Optional[int]]:
        """Walk complete steps newest→oldest; refuse corrupt steps loudly
        and fall back. (None, None) when there are no steps; raises
        CheckpointCorruptError when steps exist but none restores."""
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


def _assemble_array(step_dir: str, step: int,
                    rec: Dict[str, Any]) -> np.ndarray:
    """Reassemble one array from its chunk files, verifying every
    content digest and that the chunks exactly tile the array (in
    bounds, pairwise disjoint, volumes summing to the array's)."""
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
    out = np.empty(shape, np.dtype(rec['dtype']))
    for chunk in rec['chunks']:
        try:
            with open(os.path.join(step_dir, chunk['file']), 'rb') as f:
                raw = f.read()
        except OSError as e:
            raise CheckpointCorruptError(
                f'step {step}: chunk {chunk["file"]} unreadable: {e}'
            ) from None
        if _sha256(raw) != chunk['sha256']:
            raise CheckpointCorruptError(
                f'step {step}: chunk {chunk["file"]} content digest '
                f'mismatch (truncated or corrupted on disk).')
        try:
            data = np.load(io.BytesIO(raw), allow_pickle=False)
        except ValueError as e:
            raise CheckpointCorruptError(
                f'step {step}: chunk {chunk["file"]} undecodable: {e}'
            ) from None
        if list(data.shape) != list(chunk['shape']):
            raise CheckpointCorruptError(
                f'step {step}: chunk {chunk["file"]} shape {data.shape} != '
                f'manifest {chunk["shape"]}.')
        out[tuple(slice(s, s + d) for s, d in
                  zip(chunk['start'], data.shape))] = data
    return out


def restore_or_init(directory: str, cfg: LlamaConfig, tx: train_lib.AdamW,
                    device='cuda', params: Optional[train_lib.Params] = None
                    ) -> Tuple[train_lib.TrainState, int, Checkpointer]:
    """The trainer's resume entry point: the newest restorable step if
    there is one, else a fresh state (``params`` if given, else random
    from seed 0). Returns (state, start_step, ckpt)."""
    ckpt = Checkpointer(directory)
    if ckpt.latest_step() is not None:
        state, step = ckpt.restore_newest(abstract_train_state(cfg, tx),
                                          device)
        logger.info('Resumed from checkpoint step %d in %s.', step,
                    directory)
        return state, step, ckpt
    return train_lib.init_train_state(cfg, tx, device, params=params), 0, ckpt
