"""The port's own safetensors codec (the counterpart of the
``safetensors`` library calls in skypilot_tpu/models/hf_import.py
``_load_tensors`` and hf_export.py ``save_hf_checkpoint``, which the
card's machine does not have).

A file is an 8-byte little-endian header length N, N bytes of JSON, then
the data buffer. The header maps each tensor name to ``{"dtype",
"shape", "data_offsets": [begin, end]}`` (byte offsets into the data
buffer) and may hold ``"__metadata__"``, a string-to-string map.

:func:`load_file` reads through one ``numpy.memmap`` of the file and
keeps every tensor's stored dtype: BF16 stays ``torch.bfloat16`` (read
as 2-byte integers, then viewed), F16 stays ``torch.float16``, so
nothing is cast behind the caller's back. It refuses, by name, a
truncated file, offsets that overlap or run past the end of the data,
a byte count that does not match the shape, and a dtype it does not
know. :func:`save_file` writes one file that the ``safetensors``
library reads: tensors sorted by alignment then name, laid end to end,
the header padded with spaces to a multiple of 8 bytes.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# safetensors dtype name → (torch dtype, numpy dtype of the same width
# that numpy can memory-map; BF16 has none, so it is read as int16).
_DTYPES = {
    'F32': (torch.float32, np.float32),
    'F16': (torch.float16, np.float16),
    'BF16': (torch.bfloat16, np.int16),
    'I64': (torch.int64, np.int64),
    'I32': (torch.int32, np.int32),
    'I8': (torch.int8, np.int8),
    'U8': (torch.uint8, np.uint8),
    'BOOL': (torch.bool, np.bool_),
}
_NAMES = {t: name for name, (t, _) in _DTYPES.items()}
_MAX_HEADER = 100 * 1024 * 1024   # the format's own limit


class SafetensorsError(ValueError):
    """A file that is not a well-formed safetensors file."""


def read_header(path: str) -> Tuple[Dict[str, dict], Dict[str, str], int]:
    """(tensor entries by name, metadata, byte offset of the data
    buffer), checked against the file's size: every entry's dtype known,
    its byte count equal to its shape's, no two entries overlapping and
    none running past the end."""
    size = os.path.getsize(path)
    with open(path, 'rb') as f:
        head = f.read(8)
        if len(head) < 8:
            raise SafetensorsError(f'{path}: truncated: {size} bytes, no '
                                   f'8-byte header length')
        (n,) = struct.unpack('<Q', head)
        if n > _MAX_HEADER or 8 + n > size:
            raise SafetensorsError(f'{path}: truncated: header of {n} bytes '
                                   f'in a file of {size}')
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise SafetensorsError(f'{path}: header is not JSON: {e}') \
                from None
    if not isinstance(header, dict):
        raise SafetensorsError(f'{path}: header is not a JSON object')
    meta = header.pop('__metadata__', None) or {}
    data_len = size - 8 - n
    spans = []
    for name, ent in header.items():
        try:
            dtype, shape = ent['dtype'], [int(d) for d in ent['shape']]
            begin, end = (int(o) for o in ent['data_offsets'])
        except (TypeError, KeyError, ValueError):
            raise SafetensorsError(f'{path}: tensor {name!r}: malformed '
                                   f'entry {ent!r}') from None
        if dtype not in _DTYPES:
            raise SafetensorsError(
                f'{path}: tensor {name!r}: unknown dtype {dtype!r} (this '
                f'reader takes {sorted(_DTYPES)})')
        itemsize = np.dtype(_DTYPES[dtype][1]).itemsize
        if begin < 0 or end < begin or \
                end - begin != itemsize * int(np.prod(shape)):
            raise SafetensorsError(
                f'{path}: tensor {name!r}: data_offsets {[begin, end]} do '
                f'not hold {dtype}{shape}')
        if end > data_len:
            raise SafetensorsError(
                f'{path}: tensor {name!r}: data_offsets {[begin, end]} run '
                f'past the end of the data ({data_len} bytes): truncated')
        spans.append((begin, end, name))
    spans.sort()
    for (_, e0, a), (b1, _, b) in zip(spans, spans[1:]):
        if b1 < e0:
            raise SafetensorsError(f'{path}: tensors {a!r} and {b!r} '
                                   f'overlap')
    return header, meta, 8 + n


def load_file(path: str, device='cpu') -> Dict[str, torch.Tensor]:
    """Every tensor of ``path``, in its stored dtype, on ``device``. On
    the CPU a tensor whose bytes are aligned shares the file's
    copy-on-write memory map (pages are read when touched); an
    unaligned one is copied."""
    header, _, start = read_header(path)
    mm = np.memmap(path, dtype=np.uint8, mode='c')
    out: Dict[str, torch.Tensor] = {}
    for name, ent in header.items():
        tdtype, ndtype = _DTYPES[ent['dtype']]
        begin, end = (int(o) for o in ent['data_offsets'])
        raw = mm[start + begin:start + end]
        if (start + begin) % np.dtype(ndtype).itemsize:
            raw = np.array(raw)               # an aligned copy
        arr = raw.view(ndtype).reshape([int(d) for d in ent['shape']])
        t = torch.from_numpy(arr)
        if tdtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        out[name] = t.to(device) if torch.device(device).type != 'cpu' \
            else t
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (any device; stored in their own dtypes, which
    must be ones the format has) to ``path`` as one safetensors file."""
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise SafetensorsError(f'tensor {name!r}: dtype {t.dtype} has '
                                   f'no safetensors name')
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, object] = {}
    if metadata:
        header['__metadata__'] = {str(k): str(v) for k, v in
                                  metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {'dtype': _NAMES[t.dtype], 'shape': list(t.shape),
                        'data_offsets': [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(',', ':')).encode()
    blob += b' ' * (-len(blob) % 8)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().reshape(-1).cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(memoryview(t.numpy()).cast('B'))
