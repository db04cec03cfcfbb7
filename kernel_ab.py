"""Time the kernels of two checkouts of the port on one card, in turns.

    python3 kernel_ab.py OLD_ROOT [NEW_ROOT]

NEW_ROOT defaults to this script's directory. The two sides run OLD,
NEW, NEW, OLD, each in a process of its own that puts its checkout
first on sys.path, builds that checkout's kernels from its csrc/ and
times each kernel's launch alone (CUDA events, median of 5 runs of 20
launches; 100 for kernel B) at chip_smoke.py's timing shapes: kernel A
at B=2 and B=4, kernels C and D at B=4, all S=T=2048, H=16, KH=8,
D=128, causal, bf16; kernel B at B=8, S=1, H=16, KH=8, psz 64,
max_pages 32, ragged lengths; and, where a checkout serves head_dim
256, A at B=2, H=KH=16, D=256 and B at H=KH=16, hd 256, and where its
backward takes head_dim 256, C and D at B=2, H=KH=16, D=256.
The timing code is this directory's chip_smoke.py for both sides, so
both are measured alike. Prints the card's name and power limit, one
``[ab]`` line per run and, last, a JSON object of every run's times.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_timing', os.path.join(HERE, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def prescaled_paged_launch(torch, pa, paging):
    """Kernel B's launch for a checkout whose kernel takes q pre-scaled
    and no workspace: the one-block-per-(row, kv head) design before the
    split over blocks (commit e685bd3 and earlier), which has no
    ``kernel_call``. The q pre-scale pass runs once, outside the timed
    launch, as the other kernels' inputs are made."""
    inputs = _smoke().paged_inputs(torch, pa, paging, 1, seed=8)
    q, kp, vp, table, length, _ = inputs
    qs = (q * q.shape[-1] ** -0.5).to(q.dtype)
    out = torch.empty_like(qs)
    b, s, h, hd = q.shape
    args = (qs.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
            length.data_ptr(), out.data_ptr(), b, s, h, kp.shape[2], hd,
            kp.shape[1], table.shape[1],
            torch.cuda.current_stream().cuda_stream)
    held = inputs + (qs, out)   # the closure holds every tensor in args
    return inputs, lambda: (held, pa.KERNEL.launch(*args))


def child(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from skypilot_tpu_torch.kernels import build
    from skypilot_tpu_torch.models import paging
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    if not torch.cuda.is_available():
        sys.exit('kernel_ab: no CUDA device')
    for mod in (fa, pa, paging):
        if not os.path.abspath(mod.__file__).startswith(os.path.abspath(root)):
            sys.exit(f'kernel_ab: imported {mod.__file__}, not {root}')
    build.build_all()
    smoke = _smoke()
    paged = smoke.paged_launch if hasattr(pa, 'kernel_call') else \
        prescaled_paged_launch
    print(json.dumps(smoke.kernel_ms(torch, fa, pa, paging, paged)),
          flush=True)


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == '--child':
        child(sys.argv[2])
        return
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    old = sys.argv[1]
    new = sys.argv[2] if len(sys.argv) == 3 else HERE
    print(_smoke().gpu_line(), flush=True)
    runs = []
    for side, root in (('old', old), ('new', new), ('new', new),
                       ('old', old)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              '--child', root], capture_output=True,
                             text=True, timeout=900)
        if out.returncode != 0:
            sys.exit(f'kernel_ab: {side} run failed:\n{out.stdout}\n'
                     f'{out.stderr}')
        ms = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append({'side': side, 'root': root, 'ms': ms})
        print(f'[ab] {side} ({root}): ' + ', '.join(
            f'{k} {v:.4f} ms' for k, v in ms.items()), flush=True)
    print(json.dumps({'runs': runs}), flush=True)


if __name__ == '__main__':
    main()
