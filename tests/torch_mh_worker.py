"""One rank of the port's engine gang on the CPU, for
tests/test_torch_multihost.py and
tests/test_torch_gang_serving.py.

    python tests/torch_mh_worker.py ENGINE-FLAGS...

Runs ``python -m skypilot_tpu_torch.serve.engine ENGINE-FLAGS`` in this
process, with every debug preset (llama-debug, moe-debug, gptoss-debug,
mla-debug, deepseek-moe-debug) computing in fp32 (the JAX engine tests'
``eng.cfg = replace(eng.cfg, dtype=float32)``: greedy tokens compared
across packages and shardings need fp32 arithmetic). Imports torch and
the port only, never JAX.
"""
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from skypilot_tpu_torch import config  # noqa: E402
from skypilot_tpu_torch.serve import engine  # noqa: E402

if __name__ == '__main__':
    torch.set_num_threads(1)
    for presets in (config.PRESETS, config.MOE_PRESETS, config.MLA_PRESETS):
        for name, cfg in presets.items():
            if name.endswith('-debug'):
                presets[name] = dataclasses.replace(cfg, dtype=torch.float32)
    engine.main(sys.argv[1:])
