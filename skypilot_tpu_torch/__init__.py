"""PyTorch/CUDA port of the skypilot_tpu model and serving path.

Module names mirror the JAX package (``skypilot_tpu``) so each port
module sits beside its counterpart: ``config`` (models/llama.py's
config half), ``ops``, ``models``, ``data``, ``serve``. The hand-written
Hopper kernels live in ``csrc/`` and are built and bound by
``kernels/build.py``. Nothing here imports jax or the JAX package.
"""
