"""Weight-only int8 (port of skypilot_tpu/models/decode.py:
``QuantizedWeight``, ``_quantize_int8``, ``_d``, ``_QUANT_KEYS``).

Every layer product of models/llama.py and models/mla.py reads its
weight through :func:`_d`, so a params tree may hold int8 weights where
it held floating ones; models/decode.py re-exports these names with
``cast_params_for_decode``, which makes such a tree. This module
imports nothing of the models, so llama.py can import it without a
cycle.

The dequant is plain PyTorch (int8 codes times the fp32 scale, one cast
to the compute dtype), as JAX leaves it to XLA: no Pallas kernel
computes it, so none is ported for it.
"""
from __future__ import annotations

import dataclasses

import torch

# Layer matrices worth quantizing: the >= 2-D projections (per-layer
# stacks are [L, in, out]). Norm scales and biases stay exact.
_QUANT_KEYS = frozenset(
    ['wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down',
     'w_dkv', 'w_kr', 'w_uk', 'w_uv', 'ws_gate', 'ws_up', 'ws_down'])


@dataclasses.dataclass
class QuantizedWeight:
    """Weight-only int8 with a per-output-channel scale: ``q`` int8 in
    the weight's shape, ``scale`` fp32 with the input axis (-2) kept as
    1. Indexing acts on the leading (layer) axis of both, so a stacked
    [L, in, out] leaf slices per layer as a tensor does
    (``llama.layer_params``)."""
    q: torch.Tensor
    scale: torch.Tensor

    def __getitem__(self, i) -> 'QuantizedWeight':
        return QuantizedWeight(q=self.q[i], scale=self.scale[i])


def _quantize_int8(w: torch.Tensor) -> QuantizedWeight:
    """Symmetric per-output-channel int8 from the weights as given (the
    callers pass the fp32 masters): absmax over axis -2 in fp32, scale =
    max(absmax, 1e-8) / 127 kept in fp32, codes = round half to even of
    w / scale clipped to [-127, 127] — the JAX arithmetic, so codes and
    scales are bit-equal to its."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantizedWeight(q=q, scale=scale)


def _d(w, dtype: torch.dtype) -> torch.Tensor:
    """Dense view of a (possibly quantized) weight in ``dtype``: int8
    codes times the fp32 scale, then one cast; a tensor is cast."""
    if isinstance(w, QuantizedWeight):
        return (w.q * w.scale).to(dtype)
    return w.to(dtype)
