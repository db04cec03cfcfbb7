"""PyTorch port ops vs the JAX package's ops, on the CPU.

The same numpy-seeded inputs go through each JAX function and its port
counterpart (skypilot_tpu_torch.ops) in fp32. Tolerance 1e-5 absolute:
both sides compute in fp32 and differ only in summation order. The two
kernels' plain versions are held against the JAX Pallas kernels run in
interpret mode, as tests/unit_tests/test_flash_attention.py and
test_paged_attention.py run them.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skypilot_tpu.models import paging as jpaging
from skypilot_tpu.ops import norms as jnorms
from skypilot_tpu.ops import paged_attention as jpa
from skypilot_tpu.ops import rotary as jrotary
from skypilot_tpu.ops.attention import xla_attention as jxla_attention
from skypilot_tpu.ops.pallas import flash_attention as jflash
from skypilot_tpu.ops.pallas import paged_attention as jpaged
from skypilot_tpu_torch.kernels import build
from skypilot_tpu_torch.models import paging
from skypilot_tpu_torch.ops import attention, flash_attention, norms
from skypilot_tpu_torch.ops import paged_attention, rotary

ATOL = 1e-5


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=0)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, scale = _np(rng, 2, 5, 16), _np(rng, 16)
    _close(norms.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                          1e-5),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))


LLAMA3 = dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
              original_max_position=64)
YARN = dict(factor=4.0, rope_type='yarn', beta_fast=32.0, beta_slow=1.0,
            original_max_position=64)


@pytest.mark.parametrize('scaling', [None, LLAMA3, YARN],
                         ids=['none', 'llama3', 'yarn'])
@pytest.mark.parametrize('per_row', [False, True])
def test_rope_frequencies(scaling, per_row):
    rng = np.random.default_rng(1)
    pos = (rng.integers(0, 300, size=(3, 7)) if per_row
           else np.arange(11)).astype(np.int32)
    sin, cos = rotary.rope_frequencies(32, torch.from_numpy(pos), 10000.0,
                                       scaling)
    jsin, jcos = jrotary.rope_frequencies(32, jnp.asarray(pos), 10000.0,
                                          scaling)
    # Angles reach ~300 rad: fp32 sin/cos of a large argument differ by a
    # few ulps of the angle between libraries.
    _close(sin, jsin, atol=5e-5)
    _close(cos, jcos, atol=5e-5)


def test_apply_rope():
    rng = np.random.default_rng(2)
    x = _np(rng, 2, 6, 4, 16)
    pos = np.arange(6, dtype=np.int32)
    sin, cos = rotary.rope_frequencies(16, torch.from_numpy(pos), 500000.0)
    jsin, jcos = jrotary.rope_frequencies(16, jnp.asarray(pos), 500000.0)
    _close(rotary.apply_rope(torch.from_numpy(x), sin, cos),
           jrotary.apply_rope(jnp.asarray(x), jsin, jcos))


@pytest.mark.parametrize('offset', ['per_row', 'int', 'zero_noncausal'])
def test_plain_attention_matches_xla_attention(offset):
    rng = np.random.default_rng(3)
    b, s, t, kh, g, d = 3, 4, 24, 2, 2, 16
    q, k, v = (_np(rng, b, s, kh * g, d), _np(rng, b, t, kh, d),
               _np(rng, b, t, kh, d))
    causal = offset != 'zero_noncausal'
    if offset == 'per_row':
        q_off = np.array([0, 7, 20], np.int32)
        tq, jq = torch.from_numpy(q_off), jnp.asarray(q_off)
    else:
        tq = jq = 5 if offset == 'int' else 0
    got = attention.xla_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_offset=tq)
    want = jxla_attention(jnp.asarray(q), jnp.asarray(k),
                          jnp.asarray(v), causal=causal, q_offset=jq)
    _close(got, want)


@pytest.mark.parametrize('causal', [True, False])
def test_flash_plain_version_matches_jax_kernel(causal):
    """Kernel A's plain version vs the JAX flash kernel (interpret)."""
    rng = np.random.default_rng(4)
    b, s, kh, g, d = 1, 128, 2, 2, 128
    q, k, v = (_np(rng, b, s, kh * g, d), _np(rng, b, s, kh, d),
               _np(rng, b, s, kh, d))
    o, lse = flash_attention.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    jo, jlse = jflash.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True, block_q=128, block_k=128)
    _close(o, jo)
    _close(lse, jlse)


def _pool(seed, s, n_pages=12, psz=8, kh=2, hd=16, maxp=4):
    """Ragged rows over shuffled pages; table tails are the trash page;
    one row has length 0."""
    rng = np.random.default_rng(seed)
    kp, vp = _np(rng, n_pages, psz, kh, hd), _np(rng, n_pages, psz, kh, hd)
    length = np.array([13, 0, 27 - s, 5], np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((len(length), maxp), np.int32)
    used = 0
    for r, n in enumerate(length):
        need = -(-(int(n) + s) // psz)
        table[r, :need] = perm[used:used + need]
        used += need
    return rng, kp, vp, table, length


@pytest.mark.parametrize('s', [1, 4])
def test_paged_plain_version_matches_jax_kernel(s):
    """Kernel B's plain version vs the JAX paged kernel (interpret)."""
    rng, kp, vp, table, length = _pool(5 + s, s)
    q = _np(rng, len(length), s, 4, 16)
    got = paged_attention.paged_decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(length))
    want = jpaged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(length), interpret=True)
    _close(got, want)


@pytest.mark.parametrize('s', [1, 4])
def test_paged_step_matches_jax_fused(s):
    """The CPU step (fused overlay-then-attend, in place) vs JAX
    paged_attention_step(impl='fused'): output and both pools."""
    rng, kp, vp, table, length = _pool(9 + s, s)
    b = len(length)
    q = _np(rng, b, s, 4, 16)
    k_new, v_new = _np(rng, b, s, 2, 16), _np(rng, b, s, 2, 16)
    active = np.array([True, True, False, True])
    max_len = table.shape[1] * kp.shape[1]
    jcache = jpaging.PagedKV(k=jnp.asarray(kp)[None], v=jnp.asarray(vp)[None],
                             table=jnp.asarray(table),
                             length=jnp.asarray(length))
    jpos = jnp.asarray(length)[:, None] + jnp.arange(s)
    jpid, joff = jpaging._write_indices(jcache, jpos, jnp.asarray(active))
    jout, jkp, jvp = jpa.paged_attention_step(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(length), jnp.asarray(k_new), jnp.asarray(v_new), jpid,
        joff, max_len=max_len, impl='fused')
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tcache = paging.PagedKV(k=tkp[None], v=tvp[None],
                            table=torch.from_numpy(table),
                            length=torch.from_numpy(length))
    tpos = tcache.length[:, None].long() + torch.arange(s)
    pid, off = paging._write_indices(tcache, tpos, torch.from_numpy(active))
    out, kp2, vp2 = paged_attention.paged_attention_step(
        torch.from_numpy(q), tkp, tvp, tcache.table, tcache.length,
        torch.from_numpy(k_new), torch.from_numpy(v_new), pid, off,
        max_len=max_len)
    assert kp2 is tkp and vp2 is tvp          # updated in place
    _close(out, jout)
    # Trash-page writes (the inactive row's) race in any order; the
    # content pages must match bit for bit.
    np.testing.assert_array_equal(kp2.numpy()[1:], np.asarray(jkp)[1:])
    np.testing.assert_array_equal(vp2.numpy()[1:], np.asarray(jvp)[1:])


def test_gather_and_write_pages_match_jax():
    rng, kp, _, table, length = _pool(20, 1)
    _close(paged_attention.gather_pages(torch.from_numpy(kp),
                                        torch.from_numpy(table), 30),
           jpa.gather_pages(jnp.asarray(kp), jnp.asarray(table), 30), atol=0)


def test_wrappers_take_plain_version_on_cpu_and_launch_nothing():
    """On CPU tensors both wrappers give exactly their plain version,
    build nothing and leave their launch counts at 0."""
    build.reset_launches()
    rng, kp, vp, table, length = _pool(30, 1)
    q = torch.from_numpy(_np(rng, len(length), 1, 4, 16))
    args = (q, torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(table), torch.from_numpy(length))
    assert torch.equal(paged_attention.paged_decode_attention(*args),
                       paged_attention.paged_decode_attention_ref(*args))
    fq, fk, fv = (torch.from_numpy(_np(rng, 1, 20, 4, 16)),
                  torch.from_numpy(_np(rng, 1, 20, 2, 16)),
                  torch.from_numpy(_np(rng, 1, 20, 2, 16)))
    got = flash_attention.flash_attention_lse(fq, fk, fv)
    want = flash_attention.flash_attention_ref(fq, fk, fv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(attention.attention(fq, fk, fv),
                       attention.xla_attention(fq, fk, fv))
    kernels = build.kernels()
    assert set(kernels) == {'flash_fwd', 'paged_decode'}
    for k in kernels.values():
        assert k.launches == 0
        assert k._fn is None                 # never built or loaded
