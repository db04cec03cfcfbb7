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


def _pool(seed, s, n_pages=12, psz=8, kh=2, hd=16, maxp=4, length=None):
    """Ragged rows over shuffled pages; table tails are the trash page;
    one row has length 0."""
    rng = np.random.default_rng(seed)
    kp, vp = _np(rng, n_pages, psz, kh, hd), _np(rng, n_pages, psz, kh, hd)
    if length is None:
        length = np.array([13, 0, 27 - s, 5], np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((len(length), maxp), np.int32)
    used = 0
    for r, n in enumerate(length):
        need = min(-(-(int(n) + s) // psz), maxp)
        table[r, :need] = perm[used:used + need]
        used += need
    return rng, kp, vp, table, length


# (g, S): the q heads a kv head serves and the step width. Kernel B
# takes g*S up to 64, so the plain version is held to the JAX kernel over
# that range: g = 2 (llama-1b), 7 (qwen2-7b) and 8 (llama3-70b, qwen2-72b)
# at S = 1 (decode), 4 and 8 (verify).
PAGED_PARITY = [pytest.param(2, s, id=str(s)) for s in (1, 4)] + [
    pytest.param(g, s, id=f'g{g}-s{s}')
    for g, s in ((2, 8), (7, 1), (7, 4), (7, 8), (8, 1), (8, 4), (8, 8))]


@pytest.mark.parametrize('g,s', PAGED_PARITY)
def test_paged_plain_version_matches_jax_kernel(g, s):
    """Kernel B's plain version vs the JAX paged kernel (interpret)."""
    rng, kp, vp, table, length = _pool(5 + s, s)
    q = _np(rng, len(length), s, 2 * g, 16)
    got = paged_attention.paged_decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(length))
    want = jpaged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(length), interpret=True)
    _close(got, want)


@pytest.mark.parametrize('b,kh,maxp,want', [
    (8, 8, 32, (8, 4)),      # llama-1b serving: 512 blocks, 4 pages each
    (8, 4, 32, (16, 2)),     # g = 7 or 8 heads: KH = 4
    (4, 2, 6, (6, 1)),       # few pages: one a chunk
    (64, 8, 32, (2, 16)),    # B*KH = 512 blocks already: two chunks
    (128, 8, 32, (1, 32)),   # more than enough: one chunk, no split
    (8, 8, 30, (8, 4)),      # the last chunk short (2 pages)
    (3, 1, 1, (1, 1))])
def test_kernel_b_split_covers_every_page_once(b, kh, maxp, want):
    """Kernel B's grid (chunks, KH, B) on 132 SMs: every page in exactly
    one chunk, every chunk but the last full, and at least half the 4
    blocks per SM the split aims at where the pages allow (evening the
    chunks out rounds the count down)."""
    chunks, per = paged_attention.split_pages(b, kh, maxp, 132)
    assert (chunks, per) == want
    assert (chunks - 1) * per < maxp <= chunks * per
    assert chunks * b * kh >= min(2 * 132, maxp * b * kh)


@pytest.mark.parametrize('rows,splits', [(1, 4), (2, 4), (16, 4), (17, 2),
                                         (21, 2), (32, 2), (35, 1),
                                         (64, 1)])
def test_kernel_b_workspace_holds_a_partial_per_warp(rows, splits):
    """A partial per (batch row, kv head, chunk, key split, q row), where
    the 4 warps of a block share ceil(rows / 16) m-tiles (1, 2 or 4),
    each 128 output floats, a max and a sum; and a ticket per (batch
    row, kv head)."""
    assert paged_attention.key_splits(rows) == splits
    assert paged_attention.workspace_sizes(8, 4, rows, 16, 128) == \
        (8 * 4 * 16 * splits * rows * (128 + 2), 8 * 4)


@pytest.mark.parametrize('h,kh,s,ok', [(16, 2, 8, True), (28, 4, 9, True),
                                       (16, 2, 9, False), (64, 1, 2, False)])
def test_kernel_b_row_limit(h, kh, s, ok):
    """g*S up to 64 passes kernel B's checks (and here stops at the card
    test, as CPU tensors); above 64 the wrapper refuses it by name."""
    q = torch.zeros(1, s, h, 128, dtype=torch.bfloat16)
    pool = torch.zeros(3, 16, kh, 128, dtype=torch.bfloat16)
    table = torch.zeros(1, 2, dtype=torch.int32)
    length = torch.zeros(1, dtype=torch.int32)
    msg = 'must all lie on the card' if ok else 'at most 64 q rows'
    with pytest.raises(ValueError, match=msg):
        paged_attention._check_kernel_inputs(q, pool, pool, table, length)


@pytest.mark.parametrize('hd,psz,s,ok', [
    (64, 64, 1, True), (128, 64, 1, True), (256, 64, 1, True),
    (64, 60, 1, False), (128, 60, 1, False), (256, 60, 1, False),
    (96, 64, 1, False), (64, 64, 16, True), (64, 64, 17, False),
    (64, 136, 1, False)])
def test_kernel_b_gate_takes_exactly_the_kernel_shapes(hd, psz, s, ok):
    """Kernel B's gate names the shapes the kernel takes: head_dim 64,
    128 or 256, pages a multiple of 8 up to 128 tokens, g*S <= 64 (here
    g = 4, llama3.2-1b's 32/8 heads). A shape it takes passes the
    wrapper's own checks (and stops here only because CPU tensors are
    not on the card); a shape it declines is one the wrapper raises on,
    so paged_attention_step never hands B a shape B refuses."""
    q_shape, pool_shape = (2, s, 32, hd), (5, psz, 8, hd)
    assert paged_attention.kernel_takes(q_shape, pool_shape) is ok
    for switch in (dict(logit_softcap=30.0), dict(window=64),
                   dict(sinks=torch.zeros(32))):
        assert not paged_attention.kernel_takes(q_shape, pool_shape,
                                                **switch)
    q = torch.zeros(q_shape, dtype=torch.bfloat16)
    pool = torch.zeros(pool_shape, dtype=torch.bfloat16)
    table = torch.zeros(2, 3, dtype=torch.int32)
    length = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError) as err:
        paged_attention._check_kernel_inputs(q, pool, pool, table, length)
    assert ('must all lie on the card' in str(err.value)) is ok


def _paged_step_both(rng, kp, vp, table, length, s, active):
    """One paged step through JAX paged_attention_step(impl='fused') and
    the port's CPU step on the same inputs: (out, kp2, vp2, jout, jkp,
    jvp); asserts the port updated its pools in place."""
    b = len(length)
    q = _np(rng, b, s, 4, 16)
    k_new, v_new = _np(rng, b, s, 2, 16), _np(rng, b, s, 2, 16)
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
    return out, kp2, vp2, jout, jkp, jvp


@pytest.mark.parametrize('s', [1, 4])
def test_paged_step_matches_jax_fused(s):
    """The CPU step (fused overlay-then-attend, in place) vs JAX
    paged_attention_step(impl='fused'): output and both pools."""
    rng, kp, vp, table, length = _pool(9 + s, s)
    out, kp2, vp2, jout, jkp, jvp = _paged_step_both(
        rng, kp, vp, table, length, s, np.array([True, True, False, True]))
    _close(out, jout)
    # Trash-page writes (the inactive row's) race in any order; the
    # content pages must match bit for bit.
    np.testing.assert_array_equal(kp2.numpy()[1:], np.asarray(jkp)[1:])
    np.testing.assert_array_equal(vp2.numpy()[1:], np.asarray(jvp)[1:])


def test_paged_step_drops_positions_past_the_view():
    """A row with length + S > max_len: the JAX scatter drops the overlay
    positions at or past max_len, so the port's step must too (a clamp
    would write keys 1-3 into the view's last slot). Every row active:
    the output of each and every content page must match JAX."""
    s, max_len = 4, 32
    rng, kp, vp, table, length = _pool(
        40, s, length=np.array([13, 0, max_len - 2, 5], np.int32))
    out, kp2, vp2, jout, jkp, jvp = _paged_step_both(
        rng, kp, vp, table, length, s, np.ones(4, bool))
    _close(out, jout)
    np.testing.assert_array_equal(kp2.numpy()[1:], np.asarray(jkp)[1:])
    np.testing.assert_array_equal(vp2.numpy()[1:], np.asarray(jvp)[1:])


def test_gather_and_write_pages_match_jax():
    rng, kp, _, table, length = _pool(20, 1)
    _close(paged_attention.gather_pages(torch.from_numpy(kp),
                                        torch.from_numpy(table), 30),
           jpa.gather_pages(jnp.asarray(kp), jnp.asarray(table), 30), atol=0)


def test_wrappers_take_plain_version_on_cpu_and_launch_nothing():
    """On CPU tensors the wrappers give exactly their plain versions,
    build nothing and leave every kernel's launch count at 0."""
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
    assert set(kernels) == {'flash_fwd', 'flash_dq', 'flash_dkv',
                            'paged_decode'}
    for k in kernels.values():
        assert k.launches == 0
        assert k._fn is None                 # never built or loaded
