"""Offline batch inference of the PyTorch port (models/batch_infer.py)
on the CPU: JAX's tests/unit_tests/test_batch_infer.py (stride
partition, resume, workers, truncation, the gang environment, embed
shapes and padding invariance, pool modes) on ``device='cpu'``, plus
the port against the JAX package on the same bridged weights:
``_pooled_hidden`` rows within TOL (2e-4, rtol and atol: fp32 on both
sides, a forward's products summed in other orders) and a generate
batch's tokens exactly; the refusal of ``--mesh`` by name (``--hf-dir``
and ``--tokenizer`` run: tests/test_torch_hf.py); and the CLI, which
writes, resumes and partitions. The padding-invariance bound is JAX's
own (2e-4 on bf16 compute with padding moved).
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import batch_infer as jbatch_infer
from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch import config
from skypilot_tpu_torch.models import batch_infer, weights

TOL = 2e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_jsonl(path, records):
    with open(path, 'w', encoding='utf-8') as f:
        for r in records:
            f.write(json.dumps(r) + '\n')


def _args(**kw):
    base = dict(input=None, output=None, mode='generate', model=None,
                hf_dir=None, tokenizer=None, mesh={}, batch_size=4,
                max_len=256, max_new_tokens=8, temperature=0.0,
                top_k=None, top_p=None, seed=0, pool='mean',
                num_workers=1, worker_id=0, device='cpu')
    base.update(kw)
    return argparse.Namespace(**base)


# ------------------------------------------------------------ partitioning

def test_stride_and_default_ids(tmp_path):
    path = str(tmp_path / 'in.jsonl')
    _write_jsonl(path, [{'prompt': f'p{i}'} for i in range(7)])
    w0 = batch_infer.read_items(path, 2, 0)
    w1 = batch_infer.read_items(path, 2, 1)
    assert [it['id'] for it in w0] == [0, 2, 4, 6]
    assert [it['id'] for it in w1] == [1, 3, 5]
    assert w0[1]['text'] == 'p2'
    assert w0 == jbatch_infer.read_items(path, 2, 0)


def test_explicit_ids_and_text_key(tmp_path):
    path = str(tmp_path / 'in.jsonl')
    _write_jsonl(path, [{'id': 'a', 'text': 'hello'},
                        {'id': 'b', 'prompt': 'world'}])
    items = batch_infer.read_items(path, 1, 0)
    assert [(it['id'], it['text']) for it in items] == [
        ('a', 'hello'), ('b', 'world')]


def test_missing_text_fails_loudly(tmp_path):
    path = str(tmp_path / 'in.jsonl')
    _write_jsonl(path, [{'id': 1}])
    with pytest.raises(ValueError, match='needs "prompt" or "text"'):
        batch_infer.read_items(path, 1, 0)


def test_done_ids_skips_corrupt_tail(tmp_path):
    out = str(tmp_path / 'out.jsonl')
    with open(out, 'w') as f:
        f.write(json.dumps({'id': 3, 'completion': 'x'}) + '\n')
        f.write('{"id": 5, "comple')   # crash mid-write
    assert batch_infer.done_ids(out) == {3}
    assert batch_infer.done_ids(str(tmp_path / 'absent.jsonl')) == set()


# --------------------------------------------------------------------- run

def test_generate_resume_and_outputs(tmp_path):
    inp = str(tmp_path / 'in.jsonl')
    out = str(tmp_path / 'out.jsonl')
    _write_jsonl(inp, [{'prompt': 'hello world ' * (i + 1)}
                       for i in range(5)])
    args = _args(input=inp, output=out, model='llama-debug',
                 max_new_tokens=4, batch_size=2)
    stats = batch_infer.run(args)
    assert stats == {'total': 5, 'done': 0, 'ran': 5}
    recs = [json.loads(line) for line in open(out)]
    assert sorted(r['id'] for r in recs) == [0, 1, 2, 3, 4]
    assert all(isinstance(r['completion'], str) for r in recs)
    assert all(r['tokens'] == 4 for r in recs)
    # Second run: everything already present, nothing re-runs.
    stats2 = batch_infer.run(args)
    assert stats2['ran'] == 0 and stats2['done'] == 5


def test_worker_partitions_are_disjoint_and_complete(tmp_path):
    inp = str(tmp_path / 'in.jsonl')
    out = str(tmp_path / 'out.jsonl')
    _write_jsonl(inp, [{'prompt': f'item {i}'} for i in range(6)])
    ids = []
    for w in range(2):
        args = _args(input=inp, output=out, model='llama-debug',
                     max_new_tokens=2, num_workers=2, worker_id=w)
        batch_infer.run(args)
        part = f'{out}.part{w}'
        assert os.path.exists(part)
        ids += [json.loads(line)['id'] for line in open(part)]
    assert sorted(ids) == [0, 1, 2, 3, 4, 5]
    with pytest.raises(ValueError, match='outside'):
        batch_infer.run(_args(input=inp, output=out, model='llama-debug',
                              num_workers=2, worker_id=2))


def test_overlong_prompt_truncates_instead_of_crash_looping(tmp_path):
    inp = str(tmp_path / 'in.jsonl')
    out = str(tmp_path / 'out.jsonl')
    # Byte tokenizer: 1 char = 1 token, so 300 tokens > max_len=64.
    _write_jsonl(inp, [{'prompt': 'x' * 300}, {'prompt': 'tiny'}])
    args = _args(input=inp, output=out, model='llama-debug', max_len=64,
                 max_new_tokens=8, batch_size=2)
    stats = batch_infer.run(args)
    assert stats['ran'] == 2   # completes; no budget ValueError
    assert len([json.loads(line) for line in open(out)]) == 2


def test_max_new_tokens_exceeding_max_len_fails_loudly(tmp_path):
    inp = str(tmp_path / 'in.jsonl')
    _write_jsonl(inp, [{'prompt': 'hi'}])
    args = _args(input=inp, output=str(tmp_path / 'o.jsonl'),
                 model='llama-debug', max_len=32, max_new_tokens=32)
    with pytest.raises(ValueError, match='no prompt room'):
        batch_infer.run(args)


@pytest.mark.parametrize('flag,kw', [
    ('--mesh', {'mesh': {'tensor': 2}})])
def test_unported_flags_refused_by_name(tmp_path, flag, kw):
    inp = str(tmp_path / 'in.jsonl')
    _write_jsonl(inp, [{'prompt': 'hi'}])
    args = _args(input=inp, output=str(tmp_path / 'o.jsonl'),
                 model='llama-debug', **kw)
    with pytest.raises(NotImplementedError, match=flag):
        batch_infer.run(args)
    assert not os.path.exists(str(tmp_path / 'o.jsonl'))


def test_runner_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is usable')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        batch_infer.BatchRunner(model='llama-debug')
    assert batch_infer.build_parser().parse_args(
        ['--input', 'a', '--output', 'b']).device == 'cuda'


def test_gang_env_defaults(tmp_path, monkeypatch):
    inp = str(tmp_path / 'in.jsonl')
    out = str(tmp_path / 'out.jsonl')
    _write_jsonl(inp, [{'prompt': f'i{i}'} for i in range(4)])
    monkeypatch.setenv('SKYPILOT_NUM_NODES', '2')
    monkeypatch.setenv('SKYPILOT_NODE_RANK', '1')
    args = _args(input=inp, output=out, model='llama-debug',
                 max_new_tokens=2, num_workers=None, worker_id=None)
    stats = batch_infer.run(args)
    assert stats['total'] == 2   # the odd-indexed half
    assert os.path.exists(f'{out}.part1')


# ------------------------------------------------------------------- embed

def test_embeddings_shape_and_padding_invariance(tmp_path):
    inp = str(tmp_path / 'in.jsonl')
    out = str(tmp_path / 'emb.jsonl')
    # One short record alone...
    _write_jsonl(inp, [{'id': 'solo', 'text': 'short one'}])
    batch_infer.run(_args(input=inp, output=out, mode='embed',
                          model='llama-debug'))
    solo = json.loads(open(out).readline())['embedding']
    # ...then batched beside a much longer one (more padding): the same.
    inp2 = str(tmp_path / 'in2.jsonl')
    out2 = str(tmp_path / 'emb2.jsonl')
    _write_jsonl(inp2, [{'id': 'solo', 'text': 'short one'},
                        {'id': 'long', 'text': 'a much longer record ' * 10}])
    batch_infer.run(_args(input=inp2, output=out2, mode='embed',
                          model='llama-debug', batch_size=2))
    recs = {json.loads(line)['id']: json.loads(line)['embedding']
            for line in open(out2)}
    dim = config.get_config('llama-debug').dim
    assert len(solo) == dim and len(recs['long']) == dim
    np.testing.assert_allclose(recs['solo'], solo, atol=2e-4)


def test_pool_modes_differ(tmp_path):
    inp = str(tmp_path / 'in.jsonl')
    _write_jsonl(inp, [{'text': 'several words in here'}])
    embs = {}
    for pool in ('mean', 'last'):
        out = str(tmp_path / f'{pool}.jsonl')
        batch_infer.run(_args(input=inp, output=out, mode='embed',
                              model='llama-debug', pool=pool))
        embs[pool] = json.loads(open(out).readline())['embedding']
    assert not np.allclose(embs['mean'], embs['last'])


def test_embed_refuses_the_mla_family():
    cfg = dataclasses.replace(config.get_config('mla-debug'),
                              dtype=torch.float32)
    runner = batch_infer.BatchRunner(model='mla-debug', device='cpu',
                                     cfg=cfg)
    with pytest.raises(ValueError, match='dense family only'):
        runner.embed_batch([[1, 2, 3]])
    rows = runner.generate_batch([[1, 2, 3], [4, 5]], 4, 0.0, None, None, 0)
    assert [len(r) for r in rows] == [4, 4]


# ------------------------------------------------------------ against JAX

def _bridged():
    jcfg = dataclasses.replace(jllama.PRESETS['llama-debug'],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(config.PRESETS['llama-debug'],
                               dtype=torch.float32)
    tree = jax.device_get(jllama.init_params(jax.random.PRNGKey(0), jcfg))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            weights.params_from_jax(tree, tcfg, device='cpu'))


@pytest.mark.parametrize('pool', ['mean', 'last'])
def test_pooled_hidden_matches_jax(pool):
    jcfg, tcfg, jp, tp = _bridged()
    runner = batch_infer.BatchRunner(device='cpu', cfg=tcfg, params=tp)
    rows = [list(range(1, n + 1)) for n in (3, 17, 9)]
    prompt, lens, width = runner._pad_batch(rows, runner.max_len)
    assert width == 32 and lens.tolist() == [3, 17, 9]
    got = batch_infer._pooled_hidden(tp, prompt, lens, cfg=tcfg, pool=pool)
    want = jbatch_infer._pooled_hidden(jp, jnp.asarray(prompt.numpy()),
                                       jnp.asarray(lens.numpy()), cfg=jcfg,
                                       pool=pool)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    embs = runner.embed_batch(rows, pool=pool)
    np.testing.assert_allclose(np.asarray(embs), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_generate_batch_matches_jax_generate():
    jcfg, tcfg, jp, tp = _bridged()
    runner = batch_infer.BatchRunner(device='cpu', cfg=tcfg, params=tp,
                                     max_len=64)
    rows = [list(b'hello'), list(b'a longer prompt, ragged'), list(b'x')]
    got = runner.generate_batch(rows, 6, 0.0, None, None, seed=0)
    prompt, lens, width = runner._pad_batch(rows, 64 - 6)
    want = jdecode.generate(jp, jnp.asarray(prompt.numpy()), jcfg, 6,
                            max_len=width + 6,
                            prompt_lengths=jnp.asarray(lens.numpy()))
    assert got == np.asarray(want).tolist()


def test_cli_writes_resumes_and_partitions(tmp_path):
    inp = str(tmp_path / 'in.jsonl')
    out = str(tmp_path / 'out.jsonl')
    _write_jsonl(inp, [{'prompt': f'record {i}'} for i in range(5)])
    env = dict(os.environ, PYTHONPATH=ROOT)
    base = [sys.executable, '-m', 'skypilot_tpu_torch.models.batch_infer',
            '--model', 'llama-debug', '--device', 'cpu', '--input', inp,
            '--output', out, '--max-new-tokens', '3', '--batch-size', '2']

    def cli(*extra):
        return subprocess.run(base + list(extra), env=env, cwd=ROOT,
                              capture_output=True, text=True, timeout=300)
    r = cli()
    assert r.returncode == 0, r.stderr
    assert len(open(out).readlines()) == 5
    r = cli()
    assert r.returncode == 0 and '"ran": 0' in r.stderr, r.stderr
    r = cli('--num-workers', '2', '--worker-id', '1')
    assert r.returncode == 0, r.stderr
    assert sorted(json.loads(line)['id']
                  for line in open(f'{out}.part1')) == [1, 3]
    r = cli('--mesh', 'tensor=2')
    assert r.returncode != 0 and '--mesh' in r.stderr
