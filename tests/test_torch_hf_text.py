"""The port's users of a checkpoint's tokenizer.json (serve/engine.py,
models/batch_infer.py, train/lora_merge.py and the trainer's --sft-data)
run with the tokenizers and regex libraries blocked, as on the card's
machine, on the CPU.

The checkpoint is llama-debug's shapes with the model vocabulary widened
to hold the Llama-3-style fixture's 3009 ids (random bf16 weights,
seed 0, written by the port's own exporter), with the fixture as its
tokenizer.json and a generation_config.json naming eos 3005
(<|end_of_text|>). The ids each user tokenizes are held exactly against
the tokenizers library's, taken before the libraries are blocked.
"""
import dataclasses
import json
import os
import shutil
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'data'))
import make_torch_tokenizer_fixtures as fixtures  # noqa: E402
from skypilot_tpu_torch import config  # noqa: E402
from skypilot_tpu_torch.data import tokenizer as tokenizer_lib  # noqa: E402
from skypilot_tpu_torch.models import (batch_infer, hf_export,  # noqa: E402
                                       hf_import, llama)
from skypilot_tpu_torch.serve import engine as engine_lib  # noqa: E402
from skypilot_tpu_torch.train import lora, lora_merge, train_lib  # noqa: E402
from skypilot_tpu_torch.train import trainer  # noqa: E402

VOCAB = 3072
EOS = 3005
PROMPTS = ['hello', 'Wie spät ist es in 東京?', 'a', 'Hopper ' * 9]


@pytest.fixture(scope='module')
def chat_dir(tmp_path_factory):
    """(directory, the library's ids of PROMPTS with specials)."""
    from tokenizers import Tokenizer
    d = str(tmp_path_factory.mktemp('hf_chat'))
    cfg = dataclasses.replace(config.get_config('llama-debug'),
                              vocab_size=VOCAB, tie_embeddings=False)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu',
                               dtype=torch.bfloat16)
    hf_export.save_hf_checkpoint(params, cfg, d)
    shutil.copyfile(fixtures.LLAMA3, os.path.join(d, 'tokenizer.json'))
    with open(os.path.join(d, 'generation_config.json'), 'w') as f:
        json.dump({'eos_token_id': EOS}, f)
    lib = Tokenizer.from_file(fixtures.LLAMA3)
    return d, [lib.encode(p).ids for p in PROMPTS]


@pytest.fixture
def blocked(monkeypatch):
    monkeypatch.setitem(sys.modules, 'tokenizers', None)
    monkeypatch.setitem(sys.modules, 'regex', None)


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def test_engine_serves_chat_from_the_hf_dir(chat_dir, blocked):
    """InferenceEngine(hf_dir=...): family llama3, <|eot_id|> and the
    checkpoint's eos among the eos ids; /v1/chat/completions as JSON and
    SSE, the prompt ids under the llama3 template the library's (the
    golden file's), the stream's text the JSON's."""
    eng = engine_lib.InferenceEngine(model=None, hf_dir=chat_dir[0],
                                     device='cpu', max_len=128)
    tok = eng.tokenizer
    assert tok.chat_family == 'llama3'
    assert {tok.token_to_id('<|eot_id|>'), EOS} <= set(tok.eos_ids)
    seen = []
    encode = tok.encode

    def recorded(text, add_special_tokens=True):
        seen.append(encode(text, add_special_tokens=add_special_tokens))
        return seen[-1]
    tok.encode = recorded
    server = engine_lib.build_app(eng)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    eng.start()
    base = f'http://127.0.0.1:{server.server_address[1]}'
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                if urllib.request.urlopen(base + '/health').status == 200:
                    break
            except urllib.error.HTTPError:
                pass
            assert time.monotonic() < deadline
            time.sleep(0.02)
        with open(fixtures.GOLDEN, encoding='utf-8') as f:
            want = json.load(f)['chat_prompt_ids']
        body = {'messages': fixtures.SFT_CHAT, 'max_tokens': 6,
                'temperature': 0}
        seen.clear()
        code, raw = _post(base, '/v1/chat/completions', body)
        doc = json.loads(raw)
        assert code == 200 and seen == [want]
        assert doc['usage']['prompt_tokens'] == len(want)
        code, raw = _post(base, '/v1/chat/completions',
                          dict(body, stream=True))
        blocks = [b for b in raw.decode().split('\n\n') if b]
        assert code == 200 and blocks[-1] == 'data: [DONE]'
        events = [json.loads(b[len('data: '):]) for b in blocks[:-1]]
        text = ''.join(e['choices'][0]['delta'].get('content', '')
                       for e in events[1:])
        assert text == doc['choices'][0]['message']['content']
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()


def test_batch_infer_tokenizes_with_the_reader(chat_dir, blocked, tmp_path):
    """batch_infer --hf-dir over text records: each record's prompt
    tokenized as the library does (BOS added), every record run."""
    import argparse
    inp, out = str(tmp_path / 'in.jsonl'), str(tmp_path / 'out.jsonl')
    with open(inp, 'w', encoding='utf-8') as f:
        for i, p in enumerate(PROMPTS):
            f.write(json.dumps({'id': i, 'prompt': p}) + '\n')
    args = argparse.Namespace(
        input=inp, output=out, mode='generate', model=None,
        hf_dir=chat_dir[0], tokenizer=None, mesh={}, batch_size=2,
        max_len=128, max_new_tokens=4, temperature=0.0, top_k=None,
        top_p=None, seed=0, pool='mean', num_workers=1, worker_id=0,
        device='cpu')
    runner = batch_infer.BatchRunner(hf_dir=chat_dir[0], device='cpu')
    assert [runner.tokenizer.encode(p) for p in PROMPTS] == chat_dir[1]
    assert EOS in runner.tokenizer.eos_ids
    assert batch_infer.run(args)['ran'] == len(PROMPTS)
    with open(out, encoding='utf-8') as f:
        recs = [json.loads(line) for line in f]
    assert sorted(r['id'] for r in recs) == list(range(len(PROMPTS)))


def test_lora_merge_carries_the_tokenizer(chat_dir, blocked, tmp_path):
    """lora_merge copies tokenizer.json with the merged weights, and the
    merged directory's tokenizer reads as the fixture does."""
    _, base = hf_import.load_hf_checkpoint(chat_dir[0])
    lcfg = lora.LoRAConfig(rank=2)
    ad = lora.init_adapters(torch.Generator().manual_seed(1), base, lcfg)
    tx = train_lib.default_optimizer()
    lora.save_adapters(str(tmp_path / 'ad'), lora.LoRAState(
        step=1, adapters=ad, opt_state=tx.init(ad)), lcfg)
    out = str(tmp_path / 'merged')
    lora_merge.main(['--hf-dir', chat_dir[0], '--lora-dir',
                     str(tmp_path / 'ad'), '--out', out, '--device', 'cpu'])
    with open(fixtures.LLAMA3, 'rb') as a, \
            open(os.path.join(out, 'tokenizer.json'), 'rb') as b:
        assert a.read() == b.read()
    tok = tokenizer_lib.load_tokenizer(out)
    assert [tok.encode(p) for p in PROMPTS] == chat_dir[1]


def test_trainer_sft_lora_from_the_hf_dir(chat_dir, blocked, tmp_path):
    """The slice's user flow at a tiny size: trainer --hf-dir --sft-data
    --lora-rank (the directory's tokenizer.json, no --tokenizer): finite
    losses and a saved step."""
    hist = trainer.train(trainer.TrainerConfig(
        hf_dir=chat_dir[0], sft_data_path=fixtures.SFT_JSONL, batch_size=4,
        seq_len=32, total_steps=2, warmup_steps=1, log_every=1,
        lora_rank=4, lora_dir=str(tmp_path / 'ad'), device='cpu'))
    assert [r['step'] for r in hist] == [1, 2]
    assert all(np.isfinite(r['loss']) for r in hist)
    assert lora.load_adapters(str(tmp_path / 'ad'))[2] == 2
