"""Import hygiene of the PyTorch port: skypilot_tpu_torch, chip_smoke.py
and kernel_ab.py import neither jax nor the JAX package (skypilot_tpu),
nor any library the card's machine lacks (safetensors, transformers,
aiohttp, tokenizers, regex, ml_dtypes), and the engine runs on
the card unless asked for the CPU."""
import ast
import inspect
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / 'skypilot_tpu_torch'


def _port_files():
    return sorted(PORT.rglob('*.py')) + [ROOT / 'chip_smoke.py',
                                         ROOT / 'kernel_ab.py']


def forbidden(module: str) -> bool:
    """jax, or the JAX package itself: the module skypilot_tpu or a name
    under 'skypilot_tpu.' — never a bare prefix match, which would flag
    skypilot_tpu_torch."""
    return any(module == root or module.startswith(root + '.')
               for root in ('jax', 'jaxlib', 'skypilot_tpu'))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_matches_the_package_not_the_prefix():
    assert forbidden('skypilot_tpu')
    assert forbidden('skypilot_tpu.ops.attention')
    assert forbidden('jax.numpy')
    assert not forbidden('skypilot_tpu_torch')
    assert not forbidden('skypilot_tpu_torch.ops')
    assert not forbidden('jaxtyping_like')


def test_port_sources_import_no_jax_and_no_jax_package():
    files = _port_files()
    assert len(files) > 10
    for name in ('lora', 'lora_merge', 'grpo'):
        assert PORT / 'train' / f'{name}.py' in files
    for path in (('parallel', 'mesh.py'), ('parallel', 'sharding.py'),
                 ('parallel', '__init__.py'), ('ops', 'ring_attention.py'),
                 ('utils', 'backoff.py'), ('utils', 'sqlite_utils.py'),
                 ('analysis', '__init__.py'),
                 ('analysis', 'state_machines.py'),
                 ('serve', 'multihost.py')) + tuple(
            ('train', 'rollout', f'{name}.py') for name in (
                '__init__', '__main__', 'spec', 'telemetry', 'dispatcher',
                'worker', 'learner', 'harness')):
        assert PORT.joinpath(*path) in files
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imports(p) if forbidden(m)]
    assert bad == []


# Libraries the card's machine does not have: never imported by the
# port (tokenizer.json is read by data/tokenizer_json.py; bf16 crosses
# the framed wire as torch.bfloat16, utils/framed.py).
ABSENT_ON_CARD = ('safetensors', 'transformers', 'aiohttp', 'tokenizers',
                  'regex', 'ml_dtypes')


def _absent(module: str) -> bool:
    return any(module == root or module.startswith(root + '.')
               for root in ABSENT_ON_CARD)


def _imports_with_scope(path):
    """(module, names of the enclosing classes and functions) for every
    import in ``path``."""
    def walk(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                for alias in child.names:
                    yield alias.name, scope
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module, scope
            inner = scope
            if isinstance(child, (ast.ClassDef, ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                inner = scope + (child.name,)
            yield from walk(child, inner)
    yield from walk(ast.parse(path.read_text(), str(path)), ())


def test_port_imports_no_library_the_card_lacks():
    """safetensors, transformers, aiohttp, tokenizers, regex and
    ml_dtypes nowhere in the port, at any scope."""
    bad = []
    for p in _port_files():
        for module, scope in _imports_with_scope(p):
            if _absent(module):
                bad.append((str(p.relative_to(ROOT)), module, scope))
    assert bad == []
    assert _absent('regex') and _absent('tokenizers.models')
    assert _absent('ml_dtypes')
    assert not _absent('regexp') and not _absent('tokenizer')


def test_every_port_module_imports_with_jax_blocked():
    """Each module imports in a fresh interpreter where importing jax,
    skypilot_tpu or a library the card lacks fails."""
    mods = sorted(
        '.'.join(p.relative_to(ROOT).with_suffix('').parts)
        .removesuffix('.__init__') for p in PORT.rglob('*.py'))
    code = (
        'import sys, importlib\n'
        "for m in ('jax', 'jaxlib', 'skypilot_tpu', 'safetensors', "
        "'transformers', 'aiohttp', 'tokenizers', 'regex', 'ml_dtypes'):\n"
        '    sys.modules[m] = None\n'
        f'for m in {mods!r} + ["chip_smoke", "kernel_ab"]:\n'
        '    importlib.import_module(m)\n'
        'assert not any(k == "jax" or k.startswith("jax.") for k, v in '
        'sys.modules.items() if v is not None)\n'
        'print("ok", len(sys.modules))\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith('ok')


def test_rollout_roles_default_to_cuda():
    """The rollout plane's worker and learner run on the card unless
    asked for the CPU: their constructors, replay and CLI default to
    cuda (tests/test_torch_rollout.py holds the refusal)."""
    from skypilot_tpu_torch.train.rollout import __main__ as cli
    from skypilot_tpu_torch.train.rollout import harness, learner, worker
    for fn in (worker.RolloutWorker, learner.RolloutLearner,
               learner.replay_losses, harness.run_harvest,
               harness.spawn_worker):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'
    parser = cli.build_parser()
    assert parser.parse_args(['worker', '--dispatcher', 'h:1']).device == \
        'cuda'
    assert parser.parse_args(['learner', '--dispatcher', 'h:1', '--reward',
                              'length', '--snapshot-dir', 'd']).device == \
        'cuda'


def test_engine_defaults_to_cuda_and_refuses_without_a_card(monkeypatch):
    import torch
    from skypilot_tpu_torch.serve import engine as engine_lib
    sig = inspect.signature(engine_lib.InferenceEngine)
    assert sig.parameters['device'].default == 'cuda'
    assert engine_lib.build_parser().parse_args([]).device == 'cuda'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        engine_lib.InferenceEngine('llama-debug')


def test_chip_smoke_refuses_without_a_card_or_the_package(tmp_path):
    """No CUDA device here: non-zero exit and no result line. Alone in a
    directory (no package beside it): non-zero exit too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    env.pop('PYTHONPATH', None)
    out = subprocess.run([sys.executable, str(ROOT / 'chip_smoke.py')],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / 'chip_smoke.py'
    alone.write_text((ROOT / 'chip_smoke.py').read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_kernel_ab_refuses_without_a_card():
    """kernel_ab.py times kernels on the card only: without a CUDA device
    a side's run exits non-zero and prints no times."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    env.pop('PYTHONPATH', None)
    out = subprocess.run([sys.executable, str(ROOT / 'kernel_ab.py'),
                          '--child', str(ROOT)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and 'flash_fwd' not in out.stdout
