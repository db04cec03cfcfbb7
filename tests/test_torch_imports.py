"""Import hygiene of the PyTorch port: skypilot_tpu_torch, chip_smoke.py
and kernel_ab.py import neither jax nor the JAX package (skypilot_tpu),
nor any library the card's machine lacks (safetensors, transformers,
aiohttp; tokenizers only inside ``HFTokenizer``), and the engine runs on
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
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imports(p) if forbidden(m)]
    assert bad == []


# Libraries the card's machine does not have: never imported by the
# port, except tokenizers, inside data/tokenizer.py's HFTokenizer only.
ABSENT_ON_CARD = ('safetensors', 'transformers', 'aiohttp', 'tokenizers')


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
    """safetensors, transformers and aiohttp nowhere in the port;
    tokenizers only inside HFTokenizer (data/tokenizer.py), which raises
    by name without it."""
    bad, allowed = [], []
    for p in _port_files():
        for module, scope in _imports_with_scope(p):
            if not _absent(module):
                continue
            rel = str(p.relative_to(ROOT))
            if module == 'tokenizers' and \
                    rel == 'skypilot_tpu_torch/data/tokenizer.py' and \
                    scope[:1] == ('HFTokenizer',):
                allowed.append((rel, scope))
                continue
            bad.append((rel, module, scope))
    assert bad == []
    assert allowed == [('skypilot_tpu_torch/data/tokenizer.py',
                        ('HFTokenizer', '__init__'))]


def test_every_port_module_imports_with_jax_blocked():
    """Each module imports in a fresh interpreter where importing jax,
    skypilot_tpu or a library the card lacks fails."""
    mods = sorted(
        '.'.join(p.relative_to(ROOT).with_suffix('').parts)
        .removesuffix('.__init__') for p in PORT.rglob('*.py'))
    code = (
        'import sys, importlib\n'
        "for m in ('jax', 'jaxlib', 'skypilot_tpu', 'safetensors', "
        "'transformers', 'aiohttp', 'tokenizers'):\n"
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
