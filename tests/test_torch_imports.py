"""Import hygiene of the PyTorch port: skypilot_tpu_torch and
chip_smoke.py import neither jax nor the JAX package (skypilot_tpu), and
the engine runs on the card unless asked for the CPU."""
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
    return sorted(PORT.rglob('*.py')) + [ROOT / 'chip_smoke.py']


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


def test_every_port_module_imports_with_jax_blocked():
    """Each module imports in a fresh interpreter where importing jax or
    skypilot_tpu fails."""
    mods = sorted(
        '.'.join(p.relative_to(ROOT).with_suffix('').parts)
        .removesuffix('.__init__') for p in PORT.rglob('*.py'))
    code = (
        'import sys, importlib\n'
        "for m in ('jax', 'jaxlib', 'skypilot_tpu'):\n"
        '    sys.modules[m] = None\n'
        f'for m in {mods!r} + ["chip_smoke"]:\n'
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
