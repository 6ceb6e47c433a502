"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package
(compared by whole top-level module names, so hiprfish_tpu_torch passes),
and the plain reference imports nothing of hiprfish_tpu_torch."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "hiprfish_tpu"}


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_a_forbidden_top_level_name():
    for path in BENCH.rglob("*.py"):
        assert not (_imported(path) & FORBIDDEN), path


def test_reference_sources_import_nothing_of_the_port():
    ref = list((BENCH / "plainref").glob("*.py")) + \
        list((BENCH / "configs").glob("*.py")) + \
        [BENCH / "programs" / "control.py"] + \
        [BENCH / n for n in ("compare.py", "scenes.py", "kernel_work.py")]
    for path in ref:
        assert "hiprfish_tpu_torch" not in _imported(path), path


BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
"""


def _python(code: str, blocked) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", BLOCK.replace("BLOCKED", repr(set(blocked)))
         + code],
        cwd=BENCH, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": f"{BENCH}:{REPO}", "PATH": "/usr/bin:/bin"})


def test_reference_runs_with_the_port_and_jax_blocked():
    code = """
import glob, importlib.util
import compare, scenes, kernel_work
from plainref import classify, cells, precision, segstats, denoise
for p in glob.glob('configs/*.py'):
    spec = importlib.util.spec_from_file_location('r', p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print('ok')
"""
    proc = _python(code, FORBIDDEN | {"hiprfish_tpu_torch"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_harness_and_programs_load_no_forbidden_module():
    code = """
import glob, json, sys, importlib, importlib.util
import tracing, run
for p in glob.glob('programs/*.py') + glob.glob('e2e/*.py') \\
        + glob.glob('metrics/*.py'):
    spec = importlib.util.spec_from_file_location('m', p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
for p in ('ms7b-fov2000', 'ec10b-fov2000'):
    cfg = json.load(open('configs/%s.json' % p))
    mod, fn = cfg['entry'].split(':')
    importlib.import_module(mod)
from hiprfish_tpu_torch.kernels import _build
print(sorted({m.split('.')[0] for m in sys.modules} & FORBIDDEN_SET))
""".replace("FORBIDDEN_SET", repr(FORBIDDEN))
    proc = _python(code, FORBIDDEN)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
