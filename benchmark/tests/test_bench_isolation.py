"""Nothing the harness or the reference imports is JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
import subprocess
import sys

import pytest

import tiny

BENCH = tiny.ROOT / "benchmark"
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "miekki_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN
    if "reference" in path.parts:
        assert "miekki_tpu_torch" not in tops and "benchmark" not in tops


def test_run_loads_no_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'miekki_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(BENCH / 'tests')!r})\n"
        "import tiny\n"
        "from benchmark import harness\n"
        "res = [tiny.run(c, seconds=0.01) for c in tiny.CELLS]\n"
        "assert all(r['correct'] for r in res)\n"
        "for m in ('jax', 'jaxlib', 'flax', 'miekki_tpu'):\n"
        "    del sys.modules[m]\n"
        "assert harness.forbidden_modules() == [], harness.forbidden_modules()\n"
        "ref = [m for m in sys.modules if m.startswith('benchmark.reference')]\n"
        "print('ok', len(ref))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr[-3000:]


def test_reference_alone_loads_nothing_of_the_port():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(tiny.ROOT)!r})\n"
        "import benchmark.reference.compare, benchmark.reference.nthash\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'miekki_tpu', 'miekki_tpu_torch')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr[-3000:]
