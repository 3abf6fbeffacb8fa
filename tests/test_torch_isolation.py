"""The port stands alone: miekki_tpu_torch and chip_smoke.py import neither
jax nor the JAX package, the package imports with both blocked, and an
entry point asked for CUDA without a card raises instead of running on the
CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "miekki_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    """jax, the JAX package, and the repo's reference tools and test
    fixtures (the port's tools make their own, tools/synth.py)."""
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "miekki_tpu", "tools", "tests", "fixtures")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['miekki_tpu'] = None\n"
        "import miekki_tpu_torch, miekki_tpu_torch.engine, miekki_tpu_torch.cli\n"
        "import miekki_tpu_torch.ops.cuda_hash, miekki_tpu_torch.ops.cuda_intersect\n"
        "import miekki_tpu_torch.ops.cuda_sketch, miekki_tpu_torch.ops.cuda_intersect32\n"
        "import miekki_tpu_torch.parallel, miekki_tpu_torch.parallel.mesh\n"
        "import miekki_tpu_torch.parallel.allvsall, miekki_tpu_torch.parallel.screen\n"
        "import miekki_tpu_torch.tools.multiprocess_ring\n"
        "import miekki_tpu_torch.tools.scale100k, miekki_tpu_torch.tools.acceptance\n"
        "assert miekki_tpu_torch.SketchParams().k == 31\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'miekki_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    from miekki_tpu_torch import cli, engine
    from miekki_tpu_torch.ops import sketch
    from miekki_tpu_torch.params import SketchParams
    from miekki_tpu_torch.tools import acceptance, multiprocess_ring, scale100k

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fasta = tmp_path / "g.fa"
    fasta.write_text(">g\n" + "ACGT" * 100 + "\n")
    with pytest.raises(RuntimeError, match="cuda"):
        engine.build_index([str(fasta)], SketchParams(k=21, s=50))
    with pytest.raises(RuntimeError, match="cuda"):
        sketch.sketch_codes_device(torch.zeros(100, dtype=torch.uint8).numpy(), 21, 50)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["sketch", str(fasta), "-o", str(tmp_path / "db.npz"), "-k", "21"])
    assert not (tmp_path / "db.npz").exists()
    with pytest.raises(RuntimeError, match="cuda"):  # before any rank is spawned
        multiprocess_ring.main(["--ranks", "2", "--out", str(tmp_path / "ring")])
    assert not (tmp_path / "ring").exists()
    with pytest.raises(RuntimeError, match="cuda"):
        scale100k.main(["--out", str(tmp_path / "scale.json")])
    with pytest.raises(RuntimeError, match="cuda"):
        acceptance.main(["--workdir", str(tmp_path / "acc")])
    assert not (tmp_path / "scale.json").exists() and not (tmp_path / "acc").exists()
