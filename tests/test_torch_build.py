"""The port's kernel build (miekki_tpu_torch.ops._build): library names
follow the source's content, and a failed nvcc run raises with the
compiler's output instead of falling back to the plain versions."""

import os
from pathlib import Path

import pytest

from miekki_tpu_torch.ops import _build


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "_libs", {})
    return csrc, build


def test_every_source_in_csrc_is_built(fake_tree):
    real = sorted(p.name for p in (Path(_build.__file__).resolve().parents[1]
                                  / "csrc").glob("*.cu"))
    assert real == ["hash_reduce.cu", "hash_windows.cu", "tile_counts_merge.cu"]
    csrc, _ = fake_tree
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    assert sorted(_build.sources()) == ["a", "b"]


def test_library_name_follows_the_source(fake_tree):
    csrc, build = fake_tree
    src = csrc / "k.cu"
    src.write_text("// one\n")
    first = _build.target(src)
    src.write_text("// two\n")
    second = _build.target(src)
    assert first != second
    assert first.parent == second.parent == build
    assert first.name.startswith("k-") and first.suffix == ".so"


def test_failed_build_raises_with_compiler_output(fake_tree, tmp_path, monkeypatch):
    csrc, _ = fake_tree
    (csrc / "broken.cu").write_text("this is not CUDA\n")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'broken.cu(1): error: expected a declaration'\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(bin_dir) + os.pathsep + os.environ.get("PATH", ""))
    with pytest.raises(RuntimeError, match="expected a declaration"):
        _build.library("broken")
    assert not list((tmp_path / "build").glob("*.so"))
