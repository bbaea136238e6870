"""The kernel build's cache key, and the fusion kernel's time split, on the CPU.

A built library is named by a hash of what went into it: the kernel's own
source, every header under csrc/ and the nvcc flags. An edit to any of them
must name a new library, so that a stale one never loads.
"""

import shutil

import pytest

from sdumc_tpu_torch.ops.kernels import build, fused_cross


@pytest.fixture
def package_copy(tmp_path, monkeypatch):
    """A copy of the package's csrc/ that build.library_path reads."""
    shutil.copytree(build.PACKAGE_DIR / "csrc", tmp_path / "csrc")
    monkeypatch.setattr(build, "PACKAGE_DIR", tmp_path)
    return tmp_path / "csrc"


def test_every_kernel_includes_the_shared_header():
    for source in build.SOURCES.values():
        assert '#include "tf32x3.cuh"' in (build.PACKAGE_DIR / source).read_text()


@pytest.mark.parametrize("name", sorted(build.SOURCES))
@pytest.mark.parametrize("edited", ["tf32x3.cuh", "new_header.cuh", "source"])
def test_an_edit_names_a_new_library(package_copy, name, edited):
    before = build.library_path(name)
    path = (build.PACKAGE_DIR / build.SOURCES[name] if edited == "source"
            else package_copy / edited)
    text = path.read_text() if path.exists() else ""
    path.write_text(text + "\n// edited\n")
    after = build.library_path(name)
    assert after != before
    assert after.parent == before.parent and after.name.startswith(f"lib{name}-")


def test_an_unrelated_file_keeps_the_library(package_copy):
    before = {name: build.library_path(name) for name in build.SOURCES}
    (package_copy / "notes.txt").write_text("not a source")
    assert {name: build.library_path(name) for name in build.SOURCES} == before


@pytest.mark.parametrize("B, T, want", [
    (64, 2048, 32),     # the audio bucket: one block per 64-frame tile
    (64, 512, 8),       # the video bucket
    (64, 128, 2),       # the text bucket
    (6, 300, 5),
    (64, 20000, 33),    # capped at 16 blocks per SM in all
    (1000, 64, 1),
])
def test_splits_follow_the_tiles(B, T, want):
    assert fused_cross.splits_for(132, B, T) == want
