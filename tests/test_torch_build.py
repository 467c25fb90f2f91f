"""The kernel builder of the PyTorch port, driven by a stand-in ``nvcc``
(this machine has none): parallel builds, the cache keyed by the source,
and failures that raise and leave no partial library behind."""

import os
import stat

import pytest

from multimodal_scene_text_recognition_tpu_torch.kernels import build

FAKE_NVCC = """#!/bin/sh
# writes the -o target for grid_sample.cu, bn_backward.cu and
# fused_beam_grid.cu, fails for any other source
for a; do prev=$cur; cur=$a; [ "$prev" = "-o" ] && out=$a; done
case "$cur" in
  *grid_sample.cu|*bn_backward.cu|*fused_beam_grid.cu)
    echo built > "$out"; echo "ptxas info    : Used 24 registers";;
  *) echo "error: no" ; exit 2;;
esac
"""


@pytest.fixture
def fake_cuda(tmp_path, monkeypatch):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return tmp_path / "build"


def test_build_caches_by_source(fake_cuda):
    logs = build.build(["grid_sample"])
    assert "registers" in logs["grid_sample"]
    lib = build.library_path("grid_sample")
    assert lib.parent == fake_cuda and lib.read_text() == "built\n"
    assert build.build(["grid_sample"]) == {"grid_sample": "cached"}


def test_library_key_follows_the_shared_headers(tmp_path, monkeypatch):
    """A library is keyed by its source and the ``.cuh`` headers beside it:
    editing a header gives a new library path, so no stale build is used."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "KERNEL_DIR", tmp_path)
    before = build.library_path("k")
    (tmp_path / "common.cuh").write_text("// two\n")
    assert build.library_path("k") != before


def test_every_source_is_listed_and_builds_in_parallel(fake_cuda):
    """The package's sources are exactly the ``.cu`` files beside the
    build module; three builds started together all land."""
    assert sorted(build.SOURCES) == sorted(p.stem for p in build.KERNEL_DIR.glob("*.cu"))
    assert {"bn_backward", "fused_beam_grid"} <= set(build.SOURCES)
    logs = build.build(["grid_sample", "bn_backward", "fused_beam_grid"])
    assert set(logs) == {"grid_sample", "bn_backward", "fused_beam_grid"}
    assert all(build.library_path(n).read_text() == "built\n" for n in logs)


def test_failed_build_raises_and_leaves_no_partial_output(fake_cuda):
    with pytest.raises(RuntimeError, match="fused_decode: nvcc exited 2"):
        build.build(["fused_decode", "grid_sample"])
    # the other build still completed; nothing half-written remains
    assert sorted(p.name for p in fake_cuda.iterdir()) == [build.library_path("grid_sample").name]


def test_missing_nvcc_is_reported(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["grid_sample"])
    assert not os.path.exists(tmp_path / "build") or not os.listdir(tmp_path / "build")
