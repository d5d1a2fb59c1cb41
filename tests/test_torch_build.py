"""The kernel build's cache keys and its refusal to run without nvcc.

Nothing here compiles: ``_target`` only hashes, the build is asked for where
no ``nvcc`` exists, and the other-checkout build of ``compare_builds`` runs a
stand-in compiler that copies its source.
"""

import ctypes
import ctypes.util
import os
import shutil
import sys

import pytest

from heybuddy_tpu_torch.ops.kernels import build, compare_builds


@pytest.fixture()
def csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources that the build reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", str(copy))
    return copy


def test_every_source_is_in_the_tree():
    for name in build.SOURCES:
        assert os.path.exists(os.path.join(build.CSRC, f"{name}.cu")), name


def test_target_names_differ_per_source_and_are_stable():
    targets = [build._target(name)[1] for name in build.SOURCES]
    assert len(set(targets)) == len(targets)
    assert targets == [build._target(name)[1] for name in build.SOURCES]
    assert all(os.path.dirname(t) == build.BUILD_DIR for t in targets)


@pytest.mark.parametrize("header", ["mel_common.cuh", "mel_fft.cuh", "mel_dft.cuh", "trunk_pool.cuh", "mma_sync.cuh",
                                    "hopper.cuh"])
def test_a_changed_header_changes_every_target(csrc, header):
    before = {name: build._target(name)[1] for name in build.SOURCES}
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    after = {name: build._target(name)[1] for name in build.SOURCES}
    assert all(before[name] != after[name] for name in build.SOURCES)


def test_a_changed_source_changes_only_its_target(csrc):
    before = {name: build._target(name)[1] for name in build.SOURCES}
    with open(csrc / "mel_spectrogram.cu", "a") as f:
        f.write("\n// edited\n")
    after = {name: build._target(name)[1] for name in build.SOURCES}
    assert [n for n in build.SOURCES if before[n] != after[n]] == ["mel_spectrogram"]


def test_build_without_nvcc_raises(csrc, tmp_path, monkeypatch):
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present: the build would run")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(build.BuildError, match="nvcc not found"):
        build.build_all(["mel_spectrogram"])


def test_nvcc_command_uses_the_build_flags(monkeypatch):
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    assert build.nvcc_command("k.cu", "libk.so") == ["nvcc", *build.NVCC_FLAGS, "-o", "libk.so", "k.cu"]


def test_library_from_points_launches_at_another_library_and_restores():
    libm = ctypes.util.find_library("m")
    assert libm
    assert "mel_spectrogram" not in build._LIBS
    with build.library_from("mel_spectrogram", libm):
        assert build.library("mel_spectrogram")._name == libm
    assert "mel_spectrogram" not in build._LIBS


@pytest.fixture()
def fake_nvcc(tmp_path, monkeypatch):
    """A compiler that copies the source to the library, and a build dir of its own."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(
        build, "nvcc_command",
        lambda src, out: [sys.executable, "-c", f"import shutil; shutil.copy({src!r}, {out!r})"],
    )


def test_build_other_builds_another_checkouts_sources(tmp_path, fake_nvcc):
    root = tmp_path / "other"
    shutil.copytree(build.CSRC, root / "heybuddy_tpu_torch" / "ops" / "kernels" / "csrc")
    libs = compare_builds.build_other(str(root), compare_builds.KERNELS)
    assert sorted(libs) == sorted(compare_builds.KERNELS)
    for name, path in libs.items():
        with open(path) as built, open(os.path.join(build.CSRC, f"{name}.cu")) as src:
            assert built.read() == src.read()
    assert compare_builds.build_other(str(root), compare_builds.KERNELS) == libs
    with open(root / "heybuddy_tpu_torch" / "ops" / "kernels" / "csrc" / "trunk_pool.cuh", "a") as f:
        f.write("\n// edited\n")
    edited = compare_builds.build_other(str(root), compare_builds.KERNELS)
    assert all(os.path.dirname(edited[n]) != os.path.dirname(libs[n]) for n in libs)
