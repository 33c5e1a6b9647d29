"""The port's kernel build (``repro_torch/kernels/build.py``) on a machine
without ``nvcc``: the library's name follows its sources, a library found
ready returns the compiler log kept beside it, and a build that cannot
find ``nvcc`` raises instead of falling back."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A source directory with one kernel and an empty build directory."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a kernel\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    return csrc, out


def test_library_name_follows_the_sources(tree):
    csrc, out = tree
    first = build.library_path()
    assert first.parent == out and first.suffix == ".so"
    assert build.library_path() == first
    (csrc / "a.cu").write_text("// an edited kernel\n")
    assert build.library_path() != first


def test_a_ready_library_returns_its_kept_log(tree):
    _, out = tree
    out.mkdir()
    so = build.library_path()
    so.write_bytes(b"")
    assert build.build() == (so, 0.0, "")
    so.with_suffix(".log").write_text("ptxas info    : Used 128 registers")
    assert build.build() == (so, 0.0, "ptxas info    : Used 128 registers")


def test_build_without_nvcc_raises(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not build.library_path().exists()
