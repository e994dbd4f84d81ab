"""The kernel builder's cache key and source list (``kernels/build.py``),
against a temporary ``csrc/``: a library's name hashes its source, every
shared header ``*.cuh`` and the flags, so an edited header rebuilds the
libraries that may include it; headers are never built on their own.
No nvcc runs here."""
import ctypes

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "common.cuh"\nint a;\n')
    (src / "b.cu").write_text("int b;\n")
    (src / "common.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    return src


@pytest.mark.parametrize("edit", ["header", "source", "new_header",
                                  "renamed_header"])
def test_target_changes_with_sources_and_headers(csrc, edit):
    before = {n: build._target(n) for n in ("a", "b")}
    if edit == "header":
        (csrc / "common.cuh").write_text("#pragma once\nint c;\n")
    elif edit == "source":
        (csrc / "a.cu").write_text("int a2;\n")
    elif edit == "new_header":
        (csrc / "more.cuh").write_text("int m;\n")
    else:
        (csrc / "common.cuh").rename(csrc / "other.cuh")
    after = {n: build._target(n) for n in ("a", "b")}
    assert after["a"] != before["a"]
    # a header edit renames every library; a source edit only its own
    assert (after["b"] != before["b"]) == (edit != "source")
    assert all(p.parent == build.BUILD_DIR for p in after.values())


def test_target_is_stable_and_ignores_other_files(csrc):
    first = build._target("a")
    (csrc / "notes.txt").write_text("not a source\n")
    (csrc / "common.cuh").write_text("#pragma once\n")  # same bytes
    assert build._target("a") == first
    assert first.name.startswith("a-") and first.suffix == ".so"


def test_build_all_takes_every_cu_and_no_header(csrc, monkeypatch):
    started = []

    def fake_start(name):
        started.append(name)
        return build.BUILD_DIR / f"{name}.so", None

    monkeypatch.setattr(build, "_start", fake_start)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_SECONDS", {})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: path)
    secs = build.build_all()
    assert started == ["a", "b"] and set(secs) == {"a", "b"}


def test_shipped_headers_are_hashed():
    """The port's own csrc/ has a shared header, and both flash kernels'
    sources include it."""
    headers = sorted(p.name for p in build.CSRC.glob("*.cuh"))
    assert "sm90_common.cuh" in headers
    for name in ("flash_attention_sm90", "flash_attention_f32_sm90"):
        text = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "sm90_common.cuh"' in text
