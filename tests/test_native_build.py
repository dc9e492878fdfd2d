"""The native MAPF library is rebuilt whenever its sources' hash
differs from the one recorded beside it (never trusted by mtime)."""

import os
import shutil

import pytest

from lsc_dr_planner_tpu.mapf import native


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A private copy of native/ with the loader pointed at it."""
    for src in (native._SRC, native._SRC_ECBS):
        shutil.copy(src, tmp_path)
    lib = str(tmp_path / "libmapf.so")
    monkeypatch.setattr(native, "_SRC", str(tmp_path / "mapf.cpp"))
    monkeypatch.setattr(native, "_SRC_ECBS", str(tmp_path / "ecbs.cpp"))
    monkeypatch.setattr(native, "_LIB", lib)
    monkeypatch.setattr(native, "_STAMP", lib + ".sha256")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    return tmp_path


def _srcs():
    return [native._SRC, native._SRC_ECBS]


def test_digest_tracks_source_bytes(tree):
    d0 = native._source_digest(_srcs())
    assert d0 == native._source_digest(_srcs())
    with open(native._SRC, "a") as f:
        f.write("\n// edited\n")
    assert native._source_digest(_srcs()) != d0


@pytest.mark.parametrize("state", ["missing", "stale", "current"])
def test_rebuild_keyed_on_source_hash(tree, monkeypatch, state):
    """A missing library or a stale recorded hash triggers a build, even
    when the library file is newer than the sources; a matching hash
    does not."""
    digest = native._source_digest(_srcs())
    if state != "missing":
        with open(native._LIB, "wb") as f:
            f.write(b"not a library")
        with open(native._STAMP, "w") as f:
            f.write(digest if state == "current" else "0" * 64)
        os.utime(native._LIB, None)  # newer than the sources
    built = []
    monkeypatch.setattr(native, "_build",
                        lambda srcs, d: built.append(d))
    native._load()
    assert built == ([] if state == "current" else [digest])


def test_real_build_records_hash_and_loads(tree):
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    assert native.available()
    with open(native._STAMP) as f:
        assert f.read() == native._source_digest(_srcs())
    assert native.backend_name() == "native"
