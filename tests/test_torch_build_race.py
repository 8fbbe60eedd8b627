"""Concurrent first builds of the port's libraries.

Several threads of one process (as the loader's threads, or test workers
that share a pid across PID namespaces) build the same library into a fresh
build directory at once.  Each compiler call waits at a barrier until all
have written their output, so every builder moves its file into place after
every other has compiled: a temporary name that two builders share loses
one of them its file.  All must return the same complete library and leave
no temporary file behind.
"""

from __future__ import annotations

import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

from dmhomo_torch import native
from dmhomo_torch.ops import build as ops_build

THREADS = 4


def _run_all(fn, n=THREADS):
    with ThreadPoolExecutor(n) as pool:
        futures = [pool.submit(fn) for _ in range(n)]
        return [f.result(timeout=600) for f in futures]


def test_native_build_race(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    barrier = threading.Barrier(THREADS)
    real_run = subprocess.run

    def run_then_wait(*args, **kwargs):
        proc = real_run(*args, **kwargs)
        barrier.wait(timeout=300)
        return proc

    monkeypatch.setattr(native.subprocess, "run", run_then_wait)
    libs = _run_all(native.build)
    assert len(set(libs)) == 1 and libs[0].exists()
    assert sorted(p.name for p in (tmp_path / "native").iterdir()) == [libs[0].name]
    # the library is whole: it loads and computes
    import ctypes

    lib = ctypes.CDLL(str(libs[0]))
    assert hasattr(lib, "homography_flow_f32")


@pytest.mark.parametrize("threads", [2, THREADS])
def test_build_library_race(tmp_path, monkeypatch, threads):
    monkeypatch.setattr(ops_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(ops_build, "nvcc", lambda: "nvcc-stub")
    source = tmp_path / "k.cu"
    source.write_text('#include "k.cuh"\nint k;\n')
    (tmp_path / "k.cuh").write_text("int h;\n")
    barrier = threading.Barrier(threads)

    def fake_nvcc(cmd, **kwargs):
        assert cmd[0] == "nvcc-stub" and "sm_90a" in " ".join(cmd)
        out = Path(cmd[cmd.index("-o") + 1])
        out.write_bytes(b"library of " + source.read_bytes())
        barrier.wait(timeout=60)
        return subprocess.CompletedProcess(cmd, 0, stdout="ptxas info\n", stderr="")

    monkeypatch.setattr(ops_build.subprocess, "run", fake_nvcc)
    libs = _run_all(lambda: ops_build.build_library(source, "k"), threads)
    assert len(set(libs)) == 1
    lib = libs[0]
    assert lib.read_bytes() == b"library of " + source.read_bytes()
    assert lib.with_suffix(".log").read_text() == "ptxas info\n"
    assert sorted(p.name for p in (tmp_path / "kernels").iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])
    # a later call finds it in place and builds nothing
    monkeypatch.setattr(ops_build.subprocess, "run", None)
    assert ops_build.build_library(source, "k") == lib


def test_build_library_failure_leaves_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(ops_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(ops_build, "nvcc", lambda: "nvcc-stub")
    source = tmp_path / "bad.cu"
    source.write_text("not cuda\n")
    monkeypatch.setattr(ops_build.subprocess, "run", lambda cmd, **kw: subprocess.CompletedProcess(
        cmd, 2, stdout="", stderr="error: bad"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ops_build.build_library(source, "bad")
    assert list((tmp_path / "kernels").iterdir()) == []
