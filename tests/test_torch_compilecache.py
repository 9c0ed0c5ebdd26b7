"""The port's compile plane (compilecache/) on the CPU: ``program_key``
equal to the JAX package's, the kernel store's failure policy (the JAX
``AotStore``'s) with a fake build in place of ``nvcc``, where builds go
(first caller wins), the kernel library's build through the store, and the
engine's round-trip verification of a stored library: a failure rebuilds
once and verifies every warm width again, a second failure raises and
stops the library's launches and the node's readiness.
"""

import ctypes
import json
import os
import shutil
import subprocess
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sudoku_solver_distributed_tpu.compilecache import program_key as jax_program_key
from sudoku_solver_distributed_tpu.ops import spec_for_size as jax_spec_for_size
from sudoku_solver_distributed_tpu_torch import engine as engine_mod
from sudoku_solver_distributed_tpu_torch import native
from sudoku_solver_distributed_tpu_torch.compilecache import (
    KernelStore,
    backend_fingerprint,
    enable_persistent_cache,
    persistent_cache_dir,
    program_key,
    store as store_mod,
)
from sudoku_solver_distributed_tpu_torch.engine import (
    LibraryVerificationError,
    SolverEngine,
)
from sudoku_solver_distributed_tpu_torch.net import cli
from sudoku_solver_distributed_tpu_torch.ops import cuda_solver
from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size
from tests.conftest import README_PUZZLE

FP = "torch=x;cuda=y;nvcc=z;gpu=H100;cc=9.0;driver=1;format=1"
OTHER_FP = "torch=x;cuda=y;nvcc=z;gpu=A100;cc=8.0;driver=1;format=1"


@pytest.fixture(autouse=True)
def fresh_process_cache(monkeypatch):
    """Each test starts in a process with no cache root and no store
    decided yet, and an open launch gate, and leaves none behind (both are
    process-wide)."""
    monkeypatch.setitem(store_mod._PROCESS, "root", None)
    monkeypatch.setitem(store_mod._PROCESS, "fixed", False)
    monkeypatch.setitem(cuda_solver._GATE, "error", None)
    monkeypatch.setitem(cuda_solver._GATE, "owner", None)
    cuda_solver.kernel_store.cache_clear()
    native.native_store.cache_clear()
    yield
    cuda_solver.kernel_store.cache_clear()
    native.native_store.cache_clear()


class FakeCompile:
    """A build in place of ``nvcc``: writes ``payload`` and counts runs."""

    def __init__(self, payload=b"\x7fELF fake library"):
        self.payload = payload
        self.runs = 0

    def __call__(self, out):
        self.runs += 1
        out.write_bytes(self.payload)
        return f"fake build #{self.runs}"


@pytest.mark.parametrize(
    "name, size, bucket, config",
    [
        ("solve", 9, 64, {"waves": 3, "locked_candidates": True,
                          "max_depth": (32, 81), "backend": "xla"}),
        ("solve", 16, 1, {}),
        ("segment", 25, 4096, {"naked_pairs": None, "row_format": "v2"}),
        ("dfs_solver", 4, 0, {"source": "abc", "flags": "-O3"}),
    ],
)
def test_program_key_equals_the_jax_package(name, size, bucket, config):
    assert program_key(name, spec_for_size(size), bucket, config) == \
        jax_program_key(name, jax_spec_for_size(size), bucket, config)


def test_store_miss_then_hit(tmp_path):
    build = FakeCompile()
    store = KernelStore(tmp_path)
    path, source = store.get("lib-1", FP, build, meta={"flags": "-O3"})
    assert source == "compile+save" and build.runs == 1
    assert path.read_bytes() == build.payload
    assert store.stats() == {"loaded": 0, "saved": 1, "errors": 0}
    # a second process (a new store object) on the same directory
    again = KernelStore(tmp_path)
    path2, source2 = again.get("lib-1", FP, build)
    assert (path2, source2) == (path, "aot") and build.runs == 1
    assert again.stats() == {"loaded": 1, "saved": 0, "errors": 0}
    assert again.log("lib-1", FP) == "fake build #1"
    record = json.loads(next(tmp_path.glob("lib-1.*.json")).read_text())
    assert record["fingerprint"] == FP and record["meta"]["flags"] == "-O3"


@pytest.mark.parametrize("damage", ["truncate", "record"])
def test_store_deletes_a_corrupt_artifact_and_rebuilds(tmp_path, damage):
    build = FakeCompile()
    path, _ = KernelStore(tmp_path).get("lib-1", FP, build)
    if damage == "truncate":
        os.truncate(path, 3)
    else:
        next(tmp_path.glob("lib-1.*.json")).write_text("{not json")
    store = KernelStore(tmp_path)
    assert store.load("lib-1", FP) is None
    assert store.stats()["errors"] == 1
    assert not list(tmp_path.glob("lib-1.*"))  # record and library deleted
    path2, source = store.get("lib-1", FP, build)
    assert source == "compile+save" and build.runs == 2
    assert path2.read_bytes() == build.payload


def test_store_fingerprint_mismatch_rebuilds_and_keeps_the_other_file(tmp_path):
    theirs = FakeCompile(b"built for another card")
    their_path, _ = KernelStore(tmp_path).get("lib-1", OTHER_FP, theirs)
    ours = FakeCompile()
    store = KernelStore(tmp_path)
    path, source = store.get("lib-1", FP, ours)
    assert source == "compile+save" and ours.runs == 1
    assert store.stats() == {"loaded": 0, "saved": 1, "errors": 1}
    assert their_path.read_bytes() == b"built for another card"
    # each backend now finds its own build
    assert KernelStore(tmp_path).load("lib-1", OTHER_FP) == their_path
    assert KernelStore(tmp_path).load("lib-1", FP) == path


def test_store_invalidate_deletes_and_counts(tmp_path):
    store = KernelStore(tmp_path)
    path, _ = store.get("lib-1", FP, FakeCompile())
    store.invalidate("lib-1", FP)
    assert not path.exists() and not list(tmp_path.glob("lib-1.*"))
    assert store.stats() == {"loaded": 0, "saved": 1, "errors": 1}
    assert store.load("lib-1", FP) is None


def test_store_rebuild_with_new_bytes_is_a_new_file(tmp_path):
    """A changed build gets a new file name (its content hash), so a
    process loads it as a new library; the old file is unlinked."""
    store = KernelStore(tmp_path)
    old, _ = store.get("lib-1", FP, FakeCompile(b"first"))
    store.invalidate("lib-1", FP)
    new, _ = store.get("lib-1", FP, FakeCompile(b"second"))
    assert new != old and not old.exists() and new.read_bytes() == b"second"


def test_store_failed_build_leaves_nothing(tmp_path):
    def broken(out):
        out.write_bytes(b"half")
        raise RuntimeError("nvcc failed")

    store = KernelStore(tmp_path)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        store.get("lib-1", FP, broken)
    assert list(tmp_path.iterdir()) == []
    assert store.stats() == {"loaded": 0, "saved": 0, "errors": 0}


def test_unwritable_build_directory_names_the_flag(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    with pytest.raises(RuntimeError, match="--compile-cache-dir"):
        KernelStore(blocker / "kernels").get("lib-1", FP, FakeCompile())


def test_enable_persistent_cache_first_wins(tmp_path):
    assert persistent_cache_dir() is None
    assert enable_persistent_cache(str(tmp_path / "a")) is True
    assert enable_persistent_cache(str(tmp_path / "b")) is False
    assert persistent_cache_dir() == str(tmp_path / "a")
    assert (tmp_path / "a").is_dir() and not (tmp_path / "b").exists()


def test_a_placed_store_fixes_the_process_cache_root(tmp_path, caplog):
    """One decision per process: once the kernel store has placed itself
    in ``_build/``, a later cache root (an engine's ``compile_cache_dir``)
    is refused with a warning, so the kernels and the native oracle never
    split between two places and the engine reports the store it uses."""
    assert cuda_solver.kernel_store().root == cuda_solver.BUILD_DIR
    with caplog.at_level("WARNING", logger=store_mod.__name__):
        eng = SolverEngine(device="cpu", buckets=(1,), continuous=False,
                           compile_cache_dir=str(tmp_path / "late"))
    try:
        assert "already fixed" in caplog.text
        assert persistent_cache_dir() is None and not (tmp_path / "late").exists()
        assert eng._store is cuda_solver.kernel_store()
        assert native.native_store().root == native._HERE / "_build"
    finally:
        eng.close()


def test_kernel_library_builds_go_where_the_process_cache_says(tmp_path, monkeypatch):
    """Without a cache root the kernel store is ``_build/`` beside the
    package; with one, ``<root>/kernels``: a miss compiles and saves, a
    second process's store loads it without compiling. The store key names
    the source and flags; the fingerprint, the backend."""
    assert cuda_solver.kernel_store().root == cuda_solver.BUILD_DIR
    # a new process: no store placed yet
    cuda_solver.kernel_store.cache_clear()
    store_mod._PROCESS["fixed"] = False
    assert enable_persistent_cache(str(tmp_path))
    store = cuda_solver.kernel_store()
    assert store.root == tmp_path / "kernels"
    build = FakeCompile()
    path, source = cuda_solver.build(compile=build)
    assert source == "compile+save" and path.parent == tmp_path / "kernels"
    assert path.name.startswith(cuda_solver.library_key() + ".")
    assert cuda_solver.build_log() == "fake build #1"
    path2, source2 = cuda_solver.build(KernelStore(tmp_path / "kernels"), compile=build)
    assert (path2, source2) == (path, "aot") and build.runs == 1
    fp = backend_fingerprint()
    assert "gpu=none" in fp and "torch=" in fp and "driver=" in fp


def _rebuild_with(store, build):
    """A fake ``rebuild_library``: the real one's store traffic, with a
    fake build in place of nvcc and no library to load."""
    calls = []

    def rebuild():
        calls.append(1)
        store.invalidate(cuda_solver.library_key(), backend_fingerprint())
        cuda_solver.build(store, compile=build)

    return rebuild, calls


def _fail_round_trips(monkeypatch, width: int, failures: int, seen=None):
    """Make the next ``failures`` warm-up launches at ``width`` come back
    unsolved (status RUNNING), as a library that solves wrong would; count
    every warm-up launch by width in ``seen``."""
    real = SolverEngine._wait_rows
    bad = [failures]

    def wait_rows(self, call):
        rows = real(self, call)
        b = call.boards.shape[0]
        if not call.boards.any():  # a warm-up launch: the empty board
            if seen is not None:
                seen[b] = seen.get(b, 0) + 1
            if bad[0] and b == width:
                bad[0] -= 1
                rows[0, self.spec.cells + 1] = 0  # RUNNING: not solved
        return rows

    monkeypatch.setattr(SolverEngine, "_wait_rows", wait_rows)


@pytest.mark.parametrize("failures", [0, 1, 2])
def test_engine_verifies_each_warm_width_and_rebuilds_once(tmp_path, monkeypatch, failures):
    """Every warm width's warm-up launch is a round trip: the empty board
    must come back SOLVED and valid. One failure invalidates the library,
    rebuilds it once and verifies it again at that width and every width
    verified before; a second failure raises, shuts the launch gate and
    leaves the engine not ready, with no fallback."""
    eng = SolverEngine(device="cpu", buckets=(1, 8), compile_cache_dir=str(tmp_path),
                       continuous=False)
    try:
        store = eng._store
        assert store is cuda_solver.kernel_store()
        assert store.root == tmp_path / "kernels"
        build = FakeCompile()
        cuda_solver.build(store, compile=build)  # the library the process loaded
        rebuild, calls = _rebuild_with(store, build)
        monkeypatch.setattr(engine_mod, "rebuild_library", rebuild)
        seen = {}
        _fail_round_trips(monkeypatch, 8, failures, seen)
        board = torch.as_tensor(np.asarray(README_PUZZLE, np.int32).reshape(1, 81))
        if failures == 2:
            with pytest.raises(LibraryVerificationError, match="twice"):
                eng.warmup()
            # the rebuilt library failed at width 8 again, before width 1 reran
            assert len(calls) == 1 and seen == {1: 1, 8: 2}
            assert not eng.warmed and not eng.ready()
            assert cuda_solver.library_error() is not None
            with pytest.raises(LibraryVerificationError):
                cuda_solver.dfs_solver(board, eng.spec, 81, 100)
            with pytest.raises(LibraryVerificationError):
                eng.warmup()
            return
        eng.warmup()
        info = eng.warm_info()
        assert len(calls) == failures and eng.ready()
        # width 1 ran again on the rebuilt library
        assert seen == {1: 1 + failures, 8: 1 + failures}
        assert info["aot"] == store.stats()
        assert info["aot"] == {"loaded": 0, "saved": 1 + failures, "errors": failures}
        assert info["buckets"]["8"]["source"] == "plain"  # the CPU loads no library
        assert info["buckets"]["1"]["warm"] and info["buckets"]["8"]["warm"]
        assert cuda_solver.library_error() is None
        grid, meta = cuda_solver.dfs_solver(board, eng.spec, 81, 100)
        assert int(meta[0, 0]) == 1
    finally:
        eng.close()


def test_other_threads_launches_raise_during_a_rebuild(tmp_path, monkeypatch):
    """While the warm-up thread rebuilds and verifies the library again,
    any other thread's launch raises instead of running the library that
    just solved wrong; once the rebuilt library passes, launches run."""
    eng = SolverEngine(device="cpu", buckets=(1, 8), continuous=False)
    board = torch.as_tensor(np.asarray(README_PUZZLE, np.int32).reshape(1, 81))
    other = {}

    def rebuild():
        def launch():
            try:
                cuda_solver.dfs_solver(board, eng.spec, 81, 100)
                other["ran"] = True
            except LibraryVerificationError as e:
                other["error"] = str(e)

        t = threading.Thread(target=launch)
        t.start()
        t.join()
        assert not eng.ready()

    try:
        monkeypatch.setattr(engine_mod, "rebuild_library", rebuild)
        _fail_round_trips(monkeypatch, 8, 1)
        eng.warmup()
        assert "being rebuilt" in other["error"] and "ran" not in other
        assert eng.ready() and cuda_solver.library_error() is None
    finally:
        eng.close()


def test_a_failed_rebuild_shuts_the_gate(tmp_path, monkeypatch):
    """A rebuild that cannot build (nvcc fails) is a second failure too."""
    eng = SolverEngine(device="cpu", buckets=(1, 8), continuous=False)

    def rebuild():
        raise RuntimeError("nvcc failed (1) building dfs_solver.cu")

    try:
        monkeypatch.setattr(engine_mod, "rebuild_library", rebuild)
        _fail_round_trips(monkeypatch, 8, 1)
        with pytest.raises(LibraryVerificationError, match="rebuild failed: nvcc"):
            eng.warmup()
        assert not eng.ready() and "nvcc" in str(cuda_solver.library_error())
    finally:
        eng.close()


def test_engine_verifies_the_segment_pool_on_the_segment_kernels(tmp_path, monkeypatch):
    """The pool's warm-up segment is the segment kernels' round trip: the
    empty board injected into one lane must come back solved and valid."""
    eng = SolverEngine(device="cpu", buckets=(1, 8), compile_cache_dir=str(tmp_path))
    try:
        calls = []
        monkeypatch.setattr(engine_mod, "rebuild_library", lambda: calls.append(1))
        real = eng._segment_round_trip
        monkeypatch.setattr(eng, "_segment_round_trip",
                            lambda w, b: (0, None) if not calls else real(w, b))
        eng.warmup()
        assert calls == [1] and eng._pool_warm_width == 8
        status, grid = real(8, torch.zeros((1, 81), dtype=torch.int32))
        assert status == 1 and sorted(np.asarray(grid).reshape(9, 9)[0]) == list(range(1, 10))
    finally:
        eng.close()


def test_engine_without_the_store_reports_no_aot(tmp_path):
    """Without a cache dir, or with ``aot_artifacts=False``, the engine's
    store is the package's ``_build/``: the library is verified all the
    same, and ``warm_info`` has no ``aot`` block, as the JAX engine's
    without its AOT store."""
    for kw in ({}, {"compile_cache_dir": str(tmp_path), "aot_artifacts": False}):
        eng = SolverEngine(device="cpu", buckets=(1,), continuous=False, **kw)
        try:
            eng.warmup()
            info = eng.warm_info()
            assert eng._store.root == cuda_solver.BUILD_DIR
            assert "aot" not in info and eng._store.stats()["saved"] == 0
            assert info["buckets"]["1"]["source"] == "plain"
        finally:
            eng.close()
    assert persistent_cache_dir() is None


C_COUNTER = "static int n; int bump(void) { return ++n; }\n"


@pytest.mark.skipif(shutil.which("cc") is None, reason="needs a C compiler")
def test_a_rebuild_with_the_same_bytes_loads_a_new_image(tmp_path):
    """A deterministic rebuild has the failed build's bytes, so its
    content-hashed name too: the loader would hand back the image it
    already holds for that path. ``_dlopen`` opens a path seen before
    through a private copy, so the rebuild runs as a new image (its
    counter starts again) and no copy is left behind."""
    src = tmp_path / "counter.c"
    src.write_text(C_COUNTER)
    built = tmp_path / "counter.so"
    subprocess.run(["cc", "-shared", "-fPIC", "-o", str(built), str(src)], check=True)
    payload = built.read_bytes()
    store = KernelStore(tmp_path / "kernels")
    build = FakeCompile(payload)
    path, _ = store.get("lib-1", FP, build)
    first = cuda_solver._dlopen(path)
    assert [first.bump(), first.bump()] == [1, 2]
    store.invalidate("lib-1", FP)
    path2, source = store.get("lib-1", FP, build)
    assert path2 == path and source == "compile+save" and build.runs == 2
    # a plain CDLL of the rebuilt path runs the failed image again
    assert ctypes.CDLL(str(path2)).bump() == 3
    rebuilt = cuda_solver._dlopen(path2)
    assert rebuilt.bump() == 1 and first.bump() == 4
    assert sorted(p.name for p in (tmp_path / "kernels").iterdir()) == sorted(
        [path.name, next((tmp_path / "kernels").glob("*.json")).name])


def test_a_node_whose_library_fails_twice_answers_no_solve(tmp_path, monkeypatch):
    """A default CLI node is ready after tier 0 (bucket 1 and the pool);
    width 8 is verified later by the widening. When it fails there twice,
    the node turns not ready (/readyz 503) and /solve answers no board:
    the library that solved wrong launches no more."""
    calls = []
    monkeypatch.setattr(engine_mod, "rebuild_library", lambda: calls.append(1))
    _fail_round_trips(monkeypatch, 8, 2)
    args = cli.build_parser().parse_args(
        ["-p", "0", "-s", "0", "--platform", "cpu", "--buckets", "1,8",
         "--no-autopilot", "--no-answer-cache"])
    node, httpd = cli.build_node(args)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(path, body=None):
        req = urllib.request.Request(base + path, data=body, headers={
            "Content-Type": "application/json"} if body else {})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read() or b"null")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"null")

    try:
        deadline = time.monotonic() + 120
        while cuda_solver.library_error() is None or calls != [1] or node.engine.warmed:
            assert time.monotonic() < deadline, node.engine.warm_info()
            time.sleep(0.02)
        assert "twice" in str(cuda_solver.library_error())
        assert get("/readyz")[0] == 503
        status, body = get("/solve", json.dumps({"sudoku": README_PUZZLE}).encode())
        assert status == 500 and body == {"error": "Internal error"}
        assert not node.engine.warm_info()["fully_warmed"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        node.shutdown()
        node.engine.close()


def test_cli_compile_cache_dir_flag_and_env_default(tmp_path, monkeypatch):
    parser = cli.build_parser()
    assert parser.parse_args([]).compile_cache_dir is None
    monkeypatch.setenv("SUDOKU_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    assert cli.build_parser().parse_args([]).compile_cache_dir == str(tmp_path / "env")
    args = cli.build_parser().parse_args(
        ["-p", "0", "-s", "0", "--platform", "cpu", "--buckets", "1",
         "--no-warmup", "--no-autopilot", "--compile-cache-dir", str(tmp_path / "flag")])
    node, httpd = cli.build_node(args)
    try:
        assert node.engine.compile_cache_dir == str(tmp_path / "flag")
        assert node.engine._store.root == tmp_path / "flag" / "kernels"
        assert persistent_cache_dir() == str(tmp_path / "flag")
    finally:
        httpd.server_close()
        node.shutdown()
        node.engine.close()
