"""On-disk build artifacts: where kernel builds go, and a verified store of them.

The port of ``sudoku_solver_distributed_tpu/compilecache/store.py``. The JAX
package stores serialized XLA executables; this package's compiled
artifacts are shared libraries: the kernel library (csrc/dfs_solver.cu,
built by ``nvcc``) and the native oracle (native/oracle.cc, built by the
host C++ compiler). A process that finds neither pays their build
(~8-10 s of ``nvcc``) before it can serve; one that finds a stored build
made for its own backend loads it instead.

  * ``enable_persistent_cache`` names the process's cache root (first
    wins, as in the JAX package: a root set once is never re-pointed, and
    once a store has placed itself, ``fixed_cache_root``, neither is the
    absence of one).
    Kernel builds then go to ``<root>/kernels`` and the native oracle's to
    ``<root>/native``; without one they go to the package's own
    (gitignored) build directories.
  * ``KernelStore`` keeps builds under explicit keys, each beside a JSON
    record of what built it: the source hash and flags (``meta``), the
    backend fingerprint and the library's sha256. A stored library is only
    valid for the backend that built it: ``backend_fingerprint()`` (torch,
    CUDA, ``nvcc``, GPU, compute capability, driver) is part of the
    artifact's name, so a library built for another backend is a miss that
    leaves that backend's file alone.

Failure policy, the JAX store's: a record that cannot be read, or a
library whose bytes no longer match its record (a truncated or replaced
file), is deleted and counts as an error, and the caller builds anew; a
fingerprint mismatch is a miss (and an error) that deletes nothing.
Saves are atomic: the library and its record are written to temporary
files and published with ``os.replace``, so a crashed writer leaves no
half-artifact and a process that has a library mapped keeps its copy.
A library's file name carries its content hash; the loader opens a
rebuild as a new image even when its bytes, hence its name, are the old
build's (ops/cuda_solver.py ``_dlopen``).
Whether a stored library also SOLVES correctly is the engine's check
(``SolverEngine`` verifies each warm width by a round-trip solve).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import logging
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

# bump when the artifact layout changes: old artifacts just miss
_FORMAT = 1

# the process's cache root (``enable_persistent_cache``): first wins, and
# the first store that takes its place from it (``fixed_cache_root``)
# fixes it, set or not
_PROCESS = {"root": None, "fixed": False}
_PROCESS_LOCK = threading.Lock()


def enable_persistent_cache(cache_dir: str) -> bool:
    """Make ``cache_dir`` the process's cache root: kernel builds go to
    ``<cache_dir>/kernels``, the native oracle's to ``<cache_dir>/native``.

    First wins: when a root is already set, or a store has already taken
    its place without one (its builds go to the package's build
    directories), it is kept and this returns False, with a warning when
    the request differs, so one process never splits its builds between
    two places. Creates the directory; returns True when it took effect."""
    root = os.path.abspath(cache_dir)
    with _PROCESS_LOCK:
        current = _PROCESS["root"]
        if current is not None or _PROCESS["fixed"]:
            if current != root:
                logger.warning(
                    "compile cache already fixed at %s — keeping it, not %s",
                    current or "the package's build directories", root,
                )
            return False
        os.makedirs(root, exist_ok=True)
        _PROCESS["root"] = root
    logger.info("compile cache at %s", root)
    return True


def persistent_cache_dir() -> Optional[str]:
    """The process's cache root, or None when none was enabled."""
    return _PROCESS["root"]


def fixed_cache_root() -> Optional[str]:
    """The process's cache root (None: none), fixed from now on: a store
    places itself by it, so a later ``enable_persistent_cache`` cannot
    re-point builds that already went elsewhere."""
    with _PROCESS_LOCK:
        _PROCESS["fixed"] = True
        return _PROCESS["root"]


def nvcc_path() -> Optional[str]:
    """The CUDA compiler: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else None


@functools.cache
def _nvcc_release() -> str:
    nvcc = nvcc_path()
    if nvcc is None:
        return "none"
    try:
        out = subprocess.run(
            [nvcc, "--version"], capture_output=True, text=True, timeout=60
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return "none"
    m = re.search(r"release ([\d.]+)", out)
    return m.group(1) if m else "unknown"


@functools.cache
def _driver_version() -> str:
    try:
        libcuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return "none"
    version = ctypes.c_int(0)
    if libcuda.cuDriverGetVersion(ctypes.byref(version)) != 0:
        return "none"
    return str(version.value)


def backend_fingerprint() -> str:
    """Identity of the backend a kernel library is built for and runs on:
    a stored library is only trusted on the exact torch version, CUDA
    runtime, ``nvcc`` release, GPU, compute capability and CUDA driver that
    produced it (the role of the JAX store's jax version, platform and
    device kind)."""
    import torch

    if torch.cuda.is_available():
        gpu = torch.cuda.get_device_name(0)
        cap = "%d.%d" % torch.cuda.get_device_capability(0)
    else:
        gpu = cap = "none"
    return (
        f"torch={torch.__version__};cuda={torch.version.cuda};"
        f"nvcc={_nvcc_release()};gpu={gpu};cc={cap};"
        f"driver={_driver_version()};format={_FORMAT}"
    )


def program_key(name: str, spec, bucket: int, config: Dict[str, Any]) -> str:
    """Stable artifact key for one compiled program: the program name,
    board geometry, static batch width, and every solver knob baked into
    the trace (config). Returns a short hex digest used as the artifact
    filename. Equal to the JAX package's for the same inputs."""
    payload = json.dumps(
        {
            "name": name,
            "size": int(spec.size),
            "box": int(spec.box),
            "bucket": int(bucket),
            "config": {k: config[k] for k in sorted(config)},
        },
        sort_keys=True,
        default=str,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:32]


def _tag(fingerprint: str) -> str:
    return hashlib.sha256(fingerprint.encode()).hexdigest()[:12]


def _sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _remove(path: Path) -> None:
    try:
        path.unlink()
    except OSError:
        pass


class KernelStore:
    """Built shared libraries under one directory, keyed and fingerprinted.

    ``get`` returns a stored library for the key and fingerprint, or builds
    one with a caller's ``compile`` callable and saves it. ``loaded``,
    ``saved`` and ``errors`` count as the JAX ``AotStore``'s do. The store
    hands out paths; loading them is the caller's."""

    def __init__(self, root):
        self.root = Path(root)
        self.loaded = 0
        self.saved = 0
        self.errors = 0  # unreadable or mismatched artifacts, failed saves
        self._lock = threading.Lock()

    def _record(self, key: str, fingerprint: str) -> Path:
        return self.root / f"{key}.{_tag(fingerprint)}.json"

    def _drop(self, key: str, fingerprint: str) -> None:
        """Delete the record under (key, fingerprint) and every library
        file of that backend's key."""
        _remove(self._record(key, fingerprint))
        for path in self.root.glob(f"{key}.{_tag(fingerprint)}.*.so"):
            _remove(path)

    def stats(self) -> Dict[str, int]:
        return {
            "loaded": self.loaded,
            "saved": self.saved,
            "errors": self.errors,
        }

    def invalidate(self, key: str, fingerprint: str) -> None:
        """Delete the artifact under (key, fingerprint): it loaded but
        failed its verification, and must not be trusted by the next
        process either. Counts as an error."""
        with self._lock:
            self.errors += 1
        self._drop(key, fingerprint)

    def load(self, key: str, fingerprint: str) -> Optional[Path]:
        """The stored library under ``key`` built for ``fingerprint``, or
        None. A record that cannot be read, or a library that does not
        match its record, is deleted (an error); a record of another
        backend under the same key is a mismatch (an error) and stays."""
        record_path = self._record(key, fingerprint)
        if not record_path.exists():
            others = [
                p for p in self.root.glob(f"{key}.*.json") if p != record_path
            ]
            if others:
                logger.info(
                    "kernel artifact %s: stored for another backend (%s) — "
                    "building for %s", key,
                    ", ".join(p.name for p in others), fingerprint,
                )
                with self._lock:
                    self.errors += 1
            return None
        try:
            record = json.loads(record_path.read_text())
            if record.get("format") != _FORMAT:
                raise ValueError(f"artifact format {record.get('format')!r}")
            lib = self.root / record["so"]
            if _sha256(lib) != record["sha256"]:
                raise ValueError(f"{lib.name} does not match its record")
        except (OSError, ValueError, KeyError, TypeError):
            logger.exception(
                "kernel artifact %s unreadable — deleting, building anew", key
            )
            with self._lock:
                self.errors += 1
            self._drop(key, fingerprint)
            return None
        if record.get("fingerprint") != fingerprint:
            logger.info(
                "kernel artifact %s fingerprint mismatch (%s != %s) — "
                "building anew", key, record.get("fingerprint"), fingerprint,
            )
            with self._lock:
                self.errors += 1
            return None
        with self._lock:
            self.loaded += 1
        return lib

    def save(self, key: str, fingerprint: str,
             compile: Callable[[Path], Optional[str]],
             meta: Optional[Dict[str, Any]] = None) -> Path:
        """Build with ``compile(out)``, which writes the library to ``out``
        and may return its compiler log, then publish it under ``key`` with
        its record. Returns the library's path. Raises what ``compile``
        raises, and ``RuntimeError`` naming ``--compile-cache-dir`` when the
        directory cannot be written. A record that fails to save after a
        good build counts as an error; the library is still returned."""
        try:
            self.root.mkdir(parents=True, exist_ok=True)
            fd, tmp_name = tempfile.mkstemp(
                dir=self.root, prefix=f".{key}.", suffix=".tmp"
            )
        except OSError as e:
            raise RuntimeError(
                f"cannot write the build directory {self.root} ({e}): run "
                f"with --compile-cache-dir DIR (SolverEngine("
                f"compile_cache_dir=DIR), env SUDOKU_COMPILE_CACHE_DIR) to "
                f"build into a writable directory"
            ) from e
        os.close(fd)
        tmp = Path(tmp_name)
        try:
            log = compile(tmp)
            digest = _sha256(tmp)
            lib = self.root / f"{key}.{_tag(fingerprint)}.{digest[:12]}.so"
            os.replace(tmp, lib)
        except BaseException:
            _remove(tmp)
            raise
        record = {
            "format": _FORMAT,
            "fingerprint": fingerprint,
            "so": lib.name,
            "sha256": digest,
            "meta": dict(meta or {}, log=log),
        }
        try:
            fd, rec_tmp = tempfile.mkstemp(
                dir=self.root, prefix=f".{key}.", suffix=".tmp"
            )
            with os.fdopen(fd, "w") as f:
                json.dump(record, f)
            os.replace(rec_tmp, self._record(key, fingerprint))
        except OSError:
            logger.exception("kernel artifact %s: record save failed", key)
            with self._lock:
                self.errors += 1
            return lib
        # older builds of this backend's key: a process that has one mapped
        # keeps its copy (unlink, not truncate)
        for path in self.root.glob(f"{key}.{_tag(fingerprint)}.*.so"):
            if path != lib:
                _remove(path)
        with self._lock:
            self.saved += 1
        return lib

    def get(self, key: str, fingerprint: str,
            compile: Callable[[Path], Optional[str]],
            meta: Optional[Dict[str, Any]] = None) -> Tuple[Path, str]:
        """``(path, source)``: the stored library (``"aot"``) or a new
        build saved under ``key`` (``"compile+save"``)."""
        lib = self.load(key, fingerprint)
        if lib is not None:
            return lib, "aot"
        return self.save(key, fingerprint, compile, meta), "compile+save"

    def log(self, key: str, fingerprint: str) -> Optional[str]:
        """The compiler log kept in the record of (key, fingerprint)."""
        try:
            return json.loads(self._record(key, fingerprint).read_text())[
                "meta"].get("log")
        except (OSError, ValueError, KeyError):
            return None
