"""Build and load the port's CUDA sources (``csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, cached under ``build/`` beside
this package by a hash of the source, the headers it includes from
``csrc/`` (``#include "name"``) and the flags, and loaded with
``ctypes``.  Importing this module builds nothing; nothing here runs on
the CPU path of the wrappers.

A build is published as the snapshot store publishes a file: the
compiler writes a temp file, which is fsynced, then renamed into place,
then the directory is fsynced.  So a library at the cached path is
whole, and a crash (the ``build:publish`` crash point, between the
fsync and the rename) leaves only a temp file that no load reads.

Processes that build at once (shard workers started on a fresh tree)
take an ``fcntl`` lock on a lock file beside the library around the
check and the compile, so one of them runs the compiler and the others
find its library.  The compiler's log is published the same way as the
library, by temp file and rename, before the library: a library at the
cached path has its whole log beside it.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Callable, Optional

from repro_torch.testing.chaos import chaos_point

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
#: a local include of a source: ``#include "name"``, found beside it
_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CudaLibrary:
    """One ``csrc`` source, its cached build and its loaded library.

    ``declare(lib)`` sets ``argtypes``/``restype`` of the C functions."""

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None]):
        self.source = os.path.join(CSRC_DIR, source)
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def _text(self) -> bytes:
        """The source and, after it, each header it includes from its
        directory, in the order included."""
        with open(self.source, "rb") as f:
            text = f.read()
        parts = [text]
        for name in _LOCAL_INCLUDE.findall(text):
            with open(os.path.join(os.path.dirname(self.source),
                                   name.decode()), "rb") as f:
                parts.append(f.read())
        return b"".join(parts)

    def path(self) -> str:
        digest = hashlib.sha256(self._text()
                                + " ".join(NVCC_FLAGS).encode())
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")

    def log_path(self) -> str:
        """The compiler's output (``-Xptxas -v``: registers, spills)."""
        return self.path()[: -len(".so")] + ".log"

    def build(self) -> str:
        """Compile unless a build of this exact source exists; returns the
        library path.  One process (or thread) at a time checks and
        compiles a source, under an exclusive lock on its lock file."""
        path = self.path()
        if os.path.exists(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(path[: -len(".so")] + ".lock", "a") as lock:
            fcntl.flock(lock.fileno(), fcntl.LOCK_EX)
            try:
                if not os.path.exists(path):  # a holder before us built it
                    self._compile(path)
            finally:
                fcntl.flock(lock.fileno(), fcntl.LOCK_UN)
        return path

    def _compile(self, path: str) -> None:
        tag = f"{os.getpid()}.{threading.get_ident()}.tmp"
        tmp = f"{path}.{tag}"
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
            capture_output=True, text=True,
        )
        log = self.log_path()
        with open(f"{log}.{tag}", "w") as f:
            f.write(proc.stdout + proc.stderr)
            f.flush()
            os.fsync(f.fileno())
        os.replace(f"{log}.{tag}", log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source} "
                               f"({proc.returncode}):\n{proc.stderr}")
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        chaos_point("build:publish")
        os.replace(tmp, path)
        _fsync_dir(BUILD_DIR)

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                self._declare(lib)
                self._lib = lib
            return self._lib
