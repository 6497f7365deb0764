"""Build and load the port's CUDA sources (``csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, cached under ``build/`` beside
this package by a hash of the source and the flags, and loaded with
``ctypes``.  Importing this module builds nothing; nothing here runs on
the CPU path of the wrappers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
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


class CudaLibrary:
    """One ``csrc`` source, its cached build and its loaded library.

    ``declare(lib)`` sets ``argtypes``/``restype`` of the C functions."""

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None]):
        self.source = os.path.join(CSRC_DIR, source)
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")

    def log_path(self) -> str:
        """The compiler's output (``-Xptxas -v``: registers, spills)."""
        return self.path()[: -len(".so")] + ".log"

    def build(self) -> str:
        """Compile unless a build of this exact source exists; returns the
        library path."""
        path = self.path()
        if os.path.exists(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
            capture_output=True, text=True,
        )
        with open(self.log_path(), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source} "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
        return path

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                self._declare(lib)
                self._lib = lib
            return self._lib
