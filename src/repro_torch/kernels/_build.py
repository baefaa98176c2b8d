"""Build a CUDA kernel source into a shared library with ``nvcc`` and load it.

Every kernel of the port is one ``.cu`` file with a plain C entry point. It
is compiled at first use into ``build/kernels/`` at the repository root,
keyed by a hash of the source and the flags (a changed source or flag
rebuilds), and bound with ``ctypes``. Nothing here runs at import: the
modules that use it import cleanly on a machine with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


class Library:
    """One kernel source, its ``nvcc`` flags and its ``ctypes`` signatures
    (``bind`` sets them on the loaded library). :meth:`build` compiles if
    this source/flag combination has not been built yet, safely against
    concurrent processes (each compiles to a private temporary and renames
    into place); :meth:`get` loads the library once per process. ``log``
    holds nvcc's output (with ``-Xptxas -v``: registers, shared memory,
    spills)."""

    def __init__(self, name: str, source: Path, flags: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None]):
        self.name, self.source, self.flags, self._bind = name, source, tuple(flags), bind
        self.log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def build(self) -> Path:
        tag = hashlib.sha256(self.source.read_bytes() + " ".join(self.flags).encode()).hexdigest()[:16]
        lib = BUILD_DIR / f"{self.name}_{tag}.so"
        log = lib.with_suffix(".log")
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc(), *self.flags, "-o", str(tmp), str(self.source)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source}:\n{proc.stdout}{proc.stderr}")
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib)
        self.log = log.read_text() if log.exists() else ""
        return lib

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
        return self._lib
