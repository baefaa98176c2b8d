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

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


def stream_handle(device_index: int) -> int:
    """The ``cudaStream_t`` of the current stream on ``device_index``, as an
    int for a ``ctypes.c_void_p`` argument: PyTorch's raw handle, without
    the Stream object ``torch.cuda.current_stream`` builds on every call
    (``chip_smoke.py``'s rmsnorm_timing reports the host time of both). The
    binding exists in PyTorch's CUDA builds, the only ones that launch."""
    return torch._C._cuda_getCurrentRawStream(device_index)


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
        lib = self._lib  # once loaded, no lock and no lookup: this runs on every launch
        if lib is None:
            with self._lock:
                if self._lib is None:
                    loaded = ctypes.CDLL(str(self.build()))
                    self._bind(loaded)
                    self._lib = loaded
                lib = self._lib
        return lib
