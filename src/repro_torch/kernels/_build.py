"""Build and load the port's CUDA kernel libraries.

Each kernel is one ``.cu`` source with a plain C interface.  ``nvcc``
compiles it for ``sm_90a`` into a shared library under ``build/kernels/``
at the root of the checkout, named by a hash of the source and the flags,
and :meth:`KernelLibrary.load` opens it with ``ctypes``.  A library already
built from the same source is reused; a failed build raises.  A file lock
keeps two processes from building the same library at once, and each
build's compiler output is kept beside the library (``<name>.log``).
Nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

from torch.distributed.tensor import DTensor

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def refuse_dtensor(fn: str, *tensors) -> None:
    """Raises ``TypeError`` if any of ``tensors`` is a DTensor.  A kernel
    wrapper hands its tensors' ``data_ptr()`` to the kernel, and a
    DTensor's pointer is not its local shard's: sharded model code calls a
    wrapper on local shards (``local_map``), never on a DTensor."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{fn} takes local tensors, not DTensors: call it on each rank's "
                        "shard through torch.distributed.tensor.experimental.local_map")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")


class KernelLibrary:
    """One ``.cu`` source, built on first use and loaded with ``ctypes``.

    ``bind(lib)`` sets the C signatures (``argtypes``/``restype``) of the
    library's entry points once it is opened.
    """

    def __init__(self, name: str, source: Path, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = Path(source)
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        #: What the compiler printed for this library's build (registers,
        #: shared memory and spills per kernel, from ``-Xptxas -v``); read
        #: back from the kept log when the library was reused.
        self.build_log = ""

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{digest.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the library unless one built from this source exists."""
        out = self.library_path()
        log_path = out.with_suffix(".log")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(out.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not out.is_file():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"building {self.source.name} failed ({proc.returncode}):\n"
                        f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                    )
                log_path.write_text(proc.stdout + proc.stderr)
                os.replace(tmp, out)
        self.build_log = log_path.read_text() if log_path.is_file() else ""
        return out

    def load(self) -> ctypes.CDLL:
        """The library, built on first use, with its C signatures set."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
            return self._lib
