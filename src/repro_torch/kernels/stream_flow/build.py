"""Build and load the CUDA flow-step kernel.

``nvcc`` compiles ``csrc/stream_flow.cu`` for ``sm_90a`` into a shared
library with a plain C interface under ``build/kernels/`` at the root of
the checkout, named by a hash of the source, and :func:`load` opens it with
``ctypes``.  A library already built from the same source is reused; a
failed build raises.  Nothing is built when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "stream_flow.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: What the compiler printed for the last build (register and shared-memory
#: use per kernel, from ``-Xptxas -v``); empty when the library was reused.
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"stream_flow-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless one built from this source exists."""
    global build_log
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {SOURCE.name} failed ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    build_log = proc.stdout + proc.stderr
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.stream_flow_ell_launch.argtypes = [ptr] * 13 + [i32] * 6 + [ptr]
            lib.stream_flow_ell_launch.restype = ctypes.c_int
            lib.stream_flow_ell_smem_bytes.argtypes = [i32, i32]
            lib.stream_flow_ell_smem_bytes.restype = ctypes.c_size_t
            _lib = lib
        return _lib
