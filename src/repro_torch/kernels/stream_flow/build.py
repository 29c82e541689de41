"""Build and load the CUDA flow-step kernel (``csrc/stream_flow.cu``)
through the shared helper :mod:`repro_torch.kernels._build`."""
from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "stream_flow.cu"


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.stream_flow_ell_launch.argtypes = [ptr] * 14 + [i32] * 8 + [ptr]
    lib.stream_flow_ell_launch.restype = ctypes.c_int
    lib.stream_flow_ell_smem_bytes.argtypes = [i32, i32]
    lib.stream_flow_ell_smem_bytes.restype = ctypes.c_size_t
    lib.stream_flow_ell_error_string.argtypes = [i32]
    lib.stream_flow_ell_error_string.restype = ctypes.c_char_p
    lib.container_sum_launch.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
    lib.container_sum_launch.restype = ctypes.c_int
    lib.container_sum_smem_bytes.argtypes = [i32]
    lib.container_sum_smem_bytes.restype = ctypes.c_size_t


LIBRARY = KernelLibrary("stream_flow", SOURCE, _bind)
load = LIBRARY.load
library_path = LIBRARY.library_path


def __getattr__(name: str):
    if name == "build_log":
        return LIBRARY.build_log
    raise AttributeError(name)
