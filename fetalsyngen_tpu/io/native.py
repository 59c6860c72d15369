"""ctypes bindings for the native NIfTI loader (C++/zlib/pthreads).

The compute path of this framework is JAX/XLA; the host *runtime* path —
file IO feeding the generator — is native C++ (``native/nifti_loader.cpp``),
mirroring how the reference keeps its hot non-Python pieces in C++/CUDA.
The library is built on first use with the system toolchain (no pybind11),
and rebuilt from the source when a library left from another machine does
not load; if no toolchain can build it the callers fall back to the
pure-Python reader in :mod:`fetalsyngen_tpu.io.nifti`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent / "native"
_LIB_PATH = _DIR / "libnifti_loader.so"
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build() -> bool:
    src = _DIR / "nifti_loader.cpp"
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3",
        "-shared",
        "-fPIC",
        str(src),
        "-lz",
        "-lpthread",
        "-o",
        str(_LIB_PATH),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _open():
    try:
        return ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None


def get_lib():
    """Load (building if needed) the native library, or None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        src = _DIR / "nifti_loader.cpp"
        stale = (
            not _LIB_PATH.exists()
            or _LIB_PATH.stat().st_mtime < src.stat().st_mtime
        )
        lib = None if stale and not _build() else _open()
        if lib is None and not stale and _build():
            # a library built elsewhere (other libc/zlib) — rebuild it here
            lib = _open()
        if lib is None:
            _build_failed = True
            return None
        lib.nifti_load.restype = ctypes.c_int
        lib.nifti_load.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.nifti_load_batch_i32.restype = ctypes.c_int
        lib.nifti_load_batch_i32.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.nifti_save_batch.restype = ctypes.c_int
        lib.nifti_save_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def load_labels_batch(paths: list[str], shape: tuple[int, int, int]):
    """Concurrently decode a batch of int-label NIfTIs.

    Returns a list of n (D, H, W) int32 arrays (Fortran-ordered views), or
    None if the native path is unavailable or any volume mismatches ``shape``
    (callers fall back to the Python reader).
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    stride = int(np.prod(shape))
    out = np.empty((n, stride), dtype=np.int32)
    shapes = np.zeros((n, 3), dtype=np.int64)
    affines = np.zeros((n, 12), dtype=np.float32)

    # ctypes releases the GIL during the foreign call, so a Python thread
    # pool over the single-volume entry point runs the zlib/decode work
    # concurrently in C.
    from concurrent.futures import ThreadPoolExecutor

    def one(i):
        return lib.nifti_load(
            paths[i].encode(),
            None,
            out[i].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            stride,
            shapes[i].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            affines[i].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )

    with ThreadPoolExecutor(max_workers=min(n, 8)) as ex:
        rcs = list(ex.map(one, range(n)))
    if any(rcs) or not (shapes == np.asarray(shape)).all():
        return None
    # NIfTI voxels are Fortran-ordered; return zero-copy Fortran views per
    # volume (layout conversion, if any, happens at device upload).
    return [out[i].reshape(shape, order="F") for i in range(n)]


def save_gz_batch(paths: list[str], headers: list[bytes], datas: list[np.ndarray],
                  level: int = 6) -> bool:
    """Concurrently gzip-write a batch of NIfTI files (header bytes +
    Fortran-ordered voxel payload per file). Returns False if the native
    path is unavailable or any write failed (callers fall back to the
    Python writer)."""
    lib = get_lib()
    if lib is None:
        return False
    n = len(paths)
    datas = [np.asfortranarray(d) for d in datas]
    path_arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    hdr_arr = (ctypes.c_char_p * n)(*headers)
    hsz = (ctypes.c_int64 * n)(*[len(h) for h in headers])
    data_ptrs = (ctypes.c_char_p * n)(
        *[ctypes.cast(d.ctypes.data, ctypes.c_char_p) for d in datas]
    )
    dsz = (ctypes.c_int64 * n)(*[d.nbytes for d in datas])
    rc = lib.nifti_save_batch(path_arr, hdr_arr, hsz, data_ptrs, dsz, n, level)
    return rc == 0
