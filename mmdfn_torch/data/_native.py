"""The native batch packer (``data/native/packer.cpp``), the counterpart of
``mmdfn_tpu/data/_native.py``: built with ``g++`` at first use into the
package's ``build/`` directory (beside the CUDA kernels) and loaded with
ctypes.

:func:`pack_f32` and :func:`pack_masks_labels` give the bytes that
``data/batching.py``'s numpy path gives (``_pack``, and ``collate``'s mask
and labels), or None where no library can be built (no ``g++``).  The
numpy path packs every batch: PERF.md §6 has the two timed side by side
on the card's host.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from mmdfn_torch.ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "native" / "packer.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    """The library, built first if missing or older than its source; None
    without ``g++``.  A failed build raises."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        gxx = shutil.which("g++")
        if gxx is None:
            return None
        so = BUILD_DIR / "libpacker.so"
        if not so.exists() or so.stat().st_mtime < SRC.stat().st_mtime:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".so.{threading.get_native_id()}.tmp")
            subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                           check=True, capture_output=True)
            tmp.replace(so)
        lib = ctypes.CDLL(str(so))
        p, i32 = ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32
        lib.pack_f32.argtypes = [p, ctypes.POINTER(i32), i32, i32, i32, i32,
                                 ctypes.c_void_p]
        lib.pack_masks_labels.argtypes = [p, ctypes.POINTER(i32), i32, i32,
                                          i32, ctypes.c_void_p,
                                          ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _pointers(arrs: List[np.ndarray], B: int, L: int, what: str):
    if len(arrs) > B:
        raise ValueError(f"{what}: {len(arrs)} dialogues exceed batch B={B}")
    for i, a in enumerate(arrs):
        if a.shape[0] > L:
            raise ValueError(f"{what}: dialogue {i} length {a.shape[0]} "
                             f"exceeds bucket L={L}")
    n = len(arrs)
    ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs])
    lens = (ctypes.c_int32 * n)(*[a.shape[0] for a in arrs])
    return ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)), lens, n


def pack_f32(arrs: List[np.ndarray], B: int, L: int, D: int
             ) -> Optional[np.ndarray]:
    """(B, L, D) float32: dialogue i's (len_i, D) rows, zeros elsewhere
    (``batching._pack``'s bytes); None without the library."""
    lib = _load()
    if lib is None:
        return None
    arrs = [np.ascontiguousarray(a, dtype=np.float32) for a in arrs]
    for i, a in enumerate(arrs):
        if a.ndim != 2 or a.shape[1] != D:
            raise ValueError(f"pack_f32: dialogue {i} has shape {a.shape}, "
                             f"expected (len <= {L}, {D})")
    ptrs, lens, n = _pointers(arrs, B, L, "pack_f32")
    out = np.empty((B, L, D), dtype=np.float32)
    lib.pack_f32(ptrs, lens, n, B, L, D, out.ctypes.data)
    return out


def pack_masks_labels(labels: List[np.ndarray], B: int, L: int
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(umask (B, L) float32, label (B, L) int64) as ``batching.collate``
    fills them; None without the library."""
    lib = _load()
    if lib is None:
        return None
    labels = [np.ascontiguousarray(a, dtype=np.int64) for a in labels]
    for i, a in enumerate(labels):
        if a.ndim != 1:
            raise ValueError(f"pack_masks_labels: labels {i} has shape "
                             f"{a.shape}, expected 1-D")
    ptrs, lens, n = _pointers(labels, B, L, "pack_masks_labels")
    umask = np.empty((B, L), dtype=np.float32)
    label = np.empty((B, L), dtype=np.int64)
    lib.pack_masks_labels(ptrs, lens, n, B, L, umask.ctypes.data,
                          label.ctypes.data)
    return umask, label
