"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/lib<name>.so`` inside the package, at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
         -Xptxas -v

A build failure raises; nothing falls back.  ``build_all`` starts one nvcc
per source at once, so a cold start pays for the slowest file only.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
KERNELS = ("bigru_fwd", "bigru_bwd", "gcnii_fwd", "gcnii_bwd")
# -Xptxas -v: each kernel's registers, stack and spill bytes, in the output
# build_all returns
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_fns: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """No library yet, or one older than its source or a shared header."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every stale kernel source, one nvcc process per source;
    returns each build's nvcc output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in names:
        if _stale(n):
            tmp = BUILD_DIR / f"lib{n}.so.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    errors, outputs = [], {}
    for n, (tmp, proc) in procs.items():
        outputs[n], _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{outputs[n]}")
        else:
            os.replace(tmp, _lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return outputs


def load(lib: str, entry: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``entry`` of ``lib<lib>.so`` (built first if missing
    or stale), declared to take ``argtypes`` and return an int."""
    fn = _fns.get((lib, entry))
    if fn is None:
        if _stale(lib):
            build_all([lib])
        fn = getattr(ctypes.CDLL(str(_lib_path(lib))), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _fns[(lib, entry)] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
