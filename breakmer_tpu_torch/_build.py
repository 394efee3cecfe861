"""Build of the port's CUDA kernels.

``library()`` compiles every ``csrc/*.cu`` with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, on first
use, and loads it with ctypes. The library lives in
``build/breakmer_tpu_torch/<hash>/`` at the repository root, named by a
hash of the sources and flags, so an edited source builds anew and an
unchanged one is reused. No ``nvcc`` or a failed build raises: there is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
BUILD_ROOT = _PKG.parent / "build" / "breakmer_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(cand) if cand.exists() else None
    if found is None:
        raise RuntimeError(
            "nvcc not found (PATH or CUDA_HOME): the CUDA kernels of "
            "breakmer_tpu_torch cannot be built"
        )
    return found


def _sources() -> list:
    return sorted((_PKG / "csrc").glob("*.cu"))


def library_path() -> Path:
    """Path of the built library for the current sources (not built)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libbreakmer_tpu_torch_kernels.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; returns
    its path. The compiler's output (with ptxas register and shared
    memory use) is kept beside it in ``build.log``."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sw_wavefront_launch.restype = i32
        lib.sw_wavefront_launch.argtypes = [vp, vp] + [i32] * 9 + [vp] * 5
        lib.sw_wavefront_smem_bytes.restype = ctypes.c_longlong
        lib.sw_wavefront_smem_bytes.argtypes = [i32, i32]
        lib.sw_wavefront_error_string.restype = ctypes.c_char_p
        lib.sw_wavefront_error_string.argtypes = [i32]
        _lib = lib
    return _lib
