"""Build of the port's CUDA kernels.

``library()`` compiles every ``csrc/*.cu`` with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` a source, all started together, links the
objects into one shared library with a plain C interface, on first use,
and loads it with ctypes. The library lives in
``build/breakmer_tpu_torch/<hash>/`` at the repository root, named by a
hash of the sources and flags, so an edited source builds anew and an
unchanged one is reused. No ``nvcc`` or a failed build raises: there is
no fallback.

``launch`` is the lean launch path of a wrapper that keeps the library's
ctypes function in a module global: the card made current only when it
is not, the current stream's raw handle, and the error string looked up
only when a launch fails; a failed launch raises ``KernelLaunchError``.
``DEVICE_FAULTS`` are the errors that end a run: that one and torch's
error for a fault of the card (``torch.AcceleratorError``, which a
sticky fault such as an illegal address raises at every later call).
The runner's region fault isolation re-raises them instead of recording
a region ``error``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent
BUILD_ROOT = _PKG.parent / "build" / "breakmer_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None


class KernelLaunchError(RuntimeError):
    """A kernel launch that the CUDA runtime refused or that found the card
    in a fault: nothing ran, and on a sticky fault nothing will."""


DEVICE_FAULTS = (KernelLaunchError, torch.AcceleratorError)


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
    its path. Each source compiles in its own ``nvcc`` process, all at
    once; the compilers' output (with ptxas register and shared memory
    use) is kept beside the library in ``build.log``."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [out.parent / f"{src.stem}.{tag}.o" for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
    tmp = out.with_name(f"{out.name}.{tag}")
    if all(rc == 0 for _, _, rc in logs):
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        logs.append((cmd, proc.stdout, proc.returncode))
    for obj in objs:
        obj.unlink(missing_ok=True)
    text = "".join(" ".join(c) + "\n" + o for c, o, _ in logs)
    (out.parent / "build.log").write_text(text)
    if any(rc != 0 for _, _, rc in logs) or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{text}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sw_wavefront_launch.restype = i32
        lib.sw_wavefront_launch.argtypes = [vp, vp] + [i32] * 12 + [vp] * 6
        lib.sw_block_launch.restype = i32
        lib.sw_block_launch.argtypes = [vp, vp] + [i32] * 12 + [vp] * 4
        lib.sw_wavefront_error_string.restype = ctypes.c_char_p
        lib.sw_wavefront_error_string.argtypes = [i32]
        lib.sw_ceiling_probe_launch.restype = i32
        lib.sw_ceiling_probe_launch.argtypes = [vp, vp] + [i32] * 6 + [vp, vp]
        lib.probe_i16_launch.restype = i32
        lib.probe_i16_launch.argtypes = [i32, vp, vp, vp, vp, i32, i32, i32, vp]
        lib.probe_cummax_launch.restype = i32
        lib.probe_cummax_launch.argtypes = [vp, vp, i32, i32, i32, i32, vp]
        i64 = ctypes.c_int64
        for name, args in (
                ("kmer_codes", [vp, vp, i64, i32, i32, vp, vp]),
                ("revcomp_kmers", [vp, i64, i64, i32, i32, vp]),
                ("unique_counts_sorted", [vp, i64, i64, vp, vp, vp]),
                ("subtract_sorted", [vp, vp, vp, i64, vp, i64, i64, i64, vp, vp])):
            fn = getattr(lib, f"{name}_launch")
            fn.restype = i32
            fn.argtypes = args + [vp]  # the stream last
        lib.region_kmers_launch.restype = i32
        lib.region_kmers_launch.argtypes = ([vp, vp, i32, i32, vp, vp, i32, vp, vp]
                                            + [i32] * 4 + [vp, i64, vp, i64, i32, vp, vp])
        lib.region_kmers_smem_bytes.restype = i64
        lib.region_kmers_smem_bytes.argtypes = [i64] + [i32] * 5
        lib.region_kmers_scratch_words.restype = i64
        lib.region_kmers_scratch_words.argtypes = [i32] * 5
        lib.region_kmers_max_clusters.restype = i32
        lib.region_kmers_max_clusters.argtypes = [i32, i32]
        _lib = lib
    return _lib


def check_launch(err: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error (a launch the
    runtime refused never runs, and a later synchronize does not say so)."""
    if err != 0:
        msg = library().sw_wavefront_error_string(err).decode()
        raise KernelLaunchError(f"{what} launch failed: {msg}")


def launch(fn, index: int, what, *args) -> None:
    """``fn(*args, stream)`` on card ``index``, with ``stream`` the raw
    handle of its current stream (no ``Stream`` object is built); the card
    is made current only when it is not already. Raises
    ``KernelLaunchError`` when ``fn`` returns a CUDA error; ``what`` names
    the launch: a string, or a function that returns one, called only
    then. The current card is read without ``torch.cuda.current_device``'s
    lazy-init check: a tensor on the card means CUDA is up."""
    if index == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        check_launch(err, what() if callable(what) else what)
