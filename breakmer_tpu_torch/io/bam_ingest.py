"""The tumour BAM's whole-file ingest: fixed-width columns over its
inflated stream, and the variable-width fields of the rows a caller asks
for.

``ingest_bam(path)`` inflates the file once into a numpy buffer sized from
its BGZF blocks' ISIZE fields, and decodes every record's fixed-width
fields (the columns of ``native.bam_decode_columns`` without its 2-D ones)
with each record's offset in that buffer. ``BamFields`` keeps the buffer
for the sample's life and decodes sequence codes, qualities and names for
the rows a region keeps, in ``ReadBatch``'s layout. ``DecodedFields``
serves the same questions from columns decoded whole (the SAM text's
``native.sam_decode_columns``), so a consumer asks one accessor whatever
the source.

The routines are ``csrc/bam_ingest.cc``, built with the host's C++
compiler on first use into ``build/breakmer_tpu_torch/<hash>/`` at the
repository root (a hash of the source and flags), and loaded with ctypes.
Without a compiler, or where the build fails, ``available()`` is False and
the caller keeps its other sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np

from breakmer_tpu_torch.io.bam_columns import column_qnames
from breakmer_tpu_torch.utils.logging import get_logger
from breakmer_tpu_torch.utils.meter import METER

log = get_logger("bam_ingest")

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "bam_ingest.cc"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
# the fixed-width columns, each [n] int32, in bi_columns' argument order
FIXED_COLUMNS = ("refid", "pos", "mapq", "flag", "next_refid", "next_pos", "tlen", "lseq",
                 "n_cigar", "clip_left", "clip_right", "ref_span")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def library_path() -> Path:
    """Path of the built library for the current source and flags (not built)."""
    from breakmer_tpu_torch._build import BUILD_ROOT

    h = hashlib.sha256(" ".join(CXX_FLAGS + [platform.machine()]).encode())
    h.update(_SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libbreakmer_tpu_torch_host.so"


def _build(out: Path) -> None:
    """Compile the source into ``out`` (through a temporary name, so that
    processes building at once never load a partial file)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp), "-lz"],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {_SRC.name}:\n{proc.stdout}")
    os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first where needed; None where it cannot
    be built or loaded."""
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    out = library_path()
    try:
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        log.warning("the BAM ingest library is unavailable (%s); "
                    "the sample's BAM is read another way", exc)
        return None
    vp, u64, i64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64
    u64p = ctypes.POINTER(u64)
    lib.bi_inflated_size.restype = ctypes.c_int
    lib.bi_inflated_size.argtypes = [vp, u64, u64p]
    lib.bi_inflate.restype = ctypes.c_int
    lib.bi_inflate.argtypes = [vp, u64, vp, u64]
    lib.bi_index.restype = ctypes.c_int
    lib.bi_index.argtypes = [vp, u64, u64, u64, vp, vp]
    lib.bi_columns.restype = None
    lib.bi_columns.argtypes = [vp, vp, u64] + [vp] * len(FIXED_COLUMNS)
    lib.bi_gather_seqs.restype = ctypes.c_int
    lib.bi_gather_seqs.argtypes = [vp, vp, u64, vp, u64, u64, vp, vp]
    lib.bi_gather_names.restype = i64
    lib.bi_gather_names.argtypes = [vp, vp, u64, vp, u64, vp, u64]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class Rows(NamedTuple):
    """Gathered rows' fields; None where not asked for. ``codes`` and
    ``quals`` are [rows, width] int8 (PAD 4 and -1 past each length)."""

    codes: Optional[np.ndarray]
    quals: Optional[np.ndarray]
    names: Optional[List[str]]


class RowFields:
    """The variable-width fields of a sample's ``n`` records, by row of its
    columns. ``METER.sample_reads`` counts the rows gathered, each once."""

    inflated_bytes = 0  # the inflated stream held, where there is one

    def __init__(self, n: int):
        self._gathered = np.zeros(n, dtype=bool)
        self._lock = threading.Lock()

    def gather(self, rows: np.ndarray, width: int = 0, *, codes: bool = False,
               quals: bool = False, names: bool = False) -> Rows:
        """The rows' sequence codes and qualities at ``width`` columns, and
        their names, as asked. IndexError for a row outside the records."""
        rows = np.ascontiguousarray(rows, dtype=np.int64)
        if len(rows) and (rows.min() < 0 or rows.max() >= len(self._gathered)):
            raise IndexError("a gathered row lies outside the sample's records")
        out = self._gather(rows, int(width), codes, quals, names)
        with self._lock:
            first = np.unique(rows[~self._gathered[rows]])
            self._gathered[first] = True
        METER.add_sample_reads({"rows_gathered": len(first)})
        return out

    def _gather(self, rows, width, codes, quals, names) -> Rows:
        raise NotImplementedError


class DecodedFields(RowFields):
    """Fields decoded whole into 2-D columns (``seq_codes``, ``quals``,
    ``names``), which it takes out of ``cols``."""

    def __init__(self, cols: dict):
        super().__init__(cols["n"])
        self.seq_codes, self.quals, self.names = (cols.pop(k, None)
                                                  for k in ("seq_codes", "quals", "names"))
        cols.pop("cigar_ops", None)

    def _gather(self, rows, width, codes, quals, names) -> Rows:
        return Rows(np.ascontiguousarray(self.seq_codes[rows, :width]) if codes else None,
                    np.ascontiguousarray(self.quals[rows, :width]) if quals else None,
                    column_qnames(self.names[rows]) if names else None)


class BamFields(RowFields):
    """Fields decoded from the inflated stream ``data`` at the records'
    offsets, row by row, on demand. Only reads ``data``: threads may share
    one."""

    def __init__(self, data: np.ndarray, offset: np.ndarray, max_name: int):
        super().__init__(len(offset))
        self.data, self.offset, self.max_name = data, offset, max_name
        self.inflated_bytes = data.nbytes

    def _gather(self, rows, width, codes, quals, names) -> Rows:
        lib, n = _lib, len(self.offset)
        out_codes = np.empty((len(rows), width), np.int8) if codes else None
        out_quals = np.empty((len(rows), width), np.int8) if quals else None
        if codes or quals:
            rc = lib.bi_gather_seqs(self.data.ctypes.data, self.offset.ctypes.data, n,
                                    rows.ctypes.data, len(rows), width, _ptr(out_codes),
                                    _ptr(out_quals))
            if rc:
                raise IndexError("a gathered row lies outside the sample's records")
        out_names = None
        if names:
            blob = np.empty(len(rows) * (self.max_name + 1), np.uint8)
            used = lib.bi_gather_names(self.data.ctypes.data, self.offset.ctypes.data, n,
                                       rows.ctypes.data, len(rows), blob.ctypes.data, len(blob))
            if used < 0:
                raise IndexError("a gathered row lies outside the sample's records")
            out_names = blob[:used].tobytes().decode().split("\x00")[:-1]
        return Rows(out_codes, out_quals, out_names)


def _ptr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data


def ingest_bam(path: str) -> Optional[tuple]:
    """``(cols, ref_names, fields)`` of a BAM: ``cols`` holds ``n``,
    ``max_seq`` and the ``FIXED_COLUMNS``; ``fields`` is a ``BamFields``
    over the inflated stream. None without the library, or where the file
    is not a BGZF-framed BAM that decodes whole (the caller reads it
    another way, which reports what is wrong with it)."""
    lib = _load()
    if lib is None:
        return None
    raw = np.fromfile(path, dtype=np.uint8)
    size = ctypes.c_uint64()
    if lib.bi_inflated_size(raw.ctypes.data, len(raw), ctypes.byref(size)) != 0:
        return None
    data = np.empty(size.value, np.uint8)
    if lib.bi_inflate(raw.ctypes.data, len(raw), data.ctypes.data, len(data)) != 0:
        return None
    del raw
    header = _header(data)
    if header is None:
        return None
    ref_names, align_off = header
    # room for the most records the section can hold (36 bytes each at
    # least); pages past the records' count are never touched, so never
    # resident
    offset = np.empty((len(data) - align_off) // 36 + 1, np.int64)
    stats = np.zeros(3, np.uint64)  # records, the longest sequence, the longest name
    if lib.bi_index(data.ctypes.data, len(data), align_off, len(offset), offset.ctypes.data,
                    stats.ctypes.data) != 0:
        return None
    n, max_seq, max_name = (int(v) for v in stats)
    offset = offset[:n]
    cols = {name: np.empty(n, np.int32) for name in FIXED_COLUMNS}
    lib.bi_columns(data.ctypes.data, offset.ctypes.data, n,
                   *(cols[name].ctypes.data for name in FIXED_COLUMNS))
    cols.update(n=n, max_seq=max_seq)
    return cols, ref_names, BamFields(data, offset, max_name)


def _header(data: np.ndarray) -> Optional[tuple]:
    """(reference names, offset of the first record) from the BAM header
    at the head of the inflated stream; None where it is not one."""
    try:
        if bytes(data[:4]) != b"BAM\x01":
            return None
        off = 8 + struct.unpack_from("<i", data, 4)[0]
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        names = []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", data, off)[0]
            struct.unpack_from("<i", data, off + 4 + l_name)  # its length lies in the data
            names.append(bytes(data[off + 4: off + 3 + l_name]).decode())
            off += 8 + l_name
    except (struct.error, UnicodeDecodeError):
        return None
    return names, off
