"""ctypes bindings for the native IO runtime (native/breakmer_native.cc).

Auto-builds via ``make`` on first import if the shared library is missing
and a toolchain exists; every entry point degrades to None when the
library is unavailable so all callers keep a pure-Python fallback
(io/bam.py, io/fastq.py). pybind11 is not in the image; the ABI is plain
C consumed with ctypes (SURVEY.md §7 environment notes).
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SO = _NATIVE_DIR / "libbreakmer_native.so"

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    _cc = _NATIVE_DIR / "breakmer_native.cc"
    stale = (
        not _SO.exists()
        or (_cc.exists() and _SO.stat().st_mtime < _cc.stat().st_mtime)
    )
    if stale:
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                capture_output=True, timeout=120, check=True,
            )
        except Exception:
            if not _SO.exists():
                return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    u64 = ctypes.c_uint64
    u64p = ctypes.POINTER(u64)
    vp = ctypes.c_void_p
    lib.nat_bgzf_inflate.restype = ctypes.c_int
    lib.nat_bgzf_inflate.argtypes = [
        ctypes.c_char_p, u64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), u64p,
    ]
    lib.nat_free.argtypes = [vp]
    lib.nat_bam_count.restype = ctypes.c_int
    lib.nat_bam_count.argtypes = [ctypes.c_char_p, u64, u64, u64p, u64p, u64p, u64p]
    lib.nat_bam_decode.restype = ctypes.c_int
    lib.nat_bam_decode.argtypes = (
        [ctypes.c_char_p, u64, u64] + [vp] * 16 + [u64] * 4
    )
    lib.nat_sam_count.restype = ctypes.c_int
    lib.nat_sam_count.argtypes = [
        ctypes.c_char_p, u64, u64p, u64p, u64p, u64p,
        vp, u64, u64p, u64p,
    ]
    lib.nat_sam_decode.restype = ctypes.c_int
    lib.nat_sam_decode.argtypes = (
        [ctypes.c_char_p, u64] + [vp] * 16 + [u64] * 4
    )
    lib.nat_fastq_count.restype = ctypes.c_int
    lib.nat_fastq_count.argtypes = [ctypes.c_char_p, u64, u64p, u64p, u64p]
    lib.nat_fastq_decode.restype = ctypes.c_int
    lib.nat_fastq_decode.argtypes = [ctypes.c_char_p, u64] + [vp] * 4 + [u64] * 3
    lib.nat_pack_2bit.restype = ctypes.c_int
    lib.nat_pack_2bit.argtypes = [vp, u64, vp]
    lib.nat_sw_traceback.restype = ctypes.c_int
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    lib.nat_sw_traceback.argtypes = [
        vp, i64, vp, i64, i32, i32, i32, i32, vp, vp,
    ]
    try:
        lib.nat_assemble.restype = ctypes.c_int
        lib.nat_assemble.argtypes = [
            vp, i64, i64, vp, vp, i64, i32, i32, i32, ctypes.c_double,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), u64p,
        ]
    except AttributeError:
        # stale shared library predating nat_assemble; callers fall back
        pass
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def bgzf_inflate(data: bytes) -> Optional[bytes]:
    """Inflate a BGZF/multi-member gzip stream natively; None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_uint64()
    rc = lib.nat_bgzf_inflate(data, len(data), ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.nat_free(out)


def bam_decode_columns(data: bytes, align_off: int) -> Optional[Dict[str, np.ndarray]]:
    """Decode the BAM alignment section into columnar arrays.

    Returns dict with: refid, pos, mapq, flag, next_refid, next_pos, tlen,
    lseq, n_cigar, clip_left, clip_right, ref_span (all [n] int32),
    seq_codes/quals ([n, max_seq] int8), names ([n] bytes view), and
    cigar_ops ([n, max_cigar] uint32 raw). None if native unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_uint64()
    mname = ctypes.c_uint64()
    mseq = ctypes.c_uint64()
    mcig = ctypes.c_uint64()
    rc = lib.nat_bam_count(
        data, len(data), align_off,
        ctypes.byref(n), ctypes.byref(mname), ctypes.byref(mseq), ctypes.byref(mcig),
    )
    if rc != 0:
        return None
    N, MN, MS, MC = n.value, mname.value, mseq.value, mcig.value
    if N == 0:
        return {"n": 0}
    cols = {
        name: np.zeros(N, dtype=np.int32)
        for name in (
            "refid", "pos", "mapq", "flag", "next_refid", "next_pos",
            "tlen", "lseq", "n_cigar", "clip_left", "clip_right", "ref_span",
        )
    }
    seq_codes = np.zeros((N, MS), dtype=np.int8)
    quals = np.zeros((N, MS), dtype=np.int8)
    names = np.zeros((N, MN), dtype=np.uint8)
    cigar_ops = np.zeros((N, MC), dtype=np.uint32)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.nat_bam_decode(
        data, len(data), align_off,
        p(cols["refid"]), p(cols["pos"]), p(cols["mapq"]), p(cols["flag"]),
        p(cols["next_refid"]), p(cols["next_pos"]), p(cols["tlen"]),
        p(cols["lseq"]), p(cols["n_cigar"]),
        p(cols["clip_left"]), p(cols["clip_right"]), p(cols["ref_span"]),
        p(seq_codes), p(quals), p(names), p(cigar_ops),
        N, MN, MS, MC,
    )
    if rc != 0:
        return None
    cols.update(
        n=N, seq_codes=seq_codes, quals=quals, names=names,
        cigar_ops=cigar_ops, max_seq=MS, max_name=MN, max_cigar=MC,
    )
    return cols


# initial buffer for the NUL-joined SAM reference-name table; on overflow
# nat_sam_count returns -2 with the required size in ref_len and we retry
# once (module-level so tests can shrink it to exercise the retry)
_SAM_REF_CAP = 1 << 22


def sam_decode_columns(data: bytes):
    """Decode SAM text into the same columnar arrays as
    :func:`bam_decode_columns`, plus the ref-name table (first-appearance
    order over rname/rnext). Returns (cols dict, ref_names list) or None
    when native is unavailable or the text is malformed (callers keep the
    io/sam.py record path as fallback)."""
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_uint64()
    mname = ctypes.c_uint64()
    mseq = ctypes.c_uint64()
    mcig = ctypes.c_uint64()
    ref_cap = _SAM_REF_CAP
    ref_blob = ctypes.create_string_buffer(ref_cap)
    ref_len = ctypes.c_uint64()
    n_refs = ctypes.c_uint64()
    rc = lib.nat_sam_count(
        data, len(data),
        ctypes.byref(n), ctypes.byref(mname), ctypes.byref(mseq),
        ctypes.byref(mcig),
        ref_blob, ref_cap, ctypes.byref(ref_len), ctypes.byref(n_refs),
    )
    if rc == -2 and ref_len.value > ref_cap:
        # ref-name table exceeded the default 4 MiB buffer; nat_sam_count
        # reports the exact size needed in ref_len — retry once sized to it
        ref_cap = int(ref_len.value)
        ref_blob = ctypes.create_string_buffer(ref_cap)
        rc = lib.nat_sam_count(
            data, len(data),
            ctypes.byref(n), ctypes.byref(mname), ctypes.byref(mseq),
            ctypes.byref(mcig),
            ref_blob, ref_cap, ctypes.byref(ref_len), ctypes.byref(n_refs),
        )
    if rc != 0:
        logging.getLogger("breakmer").warning(
            "native SAM columnar decode unavailable (nat_sam_count rc=%d); "
            "falling back to per-line Python parse", rc,
        )
        return None
    ref_names = (
        ref_blob.raw[: ref_len.value].split(b"\x00")[:-1]
        if ref_len.value else []
    )
    ref_names = [r.decode() for r in ref_names]
    N, MN, MS, MC = n.value, mname.value, mseq.value, mcig.value
    if N == 0:
        return {"n": 0}, ref_names
    cols = {
        name: np.zeros(N, dtype=np.int32)
        for name in (
            "refid", "pos", "mapq", "flag", "next_refid", "next_pos",
            "tlen", "lseq", "n_cigar", "clip_left", "clip_right", "ref_span",
        )
    }
    seq_codes = np.zeros((N, MS), dtype=np.int8)
    quals = np.zeros((N, MS), dtype=np.int8)
    names = np.zeros((N, MN), dtype=np.uint8)
    cigar_ops = np.zeros((N, MC), dtype=np.uint32)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.nat_sam_decode(
        data, len(data),
        p(cols["refid"]), p(cols["pos"]), p(cols["mapq"]), p(cols["flag"]),
        p(cols["next_refid"]), p(cols["next_pos"]), p(cols["tlen"]),
        p(cols["lseq"]), p(cols["n_cigar"]),
        p(cols["clip_left"]), p(cols["clip_right"]), p(cols["ref_span"]),
        p(seq_codes), p(quals), p(names), p(cigar_ops),
        N, MN, MS, MC,
    )
    if rc != 0:
        return None
    cols.update(
        n=N, seq_codes=seq_codes, quals=quals, names=names,
        cigar_ops=cigar_ops, max_seq=MS, max_name=MN, max_cigar=MC,
    )
    return cols, ref_names


def fastq_decode(data: bytes) -> Optional[Dict[str, np.ndarray]]:
    """Parse+encode a FASTQ byte buffer natively into packed arrays."""
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_uint64()
    ml = ctypes.c_uint64()
    mn = ctypes.c_uint64()
    if lib.nat_fastq_count(data, len(data), ctypes.byref(n), ctypes.byref(ml), ctypes.byref(mn)) != 0:
        return None
    N, ML, MN = n.value, ml.value, mn.value
    if N == 0:
        return {"n": 0}
    codes = np.zeros((N, ML), dtype=np.int8)
    quals = np.zeros((N, ML), dtype=np.int8)
    lengths = np.zeros(N, dtype=np.int32)
    names = np.zeros((N, MN), dtype=np.uint8)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.nat_fastq_decode(data, len(data), p(codes), p(quals), p(lengths),
                              p(names), N, ML, MN)
    if rc != 0:
        return None
    return {"n": N, "codes": codes, "quals": quals, "lengths": lengths,
            "names": names, "max_len": ML, "max_name": MN}


def pack_2bit(codes: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    out = np.zeros((len(codes) + 15) // 16, dtype=np.uint32)
    lib.nat_pack_2bit(
        codes.ctypes.data_as(ctypes.c_void_p), len(codes),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def assemble_greedy(
    codes: np.ndarray,
    lengths: np.ndarray,
    kmer_values: np.ndarray,
    k: int,
    min_reads: int,
    min_len: int,
    mm_frac: float,
):
    """Native greedy k-mer-extension assembly (assemble/greedy.py fast
    path; the Python implementation stays the semantics oracle and tests
    assert structural equality on randomized fixtures).

    Returns (meta[n,3], reads[nr,2], kmers[nk], cons[int8]) parsed from the
    packed blob, or None when the native library is unavailable or the
    arguments are outside the native path's envelope (k > 16) — callers
    fall back to the oracle.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "nat_assemble"):
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    kv = np.ascontiguousarray(kmer_values, dtype=np.int64)
    R, L = codes.shape
    blob = ctypes.POINTER(ctypes.c_uint8)()
    blen = ctypes.c_uint64()
    rc = lib.nat_assemble(
        codes.ctypes.data_as(ctypes.c_void_p), R, L,
        lengths.ctypes.data_as(ctypes.c_void_p),
        kv.ctypes.data_as(ctypes.c_void_p), len(kv),
        k, min_reads, min_len, float(mm_frac),
        ctypes.byref(blob), ctypes.byref(blen),
    )
    if rc != 0:
        return None
    try:
        raw = ctypes.string_at(blob, blen.value)
    finally:
        lib.nat_free(blob)
    buf = np.frombuffer(raw, dtype=np.uint8)
    nc, nr, nk, ncons = (int(v) for v in buf[:32].view(np.uint64))
    off = 32
    meta = buf[off : off + nc * 24].view(np.int64).reshape(nc, 3)
    off += nc * 24
    reads = buf[off : off + nr * 16].view(np.int64).reshape(nr, 2)
    off += nr * 16
    kmers = buf[off : off + nk * 8].view(np.int64)
    off += nk * 8
    cons = buf[off : off + ncons].view(np.int8)
    return meta, reads, kmers, cons


def sw_traceback(q: np.ndarray, t: np.ndarray, match: int, mismatch: int,
                 gap_open: int, gap_extend: int):
    """Native affine SW fill + traceback (align/traceback.py fast path).

    Returns (score, q_start, q_end, t_start, t_end, matches, mismatches,
    ops_reversed_bytes) or None when unavailable/fallback-required —
    callers keep the numpy oracle path.
    """
    lib = _load()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, dtype=np.int8)
    t = np.ascontiguousarray(t, dtype=np.int8)
    out = np.zeros(8, dtype=np.int32)
    ops = np.zeros(len(q) + len(t) + 2, dtype=np.uint8)
    rc = lib.nat_sw_traceback(
        q.ctypes.data, len(q), t.ctypes.data, len(t),
        match, mismatch, gap_open, gap_extend,
        out.ctypes.data, ops.ctypes.data,
    )
    if rc != 0:
        return None
    n_ops = int(out[7])
    return (
        int(out[0]), int(out[1]), int(out[2]), int(out[3]), int(out[4]),
        int(out[5]), int(out[6]), ops[:n_ops].tobytes(),
    )
