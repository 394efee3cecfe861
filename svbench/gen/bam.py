"""A small BAM and BAI writer for the generated samples (SAM spec v1.6,
sections 4 and 5), vectorised over records: coordinate-sorted, BGZF
blocks compressed on a few threads, with the index a lab's BAM carries.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Tuple

import numpy as np

from svbench.gen.sample import Reads

BLOCK_U = 0xFF00
EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
_NIBBLE = np.array([1, 2, 4, 8], dtype=np.uint8)  # A C G T
NAME_DIGITS = 10


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    end = end - 1
    out = np.zeros(len(beg), dtype=np.int64)
    done = np.zeros(len(beg), dtype=bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def _bgzf_block(data: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    header = struct.pack("<BBBBIBBHBBHH", 31, 139, 8, 4, 0, 0, 255, 6, 66, 67, 2, len(cdata) + 25)
    return header + cdata + struct.pack("<II", zlib.crc32(data), len(data))


def _record_dtype(name_len: int, n_cig: int, L: int) -> np.dtype:
    fields = [("bs", "<i4"), ("ref", "<i4"), ("pos", "<i4"), ("lrn", "u1"), ("mapq", "u1"),
              ("bin", "<u2"), ("ncig", "<u2"), ("flag", "<u2"), ("lseq", "<i4"), ("nref", "<i4"),
              ("npos", "<i4"), ("tlen", "<i4"), ("name", "u1", (name_len,))]
    if n_cig:
        fields.append(("cig", "<u4", (n_cig,)))
    fields += [("seq", "u1", ((L + 1) // 2,)), ("qual", "u1", (L,))]
    return np.dtype(fields)


def _names(prefix: bytes, frag: np.ndarray) -> np.ndarray:
    digits = (frag[:, None] // (10 ** np.arange(NAME_DIGITS - 1, -1, -1))[None, :]) % 10 + 48
    pre = np.frombuffer(prefix, dtype=np.uint8)[None, :].repeat(len(frag), 0)
    return np.concatenate([pre, digits.astype(np.uint8), np.zeros((len(frag), 1), np.uint8)], axis=1)


def write_bam(path: Path, refs: List[Tuple[str, int]], reads: Reads, name_prefix: str,
              level: int = 1, threads: int = 4, chunk: int = 32768) -> int:
    """Write ``reads`` coordinate-sorted to ``path`` and its index to
    ``path + '.bai'``; returns the number of records."""
    order = np.lexsort((reads.pos, reads.refid))
    n = len(order)
    L = reads.seq.shape[1]
    prefix = name_prefix.encode()
    name_len = len(prefix) + NAME_DIGITS + 1
    sizes = 4 + 32 + name_len + 4 * reads.n_cig[order].astype(np.int64) + (L + 1) // 2 + L
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(f"@SQ\tSN:{c}\tLN:{ln}\n" for c, ln in refs)
    head = bytearray(b"BAM\x01" + struct.pack("<i", len(text)) + text.encode() + struct.pack("<i", len(refs)))
    for c, ln in refs:
        head += struct.pack("<i", len(c) + 1) + c.encode() + b"\x00" + struct.pack("<i", ln)
    rec_start = len(head) + np.concatenate([[0], np.cumsum(sizes)])
    bins = reg2bin(reads.pos[order].astype(np.int64), np.maximum(reads.end[order], reads.pos[order] + 1).astype(np.int64))

    futures, pending = [], bytearray(head)
    with ThreadPoolExecutor(threads) as pool:
        for c0 in range(0, n, chunk):
            idx = order[c0:c0 + chunk]
            sz = sizes[c0:c0 + chunk]
            off = np.concatenate([[0], np.cumsum(sz)])
            buf = np.zeros(int(off[-1]), dtype=np.uint8)
            for g in np.unique(reads.n_cig[idx]):
                sel = np.nonzero(reads.n_cig[idx] == g)[0]
                rows = idx[sel]
                rec = np.zeros(len(rows), dtype=_record_dtype(name_len, int(g), L))
                rec["bs"] = sz[sel] - 4
                rec["ref"], rec["pos"] = reads.refid[rows], reads.pos[rows]
                rec["lrn"], rec["mapq"] = name_len, reads.mapq[rows]
                rec["bin"] = bins[c0 + sel]
                rec["ncig"], rec["flag"], rec["lseq"] = g, reads.flag[rows], L
                rec["nref"], rec["npos"], rec["tlen"] = reads.next_refid[rows], reads.next_pos[rows], reads.tlen[rows]
                rec["name"] = _names(prefix, reads.frag[rows])
                if g:
                    rec["cig"] = (reads.cig_len[rows, :g].astype(np.uint32) << 4) | reads.cig_op[rows, :g]
                nib = _NIBBLE[reads.seq[rows]]
                if L % 2:
                    nib = np.concatenate([nib, np.zeros((len(rows), 1), np.uint8)], axis=1)
                rec["seq"] = (nib[:, 0::2] << 4) | nib[:, 1::2]
                rec["qual"] = reads.qual[rows]
                width = rec.dtype.itemsize
                dest = off[sel][:, None] + np.arange(width)[None, :]
                buf[dest.ravel()] = rec.view(np.uint8).ravel()
            pending += buf.tobytes()
            while len(pending) >= BLOCK_U:
                futures.append(pool.submit(_bgzf_block, bytes(pending[:BLOCK_U]), level))
                del pending[:BLOCK_U]
        if pending:
            futures.append(pool.submit(_bgzf_block, bytes(pending), level))
        blocks = [f.result() for f in futures]
    with open(path, "wb") as fh:
        for b in blocks:
            fh.write(b)
        fh.write(EOF)
    coff = np.concatenate([[0], np.cumsum([len(b) for b in blocks])]).astype(np.uint64)

    def voff(u: np.ndarray) -> np.ndarray:
        return (coff[u // BLOCK_U] << np.uint64(16)) | (u % BLOCK_U).astype(np.uint64)

    _write_bai(Path(str(path) + ".bai"), len(refs), reads.refid[order], reads.pos[order].astype(np.int64),
               np.maximum(reads.end[order], reads.pos[order] + 1).astype(np.int64), bins,
               voff(rec_start[:-1].astype(np.int64)), voff(rec_start[1:].astype(np.int64)))
    return n


def _write_bai(path: Path, n_ref: int, refid, pos, end, bins, vbeg, vend) -> None:
    """Bins with one chunk a run of consecutive records, and the 16 kb
    linear index, gaps filled with the previous window's offset."""
    out = bytearray(b"BAI\x01" + struct.pack("<i", n_ref))
    for r in range(n_ref):
        sel = np.nonzero(refid == r)[0]
        if not len(sel):
            out += struct.pack("<ii", 0, 0)
            continue
        b = bins[sel]
        o = np.lexsort((sel, b))
        bs, ss = b[o], sel[o]
        brk = np.r_[True, (bs[1:] != bs[:-1]) | (ss[1:] != ss[:-1] + 1)]
        starts = np.nonzero(brk)[0]
        ends = np.r_[starts[1:], len(ss)] - 1
        chunk_bin = bs[starts]
        ubins, first = np.unique(chunk_bin, return_index=True)
        out += struct.pack("<i", len(ubins))
        bounds = np.r_[first, len(chunk_bin)]
        for i, ub in enumerate(ubins):
            a, z = bounds[i], bounds[i + 1]
            out += struct.pack("<Ii", int(ub), int(z - a))
            pairs = np.stack([vbeg[ss[starts[a:z]]], vend[ss[ends[a:z]]]], axis=1).astype("<u8")
            out += pairs.tobytes()
        w0, w1 = pos[sel] >> 14, (end[sel] - 1) >> 14
        nw = int(w1.max()) + 1
        lin = np.full(nw, np.iinfo(np.uint64).max, dtype=np.uint64)
        np.minimum.at(lin, w0, vbeg[sel])
        np.minimum.at(lin, w1, vbeg[sel])
        known = lin != np.iinfo(np.uint64).max
        fill = np.maximum.accumulate(np.where(known, np.arange(nw), -1))
        first_known = lin[np.argmax(known)]
        lin = np.where(fill >= 0, lin[np.maximum(fill, 0)], first_known)
        out += struct.pack("<i", nw) + lin.astype("<u8").tobytes()
    path.write_bytes(bytes(out))
