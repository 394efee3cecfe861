// bam_ingest — the tumour BAM's whole-file ingest as fixed-width columns.
//
// A sample's BAM is inflated once into a buffer the caller owns (sized
// from the BGZF blocks' ISIZE fields), and every record's fixed-width
// fields are decoded into columns, with the record's offset in that
// buffer. The variable-width fields (sequence codes, qualities, names)
// are decoded only for the rows a caller asks for, from the same buffer.
// Columns and gathered rows equal those of the eager whole-file decode
// (native/breakmer_native.cc, nat_bam_decode) field by field.
//
// A plain C interface consumed with ctypes; host code only, built with the
// host compiler. The gathers only read the buffer, so threads may share it.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

// BREAKMER_NATIVE_THREADS overrides the hardware's count, as in native/.
size_t thread_count() {
  unsigned hw = std::thread::hardware_concurrency();
  if (const char* env = std::getenv("BREAKMER_NATIVE_THREADS")) {
    int v = std::atoi(env);
    if (v > 0) hw = static_cast<unsigned>(v);
  }
  return hw ? hw : 1;
}

// Runs fn(t) on nt threads, t = 0 .. nt - 1; on the calling thread alone
// where nt is 1.
template <class Fn>
void on_threads(size_t nt, Fn fn) {
  if (nt <= 1) {
    fn(size_t(0));
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nt);
  for (size_t t = 0; t < nt; t++) ts.emplace_back([t, &fn]() { fn(t); });
  for (auto& th : ts) th.join();
}

// Runs fn(lo, hi) over [0, n) in contiguous ranges, one a thread; serially
// below `serial_below` items, where starting threads costs more than the work.
template <class Fn>
void parallel_ranges(uint64_t n, uint64_t serial_below, Fn fn) {
  size_t nt = n < serial_below ? 1 : thread_count();
  if (nt > n) nt = n ? n : 1;
  on_threads(nt, [&](size_t t) { fn(n * t / nt, n * (t + 1) / nt); });
}

struct Block {
  uint64_t in_off, in_size, out_off, out_size;
};

// The BGZF members' extents (BC subfield -> BSIZE, ISIZE trailer); false
// where a member is not BGZF-framed.
bool walk_blocks(const uint8_t* in, uint64_t in_len, std::vector<Block>* blocks,
                 uint64_t* total_out) {
  uint64_t off = 0, out_off = 0;
  while (off < in_len) {
    if (off + 18 > in_len) return false;
    if (in[off] != 0x1f || in[off + 1] != 0x8b || in[off + 2] != 8 || !(in[off + 3] & 4))
      return false;
    uint16_t xlen;
    std::memcpy(&xlen, in + off + 10, 2);
    if (off + 12 + xlen > in_len) return false;
    uint64_t bsize = 0;
    for (uint64_t p = off + 12, xend = off + 12 + xlen; p + 4 <= xend;) {
      uint16_t slen;
      std::memcpy(&slen, in + p + 2, 2);
      if (in[p] == 'B' && in[p + 1] == 'C' && slen == 2) {
        uint16_t bs;
        std::memcpy(&bs, in + p + 4, 2);
        bsize = uint64_t(bs) + 1;
      }
      p += 4 + slen;
    }
    if (bsize == 0 || off + bsize > in_len || bsize < 12 + uint64_t(xlen) + 8) return false;
    uint32_t isize;
    std::memcpy(&isize, in + off + bsize - 4, 4);
    if (blocks) blocks->push_back({off, bsize, out_off, isize});
    off += bsize;
    out_off += isize;
  }
  *total_out = out_off;
  return true;
}

// BAM's 4-bit bases (=ACMGRSVTWYHKDBN) -> A C G T as 0-3, any other 4
constexpr int8_t kNibbleCode[16] = {4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4};

// A packed byte's two codes as they lie in memory (the high nibble first),
// so that a byte decodes with one load and one 2-byte store.
struct PairTable {
  uint16_t v[256];
  constexpr PairTable() : v() {
    for (int b = 0; b < 256; b++)
      v[b] = uint16_t(uint8_t(kNibbleCode[b >> 4]) | (uint8_t(kNibbleCode[b & 0xF]) << 8));
  }
};
constexpr PairTable kPairCode;
static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__, "kPairCode's layout is little-endian");

// A record's refID field sits 4 bytes past its block_size field; its
// fixed part is 32 bytes.
inline const uint8_t* record(const uint8_t* data, const int64_t* offset, int64_t row) {
  return data + offset[row];
}

}  // namespace

extern "C" {

// The inflated size of a BGZF stream; -1 where it is not BGZF-framed.
int bi_inflated_size(const uint8_t* in, uint64_t in_len, uint64_t* total) {
  return walk_blocks(in, in_len, nullptr, total) ? 0 : -1;
}

// Inflates a BGZF stream into dst (dst_len bytes, the size above), the
// blocks in parallel at their own offsets. 0 on success.
int bi_inflate(const uint8_t* in, uint64_t in_len, uint8_t* dst, uint64_t dst_len) {
  std::vector<Block> blocks;
  uint64_t total = 0;
  if (!walk_blocks(in, in_len, &blocks, &total)) return -1;
  if (total != dst_len) return -1;
  std::atomic<size_t> next(0);
  std::atomic<int> err(0);
  // one worker a thread, each taking the next block in turn
  size_t nt = thread_count();
  if (nt > blocks.size()) nt = blocks.size() ? blocks.size() : 1;
  on_threads(nt, [&](size_t) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 15 + 16) != Z_OK) {
      err.store(-3);
      return;
    }
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= blocks.size() || err.load()) break;
      const Block& b = blocks[i];
      inflateReset2(&zs, 15 + 16);
      zs.next_in = const_cast<uint8_t*>(in + b.in_off);
      zs.avail_in = static_cast<uInt>(b.in_size);
      uint8_t sink;  // an empty member (the EOF block): zlib needs an output byte
      bool empty = b.out_size == 0;
      zs.next_out = empty ? &sink : dst + b.out_off;
      zs.avail_out = empty ? 1 : static_cast<uInt>(b.out_size);
      int ret = inflate(&zs, Z_FINISH);
      bool exact = empty ? (zs.total_out == 0) : (zs.avail_out == 0);
      if (ret != Z_STREAM_END || !exact) {
        err.store(-2);
        break;
      }
    }
    inflateEnd(&zs);
  });
  return err.load();
}

// Walks the alignment section that starts at align_off: each record's
// refID field's offset into offset[] (room for cap), and into stats[3]
// their count, the longest sequence and the longest name (each at least 1).
// -1 where a record is shorter than its fixed part, its variable fields
// overrun it, or there are more than cap; a record cut by the end of the
// data ends the section.
int bi_index(const uint8_t* data, uint64_t len, uint64_t align_off, uint64_t cap,
             int64_t* offset, uint64_t* stats) {
  uint64_t off = align_off, cnt = 0, ms = 1, mn = 1;
  while (off + 4 <= len) {
    uint32_t block;
    std::memcpy(&block, data + off, 4);
    if (off + 4 + block > len) break;
    if (block < 32 || cnt == cap) return -1;
    const uint8_t* r = data + off + 4;
    uint8_t l_name = r[8];
    uint16_t n_cigar;
    std::memcpy(&n_cigar, r + 12, 2);
    int32_t l_seq;
    std::memcpy(&l_seq, r + 16, 4);
    if (l_seq < 0 ||
        32 + uint64_t(l_name) + 4ull * n_cigar + (uint64_t(l_seq) + 1) / 2 + uint64_t(l_seq) > block)
      return -1;
    if (uint64_t(l_seq) > ms) ms = l_seq;
    if (l_name > mn) mn = l_name;
    offset[cnt++] = int64_t(off + 4);
    off += 4 + block;
  }
  stats[0] = cnt;
  stats[1] = ms;
  stats[2] = mn;
  return 0;
}

// The n indexed records' fixed-width fields into [n] int32 columns: the
// soft clips at either end and the reference span from the CIGAR.
void bi_columns(const uint8_t* data, const int64_t* offset, uint64_t n, int32_t* refid,
                int32_t* pos, int32_t* mapq, int32_t* flag, int32_t* next_refid, int32_t* next_pos,
                int32_t* tlen, int32_t* lseq, int32_t* n_cigar, int32_t* clip_left,
                int32_t* clip_right, int32_t* ref_span) {
  parallel_ranges(n, 4096, [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; i++) {
      const uint8_t* r = data + offset[i];
      int32_t v32;
      uint16_t nc, fl;
      std::memcpy(&v32, r, 4);
      refid[i] = v32;
      std::memcpy(&v32, r + 4, 4);
      pos[i] = v32;
      mapq[i] = r[9];
      std::memcpy(&nc, r + 12, 2);
      std::memcpy(&fl, r + 14, 2);
      flag[i] = fl;
      n_cigar[i] = nc;
      std::memcpy(&v32, r + 16, 4);
      lseq[i] = v32;
      std::memcpy(&v32, r + 20, 4);
      next_refid[i] = v32;
      std::memcpy(&v32, r + 24, 4);
      next_pos[i] = v32;
      std::memcpy(&v32, r + 28, 4);
      tlen[i] = v32;
      const uint8_t* cig = r + 32 + r[8];
      int32_t cl = 0, cr = 0, span = 0;
      for (uint16_t c = 0; c < nc; c++) {
        uint32_t v;
        std::memcpy(&v, cig + 4 * c, 4);
        uint32_t op = v & 0xF, opl = v >> 4;
        if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) span += opl;  // M D N = X
        if (op == 4) {  // S: only a first or a last op is a clip
          if (c == 0)
            cl = opl;
          else if (c == nc - 1)
            cr = opl;
        }
      }
      clip_left[i] = cl;
      clip_right[i] = cr;
      ref_span[i] = span;
    }
  });
}

// The rows' sequence codes and qualities as [n_rows, width] int8 (either
// output may be null): codes A C G T -> 0-3, any other base 4, 4 past the
// read's length; qualities as stored, 40 throughout where the first is
// 0xFF (none stored), -1 past the length. -1 for a row out of range.
int bi_gather_seqs(const uint8_t* data, const int64_t* offset, uint64_t n, const int64_t* rows,
                   uint64_t n_rows, uint64_t width, int8_t* codes, int8_t* quals) {
  for (uint64_t i = 0; i < n_rows; i++) {
    if (rows[i] < 0 || uint64_t(rows[i]) >= n) return -1;
    const uint8_t* r = record(data, offset, rows[i]);
    int32_t ls;
    std::memcpy(&ls, r + 16, 4);
    uint16_t nc;
    std::memcpy(&nc, r + 12, 2);
    const uint8_t* seq = r + 32 + r[8] + 4ull * nc;
    const uint8_t* qual = seq + (ls + 1) / 2;
    uint64_t m = uint64_t(ls) < width ? uint64_t(ls) : width;
    if (codes) {
      int8_t* sc = codes + i * width;
      for (uint64_t b = 0; b + 1 < m; b += 2) std::memcpy(sc + b, &kPairCode.v[seq[b >> 1]], 2);
      if (m & 1) sc[m - 1] = kNibbleCode[seq[m >> 1] >> 4];
      std::memset(sc + m, 4, width - m);
    }
    if (quals) {
      int8_t* qu = quals + i * width;
      if (ls > 0 && qual[0] == 0xFF)
        std::memset(qu, 40, m);
      else
        std::memcpy(qu, qual, m);
      std::memset(qu + m, 0xFF, width - m);  // -1
    }
  }
  return 0;
}

// The rows' names, each ended by a NUL, one after another into out (cap
// bytes); the bytes written, or -1 for a row out of range or a full out.
int64_t bi_gather_names(const uint8_t* data, const int64_t* offset, uint64_t n,
                        const int64_t* rows, uint64_t n_rows, char* out, uint64_t cap) {
  uint64_t w = 0;
  for (uint64_t i = 0; i < n_rows; i++) {
    if (rows[i] < 0 || uint64_t(rows[i]) >= n) return -1;
    const uint8_t* r = record(data, offset, rows[i]);
    const char* name = reinterpret_cast<const char*>(r + 32);
    uint64_t l = 0;
    while (l < r[8] && name[l]) l++;
    if (w + l + 1 > cap) return -1;
    std::memcpy(out + w, name, l);
    out[w + l] = 0;
    w += l + 1;
  }
  return int64_t(w);
}

}  // extern "C"
