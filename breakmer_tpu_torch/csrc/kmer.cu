// The k-mer engine's four device functions, one kernel each, for Hopper
// (sm_90a): k-mer extraction, reverse complement, run-length counting of
// a sorted row, and the set subtraction sample - reference [- normal].
//
// Replaces no Pallas kernel: each one replaces a jitted function of
// breakmer_tpu/ops/kmer.py, which XLA runs as one program a call:
//   kmer_codes_kernel       kmer_codes            breakmer_tpu/ops/kmer.py:43-44
//   revcomp_kmers_kernel    revcomp_kmers         :102-103
//   unique_counts_kernel    unique_counts_sorted  :121-122
//   subtract_sorted_kernel  subtract_sorted       :162-163 (member_sorted :148 fused in)
// The plain versions are breakmer_tpu_torch/ops/kmer.py::*_plain (the
// eager torch ops of the JAX bodies, a few dozen to about a hundred
// launches a function); the wrappers are breakmer_tpu_torch/ops/kmer_cuda.py.
// The sorts between these functions stay torch.sort, as the JAX package
// leaves its sorts to XLA's.
//
// Codes are int64 on the device: a k-mer of k <= 15 bases is a 2k-bit
// code, and an invalid slot holds SENTINEL = 0xFFFFFFFF (as int64, not
// -1), which sorts after every code. Every kernel takes a row [N] or rows
// [G, N] (the batched step's form) and works row by row. k <= 0 is taken
// as the JAX functions take it (they refuse only k > 15 and L < k): a
// window of no base has code 0 and no N, so it is valid where it lies in
// its read, and the reverse complement of any code but SENTINEL is 0.
//
// What bounds them on this card: bytes, and at the serial path's shapes
// the launch. Each does a handful of integer operations a byte it moves
// (no tensor core applies), so its bound is its bytes (each input read
// once, each output written once) over 3.35 TB/s: kmer_codes at the batch
// step's shape (16,384 reads of 128 bases, k = 15) reads 2.1 MB and
// writes 16.8 MB, 5.7 us; subtract_sorted there moves 54.4 MB, 16.2 us. A
// region of the serial path (about 200 reads of 100 bases) moves under
// 200 KB, well under a microsecond, so there a kernel's time is one
// launch; the eager plain version paid dozens.
//
// Design.
// - kmer_codes: a block of 256 threads owns 256 V consecutive windows of
//   the flat [R * W] output (V = 8, or 2 where blocks of 2,048 windows
//   would leave an SM idle: a serial region's shapes), a span and not a
//   row, so that its stores stay aligned where W = L - k + 1 is not (114
//   at the batch shape). It stages the one run of code bytes the span
//   reads (from its first window's first byte to its last window's last)
//   in shared memory with 16-byte loads and, line by line, packs the
//   bytes' two-bit codes (the first byte on top) and a flag a byte in
//   4..127 (N: the window is invalid) with word-wide bit operations. A
//   thread then computes V consecutive windows from 64 bits of packed
//   codes and 32 flag bits read at its first window's first byte (and at
//   the next row's first byte where its windows cross a row end): a
//   shift and a mask a window. Where W < V, or the stage holds a negative
//   byte (no caller passes one), the block takes the rolling path over
//   the staged bytes: k steps at a thread's first window and at a row's,
//   then one shift, or and mask a window, and the direct k-step code in
//   uint32 for a window that holds a negative byte, as the JAX function
//   computes it (the 2k-bit mask drops such a byte's high bits). The
//   codes go back through shared memory (swizzled, so neither side
//   conflicts on banks) and leave as coalesced 16-byte stores (stored
//   straight from a thread's consecutive windows, each 16-byte store of a
//   warp half-fills its sectors, which measured slower). A thread's V
//   validity bytes are one store. At k <= 0 a block stages nothing and
//   takes the rolling path with no byte to roll: a thread reads only its
//   rows' lengths, code 0 where w <= length - k, SENTINEL elsewhere (W = L
//   - k + 1 exceeds L, and L may be 0), at either V. (A branch of its own
//   for k <= 0 cost the staged path ~3 % at a serial region's shape.)
// - revcomp_kmers: constant time a code (bit reversal, a swap of
//   neighbouring bits, a complement, a shift; no loop over k), a block of
//   256 threads owning 256 V codes of a row (V = 8, or 2 where that would
//   leave an SM idle), in coalesced 16-byte loads and stores. Its
//   both-strand form writes a row's codes and then their reverse
//   complements, [G, M] -> [G, 2M], in the same pass: the table the
//   engine sorts, which the eager form built with a second launch (a
//   torch.cat) and a second pass over the codes.
// - unique_counts: a block of 256 threads owns a tile of 2,048 slots of one
//   row, 8 a thread, or, where that would leave an SM idle, a block of 128
//   threads a tile of 256 (a serial region's 17,200 slots in 68 blocks),
//   loaded with coalesced 16-byte loads. A run ends at the next boundary (an index
//   whose value differs from the one before it, or the row's end), which is
//   the JAX function's min(next run start, total valid) on a sorted row
//   whose SENTINEL slots come last. The next boundary after each slot is a
//   reverse min-scan of the tile's boundaries, as the JAX function's
//   associative_scan: within a thread's pair, across the warp by a ballot
//   (the first later lane with a boundary), across the warps and the
//   tile's segments through shared memory, one barrier. Only the run that
//   holds the tile's last slot may end past the tile: the last warp finds
//   its end by one galloping search a tile (32 probes at 2^lane past the
//   tile, loaded with the tile, then rounds of 32 probes that narrow the
//   gap 32-fold), where a search from every run start would be a chain of
//   about 2 log2(run) loads that holds its warp.
// - subtract_sorted: a block of 128 threads owns a tile of 128 V slots of
//   one row (V = 8, or 2 where tiles of 1,024 would leave an SM idle),
//   loaded with coalesced 16-byte (values) and 8-byte (counts) loads, and
//   reduces the min and max of their values that are not SENTINEL (a tile
//   with none writes (SENTINEL, 0) and searches nothing). Its four warps
//   find [lower_bound(min), upper_bound(max)) in that row of the
//   reference and of the normal table, 32 probes a round (3 rounds for
//   30,000 entries, where a thread's own binary search made 15 dependent
//   loads). The block stages the two ranges in shared memory, 1,024
//   entries at a time with coalesced loads, and each thread searches them
//   for its V consecutive slots (exchanged through shared memory): two
//   branchless searches for the part of the range between its own least
//   and greatest value, then its V slots together in that part, so their
//   loads overlap; a "found" flag a slot holds across the chunks. The values out
//   of unique_counts_sorted ascend apart from SENTINEL gaps, so a tile's
//   ranges are a few percent of each table, one chunk holds them, and a
//   thread's part is a few entries wide; min and max, not the first and
//   last value, keep the kernel exact for queries in any order, only
//   slower. A table of width 0 is refused (the plain versions index past
//   its end).
// revcomp_kmers uses no shared memory and no barrier. A kernel never
// writes where it reads, so the outputs are fresh tensors.
//
// On an NVIDIA H100 80GB HBM3 at 700.00 W (device time of queued calls,
// tools/kmer_time.py, this design against the one-thread-an-element one in
// turns; PERF.md, section 6): kmer_codes 9.4-9.5 us at the batch step's
// shape (29.1 before; 60 % of its bound) and 3.6 at a serial region's
// (3.1 before: the stage's barriers at 34 blocks); subtract_sorted
// 31.2-31.3 (84.0; 52 %) and 5.0 (7.7); unique_counts 13.6 at the batch
// step's shape on random reads and 14.1 on tiled errored reads (86 % and
// 83 % of its 11.7 us bound; 14.4 and 22.8 with one search from every run
// start) and 2.8 at a serial region's (3.0); revcomp_kmers' both-strand
// form 2.9-3.0 at the batch step's shape (its bound 0.94) and 2.5 at a
// serial region's (the reverse complement, then a torch.cat: two launches,
// 6.1 and 4.9).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int64_t SENT = 0xFFFFFFFFLL;
constexpr int MAX_K = 15;
constexpr unsigned FULL = 0xFFFFFFFFu;

// kmer_codes_kernel<KMER_THREADS, V> and subtract_sorted_kernel<SUB_THREADS,
// V, PROBES>: V = KMER_V or SUB_V elements a thread, or SMALL_V where that
// leaves the card's SMs without a block each (a serial region's shapes)
constexpr int KMER_THREADS = 256;
constexpr int KMER_V = 8;
constexpr int SUB_THREADS = 128;  // 4 warps for the 4 range searches
constexpr int SUB_V = 8;
constexpr int SMALL_V = 2;
// revcomp_kmers_kernel<RC_THREADS, RC_V or SMALL_V, ...> and
// unique_counts_kernel<UC_THREADS, UC_V, ...> or <UC_SMALL_THREADS, SMALL_V>,
// the latter where the former would leave an SM idle
constexpr int RC_THREADS = 256;
constexpr int RC_V = 8;
constexpr int UC_THREADS = 256;
constexpr int UC_V = 8;
constexpr int UC_SMALL_THREADS = 128;
constexpr int PROBES = 1;            // probes a lane a round of the range search
constexpr int CHUNK_PER_THREAD = 8;  // table entries staged a thread at a time

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) { return a < b ? b : a; }

// The code of the k bytes at s as the JAX function computes it, in uint32:
// a byte >= 4 adds 0, a negative byte its 32-bit two's complement.
__device__ __forceinline__ uint32_t window_code(const int8_t* s, int k) {
  uint32_t acc = 0;
  for (int j = 0; j < k; ++j) {
    const int8_t x = s[j];
    acc = (acc << 2) | (x >= 4 ? 0u : (uint32_t)(int32_t)x);
  }
  return acc;
}

// The place of 16-byte chunk q in shared memory where thread t writes (or
// reads) chunks CPT t .. CPT t + CPT - 1 and reads (or writes) chunks t,
// t + blockDim.x, ...: the XOR puts the chunks of 8 threads of either side
// in 8 distinct 16-byte bank groups.
template <int CPT>
__device__ __forceinline__ int swizzle(int q) {
  return (q & ~(CPT - 1)) | ((q & (CPT - 1)) ^ ((q >> 3) & (CPT - 1)));
}

// e / d, in 32 bits where e fits them (a 64-bit division is a long
// instruction sequence, and three of them stand before the stage's loads)
__device__ __forceinline__ int64_t div_small(int64_t e, int d) {
  return e <= INT_MAX ? (int64_t)((uint32_t)e / (uint32_t)d) : e / d;
}

// The two-bit codes (x & 3) of 16 bytes, the first byte in the top two
// bits: per 32-bit word, reverse the bytes, then fold 8 bits into 4 and 4
// into 2.
__device__ __forceinline__ uint32_t pack_codes(uint4 x) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t t = __byte_perm(w[i] & 0x03030303u, 0, 0x0123);
    t = (t | (t >> 6)) & 0x000F000Fu;
    t = (t | (t >> 12)) & 0xFFu;
    out |= t << (24 - 8 * i);
  }
  return out;
}

// Bit j set iff byte j of 16 is in 4 .. 127 (a byte >= 4 as the JAX
// function tests an int8): bits 2-6 of a byte not negative, found per
// byte by a carry into bit 7, then gathered by one multiply.
__device__ __forceinline__ uint32_t pack_bad(uint4 x) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t nz = ((w[i] & 0x7C7C7C7Cu) + 0x7C7C7C7Cu) & ~w[i] & 0x80808080u;
    out |= (((nz >> 7) * 0x10204080u) >> 28) << (4 * i);
  }
  return out;
}

// kmers, valid [R, W], W = L - k + 1, as the flat [R * W] run; kmers
// 16-byte and valid 8-byte aligned. A code >= 4 (N, pad, or any other byte
// >= 4) invalidates its windows; a negative byte adds in as uint32.
// lines: the stage's 16-byte lines at most, for the layout of shared
// memory: the staged bytes, then a packed word of two-bit codes a line
// (lines + 2 words), then 16 bits of byte >= 4 flags a line (lines + 4);
// the span's codes reuse it from the start.
template <int THR, int V>
__global__ void __launch_bounds__(THR)
kmer_codes_kernel(const int8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
                  int64_t R, int L, int k, int lines_cap, int64_t* __restrict__ kmers,
                  uint8_t* __restrict__ valid) {
  extern __shared__ uint4 smem[];
  const int8_t* stage = reinterpret_cast<const int8_t*>(smem);
  uint32_t* packed = reinterpret_cast<uint32_t*>(smem + lines_cap);
  uint16_t* bad16 = reinterpret_cast<uint16_t*>(packed + lines_cap + 2);
  const uint32_t* bad32 = reinterpret_cast<const uint32_t*>(bad16);
  const int W = L - k + 1;
  constexpr int SPAN_ = THR * V;
  const int64_t e0 = (int64_t)blockIdx.x * SPAN_;
  const int64_t e_end = lmin(e0 + SPAN_, R * W);
  // the code bytes the span reads: one run of the flat [R * L] codes from
  // window e0's first byte to window e_end - 1's last, staged from the
  // 16-byte line it starts in (stage byte i is the byte at base + i;
  // bytes of its first and last line outside the run are 0)
  const int64_t r0 = div_small(e0, W), r1 = div_small(e_end - 1, W);
  const uintptr_t lo = (uintptr_t)(codes + r0 * L + (e0 - r0 * W));
  const uintptr_t hi = (uintptr_t)(codes + r1 * L + (e_end - 1 - r1 * W) + k);
  const uintptr_t base = lo & ~(uintptr_t)15;
  const int lines = k > 0 ? (int)((hi - base + 15) / 16) : 0;  // k <= 0: no byte is read
  uint32_t neg = 0;
  for (int q = threadIdx.x; q < lines; q += THR) {
    const uintptr_t a = base + 16 * (uintptr_t)q;
    uint4 x;
    if (a >= lo && a + 16 <= hi) {
      x = *reinterpret_cast<const uint4*>(a);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (a + b >= lo && a + b < hi)
          w[b / 4] |= (uint32_t)*reinterpret_cast<const uint8_t*>(a + b) << (8 * (b % 4));
      x = make_uint4(w[0], w[1], w[2], w[3]);
    }
    smem[q] = x;
    packed[q] = pack_codes(x);
    bad16[q] = (uint16_t)pack_bad(x);
    neg |= (x.x | x.y | x.z | x.w) & 0x80808080u;
  }
  // the thread's first window, and the lengths of its row and the next
  // (the only rows of its windows where W >= V), loaded while the
  // stage fills
  const int64_t first = e0 + (int64_t)threadIdx.x * V;
  const int nwin = (int)lmax(0, lmin(V, e_end - first));
  int64_t r = nwin ? div_small(first, W) : 0;
  const int32_t len0 = nwin ? lengths[r] : 0;
  const int32_t len1 = nwin && r + 1 < R ? lengths[r + 1] : 0;
  // a negative byte anywhere in the stage (no caller passes one) sends the
  // block down the rolling path
  const bool any_neg = __syncthreads_or(neg != 0);

  const uint32_t mask = k > 0 ? (1u << (2 * k)) - 1 : 0;  // k <= 15
  // w <= length - k in wrapping int32, as the plain version computes it
  const int last0 = (int)((uint32_t)len0 - (uint32_t)k);
  const int last1 = (int)((uint32_t)len1 - (uint32_t)k);
  uint32_t out[V];  // a code, or SENTINEL (as int64, the high word is 0)
  uint64_t ok_bytes = 0;
  int w = nwin ? (int)(first - r * W) : 0;
  int row = (int)((intptr_t)(codes + r * L) - (intptr_t)base);  // stage index of (r, 0)
  if (nwin && W >= V && !any_neg && k > 0) {
    // The thread's windows lie in row r and, past its end, at the start of
    // row r + 1 (W >= V: no further). For each, 64 bits of codes from
    // its first window's first byte on (window s of the run is bits
    // 64 - 2 (s + k) .. 63 - 2 s) and 32 flag bits (window s: bits s ..
    // s + k - 1).
    const int nr = W - w;  // the thread's windows in row r
    uint64_t z[2] = {0, 0};
    uint32_t bad[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = h ? row + L : row + w;
      if (h && nr >= nwin) break;
      const int q = p >> 4, j = 2 * (p & 15), qb = p >> 5;
      const uint32_t a = packed[q], b = packed[q + 1], c = packed[q + 2];
      z[h] = (uint64_t)__funnelshift_l(b, a, j) << 32 | __funnelshift_l(c, b, j);
      bad[h] = __funnelshift_r(bad32[qb], bad32[qb + 1], p & 31);
    }
    const uint32_t kmask = (1u << k) - 1;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const bool next = i >= nr;
      const int s = next ? i - nr : i;
      const uint32_t code = (uint32_t)((next ? z[1] : z[0]) >> (64 - 2 * (s + k))) & mask;
      const bool ok = i < nwin && (next ? s <= last1 : w + i <= last0) &&
                      (((next ? bad[1] : bad[0]) >> s) & kmask) == 0;
      out[i] = ok ? code : (uint32_t)SENT;
      ok_bytes |= (uint64_t)ok << (8 * i);
    }
  } else if (nwin) {
    // The rolling path: acc is the window's code mod 4^k (a byte's two low
    // bits leave it by the mask once the byte leaves the window), exact for
    // a window that holds no byte >= 4 (else SENTINEL) and none < 0 (else
    // the direct code). At k <= 0 no byte is read or rolled in: acc stays
    // 0, the JAX function's code of a window of no base.
    const int64_t r_first = r;
    int last = 0, bad_at = -1, neg_at = -1;  // the window's last byte >= 4 and < 0 so far
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      out[i] = (uint32_t)SENT;
      if (i >= nwin) continue;
      if (i == 0 || w == 0) {  // a thread's first window, or a row's: k steps
        last = r == r_first ? last0 : r == r_first + 1 ? last1
                                     : (int)((uint32_t)lengths[r] - (uint32_t)k);
        acc = 0;
        bad_at = neg_at = -1;
        for (int j = 0; j < k; ++j) {
          const int8_t x = stage[row + w + j];
          if (x >= 4) bad_at = w + j;
          if (x < 0) neg_at = w + j;
          acc = (acc << 2) | (uint32_t)(x & 3);
        }
      } else if (k > 0) {  // roll the window's last byte in
        const int8_t x = stage[row + w + k - 1];
        if (x >= 4) bad_at = w + k - 1;
        if (x < 0) neg_at = w + k - 1;
        acc = ((acc << 2) | (uint32_t)(x & 3)) & mask;
      }
      const bool ok = w <= last && bad_at < w;
      out[i] = ok ? (neg_at >= w ? window_code(stage + row + w, k) : acc) : (uint32_t)SENT;
      ok_bytes |= (uint64_t)ok << (8 * i);
      if (++w == W) {
        w = 0;
        ++r;
        row += L;
      }
    }
  }
  if (nwin == V && V == 8) {
    *reinterpret_cast<uint64_t*>(valid + first) = ok_bytes;
  } else if (nwin == V && V == 4) {
    *reinterpret_cast<uint32_t*>(valid + first) = (uint32_t)ok_bytes;
  } else if (nwin == V && V == 2) {
    *reinterpret_cast<uint16_t*>(valid + first) = (uint16_t)ok_bytes;
  } else {
    for (int i = 0; i < nwin; ++i) valid[first + i] = (uint8_t)(ok_bytes >> (8 * i));
  }
  __syncthreads();  // the stage is read: its space takes the codes out
  uint4* pairs = smem;
#pragma unroll
  for (int j = 0; j < V / 2; ++j)
    pairs[swizzle<V / 2>(threadIdx.x * (V / 2) + j)] = make_uint4(out[2 * j], 0, out[2 * j + 1], 0);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < V / 2; ++u) {
    const int q = u * THR + threadIdx.x;
    const int64_t e = e0 + 2 * q;
    if (e >= e_end) break;
    const uint4 p = pairs[swizzle<V / 2>(q)];
    if (e + 2 <= e_end) *reinterpret_cast<uint4*>(kmers + e) = p;
    else kmers[e] = (int64_t)p.x;
  }
}

// The reverse complement of v's low 2k bits (k <= 15); SENTINEL stays
// SENTINEL, and at k <= 0 any other code is 0 (no two-bit group).
// Reversing the 64 bits reverses the order of the two-bit groups and the
// two bits within each; swapping neighbouring bits puts the latter back; a
// group's complement 3 - g is g ^ 3; the input's low 2k bits are then the
// top 2k. The plain version's k steps, (o << 2) | (3 - (c & 3)) and c >>=
// 2, read the same bits, so any int64 gives the same code.
__device__ __forceinline__ int64_t revcomp(int64_t v, int k) {
  constexpr uint64_t ODD = 0x5555555555555555ull;
  uint64_t y = __brevll((unsigned long long)v);
  y = ((y >> 1) & ODD) | ((y & ODD) << 1);
  return v == SENT ? SENT : k > 0 ? (int64_t)(~y >> (64 - 2 * k)) : 0;
}

// x [rows, m] -> out [rows, m], the codes' reverse complements (BOTH
// false), or out [rows, 2m], row g being x's row g and then its reverse
// complements (BOTH true: the both-strand table, each code read once). THR
// threads of V codes a block: block b is tile b % tiles of row b / tiles,
// and thread t holds the code pairs t, t + THR, ... of its tile, so loads
// and stores are coalesced. PAIRS: m is even and x and out are 16-byte
// aligned, so a pair is one load and one store a half.
template <int THR, int V, bool BOTH, bool PAIRS>
__global__ void __launch_bounds__(THR)
revcomp_kmers_kernel(const int64_t* __restrict__ x, int64_t m, unsigned tiles, int k,
                     int64_t* __restrict__ out) {
  constexpr int CPT = V / 2;
  const unsigned g = blockIdx.x / tiles;  // (32 bits: the launch keeps rows * tiles < 2^31)
  const int64_t i0 = (int64_t)(blockIdx.x - g * tiles) * (THR * V) + 2 * threadIdx.x;
  const int64_t* xr = x + (int64_t)g * m;
  int64_t* copy = out + (int64_t)g * (BOTH ? 2 * m : m);
  int64_t* rc = BOTH ? copy + m : copy;
  longlong2 a[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {  // every load in flight before a store
    const int64_t i = i0 + 2 * j * THR;
    if (PAIRS) {
      a[j] = i < m ? *reinterpret_cast<const longlong2*>(xr + i) : make_longlong2(0, 0);
    } else {
      a[j].x = i < m ? xr[i] : 0;
      a[j].y = i + 1 < m ? xr[i + 1] : 0;
    }
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int64_t i = i0 + 2 * j * THR;
    const longlong2 r = make_longlong2(revcomp(a[j].x, k), revcomp(a[j].y, k));
    if (PAIRS) {
      if (i < m) {
        if (BOTH) *reinterpret_cast<longlong2*>(copy + i) = a[j];
        *reinterpret_cast<longlong2*>(rc + i) = r;
      }
    } else {
      if (i < m) {
        if (BOTH) copy[i] = a[j].x;
        rc[i] = r.x;
      }
      if (i + 1 < m) {
        if (BOTH) copy[i + 1] = a[j].y;
        rc[i + 1] = r.y;
      }
    }
  }
}

// The first index past `last` in the sorted row[0 .. n) whose value is not
// v = row[last], or n (n < 2^31), by one whole warp. Lane l probes last +
// 2^l (x: the value there, which the caller loads with its tile, before v
// is known; anything past the row), and the first lane f whose probe
// differs from v or lies past the row brackets the answer in (last +
// 2^(f-1), last + 2^f]. Each further round spreads 32 probes over the open
// gap and keeps the part between the last probe that holds v and the first
// that does not, about a 32nd of it: a run that goes r slots past `last`
// costs 1 + ceil(log2(r) / 5) rounds of loads, the first taken with the
// tile. Every lane returns it. On a row that is not sorted the result is
// some index in (last, n], and every load lies in the row.
__device__ __forceinline__ int64_t run_end(const int64_t* __restrict__ row, int64_t n,
                                           int64_t last, int64_t v, int64_t x) {
  const int lane = threadIdx.x & 31;
  // nonzero: lane 31's probe, last + 2^31, lies past the row
  const unsigned out = __ballot_sync(FULL, last + (1LL << lane) >= n || x != v);
  const int f = __ffs(out) - 1;
  int64_t lo = f ? last + (1LL << (f - 1)) : last;  // row[lo] == v
  int64_t hi = lmin(last + (1LL << f), n);          // row[hi] != v, or hi == n
  while (hi - lo > 1) {
    const int64_t d = hi - lo - 1;  // the open indices lo + 1 .. hi - 1
    const unsigned differ = __ballot_sync(FULL, row[lo + 1 + ((d * lane) >> 5)] != v);
    if (differ) {
      const int j = __ffs(differ) - 1;
      const int64_t h = lo + 1 + ((d * j) >> 5);
      if (j) lo = lo + 1 + ((d * (j - 1)) >> 5);
      hi = h;
    } else {
      lo += 1 + ((d * 31) >> 5);
    }
  }
  return hi;
}

// Rows [rows, n], each sorted, SENTINEL (the greatest value) last. At a run
// start i (a value that is not SENTINEL and differs from the one before
// it): values = row[i], counts = the run's length, is_start; elsewhere
// SENTINEL, 0, false. A run ends at the next boundary after its start: an
// index whose value differs from the one before it, or n. THR threads of V
// slots a block: block b is tile b % tiles of row b / tiles, and thread t
// holds the slot pairs t, t + THR, ... of its tile (coalesced loads and
// stores), so the tile is V / 2 segments of 2 THR slots, segment j held by
// pair j of every thread. The next boundary after a thread's pair is a
// reverse min-scan of the tile's boundaries: the first later lane of its
// warp with one (a ballot), else the first in a later warp of the segment,
// else in a later segment (each warp's first a segment in shared memory),
// else the end of the run that holds the tile's last slot, which the last
// warp finds past the tile by run_end. PAIRS: n is even, s and values are
// 16-byte aligned, counts 8-byte and is_start 2-byte aligned, so a pair is
// one load and one store an output.
template <int THR, int V, bool PAIRS>
__global__ void __launch_bounds__(THR)
unique_counts_kernel(const int64_t* __restrict__ s, int64_t n, unsigned tiles,
                     int64_t* __restrict__ values, int32_t* __restrict__ counts,
                     uint8_t* __restrict__ is_start) {
  constexpr int CPT = V / 2, WARPS = THR / 32;
  constexpr int NONE = INT_MAX;             // no boundary (n <= INT_MAX is one)
  __shared__ int first[CPT][WARPS];         // a warp's first boundary in segment j, or NONE
  __shared__ int64_t tail;                  // where the run of the tile's last slot ends
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned g = blockIdx.x / tiles;  // (32 bits: the launch keeps rows * tiles < 2^31)
  const int64_t i0 = (int64_t)(blockIdx.x - g * tiles) * (THR * V);
  const int64_t* row = s + (int64_t)g * n;
  const int64_t last = i0 + THR * V - 1;  // the tile's last slot
  const bool searcher = warp == WARPS - 1 && last + 1 < n;  // (a whole warp)
  const int64_t probe_at = last + (1LL << lane);
  const int64_t probe = searcher && probe_at < n ? row[probe_at] : 0;

  longlong2 a[CPT];
  int64_t before[CPT];  // lane 0: the slot before its pair (SENTINEL before the row)
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int64_t i = i0 + 2 * (j * THR + t);
    if (PAIRS) {
      a[j] = i < n ? *reinterpret_cast<const longlong2*>(row + i) : make_longlong2(SENT, SENT);
    } else {
      a[j].x = i < n ? row[i] : SENT;
      a[j].y = i + 1 < n ? row[i + 1] : SENT;
    }
    before[j] = lane == 0 && i > 0 && i < n ? row[i - 1] : SENT;
  }

  int nb[CPT];  // the first boundary after the pair among the later lanes of its warp
  bool cut[CPT], st0[CPT], st1[CPT];  // a boundary at i + 1; run starts at i, i + 1
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int64_t i = i0 + 2 * (j * THR + t);
    const int64_t up = __shfl_up_sync(FULL, a[j].y, 1);
    const int64_t prev = lane ? up : before[j];
    const bool in0 = i < n, in1 = i + 1 < n;
    const bool c0 = !in0 || a[j].x != prev;
    cut[j] = !in1 || a[j].y != a[j].x;
    st0[j] = in0 && a[j].x != SENT && a[j].x != prev;
    st1[j] = in1 && a[j].y != SENT && cut[j];
    const int fb = c0 ? (int)lmin(i, n) : cut[j] ? (int)lmin(i + 1, n) : NONE;
    const unsigned has = __ballot_sync(FULL, fb != NONE);
    const unsigned later = has & ((FULL << lane) << 1);
    const int next = __shfl_sync(FULL, fb, later ? __ffs(later) - 1 : lane);
    const int head = __shfl_sync(FULL, fb, has ? __ffs(has) - 1 : 0);
    nb[j] = later ? next : NONE;
    if (lane == 0) first[j][warp] = has ? head : NONE;
  }
  if (warp == WARPS - 1) {
    int64_t end = n;  // the row's last tile: its runs end in it or at n
    if (searcher) {
      const int64_t v = __shfl_sync(FULL, a[CPT - 1].y, 31);
      end = v == SENT ? last + 1 : run_end(row, n, last, v, probe);  // (SENTINEL starts no run)
    }
    if (lane == 0) tail = end;
  }
  __syncthreads();

  int64_t carry = tail;  // the first boundary past segment j (the tile's later segments)
#pragma unroll
  for (int j = CPT - 1; j >= 0; --j) {
    int later = nb[j], all = NONE;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int f = first[j][w];
      all = min(all, f);
      if (w > warp) later = min(later, f);
    }
    const int64_t after = lmin(later, carry);  // the first boundary past the pair
    carry = lmin(carry, all);
    const int64_t i = i0 + 2 * (j * THR + t);
    const int32_t c0 = st0[j] ? (int32_t)((cut[j] ? i + 1 : after) - i) : 0;
    const int32_t c1 = st1[j] ? (int32_t)(after - i - 1) : 0;
    const int64_t v0 = st0[j] ? a[j].x : SENT, v1 = st1[j] ? a[j].y : SENT;
    const int64_t e = (int64_t)g * n + i;
    if (PAIRS) {
      if (i < n) {
        *reinterpret_cast<longlong2*>(values + e) = make_longlong2(v0, v1);
        *reinterpret_cast<int2*>(counts + e) = make_int2(c0, c1);
        *reinterpret_cast<uint16_t*>(is_start + e) = (uint16_t)(st0[j] | st1[j] << 8);
      }
    } else {
      if (i < n) values[e] = v0, counts[e] = c0, is_start[e] = st0[j];
      if (i + 1 < n) values[e + 1] = v1, counts[e + 1] = c1, is_start[e + 1] = st1[j];
    }
  }
}

// lower_bound (upper false: the first index with t[i] >= v) or
// upper_bound (upper true: t[i] > v) of the sorted t[0 .. m), by one whole
// warp: each round probes N = 32 P points (P a lane, a power of two), at
// lo + d (2 j + 1) / 2N for j < N (d = hi - lo: a shift, not a division;
// every probe in [lo, hi)), and a ballot (the probes right of the answer
// are a suffix, the table being sorted) keeps the gap between two probes
// that holds the answer, about d / N wide: at P = 8, 2 rounds up to 65,536
// entries. Every lane returns it.
template <int P>
__device__ __forceinline__ int64_t warp_bound(const int64_t* __restrict__ t, int64_t m,
                                              int64_t v, bool upper) {
  constexpr int N = 32 * P, SHIFT = P == 1 ? 6 : P == 2 ? 7 : P == 4 ? 8 : 9;
  static_assert(P == 1 || P == 2 || P == 4 || P == 8, "P: 1, 2, 4 or 8 probes a lane");
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = m;
  while (lo < hi) {
    const int64_t d = hi - lo;
    int64_t x[P];
#pragma unroll
    for (int i = 0; i < P; ++i) x[i] = t[lo + ((d * (2 * (lane * P + i) + 1)) >> SHIFT)];
    unsigned right = 0;
#pragma unroll
    for (int i = 0; i < P; ++i) right |= (unsigned)(upper ? x[i] > v : x[i] >= v) << i;
    const unsigned lanes = __ballot_sync(FULL, right != 0);
    const int f = lanes ? __ffs(lanes) - 1 : 0;
    const unsigned bits = __shfl_sync(FULL, right, f);
    const int64_t j = lanes ? f * P + __ffs(bits) - 1 : N;  // the first probe right of v
    const int64_t next_lo = j > 0 ? lo + ((d * (2 * j - 1)) >> SHIFT) + 1 : lo;  // past probe j - 1
    if (j < N) hi = lo + ((d * (2 * j + 1)) >> SHIFT);                           // probe j
    lo = next_lo;
  }
  return lo;
}

// found[i] |= u[i] lies in the sorted s[a .. b) of shared memory, for a
// thread's V consecutive slots u (umin, umax: the least and the greatest
// of them that are not SENTINEL). Two branchless searches find the
// thread's own part of s, [lower_bound(umin), upper_bound(umax)); then
// the V slots search that part together, each a branchless search of the
// last entry <= u[i] whose trip count depends on the part's width alone,
// so their loads overlap. Exact for slots in any order; where they ascend,
// as the values out of unique_counts_sorted do, the part is a few entries
// wide.
template <int V>
__device__ __forceinline__ void member_staged(const int64_t* s, int a, int b,
                                              const int64_t (&u)[V], int64_t umin,
                                              int64_t umax, bool (&found)[V]) {
  if (a >= b) return;
  int p = a, q = a;  // s[p] is the last entry < umin (or a), s[q] the last <= umax (or a)
  for (int n = b - a; n > 1; n -= n >> 1) {
    const int half = n >> 1;
    p = s[p + half] < umin ? p + half : p;
    q = s[q + half] <= umax ? q + half : q;
  }
  const int lo = p + (s[p] < umin), hi = q + (s[q] <= umax);
  if (lo >= hi) return;
  int at[V];
#pragma unroll
  for (int i = 0; i < V; ++i) at[i] = lo;
  for (int n = hi - lo; n > 1; n -= n >> 1) {
    const int half = n >> 1;
#pragma unroll
    for (int i = 0; i < V; ++i) at[i] = s[at[i] + half] <= u[i] ? at[i] + half : at[i];
  }
#pragma unroll
  for (int i = 0; i < V; ++i) found[i] |= s[at[i]] == u[i];
}

// Sample slots [rows, n] against the reference table [rows, m_ref] and,
// when normal is not null, the normal table [rows, m_normal], row g
// against row g, m_ref and m_normal >= 1: a slot is kept iff its value is
// not SENTINEL and lies in neither table; kept slots keep (value, count),
// the others become (SENTINEL, 0). THR threads of V slots a block: block b
// is tile b % tiles of row b / tiles. For loads and stores thread t holds
// the slot pairs t, t + THR, ... of its tile; for the search, the V
// consecutive slots V t .. V t + V - 1, exchanged through shared memory. P
// probes a lane in the range search. PAIRS: n is even, values and
// out_values are 16-byte aligned and counts and out_counts 8-byte
// aligned, so a pair is one load.
template <int THR, int V, int P, bool PAIRS>
__global__ void __launch_bounds__(THR)
subtract_sorted_kernel(const int64_t* __restrict__ values, const int32_t* __restrict__ counts,
                       const int64_t* __restrict__ ref, int64_t m_ref,
                       const int64_t* __restrict__ normal, int64_t m_normal, int64_t n,
                       int64_t tiles, int64_t* __restrict__ out_values,
                       int32_t* __restrict__ out_counts) {
  constexpr int TILE_ = THR * V, CH = THR * CHUNK_PER_THREAD, CPT = V / 2;
  __shared__ int64_t stage[CH];
  __shared__ longlong2 tile[TILE_ / 2];  // the tile's values, pair p at swizzle(p)
  __shared__ uint32_t flags[THR];        // bit i of word t: slot V t + i found
  __shared__ int64_t part[2][THR / 32];
  __shared__ int64_t ends[4];  // the reference row's range of the tile's values, then the normal's
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t g = blockIdx.x / tiles;
  const int64_t row_end = (g + 1) * n;
  const int64_t tile0 = g * n + (blockIdx.x - g * tiles) * TILE_;

  int64_t lo = LLONG_MAX, hi = LLONG_MIN;  // of the tile's values that are not SENTINEL
  int32_t c[V];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int64_t s = tile0 + 2 * (j * THR + t);
    longlong2 a;
    if (PAIRS) {
      const bool in = s < row_end;  // n is even: a pair is whole or out
      a = in ? *reinterpret_cast<const longlong2*>(values + s) : make_longlong2(SENT, SENT);
      const int2 b = in ? *reinterpret_cast<const int2*>(counts + s) : make_int2(0, 0);
      c[2 * j] = b.x, c[2 * j + 1] = b.y;
    } else {
      a.x = s < row_end ? values[s] : SENT;
      a.y = s + 1 < row_end ? values[s + 1] : SENT;
      c[2 * j] = s < row_end ? counts[s] : 0;
      c[2 * j + 1] = s + 1 < row_end ? counts[s + 1] : 0;
    }
    tile[swizzle<CPT>(j * THR + t)] = a;
    if (a.x != SENT) lo = lmin(lo, a.x), hi = lmax(hi, a.x);
    if (a.y != SENT) lo = lmin(lo, a.y), hi = lmax(hi, a.y);
  }
  for (int o = 16; o; o >>= 1) {
    lo = lmin(lo, __shfl_xor_sync(FULL, lo, o));
    hi = lmax(hi, __shfl_xor_sync(FULL, hi, o));
  }
  if (lane == 0) part[0][warp] = lo, part[1][warp] = hi;
  __syncthreads();
  lo = part[0][0], hi = part[1][0];
  for (int w = 1; w < THR / 32; ++w) lo = lmin(lo, part[0][w]), hi = lmax(hi, part[1][w]);

  if (lo <= hi) {  // (a tile of SENTINEL alone searches nothing)
    if (warp < (normal != nullptr ? 4 : 2)) {
      const bool upper = warp & 1;
      const int64_t m = warp < 2 ? m_ref : m_normal;
      const int64_t b = warp_bound<P>((warp < 2 ? ref : normal) + g * m, m, upper ? hi : lo,
                                      upper);
      if (lane == 0) ends[warp] = b;
    } else if (t == 2 * 32) {  // no normal table: an empty range
      ends[2] = ends[3] = 0;
    }
    int64_t u[V];  // the thread's consecutive slots, their least and greatest value
    int64_t umin = LLONG_MAX, umax = LLONG_MIN;
    bool found[V] = {};
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const longlong2 a = tile[swizzle<CPT>(CPT * t + j)];
      u[2 * j] = a.x, u[2 * j + 1] = a.y;
    }
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (u[i] != SENT) umin = lmin(umin, u[i]), umax = lmax(umax, u[i]);
    __syncthreads();
    // the two ranges as one run: entry q < n_ref of the reference row,
    // the rest of the normal row
    const int64_t* rr = ref + g * m_ref + ends[0];
    const int64_t* nr = normal == nullptr ? nullptr : normal + g * m_normal + ends[2];
    const int64_t n_ref = ends[1] - ends[0], total = n_ref + ends[3] - ends[2];
    for (int64_t c0 = 0; c0 < total; c0 += CH) {
      const int len = (int)lmin(CH, total - c0);
      int64_t x[CHUNK_PER_THREAD];  // every load of the chunk in flight at once
#pragma unroll
      for (int k = 0; k < CHUNK_PER_THREAD; ++k) {
        const int64_t q = c0 + k * THR + t;
        x[k] = k * THR + t >= len ? 0 : q < n_ref ? rr[q] : nr[q - n_ref];
      }
#pragma unroll
      for (int k = 0; k < CHUNK_PER_THREAD; ++k)
        if (k * THR + t < len) stage[k * THR + t] = x[k];
      __syncthreads();
      const int split = (int)lmin(len, lmax(0, n_ref - c0));
      if (umin <= umax) {  // (a thread of SENTINEL alone searches nothing)
        member_staged<V>(stage, 0, split, u, umin, umax, found);
        member_staged<V>(stage, split, len, u, umin, umax, found);
      }
      __syncthreads();
    }
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < V; ++i) bits |= (uint32_t)found[i] << i;
    flags[t] = bits;
  } else {
    flags[t] = 0;
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int p = j * THR + t, s_in = 2 * p;  // the pair's first slot in the tile
    const int64_t s = tile0 + s_in;
    const longlong2 a = tile[swizzle<CPT>(p)];
    const uint32_t f = flags[s_in / V] >> (s_in % V);  // slots s_in, s_in + 1 (V is even)
    const bool k0 = a.x != SENT && !(f & 1), k1 = a.y != SENT && !(f & 2);
    const int64_t v0 = k0 ? a.x : SENT, v1 = k1 ? a.y : SENT;
    const int32_t c0 = k0 ? c[2 * j] : 0, c1 = k1 ? c[2 * j + 1] : 0;
    if (PAIRS) {
      if (s < row_end) {
        *reinterpret_cast<longlong2*>(out_values + s) = make_longlong2(v0, v1);
        *reinterpret_cast<int2*>(out_counts + s) = make_int2(c0, c1);
      }
    } else {
      if (s < row_end) out_values[s] = v0, out_counts[s] = c0;
      if (s + 1 < row_end) out_values[s + 1] = v1, out_counts[s + 1] = c1;
    }
  }
}

bool grid(int64_t elements, int64_t per_block, unsigned* blocks) {
  const int64_t b = (elements + per_block - 1) / per_block;
  if (elements <= 0 || b > INT_MAX) return false;
  *blocks = (unsigned)b;
  return true;
}

bool aligned(const void* p, uintptr_t bytes) { return (uintptr_t)p % bytes == 0; }

// The 16-byte lines of kmer_codes_kernel's stage at L and k, at most: a
// span's windows cross at most (span - 1) / W + 1 row ends, each adding
// k - 1 bytes, and the run starts and ends inside a line; none at k <= 0.
long long kmer_codes_lines(long long span, long long L, int k) {
  if (k <= 0) return 0;
  const long long W = L - k + 1;
  return (span - 1 + ((span - 1) / W + 1) * (k - 1) + k + 30) / 16 + 1;
}

// The card's SMs, asked once.
int sm_count() {
  static int sms = 0;
  if (sms < 1) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms > 0 ? sms : 1;
}

template <int V>
int kmer_codes_run(const void* codes, const void* lengths, long long R, int L, int k,
                   void* kmers, void* valid, unsigned blocks, void* stream) {
  constexpr int SPAN_ = KMER_THREADS * V;
  // the staged bytes, the packed codes and the flags, or the span's codes
  const long long lines = kmer_codes_lines(SPAN_, L, k);
  const long long smem = 16 * lines + 4 * (lines + 2) + 2 * (lines + 4);
  kmer_codes_kernel<KMER_THREADS, V>
      <<<blocks, KMER_THREADS, (size_t)(smem > 8 * SPAN_ ? smem : 8 * SPAN_),
         (cudaStream_t)stream>>>((const int8_t*)codes, (const int32_t*)lengths, R, L, k,
                                 (int)lines, (int64_t*)kmers, (uint8_t*)valid);
  return (int)cudaGetLastError();
}

template <int V>
int subtract_sorted_run(const void* values, const void* counts, const void* ref,
                        long long m_ref, const void* normal, long long m_normal, long long n,
                        long long tiles, void* out_values, void* out_counts, unsigned blocks,
                        void* stream) {
  const bool pairs = n % 2 == 0 && aligned(values, 16) && aligned(out_values, 16) &&
                     aligned(counts, 8) && aligned(out_counts, 8);
  auto kernel = pairs ? subtract_sorted_kernel<SUB_THREADS, V, PROBES, true>
                      : subtract_sorted_kernel<SUB_THREADS, V, PROBES, false>;
  kernel<<<blocks, SUB_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)values, (const int32_t*)counts, (const int64_t*)ref, m_ref,
      (const int64_t*)normal, m_normal, n, tiles, (int64_t*)out_values, (int32_t*)out_counts);
  return (int)cudaGetLastError();
}

template <int THR, int V>
int revcomp_kmers_run(const void* x, long long m, long long tiles, int k, bool both, void* out,
                      unsigned blocks, void* stream) {
  const bool pairs = m % 2 == 0 && aligned(x, 16) && aligned(out, 16);
  auto kernel = both ? (pairs ? revcomp_kmers_kernel<THR, V, true, true>
                              : revcomp_kmers_kernel<THR, V, true, false>)
                     : (pairs ? revcomp_kmers_kernel<THR, V, false, true>
                              : revcomp_kmers_kernel<THR, V, false, false>);
  kernel<<<blocks, THR, 0, (cudaStream_t)stream>>>((const int64_t*)x, m, (unsigned)tiles, k,
                                                   (int64_t*)out);
  return (int)cudaGetLastError();
}

template <int THR, int V>
int unique_counts_run(const void* s, long long n, long long tiles, void* values, void* counts,
                      void* is_start, unsigned blocks, void* stream) {
  const bool pairs = n % 2 == 0 && aligned(s, 16) && aligned(values, 16) &&
                     aligned(counts, 8) && aligned(is_start, 2);
  auto kernel = pairs ? unique_counts_kernel<THR, V, true> : unique_counts_kernel<THR, V, false>;
  kernel<<<blocks, THR, 0, (cudaStream_t)stream>>>(
      (const int64_t*)s, n, (unsigned)tiles, (int64_t*)values, (int32_t*)counts,
      (uint8_t*)is_start);
  return (int)cudaGetLastError();
}

// The tiles of a row of n slots at `per_tile` slots a tile and the grid of
// rows * tiles blocks (false where that does not fit a grid).
bool row_tiles(long long rows, long long n, long long per_tile, long long* tiles,
               unsigned* blocks) {
  *tiles = (n + per_tile - 1) / per_tile;
  return rows >= 1 && n >= 1 && *tiles <= INT_MAX / rows && grid(rows * *tiles, 1, blocks);
}

}  // namespace

// Each entry point launches one kernel on ``stream`` and returns the
// cudaError_t of the launch (cudaErrorInvalidValue, with nothing launched,
// for arguments it does not take, a grid of 0 blocks among them). Pointers
// are to contiguous device memory; int64 codes, int32 counts and lengths,
// int8 base codes, one byte a bool.
extern "C" {

// codes [R, L], lengths [R] -> kmers, valid [R, L - k + 1]; k <= 15 and
// L >= k (k <= 0: codes is not read); kmers 16-byte and valid 8-byte
// aligned (as torch.empty gives them).
int kmer_codes_launch(const void* codes, const void* lengths, long long R, int L, int k,
                      void* kmers, void* valid, void* stream) {
  unsigned blocks;
  if (k > MAX_K || L < k || !aligned(kmers, 16) || !aligned(valid, 8) ||
      !grid(R * (L - k + 1), KMER_THREADS * KMER_V, &blocks))
    return (int)cudaErrorInvalidValue;
  if ((int)blocks >= sm_count())
    return kmer_codes_run<KMER_V>(codes, lengths, R, L, k, kmers, valid, blocks, stream);
  grid(R * (L - k + 1), KMER_THREADS * SMALL_V, &blocks);
  return kmer_codes_run<SMALL_V>(codes, lengths, R, L, k, kmers, valid, blocks, stream);
}

// x [rows, m] -> out [rows, m] of reverse complements (both 0), or out
// [rows, 2m], each row's codes and then their reverse complements (both
// 1); k <= 15.
int revcomp_kmers_launch(const void* x, long long rows, long long m, int k, int both, void* out,
                         void* stream) {
  long long tiles;
  unsigned blocks;
  if (k > MAX_K || !row_tiles(rows, m, RC_THREADS * RC_V, &tiles, &blocks))
    return (int)cudaErrorInvalidValue;
  if ((int)blocks >= sm_count())
    return revcomp_kmers_run<RC_THREADS, RC_V>(x, m, tiles, k, both, out, blocks, stream);
  if (!row_tiles(rows, m, RC_THREADS * SMALL_V, &tiles, &blocks))
    return (int)cudaErrorInvalidValue;
  return revcomp_kmers_run<RC_THREADS, SMALL_V>(x, m, tiles, k, both, out, blocks, stream);
}

// s [rows, n] -> values, counts, is_start [rows, n]; n < 2^31.
int unique_counts_sorted_launch(const void* s, long long rows, long long n, void* values,
                                void* counts, void* is_start, void* stream) {
  long long tiles;
  unsigned blocks;
  if (n > INT_MAX || !row_tiles(rows, n, UC_THREADS * UC_V, &tiles, &blocks))
    return (int)cudaErrorInvalidValue;
  if ((int)blocks >= sm_count())
    return unique_counts_run<UC_THREADS, UC_V>(s, n, tiles, values, counts, is_start, blocks,
                                               stream);
  if (!row_tiles(rows, n, UC_SMALL_THREADS * SMALL_V, &tiles, &blocks))
    return (int)cudaErrorInvalidValue;
  return unique_counts_run<UC_SMALL_THREADS, SMALL_V>(s, n, tiles, values, counts, is_start,
                                                      blocks, stream);
}

// values, counts [rows, n], ref [rows, m_ref], normal [rows, m_normal] or
// null -> out_values, out_counts [rows, n]; m_ref >= 1, and m_normal >= 1
// with a normal table (a table of width 0 is refused).
int subtract_sorted_launch(const void* values, const void* counts, const void* ref,
                           long long m_ref, const void* normal, long long m_normal,
                           long long rows, long long n, void* out_values, void* out_counts,
                           void* stream) {
  unsigned blocks;
  const long long tiles = (n + SUB_THREADS * SUB_V - 1) / (SUB_THREADS * SUB_V);
  if (n < 1 || m_ref < 1 || (normal != nullptr && m_normal < 1) || rows < 1 ||
      tiles > INT_MAX / rows || !grid(rows * tiles, 1, &blocks))
    return (int)cudaErrorInvalidValue;
  if ((int)blocks >= sm_count())
    return subtract_sorted_run<SUB_V>(values, counts, ref, m_ref, normal, m_normal, n, tiles,
                                      out_values, out_counts, blocks, stream);
  const long long small = (n + SUB_THREADS * SMALL_V - 1) / (SUB_THREADS * SMALL_V);
  if (small > INT_MAX / rows || !grid(rows * small, 1, &blocks))
    return (int)cudaErrorInvalidValue;
  return subtract_sorted_run<SMALL_V>(values, counts, ref, m_ref, normal, m_normal, n, small,
                                      out_values, out_counts, blocks, stream);
}

}  // extern "C"
